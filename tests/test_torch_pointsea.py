"""The port's PointSea track vs the JAX package on the CPU: the realistic
voxel renderer (grid bit for bit, images), ResNet-18 in train and eval mode,
the no-projection attention blocks, both PointSeaSDG variants, PointSea's
eval-mode completions, one train step, the weight conversion, and
``main_pointsea`` (train, ``--test``, a bit-equal resume) with
test_torch_orchestration.py's stand-in model on PointSea's renders. Inputs
and weights come from numpy seeds; the JAX package compiles two functions of
the whole model here, PointSea's forward (a module-scoped fixture) and the
train step (one test), once each, at the tiny geometry of
tests/test_torch_geospec.py (step 2 / 2, merge and local 128). The renderer
keeps its fixed 224² x 8 grid."""

import dataclasses
import functools
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_parity import (  # noqa: F401
    close,
    jax_blocked_bn_sums,
    jax_difference_form_nn,
    jax_reference_modes,
    jax_variables,
    load_port,
    t,
)
from svdformer_pointsea_tpu import nn as jnn
from svdformer_pointsea_tpu.configs import pointsea_config as jax_pointsea_config
from svdformer_pointsea_tpu.nn import layers as jl
from svdformer_pointsea_tpu.nn import resnet as jresnet
from svdformer_pointsea_tpu.render import realistic as jreal
from svdformer_pointsea_tpu.train import state as jstate
from svdformer_pointsea_tpu_torch import cli
from svdformer_pointsea_tpu_torch import train as port_train
from svdformer_pointsea_tpu_torch.configs import pcn_config, pointsea_config
from svdformer_pointsea_tpu_torch.nn import (
    PointSea,
    PointSeaSDG,
    PointSeaSDGDecoder,
    ResNet18,
    SelfAttentionBlockNoProj,
    has_zero_gradient,
    init_parameters,
)
from svdformer_pointsea_tpu_torch.nn.layers import bn_row_weights
from svdformer_pointsea_tpu_torch.render import PCViewsReal, make_renderer, points2grid
from svdformer_pointsea_tpu_torch.train import init_state, loop, make_lr_fn, make_train_step
from svdformer_pointsea_tpu_torch.train.convert import params_from_jax
from test_torch_orchestration import MODELS, TinyCompletion, tiny  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_reference_modes")

TINY = dict(step1=2, step2=2, merge_points=128, local_points=128)
B, N_IN, GT = 3, 512, 1024
COMPLETION_ATOL = 2e-3  # tests/test_reference_parity.py's bound for whole-model outputs
MU_RTOL = 5e-3  # test_torch_train.py's first-moment bound per leaf
NOISE_MU = 1e-6  # first moment of a parameter whose exact gradient is 0
IMG_ATOL = 1e-6


def _pts(rng, *shape, scale=0.8):
    return ((rng.rand(*shape) - 0.5) * scale).astype(np.float32)


def _row_weights(n: int) -> np.ndarray:
    w = np.ones(n, np.float32)
    w[1] = 0.0  # a pad row
    return w


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return (torch.linalg.norm(got.detach() - want) / torch.linalg.norm(want)).item()


def _port_cfg():
    cfg = pointsea_config()
    return cfg.replace(network=dataclasses.replace(cfg.network, **TINY))


def _boundary_cloud(rng, n: int = 2048) -> np.ndarray:
    """Normalised clouds (centre 0, largest range 2 on z) whose voxel
    coordinates are integers up to rounding: x, y at (k / 112 - 1) / 0.8 and z
    at (j / 5 - 0.2) * 2 - 1, so that each ceil decides on the last bit."""
    k = rng.randint(-89, 90, size=(n, 2)).astype(np.float64)
    xy = np.sign(k) * (np.abs(k) / 112) / 0.8
    xy[:2] = [[-89 / 112 / 0.8] * 2, [89 / 112 / 0.8] * 2]  # x, y centred on 0
    z = (rng.randint(1, 7, size=n) / 5 - 0.2) * 2 - 1
    z[:2] = [-1.0, 1.0]
    return np.concatenate([xy, z[:, None]], axis=1).astype(np.float32)


def _cloud(kind: str, rng, batch: int, n: int = 2048) -> np.ndarray:
    if kind == "random":
        return _pts(rng, batch, n, 3, scale=rng.uniform(0.2, 2.0))
    if kind == "boundaries":
        return np.stack([_boundary_cloud(rng, n) for _ in range(batch)])
    pts = _pts(rng, batch, n, 3)
    pts[:, :, 2] = 0.1  # flat: the z range is 0
    return pts


def _jax_grid(points):
    """The first half of the JAX package's _real_render: projection and grid."""
    jv = jreal.PCViewsReal(trans=-0.7)
    proj = jnp.einsum("bpc,vcd->bvpd", points, jnp.asarray(jv.rot))
    proj = jnp.einsum("bvpc,vcd->bvpd", proj, jnp.asarray(jv.rot_bias))
    proj = proj - jnp.asarray(jv.translation)[None]
    return jreal.points2grid(proj.reshape(points.shape[0] * 3, -1, 3))


@pytest.mark.parametrize("kind", ["random", "boundaries", "flat"])
def test_points2grid_is_bit_equal_to_jax(kind):
    """The quantisation as XLA compiles it, on clouds whose coordinates fall
    anywhere, on voxel boundaries, and in a plane."""
    pts = _cloud(kind, np.random.RandomState(("random", "boundaries", "flat").index(kind)), 4)
    got = points2grid(t(pts))
    want = np.asarray(jax.jit(jreal.points2grid)(pts))
    assert got.shape == (4, 8, 224, 224) and (want > 0).sum() > 1000
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["random", "flat"])
def test_realistic_render_matches_jax(kind):
    """PCViewsReal: the three views' grids bit for bit, the images (channels
    first here, channels last in JAX) within 1e-6."""
    pts = _cloud(kind, np.random.RandomState(10 + (kind == "flat")), 2)
    render = PCViewsReal(trans=-0.7)
    np.testing.assert_array_equal(render.grid(t(pts)).numpy(), np.asarray(jax.jit(_jax_grid)(pts)))
    got = render.get_img(t(pts))
    want = np.asarray(jreal.PCViewsReal(trans=-0.7).get_img(jnp.asarray(pts)))
    assert got.shape == (6, 3, 224, 224)
    close(got.permute(0, 2, 3, 1), want, atol=IMG_ATOL)
    assert isinstance(make_renderer(pointsea_config()), PCViewsReal)


@pytest.mark.parametrize("train", [True, False])
def test_resnet18_matches_jax(rng, jax_blocked_bn_sums, train):
    """ResNet-18 at 64² on B·3 = 6 images: train mode (batch moments weighted
    by 2 row weights, one a pad row, each over 3 images; the running
    statistics move) and eval mode (running statistics). Every leaf, bn2's
    scale too, is drawn from numpy, so no block is an identity.

    Eval mode and the running statistics hold within 1e-5. Train mode's
    output holds within 1e-5 in relative L2 and 2e-4 per element: 20
    BatchNorms on batch moments (the last over 12 values a channel) amplify
    the f32 rounding of the convolutions, so that each side's f32 output is
    itself about 1e-4 from an f64 evaluation of the same input."""
    x = rng.rand(6, 64, 64, 3).astype(np.float32)
    w = _row_weights(2)
    jm = jresnet.ResNet18()
    variables = jax_variables(jm, x, seed=2)
    with jl.bn_row_weights(jnp.asarray(w)):
        want, mut = jax.jit(functools.partial(jm.apply, train=train, mutable=["batch_stats"]))(
            variables, x)
    m = ResNet18()
    m.load_state_dict(params_from_jax(variables), strict=True)
    m.train(train)
    with bn_row_weights(t(w)), torch.no_grad():
        got = m(t(x.transpose(0, 3, 1, 2)))
    assert got.shape == (6, 512, 2, 2) and got.dtype == torch.float32
    want = torch.from_numpy(np.array(want).transpose(0, 3, 1, 2))
    if train:
        close(got, want, atol=2e-4)
        assert _rel(got, want) <= 1e-5
    else:
        close(got, want, atol=1e-5, rtol=1e-5)
    state = m.state_dict()
    for name, val in params_from_jax({"batch_stats": mut["batch_stats"]}).items():
        close(state[name], val.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("block", ["noproj", "noproj_pos", "decoder"])
def test_no_projection_blocks_match_jax(rng, block):
    x, pos = rng.randn(2, 40, 64).astype(np.float32), rng.randn(2, 40, 64).astype(np.float32)
    if block == "decoder":
        jm, m, args = jl.PointSeaSDGDecoder(64), PointSeaSDGDecoder(64), (x,)
    else:
        jm, m = jl.SelfAttentionBlockNoProj(64, nhead=8), SelfAttentionBlockNoProj(64, nhead=8)
        args = (x, pos) if block == "noproj_pos" else (x,)
    variables = jax_variables(jm, *args, seed=4)
    want = jax.jit(jm.apply)(variables, *args)
    load_port(m, variables)
    with torch.no_grad():
        got = m(*map(t, args))
    close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("use_prev", [False, True])
def test_pointsea_sdg_matches_jax(rng, use_prev):
    """Both stages' SDG (hidden 64, ratio 2, 32 coarse points, 832 local
    channels): the fine points and the upsampled features passed on."""
    local, coarse = rng.randn(2, 32, 832).astype(np.float32), _pts(rng, 2, 32, 3)
    f_g, partial = rng.randn(2, 1, 512).astype(np.float32), _pts(rng, 2, 64, 3)
    args = (local, coarse, f_g, partial)
    if use_prev:
        args += (rng.randn(2, 32, 128).astype(np.float32),)  # prev_f_l
    jm = jnn.pointsea.PointSeaSDG(2, hidden_dim=64, use_prev=use_prev)
    variables = jax_variables(jm, *args, seed=6)
    want = jax.jit(jm.apply)(variables, *args)
    m = load_port(PointSeaSDG(2, hidden_dim=64, use_prev=use_prev), variables)
    with torch.no_grad():
        got = m(*map(t, args))
    assert got[0].shape == (2, 64, 3) and got[1].shape == (2, 64, 128)
    for g, w_ in zip(got, want):
        close(g, w_, atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def ps_variables(jax_reference_modes):
    """Random variables of the tiny JAX PointSea (from eval_shape, traced once
    for the module: they do not depend on the batch size)."""
    return jax_variables(jnn.PointSea(**TINY), np.zeros((2, N_IN, 3), np.float32),
                         np.zeros((6, 224, 224, 3), np.float32), seed=1)


@pytest.fixture(scope="module")
def forward_case(ps_variables):
    """PointSea's eval-mode forward through the JAX package, compiled once."""
    partial = _pts(np.random.RandomState(7), 2, N_IN, 3)
    depth = np.asarray(jreal.PCViewsReal(trans=-0.7).get_img(jnp.asarray(partial)))
    outs = [np.asarray(o) for o in jax.jit(jnn.PointSea(**TINY).apply)(ps_variables, partial,
                                                                        depth)]
    model = load_port(PointSea.from_config(_port_cfg().network), ps_variables)
    return SimpleNamespace(partial=partial, outs=outs, model=model)


def test_pointsea_completions_match_jax(forward_case):
    c = forward_case
    with torch.inference_mode():
        outs = c.model(t(c.partial), make_renderer(_port_cfg()).get_img(t(c.partial)))
    for got, want, n in zip(outs, c.outs, (256, 256, 512)):
        assert got.shape == (2, n, 3)
        close(got, want, atol=COMPLETION_ATOL)


def test_train_step_matches_jax(ps_variables, jax_difference_form_nn, jax_blocked_bn_sums):
    """One train step of a tiny PointSea (B 3 with a pad row, 512 partial and
    1024 gt points, the 224² realistic renders) through the JAX package's
    make_train_step and through the port, at train_net's first warmup LR;
    the JAX NN search is the difference form, as in test_torch_train.py, and
    its BatchNorm sums are blocked (port_parity.py: the renders' constant
    background costs XLA's row-by-row CPU sums several digits in ResNet-18).
    One test, so that the JAX step compiles once however the tests are
    spread over workers.

    - The loss and its parts within 1e-5 relative.
    - Adam's first moment per leaf within 5e-3 relative (L2; kNN membership
      at near-ties and f32 sum order, as in test_torch_train.py); the leaves
      whose exact gradient is 0 by PointSea's list (attention key biases,
      EdgeConv's conv0 / conv1 biases) below 1e-6 on both sides. gcn1's conv2
      bias is not on the list: x1 also enters the local features.
    - The running statistics (ResNet-18's 20 BatchNorms, EdgeConv's 6)
      within 1e-5."""
    rng = np.random.RandomState(11)
    partial, gt = _pts(rng, B, N_IN, 3), _pts(rng, B, GT, 3)
    w = _row_weights(B)
    cfg = _port_cfg()
    lr = make_lr_fn(cfg)(1, 0)
    jmodel, jopt = jnn.PointSea(**TINY), jstate.make_optimizer()
    jst = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=ps_variables["params"],
                            batch_stats=ps_variables["batch_stats"],
                            opt_state=jax.jit(jopt.init)(ps_variables["params"]))
    jstep = jstate.make_train_step(jmodel, jopt, donate=False,
                                   render_fn=jreal.PCViewsReal(trans=-0.7).render)
    start = params_from_jax(ps_variables)
    jst, jm = jstep(jst, partial, gt, w, lr)
    want_metrics = {key: float(val) for key, val in jm.items()}
    want_mu = params_from_jax({"params": jst.opt_state.inner_state[0].mu})
    want_stats = params_from_jax({"batch_stats": jst.batch_stats})
    del jst, jstep

    model = PointSea.from_config(cfg.network)
    model.load_state_dict(start, strict=True)
    state = init_state(cfg, model)
    step = make_train_step(model, state.optimizer, cfg.train.sqrt_loss, make_renderer(cfg).get_img)
    state, metrics = step(state, t(partial), t(gt), t(w), lr)
    assert state.step == 1
    for key in ("loss", "cdc", "cd1", "cd2"):
        close(metrics[key], want_metrics[key], atol=0, rtol=1e-5)
    params = dict(model.named_parameters())
    assert want_mu.keys() == params.keys()
    zero = {name for name in params if has_zero_gradient(name, "pointsea")}
    for name, want in want_mu.items():
        mu = state.optimizer.state[params[name]]["exp_avg"]
        if name in zero:
            assert max(mu.abs().max(), want.abs().max()) <= NOISE_MU, name
        else:
            assert _rel(mu, want) <= MU_RTOL, name
    gcn1 = "localencoder.gcn1.conv2.bias"
    assert gcn1 not in zero and has_zero_gradient(gcn1, "svdformer")
    assert want_mu[gcn1].abs().max() > 100 * NOISE_MU
    assert len(zero) == sum(n.endswith("attn.k_proj.bias") for n in params) + 6
    buffers = dict(model.named_buffers())
    assert len([n for n in want_stats if n.startswith("encoder.img_trunk.")]) == 2 * 20
    for name, want in want_stats.items():
        close(buffers[name], want.numpy(), atol=1e-5)


def test_params_from_jax_loads_pointsea_strictly(ps_variables):
    """Every leaf of the JAX tree lands on a port name (strict): ResNet-18's
    7x7 and 1x1 kernels HWIO -> OIHW, and point_fe's SA modules without PCSA."""
    model = loop.build_model(_port_cfg(), device="cpu")
    assert isinstance(model, PointSea) and isinstance(model.encoder.img_trunk, ResNet18)
    model.load_state_dict(params_from_jax(ps_variables), strict=True)
    fe = model.encoder.point_fe
    assert fe.sa1.pcsa is None and fe.sa2.pcsa is None and fe.sa3.pcsa is None
    assert model.encoder.img_trunk.conv1.weight.shape == (64, 3, 7, 7)
    assert model.encoder.ps.bias.shape == (64 * 128,)  # the full bias (ROADMAP C)


def test_pointsea_config_matches_jax():
    port, ref = pointsea_config(), jax_pointsea_config()
    assert port.network.model == ref.network.model == "pointsea"
    for field in ("step1", "step2", "merge_points", "local_points", "view_distance"):
        assert getattr(port.network, field) == getattr(ref.network, field), field
    for field in ("batch_size", "n_epochs", "learning_rate", "warmup_steps", "gamma",
                  "sqrt_loss", "partial_matching", "weight_decay", "save_freq"):
        assert getattr(port.train, field) == getattr(ref.train, field), field
    assert tuple(port.train.lr_decay_step) == tuple(ref.train.lr_decay_step)
    assert tuple(port.train.betas) == tuple(ref.train.betas)
    assert (port.data.gt_points, port.data.n_points) == (ref.data.gt_points, ref.data.n_points)
    assert port.out_path == ref.out_path


class TinyPointSea(TinyCompletion):
    """The orchestration tests' stand-in model on PointSea's renders (B·3, 3,
    H, W): the first channel of each view's image."""

    def forward(self, partial, depth):
        views = depth[:, 0].reshape(partial.shape[0], -1, *depth.shape[2:])
        return super().forward(partial, views)


@pytest.fixture
def tiny_pointsea(tiny, monkeypatch):
    """test_torch_orchestration.py's tiny PCN tree as the pointsea track's
    configuration (main_pointsea reads it), with the stand-in model: a
    PointSea checkpoint with Adam's moments is hundreds of MB."""

    def build(cfg, device=None, seed=0):
        model = init_parameters(TinyPointSea(), torch.Generator().manual_seed(seed))
        return model.to(loop.resolve_device(device))

    monkeypatch.setattr(loop, "build_model", build)
    cfg = tiny.replace(network=dataclasses.replace(tiny.network, model="pointsea"))
    monkeypatch.setattr(cli, "pointsea_config", lambda: cfg)
    return cfg


def test_main_pointsea_trains_and_tests(tiny_pointsea, capsys, monkeypatch):
    """Two epochs of train_net on the realistic renders (the renderer sees
    every batch), checkpoints and scalars; then --test evaluates the best
    checkpoint."""
    shapes = []
    real = PCViewsReal.get_img
    monkeypatch.setattr(PCViewsReal, "get_img",
                        lambda self, p: shapes.append(tuple(p.shape)) or real(self, p))
    out = tiny_pointsea.out_path
    state, best = cli.main_pointsea(["--out", out], device="cpu")
    assert state.step == 6 and np.isfinite(best)
    assert shapes[0] == (2, 32, 3) and len(shapes) >= 6
    assert sorted(os.listdir(os.path.join(out, "checkpoints"))) == [
        "ckpt-best.pt", "ckpt-epoch-001.pt", "ckpt-epoch-002.pt"]
    capsys.readouterr()
    mean_cd = cli.main_pointsea(["--test", "--weights",
                                 os.path.join(out, "checkpoints", "ckpt-best.pt")], device="cpu")
    rows = {line.split("\t")[0]: line.split("\t")
            for line in capsys.readouterr().out.splitlines() if "\t" in line}
    assert np.isfinite(mean_cd) and abs(float(rows["Overall"][2]) - mean_cd) < 1e-4
    assert sum(int(r[1]) for k, r in rows.items() if k.isdigit()) == MODELS["test"]


def test_pointsea_resume_ends_bit_equal_to_the_straight_run(tiny_pointsea):
    """Two epochs straight, and one then a resume from ckpt-epoch-001:
    parameters, statistics, Adam's state, the step count and the best metric
    all equal."""
    torch.use_deterministic_algorithms(True)
    try:
        straight, best = cli.main_pointsea([], device="cpu")
        first = os.path.join(tiny_pointsea.out_path, "checkpoints", "ckpt-epoch-001.pt")
        resumed, best_r = cli.main_pointsea(
            ["--weights", first, "--out", tiny_pointsea.out_path + "_resumed"], device="cpu")
    finally:
        torch.use_deterministic_algorithms(False)
    assert resumed.step == straight.step == 6 and best_r == best
    want = straight.model.state_dict()
    for name, got in resumed.model.state_dict().items():
        assert torch.equal(got, want[name]), name
    s, r = straight.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    assert s.keys() == r.keys()
    for key in s:
        for field in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(s[key][field], r[key][field]), (key, field)


def test_main_pointsea_flags(monkeypatch):
    """Training goes to train_net, --test to test_net, with the pointsea
    configuration and the flags applied."""
    calls = []
    monkeypatch.setattr(port_train, "train_net", lambda cfg, device=None: calls.append(
        ("train", cfg, device)))
    monkeypatch.setattr(port_train, "test_net", lambda cfg, device=None: calls.append(
        ("test", cfg, device)))
    cli.main(["pointsea", "--epochs", "2", "--precision", "bf16"])
    kind, cfg, device = calls.pop()
    assert (kind, device, cfg.out_path) == ("train", None, "out/pointsea_pcn")
    assert (cfg.train.n_epochs, cfg.train.precision, cfg.network.model) == (2, "bf16", "pointsea")
    cli.main_pointsea(["--test", "--weights", "w.pt", "--out", "o"], device="cpu")
    kind, cfg, device = calls.pop()
    assert (kind, device, cfg.weights, cfg.out_path) == ("test", "cpu", "w.pt", "o")
    assert cfg.network == pointsea_config().network and cfg.data == pcn_config().data
