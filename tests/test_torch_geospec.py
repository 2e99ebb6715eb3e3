"""The port's GeoSpecNet track vs the JAX package on the CPU: SpectralAdapter,
MSGSpecConv, PointDiscriminator in train and eval mode, GeoSpecNet's
eval-mode completions, one GAN step (D then the generator through one
forward), the weight conversion of both model families, and ``main_geospec``
(train, ``--test``, a bit-equal resume) with test_torch_orchestration.py's
stand-in generator beside the real discriminator. Inputs and weights come
from numpy seeds; the JAX package compiles two functions here, GeoSpecNet's
forward (a module-scoped fixture) and the GAN step (one test), once each, at
the tiny geometry of tests/test_models.py (step 2 / 2, merge and local 128)."""

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
    jax_reference_modes,
    jax_variables,
    load_port,
    t,
)
from svdformer_pointsea_tpu import nn as jnn
from svdformer_pointsea_tpu.configs import geospec_config as jax_geospec_config
from svdformer_pointsea_tpu.nn import layers as jl
from svdformer_pointsea_tpu.ops import distances as jax_distances
from svdformer_pointsea_tpu.render import PCViews as JaxPCViews
from svdformer_pointsea_tpu.train import gan as jgan
from svdformer_pointsea_tpu.train import state as jstate
from svdformer_pointsea_tpu_torch import cli
from svdformer_pointsea_tpu_torch import train as port_train
from svdformer_pointsea_tpu_torch.configs import geospec_config, pcn_config
from svdformer_pointsea_tpu_torch.nn import (
    GeoSpecNet,
    MSGSpecConv,
    PointDiscriminator,
    SpectralAdapter,
    SVDFormer,
    has_zero_gradient,
    init_parameters,
)
from svdformer_pointsea_tpu_torch.nn.layers import bn_row_weights
from svdformer_pointsea_tpu_torch.render import make_renderer
from svdformer_pointsea_tpu_torch.train import loop, make_lr_fn
from svdformer_pointsea_tpu_torch.train.convert import params_from_jax
from svdformer_pointsea_tpu_torch.train.gan import GANTrainState, create_gan_state, make_gan_train_step
from test_torch_orchestration import MODELS, tiny  # noqa: F401

pytestmark = pytest.mark.usefixtures("jax_reference_modes")

TINY = dict(step1=2, step2=2, merge_points=128, local_points=128)  # tests/test_models.py:95
B, N_IN, GT, RES = 3, 512, 1024, 32
COMPLETION_ATOL = 2e-3  # tests/test_reference_parity.py's bound for whole-model outputs
MU_RTOL = 5e-3  # test_torch_train.py's first-moment bound per leaf
NOISE_MU = 1e-6  # first moment of a parameter whose exact gradient is 0


def _pts(rng, *shape, scale=0.8):
    return ((rng.rand(*shape) - 0.5) * scale).astype(np.float32)


def _row_weights(n: int) -> np.ndarray:
    w = np.ones(n, np.float32)
    w[1] = 0.0  # a pad row
    return w


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return (torch.linalg.norm(got.detach() - want) / torch.linalg.norm(want)).item()


def _difference_form_nn(a, b):
    """port_parity.py's jax_difference_form_nn, for a module-scoped fixture."""
    diff = a.astype(jnp.float32)[:, :, None, :] - b.astype(jnp.float32)[:, None, :, :]
    d = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] + diff[..., 2] * diff[..., 2]
    return jnp.min(d, axis=-1), jnp.argmin(d, axis=-1).astype(jnp.int32)


def _port_cfg():
    cfg = geospec_config()
    return cfg.replace(network=dataclasses.replace(cfg.network, resolution=RES, **TINY))


@pytest.fixture(scope="module")
def msg_case(jax_reference_modes):
    """One JAX apply of MSGSpecConv(32, 32) that also records its branches'
    outputs (the spectral adapters at K 16 and K 32), and the port's module
    with the same weights."""
    rng = np.random.RandomState(3)
    xyz, feats = _pts(rng, 2, 128, 3), rng.randn(2, 128, 32).astype(np.float32)
    jmod = jnn.geospecnet.MSGSpecConv(32, 32)
    variables = jax_variables(jmod, xyz, feats, seed=3)
    out, inter = jax.jit(functools.partial(jmod.apply, capture_intermediates=True,
                                           mutable=["intermediates"]))(variables, xyz, feats)
    want = {name: inter["intermediates"][name]["__call__"][0] for name in ("branch0", "branch1")}
    want["fused"] = out
    mod = MSGSpecConv(32, 32)
    mod.load_state_dict(params_from_jax(variables), strict=True)
    return SimpleNamespace(xyz=t(xyz), feats=t(feats), want=want, mod=mod)


@pytest.mark.parametrize("k", [16, 32])
def test_spectral_adapter_matches_jax(msg_case, k):
    """The adapter at K 16 / 32: MSGSpecConv's branch0 / branch1."""
    name = f"branch{(16, 32).index(k)}"
    adapter = getattr(msg_case.mod, name)
    assert isinstance(adapter, SpectralAdapter) and adapter.k == k
    with torch.no_grad():
        got = adapter(msg_case.xyz, msg_case.feats)
    assert got.shape == (2, 128, 32)
    close(got, msg_case.want[name], atol=1e-5, rtol=1e-5)


def test_msg_spec_conv_matches_jax(msg_case):
    with torch.no_grad():
        got = msg_case.mod(msg_case.xyz, msg_case.feats)
    close(got, msg_case.want["fused"], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("train", [True, False])
def test_point_discriminator_matches_jax(rng, train):
    """Logits (B,) in train mode (row-weighted batch moments; the running
    statistics move) and in eval mode (running statistics)."""
    pcd = _pts(rng, 4, 200, 3)
    w = _row_weights(4)
    jd = jnn.PointDiscriminator()
    variables = jax_variables(jd, pcd, seed=5)
    with jl.bn_row_weights(jnp.asarray(w)):
        want, mut = jax.jit(functools.partial(jd.apply, train=train, mutable=["batch_stats"]))(
            variables, pcd)
    d = PointDiscriminator()
    d.load_state_dict(params_from_jax(variables), strict=True)
    d.train(train)
    with bn_row_weights(t(w)), torch.no_grad():
        got = d(t(pcd))
    assert got.shape == (4,)
    close(got, want, atol=1e-5, rtol=1e-5)
    state = d.state_dict()
    for name, val in params_from_jax({"batch_stats": mut["batch_stats"]}).items():
        close(state[name], val.numpy(), atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def geo_variables(jax_reference_modes):
    """Random variables of the tiny JAX GeoSpecNet (from eval_shape, traced
    once for the module: they do not depend on the batch size)."""
    partial = np.zeros((2, N_IN, 3), np.float32)
    return jax_variables(jnn.GeoSpecNet(**TINY), partial,
                         np.zeros((2, 3, RES, RES), np.float32), seed=1)


@pytest.fixture(scope="module")
def forward_case(geo_variables):
    """GeoSpecNet's eval-mode forward through the JAX package, compiled once."""
    rng = np.random.RandomState(7)
    partial = _pts(rng, 2, N_IN, 3)
    depth = np.asarray(JaxPCViews(trans=-0.7, resolution=RES).get_img(jnp.asarray(partial)))
    jmodel = jnn.GeoSpecNet(**TINY)
    outs = [np.asarray(o) for o in jax.jit(jmodel.apply)(geo_variables, partial, depth)]
    model = load_port(GeoSpecNet.from_config(_port_cfg().network), geo_variables)
    return SimpleNamespace(partial=partial, outs=outs, model=model)


def test_geospecnet_completions_match_jax(forward_case):
    c = forward_case
    with torch.inference_mode():
        outs = c.model(t(c.partial), make_renderer(_port_cfg()).get_img(t(c.partial)))
    for got, want, n in zip(outs, c.outs, (256, 256, 512)):
        assert got.shape == (2, n, 3)
        close(got, want, atol=COMPLETION_ATOL)


def test_gan_step_matches_jax(geo_variables):
    """One GAN step of a tiny GeoSpecNet and the PointDiscriminator (B 3 with
    a pad row, 512 partial and 1024 gt points, 32² render) through the JAX
    package's make_gan_train_step (mesh None) and through the port, at
    train_net_gan's first warmup LR for both networks; the JAX NN search is
    the difference form, as in test_torch_train.py. One test, so that the
    JAX step compiles once however the tests are spread over workers.

    - Every metric within 1e-5 relative.
    - D's parameters and running statistics after its Adam step (both passes
      moved the statistics, real first) within 1e-5 relative (L2), and its
      first moments; its stem biases, whose exact gradient is 0 (BatchNorm
      follows them), hold |mu| <= 1e-6 and move by at most lr.
    - G's first moment per leaf within 5e-3 relative (L2; kNN membership at
      near-ties and f32 sum order, as in test_torch_train.py), its
      zero-gradient leaves (attention key biases, the spectral adapters'
      geo_fc2 biases, EdgeConv biases before BatchNorm) below 1e-6 on both
      sides; its running statistics within 1e-5."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_distances, "_nn_one_way", _difference_form_nn)
    try:
        rng = np.random.RandomState(11)
        partial, gt = _pts(rng, B, N_IN, 3), _pts(rng, B, GT, 3)
        w = _row_weights(B)
        cfg = _port_cfg()
        lr = make_lr_fn(cfg)(1, 0)
        render = JaxPCViews(trans=-0.7, resolution=RES)
        jmodel, jd = jnn.GeoSpecNet(**TINY), jnn.PointDiscriminator()
        g_vars, d_vars = geo_variables, jax_variables(jd, gt, seed=4)
        g_opt, d_opt = jstate.make_optimizer(), jstate.make_optimizer()
        jst = jgan.GANTrainState(
            step=jnp.zeros((), jnp.int32), g_params=g_vars["params"],
            g_batch_stats=g_vars["batch_stats"], g_opt_state=jax.jit(g_opt.init)(g_vars["params"]),
            d_params=d_vars["params"], d_batch_stats=d_vars["batch_stats"],
            d_opt_state=jax.jit(d_opt.init)(d_vars["params"]))
        jstep = jgan.make_gan_train_step(jmodel, jd, g_opt, d_opt, cfg.train.gan_weight,
                                         render_fn=render.render, donate=False)
        start_g, start_d = params_from_jax(g_vars), params_from_jax(d_vars)
        jst, jm = jstep(jst, partial, gt, w, lr, lr)
        want_metrics = {key: float(val) for key, val in jm.items()}
        want_d = params_from_jax({"params": jst.d_params, "batch_stats": jst.d_batch_stats})
        want_d_mu = params_from_jax({"params": jst.d_opt_state.inner_state[0].mu})
        want_g_mu = params_from_jax({"params": jst.g_opt_state.inner_state[0].mu})
        want_g_stats = params_from_jax({"batch_stats": jst.g_batch_stats})
        del jst, jstep
    finally:
        mp.undo()

    model = GeoSpecNet.from_config(cfg.network)
    model.load_state_dict(start_g, strict=True)
    state = create_gan_state(cfg, model, seed=cfg.seed)
    state.d_model.load_state_dict(start_d, strict=True)
    step = make_gan_train_step(cfg.train.gan_weight, make_renderer(cfg).get_img)
    state, metrics = step(state, t(partial), t(gt), t(w), lr, lr)
    assert state.step == 1
    assert set(metrics) == set(want_metrics) == {"g_loss", "d_loss", "recon", "gan", "cdc", "cd1",
                                                 "cd2"}
    for key, val in want_metrics.items():
        close(metrics[key], val, atol=0, rtol=1e-5)

    d_state = state.d_model.state_dict()
    assert d_state.keys() == want_d.keys()
    for name, val in want_d.items():
        if has_zero_gradient(name):
            assert (d_state[name] - start_d[name]).abs().max() <= lr, name
            continue
        assert _rel(d_state[name], val) <= 1e-5, name
        assert not torch.equal(d_state[name], start_d[name]), name
    for net, opt, want_mu, bound in ((state.d_model, state.d_optimizer, want_d_mu, 1e-5),
                                     (model, state.optimizer, want_g_mu, MU_RTOL)):
        params = dict(net.named_parameters())
        assert want_mu.keys() == params.keys()
        for name, want in want_mu.items():
            mu = opt.state[params[name]]["exp_avg"]
            if has_zero_gradient(name):
                assert max(mu.abs().max(), want.abs().max()) <= NOISE_MU, name
            else:
                assert _rel(mu, want) <= bound, name
    assert sum(".geo_fc2.bias" in n for n in dict(model.named_parameters())
               if has_zero_gradient(n)) == 2
    buffers = dict(model.named_buffers())
    for name, want in want_g_stats.items():
        close(buffers[name], want.numpy(), atol=1e-5)


@pytest.mark.parametrize("family", ["svdformer", "geospecnet"])
def test_params_from_jax_loads_both_families_strictly(request, family):
    """Every leaf of the JAX tree, the raw freq_gate included, lands on a
    port name (strict): SVDFormer's SA modules keep their PCSA, GeoSpecNet's
    have none."""
    if family == "geospecnet":
        variables = request.getfixturevalue("geo_variables")
    else:
        variables = jax_variables(jnn.SVDFormer(**TINY), np.zeros((1, N_IN, 3), np.float32),
                                  np.zeros((1, 3, RES, RES), np.float32))
    cfg = _port_cfg()
    cfg = cfg.replace(network=dataclasses.replace(cfg.network, model=family))
    model = loop.build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(variables), strict=True)
    sa = [model.encoder.point_fe.sa1, model.encoder.point_fe.sa2]
    assert all((m.pcsa is None) == (family == "geospecnet") for m in sa)
    assert model.encoder.point_fe.sa3.pcsa is None
    assert isinstance(model, GeoSpecNet if family == "geospecnet" else SVDFormer)
    with pytest.raises(KeyError, match="unhandled parameter leaf"):
        params_from_jax({"params": {"gate": np.zeros(3, np.float32)}})


def test_geospec_config_matches_jax():
    port, ref = geospec_config(), jax_geospec_config()
    assert port.network.model == ref.network.model == "geospecnet"
    for field in ("step1", "step2", "merge_points", "local_points", "view_distance",
                  "resolution"):
        assert getattr(port.network, field) == getattr(ref.network, field), field
    for field in ("batch_size", "n_epochs", "learning_rate", "warmup_steps", "gamma",
                  "gan_weight", "sqrt_loss", "partial_matching", "weight_decay", "save_freq"):
        assert getattr(port.train, field) == getattr(ref.train, field), field
    assert tuple(port.train.lr_decay_step) == tuple(ref.train.lr_decay_step)
    assert tuple(port.train.betas) == tuple(ref.train.betas)
    assert (port.data.gt_points, port.data.n_points) == (ref.data.gt_points, ref.data.n_points)
    assert port.out_path == ref.out_path and ref.network.decoder == "sdg" == port.network.decoder


def test_init_parameters_draws_the_frequency_gates():
    """init_parameters draws every freq_gate from its generator (0.02 N(0, 1)),
    so one seed gives one GeoSpecNet."""
    a, b = (init_parameters(SpectralAdapter(8, 8, 16), torch.Generator().manual_seed(3))
            for _ in range(2))
    assert torch.equal(a.freq_gate, b.freq_gate) and a.freq_gate.std() > 0.01


@pytest.fixture
def tiny_geospec(tiny, monkeypatch):
    """test_torch_orchestration.py's tiny PCN tree and stand-in generator as
    the geospec track's configuration (main_geospec reads it)."""
    cfg = tiny.replace(network=dataclasses.replace(tiny.network, model="geospecnet"))
    monkeypatch.setattr(cli, "geospec_config", lambda: cfg)
    return cfg


def test_main_geospec_trains_and_tests(tiny_geospec, capsys):
    """Two epochs of train_net_gan: both networks move, both checkpoints hold
    G, D and their optimizers, g_loss / d_loss are logged each step; then
    --test evaluates the best checkpoint's generator."""
    out = tiny_geospec.out_path
    state, best = cli.main_geospec(["--out", out], device="cpu")
    assert isinstance(state, GANTrainState) and state.step == 6 and np.isfinite(best)
    ckpt = torch.load(os.path.join(out, "checkpoints", "ckpt-best.pt"), weights_only=True)
    assert {"model", "optimizer", "d_model", "d_optimizer"} <= set(ckpt)
    assert set(ckpt["d_model"]) == set(state.d_model.state_dict())
    fresh = PointDiscriminator()
    init_parameters(fresh, torch.Generator().manual_seed(tiny_geospec.seed + 1))
    assert not torch.equal(fresh.head1.weight, state.d_model.head1.weight)
    tags = [line for line in open(os.path.join(out, "logs", "scalars.jsonl"))]
    assert sum('"Train/g_loss"' in x for x in tags) == sum('"Train/d_loss"' in x for x in tags) == 6
    capsys.readouterr()
    mean_cd = cli.main_geospec(["--test", "--weights",
                                os.path.join(out, "checkpoints", "ckpt-best.pt")], device="cpu")
    rows = {line.split("\t")[0]: line.split("\t")
            for line in capsys.readouterr().out.splitlines() if "\t" in line}
    assert np.isfinite(mean_cd) and abs(float(rows["Overall"][2]) - mean_cd) < 1e-4
    assert sum(int(r[1]) for k, r in rows.items() if k.isdigit()) == MODELS["test"]


def test_gan_resume_ends_bit_equal_to_the_straight_run(tiny_geospec):
    """Two GAN epochs straight, and one then a resume from ckpt-epoch-001:
    both networks' parameters and statistics, both Adam states, the step
    count and the best metric all equal."""
    torch.use_deterministic_algorithms(True)
    try:
        straight, best = cli.main_geospec([], device="cpu")
        first = os.path.join(tiny_geospec.out_path, "checkpoints", "ckpt-epoch-001.pt")
        resumed, best_r = cli.main_geospec(
            ["--weights", first, "--out", tiny_geospec.out_path + "_resumed"], device="cpu")
    finally:
        torch.use_deterministic_algorithms(False)
    assert resumed.step == straight.step == 6 and best_r == best
    for net, opt in (("model", "optimizer"), ("d_model", "d_optimizer")):
        want = getattr(straight, net).state_dict()
        for name, got in getattr(resumed, net).state_dict().items():
            assert torch.equal(got, want[name]), (net, name)
        s, r = getattr(straight, opt).state_dict()["state"], getattr(resumed, opt).state_dict()["state"]
        assert s.keys() == r.keys()
        for key in s:
            for field in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(s[key][field], r[key][field]), (net, key, field)


def test_main_geospec_flags(monkeypatch):
    """--run_id tags the output path; training goes to train_net_gan, --test
    to test_net with the geospec configuration."""
    calls = []
    monkeypatch.setattr(port_train, "train_net_gan", lambda cfg, device=None: calls.append(
        ("gan", cfg, device)))
    monkeypatch.setattr(port_train, "test_net", lambda cfg, device=None: calls.append(
        ("test", cfg, device)))
    cli.main(["geospec", "--run_id", "3", "--epochs", "2", "--precision", "bf16"])
    kind, cfg, device = calls.pop()
    assert (kind, device, cfg.out_path) == ("gan", None, "out/geospecnet_pcn_3")
    assert (cfg.train.n_epochs, cfg.train.precision, cfg.network.model) == (2, "bf16", "geospecnet")
    cli.main_geospec(["--test", "--weights", "w.pt", "--out", "o"], device="cpu")
    kind, cfg, device = calls.pop()
    assert (kind, device, cfg.weights, cfg.out_path) == ("test", "cpu", "w.pt", "o")
    assert cfg.network == geospec_config().network and cfg.data == pcn_config().data
