"""The port's ShapeNet-55 track vs the JAX package on the CPU: the npy data
and loader, the online crops, the partial-matching loss, the attention-
decoder SVDFormer, two train steps with crops and AdamW, one corner of the
55 evaluation, and ``main_55`` (with test_torch_orchestration.py's stand-in
model, whose checkpoints hold kilobytes). Inputs and weights come from numpy
seeds; each JAX function is compiled once, at gt 512 and 128 input points."""

import dataclasses
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_parity import (  # noqa: F401
    close,
    jax_difference_form_nn,
    jax_reference_modes,
    jax_variables,
    load_port,
    t,
)
from svdformer_pointsea_tpu import losses as jlosses
from svdformer_pointsea_tpu.configs import shapenet55_config as jax_shapenet55_config
from svdformer_pointsea_tpu.data import crop as jcrop
from svdformer_pointsea_tpu.data import datasets as jdatasets
from svdformer_pointsea_tpu.data import pipeline as jpipeline
from svdformer_pointsea_tpu.data import transforms as jtransforms
from svdformer_pointsea_tpu.nn import SVDFormer as JaxSVDFormer
from svdformer_pointsea_tpu.render import PCViews as JaxPCViews
from svdformer_pointsea_tpu.train import evaluate as jevaluate
from svdformer_pointsea_tpu.train import state as jstate
from svdformer_pointsea_tpu_torch import cli
from svdformer_pointsea_tpu_torch import train as port_train
from svdformer_pointsea_tpu_torch.configs import shapenet34_config, shapenet55_config
from svdformer_pointsea_tpu_torch.data import (
    FIXED_CORNERS,
    Loader,
    crop_fixed,
    crop_random_resampled,
    make_dataset,
    random_crop_params,
    random_partial,
)
from svdformer_pointsea_tpu_torch.data.synthetic import write_55_tree
from svdformer_pointsea_tpu_torch.data.transforms import pc_norm
from svdformer_pointsea_tpu_torch.losses import get_loss_pm
from svdformer_pointsea_tpu_torch.nn import SVDFormer, has_zero_gradient
from svdformer_pointsea_tpu_torch.render import make_renderer
from svdformer_pointsea_tpu_torch.train import init_state, loop, make_train_step
from svdformer_pointsea_tpu_torch.train.convert import params_from_jax
from svdformer_pointsea_tpu_torch.train.evaluate import CROP_RATIO, eval_55, make_55_eval_fn
from test_torch_orchestration import _tiny_model

pytestmark = pytest.mark.usefixtures("jax_reference_modes")

GT, N_IN = 512, 128  # complete and partial clouds of the tests (8192 and 2048 at full size)
SLICE_TINY = dict(step1=2, step2=2, merge_points=128, local_points=128)  # test_torch_slice.py's
TINY = dict(step1=2, step2=2, merge_points=32, local_points=32)  # test_torch_train.py's
COMPLETION_ATOL = 2e-3  # tests/test_reference_parity.py's bound for whole-model outputs
CD_GATE = 0.01  # |ΔCD×10³| (docs/PARITY.md), here on CD-L2


def _cloud(rng, b, n, grid=False):
    """Unit-sphere-ish clouds; ``grid`` rounds them to a grid of 1/8, so that
    many points share a distance to a viewpoint (ties of the sort)."""
    x = (rng.rand(b, n, 3) - 0.5).astype(np.float32)
    if grid:
        x = np.round(x * 8) / 8
        x[:, n // 2:] = x[:, :n - n // 2]  # exact duplicates too
    return x.astype(np.float32)


def _port_cfg(root=None, **net):
    cfg = shapenet55_config()
    cfg = cfg.replace(network=dataclasses.replace(cfg.network, resolution=16, **(net or TINY)),
                      data=dataclasses.replace(cfg.data, gt_points=GT, n_points=N_IN))
    if root is None:
        return cfg
    return cfg.replace(
        data=dataclasses.replace(cfg.data, category_file=f"{root}/datasets/ShapeNet55",
                                 complete_points_path=f"{root}/shapenet_pc/%s", num_workers=2),
        train=dataclasses.replace(cfg.train, batch_size=2, n_epochs=2, save_freq=1),
        out_path=f"{root}/out")


# --- data ------------------------------------------------------------------


@pytest.mark.parametrize("n", [GT, 2048])
def test_crop_fixed_matches_jax_bit_for_bit(rng, n):
    """Every difficulty at 3 directions drawn as the train step draws them
    and at 2 fixed corners, on random clouds and on a grid with duplicated
    points (ties in the distance: the sort is stable on both sides)."""
    gt = np.concatenate([_cloud(rng, 2, n), _cloud(rng, 2, n, grid=True)])
    _, dirs = random_crop_params(np.random.RandomState(n), 3, n)
    for direction in list(dirs) + list(FIXED_CORNERS[[0, 7]]):
        d = np.broadcast_to(direction, (4, 3)).copy()
        for ratio in CROP_RATIO.values():
            num_crop = int(n * ratio)
            got = crop_fixed(t(gt), t(d), num_crop)
            want = jcrop.crop_fixed(jnp.asarray(gt), jnp.asarray(d), num_crop)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n,n_out", [(GT, N_IN), (2048, 512)])
def test_crop_random_resampled_matches_jax_bit_for_bit(rng, n, n_out):
    """Random sizes and directions, random and tied clouds: the zeroed rows
    of each masked block are never picked, so the kept partial, the crop
    and the train step's partial are the JAX package's, bit for bit."""
    gt = np.concatenate([_cloud(rng, 2, n), _cloud(rng, 2, n, grid=True)])
    num_crop, d = random_crop_params(np.random.RandomState(n), 4, n)
    got = crop_random_resampled(t(gt), t(d), t(num_crop), n_out)
    want = jcrop.crop_random_resampled(jnp.asarray(gt), jnp.asarray(d), jnp.asarray(num_crop),
                                       n_out)
    for g, w in zip(got, want):
        assert g.shape == (4, n_out, 3)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(random_partial(t(gt), t(d), t(num_crop), n_out).numpy(),
                                  got[0].numpy())
    assert (got[0].square().sum(-1) > 1e-3).all()  # no zeroed row was picked


def test_random_crop_params_match_jax():
    for seed, batch, n in ((0, 16, 8192), (3, 5, GT), (7, 1, 2048)):
        got = random_crop_params(np.random.RandomState(seed), batch, n)
        want = jcrop.random_crop_params(np.random.RandomState(seed), batch, n)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert ((n // 4 <= got[0]) & (got[0] <= 3 * n // 4)).all()


@pytest.fixture(scope="module")
def tree55(tmp_path_factory):
    root = tmp_path_factory.mktemp("shapenet55")
    write_55_tree(str(root), np.random.RandomState(0), {"train": 5, "test": 3}, gt_points=GT)
    return root


def test_55_loader_batches_match_jax_bit_for_bit(tree55):
    """ShapeNet55Dataset + Loader against the JAX package's over two epochs
    (batch 2 over 5 / 3 models: the last batch padded by repetition), and
    pc_norm itself."""
    cfg = _port_cfg(tree55)
    jcfg = jax_shapenet55_config().replace(data=dataclasses.replace(
        jax_shapenet55_config().data, category_file=cfg.data.category_file,
        complete_points_path=cfg.data.complete_points_path, gt_points=GT))
    for subset, shuffle in (("train", True), ("val", False), ("test", False)):
        port = Loader(make_dataset(cfg, subset, seed=7), 2, shuffle=shuffle, seed=7)
        ref = jpipeline.Loader(jdatasets.make_dataset(jcfg, subset, seed=7), 2, shuffle=shuffle,
                               seed=7)
        for epoch in (1, 2):
            port.set_epoch(epoch)
            ref.set_epoch(epoch)
            got, want = list(port), list(ref)
            assert len(got) == len(want) == (3 if subset == "train" else 2)
            for a, b in zip(got, want):
                assert (a.taxonomy_ids, a.model_ids, a.valid) == (b.taxonomy_ids, b.model_ids,
                                                                   b.valid)
                assert a.data["gtcloud"].shape == (2, GT, 3)
                np.testing.assert_array_equal(a.data["gtcloud"], b.data["gtcloud"])
            assert got[-1].valid == 1  # padded by repeating its first row
            np.testing.assert_array_equal(got[-1].data["gtcloud"][0], got[-1].data["gtcloud"][1])
    x = (np.random.RandomState(1).rand(100, 3) * 3).astype(np.float32)
    np.testing.assert_array_equal(pc_norm(x), jtransforms.pc_norm(x))


def test_55_configs_match_jax():
    from svdformer_pointsea_tpu.configs import shapenet34_config as jax_shapenet34_config

    for port, ref in ((shapenet55_config("hard", adv=True), jax_shapenet55_config("hard", True)),
                      (shapenet34_config(), jax_shapenet34_config()),
                      (shapenet34_config(unseen=True), jax_shapenet34_config(unseen=True))):
        for section in ("network", "data", "train"):
            p, r = getattr(port, section), getattr(ref, section)
            for field in dataclasses.fields(p):
                assert getattr(p, field.name) == getattr(r, field.name), (section, field.name)
        assert port.out_path == ref.out_path


# --- loss ------------------------------------------------------------------


def _row_weights(n: int) -> np.ndarray:
    w = np.ones(n, np.float32)
    w[1] = 0.0  # a pad row
    return w


@pytest.mark.parametrize("sqrt", [True, False])
def test_get_loss_pm_and_gradient_match_jax(rng, jax_difference_form_nn, sqrt):
    preds = [_cloud(rng, 3, n) for n in (16, 32, 64)]
    partial, gt = _cloud(rng, 3, 24), _cloud(rng, 3, 64)
    w = _row_weights(3)

    def jloss(p):
        return jlosses.get_loss_pm(tuple(p), jnp.asarray(partial), jnp.asarray(gt), sqrt=sqrt,
                                   weights=jnp.asarray(w))

    (want, want_parts), want_grads = jax.value_and_grad(jloss, has_aux=True)(
        [jnp.asarray(p) for p in preds])
    tp = [t(p).requires_grad_(True) for p in preds]
    loss, parts = get_loss_pm(tp, t(partial), t(gt), sqrt=sqrt, weights=t(w))
    loss.backward()
    close(loss, want, atol=0, rtol=1e-5)
    for got, exp in zip(parts, want_parts):
        close(got, exp, atol=0, rtol=1e-5)
    for got, exp in zip(tp, want_grads):
        close(got.grad, exp, atol=0, rtol=1e-5)
    assert not tp[2].grad[1].any()  # the pad row gets no gradient


# --- model, train step, evaluation ------------------------------------------


@pytest.fixture(scope="module")
def attn_case(jax_reference_modes):
    """The attention-decoder SVDFormer at test_torch_slice.py's sizes: the
    partial of one evaluation corner, the JAX completions and that corner's
    JAX metrics (make_55_eval_fn)."""
    rng = np.random.RandomState(5)
    gt = _cloud(rng, 2, GT)
    num_crop = int(GT * CROP_RATIO["median"])
    corner = FIXED_CORNERS[1:2]
    render = JaxPCViews(trans=-1.5, resolution=16)
    jpartial, _ = jcrop.crop_fixed(jnp.asarray(gt), jnp.broadcast_to(corner, (2, 3)), num_crop)
    partial = np.asarray(jcrop.fps_subsample(jpartial, N_IN))
    depth = np.asarray(render.get_img(jnp.asarray(partial)))
    jmodel = JaxSVDFormer(**SLICE_TINY, sdg_decoder=False, view_distance=1.5)
    variables = jax_variables(jmodel, partial, depth, seed=2)
    outs = [np.asarray(o) for o in jax.jit(jmodel.apply)(variables, partial, depth)]
    jeval = jevaluate.make_55_eval_fn(jmodel, render, num_crop, n_sample=N_IN)
    metrics = np.asarray(jeval(variables, jnp.asarray(gt), jnp.asarray(corner)))
    cfg = _port_cfg(**SLICE_TINY)
    model = load_port(SVDFormer.from_config(cfg.network), variables)
    return SimpleNamespace(gt=gt, partial=partial, outs=outs, metrics=metrics, corner=corner,
                           num_crop=num_crop, cfg=cfg, model=model)


def test_attn_decoder_completions_match_jax(attn_case):
    c = attn_case
    assert "refine1.decoder1.attn.q_proj.weight" in c.model.state_dict()
    assert "refine2.decoder2.norm13.weight" in c.model.state_dict()
    partial, _ = crop_fixed(t(c.gt), t(np.broadcast_to(c.corner, (2, 3)).copy()), c.num_crop)
    from svdformer_pointsea_tpu_torch.ops import fps_subsample

    partial = fps_subsample(partial, N_IN)
    np.testing.assert_array_equal(partial.numpy(), c.partial)
    with torch.inference_mode():
        outs = c.model(partial, make_renderer(c.cfg).get_img(partial))
    for got, want, n in zip(outs, c.outs, (256, 256, 512)):
        assert got.shape == (2, n, 3)
        close(got, want, atol=COMPLETION_ATOL)


def test_55_eval_corner_matches_jax(attn_case, capsys):
    c = attn_case
    eval_fn = make_55_eval_fn(c.model, make_renderer(c.cfg), c.num_crop, n_sample=N_IN)
    got = eval_fn(t(c.gt), t(c.corner)).numpy()
    assert got.shape == (1, 3, 2) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got[:, 0], c.metrics[:, 0], atol=CD_GATE)
    np.testing.assert_allclose(got[:, 1:], c.metrics[:, 1:], atol=1e-3)
    # eval_55 over one corner: the table with its mean-class row, the pad row out.
    batch = SimpleNamespace(data={"gtcloud": c.gt}, taxonomy_ids=["a", "b"], valid=1)
    cfg = c.cfg.replace(data=dataclasses.replace(c.cfg.data, mode="median"))
    mean_cd = eval_55(cfg, c.model, [batch], n_viewpoints=2)
    lines = capsys.readouterr().out.strip().splitlines()
    assert [line.split("\t")[0] for line in lines] == ["Taxonomy", "a", "Overall", "MeanClass"]
    assert lines[1].split("\t")[1] == "2"  # two corners of one sample
    assert abs(float(lines[1].split("\t")[2]) - mean_cd) < 1e-4
    assert abs(got[0, 0, 0] - eval_fn(t(c.gt), t(FIXED_CORNERS[:2])).numpy()[1, 0, 0]) < 1e-4


def test_adamw_matches_optax():
    """torch.optim.AdamW as the 55 track builds it (wd 5e-4, eps 1e-8) against
    the JAX package's optax.adamw, three steps at changing LRs."""
    rng = np.random.RandomState(4)
    params = {"a": rng.randn(7, 5).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    jopt = jstate.make_optimizer(weight_decay=5e-4)
    jparams, jst = params, jopt.init(params)
    tparams = {k: torch.nn.Parameter(t(v)) for k, v in params.items()}
    cfg = shapenet55_config()
    opt = port_train.make_optimizer(list(tparams.values()), cfg.train.weight_decay,
                                    cfg.train.betas)
    assert isinstance(opt, torch.optim.AdamW)
    for lr, g in zip((1e-3, 5e-4, 2e-3), grads):
        jst = jstate._set_lr(jst, lr)
        updates, jst = jopt.update(g, jst, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, updates)
        for k, p in tparams.items():
            p.grad = t(g[k])
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        for k, p in tparams.items():
            close(p, jparams[k], atol=1e-7, rtol=1e-6)


def test_two_55_train_steps_match_jax(rng, jax_difference_form_nn):
    """Two crop + render + train-mode forward + get_loss_pm + AdamW steps of
    a tiny attention-decoder SVDFormer (B 4 with a pad row, gt 512 -> 128
    partial points, 16² render) through the port and through the JAX
    package's make_train_step(crop_n_out=128), at the LRs train_net gives
    the first two steps (warmup): loss and parts of both steps within 1e-5
    relative, AdamW's first moment after step 1 within 5e-3 (L2) per leaf
    and below 1e-6 where the exact gradient is 0 (tests/test_torch_train.py's
    bounds). (At lr 1e-4, past the warmup, one step of this random model
    multiplies its loss by 5, and the second loss then carries the first
    step's sign flips at near-zero gradients, ±lr each, to 1e-4 relative.)"""
    B = 4
    gt = _cloud(rng, B, GT)
    num_crop, direction = random_crop_params(np.random.RandomState(3), B, GT)
    w = _row_weights(B)
    cfg = _port_cfg()
    lrs = [port_train.make_lr_fn(cfg)(s, 0) for s in (1, 2)]
    render = JaxPCViews(trans=-1.5, resolution=16)
    jmodel = JaxSVDFormer(**TINY, sdg_decoder=False, view_distance=1.5)
    partial = np.asarray(jcrop.crop_random_resampled(
        jnp.asarray(gt), jnp.asarray(direction), jnp.asarray(num_crop), N_IN)[0])
    variables = jax_variables(jmodel, partial, np.asarray(render.get_img(jnp.asarray(partial))),
                              seed=1)
    jopt = jstate.make_optimizer(weight_decay=5e-4)
    jst = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                            batch_stats=variables["batch_stats"],
                            opt_state=jopt.init(variables["params"]))
    jstep = jstate.make_train_step(jmodel, jopt, sqrt_loss=False, partial_matching=True,
                                   donate=False, render_fn=render.render, crop_n_out=N_IN)
    start = params_from_jax(variables)
    del variables
    want = []
    for i, lr in enumerate(lrs):
        jst, jm = jstep(jst, gt, direction, num_crop, w, lr)
        want.append({key: float(val) for key, val in jm.items()})
        if i == 0:
            want_mu = params_from_jax({"params": jst.opt_state.inner_state[0].mu})
    del jst, jstep

    model = SVDFormer.from_config(cfg.network)
    model.load_state_dict(start, strict=True)
    state = init_state(cfg, model)
    step = make_train_step(model, state.optimizer, cfg.train.sqrt_loss,
                           make_renderer(cfg).get_img, partial_matching=True, crop_n_out=N_IN)
    params = dict(model.named_parameters())
    assert want_mu.keys() == params.keys()
    for i, lr in enumerate(lrs):
        state, m = step(state, t(gt), t(direction), t(num_crop), t(w), lr)
        for key in ("loss", "cdc", "cd1", "cd2"):
            close(m[key], want[i][key], atol=0, rtol=1e-5)
        if i == 0:
            for name, mu_want in want_mu.items():
                mu = state.optimizer.state[params[name]]["exp_avg"]
                if has_zero_gradient(name):
                    assert max(mu.abs().max(), mu_want.abs().max()) <= 1e-6, name
                else:
                    err = torch.linalg.norm(mu - mu_want) / torch.linalg.norm(mu_want)
                    assert err <= 5e-3, (name, err.item())
    assert state.step == 2


# --- main_55 ------------------------------------------------------------------


def _tiny_55(root):
    """shapenet55_config cut to the tiny model over the tree at ``root``
    (batch 2 over 3 train and 2 test models, 2 epochs)."""

    def tiny(mode="easy", adv=False):
        small = _port_cfg(root)
        return small.replace(data=dataclasses.replace(small.data, mode=mode),
                             train=dataclasses.replace(small.train, adv_enabled=adv))

    return tiny


@pytest.fixture(scope="module")
def run55(tmp_path_factory):
    """main_55 --epochs 2 on a write_55_tree tree with the stand-in model (2
    steps an epoch, the last batch padded), under deterministic algorithms."""
    root = tmp_path_factory.mktemp("55")
    write_55_tree(str(root), np.random.RandomState(0), {"train": 3, "test": 2}, gt_points=GT)
    out = str(root / "out")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "shapenet55_config", _tiny_55(root))
        mp.setattr(loop, "build_model", _tiny_model)
        torch.use_deterministic_algorithms(True)
        try:
            state, best = cli.main_55(["--epochs", "2", "--out", out], device="cpu")
        finally:
            torch.use_deterministic_algorithms(False)
    return SimpleNamespace(root=root, out=out, state=state, best=best)


def test_main_55_trains_and_tests(run55, monkeypatch, capsys):
    """Two epochs with validation by eval_55 on the test split and
    checkpoints, then --test at another mode from the best checkpoint."""
    assert run55.state.step == 4 and np.isfinite(run55.best)
    ckpts = sorted(os.listdir(os.path.join(run55.out, "checkpoints")))
    assert ckpts[-2:] == ["ckpt-epoch-001.pt", "ckpt-epoch-002.pt"] and "ckpt-best.pt" in ckpts
    monkeypatch.setattr(cli, "shapenet55_config", _tiny_55(run55.root))
    monkeypatch.setattr(loop, "build_model", _tiny_model)
    capsys.readouterr()
    mean_cd = cli.main_55(["--test", "--mode", "hard", "--weights",
                           os.path.join(run55.out, "checkpoints", "ckpt-best.pt")], device="cpu")
    rows = {line.split("\t")[0]: line.split("\t")
            for line in capsys.readouterr().out.splitlines() if "\t" in line}
    assert {"Overall", "MeanClass"} <= set(rows)
    assert sum(int(r[1]) for k, r in rows.items() if k.isdigit()) == 2 * 8  # 2 models x 8 corners
    assert np.isfinite(mean_cd) and abs(float(rows["Overall"][2]) - mean_cd) < 1e-4


def test_55_resume_replays_the_straight_run(run55, monkeypatch):
    """One epoch then a resume from ckpt-epoch-001 against the two straight
    epochs: the crop draws come from (seed, epoch, 55), so parameters,
    statistics, AdamW's state and the best metric end bit-equal."""
    monkeypatch.setattr(cli, "shapenet55_config", _tiny_55(run55.root))
    monkeypatch.setattr(loop, "build_model", _tiny_model)
    first = os.path.join(run55.out, "checkpoints", "ckpt-epoch-001.pt")
    torch.use_deterministic_algorithms(True)
    try:
        resumed, best_r = cli.main_55(["--epochs", "2", "--out", run55.out + "_r", "--weights",
                                       first], device="cpu")
    finally:
        torch.use_deterministic_algorithms(False)
    straight = run55.state
    assert resumed.step == straight.step == 4 and best_r == run55.best
    want = straight.model.state_dict()
    for name, got in resumed.model.state_dict().items():
        assert torch.equal(got, want[name]), name
    opt, opt_r = straight.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    for key in opt:
        for field in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(opt[key][field], opt_r[key][field]), (key, field)


@pytest.mark.parametrize("flag,suffix", [("55", "ShapeNet55"), ("34", "ShapeNet34"),
                                         ("unseen21", "ShapeNet-Unseen21")])
def test_main_55_dataset_presets(monkeypatch, flag, suffix):
    """The cases of tests/test_cli.py: --dataset picks the index directory
    only, --mode reaches test_net and the configuration."""
    calls = []
    monkeypatch.setattr(port_train, "test_net", lambda cfg, device=None, mode=None: calls.append(
        (cfg, device, mode)))
    cli.main_55(["--dataset", flag, "--mode", "median", "--test", "--weights", "w"],
                device="cpu")
    cfg, device, mode = calls.pop()
    assert cfg.data.category_file.endswith(suffix) and (device, mode) == ("cpu", "median")
    assert cfg.data.gt_points == 8192 and cfg.data.mode == "median"
    assert cfg.network == shapenet55_config().network


def test_main_55_default_dataset(monkeypatch):
    calls = []
    monkeypatch.setattr(port_train, "train_net", lambda cfg, device=None: calls.append(cfg))
    cli.main_55(["--epochs", "3"], device="cpu")
    cfg = calls.pop()
    assert cfg.data.category_file.endswith("ShapeNet55") and cfg.data.mode == "easy"
    assert cfg.train.n_epochs == 3 and cfg.train.weight_decay == 5e-4
