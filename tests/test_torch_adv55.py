"""The port's adversarial ShapeNet-55 branch vs the JAX package on the CPU:
the BCE term, SimplePointDiscriminator, one adversarial step (D update, then
the generator through the same forward) against make_adv55_train_step with
mesh=None, and ``main_55`` with the branch on (with the stand-in model of
test_torch_orchestration.py). The JAX step is compiled once, at gt 512 and 128
input points."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_parity import close, jax_difference_form_nn, jax_reference_modes, jax_variables, t  # noqa: F401
from svdformer_pointsea_tpu.data import crop as jcrop
from svdformer_pointsea_tpu.nn import SimplePointDiscriminator as JaxDiscriminator
from svdformer_pointsea_tpu.nn import SVDFormer as JaxSVDFormer
from svdformer_pointsea_tpu.render import PCViews as JaxPCViews
from svdformer_pointsea_tpu.train import gan as jgan
from svdformer_pointsea_tpu.train import state as jstate
from svdformer_pointsea_tpu_torch import cli
from svdformer_pointsea_tpu_torch.data import random_crop_params
from svdformer_pointsea_tpu_torch.data.synthetic import write_55_tree
from svdformer_pointsea_tpu_torch.nn import SimplePointDiscriminator, SVDFormer
from svdformer_pointsea_tpu_torch.render import make_renderer
from svdformer_pointsea_tpu_torch.train import init_state, loop, make_lr_fn
from svdformer_pointsea_tpu_torch.train.convert import params_from_jax
from svdformer_pointsea_tpu_torch.train.gan import (
    bce_logits,
    create_adv55_state,
    make_adv55_train_step,
)
from test_torch_55 import GT, N_IN, TINY, _cloud, _port_cfg, _row_weights
from test_torch_orchestration import _tiny_model

pytestmark = pytest.mark.usefixtures("jax_reference_modes")


def _rel(got: torch.Tensor, want) -> float:
    want = torch.as_tensor(np.asarray(want))
    return (torch.linalg.norm(got.detach() - want) / torch.linalg.norm(want)).item()


@pytest.mark.parametrize("target", [0.0, 1.0])
def test_bce_logits_matches_jax(rng, target):
    logits = (rng.randn(5, 1) * 4).astype(np.float32)
    w = _row_weights(5)
    for weights in (None, w):
        want = jgan._bce_logits(jnp.asarray(logits), target,
                                None if weights is None else jnp.asarray(weights))
        got = bce_logits(t(logits), target, None if weights is None else t(weights))
        close(got, want, atol=0, rtol=1e-6)


def test_discriminator_matches_jax(rng):
    pcd = _cloud(rng, 3, 200)
    jd = JaxDiscriminator()
    variables = jax_variables(jd, pcd, seed=3)
    d = SimplePointDiscriminator()
    d.load_state_dict(params_from_jax(variables), strict=True)
    with torch.no_grad():
        got = d(t(pcd))
    assert got.shape == (3, 1)
    close(got, jd.apply(variables, pcd), atol=1e-5, rtol=1e-5)


def test_adv55_step_matches_jax(rng, jax_difference_form_nn):
    """One adversarial step of a tiny attention-decoder SVDFormer and the
    discriminator (d_steps 1; B 4 with a pad row, gt 512 -> 128 partial
    points) through the port and through make_adv55_train_step(mesh=None):
    the generator's loss, its BCE term, the D loss and the pyramid parts
    within 1e-5 relative; every D parameter after its Adam step within
    1e-5 relative (L2); the generator's parameters moved."""
    B = 4
    gt = _cloud(rng, B, GT)
    num_crop, direction = random_crop_params(np.random.RandomState(5), B, GT)
    w = _row_weights(B)
    cfg = _port_cfg()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, adv_enabled=True))
    lr, d_lr = make_lr_fn(cfg)(1, 0), cfg.train.adv_d_lr
    render = JaxPCViews(trans=-1.5, resolution=16)
    jmodel = JaxSVDFormer(**TINY, sdg_decoder=False, view_distance=1.5)
    partial = np.asarray(jcrop.crop_random_resampled(
        jnp.asarray(gt), jnp.asarray(direction), jnp.asarray(num_crop), N_IN)[0])
    variables = jax_variables(jmodel, partial, np.asarray(render.get_img(jnp.asarray(partial))),
                              seed=1)
    jd = JaxDiscriminator()
    d_variables = jax_variables(jd, gt, seed=4)
    jopt, jd_opt = jstate.make_optimizer(weight_decay=5e-4), jstate.make_optimizer()
    jst = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                            batch_stats=variables["batch_stats"],
                            opt_state=jopt.init(variables["params"]))
    jadv = jgan.AdvAuxState(d_params=d_variables["params"],
                            d_opt_state=jd_opt.init(d_variables["params"]))
    jstep = jgan.make_adv55_train_step(
        jmodel, jd, jopt, jd_opt, sqrt_loss=False, lambda_g=cfg.train.adv_lambda_g, d_steps=1,
        render_fn=render.render, crop_n_out=N_IN, mesh=None, donate=False)
    start = params_from_jax(variables)
    del variables
    jst, jadv, jm = jstep(jst, jadv, gt, direction, num_crop, w, lr, jnp.float32(d_lr))
    want = {key: float(val) for key, val in jm.items()}
    want_d = params_from_jax({"params": jadv.d_params})
    del jst, jadv, jstep

    model = SVDFormer.from_config(cfg.network)
    model.load_state_dict(start, strict=True)
    state = init_state(cfg, model)
    adv = create_adv55_state(cfg, "cpu", seed=cfg.seed)
    adv.model.load_state_dict(params_from_jax(d_variables), strict=True)
    step = make_adv55_train_step(model, state.optimizer, sqrt_loss=False,
                                 lambda_g=cfg.train.adv_lambda_g, d_steps=1,
                                 render_fn=make_renderer(cfg).get_img, crop_n_out=N_IN)
    state, adv, m = step(state, adv, t(gt), t(direction), t(num_crop), t(w), lr, d_lr)
    assert set(m) == set(want)
    for key, val in want.items():
        close(m[key], val, atol=0, rtol=1e-5)
    d_state = adv.model.state_dict()
    assert d_state.keys() == want_d.keys()
    for name, val in want_d.items():
        assert _rel(d_state[name], val) <= 1e-5, name
        assert not torch.equal(d_state[name], params_from_jax(d_variables)[name]), name
    moved = [not torch.equal(p, start[n]) for n, p in model.state_dict().items()
             if n.endswith("weight")]
    assert all(moved) and state.step == 1


@pytest.fixture
def tiny55_adv(monkeypatch, tmp_path):
    root = tmp_path / "55"
    write_55_tree(str(root), np.random.RandomState(1), {"train": 3, "test": 1}, gt_points=GT)

    def tiny(mode="easy", adv=False):
        cfg = _port_cfg(root)
        return cfg.replace(train=dataclasses.replace(cfg.train, adv_enabled=True, n_epochs=1))

    monkeypatch.setattr(cli, "shapenet55_config", tiny)
    monkeypatch.setattr(loop, "build_model", _tiny_model)
    return root


def test_main_55_trains_with_the_adversarial_branch(tiny55_adv, monkeypatch):
    """main_55 with adv_enabled: every step takes the adversarial step, and
    the run validates and checkpoints the generator only."""
    steps = []
    real = loop.make_adv55_train_step

    def spy(*args, **kw):
        inner = real(*args, **kw)

        def counted(*a):
            out = inner(*a)
            steps.append({k: float(v) for k, v in out[2].items()})
            return out

        return counted

    monkeypatch.setattr(loop, "make_adv55_train_step", spy)
    out = str(tiny55_adv / "out")
    state, best = cli.main_55(["--out", out], device="cpu")
    assert state.step == len(steps) == 2 and np.isfinite(best)
    assert all(np.isfinite(list(s.values())).all() and s["d_loss"] > 0 for s in steps)
    ckpt = torch.load(os.path.join(out, "checkpoints", "ckpt-best.pt"), weights_only=True)
    assert set(ckpt["model"]) == set(state.model.state_dict())  # the generator's alone
