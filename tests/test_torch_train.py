"""The port's PCN train step vs the JAX package on the CPU: train-mode
BatchNorm, the image trunk in train mode, the pyramid loss and its gradient,
the LR schedule, the plain flash-attention backward, and two whole train
steps of a tiny SVDFormer. Inputs and weights come from numpy seeds; the JAX
train step is compiled once, inside its one test."""

import dataclasses

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
    t,
)
from svdformer_pointsea_tpu import losses as jlosses
from svdformer_pointsea_tpu.nn import SVDFormer as JaxSVDFormer
from svdformer_pointsea_tpu.nn import flash_vjp
from svdformer_pointsea_tpu.nn import layers as jl
from svdformer_pointsea_tpu.nn import resnet as jr
from svdformer_pointsea_tpu.render import PCViews as JaxPCViews
from svdformer_pointsea_tpu.train import state as jstate
from svdformer_pointsea_tpu_torch import kernels
from svdformer_pointsea_tpu_torch.configs import pcn_config
from svdformer_pointsea_tpu_torch.losses import get_loss
from svdformer_pointsea_tpu_torch.nn import SVDFormer, flash, has_zero_gradient
from svdformer_pointsea_tpu_torch.nn.layers import BatchNorm, bn_row_weights, naive_attention
from svdformer_pointsea_tpu_torch.nn.resnet import ImageTrunk
from svdformer_pointsea_tpu_torch.render import make_renderer
from svdformer_pointsea_tpu_torch.train import (
    build_model,
    init_state,
    make_lr_fn,
    make_train_step,
    reference_lr_schedule,
)
from svdformer_pointsea_tpu_torch.train.convert import params_from_jax

pytestmark = pytest.mark.usefixtures("jax_reference_modes")

TINY = dict(step1=2, step2=2, merge_points=32, local_points=32)
FLASH_TOL = dict(atol=2e-4, rtol=2e-4)  # tests/test_flash_vjp.py's bound


def _pts(rng, *shape):
    return ((rng.rand(*shape) - 0.5) * 0.8).astype(np.float32)


def _row_weights(n: int) -> np.ndarray:
    w = np.ones(n, np.float32)
    w[1] = 0.0  # a pad row
    return w


@pytest.mark.parametrize("shape,dim,n_w", [
    ((4, 5, 6), -1, 4),     # one weight per row
    ((12, 5, 6), -1, 4),    # k = 3 consecutive rows per weight
    ((6, 3, 4, 5), 1, 2),   # NCHW, the image trunk's B x 3-view fold
])
def test_batchnorm_train_mode_matches_jax(rng, shape, dim, n_w):
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    w = _row_weights(n_w)
    x_last = np.moveaxis(x, dim, -1)
    with jl.bn_row_weights(jnp.asarray(w)):
        jbn = jl.BatchNorm(use_running_average=False)
        variables = jax_variables(jbn, x_last)
        y, mut = jbn.apply(variables, x_last, mutable=["batch_stats"])
    bn = BatchNorm(shape[dim], dim=dim)
    bn.load_state_dict(params_from_jax(variables), strict=True)
    bn.train()
    with bn_row_weights(t(w)), torch.no_grad():
        out = bn(t(x))
    close(out, np.moveaxis(np.asarray(y), -1, dim), atol=1e-5)
    close(bn.running_mean, mut["batch_stats"]["mean"], atol=1e-5)
    close(bn.running_var, mut["batch_stats"]["var"], atol=1e-5)


def test_image_trunk_train_mode_matches_jax(rng):
    """Against the JAX train trace as it runs (space-to-depth packed stem and
    layer1): output and every new running statistic."""
    x = rng.rand(6, 16, 16, 1).astype(np.float32)  # 2 samples x 3 views, NHWC
    w = _row_weights(2)
    with jl.bn_row_weights(jnp.asarray(w)):
        jt = jr.ImageTrunk(feat_size=4)
        variables = jax_variables(jt, x)  # the packed trace has the same tree
        y, mut = jax.jit(lambda v, x: jt.apply(v, x, train=True, mutable=["batch_stats"]))(
            variables, x)
    trunk = ImageTrunk(feat_size=4)
    trunk.load_state_dict(params_from_jax(variables), strict=True)
    trunk.train()
    with bn_row_weights(t(w)), torch.no_grad():
        out = trunk(t(x).permute(0, 3, 1, 2))
    close(out, y, atol=2e-5)
    new_stats = params_from_jax({"batch_stats": mut["batch_stats"]})
    assert len(new_stats) == 2 * sum(isinstance(m, BatchNorm) for m in trunk.modules())
    state = trunk.state_dict()
    for name, want in new_stats.items():
        close(state[name], want.numpy(), atol=2e-5)


@pytest.mark.parametrize("sqrt", [True, False])
def test_get_loss_and_gradient_match_jax(rng, jax_difference_form_nn, sqrt):
    preds = [_pts(rng, 3, n, 3) for n in (16, 32, 64)]
    gt = _pts(rng, 3, 64, 3)
    w = _row_weights(3)

    def jloss(p):
        loss, parts = jlosses.get_loss(tuple(p), jnp.asarray(gt), sqrt=sqrt, weights=jnp.asarray(w))
        return loss, parts

    (want, want_parts), want_grads = jax.value_and_grad(jloss, has_aux=True)(
        [jnp.asarray(p) for p in preds])
    tp = [t(p).requires_grad_(True) for p in preds]
    loss, parts = get_loss(tp, t(gt), sqrt=sqrt, weights=t(w))
    loss.backward()
    close(loss, want, atol=0, rtol=1e-5)
    for got, exp in zip(parts, want_parts):
        close(got, exp, atol=0, rtol=1e-5)
    for got, exp in zip(tp, want_grads):
        close(got.grad, exp, atol=0, rtol=1e-5)
    assert not tp[0].grad[1].any()  # the pad row gets no gradient


def test_lr_schedule_matches_reference():
    """The cases of tests/test_train_sharding.py::test_lr_schedule_reference_semantics,
    then the PCN schedule against the JAX package's on a grid."""
    lr = reference_lr_schedule(1e-4, 300, [40, 80, 120], 0.7)
    assert lr(0, 0) == 0.0
    assert np.isclose(lr(150, 0), 1e-4 * 0.5)
    assert np.isclose(lr(300, 0), 1e-4)
    assert np.isclose(lr(5000, 0), 1e-4)
    assert np.isclose(lr(5000, 39), 1e-4)
    assert np.isclose(lr(5000, 40), 1e-4 * 0.7)
    assert np.isclose(lr(5000, 80), 1e-4 * 0.49)
    lr55 = reference_lr_schedule(1e-4, 300, 2, 0.98)
    assert np.isclose(lr55(1000, 0), 1e-4)
    assert np.isclose(lr55(1000, 2), 1e-4 * 0.98)
    assert np.isclose(lr55(1000, 5), 1e-4 * 0.98**2)
    tc = pcn_config().train
    want = jstate.reference_lr_schedule(tc.learning_rate, tc.warmup_steps, list(tc.lr_decay_step),
                                        tc.gamma)
    got = make_lr_fn(pcn_config())
    for step in (0, 1, 299, 300, 301, 10_000):
        for epoch in (0, 39, 40, 100, 359, 360, 399):
            assert got(step, epoch) == want(step, epoch)


def _attention_case(lq: int, lk: int):
    """q, k, v, do in JAX's (B, h, L, dh) layout and the flash residuals as
    the upstream forward defines them (m = rowmax of the scaled logits,
    l = rowsum exp(s - m), di = rowsum(o * do))."""
    rng = np.random.default_rng(0)
    b, h, dh = 2, 2, 64
    q, k, v = (rng.standard_normal((b, h, n, dh)).astype(np.float32) for n in (lq, lk, lk))
    do = rng.standard_normal((b, h, lq, dh)).astype(np.float32)
    scale = 1.0 / np.sqrt(dh)
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k) * scale
    m = jnp.max(s, axis=-1)
    l = jnp.sum(jnp.exp(s - m[..., None]), axis=-1)
    o = jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(s, axis=-1), v)
    di = jnp.sum(o * do, axis=-1)
    return q, k, v, do, m, l, di, scale


def _port(x):
    """(B, h, L, dh) numpy / JAX -> the port's (B, L, h, dh) tensor."""
    return t(x).transpose(1, 2).contiguous()


def _port_residuals(m, l, di):
    lse = t(m + jnp.log(l))
    return lse, t(di)


@pytest.mark.parametrize("lq,lk,block_q,block_k_major,block_k",
                         [(256, 256, 128, 128, 128), (256, 512, 256, 256, 128)])
def test_plain_dq_matches_jax_dq_kernel(lq, lk, block_q, block_k_major, block_k):
    """The plain version of K5 vs the JAX package's dq Pallas kernel in
    interpret mode, fed the same residuals (the cases of tests/test_flash_vjp.py)."""
    q, k, v, do, m, l, di, scale = _attention_case(lq, lk)
    flash_vjp._INTERPRET = True
    try:
        want = flash_vjp._bwd_dq_di128(q, k, v, l, m, do, di, block_q_major=block_q,
                                       block_k_major=block_k_major, block_k=block_k,
                                       sm_scale=scale)
    finally:
        flash_vjp._INTERPRET = False
    lse, tdi = _port_residuals(m, l, di)
    got = flash.attention_bwd_dq_plain(_port(q), _port(k), _port(v), lse, _port(do), tdi)
    close(got.transpose(1, 2), want, **FLASH_TOL)


@pytest.mark.parametrize("lq,lk", [(256, 256), (256, 512)])
def test_plain_dkv_matches_jax_grad(lq, lk):
    """The plain version of K4 vs jax.grad of naive attention."""
    q, k, v, do, m, l, di, scale = _attention_case(lq, lk)

    def naive(k_, v_):
        s = jnp.einsum("bhqd,bhkd->bhqk", q, k_) * scale
        return jnp.vdot(jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(s, axis=-1), v_), do)

    want_dk, want_dv = jax.grad(naive, argnums=(0, 1))(jnp.asarray(k), jnp.asarray(v))
    lse, tdi = _port_residuals(m, l, di)
    dk, dv = flash.attention_bwd_dkv_plain(_port(q), _port(k), _port(v), lse, _port(do), tdi)
    close(dk.transpose(1, 2), want_dk, **FLASH_TOL)
    close(dv.transpose(1, 2), want_dv, **FLASH_TOL)


def test_flash_function_cpu_autograd_matches_naive():
    """FlashAttention on CPU tensors (the plain forward with statistics and
    the plain backward) vs autograd through naive_attention; no kernel runs."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, n, 4, 96)).astype(np.float32))
               for n in (128, 192, 192))
    do = torch.from_numpy(rng.standard_normal((2, 128, 4, 96)).astype(np.float32))
    before = dict(kernels.launches)
    ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = flash.flash_attention_train(*ins)
    got = torch.autograd.grad(out, ins, do)
    ref_ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref = naive_attention(*ref_ins)
    want = torch.autograd.grad(ref, ref_ins, do)
    close(out, ref.detach().numpy(), atol=1e-5)
    for g, w in zip(got, want):
        close(g, w.numpy(), **FLASH_TOL)
    assert kernels.launches == before


def test_two_train_steps_match_jax(rng, jax_difference_form_nn):
    """Two steps of a tiny SVDFormer (step 2/2, merge and local 32, B 4 with a
    pad row, N 128, gt 128, 16² render) through the port and through the
    JAX package's make_train_step: losses and parts of both steps (rtol
    1e-5); Adam's first moment after step 1 (0.1 x the gradient) per leaf,
    ‖Δ‖₂ ≤ 5e-3 ‖ref‖₂ (kNN membership at near-ties and f32 sum order move
    the first SA stage's gradients by up to 1.5e-3); parameters after step 2
    within 2.5e-4 (a first Adam step moves a weight by ±lr, so a tiny
    gradient of the other sign costs 2 lr: tests/test_train_sharding.py's
    bound); BN running statistics after each step within 1e-5. Leaves of
    zero exact gradient hold noise: their first moments must stay below 1e-6
    on both sides and, as each step moves them by less than lr either way,
    their parameters within 4 lr; a running mean after step 2 takes 0.1 of
    that from the bias before its BatchNorm."""
    B, lr = 4, 1e-4
    partial, gt = _pts(rng, B, 128, 3), _pts(rng, B, 128, 3)
    w = _row_weights(B)
    render = JaxPCViews(trans=-0.7, resolution=16)
    jmodel = JaxSVDFormer(**TINY)
    variables = jax_variables(jmodel, partial, np.asarray(render.get_img(jnp.asarray(partial))),
                              seed=1)
    jopt = jstate.make_optimizer()
    jst = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                            batch_stats=variables["batch_stats"],
                            opt_state=jopt.init(variables["params"]))
    jstep = jstate.make_train_step(jmodel, jopt, donate=False, render_fn=render.render)
    # Keep what the comparison reads and let each JAX state go as soon as it
    # can: the 41 M-parameter trees of both sides need not be alive together.
    start = params_from_jax(variables)
    del variables
    jst1, jm1 = jstep(jst, partial, gt, w, lr)
    del jst
    want_mu = params_from_jax({"params": jst1.opt_state.inner_state[0].mu})
    want_stats1 = params_from_jax({"batch_stats": jst1.batch_stats})
    jst2, jm2 = jstep(jst1, partial, gt, w, lr)
    del jst1
    want_metrics = [{key: float(val) for key, val in m.items()} for m in (jm1, jm2)]
    want_state = params_from_jax({"params": jst2.params, "batch_stats": jst2.batch_stats})
    del jst2, jstep

    cfg = pcn_config()
    cfg = cfg.replace(network=dataclasses.replace(cfg.network, resolution=16, **TINY))
    model = SVDFormer.from_config(cfg.network)
    model.load_state_dict(start, strict=True)
    del start
    state = init_state(cfg, model)
    step = make_train_step(model, state.optimizer, cfg.train.sqrt_loss,
                           make_renderer(cfg).get_img)
    state, m1 = step(state, t(partial), t(gt), t(w), lr)
    params = dict(model.named_parameters())
    assert want_mu.keys() == params.keys()
    for name, want in want_mu.items():
        mu = state.optimizer.state[params[name]]["exp_avg"]
        if has_zero_gradient(name):
            assert max(mu.abs().max(), want.abs().max()) <= 1e-6, name
        else:
            err = torch.linalg.norm(mu - want) / torch.linalg.norm(want)
            assert err <= 5e-3, (name, err.item())
    buffers = dict(model.named_buffers())
    assert want_stats1.keys() <= buffers.keys()
    for name, want in want_stats1.items():
        close(buffers[name], want.numpy(), atol=1e-5)
    state, m2 = step(state, t(partial), t(gt), t(w), lr)
    assert state.step == 2

    for got, want in zip((m1, m2), want_metrics):
        for key in ("loss", "cdc", "cd1", "cd2"):
            close(got[key], want[key], atol=0, rtol=1e-5)
    got_state = model.state_dict()
    for name, want in want_state.items():
        if name in want_stats1:
            bias = name.replace(".bn", ".conv").replace(".running_mean", ".bias")
            atol = 1e-5 + (0.1 * 4 * lr if has_zero_gradient(bias) else 0.0)
        else:
            atol = 4 * lr if has_zero_gradient(name) else 2.5e-4
        close(got_state[name], want.numpy(), atol=atol)


def test_build_model_defaults_to_the_card(monkeypatch):
    cfg = pcn_config()
    cfg = cfg.replace(network=dataclasses.replace(cfg.network, **TINY))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    model = build_model(cfg, device="cpu", seed=3)
    assert all(p.device.type == "cpu" for p in model.parameters())
    want = torch.Generator().manual_seed(3)
    first = model.encoder.img_trunk.stem_conv.weight  # the first weight init_parameters draws
    bound = 1.0 / np.sqrt(first[0].numel())
    assert torch.equal(first, torch.rand(first.shape, generator=want) * (2 * bound) - bound)
