"""The port's bf16 mode (--precision bf16) vs the JAX package's on the CPU:
the bf16 plain versions of the flash kernels against the upstream Pallas
kernels run on bf16 inputs in TPU interpret mode, the bf16 image trunk, and
the train-mode loss of a tiny SVDFormer in bf16 mode. On the CPU both
packages take the naive f32 attention (their flash paths need the TPU or a
CUDA card), so there bf16 mode changes the image trunk only."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as upstream

from port_parity import close, jax_mixed_precision, jax_reference_modes, jax_variables, t  # noqa: F401
from svdformer_pointsea_tpu import losses as jlosses
from svdformer_pointsea_tpu.nn import SVDFormer as JaxSVDFormer
from svdformer_pointsea_tpu.nn import flash_vjp
from svdformer_pointsea_tpu.nn import layers as jl
from svdformer_pointsea_tpu.nn import resnet as jr
from svdformer_pointsea_tpu.render import PCViews as JaxPCViews
from svdformer_pointsea_tpu_torch.configs import pcn_config
from svdformer_pointsea_tpu_torch.losses import get_loss
from svdformer_pointsea_tpu_torch.nn import SVDFormer, flash, mixed_precision
from svdformer_pointsea_tpu_torch.nn.layers import bn_row_weights
from svdformer_pointsea_tpu_torch.nn.resnet import ImageTrunk
from svdformer_pointsea_tpu_torch.render import make_renderer
from svdformer_pointsea_tpu_torch.train.convert import params_from_jax

pytestmark = pytest.mark.usefixtures("jax_reference_modes")

BF16_REL = 1e-2  # |Δ| ≤ 1e-2 · max|ref| for a bf16 output (8 significand bits)
LSE_RTOL = 1e-5  # the log-sum-exp stays f32
TINY = dict(step1=2, step2=2, merge_points=32, local_points=32)


def _bf16_close(got: torch.Tensor, want) -> float:
    """Worst |Δ| / max|ref| of a bf16 port tensor in the (B, L, h, dh) layout
    against a JAX (B, h, L, dh) array; asserts it is within BF16_REL."""
    want = np.asarray(jnp.asarray(want, jnp.float32)).transpose(0, 2, 1, 3)
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= BF16_REL, err
    return err


@pytest.mark.parametrize("lq,lk,dh,block,spread", [
    pytest.param(256, 256, 64, 128, 1.0, id="256-256-64-128"),
    pytest.param(256, 256, 96, 128, 1.0, id="256-256-96-128"),
    pytest.param(128, 256, 64, 128, 1.0, id="128-256-64-128"),
    pytest.param(256, 256, 128, 128, 1.0, id="256-256-128-128"),
    pytest.param(256, 256, 64, 128, 8.0, id="256-256-64-128-q8"),
])
def test_bf16_plain_flash_matches_upstream_pallas(lq, lk, dh, block, spread):
    """O and LSE of the bf16 K3's plain version, and dq, dk, dv of the bf16
    K5 / K4 plain versions fed the upstream forward's residuals, against the
    upstream kernels on the same bf16 inputs (interpret mode), at every dh of
    the main path and with q scaled by ``spread`` (8: the running max moves
    between key blocks). The kernel rounds P per 128-key block against the
    running max, the plain version against the row max. Measured worst
    cases, of max|ref|: O 5.5e-3, dq 2.7e-3, dk 2.2e-3, dv 1.7e-3 (dh 128);
    LSE 8.3e-8 relative."""
    rng = np.random.RandomState(dh + lq)
    q, do = (rng.randn(1, 2, lq, dh).astype(np.float32) for _ in range(2))
    q *= spread
    k, v = (rng.randn(1, 2, lk, dh).astype(np.float32) for _ in range(2))
    bq, bk, bv, bdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    scale = 1.0 / np.sqrt(dh)
    bs = upstream.BlockSizes(block_q=block, block_k_major=block, block_k=block, block_b=1,
                             block_q_major_dkv=block, block_k_major_dkv=block,
                             block_k_dkv=block, block_q_dkv=block, block_k_major_dq=block,
                             block_k_dq=block, block_q_dq=block)
    with pltpu.force_tpu_interpret_mode():
        o, l, m = upstream._flash_attention(bq, bk, bv, None, None, True, False, scale, bs,
                                            False)
        di = jnp.sum(o.astype(jnp.float32) * bdo.astype(jnp.float32), axis=-1)
        dk, dv = upstream._flash_attention_bwd_dkv(
            bq, bk, bv, None, None, l, m, bdo, di, block_q_major=block, block_q=block,
            block_k_major=block, block_k=block, sm_scale=scale, causal=False,
            mask_value=upstream.DEFAULT_MASK_VALUE, debug=False)
        dq = flash_vjp._bwd_dq_di128(bq, bk, bv, l, m, bdo, di, block_q_major=block,
                                     block_k_major=block, block_k=block, sm_scale=scale)
    assert all(x.dtype == jnp.bfloat16 for x in (o, dq, dk, dv))

    def port(x):
        return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32))).transpose(1, 2).to(
            torch.bfloat16).contiguous()

    pq, pk, pv, pdo = (port(x) for x in (bq, bk, bv, bdo))
    got_o, got_lse = flash.attention_fwd_plain_bf16(pq, pk, pv)
    assert got_o.dtype == torch.bfloat16 and got_lse.dtype == torch.float32
    _bf16_close(got_o, o)
    lse = np.asarray(m) + np.log(np.asarray(l))
    close(got_lse, lse, atol=0, rtol=LSE_RTOL)
    # The backward from the upstream forward's residuals, as the kernels get them.
    tlse, tdi = t(lse.astype(np.float32)), t(np.asarray(di))
    got_dq = flash.attention_bwd_dq_plain_bf16(pq, pk, pv, tlse, pdo, tdi)
    got_dk, got_dv = flash.attention_bwd_dkv_plain_bf16(pq, pk, pv, tlse, pdo, tdi)
    for got, want in ((got_dq, dq), (got_dk, dk), (got_dv, dv)):
        assert got.dtype == torch.bfloat16
        _bf16_close(got, want)


def test_flash_function_bf16_on_cpu_runs_the_bf16_plain_versions():
    """bf16 into the flash Function on the CPU: bf16 O and gradients, equal to
    the bf16 plain versions fed the same residuals."""
    q, k, v, do = (torch.randn(1, 128, 2, 64).to(torch.bfloat16) for _ in range(4))
    ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = flash.flash_attention_train(*ins)
    got = torch.autograd.grad(out, ins, do)
    o, lse = flash.attention_fwd_plain_bf16(q, k, v)
    assert torch.equal(out, o) and torch.equal(flash.flash_attention(q, k, v), o)
    di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    dk, dv = flash.attention_bwd_dkv_plain_bf16(q, k, v, lse, do, di)
    dq = flash.attention_bwd_dq_plain_bf16(q, k, v, lse, do, di)
    for a, b in zip(got, (dq, dk, dv)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


def _jax_run(fn, *args):
    """``jax.jit(fn)(*args)`` with XLA's excess precision off. XLA's CPU
    compiler by default drops a bf16 round trip it can fuse away (the
    rounding of a bf16 convolution's output before its BatchNorm's f32
    moments), which moves the tiny trunk's train-mode output by up to 4 %;
    with the option off it rounds where the program says, as the port does."""
    compiled = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return compiled(*args)


@pytest.mark.parametrize("train", [True, False])
def test_bf16_image_trunk_matches_jax(rng, train):
    """The image trunk under mixed precision against the JAX trunk's trace
    (train mode: its space-to-depth packed stem and layer1, which differ
    from the unpacked form in summation order only): output and, in train
    mode, the running statistics, within 1e-6 (measured: equal)."""
    x = rng.rand(6, 16, 16, 1).astype(np.float32)  # 2 samples x 3 views, NHWC
    w = np.array([1.0, 0.0], np.float32)  # one pad sample
    jt = jr.ImageTrunk(feat_size=4)
    variables = jax_variables(jt, x)
    with jax_mixed_precision(), jl.bn_row_weights(jnp.asarray(w)):
        y, mut = _jax_run(lambda v, x: jt.apply(v, x, train=train, mutable=["batch_stats"]),
                          variables, x)
    trunk = ImageTrunk(feat_size=4)
    trunk.load_state_dict(params_from_jax(variables), strict=True)
    trunk.train(train)
    with mixed_precision(True), bn_row_weights(t(w)), torch.no_grad():
        out = trunk(t(x).permute(0, 3, 1, 2))
    assert out.dtype == torch.float32
    close(out, y, atol=1e-6)
    if train:
        state = trunk.state_dict()
        for name, want in params_from_jax({"batch_stats": mut["batch_stats"]}).items():
            close(state[name], want.numpy(), atol=1e-6)
    with torch.no_grad():  # the switch is off again: f32, another result
        assert not torch.equal(trunk.eval()(t(x).permute(0, 3, 1, 2)), out)


def test_bf16_train_mode_loss_matches_jax(rng):
    """A tiny SVDFormer's train-mode forward and pyramid loss in bf16 mode
    (B 3 with a pad row, N 128, gt 128, 16² render) against the JAX package
    under set_mixed_precision(True), compiled without excess precision:
    loss and parts within 1e-5 relative, the f32 train step's bound
    (measured 3.3e-7)."""
    B = 3
    partial = ((rng.rand(B, 128, 3) - 0.5) * 0.8).astype(np.float32)
    gt = ((rng.rand(B, 128, 3) - 0.5) * 0.8).astype(np.float32)
    w = np.array([1.0, 0.0, 1.0], np.float32)
    render = JaxPCViews(trans=-0.7, resolution=16)
    depth = np.asarray(render.get_img(jnp.asarray(partial)))
    jmodel = JaxSVDFormer(**TINY)
    variables = jax_variables(jmodel, partial, depth, seed=2)

    def jloss(v, partial, depth, gt, w):
        with jl.bn_row_weights(w):
            outs, _ = jmodel.apply(v, partial, depth, train=True, mutable=["batch_stats"])
        return jlosses.get_loss(outs, gt, sqrt=True, weights=w)

    with jax_mixed_precision():
        want, want_parts = _jax_run(jloss, variables, partial, depth, gt, w)
    cfg = pcn_config()
    cfg = cfg.replace(network=dataclasses.replace(cfg.network, resolution=16, **TINY))
    model = SVDFormer.from_config(cfg.network)
    model.load_state_dict(params_from_jax(variables), strict=True)
    model.train()
    with mixed_precision(True), bn_row_weights(t(w)), torch.no_grad():
        outs = model(t(partial), make_renderer(cfg).get_img(t(partial)))
        loss, parts = get_loss(outs, t(gt), sqrt=True, weights=t(w))
    close(loss, want, atol=0, rtol=1e-5)
    for got, exp in zip(parts, want_parts):
        close(got, exp, atol=0, rtol=1e-5)
