"""PyTorch port blocks vs the JAX package on the CPU, each with the same
random weights carried over by ``params_from_jax`` (atol 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_parity import close, jax_reference_modes, jax_variables, load_port, t  # noqa: F401
from svdformer_pointsea_tpu.nn import layers as jl
from svdformer_pointsea_tpu.nn import resnet as jr
from svdformer_pointsea_tpu.nn import svdformer as js
from svdformer_pointsea_tpu_torch import kernels
from svdformer_pointsea_tpu_torch.nn import layers as tl
from svdformer_pointsea_tpu_torch.nn import resnet as tr
from svdformer_pointsea_tpu_torch.nn import svdformer as ts
from svdformer_pointsea_tpu_torch.train.convert import params_from_jax

ATOL = 1e-5

pytestmark = pytest.mark.usefixtures("jax_reference_modes")


def _compare(jax_module, port_module, *inputs, atol=ATOL):
    """Same random weights and inputs through both; outputs within ``atol``."""
    variables = jax_variables(jax_module, *inputs)
    want = jax.jit(jax_module.apply)(variables, *inputs)
    port = load_port(port_module, variables)
    with torch.no_grad():
        got = port(*(None if x is None else t(x) for x in inputs))
    for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        close(g, w, atol=atol)
    return port, variables


def _x(rng, *shape):
    return (rng.rand(*shape) - 0.5).astype(np.float32)


def test_mlp_conv_and_shared_mlp(rng):
    x = _x(rng, 2, 16, 7)
    _compare(jl.MLPConv((32, 24)), tl.MLPConv(7, (32, 24)), x)
    x4 = _x(rng, 2, 8, 4, 7)
    for if_bn, last_act in ((True, True), (True, False), (False, False)):
        _compare(jl.SharedMLP((16, 12), if_bn=if_bn, last_act=last_act),
                 tl.SharedMLP(7, (16, 12), if_bn=if_bn, last_act=last_act), x4)


@pytest.mark.parametrize("lq,lk,dh", [(24, 40, 16), (512, 512, 64)])
def test_scaled_attention_matches_jax(rng, lq, lk, dh):
    # 512 tokens and dh 64 are flash-eligible shapes: on CPU tensors the
    # dispatcher takes the naive math, as the JAX package does off the TPU.
    q, k, v = _x(rng, 1, lq, 2, dh), _x(rng, 1, lk, 2, dh), _x(rng, 1, lk, 2, dh)
    want = jl._scaled_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    close(tl.scaled_attention(t(q), t(k), t(v)), want, atol=ATOL)
    close(tl.flash_attention(t(q), t(k), t(v)), want, atol=ATOL)
    assert kernels.launches["flash_attn"] == 0


def test_attention_blocks(rng):
    x, pos, mem = _x(rng, 2, 20, 12), _x(rng, 2, 20, 16), _x(rng, 2, 9, 12)
    _compare(jl.MultiheadAttention(16, 4), tl.MultiheadAttention(16, 4), _x(rng, 2, 20, 16),
             _x(rng, 2, 9, 16), _x(rng, 2, 9, 16))
    for p in (None, pos):
        _compare(jl.SelfAttentionBlock(12, 16, nhead=4, dim_feedforward=32),
                 tl.SelfAttentionBlock(12, 16, nhead=4, dim_feedforward=32), x, p)
    _compare(jl.CrossAttentionBlock(12, 16, nhead=4, dim_feedforward=32),
             tl.CrossAttentionBlock(12, 16, nhead=4, dim_feedforward=32), x, mem, pos)
    _compare(jl.SDGDecoder(16, 8, 3), tl.SDGDecoder(16, 8, 3), _x(rng, 2, 20, 16))


def test_edge_conv(rng):
    _compare(jl.EdgeConv(16, 6), tl.EdgeConv(3, 16, 6), _x(rng, 2, 64, 3))
    _compare(jl.EdgeConv(32, 4), tl.EdgeConv(16, 32, 4), _x(rng, 2, 40, 16))


def test_pcsa_and_positional_embedding(rng):
    _compare(jl.PCSA(16), tl.PCSA(16), _x(rng, 2, 8, 16, 6))
    idx = rng.rand(2, 50).astype(np.float32) * 5
    want = jl.SinusoidalPositionalEmbedding(32).apply({}, jnp.asarray(idx))
    close(tl.SinusoidalPositionalEmbedding(32)(t(idx)), want, atol=1e-6)


@pytest.mark.parametrize("if_bn", [False, True])
def test_sa_module_knn(rng, if_bn):
    # With PCSA on its groups, as SVDFormer's kNN-grouped modules run.
    xyz, pts = _x(rng, 2, 128, 3), _x(rng, 2, 128, 5)
    _compare(jl.PointNetSAModuleKNN(32, 8, (16, 24), if_bn=if_bn, if_idx=True, use_pcsa=True),
             tl.PointNetSAModuleKNN(32, 8, 5, (16, 24), if_bn=if_bn, if_idx=True,
                                    use_pcsa=True), xyz, pts)
    _compare(jl.PointNetSAModuleKNN(None, None, (16, 24), if_bn=if_bn, group_all=True),
             tl.PointNetSAModuleKNN(None, None, 5, (16, 24), if_bn=if_bn, group_all=True), xyz, pts)


def test_basic_block_and_image_trunk(rng):
    img = _x(rng, 2, 16, 16, 8)  # JAX NHWC; the port takes NCHW
    jb = jr.BasicBlock(12, stride=2, downsample=True)
    variables = jax_variables(jb, img)
    want = jax.jit(jb.apply)(variables, img)
    got = load_port(tr.BasicBlock(8, 12, stride=2, downsample=True), variables)(
        t(img).permute(0, 3, 1, 2))
    close(got.detach().permute(0, 2, 3, 1), want, atol=ATOL)

    depth = rng.rand(4, 32, 32, 1).astype(np.float32)
    jt = jr.ImageTrunk(feat_size=8)
    variables = jax_variables(jt, depth)
    with torch.no_grad():
        got = load_port(tr.ImageTrunk(feat_size=8), variables)(t(depth).permute(0, 3, 1, 2))
    close(got, jax.jit(jt.apply)(variables, depth), atol=ATOL)


def test_local_encoder_and_sdg(rng):
    pts = _x(rng, 2, 512, 3)
    _compare(js.LocalEncoder(64), ts.LocalEncoder(64), pts)
    local, coarse, f_g = _x(rng, 2, 64, 256), _x(rng, 2, 48, 3), _x(rng, 2, 1, 512)
    _compare(js.SDG(2, hidden_dim=64, sdg_decoder=True), ts.SDG(2, hidden_dim=64),
             local, coarse, f_g, pts)


def test_torch_channel_reshape(rng):
    x = _x(rng, 2, 12, 8)
    close(ts.torch_channel_reshape(t(x), 4, 24), js.torch_channel_reshape(jnp.asarray(x), 4, 24), atol=0)


def test_params_from_jax_layouts(rng):
    """Dense kernels transpose, conv kernels go HWIO -> OIHW, LayerNorm /
    BatchNorm scales become weights and the stats become running stats."""
    variables = {
        "params": {
            "fc": {"kernel": rng.rand(3, 5), "bias": rng.rand(5)},
            "conv": {"kernel": rng.rand(3, 3, 2, 4)},
            "bn": {"scale": rng.rand(4), "bias": rng.rand(4)},
        },
        "batch_stats": {"bn": {"mean": rng.rand(4), "var": rng.rand(4)}},
    }
    sd = params_from_jax(variables)
    p, s = variables["params"], variables["batch_stats"]
    np.testing.assert_array_equal(sd["fc.weight"].numpy(), p["fc"]["kernel"].T.astype(np.float32))
    np.testing.assert_array_equal(sd["conv.weight"].numpy(),
                                  p["conv"]["kernel"].transpose(3, 2, 0, 1).astype(np.float32))
    assert sd["conv.weight"].shape == (4, 2, 3, 3) and sd["conv.weight"].is_contiguous()
    np.testing.assert_array_equal(sd["bn.weight"].numpy(), p["bn"]["scale"].astype(np.float32))
    np.testing.assert_array_equal(sd["bn.running_var"].numpy(), s["bn"]["var"].astype(np.float32))
    assert sorted(sd) == sorted(["fc.weight", "fc.bias", "conv.weight", "bn.weight", "bn.bias",
                                 "bn.running_mean", "bn.running_var"])


def test_svfnet_keeps_full_ps_bias(rng):
    """SVFNet parity, with the seed layer ``encoder/ps`` bias random and not
    repeated: the JAX tree carries 64 x 128 bias values (a JAX-trained tree
    need not repeat one per channel), and all of them must reach the port
    through ``params_from_jax`` and shape its output."""
    pts = _x(rng, 2, 512, 3)
    depth = rng.rand(2, 3, 32, 32).astype(np.float32)
    enc = js.SVFNet(0.7)
    variables = jax_variables(enc, pts, depth)
    bias = rng.randn(64 * 128).astype(np.float32)  # random, not repeated
    assert len(np.unique(bias)) == bias.size
    variables["params"]["ps"]["bias"] = bias
    port = load_port(ts.SVFNet(0.7), variables)
    np.testing.assert_array_equal(port.ps.bias.detach().numpy(), bias)
    want = jax.jit(enc.apply)(variables, pts, depth)
    with torch.no_grad():
        got = port(t(pts), t(depth))
    for g, w in zip(got, want):
        close(g, w, atol=2e-5)
