"""The port's CUDA kernels against their plain PyTorch versions, and the
dispatch rules around them. Imports torch only, so it also runs on a machine
without JAX: ``python -m pytest --noconftest tests/test_torch_kernels.py -q``
on a CUDA machine runs the kernel tests (marker ``cuda``), which skip where no
card is visible."""

import numpy as np
import pytest
import torch

from svdformer_pointsea_tpu_torch import kernels
from svdformer_pointsea_tpu_torch.nn.layers import (
    _flash_eligible,
    flash_attention,
    naive_attention,
    scaled_attention,
)
from svdformer_pointsea_tpu_torch.ops import (
    furthest_point_sample,
    furthest_point_sample_ref,
    nn_one_way,
    nn_one_way_plain,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def test_cpu_tensors_take_the_plain_versions():
    kernels.reset_launches()
    x = torch.rand(2, 64, 3)
    assert torch.equal(furthest_point_sample(x, 8), furthest_point_sample_ref(x, 8))
    d, i = nn_one_way(x, x[:, :32])
    dp, ip = nn_one_way_plain(x, x[:, :32])
    assert torch.equal(d, dp) and torch.equal(i, ip)
    q = torch.rand(1, 512, 2, 64)
    assert torch.equal(scaled_attention(q, q, q), naive_attention(q, q, q))
    assert torch.equal(flash_attention(q, q, q), naive_attention(q, q, q))
    assert all(n == 0 for n in kernels.launches.values())


def test_use_kernel_and_reference_ops():
    cpu = torch.zeros(1)
    assert kernels.use_kernel(cpu) is False
    with pytest.raises(RuntimeError):
        kernels.use_kernel(torch.zeros(1, device="meta"))
    with kernels.reference_ops():
        assert kernels._plain_forced
        with kernels.reference_ops():
            pass
        assert kernels._plain_forced
    assert not kernels._plain_forced


def test_kernel_wrappers_refuse_cpu_tensors():
    from svdformer_pointsea_tpu_torch.nn.layers import _flash_kernel
    from svdformer_pointsea_tpu_torch.ops.distances import _nn_one_way_kernel
    from svdformer_pointsea_tpu_torch.ops.fps import _fps_kernel

    x = torch.rand(1, 64, 3)
    with pytest.raises(ValueError, match="CUDA"):
        _fps_kernel(x, 4)
    with pytest.raises(ValueError, match="CUDA"):
        _nn_one_way_kernel(x, x)
    q = torch.rand(1, 64, 1, 64)
    with pytest.raises(ValueError, match="CUDA"):
        _flash_kernel(q, q, q)


@pytest.mark.parametrize("lq,lk,dh,eligible", [
    (512, 512, 96, True), (2048, 512, 64, True), (1024, 1024, 256, True),
    (256, 512, 64, False), (768, 512, 64, False), (512, 640, 128, False), (512, 512, 80, False),
])
def test_flash_eligibility_is_a_shape_rule(monkeypatch, lq, lk, dh, eligible):
    """The JAX package's rule (>= 512 query tokens, both lengths multiples of
    512, dh in {64, 96, 128, 256}) with no dtype clause: a non-f32 input of
    eligible shape goes to the kernel wrapper, which raises on the card."""
    monkeypatch.setattr(kernels, "use_kernel", lambda t: True)
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros(1, lq, 1, dh, dtype=dtype)
        assert _flash_eligible(q, torch.zeros(1, lk, 1, dh, dtype=dtype)) is eligible


def test_library_name_tracks_source_and_flags():
    paths = {kernels._lib_path(n) for n in kernels.KERNEL_NAMES}
    assert len(paths) == len(kernels.KERNEL_NAMES)
    assert all(p.parent == kernels.BUILD_DIR and p.suffix == ".so" for p in paths)
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(512, 2048), (2048, 2048), (1000, 333)])
def test_nn_distance_kernel_matches_plain(cuda, n, m):
    a = torch.rand(2, n, 3, device="cuda", generator=cuda) - 0.5
    b = torch.rand(2, m, 3, device="cuda", generator=cuda) - 0.5
    before = kernels.launches["nn_distance"]
    d, i = nn_one_way(a, b)
    torch.cuda.synchronize()
    assert kernels.launches["nn_distance"] == before + 1
    dp, ip = nn_one_way_plain(a, b)
    assert torch.equal(d, dp) and torch.equal(i, ip)  # same rounding, same ties


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(2048, 512), (2304, 512), (512, 128), (700, 100), (16384, 64)])
def test_fps_kernel_matches_plain(cuda, n, m):
    x = torch.rand(3, n, 3, device="cuda", generator=cuda) - 0.5
    x[1] = 0.0  # all-invalid row
    x[2, 1:n // 2] = x[2, n // 2 + 1:n // 2 * 2]  # ties
    got = furthest_point_sample(x, m)
    torch.cuda.synchronize()
    assert torch.equal(got, furthest_point_sample_ref(x, m))
    assert not got[1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lk,dh", [(512, 512, 96), (512, 512, 64), (2048, 512, 64),
                                      (1024, 1024, 128), (512, 1024, 256)])
def test_flash_kernel_matches_naive(cuda, lq, lk, dh):
    q = torch.randn(2, lq, 8, dh, device="cuda", generator=cuda)
    k = torch.randn(2, lk, 8, dh, device="cuda", generator=cuda)
    v = torch.randn(2, lk, 8, dh, device="cuda", generator=cuda)
    before = kernels.launches["flash_attn"]
    out = scaled_attention(q, k, v)
    torch.cuda.synchronize()
    assert kernels.launches["flash_attn"] == before + 1
    np.testing.assert_allclose(out.cpu().numpy(), naive_attention(q, k, v).cpu().numpy(), atol=2e-5)


@pytest.mark.cuda
def test_flash_refuses_bf16_cuda_inputs(cuda):
    """A bf16 CUDA input of eligible shape raises; it does not fall back to
    the naive math (K3 is f32 only)."""
    q = torch.randn(1, 512, 8, 64, device="cuda", generator=cuda).to(torch.bfloat16)
    before = kernels.launches["flash_attn"]
    with pytest.raises(ValueError, match="float32"):
        scaled_attention(q, q, q)
    assert kernels.launches["flash_attn"] == before
