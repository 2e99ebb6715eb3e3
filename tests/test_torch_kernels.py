"""The port's CUDA kernels against their plain PyTorch versions, and the
dispatch rules around them. Imports torch only, so it also runs on a machine
without JAX: ``python -m pytest --noconftest tests/test_torch_kernels.py -q``
on a CUDA machine runs the kernel tests (marker ``cuda``), which skip where no
card is visible."""

import numpy as np
import pytest
import torch

from svdformer_pointsea_tpu_torch import kernels
from svdformer_pointsea_tpu_torch.nn import flash, layers, mixed_precision
from svdformer_pointsea_tpu_torch.nn.layers import (
    _flash_eligible,
    flash_attention,
    naive_attention,
    scaled_attention,
)
from svdformer_pointsea_tpu_torch.ops import (
    chamfer_distance,
    earth_mover_distance,
    emd_convergence,
    group_local,
    index_points,
    query_knn,
    furthest_point_sample,
    furthest_point_sample_ref,
    nn_one_way,
    nn_one_way_plain,
    nn_squared_distance,
    scatter,
    three_interpolate,
)
from svdformer_pointsea_tpu_torch.ops.distances import (
    NnPlan,
    _nn_one_way_kernel,
    check_nn_plan,
    nn_launch_plan,
    split_ranges,
)
from svdformer_pointsea_tpu_torch.ops.fps import (
    FpsPlan,
    _fps_kernel,
    check_fps_plan,
    fps_launch_plan,
)
from svdformer_pointsea_tpu_torch.ops.scatter import gather_rows, scatter_add_rows
from svdformer_pointsea_tpu_torch.render import PCViews

# (N, npoint) of K2 and (N, M) of K1 on the main paths (training at B 12,
# evaluation at B 8), and the H100's SM count.
FPS_SITES = [(2048, 512), (512, 128), (2304, 512), (16384, 2048), (2048, 256)]
NN_SITES = [(512, 2048), (2048, 2048), (256, 256), (16384, 16384)]
H100_SMS = 132
# The ShapeNet-55 track's sites at its batch of 16, train step and evaluation:
# K2 on the crop's masked 8192-point block, SA1, SA2, the LocalEncoder, the
# merge, the loss pyramid, and the eval crops' 6144 / 4096 kept points; K1 in
# SDG1 and SDG2, the loss pyramid, the partial-matching term and the metrics.
B_55 = 16
FPS_SITES_55 = [(8192, 2048), (2048, 512), (512, 128), (2048, 1024), (2304, 1024), (2048, 256),
                (6144, 2048), (4096, 2048)]
NN_SITES_55 = [(1024, 2048), (2048, 2048), (256, 256), (8192, 8192), (2048, 8192)]


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
    from svdformer_pointsea_tpu_torch.nn.flash import _bwd_kernels, _flash_kernel
    from svdformer_pointsea_tpu_torch.ops.distances import _nn_one_way_kernel
    from svdformer_pointsea_tpu_torch.ops.fps import _fps_kernel

    x = torch.rand(1, 64, 3)
    with pytest.raises(ValueError, match="CUDA"):
        _fps_kernel(x, 4)
    with pytest.raises(ValueError, match="CUDA"):
        _nn_one_way_kernel(x, x)
    lse = torch.zeros(1, 1, 64)
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.rand(1, 64, 1, 64).to(dtype)
        with pytest.raises(ValueError, match="CUDA"):
            _flash_kernel(q, q, q)
        with pytest.raises(ValueError, match="CUDA"):
            _flash_kernel(q, q, q, stats=True)
        with pytest.raises(ValueError, match="CUDA"):
            _bwd_kernels(q, q, q, lse, q, lse)


def test_cpu_training_attention_takes_the_plain_versions():
    """With a gradient recorded, an eligible shape on the CPU still takes the
    naive math (as the JAX package does off the TPU), and the flash Function
    called directly runs its plain versions: no kernel launches."""
    kernels.reset_launches()
    q, k, v = (torch.randn(1, 512, 2, 64, requires_grad=True) for _ in range(3))
    out = scaled_attention(q, k, v)
    assert out.grad_fn is not None and "FlashAttention" not in type(out.grad_fn).__name__
    out_f = flash.flash_attention_train(q, k, v)
    assert "FlashAttention" in type(out_f.grad_fn).__name__
    g = torch.randn_like(out)
    got = torch.autograd.grad(out_f, (q, k, v), g)
    want = torch.autograd.grad(naive_attention(q, k, v), (q, k, v), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=2e-4)
    assert all(n == 0 for n in kernels.launches.values())


@pytest.mark.parametrize("lq,lk,dh,eligible", [
    (512, 512, 96, True), (2048, 512, 64, True), (1024, 1024, 256, True),
    (256, 512, 64, False), (768, 512, 64, False), (512, 640, 128, False), (512, 512, 80, False),
])
def test_flash_eligibility_is_a_shape_rule(monkeypatch, lq, lk, dh, eligible):
    """On the card (the device predicate), the JAX package's rule (>= 512
    query tokens, both lengths multiples of 512, dh in {64, 96, 128, 256})
    with no dtype clause: an input of another dtype and eligible shape goes
    to the kernel wrapper, which raises on the card. Off the card nothing is
    eligible."""
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        q = torch.zeros(1, lq, 1, dh, dtype=dtype)
        k = torch.zeros(1, lk, 1, dh, dtype=dtype)
        assert _flash_eligible(q, k) is False
        monkeypatch.setattr(layers, "_on_card", lambda t: True)
        assert _flash_eligible(q, k) is eligible
        monkeypatch.undo()


def test_library_name_tracks_source_and_flags():
    paths = {kernels._lib_path(src) for src in kernels.SOURCES}
    assert len(paths) == len(kernels.SOURCES)
    assert all(p.parent == kernels.BUILD_DIR and p.suffix == ".so" for p in paths)
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS
    assert {src for src, _, _ in kernels._ENTRY.values()} == set(kernels.SOURCES)
    assert all((kernels.CSRC / f"{src}.cu").is_file() for src in kernels.SOURCES)


def test_split_bf16x3_plain_reconstructs_f32_exactly():
    """hi + mid + lo == x bit for bit (each difference of the split is exact),
    over randn and magnitudes from 1e-30 to 1e30; hi is x rounded to bf16; a
    CPU tensor takes the plain version, with no launch."""
    rng = np.random.default_rng(0)
    mags = 10.0 ** rng.uniform(-30, 30, 4096) * (1 + rng.random(4096)) * rng.choice([-1, 1], 4096)
    x = torch.from_numpy(np.concatenate([rng.standard_normal(4096), mags]).astype(np.float32))
    kernels.reset_launches()
    planes = flash.split_bf16x3(x)
    assert all(n == 0 for n in kernels.launches.values())
    assert planes.shape == (3, 8192) and planes.dtype == torch.bfloat16
    assert torch.equal(planes.view(torch.int16), flash.split_bf16x3_plain(x).view(torch.int16))
    hi, mid, lo = planes.float()
    assert torch.equal(hi, x.to(torch.bfloat16).float())
    assert torch.equal((hi + mid) + lo, x)


def _six_products(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b from the split planes of a and b: the six products of the
    kernels, in their order (lo hi, mid mid, hi lo, mid hi, hi mid, then hi
    hi), summed into one f32 accumulator."""
    pa, pb = (flash.split_bf16x3_plain(x).float() for x in (a, b))
    acc = torch.zeros(a.shape[0], b.shape[1])
    for i, j in ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)):
        acc += pa[i] @ pb[j]
    return acc


@pytest.mark.parametrize("depth,a_kind", [
    pytest.param(64, "randn", id="64"), pytest.param(128, "randn", id="128"),
    pytest.param(2048, "randn", id="2048"), pytest.param(128, "softmax", id="softmax-128"),
    pytest.param(2048, "softmax", id="softmax-2048"),
])
def test_six_product_split_is_at_f32_level(depth, a_kind):
    """The split's six products of A (256 x depth) by randn (depth x 256)
    stay within 1e-6 of max|ref| of the f64 product: f32's level, where one
    bf16 product alone is ~1e-3 away. A is randn, or a row softmax of randn x
    4 (values in [0, 1], rows summing to 1: the P of the forward's P V)."""
    rng = np.random.default_rng(depth)
    a = rng.standard_normal((256, depth))
    if a_kind == "softmax":
        a = np.exp(4 * a - 4 * a.max(axis=1, keepdims=True))
        a /= a.sum(axis=1, keepdims=True)
    a = a.astype(np.float32)
    b = rng.standard_normal((depth, 256)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    got = _six_products(torch.from_numpy(a), torch.from_numpy(b)).double().numpy()
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()
    hi_only = (torch.from_numpy(a).bfloat16().float() @ torch.from_numpy(b).bfloat16().float())
    assert np.abs(hi_only.double().numpy() - ref).max() > 1e-4 * np.abs(ref).max()


def test_f32_forward_is_bound_to_the_split_source():
    """The f32 K3, without and with statistics, is the kernel of
    flash_attn_split_fwd.cu on the split planes; the FMA source flash_attn.cu
    is gone."""
    for name in ("flash_attn", "flash_attn_stats"):
        assert kernels._ENTRY[name][:2] == ("flash_attn_split_fwd", "flash_attn_split_fwd_launch")
    assert "flash_attn_split_fwd" in kernels.SOURCES and "flash_attn" not in kernels.SOURCES
    assert (kernels.CSRC / "flash_attn_split_fwd.cu").is_file()
    assert (kernels.CSRC / "split.cuh").is_file()
    assert not (kernels.CSRC / "flash_attn.cu").exists()


def test_flash_function_saves_its_operands_and_runs_plain_on_cpu():
    """On CPU tensors the flash Function saves q, k, v (the split planes only
    where it launches the kernels), O and lse, and differentiates through the
    plain versions: gradients as autograd through the naive math, no launch."""
    kernels.reset_launches()
    q, k, v = (torch.randn(2, 256, 2, 64, requires_grad=True) for _ in range(3))
    out = flash.flash_attention_train(q, k, v)
    saved = out.grad_fn.saved_tensors
    assert all(torch.equal(a, b) for a, b in zip(saved[:3], (q, k, v)))
    o, lse = flash.attention_fwd_plain(q.detach(), k.detach(), v.detach())
    assert torch.equal(saved[3], out) and torch.equal(saved[4], lse)
    g = torch.randn_like(out)
    got = torch.autograd.grad(out, (q, k, v), g)
    want = torch.autograd.grad(naive_attention(q, k, v), (q, k, v), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=2e-4)
    assert all(n == 0 for n in kernels.launches.values())


def test_f32_backward_is_bound_to_the_split_source():
    """The f32 K4 and K5 and the split pass are the kernels of
    flash_attn_split_bwd.cu; the FMA source flash_attn_bwd.cu is gone."""
    assert kernels._ENTRY["flash_attn_bwd_dkv"][:2] == (
        "flash_attn_split_bwd", "flash_attn_split_bwd_dkv_launch")
    assert kernels._ENTRY["flash_attn_bwd_dq"][:2] == (
        "flash_attn_split_bwd", "flash_attn_split_bwd_dq_launch")
    assert kernels._ENTRY["split_bf16x3"][:2] == ("flash_attn_split_bwd", "split_bf16x3_launch")
    assert "flash_attn_split_bwd" in kernels.SOURCES and "flash_attn_bwd" not in kernels.SOURCES
    assert (kernels.CSRC / "flash_attn_split_bwd.cu").is_file()
    assert not (kernels.CSRC / "flash_attn_bwd.cu").exists()


@pytest.mark.parametrize("batch", [8, 12, 40])
def test_fps_launch_plan_rules(batch):
    """Every plan is one that fps_launch takes; at B 8 and B 12 all clusters
    fit the card at once (B x C <= SMs); C = 1 is valid at every site up to
    the 8192 points a CTA holds and refused above, where C = 2 is valid; the
    16384-point site runs on a cluster of more than one CTA at any batch."""
    for n, m in FPS_SITES + [(1, 1), (3, 2), (700, 100), (8192, 64), (16384, 64)]:
        plan = fps_launch_plan(batch, n, m, H100_SMS)
        check_fps_plan(n, plan)
        if batch <= 12:
            assert batch * plan.cluster <= H100_SMS
        if n <= 8192:
            one = fps_launch_plan(batch, n, m, H100_SMS, cluster=1)
            check_fps_plan(n, one)
            assert one.cluster == 1
        else:
            with pytest.raises(ValueError):
                fps_launch_plan(batch, n, m, H100_SMS, cluster=1)
        for c in (2, 4, 8, 16):
            check_fps_plan(n, fps_launch_plan(batch, n, m, H100_SMS, cluster=c))
    assert fps_launch_plan(batch, 16384, 2048, H100_SMS).cluster > 1
    assert fps_launch_plan(10 * batch, 16384, 2048, H100_SMS).cluster == 2  # in waves


def test_launch_plans_at_the_55_sites():
    """Every K1 and K2 site of the 55 track gets a plan its kernel takes at
    B 16, with every cluster resident at once (B x C <= SMs): K2 on 8 CTAs a
    sample from 2049 points (the masked crop block, the merge and the eval
    crops), on one below; K1 splits the targets of every site below 16384
    queries."""
    for n, m in FPS_SITES_55:
        plan = fps_launch_plan(B_55, n, m, H100_SMS)
        check_fps_plan(n, plan)
        assert B_55 * plan.cluster <= H100_SMS
        assert plan.cluster == (8 if n >= 2049 else 1), (n, plan)
    for n, m in NN_SITES_55:
        plan = nn_launch_plan(B_55, n, m, H100_SMS)
        check_nn_plan(m, plan)
        assert plan.splits > 1, (n, m, plan)


@pytest.mark.parametrize("n,plan", [
    (2048, FpsPlan(3, 128, 16)),     # no such cluster size
    (2048, FpsPlan(1, 256, 8)),      # no such instance
    (2048, FpsPlan(1, 200, 16)),     # not whole warps
    (2048, FpsPlan(1, 96, 16)),      # points left over
    (16384, FpsPlan(1, 1024, 16)),   # one CTA on 16384 points: above 512 threads
    (2048, FpsPlan(1, 2048, 4)),     # more threads than a CTA has
    (20, FpsPlan(16, 32, 4)),        # CTAs that own no point
    (20000, FpsPlan(16, 128, 16)),   # a cloud beyond a CTA's shared memory
])
def test_fps_plan_check_refuses_what_the_kernel_refuses(n, plan):
    with pytest.raises(ValueError):
        check_fps_plan(n, plan)


@pytest.mark.parametrize("batch", [8, 12, 40])
def test_nn_launch_plan_rules(batch):
    """Every plan is one that nn_one_way_launch takes; S = 1 is valid at every
    site; the split ranges are contiguous, increasing, non-empty and cover
    [0, M) exactly; the small main-path sites split the targets."""
    for n, m in NN_SITES + [(1000, 333), (5, 3), (1, 1), (300, 70)]:
        for plan in (nn_launch_plan(batch, n, m, H100_SMS),
                     nn_launch_plan(batch, n, m, H100_SMS, splits=1)):
            check_nn_plan(m, plan)
            ranges = split_ranges(m, plan)
            assert len(ranges) == plan.splits and ranges[0][0] == 0 and ranges[-1][1] == m
            assert all(lo < hi for lo, hi in ranges)
            assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert nn_launch_plan(batch, n, m, H100_SMS, splits=1).splits == 1
    if batch <= 12:
        assert all(nn_launch_plan(batch, n, m, H100_SMS).splits > 1
                   for n, m in NN_SITES if n < 16384)


@pytest.mark.parametrize("m,plan", [
    (2048, NnPlan(128, 8, 1, 2048, 0)),     # no such instance
    (2048, NnPlan(96 + 1, 2, 1, 2048, 0)),  # not whole warps
    (2048, NnPlan(512, 2, 1, 2048, 0)),     # above the kernel's threads
    (2048, NnPlan(128, 2, 16, 128, 0)),     # more splits than a cluster takes
    (2048, NnPlan(128, 2, 2, 1000, 0)),     # targets left over
    (2048, NnPlan(128, 2, 8, 1024, 0)),     # empty ranges
    (2048, NnPlan(128, 2, 1, 2048, 1)),     # no such vote
])
def test_nn_plan_check_refuses_what_the_kernel_refuses(m, plan):
    with pytest.raises(ValueError):
        check_nn_plan(m, plan)


def test_k1_and_k2_are_bound_to_their_sources():
    """K1 and K2 are the kernels of nn_distance.cu and fps.cu, which include
    the cluster helpers of cluster.cuh; their C entry points take the launch
    plan after the shapes (five integers for K1, three for K2)."""
    nn_src, nn_fn, nn_args = kernels._ENTRY["nn_distance"]
    fps_src, fps_fn, fps_args = kernels._ENTRY["fps"]
    assert (nn_src, nn_fn, len(nn_args)) == ("nn_distance", "nn_one_way_launch", 13)
    assert (fps_src, fps_fn, len(fps_args)) == ("fps", "fps_launch", 9)
    for src, fn in ((nn_src, nn_fn), (fps_src, fps_fn)):
        text = (kernels.CSRC / f"{src}.cu").read_text()
        assert f'extern "C" int {fn}(' in text and '#include "cluster.cuh"' in text
    assert (kernels.CSRC / "cluster.cuh").is_file()


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n,m", [
    pytest.param(2, 512, 2048, id="512-2048"), pytest.param(2, 2048, 2048, id="2048-2048"),
    pytest.param(2, 1000, 333, id="1000-333"), pytest.param(12, 256, 256, id="B12-256-256"),
    pytest.param(12, 512, 2048, id="B12-512-2048"), pytest.param(8, 2048, 2048, id="B8-2048-2048"),
    pytest.param(40, 2048, 2048, id="B40-2048-2048"),  # more CTAs than one wave
])
def test_nn_distance_kernel_matches_plain(cuda, batch, n, m):
    """K1 with its launch plan equals the plain version bit for bit (d and
    idx), and a repeat gives the same bits."""
    a = torch.rand(batch, n, 3, device="cuda", generator=cuda) - 0.5
    b = torch.rand(batch, m, 3, device="cuda", generator=cuda) - 0.5
    before = kernels.launches["nn_distance"]
    d, i = nn_one_way(a, b)
    d2, i2 = nn_one_way(a, b)
    torch.cuda.synchronize()
    assert kernels.launches["nn_distance"] == before + 2
    dp, ip = nn_one_way_plain(a, b)
    assert torch.equal(d, dp) and torch.equal(i, ip)  # same rounding, same ties
    assert torch.equal(d, d2) and torch.equal(i, i2)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [256, 2048, 2304])
def test_nn_distance_kernel_keeps_the_lowest_index_across_tiles_and_splits(cuda, m):
    """Equal targets on either side of a 256-point tile and of every split
    boundary: every query count and split count, with and without votes,
    keeps the lowest index, as the plain version does."""
    a = torch.rand(3, 512, 3, device="cuda", generator=cuda) - 0.5
    b = torch.rand(3, m, 3, device="cuda", generator=cuda) - 0.5
    dups = sorted({j for s in (2, 4, 8) for j in range(-(-m // s), m, -(-m // s))} | {256})
    for k, j in enumerate(d for d in dups if 0 < d < m):
        b[:, j] = b[:, j - 1]
        a[:, 2 * k] = b[:, j - 1]  # distance 0 to both
        a[:, 2 * k + 1] = b[:, j - 1] + 1e-4  # the same distance to both
    dp, ip = nn_one_way_plain(a, b)
    for q in (2, 4):
        for splits in (1, 2, 4, 8):
            for vote in (0, 4):
                plan = NnPlan(128, q, splits, -(-m // splits), vote)
                d, i = _nn_one_way_kernel(a, b, plan)
                assert torch.equal(d, dp) and torch.equal(i, ip), plan


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n,m", [
    pytest.param(3, 2048, 512, id="2048-512"), pytest.param(3, 2304, 512, id="2304-512"),
    pytest.param(3, 512, 128, id="512-128"), pytest.param(3, 700, 100, id="700-100"),
    pytest.param(3, 16384, 64, id="16384-64"), pytest.param(12, 16384, 2048, id="B12-16384-2048"),
    pytest.param(40, 16384, 256, id="B40-16384-256"),  # more clusters than one wave
])
def test_fps_kernel_matches_plain(cuda, batch, n, m):
    """K2 with its launch plan picks the plain version's indices, with an
    all-invalid row and duplicated points (ties) among the rows, and a repeat
    gives the same indices."""
    x = torch.rand(batch, n, 3, device="cuda", generator=cuda) - 0.5
    x[1] = 0.0  # all-invalid row
    x[2, 1:n // 2] = x[2, n // 2 + 1:n // 2 * 2]  # ties
    before = kernels.launches["fps"]
    got = furthest_point_sample(x, m)
    again = furthest_point_sample(x, m)
    torch.cuda.synchronize()
    assert kernels.launches["fps"] == before + 2
    assert torch.equal(got, furthest_point_sample_ref(x, m))
    assert torch.equal(got, again)
    assert not got[1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_fps_kernel_clusters_match_plain(cuda, cluster):
    """Every cluster size picks the plain version's indices at 2048 and 16384
    points (there at least 2 CTAs), on random points and on a coarse grid
    (many equal distances)."""
    for n, m in ((2048, 512), (16384, 256)):
        x = torch.rand(4, n, 3, device="cuda", generator=cuda) - 0.5
        x[2:] = torch.round(x[2:] * 4) / 4
        plan = fps_launch_plan(4, n, m, H100_SMS, cluster=max(cluster, 2) if n > 8192 else cluster)
        assert torch.equal(_fps_kernel(x, m, plan), furthest_point_sample_ref(x, m)), plan


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", NN_SITES_55)
def test_nn_distance_kernel_matches_plain_at_the_55_sites(cuda, n, m):
    a = torch.rand(B_55, n, 3, device="cuda", generator=cuda) - 0.5
    b = torch.rand(B_55, m, 3, device="cuda", generator=cuda) - 0.5
    d, i = nn_one_way(a, b)
    d2, i2 = nn_one_way(a, b)
    dp, ip = nn_one_way_plain(a, b)
    assert torch.equal(d, dp) and torch.equal(i, ip)
    assert torch.equal(d, d2) and torch.equal(i, i2)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", FPS_SITES_55)
def test_fps_kernel_matches_plain_at_the_55_sites(cuda, n, m):
    x = torch.rand(B_55, n, 3, device="cuda", generator=cuda) - 0.5
    got = furthest_point_sample(x, m)
    assert torch.equal(got, furthest_point_sample_ref(x, m))
    assert torch.equal(got, furthest_point_sample(x, m))


@pytest.mark.cuda
@pytest.mark.parametrize("kept", [2048, 4096, 6144])
def test_fps_kernel_on_the_masked_crop_block(cuda, kept):
    """The train step's crop: 8192 points sorted by distance to a direction,
    the kept block shifted to the front and the rest zeroed. K2 on its
    cluster of 8 CTAs skips the zero rows as the plain version does (the
    origin-skip rule, across the CTAs' point ranges), so the partial is
    bit-equal, and no zero row is picked."""
    from svdformer_pointsea_tpu_torch.data import crop_random_resampled, random_partial

    gt = torch.rand(B_55, 8192, 3, device="cuda", generator=cuda) - 0.5
    direction = torch.nn.functional.normalize(
        torch.randn(B_55, 3, device="cuda", generator=cuda), dim=-1)
    num_crop = torch.full((B_55,), 8192 - kept, dtype=torch.int32, device="cuda")
    num_crop[::2] = 8192 - kept + torch.arange(B_55 // 2, device="cuda", dtype=torch.int32)
    before = kernels.launches["fps"]
    got = random_partial(gt, direction, num_crop, 2048)
    again = random_partial(gt, direction, num_crop, 2048)
    assert kernels.launches["fps"] == before + 2
    with kernels.reference_ops():
        want = random_partial(gt, direction, num_crop, 2048)
        want_both = crop_random_resampled(gt, direction, num_crop, 2048)
    assert torch.equal(got, want) and torch.equal(got, again)
    assert (got.square().sum(-1) > 1e-3).all()
    for g, w in zip(crop_random_resampled(gt, direction, num_crop, 2048), want_both):
        assert torch.equal(g, w)


# The f32 K3's cases: q x 8 (a large spread of scores, the running max moving
# between key tiles) against the naive math in f64, where the f32 naive math
# is itself about 2e-5 from the f64 one; dh 256 is off the model's path.
F32_K3_CASES = [(512, 512, 96, 1.0), (512, 512, 64, 1.0), (2048, 512, 64, 1.0),
                (1024, 1024, 128, 1.0), (512, 1024, 256, 1.0), (512, 512, 96, 8.0),
                (2048, 512, 64, 8.0), (1024, 1024, 128, 8.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lk,dh,spread", F32_K3_CASES)
def test_flash_kernel_matches_naive(cuda, lq, lk, dh, spread):
    """K3 (the split of q, k and v, then the kernel on the planes) against
    the naive math at atol 2e-5, in f32 with q x 1 and in f64 with q x 8."""
    q = torch.randn(2, lq, 8, dh, device="cuda", generator=cuda) * spread
    k = torch.randn(2, lk, 8, dh, device="cuda", generator=cuda)
    v = torch.randn(2, lk, 8, dh, device="cuda", generator=cuda)
    before = dict(kernels.launches)
    out = scaled_attention(q, k, v)
    torch.cuda.synchronize()
    assert kernels.launches["flash_attn"] == before["flash_attn"] + 1
    assert kernels.launches["split_bf16x3"] == before["split_bf16x3"] + 3
    ref = (q, k, v) if spread == 1.0 else (q.double(), k.double(), v.double())
    np.testing.assert_allclose(out.double().cpu().numpy(), naive_attention(*ref).cpu().numpy(),
                               atol=2e-5)


@pytest.mark.cuda
def test_flash_takes_bf16_and_refuses_f16_cuda_inputs(cuda):
    """A bf16 CUDA input of eligible shape launches the bf16 K3 and gives a
    bf16 O; an f16 one raises: neither falls back to the naive math."""
    q = torch.randn(1, 512, 8, 64, device="cuda", generator=cuda).to(torch.bfloat16)
    before = dict(kernels.launches)
    out = scaled_attention(q, q, q)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16
    assert kernels.launches["flash_attn_bf16"] == before["flash_attn_bf16"] + 1
    assert kernels.launches["flash_attn"] == before["flash_attn"]
    want = flash.attention_fwd_plain_bf16(q, q, q)[0].float()
    assert ((out.float() - want).abs().max() / want.abs().max()).item() <= BF16_REL
    with pytest.raises(ValueError, match="float32 or torch.bfloat16"):
        scaled_attention(q.half(), q.half(), q.half())
    assert kernels.launches["flash_attn_bf16"] == before["flash_attn_bf16"] + 1


def _qkv(gen, lq, lk, dh, b=2, h=8, dtype=torch.float32):
    return [torch.randn(b, n, h, dh, device="cuda", generator=gen).to(dtype)
            for n in (lq, lk, lk, lq)]


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lk,dh,spread", F32_K3_CASES)
def test_flash_stats_kernel_matches_plain(cuda, lq, lk, dh, spread):
    """K3 with its row statistics: O (bit-equal to K3 without them and on a
    repeat) and the log-sum-exp against the plain forward, in f32 with q x 1
    and in f64 with q x 8, at atol 2e-5."""
    q, k, v, _ = _qkv(cuda, lq, lk, dh)
    q = q * spread
    before = dict(kernels.launches)
    o, lse = flash._flash_kernel(q, k, v, stats=True)
    o_eval = flash._flash_kernel(q, k, v)
    o_again, lse_again = flash._flash_kernel(q, k, v, stats=True)
    torch.cuda.synchronize()
    assert kernels.launches["flash_attn_stats"] == before["flash_attn_stats"] + 2
    assert kernels.launches["flash_attn"] == before["flash_attn"] + 1
    assert torch.equal(o, o_eval) and torch.equal(o, o_again) and torch.equal(lse, lse_again)
    ref = (q, k, v) if spread == 1.0 else (q.double(), k.double(), v.double())
    o_p, lse_p = flash.attention_fwd_plain(*ref)
    torch.testing.assert_close(o.to(o_p.dtype), o_p, atol=2e-5, rtol=0)
    torch.testing.assert_close(lse.to(lse_p.dtype), lse_p, atol=2e-5, rtol=0)


@pytest.mark.cuda
def test_f32_forward_refuses_lengths_off_its_tiles(cuda):
    """The f32 K3 takes Lq and Lk in multiples of 128 (576 is one of 64, which
    the f32 K4 and K5 take): refused by the wrapper and the flash Function
    before any launch, the split's included."""
    q, k, v, _ = _qkv(cuda, 576, 512, 64)
    before = dict(kernels.launches)
    for stats in (False, True):
        with pytest.raises(ValueError, match="% 128"):
            flash._flash_kernel(q, k, v, stats=stats)
        with pytest.raises(ValueError, match="% 128"):
            flash._flash_kernel(k, q, q, stats=stats)  # Lq 512, Lk 576
    with pytest.raises(ValueError, match="% 128"):
        flash.flash_attention_train(q.requires_grad_(True), k, v)
    assert kernels.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("spread", [1.0, 8.0])
@pytest.mark.parametrize("dh", [64, 96, 128, 256])
@pytest.mark.parametrize("length", [512, 2048])
def test_flash_backward_kernels_match_plain(cuda, dh, length, spread):
    """K5 (dQ) and K4 (dK, dV), on the split planes of q, k, v and dO (one
    split launch each), against the plain backward on the same residuals, at
    atol 2e-4 and rtol 2e-4 (tests/test_flash_vjp.py's bound); also with q
    scaled by 8 (a large spread of scores); a repeat gives the same bits."""
    q, k, v, do = _qkv(cuda, length, length, dh)
    q = q * spread
    o, lse = flash.attention_fwd_plain(q, k, v)
    di = (o * do).sum(-1).transpose(1, 2).contiguous()
    before = dict(kernels.launches)
    dq, dk, dv = flash._bwd_kernels(q, k, v, lse, do, di)
    again = flash._bwd_kernels(q, k, v, lse, do, di)
    torch.cuda.synchronize()
    assert kernels.launches["flash_attn_bwd_dq"] == before["flash_attn_bwd_dq"] + 2
    assert kernels.launches["flash_attn_bwd_dkv"] == before["flash_attn_bwd_dkv"] + 2
    assert kernels.launches["split_bf16x3"] == before["split_bf16x3"] + 8
    assert all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again))
    dk_p, dv_p = flash.attention_bwd_dkv_plain(q, k, v, lse, do, di)
    dq_p = flash.attention_bwd_dq_plain(q, k, v, lse, do, di)
    for got, want in ((dq, dq_p), (dk, dk_p), (dv, dv_p)):
        torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)


@pytest.mark.cuda
def test_f32_backward_launches_the_split_once_per_operand(cuda):
    """One f32 flash backward splits q, k, v and dO (four split launches),
    then launches K5 and K4 once each, and nothing else."""
    q, k, v, do = _qkv(cuda, 512, 1024, 64)
    o, lse = flash.attention_fwd_plain(q, k, v)
    di = flash.attention_di(o, do)
    before = dict(kernels.launches)
    flash._bwd_kernels(q, k, v, lse, do, di)
    torch.cuda.synchronize()
    moved = {n: kernels.launches[n] - before[n] for n in kernels.KERNEL_NAMES}
    assert {n: c for n, c in moved.items() if c} == {
        "split_bf16x3": 4, "flash_attn_bwd_dq": 1, "flash_attn_bwd_dkv": 1}


@pytest.mark.cuda
def test_f32_backward_refuses_lengths_off_its_tiles(cuda):
    """The f32 K5 and K4 take Lq and Lk in multiples of 64: 544 against 512,
    both ways, is refused by the wrapper before any launch, the split's
    included."""
    before = dict(kernels.launches)
    for lq, lk in ((544, 512), (512, 544)):
        q, k, v, do = _qkv(cuda, lq, lk, 64)
        lse = torch.zeros(2, 8, lq, device="cuda")
        with pytest.raises(ValueError, match="% 64"):
            flash._bwd_kernels(q, k, v, lse, do, torch.zeros_like(lse))
    assert kernels.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 512, 8, 64), (12, 2048, 8, 128), (3, 64, 1, 96)])
def test_split_kernel_matches_plain(cuda, shape):
    """The split kernel gives its plain version's planes bit for bit, over
    randn and magnitudes from 1e-30 to 1e30."""
    x = torch.randn(*shape, device="cuda", generator=cuda)
    x[0] *= torch.logspace(-30, 30, x[0].numel(), device="cuda").view(x[0].shape)
    before = kernels.launches["split_bf16x3"]
    got = flash.split_bf16x3(x)
    torch.cuda.synchronize()
    assert kernels.launches["split_bf16x3"] == before + 1
    want = flash.split_bf16x3_plain(x)
    assert got.shape == (3, *shape) and got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.cuda
def test_training_attention_launches_k3_stats_k4_k5(cuda):
    """scaled_attention with a gradient recorded goes through the flash
    Function: the split of q, k and v and K3 with statistics forward, the
    split of dO, K5 and K4 backward (four split launches in all: the forward
    saves the planes of q, k and v for the backward), and its gradients agree
    with autograd through the naive math. Without a gradient (evaluation) it
    launches the split of q, k and v and K3."""
    q, k, v, do = _qkv(cuda, 2048, 512, 64)
    ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = dict(kernels.launches)
    out = scaled_attention(*ins)
    got = torch.autograd.grad(out, ins, do)
    torch.cuda.synchronize()
    moved = {n: kernels.launches[n] - before[n] for n in kernels.KERNEL_NAMES}
    assert {n: c for n, c in moved.items() if c} == {
        "flash_attn_stats": 1, "flash_attn_bwd_dkv": 1, "flash_attn_bwd_dq": 1, "split_bf16x3": 4}
    ref_ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(naive_attention(*ref_ins), ref_ins, do)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=2e-4)
    with torch.inference_mode():
        scaled_attention(q, k, v)
    assert kernels.launches["flash_attn"] == before["flash_attn"] + 1
    assert kernels.launches["flash_attn_stats"] == before["flash_attn_stats"] + 1
    assert kernels.launches["split_bf16x3"] == before["split_bf16x3"] + 4 + 3


@pytest.mark.cuda
def test_flash_function_takes_bf16_and_refuses_f16_and_device_mixes(cuda):
    """bf16 into the flash Function launches the bf16 K3 with statistics,
    K5 and K4 once each and gives a bf16 O and bf16 gradients; f16 and a mix
    of devices raise before any launch."""
    q, k, v, do = _qkv(cuda, 512, 512, 64, dtype=torch.bfloat16)
    before = dict(kernels.launches)
    bf = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = flash.flash_attention_train(*bf)
    grads = torch.autograd.grad(out, bf, do)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and all(g.dtype == torch.bfloat16 for g in grads)
    moved = {n: kernels.launches[n] - before[n] for n in kernels.KERNEL_NAMES}
    assert {n: c for n, c in moved.items() if c} == {
        "flash_attn_stats_bf16": 1, "flash_attn_bwd_dkv_bf16": 1, "flash_attn_bwd_dq_bf16": 1}
    before = dict(kernels.launches)
    with pytest.raises(ValueError, match="float32 or torch.bfloat16"):
        flash.flash_attention_train(*(x.half().requires_grad_(True) for x in (q, k, v)))
    q32, k32, v32 = (x.float() for x in (q, k, v))
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_attention_train(q32.requires_grad_(True), k32.cpu(), v32)
    with pytest.raises(ValueError, match="torch.bfloat16"):
        flash.flash_attention_train(q.requires_grad_(True), k32, v32)  # dtype mix
    assert kernels.launches == before


BF16_REL = 1e-2  # |Δ| ≤ 1e-2 · max|ref| for a bf16 output (tests/test_torch_bf16.py)


def _rel(got, want) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


# The bf16 K3's shapes (every dh at four (Lq, Lk), one of them also with q
# scaled by 8, so that the running max moves between key tiles and the
# accumulator's rescale is exercised) and two more dh-256 shapes.
BF16_CASES = ([(lq, lk, dh, 1.0) for lq, lk in ((512, 512), (2048, 512), (2048, 2048),
                                               (1024, 2048)) for dh in (64, 96, 128, 256)]
              + [(1024, 2048, dh, 8.0) for dh in (64, 96, 128, 256)]
              + [(512, 1024, 256, 1.0), (1024, 512, 256, 1.0)])


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lk,dh,spread", BF16_CASES)
def test_bf16_flash_kernels_match_plain(cuda, lq, lk, dh, spread):
    """The bf16 K3 (O bit-equal with and without statistics and on a
    repeat), K5 and K4 against their bf16 plain versions on the same inputs
    and residuals: O, dq, dk, dv within 1e-2 · max|ref|, LSE within 1e-5
    relative; a second backward gives the same bits (no atomics)."""
    q, k, v, do = _qkv(cuda, lq, lk, dh, dtype=torch.bfloat16)
    q = (q.float() * spread).to(torch.bfloat16)
    before = dict(kernels.launches)
    o, lse = flash._flash_kernel(q, k, v, stats=True)
    o_eval = flash._flash_kernel(q, k, v)
    o_again, lse_again = flash._flash_kernel(q, k, v, stats=True)
    di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    got = flash._bwd_kernels(q, k, v, lse, do, di)
    again = flash._bwd_kernels(q, k, v, lse, do, di)
    torch.cuda.synchronize()
    moved = {n: kernels.launches[n] - before[n] for n in kernels.KERNEL_NAMES}
    assert {n: c for n, c in moved.items() if c} == {
        "flash_attn_bf16": 1, "flash_attn_stats_bf16": 2, "flash_attn_bwd_dq_bf16": 2,
        "flash_attn_bwd_dkv_bf16": 2}
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32 and torch.equal(o, o_eval)
    assert torch.equal(o, o_again) and torch.equal(lse, lse_again)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    o_p, lse_p = flash.attention_fwd_plain_bf16(q, k, v)
    assert _rel(o, o_p) <= BF16_REL
    torch.testing.assert_close(lse, lse_p, atol=0, rtol=1e-5)
    dk_p, dv_p = flash.attention_bwd_dkv_plain_bf16(q, k, v, lse, do, di)
    dq_p = flash.attention_bwd_dq_plain_bf16(q, k, v, lse, do, di)
    for a, b in zip(got, (dq_p, dk_p, dv_p)):
        assert a.dtype == torch.bfloat16 and _rel(a, b) <= BF16_REL


def test_bf16_forward_is_bound_to_its_own_source():
    """The bf16 K3, without and with statistics, is the TMA / wgmma kernel of
    flash_attn_bf16_fwd.cu; the bf16 K4 and K5 are those of
    flash_attn_bf16_bwd.cu. The mma.sync source flash_attn_bf16.cu is gone."""
    for name in ("flash_attn_bf16", "flash_attn_stats_bf16"):
        assert kernels._ENTRY[name][:2] == ("flash_attn_bf16_fwd", "flash_attn_bf16_fwd_launch")
    assert kernels._ENTRY["flash_attn_bwd_dkv_bf16"][:2] == (
        "flash_attn_bf16_bwd", "flash_attn_bf16_bwd_dkv_launch")
    assert kernels._ENTRY["flash_attn_bwd_dq_bf16"][:2] == (
        "flash_attn_bf16_bwd", "flash_attn_bf16_bwd_dq_launch")
    assert {"flash_attn_bf16_fwd", "flash_attn_bf16_bwd"} <= set(kernels.SOURCES)
    assert "flash_attn_bf16" not in kernels.SOURCES
    for src in ("flash_attn_bf16_fwd", "flash_attn_bf16_bwd"):
        assert (kernels.CSRC / f"{src}.cu").is_file()
    assert not (kernels.CSRC / "flash_attn_bf16.cu").exists()


@pytest.mark.cuda
def test_bf16_forward_refuses_lengths_off_its_tiles(cuda):
    """Lq or Lk not a multiple of 128 (576 is one of 64, which the bf16 K4
    and K5 take) is refused by the wrapper before any launch."""
    q, k, v, _ = _qkv(cuda, 576, 512, 64, dtype=torch.bfloat16)
    before = dict(kernels.launches)
    for stats in (False, True):
        with pytest.raises(ValueError, match="% 128"):
            flash._flash_kernel(q, k, v, stats=stats)
        with pytest.raises(ValueError, match="% 128"):
            flash._flash_kernel(k, q, q, stats=stats)  # Lq 512, Lk 576
    assert kernels.launches == before


@pytest.mark.cuda
def test_bf16_backward_refuses_lengths_off_its_tiles(cuda):
    """The bf16 K5 and K4 take Lq and Lk in multiples of 128, as the bf16 K3
    does: 576 (a multiple of the f32 kernels' 64) against 512, both ways, is
    refused by the wrapper before any launch."""
    before = dict(kernels.launches)
    for lq, lk in ((576, 512), (512, 576)):
        q, k, v, do = _qkv(cuda, lq, lk, 64, dtype=torch.bfloat16)
        lse = torch.zeros(2, 8, lq, device="cuda")
        with pytest.raises(ValueError, match="% 128"):
            flash._bwd_kernels(q, k, v, lse, do, torch.zeros_like(lse))
    assert kernels.launches == before


@pytest.mark.cuda
def test_bf16_mode_attention_launches_the_bf16_kernels(cuda):
    """In bf16 mode an eligible f32 site casts q, k, v to bf16: training
    launches the bf16 K3 with statistics, K5 and K4 and no f32 flash kernel,
    evaluation the bf16 K3; output and gradients come back f32 and agree
    with the same site under reference_ops() (the bf16 plain versions)."""
    q, k, v, do = _qkv(cuda, 2048, 512, 64)
    before = dict(kernels.launches)
    with mixed_precision(True):
        ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = scaled_attention(*ins)
        got = torch.autograd.grad(out, ins, do)
        with torch.inference_mode():
            out_eval = scaled_attention(q, k, v)
        torch.cuda.synchronize()
        moved = {n: kernels.launches[n] - before[n] for n in kernels.KERNEL_NAMES}
        assert {n: c for n, c in moved.items() if c} == {
            "flash_attn_stats_bf16": 1, "flash_attn_bwd_dkv_bf16": 1, "flash_attn_bwd_dq_bf16": 1,
            "flash_attn_bf16": 1}
        assert out.dtype == out_eval.dtype == torch.float32
        assert all(g.dtype == torch.float32 for g in got)
        with kernels.reference_ops():
            ref_ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
            out_r = scaled_attention(*ref_ins)
            want = torch.autograd.grad(out_r, ref_ins, do)
        assert {n: kernels.launches[n] - before[n] for n in kernels.KERNEL_NAMES} == moved
    assert torch.equal(out, out_eval)
    assert _rel(out, out_r) <= BF16_REL
    for a, b in zip(got, want):
        assert _rel(a, b) <= BF16_REL


@pytest.mark.cuda
def test_chamfer_and_nn_backward_with_k1_match_plain(cuda):
    """The chamfer and one-way NN gradients (±2 g (p − q[argmin]) scattered
    into both clouds) with K1 in the forward match those of the plain
    forward: K1 picks the same argmins bit for bit, and both sides scatter
    in the same fixed order (held at 1e-6)."""
    a = torch.rand(2, 2048, 3, device="cuda", generator=cuda) - 0.5
    b = torch.rand(2, 512, 3, device="cuda", generator=cuda) - 0.5
    w1 = torch.rand(2, 2048, device="cuda", generator=cuda)
    w2 = torch.rand(2, 512, device="cuda", generator=cuda)

    def grads():
        x, y = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
        d1, d2, _, _ = chamfer_distance(x, y)
        loss = (d1 * w1).sum() + (d2 * w2).sum() + (nn_squared_distance(y, x) * w2).sum()
        return torch.autograd.grad(loss, (x, y))

    before = kernels.launches["nn_distance"]
    got = grads()
    torch.cuda.synchronize()
    assert kernels.launches["nn_distance"] == before + 3
    with kernels.reference_ops():
        want = grads()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6)


def test_scatter_and_gather_keep_their_cpu_ops():
    """On CPU tensors scatter_add_rows is index_add_ and gather_rows is
    gather with gather's own backward, bit for bit (CUDA tensors sum each
    run of equal indices in sorted order instead: below)."""
    g = torch.Generator().manual_seed(0)
    idx = torch.randint(0, 50, (400,), generator=g)
    vals = torch.randn(400, 3, generator=g)
    assert torch.equal(scatter_add_rows(50, idx, vals), torch.zeros(50, 3).index_add_(0, idx, vals))
    pts = torch.randn(2, 50, 4, generator=g).requires_grad_(True)
    gi = torch.randint(0, 50, (2, 300), generator=g)
    gout = torch.randn(2, 300, 4, generator=g)
    (got,) = torch.autograd.grad(gather_rows(pts, gi), pts, gout)
    (want,) = torch.autograd.grad(pts.gather(1, gi[..., None].expand(-1, -1, 4)), pts, gout)
    assert torch.equal(got, want)


# (B, partial, gt, coarse, render resolution, EdgeConv points) and the kNN
# groupings (N, centres, K, channels): PCN training shapes (SA1, SA2 and the
# spectral adapters at K 16 / 32), and a small set for the CPU.
SCATTER_SHAPES = {
    "pcn": ((12, 2048, 16384, 512, 224, 512),
            [(2048, 512, 16, 6), (512, 128, 16, 131), (128, 128, 16, 256), (128, 128, 32, 256)]),
    "small": ((2, 256, 512, 64, 32, 64),
              [(256, 64, 16, 6), (64, 32, 16, 9), (32, 32, 16, 8), (32, 32, 32, 8)]),
}


def _scatter_site(site, gen, device, shapes):
    """A closure that runs one scatter site on fixed inputs: the depth
    render's splat; the chamfer and NN backwards; or the grouping backwards
    (index_points at each kNN grouping, group_local's EdgeConv grouping of
    64 channels at K 8)."""
    (b, n, n_gt, n_coarse, res, n_edge), cases = SCATTER_SHAPES[shapes]

    def surfaces(m):
        v = torch.randn(b, m, 3, device=device, generator=gen)
        return 0.35 * v / v.norm(dim=-1, keepdim=True)

    partial = surfaces(n)
    if site == "render":
        render = PCViews(trans=-0.7, resolution=res)
        return lambda: (render.get_img(partial),)
    if site == "chamfer":
        gt = surfaces(n_gt)
        pred = gt + 0.01 * torch.randn(gt.shape, device=device, generator=gen)
        coarse = partial[:, :n_coarse] + 0.01 * torch.randn(b, n_coarse, 3, device=device,
                                                             generator=gen)

        def run():
            p, q, c = (x.clone().requires_grad_(True) for x in (pred, gt, coarse))
            d1, d2, _, _ = chamfer_distance(p, q)
            loss = d1.sqrt().mean() + d2.sqrt().mean() + nn_squared_distance(c, partial).sum()
            return torch.autograd.grad(loss, (p, q, c))
        return run
    feats = [torch.randn(b, m, ch, device=device, generator=gen) for m, _, _, ch in cases]
    outs = [torch.randn(b, s, k, ch, device=device, generator=gen) for _, s, k, ch in cases]
    idx = [query_knn(k, partial[:, :m], partial[:, :s]) for m, s, k, _ in cases]
    x1 = torch.randn(b, n_edge, 64, device=device, generator=gen)
    g2 = torch.randn(b, n_edge, 8, 64, device=device, generator=gen)

    def run():
        fs = [f.clone().requires_grad_(True) for f in feats]
        loss = sum((index_points(f, i) * o).sum() for f, i, o in zip(fs, idx, outs))
        x = x1.clone().requires_grad_(True)
        loss = loss + (group_local(x, k=8) * g2).sum()
        return torch.autograd.grad(loss, fs + [x])
    return run


def _assert_same_sums(got, want):
    """Equal up to the order of the sums: 1e-5 of want's largest entry."""
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * b.abs().max().item())


@pytest.mark.parametrize("site", ["render", "chamfer", "grouping"])
def test_sorted_path_matches_the_plain_ops_on_cpu(site, monkeypatch):
    """The sorted path (the private index_put_ and _GatherRows' backward with
    its batch offsets), run here on CPU tensors, agrees with index_add_ and
    gather's own backward at each scatter site."""
    run = _scatter_site(site, torch.Generator().manual_seed(5), "cpu", "small")
    want = run()
    monkeypatch.setattr(scatter, "_fixed_order", lambda x: True)
    _assert_same_sums(run(), want)


@pytest.mark.cuda
def test_private_index_put_matches_index_add(cuda):
    """scatter_add_rows' private ATen call equals index_add_ on the card
    (integer-valued terms, so that every order of the sums gives the same
    bits): a torch whose _index_put_impl_ differs fails here."""
    idx = torch.randint(0, 300, (5000,), device="cuda", generator=cuda)
    vals = torch.randint(-64, 64, (5000, 4), device="cuda", generator=cuda).float()
    want = torch.zeros(300, 4, device="cuda").index_add_(0, idx, vals)
    assert torch.equal(scatter_add_rows(300, idx, vals), want)


@pytest.mark.cuda
@pytest.mark.parametrize("site", ["render", "chamfer", "grouping"])
def test_cuda_scatters_are_reproducible(cuda, site, monkeypatch):
    """Two runs at PCN training shapes (B 12) give the same bits under the
    default algorithms: the depth render's splat (2048 points, 224²); the
    chamfer backward at 16384² and the NN backward 512 -> 2048 (K1 in their
    forwards); the grouping backwards of SA1 (kNN 16 of 2048 at 512
    centres), SA2 (16 of 512 at 128, 131 channels), EdgeConv's gcn2 (8 of
    512, 64 channels) and the spectral adapters (16 and 32 of 128, 256
    channels). Each output also agrees, to 1e-5 of its largest entry, with
    the same call through the atomic ops (index_add_ and gather's own
    backward), which share no code with the sorted path."""
    assert not torch.are_deterministic_algorithms_enabled()
    run = _scatter_site(site, cuda, "cuda", "pcn")
    first = run()
    for _ in range(2):
        again = run()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, again)), site
    monkeypatch.setattr(scatter, "_fixed_order", lambda x: False)
    _assert_same_sums(first, run())


def _kitti_partials(n_valid: int, batch: int = 4, n: int = 2048, gen=None) -> torch.Tensor:
    """KITTI-like inputs: ``n_valid`` real points a row, the rest zero rows
    (RandomSamplePoints' padding), a scan of pose-normalised size."""
    x = torch.zeros(batch, n, 3, device="cuda")
    x[:, :n_valid] = (torch.rand(batch, n_valid, 3, device="cuda", generator=gen) - 0.5) * 0.8
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("m", [512, 128])
@pytest.mark.parametrize("valid", [60, 137, 300, 511])
def test_fps_kernel_on_zero_padded_kitti_scans(cuda, valid, m):
    """Fewer real points than picks (a KITTI scan at SA1): once every real
    point is taken, each later pick falls back to index 0, under C = 1, 2, 4
    and 8, as the plain version picks."""
    x = _kitti_partials(valid, gen=cuda)
    want = furthest_point_sample_ref(x, m)
    for c in (1, 2, 4, 8):
        plan = fps_launch_plan(x.shape[0], x.shape[1], m, H100_SMS, cluster=c)
        assert torch.equal(_fps_kernel(x, m, plan), want), plan
    if valid < m:
        assert not want[:, valid:].any()


@pytest.mark.cuda
def test_nn_distance_kernel_with_zero_padded_queries(cuda):
    """KITTI's fidelity: zero-padded scans (B 12 x 2048) into 16384-point
    completions, bit for bit."""
    a = torch.cat([_kitti_partials(v, batch=3, gen=cuda) for v in (60, 137, 300, 2048)])
    b = torch.rand(12, 16384, 3, device="cuda", generator=cuda) - 0.5
    d, i = nn_one_way(a, b)
    dp, ip = nn_one_way_plain(a, b)
    assert torch.equal(d, dp) and torch.equal(i, ip)


@pytest.mark.cuda
def test_emd_on_the_card_matches_the_cpu(cuda):
    """The auction on quantized coordinates (multiples of 2^-6, where the
    distances are exact): dist, assignment, iterations used and the gradient
    bit for bit between the card and the CPU, at the train point."""
    x1 = torch.randint(0, 64, (4, 1024, 3), device="cuda", generator=cuda) / 64.0
    x2 = torch.randint(0, 64, (4, 1024, 3), device="cuda", generator=cuda) / 64.0
    got = emd_convergence(x1, x2, 0.005, 50)
    want = emd_convergence(x1.cpu(), x2.cpu(), 0.005, 50)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    grads = []
    for dev in ("cuda", "cpu"):
        a = x1.detach().to(dev).requires_grad_(True)
        dist, _ = earth_mover_distance(a, x2.to(dev), 0.005, 50)
        dist.sum().backward()
        grads.append(a.grad.cpu())
    assert torch.equal(*grads)


@pytest.mark.cuda
def test_three_interpolate_backward_is_reproducible(cuda):
    """The gather's backward adds in a fixed order on CUDA: two backward
    passes give the same bits, within 1e-5 of the CPU's index_add_."""
    points = torch.randn(8, 512, 64, device="cuda", generator=cuda)
    idx = torch.randint(0, 512, (8, 2048, 3), device="cuda", generator=cuda)
    idx[:, :256] = 7  # a row gathered many times
    weight = torch.rand(8, 2048, 3, device="cuda", generator=cuda)
    cot = torch.randn(8, 2048, 64, device="cuda", generator=cuda)
    grads = []
    for dev in ("cuda", "cuda", "cpu"):
        p = points.detach().to(dev).requires_grad_(True)
        three_interpolate(p, idx.to(dev), weight.to(dev)).backward(cot.to(dev))
        grads.append(p.grad.cpu())
    assert torch.equal(grads[0], grads[1])
    torch.testing.assert_close(grads[0], grads[2], rtol=1e-5, atol=1e-5)
