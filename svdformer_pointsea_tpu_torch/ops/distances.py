"""Pairwise distances, kNN and chamfer (channels-last ``(B, N, C)``).

Semantics of svdformer_pointsea_tpu/ops/distances.py:
- ``square_distance`` / ``query_knn``: |s|^2 - 2 s.d + |d|^2 and an exact
  ascending top-k (self included);
- ``nn_squared_distance`` / ``chamfer_distance``: per-query min squared
  distance and int32 argmin (lowest index on ties), with the CUDA chamfer's
  backward: ``±2·g·(p − q[argmin])`` scattered into both clouds (in a fixed
  order on CUDA, ``ops/scatter.py``);
- ``three_nn`` / ``three_interpolate``: PointNet++'s 3 nearest known points
  (sqrt distances, ties to the lowest index) and their weighted features.

The one-way NN search launches kernel K1 (``csrc/nn_distance.cu``) on a CUDA
tensor, with the launch plan of ``nn_launch_plan``, and runs
``nn_one_way_plain`` on a CPU tensor.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Tuple

import torch

from svdformer_pointsea_tpu_torch import kernels
from svdformer_pointsea_tpu_torch.ops.scatter import gather_rows, scatter_add_rows

# Cap on the (B, chunk, M) f32 distance tiles the plain NN search holds at
# once (several temporaries of that size are live), so 16384 x 16384 at
# evaluation batch sizes never materialises in full.
_CHUNK_BYTES = 256 * 1024 * 1024

NN_QUERIES_PER_THREAD = (2, 4)  # the kernel's instances
NN_MAX_THREADS = 256
NN_MAX_SPLITS = 8
NN_VOTES = (0, 4)  # the kernel's instances: targets a vote of the warp, 0 for none
# Launch-plan rules, chosen from timings on the card at every main-path site
# (PERF.md §6): from NN_WIDE_MIN_QUERIES queries a row, CTAs of 256
# threads with 4 queries each, else of 128 with 2 (more threads pay more on
# the small sites); splits of the targets until the card has at least
# NN_WARPS_PER_SM warps an SM (or 8 splits); a vote every 4 targets on ranges
# of NN_VOTE_MIN_TARGETS, where a smaller distance soon becomes rare.
NN_WIDE_MIN_QUERIES = 4096
NN_WARPS_PER_SM = 12
NN_VOTE_MIN_TARGETS = 4096


class NnPlan(NamedTuple):
    """K1's launch: ``threads`` a CTA, ``q`` queries a thread, the targets in
    ``splits`` ranges of ``chunk`` (a cluster of ``splits`` CTAs for each
    block of threads x q queries), and ``vote``: update the running minima
    only after a vote of the warp finds a smaller distance among that many
    targets, or always (0)."""
    threads: int
    q: int
    splits: int
    chunk: int
    vote: int


def split_ranges(m: int, plan: NnPlan) -> List[Tuple[int, int]]:
    """The target ranges [start, end) that the CTAs of a cluster scan, in
    rank order."""
    return [(s * plan.chunk, min(m, (s + 1) * plan.chunk)) for s in range(plan.splits)]


def check_nn_plan(m: int, plan: NnPlan) -> None:
    """Raises ValueError unless ``plan`` is one that ``nn_one_way_launch``
    takes for ``m`` targets: whole warps up to NN_MAX_THREADS, a query count
    of NN_QUERIES_PER_THREAD, 1 to NN_MAX_SPLITS non-empty ranges covering
    [0, m), a vote of NN_VOTES."""
    threads, q, splits, chunk, vote = plan
    if not (vote in NN_VOTES and 32 <= threads <= NN_MAX_THREADS and threads % 32 == 0
            and q in NN_QUERIES_PER_THREAD and 1 <= splits <= NN_MAX_SPLITS and chunk > 0
            and splits * chunk >= m > (splits - 1) * chunk):
        raise ValueError(f"nn_distance launch plan {plan} is not valid for {m} targets")


@functools.lru_cache(maxsize=None)
def nn_launch_plan(batch: int, n: int, m: int, sm_count: int,
                   splits: Optional[int] = None) -> NnPlan:
    """K1's plan for ``batch`` rows of ``n`` queries and ``m`` targets on a
    card of ``sm_count`` SMs: from NN_WIDE_MIN_QUERIES queries CTAs of 256
    threads with 4 queries each, else of 128 threads (fewer where n is
    smaller) with 2; the fewest splits of 1, 2, 4, 8 that give the card
    NN_WARPS_PER_SM warps an SM, else the most that keep a target in every
    range; a vote every 4 targets where a range holds NN_VOTE_MIN_TARGETS.
    ``splits`` fixes S."""
    wide = n >= NN_WIDE_MIN_QUERIES
    q = 4 if wide else 2
    threads = 256 if wide else min(128, max(32, -(-n // (32 * q)) * 32))
    warps = batch * -(-n // (threads * q)) * threads // 32
    valid = [s for s in ((1, 2, 4, 8) if splits is None else (splits,))
             if (s - 1) * -(-m // s) < m]
    if not valid:
        raise ValueError(f"{splits} splits leave a range of {m} targets empty")
    s = next((s for s in valid if warps * s >= NN_WARPS_PER_SM * sm_count), valid[-1])
    chunk = -(-m // s)
    plan = NnPlan(threads, q, s, chunk, 4 if chunk >= NN_VOTE_MIN_TARGETS else 0)
    check_nn_plan(m, plan)
    return plan


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """(B, N, C), (B, M, C) -> (B, N, M) squared euclidean distances."""
    inner = torch.bmm(src, dst.transpose(1, 2))
    s2 = (src * src).sum(-1)
    d2 = (dst * dst).sum(-1)
    return s2[:, :, None] - 2.0 * inner + d2[:, None, :]


def query_knn(nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor) -> torch.Tensor:
    """(B, S, nsample) int64 indices of the nearest ``xyz`` to each ``new_xyz``
    (a point of both sets is its own first neighbour), ascending distance."""
    d = square_distance(new_xyz, xyz)
    return torch.topk(d, nsample, dim=-1, largest=False, sorted=True).indices


def nn_one_way_plain(a: torch.Tensor, b: torch.Tensor):
    """min / argmin squared distance from each of ``a`` (B, N, 3) to ``b``
    (B, M, 3): ((B, N) f32 clamped >= 0, (B, N) int32). Difference form
    (dx*dx + dy*dy) + dz*dz, chunked over queries."""
    a = a.float()
    b = b.float()
    B, N, _ = a.shape
    M = b.shape[1]
    chunk = max(1, min(N, _CHUNK_BYTES // max(1, 16 * B * M)))
    bx, by, bz = (t[:, None, :] for t in b.unbind(-1))
    dmins, idxs = [], []
    for s in range(0, N, chunk):
        ax, ay, az = (t[:, :, None] for t in a[:, s:s + chunk].unbind(-1))
        dx, dy, dz = ax - bx, ay - by, az - bz
        d = dx * dx + dy * dy + dz * dz
        dmin, idx = d.min(dim=-1)
        dmins.append(dmin)
        idxs.append(idx)
    return torch.cat(dmins, 1).clamp_min(0.0), torch.cat(idxs, 1).int()


def _nn_one_way_kernel(a: torch.Tensor, b: torch.Tensor, plan: Optional[NnPlan] = None):
    kernels.check_cuda_input(a, "nn_distance a", torch.float32, 3)
    kernels.check_cuda_input(b, "nn_distance b", torch.float32, 3)
    B, N, C = a.shape
    M = b.shape[1]
    if C != 3 or b.shape[0] != B or b.shape[2] != 3 or M == 0:
        raise ValueError(f"nn_distance takes (B, N, 3), (B, M>0, 3); "
                         f"got {tuple(a.shape)}, {tuple(b.shape)}")
    if plan is None:
        plan = nn_launch_plan(B, N, M, kernels.sm_count(a.device))
    else:
        check_nn_plan(M, plan)
    dmin = torch.empty(B, N, dtype=torch.float32, device=a.device)
    idx = torch.empty(B, N, dtype=torch.int32, device=a.device)
    kernels.launch("nn_distance", a.device, a.data_ptr(), b.data_ptr(), dmin.data_ptr(),
                   idx.data_ptr(), B, N, M, *plan)
    return dmin, idx


def nn_one_way(a: torch.Tensor, b: torch.Tensor):
    """One-way NN search (kernel K1 on CUDA): ((B, N) f32, (B, N) int32)."""
    if kernels.use_kernel(a):
        return _nn_one_way_kernel(a.float().contiguous(), b.float().contiguous())
    return nn_one_way_plain(a, b)


def _gather_rows(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return points.gather(1, idx.long()[:, :, None].expand(-1, -1, points.shape[-1]))


def _scatter_rows(n: int, idx: torch.Tensor, updates: torch.Tensor) -> torch.Tensor:
    """Scatter-add (B, K, 3) ``updates`` into zeros (B, n, 3) at (B, K) ``idx``,
    in a fixed order on CUDA (``ops/scatter.py``)."""
    B, K, C = updates.shape
    flat = (idx.long() + torch.arange(B, device=idx.device)[:, None] * n).reshape(-1)
    return scatter_add_rows(B * n, flat, updates.reshape(B * K, C)).reshape(B, n, C)


class _NNSquaredDistance(torch.autograd.Function):
    @staticmethod
    def forward(ctx, query, target):
        d, idx = nn_one_way(query, target)
        ctx.save_for_backward(query, target, idx)
        return d

    @staticmethod
    def backward(ctx, g):
        query, target, idx = ctx.saved_tensors
        diff = 2.0 * g[..., None] * (query - _gather_rows(target, idx))
        return diff, _scatter_rows(target.shape[1], idx, -diff)


def nn_squared_distance(query: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Differentiable (B, N) min squared distance from ``query`` to ``target``."""
    return _NNSquaredDistance.apply(query, target)


class _ChamferDistance(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xyz1, xyz2):
        d1, idx1 = nn_one_way(xyz1, xyz2)
        d2, idx2 = nn_one_way(xyz2, xyz1)
        ctx.save_for_backward(xyz1, xyz2, idx1, idx2)
        ctx.mark_non_differentiable(idx1, idx2)
        return d1, d2, idx1, idx2

    @staticmethod
    def backward(ctx, g1, g2, _gi1, _gi2):
        xyz1, xyz2, idx1, idx2 = ctx.saved_tensors
        w1 = 2.0 * g1[..., None] * (xyz1 - _gather_rows(xyz2, idx1))
        w2 = 2.0 * g2[..., None] * (xyz2 - _gather_rows(xyz1, idx2))
        grad1 = w1 + _scatter_rows(xyz1.shape[1], idx2, -w2)
        grad2 = w2 + _scatter_rows(xyz2.shape[1], idx1, -w1)
        return grad1, grad2


def chamfer_distance(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """(d1 (B, N), d2 (B, M), idx1, idx2): squared nearest distances both ways
    and int32 argmins, the chamfer_3DDist contract."""
    return _ChamferDistance.apply(xyz1, xyz2)


def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """The 3 nearest ``known`` (B, M, 3) points of each ``unknown`` (B, N, 3)
    point: (B, N, 3) sqrt distances, ascending, and (B, N, 3) int32 indices;
    equal distances go to the lowest index (a stable sort), as ``lax.top_k``
    orders them."""
    d, idx = torch.sort(square_distance(unknown, known), dim=-1, stable=True)
    return d[..., :3].clamp_min(0.0).sqrt(), idx[..., :3].int()


def three_interpolate(points: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """(B, M, C) features of the known points at (B, N, 3) indices, summed
    with (B, N, 3) weights: (B, N, C). The gather's backward adds in a fixed
    order on CUDA (``ops/scatter.py``)."""
    B, N, _ = idx.shape
    g = gather_rows(points, idx.reshape(B, -1)).reshape(B, N, 3, points.shape[-1])
    w = weight[..., None]
    return g[:, :, 0] * w[:, :, 0] + g[:, :, 1] * w[:, :, 1] + g[:, :, 2] * w[:, :, 2]
