"""Furthest point sampling (FPS) and index gathering.

Semantics of svdformer_pointsea_tpu/ops/fps.py (the pointnet2 CUDA op):
- the first selected index is always 0;
- each round updates a per-point running min squared distance to the
  selected set and picks the first-occurrence argmax;
- points with ``|p|^2 <= 1e-3`` are never selected; with no valid point the
  pick falls back to index 0;
- int32 indices, no gradient.

``furthest_point_sample`` launches kernel K2 (``csrc/fps.cu``) on a CUDA
tensor, with the launch plan of ``fps_launch_plan``, and runs
``furthest_point_sample_ref`` on a CPU tensor.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from svdformer_pointsea_tpu_torch import kernels
from svdformer_pointsea_tpu_torch.ops.scatter import gather_rows

_MAG_SKIP = 1e-3
_INIT_DIST = 1e10
_MAX_KERNEL_POINTS = 16384
FPS_CLUSTERS = (1, 2, 4, 8, 16)  # CTAs a sample; above 8 a non-portable cluster
FPS_POINTS_PER_THREAD = (4, 16)  # the kernel's instances
FPS_MAX_THREADS = 512  # at 16 points a thread in registers: 8192 points a CTA
FPS_MAX_SMEM = 232448  # bytes of shared memory a CTA may use
# Launch-plan rules, chosen from timings on the card at every main-path site
# (PERF.md §6): a cluster above this many points a sample (one CTA of
# FPS_THREADS threads at 16 points a thread), and 4 points a thread where
# FPS_THREADS threads cover a CTA's points that way.
FPS_CLUSTER_MIN_POINTS = 2049
FPS_THREADS = 128


class FpsPlan(NamedTuple):
    """K2's launch: ``cluster`` CTAs a sample, ``threads`` a CTA, ``ppt``
    points a thread; CTA r of a cluster owns points [r * chunk, (r + 1) *
    chunk) with chunk = ceil(N / cluster)."""
    cluster: int
    threads: int
    ppt: int


def fps_smem_bytes(n: int, plan: FpsPlan) -> int:
    """Dynamic shared memory of one CTA: two mbarriers, two 8-byte slots a
    warp of the cluster, and the cloud's n points."""
    return 16 + 16 * plan.cluster * (plan.threads // 32) + 12 * n


def check_fps_plan(n: int, plan: FpsPlan) -> None:
    """Raises ValueError unless ``plan`` is one that ``fps_launch`` takes for
    ``n`` points: a cluster size of FPS_CLUSTERS, a point count of
    FPS_POINTS_PER_THREAD, whole warps up to FPS_MAX_THREADS, every point
    covered and every CTA owning one, shared memory within FPS_MAX_SMEM."""
    cluster, threads, ppt = plan
    chunk = -(-n // cluster) if cluster in FPS_CLUSTERS else 0
    if not (cluster in FPS_CLUSTERS and ppt in FPS_POINTS_PER_THREAD and 32 <= threads
            <= FPS_MAX_THREADS and threads % 32 == 0 and threads * ppt >= chunk
            and (cluster - 1) * chunk < n and fps_smem_bytes(n, plan) <= FPS_MAX_SMEM):
        raise ValueError(f"fps launch plan {plan} is not valid for {n} points")


@functools.lru_cache(maxsize=None)
def fps_launch_plan(batch: int, n: int, npoint: int, sm_count: int,
                    cluster: Optional[int] = None) -> FpsPlan:
    """K2's plan for ``batch`` samples of ``n`` points on a card of
    ``sm_count`` SMs. A round of FPS is a chain of dependent steps, so a
    sample's points go to one cluster of C CTAs on neighbouring SMs: the
    largest C of 8, 4, 2 with batch x C <= sm_count (every cluster resident
    at once) from FPS_CLUSTER_MIN_POINTS points, else C = 2 (the clusters
    run in waves); below that C = 1 (the round's exchange costs about what
    it saves on fewer points). ``cluster`` fixes C instead (C = 1 takes at
    most 16 x FPS_MAX_THREADS points). Then 4 points a thread where
    FPS_THREADS threads cover the CTA's points that way, else 16, and the
    fewest whole warps that cover them. ``npoint`` sets no rule: every round
    is alike."""
    del npoint
    if cluster is None:
        cluster = 1
        if n >= FPS_CLUSTER_MIN_POINTS:
            cluster = next((c for c in (8, 4, 2) if batch * c <= sm_count), 2)
    while cluster > 1 and (cluster - 1) * -(-n // cluster) >= n:
        cluster //= 2  # every CTA owns a point
    chunk = -(-n // cluster)
    ppt = 4 if chunk <= 4 * FPS_THREADS else 16
    plan = FpsPlan(cluster, max(32, -(-chunk // (32 * ppt)) * 32), ppt)
    check_fps_plan(n, plan)
    return plan


def _sq3(dx: torch.Tensor, dy: torch.Tensor, dz: torch.Tensor) -> torch.Tensor:
    # (dx*dx + dy*dy) + dz*dz, every op rounded on its own — the order the
    # kernel evaluates, so both pick the same indices bit for bit.
    return dx * dx + dy * dy + dz * dz


def furthest_point_sample_ref(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Plain FPS: one distance update + argmax per round. (B, N, 3) -> (B, npoint) int32."""
    xyz = xyz.float()
    B, N, _ = xyz.shape
    x, y, z = xyz.unbind(-1)
    valid = _sq3(x, y, z) > _MAG_SKIP
    out = torch.zeros(B, npoint, dtype=torch.int64, device=xyz.device)
    mindist = torch.full((B, N), _INIT_DIST, device=xyz.device)
    last = out[:, 0]
    neg_inf = torch.tensor(float("-inf"), device=xyz.device)
    for j in range(1, npoint):
        lp = xyz.gather(1, last[:, None, None].expand(B, 1, 3))  # (B, 1, 3)
        d = _sq3(x - lp[:, :, 0], y - lp[:, :, 1], z - lp[:, :, 2])
        mindist = torch.minimum(mindist, d)
        last = torch.where(valid, mindist, neg_inf).argmax(dim=1)
        out[:, j] = last
    return out.int()


def _fps_kernel(xyz: torch.Tensor, npoint: int, plan: Optional[FpsPlan] = None) -> torch.Tensor:
    kernels.check_cuda_input(xyz, "fps xyz", torch.float32, 3)
    B, N, C = xyz.shape
    if C != 3 or not 0 < N <= _MAX_KERNEL_POINTS:
        raise ValueError(f"fps kernel takes (B, N<= {_MAX_KERNEL_POINTS}, 3), got {tuple(xyz.shape)}")
    if plan is None:
        plan = fps_launch_plan(B, N, npoint, kernels.sm_count(xyz.device))
    else:
        check_fps_plan(N, plan)
    out = torch.empty(B, npoint, dtype=torch.int32, device=xyz.device)
    kernels.launch("fps", xyz.device, xyz.data_ptr(), out.data_ptr(), B, N, npoint, *plan)
    return out


@torch.no_grad()
def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """FPS: (B, N, 3) float -> (B, npoint) int32 indices (kernel K2 on CUDA)."""
    if kernels.use_kernel(xyz):
        return _fps_kernel(xyz.float().contiguous(), npoint)
    return furthest_point_sample_ref(xyz, npoint)


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) gathered at (B, S) indices -> (B, S, C); the backward adds
    repeated indices in a fixed order on CUDA (``ops/scatter.py``)."""
    return gather_rows(points, idx)


def fps_subsample(pcd: torch.Tensor, n_points: int = 2048) -> torch.Tensor:
    """FPS-resample (B, N, 3) to (B, n_points, 3); identity when N == n_points."""
    if pcd.shape[1] == n_points:
        return pcd
    return gather_points(pcd, furthest_point_sample(pcd, n_points))
