"""Furthest point sampling (FPS) and index gathering.

Semantics of svdformer_pointsea_tpu/ops/fps.py (the pointnet2 CUDA op):
- the first selected index is always 0;
- each round updates a per-point running min squared distance to the
  selected set and picks the first-occurrence argmax;
- points with ``|p|^2 <= 1e-3`` are never selected; with no valid point the
  pick falls back to index 0;
- int32 indices, no gradient.

``furthest_point_sample`` launches kernel K2 (``csrc/fps.cu``) on a CUDA
tensor and runs ``furthest_point_sample_ref`` on a CPU tensor.
"""

from __future__ import annotations

import torch

from svdformer_pointsea_tpu_torch import kernels

_MAG_SKIP = 1e-3
_INIT_DIST = 1e10
_MAX_KERNEL_POINTS = 16384


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


def _fps_kernel(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    kernels.check_cuda_input(xyz, "fps xyz", torch.float32, 3)
    B, N, C = xyz.shape
    if C != 3 or not 0 < N <= _MAX_KERNEL_POINTS:
        raise ValueError(f"fps kernel takes (B, N<= {_MAX_KERNEL_POINTS}, 3), got {tuple(xyz.shape)}")
    out = torch.empty(B, npoint, dtype=torch.int32, device=xyz.device)
    kernels.launch("fps", xyz.device, xyz.data_ptr(), out.data_ptr(), B, N, npoint)
    return out


@torch.no_grad()
def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """FPS: (B, N, 3) float -> (B, npoint) int32 indices (kernel K2 on CUDA)."""
    if kernels.use_kernel(xyz):
        return _fps_kernel(xyz.float().contiguous(), npoint)
    return furthest_point_sample_ref(xyz, npoint)


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) gathered at (B, S) indices -> (B, S, C)."""
    C = points.shape[-1]
    return points.gather(1, idx.long()[:, :, None].expand(-1, -1, C))


def fps_subsample(pcd: torch.Tensor, n_points: int = 2048) -> torch.Tensor:
    """FPS-resample (B, N, 3) to (B, n_points, 3); identity when N == n_points."""
    if pcd.shape[1] == n_points:
        return pcd
    return gather_points(pcd, furthest_point_sample(pcd, n_points))
