"""Neighbourhood grouping (semantics of svdformer_pointsea_tpu/ops/grouping.py)."""

from __future__ import annotations

from typing import Optional

import torch

from svdformer_pointsea_tpu_torch.ops.distances import query_knn
from svdformer_pointsea_tpu_torch.ops.fps import furthest_point_sample, gather_points
from svdformer_pointsea_tpu_torch.ops.scatter import gather_rows


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) gathered at (B, ...) indices -> (B, ..., C); the backward
    adds repeated indices in a fixed order on CUDA (``ops/scatter.py``)."""
    B, _, C = points.shape
    return gather_rows(points, idx.reshape(B, -1)).reshape(*idx.shape, C)


def grouping_operation(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) features + (B, S, K) indices -> (B, S, K, C)."""
    return index_points(points, idx)


def sample_and_group_knn(xyz: torch.Tensor, points: Optional[torch.Tensor], npoint: int,
                         k: int, use_xyz: bool = True):
    """FPS ``npoint`` centres, group their ``k`` nearest neighbours.

    Returns new_xyz (B, npoint, 3), new_points (B, npoint, k, 3 | C | 3+C) with
    centre-relative coordinates first, idx (B, npoint, k), grouped_xyz.
    """
    new_xyz = gather_points(xyz, furthest_point_sample(xyz, npoint))
    idx = query_knn(k, xyz, new_xyz)
    grouped_xyz = grouping_operation(xyz, idx) - new_xyz[:, :, None, :]
    if points is None:
        new_points = grouped_xyz
    elif use_xyz:
        new_points = torch.cat([grouped_xyz, grouping_operation(points, idx)], dim=-1)
    else:
        new_points = grouping_operation(points, idx)
    return new_xyz, new_points, idx, grouped_xyz


def sample_and_group_all(xyz: torch.Tensor, points: Optional[torch.Tensor], use_xyz: bool = True):
    """One global group: new_xyz zeros (B, 1, 3), new_points (B, 1, N, ...),
    idx (B, 1, N) arange, grouped_xyz (B, 1, N, 3)."""
    B, N, _ = xyz.shape
    new_xyz = torch.zeros(B, 1, 3, dtype=xyz.dtype, device=xyz.device)
    grouped_xyz = xyz[:, None]
    idx = torch.arange(N, device=xyz.device).expand(B, 1, N)
    if points is None:
        new_points = grouped_xyz
    else:
        new_points = (torch.cat([xyz, points], dim=-1) if use_xyz else points)[:, None]
    return new_xyz, new_points, idx, grouped_xyz


def group_local(xyz: torch.Tensor, k: int = 20, return_idx: bool = False):
    """Self-kNN grouping (EdgeConv): (B, N, C) -> neighbours (B, N, k, C),
    absolute and self included, and with ``return_idx`` their (B, N, k)
    indices too."""
    idx = query_knn(k, xyz, xyz)
    grouped = grouping_operation(xyz, idx)
    return (grouped, idx) if return_idx else grouped
