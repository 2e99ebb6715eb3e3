"""Neighbourhood grouping (semantics of svdformer_pointsea_tpu/ops/grouping.py):
kNN and ball-query groups around FPS centres, one global group, EdgeConv's
self-kNN."""

from __future__ import annotations

from typing import Optional

import torch

from svdformer_pointsea_tpu_torch.ops.distances import query_knn, square_distance
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
    return _group(xyz, points, new_xyz, query_knn(k, xyz, new_xyz), use_xyz)


def _group(xyz, points, new_xyz, idx, use_xyz: bool):
    """The groups at ``idx``: coordinates relative to their ``new_xyz``
    centre, ahead of the features with ``use_xyz``."""
    grouped_xyz = grouping_operation(xyz, idx) - new_xyz[:, :, None, :]
    if points is None:
        new_points = grouped_xyz
    elif use_xyz:
        new_points = torch.cat([grouped_xyz, grouping_operation(points, idx)], dim=-1)
    else:
        new_points = grouping_operation(points, idx)
    return new_xyz, new_points, idx, grouped_xyz


def ball_query(radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor) -> torch.Tensor:
    """(B, S, nsample) int32 indices of the first ``nsample`` points of
    ``xyz`` (B, N, 3), in index order, within ``radius`` of each ``new_xyz``
    (B, S, 3) centre (squared distance in the matmul form < radius²), as
    PointNet++'s CUDA scan keeps them: a centre with fewer hits repeats its
    first hit, one with none gets index 0. The ``nsample`` smallest of the
    keys ``i`` (hit) / ``N + i`` (miss), all distinct, are the first hits in
    index order."""
    N = xyz.shape[1]
    mask = square_distance(new_xyz, xyz) < radius * radius
    ids = torch.arange(N, device=xyz.device)
    keys = torch.where(mask, ids, N + ids)
    slots = torch.topk(keys, nsample, dim=-1, largest=False, sorted=True).values
    hits = mask.sum(-1, keepdim=True)
    idx = torch.where(torch.arange(nsample, device=xyz.device) < hits, slots % N, slots[..., :1] % N)
    return torch.where(hits == 0, 0, idx).int()


def sample_and_group_ball(xyz: torch.Tensor, points: Optional[torch.Tensor], npoint: int,
                          nsample: int, radius: float, use_xyz: bool = True):
    """FPS ``npoint`` centres, group the points of each one's ball
    (:func:`ball_query`); the same returns as :func:`sample_and_group_knn`."""
    new_xyz = gather_points(xyz, furthest_point_sample(xyz, npoint))
    return _group(xyz, points, new_xyz, ball_query(radius, nsample, xyz, new_xyz), use_xyz)


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
