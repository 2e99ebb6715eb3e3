"""Scatter-based multi-view depth rasterizer (SVDFormer's ``PCViews``).

Semantics of svdformer_pointsea_tpu/render/pcviews.py: rotate and
perspective-project three fixed views, snap with ``ceil(x + offset)``, wrap
with a floored modulo after masking, and scatter depth-weighted values into
per-view pixel buffers; a pixel with zero weight divides by 1.

The splat adds with ``ops/scatter.py::scatter_add_rows``: on CUDA in a fixed
order (a stable sort of the pixel indices, no atomics), so two runs of one
input give the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from svdformer_pointsea_tpu_torch.ops.scatter import scatter_add_rows


def euler2mat(angles: np.ndarray) -> np.ndarray:
    """Euler angles (..., 3) -> rotation matrices (..., 3, 3), R = Rx @ Ry @ Rz."""
    angles = np.asarray(angles, np.float32)
    x, y, z = angles[..., 0], angles[..., 1], angles[..., 2]
    cz, sz = np.cos(z), np.sin(z)
    cy, sy = np.cos(y), np.sin(y)
    cx, sx = np.cos(x), np.sin(x)
    one, zero = np.ones_like(x), np.zeros_like(x)
    shape = angles.shape[:-1] + (3, 3)
    zmat = np.stack([cz, -sz, zero, sz, cz, zero, zero, zero, one], -1).reshape(shape)
    ymat = np.stack([cy, zero, sy, zero, one, zero, -sy, zero, cy], -1).reshape(shape)
    xmat = np.stack([one, zero, zero, zero, cx, -sx, zero, sx, cx], -1).reshape(shape)
    return xmat @ ymat @ zmat


def _distribute_and_average(depth: torch.Tensor, _x: torch.Tensor, _y: torch.Tensor,
                            size_x: int, size_y: int, image_height: int,
                            image_width: int) -> torch.Tensor:
    """Weighted scatter of per-point depth (B, P) at continuous pixel
    coordinates into (B, H, W): sum(w * z) / (sum(w) or 1), w = mask / (z + eps)."""
    assert size_x % 2 == 0 or size_x == 1
    assert size_y % 2 == 0 or size_y == 1
    B = depth.shape[0]
    eps = 1e-12
    # size 1 gives the single offset -0.5, i.e. round half up.
    _i = torch.from_numpy(np.linspace(-size_x / 2, size_x / 2 - 1, size_x, dtype=np.float32))
    _j = torch.from_numpy(np.linspace(-size_y / 2, size_y / 2 - 1, size_y, dtype=np.float32))
    _i, _j = _i.to(depth.device), _j.to(depth.device)

    ex = torch.ceil(_x[:, :, None, None] + _i[None, None, :, None])  # (B, P, sx, sy)
    ey = torch.ceil(_y[:, :, None, None] + _j[None, None, None, :])
    ex, ey = torch.broadcast_tensors(ex, ey)
    value = depth[:, :, None, None].expand(ex.shape)
    mask = (ex >= 0) & (ex <= image_height - 1) & (ey >= 0) & (ey <= image_width - 1) & (value >= 0)
    ex = torch.remainder(ex, image_height)
    ey = torch.remainder(ey, image_width)

    weight = mask.float() / (value + eps)
    weighted_value = value * weight
    size = image_height * image_width
    coords = (ex * image_width + ey).long().reshape(B, -1)
    flat = (coords + torch.arange(B, device=depth.device)[:, None] * size).reshape(-1)
    sums = scatter_add_rows(B * size, flat,
                            torch.stack([weight.reshape(-1), weighted_value.reshape(-1)], 1))
    weight_sum, value_sum = sums[:, 0], sums[:, 1]
    weight_sum = torch.where(weight_sum == 0.0, torch.ones_like(weight_sum), weight_sum)
    return (value_sum / weight_sum).reshape(B, image_height, image_width)


def points2depth(points: torch.Tensor, image_height: int, image_width: int,
                 size_x: int = 4, size_y: int = 4) -> torch.Tensor:
    """Perspective-project camera-frame points (B, P, 3) to a (B, H, W) depth image."""
    eps = 1e-12
    z = points[:, :, 2]
    coord_x = (points[:, :, 0] / (z + eps)) * (image_width / image_height)
    coord_y = points[:, :, 1] / (z + eps)
    _x = (coord_x + 1) * image_height / 2
    _y = (coord_y + 1) * image_width / 2
    return _distribute_and_average(z, _x, _y, size_x, size_y, image_height, image_width)


class PCViews:
    """Three fixed self-views of a point cloud as depth images.

    ``PCViews(trans=-0.7, resolution=224).get_img(points)`` maps (B, P, 3) to
    (B, 3, H, W) on the points' device.
    """

    _VIEW_ANGLES = np.asarray(
        [[0 * np.pi / 2, 0, np.pi / 2], [1 * np.pi / 2, 0, np.pi / 2], [0, -np.pi / 2, np.pi / 2]],
        np.float32,
    )

    def __init__(self, trans: float, resolution: int = 224):
        self.num_views = 3
        self.resolution = resolution
        # Stored pre-transposed so that projection is points @ rot.
        self.rot = torch.from_numpy(
            np.ascontiguousarray(np.transpose(euler2mat(self._VIEW_ANGLES), (0, 2, 1))))
        self.translation = torch.tensor([[0.0, 0.0, trans]] * 3).reshape(3, 1, 3)

    def get_img(self, points: torch.Tensor) -> torch.Tensor:
        B = points.shape[0]
        rot = self.rot.to(points.device)
        trans = self.translation.to(points.device)
        proj = torch.einsum("bpc,vcd->bvpd", points.float(), rot) - trans[None]
        img = points2depth(proj.reshape(B * 3, -1, 3), self.resolution, self.resolution,
                           size_x=1, size_y=1)
        return img.reshape(B, 3, self.resolution, self.resolution)
