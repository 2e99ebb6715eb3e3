"""Online partial synthesis by directional cropping, for the ShapeNet-55
track (semantics of svdformer_pointsea_tpu/data/crop.py).

A complete cloud is sorted once by distance to a viewpoint (a stable sort,
as ``jnp.argsort``; the distance rounded as the JAX package rounds it, so the
order and its ties are the same). Evaluation keeps the far block of a fixed
size. Training keeps a block of a per-sample size through one batched FPS:
the sorted cloud is shifted cyclically so that the kept block starts at
index 0 (FPS's first pick, which is always index 0, is then the point the
reference seeds at) and every other row is zeroed. Zero rows are never
picked: FPS skips points with |p|² <= 1e-3 (``ops/fps.py``, kernel K2 and its
plain version alike).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from svdformer_pointsea_tpu_torch.ops import fps_subsample

# The 8 corner viewpoints of ShapeNet-55's evaluation, not normalised (the
# reference's test_55.py).
FIXED_CORNERS = np.asarray(
    [[1, 1, 1], [1, 1, -1], [1, -1, 1], [-1, 1, 1], [-1, -1, 1], [-1, 1, -1], [1, -1, -1],
     [-1, -1, -1]], np.float32)


def _sorted_by_direction(gt: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) points by ascending distance to the (B, 3) ``direction``;
    the distance is sqrt((dx·dx + dy·dy) + dz·dz), each operation rounded on
    its own, and equal distances keep their input order."""
    diff = direction[:, None, :] - gt
    dx, dy, dz = diff.unbind(-1)
    d = torch.sqrt(dx * dx + dy * dy + dz * dz)
    order = torch.sort(d, dim=1, stable=True).indices
    return gt.gather(1, order[..., None].expand(-1, -1, 3))


@torch.no_grad()
def crop_fixed(gt: torch.Tensor, direction: torch.Tensor,
               num_crop: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The evaluation crop: (partial (B, N - num_crop, 3), crop (B, num_crop,
    3)), the ``num_crop`` points nearest ``direction`` removed; both in
    ascending distance order."""
    s = _sorted_by_direction(gt, direction)
    return s[:, num_crop:], s[:, :num_crop]


def masked_block(s: torch.Tensor, start: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """The block [start, start + count) of each sorted cloud (B, N, 3),
    shifted cyclically to index 0, the other rows zeroed: FPS's input."""
    N = s.shape[1]
    ranks = torch.arange(N, device=s.device)[None, :]
    shift = torch.remainder(ranks + start[:, None].long(), N)
    block = s.gather(1, shift[..., None].expand(-1, -1, 3))
    keep = ranks < count[:, None].long()
    return torch.where(keep[..., None], block, torch.zeros_like(block))


def _masked_fps(s: torch.Tensor, start: torch.Tensor, count: torch.Tensor,
                n_out: int) -> torch.Tensor:
    return fps_subsample(masked_block(s, start, count), n_out)


@torch.no_grad()
def random_partial(gt: torch.Tensor, direction: torch.Tensor, num_crop: torch.Tensor,
                   n_out: int = 2048) -> torch.Tensor:
    """The training partial: for each sample, the points left after removing
    its ``num_crop`` (B,) points nearest its ``direction`` (B, 3), resampled
    to ``n_out`` by FPS (kernel K2 on CUDA). (B, n_out, 3)."""
    s = _sorted_by_direction(gt, direction)
    return _masked_fps(s, num_crop, gt.shape[1] - num_crop, n_out)


@torch.no_grad()
def crop_random_resampled(gt: torch.Tensor, direction: torch.Tensor, num_crop: torch.Tensor,
                          n_out: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """(partial, crop), both (B, n_out, 3) and FPS-resampled: the training
    partial of :func:`random_partial` and the removed points. The train step
    takes the partial only."""
    s = _sorted_by_direction(gt, direction)
    partial = _masked_fps(s, num_crop, gt.shape[1] - num_crop, n_out)
    return partial, _masked_fps(s, torch.zeros_like(num_crop), num_crop, n_out)


def random_crop_params(rng: np.random.RandomState, batch: int,
                       n: int) -> Tuple[np.ndarray, np.ndarray]:
    """The host's draw of a batch's crops: (num_crop (batch,) int32 in [n/4,
    3n/4], direction (batch, 3) f32 on the unit sphere), in the JAX package's
    order of draws."""
    num_crop = rng.randint(n // 4, 3 * n // 4 + 1, size=(batch,)).astype(np.int32)
    d = rng.randn(batch, 3).astype(np.float32)
    d /= np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
    return num_crop, d
