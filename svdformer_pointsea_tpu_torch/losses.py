"""Training losses and evaluation metric calculators (semantics of
svdformer_pointsea_tpu/losses.py).

- ``get_loss``: the coarse / fine1 / fine2 chamfer pyramid against
  FPS-subsampled ground truths; ``sqrt=True`` (PCN) averages sqrt distances
  (CD-L1-style), ``sqrt=False`` squared ones. Row weights (B,) give a
  weighted mean of per-sample means: pad rows (weight 0) add nothing.
- ``get_loss_pm`` (ShapeNet-55): the same pyramid plus the one-way partial
  matching term from the input partial to the finest prediction.
- ``calc_cd``: evaluation CD, called as chamfer(gt, output) (the reference's
  argument order); ``calc_dcd``: density-aware CD.
"""

from __future__ import annotations

from typing import Optional

import torch

from svdformer_pointsea_tpu_torch.ops import (
    chamfer_distance,
    density_aware_chamfer,
    fps_subsample,
    fscore,
    nn_squared_distance,
)

# sqrt of an exact zero has an infinite derivative; this floor keeps the
# gradient finite without measurably changing the loss.
_SQRT_EPS = 1e-12


def _batch_mean(d: torch.Tensor, weights: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over (B, N) distances; with (B,) ``weights`` the weighted mean of
    the per-sample means."""
    per = d.mean(dim=1)
    if weights is None:
        return per.sum() / d.shape[0]
    return (per * weights).sum() / weights.sum()


def chamfer(p1: torch.Tensor, p2: torch.Tensor, weights: Optional[torch.Tensor] = None):
    """mean(d1) + mean(d2) over squared distances (CD-L2-style sum)."""
    d1, d2, _, _ = chamfer_distance(p1, p2)
    return _batch_mean(d1, weights) + _batch_mean(d2, weights)


def chamfer_sqrt(p1: torch.Tensor, p2: torch.Tensor, weights: Optional[torch.Tensor] = None):
    """(mean(sqrt d1) + mean(sqrt d2)) / 2 (CD-L1-style)."""
    d1, d2, _, _ = chamfer_distance(p1, p2)
    return (_batch_mean(torch.sqrt(d1 + _SQRT_EPS), weights)
            + _batch_mean(torch.sqrt(d2 + _SQRT_EPS), weights)) / 2


def chamfer_single_side(p1: torch.Tensor, p2: torch.Tensor,
                        weights: Optional[torch.Tensor] = None):
    """mean over p1 of the squared distance to p2 (one NN search, K1 on CUDA)."""
    return _batch_mean(nn_squared_distance(p1, p2), weights)


def chamfer_single_side_sqrt(p1: torch.Tensor, p2: torch.Tensor,
                             weights: Optional[torch.Tensor] = None):
    """mean over p1 of the distance to p2."""
    return _batch_mean(torch.sqrt(nn_squared_distance(p1, p2) + _SQRT_EPS), weights)


def _pyramid(pcds_pred, gt: torch.Tensor, cd, weights: Optional[torch.Tensor]):
    pc, p1, p2 = pcds_pred
    gt_1 = fps_subsample(gt, p1.shape[1])
    gt_c = fps_subsample(gt_1, pc.shape[1])
    return [cd(pc, gt_c, weights), cd(p1, gt_1, weights), cd(p2, gt, weights)]


def get_loss(pcds_pred, gt: torch.Tensor, sqrt: bool = True,
             weights: Optional[torch.Tensor] = None):
    """Pyramid chamfer loss of (coarse, fine1, fine2) against ``gt`` (B, M, 3),
    FPS-subsampled to each prediction's size (kernel K2 on CUDA).
    Returns (loss, [cdc, cd1, cd2])."""
    cdc, cd1, cd2 = _pyramid(pcds_pred, gt, chamfer_sqrt if sqrt else chamfer, weights)
    return cdc + cd1 + cd2, [cdc, cd1, cd2]


def get_loss_pm(pcds_pred, partial: torch.Tensor, gt: torch.Tensor, sqrt: bool = True,
                weights: Optional[torch.Tensor] = None):
    """:func:`get_loss`'s pyramid plus the partial matching term: the mean
    distance (squared unless ``sqrt``) from each point of the input
    ``partial`` (B, N, 3) to the finest prediction. Returns (loss, [cdc, cd1,
    cd2]); the partial term is in the loss only."""
    cdc, cd1, cd2 = _pyramid(pcds_pred, gt, chamfer_sqrt if sqrt else chamfer, weights)
    pm = chamfer_single_side_sqrt if sqrt else chamfer_single_side
    return cdc + cd1 + cd2 + pm(partial, pcds_pred[2], weights), [cdc, cd1, cd2]


def calc_cd(output: torch.Tensor, gt: torch.Tensor, calc_f1: bool = False):
    """Per-sample [cd_p (CD-L1-style), cd_t (CD-L2-style sum)] (+ f1). Chamfer
    is called as chamfer(gt, output), the reference order."""
    dist1, dist2, _, _ = chamfer_distance(gt, output)
    cd_p = (dist1.sqrt().mean(dim=1) + dist2.sqrt().mean(dim=1)) / 2
    cd_t = dist1.mean(dim=1) + dist2.mean(dim=1)
    res = [cd_p, cd_t]
    if calc_f1:
        res.append(fscore(dist1, dist2)[0])
    return res


def calc_dcd(x: torch.Tensor, gt: torch.Tensor, alpha: float = 1000.0, n_lambda: float = 1.0):
    """Density-aware CD: per-sample (dcd, cd_p, cd_t)."""
    return density_aware_chamfer(x, gt, alpha=alpha, n_lambda=n_lambda)
