"""Evaluation metric calculators (semantics of svdformer_pointsea_tpu/losses.py)."""

from __future__ import annotations

import torch

from svdformer_pointsea_tpu_torch.ops import chamfer_distance, density_aware_chamfer, fscore


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
