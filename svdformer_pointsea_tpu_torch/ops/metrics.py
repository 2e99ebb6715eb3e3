"""F-score and density-aware chamfer (semantics of svdformer_pointsea_tpu/ops/metrics.py)."""

from __future__ import annotations

import torch

from svdformer_pointsea_tpu_torch.ops.distances import chamfer_distance


def fscore(dist1: torch.Tensor, dist2: torch.Tensor, threshold: float = 1e-4):
    """F1 on squared nearest distances: (f1, precision_1, precision_2), each (B,)."""
    precision_1 = (dist1 < threshold).float().mean(dim=1)
    precision_2 = (dist2 < threshold).float().mean(dim=1)
    denom = precision_1 + precision_2
    f1 = torch.where(denom > 0, 2 * precision_1 * precision_2 / denom.clamp_min(1e-12),
                     torch.zeros_like(denom))
    return f1, precision_1, precision_2


def _bincount_gather(idx: torch.Tensor, length: int) -> torch.Tensor:
    """count[j] = multiplicity of j in ``idx`` (B, K), gathered back at idx.
    Integer counts add exactly in f32, so the atomics' order does not matter."""
    B, K = idx.shape
    flat = (idx.long() + torch.arange(B, device=idx.device)[:, None] * length).reshape(-1)
    counts = torch.zeros(B * length, device=idx.device)
    counts.index_add_(0, flat, torch.ones_like(flat, dtype=torch.float32))
    return counts[flat].reshape(B, K)


def density_aware_chamfer(x: torch.Tensor, gt: torch.Tensor, alpha: float = 1000.0,
                          n_lambda: float = 1.0):
    """Per-sample (dcd, cd_p, cd_t) of prediction ``x`` (B, N, 3) against
    ``gt`` (B, M, 3); chamfer is called as chamfer(gt, x), the reference order."""
    x = x.float()
    gt = gt.float()
    n_x, n_gt = x.shape[1], gt.shape[1]
    frac_12 = n_x / n_gt
    frac_21 = n_gt / n_x

    dist1, dist2, idx1, idx2 = chamfer_distance(gt, x)
    cd_p = (dist1.sqrt().mean(dim=1) + dist2.sqrt().mean(dim=1)) / 2
    cd_t = dist1.mean(dim=1) + dist2.mean(dim=1)

    exp_dist1 = torch.exp(-dist1 * alpha)
    exp_dist2 = torch.exp(-dist2 * alpha)
    # idx1 indexes into x (n_x points); idx2 into gt (n_gt points).
    weight1 = _bincount_gather(idx1, n_x) ** n_lambda
    weight1 = 1.0 / (weight1 + 1e-6) * frac_21
    loss1 = (1 - exp_dist1 * weight1).mean(dim=1)
    weight2 = _bincount_gather(idx2, n_gt) ** n_lambda
    weight2 = 1.0 / (weight2 + 1e-6) * frac_12
    loss2 = (1 - exp_dist2 * weight2).mean(dim=1)
    return (loss1 + loss2) / 2, cd_p, cd_t
