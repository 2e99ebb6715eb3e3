"""Evaluation: render -> SVDFormer forward -> per-sample metrics and the
per-category table (semantics of svdformer_pointsea_tpu/train/evaluate.py).
PCN scores the given partials by CD-L1×10³ / DCD / F1; ShapeNet-55 crops each
complete cloud at the 8 fixed corners and scores CD-L2×10³ / DCD / F1."""

from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np
import torch

from svdformer_pointsea_tpu_torch.data.crop import FIXED_CORNERS, crop_fixed
from svdformer_pointsea_tpu_torch.losses import calc_cd, calc_dcd
from svdformer_pointsea_tpu_torch.ops import fps_subsample
from svdformer_pointsea_tpu_torch.render import make_renderer
from svdformer_pointsea_tpu_torch.utils import AverageMeter

METRIC_NAMES = ["cd", "dcd", "f1"]
# The share of a ShapeNet-55 cloud each evaluation difficulty crops away.
CROP_RATIO = {"easy": 1 / 4, "median": 1 / 2, "hard": 3 / 4}


def disable_tf32() -> None:
    """Keep f32 matmuls and cuDNN convolutions in full f32 (cuDNN convolutions
    default to TF32, which keeps about three decimal digits)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _per_sample_metrics(pred, gt, sqrt_cd: bool):
    """(cd ×10³, dcd, f1) per sample; ``sqrt_cd``: CD-L1 (PCN) or CD-L2 sum."""
    cd_p, cd_t, f1 = calc_cd(pred, gt, calc_f1=True)
    dcd, _, _ = calc_dcd(pred, gt)
    cd = cd_p if sqrt_cd else cd_t
    return cd * 1e3, dcd, f1


def make_pcn_eval_fn(model: torch.nn.Module, render):
    """(partial (B, N, 3), gt (B, M, 3)) -> (3, B) metrics [cd×10³, dcd, f1],
    rendering and running ``model`` in eval mode under inference mode."""
    disable_tf32()
    model.eval()

    def eval_fn(partial: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            depth = render.get_img(partial)
            preds = model(partial, depth)
            return torch.stack(_per_sample_metrics(preds[-1], gt, sqrt_cd=True))

    return eval_fn


def eval_pcn(cfg, model: torch.nn.Module, loader, logger=None, epoch: int = 0) -> float:
    """Per-taxonomy CD-L1×10³ / DCD / F1 over ``loader``, on the model's device.

    ``loader`` yields batches with ``data["partial_cloud"]`` (B, N, 3),
    ``data["gtcloud"]`` (B, M, 3), ``taxonomy_ids`` and ``valid`` (rows past
    ``valid`` are padding and are not counted). With a ``logger`` the means
    go to it as ``Test/cd``, ``Test/dcd``, ``Test/f1`` at step ``epoch``.
    Returns the mean CD.
    """
    device = next(model.parameters()).device
    eval_fn = make_pcn_eval_fn(model, make_renderer(cfg))
    tables = _Tables()
    for batch in loader:
        partial = torch.as_tensor(batch.data["partial_cloud"], dtype=torch.float32, device=device)
        gt = torch.as_tensor(batch.data["gtcloud"], dtype=torch.float32, device=device)
        tables.add(batch, eval_fn(partial, gt).cpu().numpy())
    return tables.report(logger, epoch)


def make_55_eval_fn(model: torch.nn.Module, render, num_crop: int,
                    n_sample: int = 2048):
    """(gt (B, N, 3), corners (V, 3)) -> (V, 3, B) metrics [cd×10³ (CD-L2),
    dcd, f1]: for each corner in turn, the ``num_crop`` points nearest it
    cropped away (:func:`crop_fixed`), the rest FPS-resampled to ``n_sample``
    (identity where it has that many), rendered and completed by ``model``
    in eval mode under inference mode."""
    disable_tf32()
    model.eval()

    def eval_fn(gt: torch.Tensor, corners: torch.Tensor) -> torch.Tensor:
        out = []
        with torch.inference_mode():
            for corner in corners:
                partial, _ = crop_fixed(gt, corner.expand(gt.shape[0], 3), num_crop)
                partial = fps_subsample(partial, n_sample)
                preds = model(partial, render.get_img(partial))
                out.append(torch.stack(_per_sample_metrics(preds[-1], gt, sqrt_cd=False)))
        return torch.stack(out)

    return eval_fn


def eval_55(cfg, model: torch.nn.Module, loader, logger=None, epoch: int = 0,
            mode: Optional[str] = None, n_viewpoints: int = 8) -> float:
    """ShapeNet-55 evaluation: every complete cloud of ``loader`` cropped at
    the first ``n_viewpoints`` fixed corners by the share of ``mode``
    (default ``cfg.data.mode``), each crop a sample of the per-category
    CD-L2×10³ / DCD / F1 table, with its mean-class row. Rows past a batch's
    ``valid`` are padding. With a ``logger`` the means go to it as
    ``Test/cd``, ``Test/dcd``, ``Test/f1`` at step ``epoch``. Returns the
    mean CD."""
    device = next(model.parameters()).device
    mode = mode or cfg.data.mode
    num_crop = int(cfg.data.gt_points * CROP_RATIO[mode])
    eval_fn = make_55_eval_fn(model, make_renderer(cfg), num_crop, n_sample=cfg.data.n_points)
    corners = torch.as_tensor(FIXED_CORNERS[:n_viewpoints], device=device)
    tables = _Tables()
    for batch in loader:
        gt = torch.as_tensor(batch.data["gtcloud"], dtype=torch.float32, device=device)
        for m in eval_fn(gt, corners).cpu().numpy():
            tables.add(batch, m)
    return tables.report(logger, epoch, mean_class=True)


class _Tables:
    """Per-category and overall meters of the metrics of METRIC_NAMES."""

    def __init__(self):
        self.category: Dict[str, AverageMeter] = {}
        self.overall = AverageMeter(METRIC_NAMES)

    def add(self, batch, m: np.ndarray) -> None:
        """The (3, B) metrics of ``batch``'s valid rows."""
        for i in range(batch.valid):
            vals = [float(m[0, i]), float(m[1, i]), float(m[2, i])]
            tax = batch.taxonomy_ids[i]
            self.category.setdefault(tax, AverageMeter(METRIC_NAMES)).update(vals)
            self.overall.update(vals)

    def report(self, logger, epoch: int, mean_class: bool = False) -> float:
        """Prints the table, logs the overall means; returns the mean CD."""
        _print_category_table(self.category, self.overall, mean_class)
        if logger is not None:
            for i, name in enumerate(METRIC_NAMES):
                logger.add_scalar(f"Test/{name}", self.overall.avg(i), epoch)
        return self.overall.avg(0)


def _print_category_table(category_metrics: Dict[str, AverageMeter],
                          test_metrics: AverageMeter, mean_class: bool = False) -> None:
    """Per-category results table and the overall row; with ``mean_class``
    also the mean over categories of each category's mean."""
    lines = ["Taxonomy\t#Samples\t" + "\t".join(METRIC_NAMES)]
    for tax in sorted(category_metrics):
        am = category_metrics[tax]
        lines.append(f"{tax}\t{am.count(0)}\t"
                     + "\t".join(f"{am.avg(i):.4f}" for i in range(len(METRIC_NAMES))))
    lines.append("Overall\t\t" + "\t".join(f"{test_metrics.avg(i):.4f}"
                                           for i in range(len(METRIC_NAMES))))
    if mean_class and category_metrics:
        means = [sum(am.avg(i) for am in category_metrics.values()) / len(category_metrics)
                 for i in range(len(METRIC_NAMES))]
        lines.append("MeanClass\t\t" + "\t".join(f"{v:.4f}" for v in means))
    table = "\n".join(lines)
    logging.info("\n%s", table)
    print(table)
