"""PCN evaluation: render -> SVDFormer forward -> per-sample CD-L1×10³ / DCD / F1,
and the per-category table (semantics of svdformer_pointsea_tpu/train/evaluate.py)."""

from __future__ import annotations

import logging
from typing import Dict

import torch

from svdformer_pointsea_tpu_torch.losses import calc_cd, calc_dcd
from svdformer_pointsea_tpu_torch.render import PCViews, make_renderer
from svdformer_pointsea_tpu_torch.utils import AverageMeter

METRIC_NAMES = ["cd", "dcd", "f1"]


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


def make_pcn_eval_fn(model: torch.nn.Module, render: PCViews):
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
    category_metrics: Dict[str, AverageMeter] = {}
    test_metrics = AverageMeter(METRIC_NAMES)
    for batch in loader:
        partial = torch.as_tensor(batch.data["partial_cloud"], dtype=torch.float32, device=device)
        gt = torch.as_tensor(batch.data["gtcloud"], dtype=torch.float32, device=device)
        m = eval_fn(partial, gt).cpu().numpy()
        for i in range(batch.valid):
            vals = [float(m[0, i]), float(m[1, i]), float(m[2, i])]
            tax = batch.taxonomy_ids[i]
            category_metrics.setdefault(tax, AverageMeter(METRIC_NAMES)).update(vals)
            test_metrics.update(vals)

    _print_category_table(category_metrics, test_metrics)
    if logger is not None:
        for i, name in enumerate(METRIC_NAMES):
            logger.add_scalar(f"Test/{name}", test_metrics.avg(i), epoch)
    return test_metrics.avg(0)


def _print_category_table(category_metrics: Dict[str, AverageMeter],
                          test_metrics: AverageMeter) -> None:
    """Per-category results table and the overall row."""
    lines = ["Taxonomy\t#Samples\t" + "\t".join(METRIC_NAMES)]
    for tax in sorted(category_metrics):
        am = category_metrics[tax]
        lines.append(f"{tax}\t{am.count(0)}\t"
                     + "\t".join(f"{am.avg(i):.4f}" for i in range(len(METRIC_NAMES))))
    lines.append("Overall\t\t" + "\t".join(f"{test_metrics.avg(i):.4f}"
                                           for i in range(len(METRIC_NAMES))))
    table = "\n".join(lines)
    logging.info("\n%s", table)
    print(table)
