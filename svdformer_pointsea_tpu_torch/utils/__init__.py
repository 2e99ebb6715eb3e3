"""Host-side helpers."""

from svdformer_pointsea_tpu_torch.utils.meters import AverageMeter

__all__ = ["AverageMeter"]
