"""Host-side helpers."""

from svdformer_pointsea_tpu_torch.utils.logging import StepTimer, SummaryLogger
from svdformer_pointsea_tpu_torch.utils.meters import AverageMeter

__all__ = ["AverageMeter", "StepTimer", "SummaryLogger"]
