"""Model and train-state construction for the PCN track (semantics of
svdformer_pointsea_tpu/train/loop.py ``build_model`` / ``init_state``).

The model is built on the CUDA card unless the caller names another device;
without a card and without ``device``, :func:`build_model` raises rather than
falling back to the CPU.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from svdformer_pointsea_tpu_torch.nn import SVDFormer, init_parameters
from svdformer_pointsea_tpu_torch.train.state import (
    TrainState,
    make_optimizer,
    reference_lr_schedule,
)


def build_model(cfg, device: Optional[str] = None, seed: int = 0) -> SVDFormer:
    """SVDFormer from ``cfg.network`` with weights drawn by ``init_parameters``
    from a ``torch.Generator`` seeded with ``seed``, on ``device`` (default:
    the CUDA card; pass ``device="cpu"`` to build on the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("build_model: no CUDA device is visible; pass device='cpu' "
                               "to build on the CPU")
        device = "cuda"
    model = SVDFormer.from_config(cfg.network)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device)


def init_state(cfg, model: torch.nn.Module) -> TrainState:
    """Step-0 train state: ``model`` with Adam (AdamW with weight decay) over
    its parameters, betas and weight decay from ``cfg.train``."""
    opt = make_optimizer(model.parameters(), cfg.train.weight_decay, cfg.train.betas)
    return TrainState(model=model, optimizer=opt)


def make_lr_fn(cfg) -> Callable[[int, int], float]:
    """The reference warmup + MultiStep schedule of ``cfg.train``. The LR of
    the batch taken after ``global_step`` steps in 1-based ``epoch`` is
    ``lr_fn(global_step + 1, epoch - 1)``."""
    t = cfg.train
    return reference_lr_schedule(t.learning_rate, t.warmup_steps, t.lr_decay_step, t.gamma)
