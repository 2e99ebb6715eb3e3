"""Train state, optimizer, LR schedule and the train step of the PCN and
ShapeNet-55 tracks (semantics of svdformer_pointsea_tpu/train/state.py).

The LR is the reference's composite schedule: a linear warmup over the first
``warmup_steps`` optimizer steps, then a per-epoch MultiStep (or Step) decay.
The caller computes it on the host for each step and the step writes it into
the optimizer's parameter groups, as the JAX package injects it into Adam.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Union

import torch

from svdformer_pointsea_tpu_torch.data.crop import random_partial
from svdformer_pointsea_tpu_torch.losses import get_loss, get_loss_pm
from svdformer_pointsea_tpu_torch.nn.layers import bn_row_weights
from svdformer_pointsea_tpu_torch.train.evaluate import disable_tf32

ADAM_EPS = 1e-8  # optax's default; torch's Adam computes m̂ / (sqrt(v̂) + eps) as optax does


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BatchNorm running statistics), its
    optimizer (Adam moments) and the count of steps taken."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def reference_lr_schedule(base_lr: float, warmup_steps: int,
                          lr_decay_step: Union[int, Sequence[int]],
                          gamma: float) -> Callable[[int, int], float]:
    """lr(optimizer_step, completed_epochs): base * min(step, warmup) / warmup,
    times gamma per MultiStep milestone passed (a list of epochs, PCN) or per
    ``lr_decay_step`` epochs (an int, StepLR)."""

    def lr(step: int, epoch: int) -> float:
        warm = min(step, warmup_steps) / warmup_steps if warmup_steps > 0 else 1.0
        if isinstance(lr_decay_step, int):
            decay = gamma ** (epoch // lr_decay_step)
        else:
            decay = gamma ** sum(1 for m in lr_decay_step if m <= epoch)
        return base_lr * warm * decay

    return lr


def make_optimizer(params, weight_decay: float = 0.0,
                   betas=(0.9, 0.999)) -> torch.optim.Optimizer:
    """Adam (AdamW when ``weight_decay`` > 0) with eps 1e-8; its LR is set by
    the train step."""
    cls = torch.optim.AdamW if weight_decay > 0 else torch.optim.Adam
    return cls(params, lr=0.0, betas=tuple(betas), eps=ADAM_EPS, weight_decay=weight_decay)


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer, sqrt_loss: bool,
                    render_fn: Callable[[torch.Tensor], torch.Tensor],
                    partial_matching: bool = False, crop_n_out: Optional[int] = None):
    """The train step, with the depth render fused in. PCN:
    ``step(state, partial, gt, weights, lr) -> (state, metrics)``. With
    ``crop_n_out`` (ShapeNet-55) the step crops its own partials first:
    ``step(state, gt, direction, num_crop, weights, lr)`` takes the (B, 3)
    directions and (B,) crop sizes drawn on the host and runs
    :func:`random_partial` to ``crop_n_out`` points.

    ``weights`` (B,) is the row mask (0 for pad rows): it weights the loss and,
    through :func:`bn_row_weights`, the BatchNorm batch moments. The step
    renders the partial without gradient, runs ``model`` in train mode, takes
    the pyramid loss (with ``partial_matching``, :func:`get_loss_pm`'s),
    back-propagates and takes one optimizer step at ``lr``; the model's
    parameters, running statistics and the optimizer's moments are updated in
    place. metrics = {'loss', 'cdc', 'cd1', 'cd2'}, 0-d tensors. TF32 is
    turned off, as for evaluation: the step is f32.
    """
    disable_tf32()

    def update(state: TrainState, partial: torch.Tensor, gt: torch.Tensor,
               weights: torch.Tensor, lr: float):
        with torch.no_grad():
            depth = render_fn(partial)
        model.train()
        with bn_row_weights(weights):
            outs = model(partial, depth)
        if partial_matching:
            loss, parts = get_loss_pm(outs, partial, gt, sqrt=sqrt_loss, weights=weights)
        else:
            loss, parts = get_loss(outs, gt, sqrt=sqrt_loss, weights=weights)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()
        metrics: Dict[str, torch.Tensor] = {
            "loss": loss.detach(), "cdc": parts[0].detach(), "cd1": parts[1].detach(),
            "cd2": parts[2].detach()}
        return dataclasses.replace(state, step=state.step + 1), metrics

    if crop_n_out is None:
        return update

    def crop_step(state: TrainState, gt: torch.Tensor, direction: torch.Tensor,
                  num_crop: torch.Tensor, weights: torch.Tensor, lr: float):
        return update(state, random_partial(gt, direction, num_crop, crop_n_out), gt, weights, lr)

    return crop_step
