"""Train state, optimizer, LR schedule and the PCN train step (semantics of
svdformer_pointsea_tpu/train/state.py).

The LR is the reference's composite schedule: a linear warmup over the first
``warmup_steps`` optimizer steps, then a per-epoch MultiStep (or Step) decay.
The caller computes it on the host for each step and the step writes it into
the optimizer's parameter groups, as the JAX package injects it into Adam.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence, Union

import torch

from svdformer_pointsea_tpu_torch.losses import get_loss
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
                    render_fn: Callable[[torch.Tensor], torch.Tensor]):
    """The PCN train step, with the depth render fused in:
    ``step(state, partial, gt, weights, lr) -> (state, metrics)``.

    ``weights`` (B,) is the row mask (0 for pad rows): it weights the loss and,
    through :func:`bn_row_weights`, the BatchNorm batch moments. The step
    renders ``partial`` without gradient, runs ``model`` in train mode, takes
    the pyramid loss, back-propagates and takes one Adam step at ``lr``; the
    model's parameters, running statistics and the optimizer's moments are
    updated in place. metrics = {'loss', 'cdc', 'cd1', 'cd2'}, 0-d tensors.
    TF32 is turned off, as for evaluation: the step is f32.
    """
    disable_tf32()

    def step(state: TrainState, partial: torch.Tensor, gt: torch.Tensor,
             weights: torch.Tensor, lr: float):
        with torch.no_grad():
            depth = render_fn(partial)
        model.train()
        with bn_row_weights(weights):
            outs = model(partial, depth)
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

    return step
