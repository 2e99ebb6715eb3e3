"""The adversarial trainers (semantics of svdformer_pointsea_tpu/train/gan.py
``_bce_logits``, ``GANTrainState``, ``create_gan_state``,
``make_gan_train_step``, ``AdvAuxState``, ``create_adv55_state`` and
``make_adv55_train_step``).

GeoSpecNet trains against a :class:`PointDiscriminator` D with BatchNorm.
Each step runs the generator's forward once; D takes one Adam step on
BCE(D(gt), 1) + BCE(D(P2), 0) in train mode against the detached finest
prediction P2; then the generator takes one step on ``get_loss_pm`` (sqrt)
+ ``gan_weight`` · BCE(D(P2), 1) through the same forward, with the updated
D in eval mode. Both networks and both optimizers are checkpointed.

The optional adversarial branch of the ShapeNet-55 track trains a
:class:`SimplePointDiscriminator` the same way, ``d_steps`` times a step on
0.5 · (BCE(D(gt), 1) + BCE(D(P2), 0)), with ``get_loss_pm`` + λ · BCE(D(P2),
1) for the generator; its D lives with the run and is not checkpointed, as
in the reference.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Iterator, Optional

import torch
import torch.nn.functional as F

from svdformer_pointsea_tpu_torch.data.crop import random_partial
from svdformer_pointsea_tpu_torch.losses import get_loss_pm
from svdformer_pointsea_tpu_torch.nn import (
    PointDiscriminator,
    SimplePointDiscriminator,
    init_parameters,
)
from svdformer_pointsea_tpu_torch.nn.layers import bn_row_weights
from svdformer_pointsea_tpu_torch.train.evaluate import disable_tf32
from svdformer_pointsea_tpu_torch.train.state import TrainState, make_optimizer


def bce_logits(logits: torch.Tensor, target: float,
               weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """BCE with logits against a constant ``target``: the mean over each
    sample's logits, then over the batch, weighted by ``weights`` (B,)."""
    bce = F.binary_cross_entropy_with_logits(logits, torch.full_like(logits, target),
                                             reduction="none")
    per = bce.reshape(bce.shape[0], -1).mean(dim=1)
    if weights is None:
        return per.sum() / per.shape[0]
    return (per * weights).sum() / weights.sum()


@dataclasses.dataclass
class GANTrainState(TrainState):
    """The generator and its Adam (``model``, ``optimizer``), the
    discriminator and its Adam, and the count of steps taken."""

    d_model: Optional[torch.nn.Module] = None
    d_optimizer: Optional[torch.optim.Optimizer] = None


def create_gan_state(cfg, model: torch.nn.Module, seed: int = 1) -> GANTrainState:
    """Step-0 GAN state for the generator ``model``: Adam over its parameters,
    and a :class:`PointDiscriminator` on the model's device with weights
    drawn by ``init_parameters`` from a generator seeded with ``seed + 1``,
    with its own Adam (betas and weight decay of ``cfg.train`` for both)."""
    t = cfg.train
    d_model = PointDiscriminator()
    init_parameters(d_model, torch.Generator().manual_seed(seed + 1))
    d_model.to(next(model.parameters()).device)
    return GANTrainState(model=model,
                         optimizer=make_optimizer(model.parameters(), t.weight_decay, t.betas),
                         d_model=d_model,
                         d_optimizer=make_optimizer(d_model.parameters(), t.weight_decay, t.betas))


def _set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


@contextlib.contextmanager
def _frozen(module: torch.nn.Module) -> Iterator[None]:
    """``module``'s parameters take no gradient inside the block: a loss
    reaches its input through it, not its parameters."""
    params = list(module.parameters())
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def make_gan_train_step(gan_weight: float, render_fn: Callable[[torch.Tensor], torch.Tensor]):
    """GeoSpecNet's GAN step: ``step(state, partial, gt, weights, g_lr, d_lr)
    -> (state, metrics)``.

    The step renders the partial without gradient and runs the generator
    once in train mode with the (B,) row weights ``weights`` in its
    BatchNorms. D (train mode, the same row weights) scores ``gt`` and then
    the detached P2, each pass moving its running statistics in that order,
    and takes one Adam step at ``d_lr`` on BCE(real, 1) + BCE(fake, 0). The
    generator then takes one Adam step at ``g_lr`` on get_loss_pm(sqrt) +
    ``gan_weight`` · BCE(D(P2), 1), D being the updated one in eval mode with
    its parameters frozen. Everything is updated in place. metrics =
    {'g_loss', 'd_loss', 'recon', 'gan', 'cdc', 'cd1', 'cd2'}, 0-d tensors."""
    disable_tf32()

    def step(state: GANTrainState, partial: torch.Tensor, gt: torch.Tensor,
             weights: torch.Tensor, g_lr: float, d_lr: float):
        g_model, d_model = state.model, state.d_model
        with torch.no_grad():
            depth = render_fn(partial)
        g_model.train()
        with bn_row_weights(weights):
            preds = g_model(partial, depth)

        d_model.train()
        with bn_row_weights(weights):
            real = d_model(gt)
            fake = d_model(preds[-1].detach())
        d_loss = bce_logits(real, 1.0, weights) + bce_logits(fake, 0.0, weights)
        state.d_optimizer.zero_grad(set_to_none=True)
        d_loss.backward()
        _set_lr(state.d_optimizer, d_lr)
        state.d_optimizer.step()

        recon, parts = get_loss_pm(preds, partial, gt, sqrt=True, weights=weights)
        d_model.eval()
        with _frozen(d_model):
            gan = bce_logits(d_model(preds[-1]), 1.0, weights)
        g_loss = recon + gan_weight * gan
        state.optimizer.zero_grad(set_to_none=True)
        g_loss.backward()
        _set_lr(state.optimizer, g_lr)
        state.optimizer.step()
        metrics: Dict[str, torch.Tensor] = {
            "g_loss": g_loss.detach(), "d_loss": d_loss.detach(), "recon": recon.detach(),
            "gan": gan.detach(), "cdc": parts[0].detach(), "cd1": parts[1].detach(),
            "cd2": parts[2].detach()}
        return dataclasses.replace(state, step=state.step + 1), metrics

    return step


@dataclasses.dataclass
class AdvAuxState:
    """The discriminator and its Adam optimizer."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer


def create_adv55_state(cfg, device, seed: int = 1) -> AdvAuxState:
    """A :class:`SimplePointDiscriminator` on ``device`` with weights drawn
    by ``init_parameters`` from a generator seeded with ``seed + 1``, and its
    Adam (no weight decay, ``cfg.train.betas``)."""
    d_model = SimplePointDiscriminator()
    init_parameters(d_model, torch.Generator().manual_seed(seed + 1))
    d_model.to(device)
    return AdvAuxState(d_model, make_optimizer(d_model.parameters(), 0.0, cfg.train.betas))


def make_adv55_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer, *,
                          sqrt_loss: bool, lambda_g: float, d_steps: int,
                          render_fn: Callable[[torch.Tensor], torch.Tensor], crop_n_out: int):
    """The adversarial 55 step: ``step(state, adv, gt, direction, num_crop,
    weights, lr, d_lr) -> (state, adv, metrics)``, cropping, rendering and
    weighting rows as ``make_train_step`` with ``crop_n_out`` does. metrics
    = {'loss' (the generator's total), 'd_loss' (of the last D step, before
    its update), 'gan' (the generator's BCE term), 'cdc', 'cd1', 'cd2'}."""
    disable_tf32()

    def step(state: TrainState, adv: AdvAuxState, gt: torch.Tensor, direction: torch.Tensor,
             num_crop: torch.Tensor, weights: torch.Tensor, lr: float, d_lr: float):
        partial = random_partial(gt, direction, num_crop, crop_n_out)
        with torch.no_grad():
            depth = render_fn(partial)
        model.train()
        with bn_row_weights(weights):
            preds = model(partial, depth)
        fake = preds[-1].detach()
        _set_lr(adv.optimizer, d_lr)
        d_loss = torch.zeros((), device=gt.device)
        for _ in range(d_steps):
            d_loss = 0.5 * (bce_logits(adv.model(gt), 1.0, weights)
                            + bce_logits(adv.model(fake), 0.0, weights))
            adv.optimizer.zero_grad(set_to_none=True)
            d_loss.backward()
            adv.optimizer.step()

        recon, parts = get_loss_pm(preds, partial, gt, sqrt=sqrt_loss, weights=weights)
        with _frozen(adv.model):
            g_adv = bce_logits(adv.model(preds[-1]), 1.0, weights)
        loss = recon + lambda_g * g_adv
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        _set_lr(optimizer, lr)
        optimizer.step()
        metrics: Dict[str, torch.Tensor] = {
            "loss": loss.detach(), "d_loss": d_loss.detach(), "gan": g_adv.detach(),
            "cdc": parts[0].detach(), "cd1": parts[1].detach(), "cd2": parts[2].detach()}
        return dataclasses.replace(state, step=state.step + 1), adv, metrics

    return step
