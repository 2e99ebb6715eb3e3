"""The optional adversarial branch of the ShapeNet-55 track (semantics of
svdformer_pointsea_tpu/train/gan.py ``_bce_logits``, ``AdvAuxState``,
``create_adv55_state`` and ``make_adv55_train_step``).

A :class:`SimplePointDiscriminator` D trains beside the generator. Each step
runs the generator's forward once; D takes ``d_steps`` Adam steps on
0.5 · (BCE(D(gt), 1) + BCE(D(P2), 0)) against the detached finest prediction
P2; then the generator takes one step on ``get_loss_pm`` + λ · BCE(D(P2), 1)
through the same forward, with the updated D. D's state lives with the run
and is not checkpointed, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from svdformer_pointsea_tpu_torch.data.crop import random_partial
from svdformer_pointsea_tpu_torch.losses import get_loss_pm
from svdformer_pointsea_tpu_torch.nn import SimplePointDiscriminator, init_parameters
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
        d_params = list(adv.model.parameters())
        for group in adv.optimizer.param_groups:
            group["lr"] = d_lr
        d_loss = torch.zeros((), device=gt.device)
        for _ in range(d_steps):
            d_loss = 0.5 * (bce_logits(adv.model(gt), 1.0, weights)
                            + bce_logits(adv.model(fake), 0.0, weights))
            adv.optimizer.zero_grad(set_to_none=True)
            d_loss.backward()
            adv.optimizer.step()

        recon, parts = get_loss_pm(preds, partial, gt, sqrt=sqrt_loss, weights=weights)
        for p in d_params:  # the generator's term reaches P2 through D, not D itself
            p.requires_grad_(False)
        try:
            g_adv = bce_logits(adv.model(preds[-1]), 1.0, weights)
        finally:
            for p in d_params:
                p.requires_grad_(True)
        loss = recon + lambda_g * g_adv
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()
        metrics: Dict[str, torch.Tensor] = {
            "loss": loss.detach(), "d_loss": d_loss.detach(), "gan": g_adv.detach(),
            "cdc": parts[0].detach(), "cd1": parts[1].detach(), "cd2": parts[2].detach()}
        return dataclasses.replace(state, step=state.step + 1), adv, metrics

    return step
