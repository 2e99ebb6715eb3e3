"""Checkpoints with the reference's best / periodic policy (semantics of
svdformer_pointsea_tpu/train/checkpoint.py, stored with ``torch.save``).

After each epoch's validation, ``ckpt-epoch-NNN.pt`` is written when
``epoch % save_freq == 0`` and ``ckpt-best.pt`` whenever the validation CD
improves. A checkpoint holds the model (parameters and BatchNorm running
statistics), the optimizer (Adam moments and step counts), the epoch, the
best metric so far and the train step count, so training resumes exactly. A
GAN run's checkpoint (``GANTrainState``) also holds the discriminator and its
optimizer under ``d_model`` / ``d_optimizer``; evaluation reads the
generator's ``model`` alone.
"""

from __future__ import annotations

import dataclasses
import os

import torch

_KEYS = ("model", "optimizer", "epoch", "best_metric", "step")
_D_KEYS = ("d_model", "d_optimizer")


def _has_d(state) -> bool:
    return getattr(state, "d_model", None) is not None


def save_checkpoint(path: str, state, epoch: int, best_metric: float) -> None:
    """Write ``state`` (a ``TrainState`` or ``GANTrainState``) with its epoch
    and best metric to ``path``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    payload = {"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
               "epoch": int(epoch), "best_metric": float(best_metric), "step": int(state.step)}
    if _has_d(state):
        payload.update(d_model=state.d_model.state_dict(),
                       d_optimizer=state.d_optimizer.state_dict())
    torch.save(payload, tmp)
    os.replace(tmp, path)


def restore_checkpoint(path: str, state):
    """Load ``path`` into ``state``'s model and optimizer (on the model's
    device), and into its discriminator and D optimizer when ``state`` has
    them; returns ``(state with its step, epoch, best_metric)``."""
    device = next(state.model.parameters()).device
    payload = torch.load(path, map_location=device, weights_only=True)
    keys = _KEYS + (_D_KEYS if _has_d(state) else ())
    if not isinstance(payload, dict) or not set(keys) <= set(payload):
        raise ValueError(f"{path} is not a checkpoint of this port (keys {keys}); loading "
                         "an original .pth checkpoint is ROADMAP queue A item 14")
    state.model.load_state_dict(payload["model"], strict=True)
    state.optimizer.load_state_dict(payload["optimizer"])
    if _has_d(state):
        state.d_model.load_state_dict(payload["d_model"], strict=True)
        state.d_optimizer.load_state_dict(payload["d_optimizer"])
    return (dataclasses.replace(state, step=int(payload["step"])), int(payload["epoch"]),
            float(payload["best_metric"]))


class CheckpointManager:
    """The best / periodic policy over ``<out_dir>/checkpoints``."""

    def __init__(self, out_dir: str, save_freq: int):
        self.dir = os.path.join(out_dir, "checkpoints")
        os.makedirs(self.dir, exist_ok=True)
        self.save_freq = save_freq
        self.best_metric = float("inf")

    @property
    def best_path(self) -> str:
        return os.path.join(self.dir, "ckpt-best.pt")

    def epoch_path(self, epoch: int) -> str:
        return os.path.join(self.dir, f"ckpt-epoch-{epoch:03d}.pt")

    def maybe_save(self, state, epoch: int, val_metric: float) -> bool:
        """Save the periodic and best checkpoints; True if validation improved."""
        improved = val_metric < self.best_metric
        if improved:
            self.best_metric = val_metric
        if epoch % self.save_freq == 0:
            save_checkpoint(self.epoch_path(epoch), state, epoch, self.best_metric)
        if improved:
            save_checkpoint(self.best_path, state, epoch, self.best_metric)
        return improved
