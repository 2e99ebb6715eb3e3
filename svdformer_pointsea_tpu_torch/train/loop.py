"""Orchestration of the PCN, ShapeNet-55, GeoSpecNet and PointSea tracks:
model and train-state construction, ``train_net``, GeoSpecNet's
``train_net_gan`` and ``test_net`` (semantics of
svdformer_pointsea_tpu/train/loop.py and ``train_net_gan`` of
svdformer_pointsea_tpu/train/gan.py). PointSea runs the PCN loop with its
realistic renderer (``render.make_renderer``).

The model is built on the CUDA card unless the caller names another device;
without a card and without ``device``, :func:`build_model` (and so
``train_net`` / ``test_net``) raises rather than falling back to the CPU.
"""

from __future__ import annotations

import logging
import os
import random
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from svdformer_pointsea_tpu_torch.data import Loader, make_dataset, random_crop_params
from svdformer_pointsea_tpu_torch.nn import GeoSpecNet, PointSea, SVDFormer, init_parameters
from svdformer_pointsea_tpu_torch.nn.precision import mixed_precision
from svdformer_pointsea_tpu_torch.render import make_renderer
from svdformer_pointsea_tpu_torch.train.checkpoint import CheckpointManager, restore_checkpoint
from svdformer_pointsea_tpu_torch.train.evaluate import eval_55, eval_pcn
from svdformer_pointsea_tpu_torch.train.gan import (
    create_adv55_state,
    create_gan_state,
    make_adv55_train_step,
    make_gan_train_step,
)
from svdformer_pointsea_tpu_torch.train.state import (
    TrainState,
    make_optimizer,
    make_train_step,
    reference_lr_schedule,
)
from svdformer_pointsea_tpu_torch.utils import AverageMeter, StepTimer, SummaryLogger


def resolve_device(device: Optional[str] = None) -> str:
    """``device``, or the CUDA card when none is named; raises when no card
    is visible and no device is named."""
    if device is not None:
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass device='cpu' to run on the CPU")
    return "cuda"


_MODELS = {"svdformer": SVDFormer, "geospecnet": GeoSpecNet, "pointsea": PointSea}


def build_model(cfg, device: Optional[str] = None, seed: int = 0) -> torch.nn.Module:
    """The generator ``cfg.network.model`` names (SVDFormer, GeoSpecNet or PointSea)
    from ``cfg.network``, with weights drawn by ``init_parameters`` from a
    ``torch.Generator`` seeded with ``seed``, on ``device`` (default: the
    CUDA card; pass ``device="cpu"`` to build on the CPU)."""
    device = resolve_device(device)
    model = _MODELS[cfg.network.model].from_config(cfg.network)
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


def set_seed(seed: int) -> None:
    """Seed the host generators (the reference's main_pcn.py)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def check_supported(cfg) -> None:
    """Refuse, with the ROADMAP item that ports it, a configuration this
    port does not run: nothing is ignored silently."""
    t = cfg.train
    if cfg.data.name not in ("ShapeNet", "ShapeNet55"):
        raise NotImplementedError(f"the {cfg.data.name} track is not ported (ROADMAP queue A "
                                  "item 13 for KITTI)")
    if cfg.network.model not in _MODELS:
        raise ValueError(f"model must be one of {sorted(_MODELS)}, got {cfg.network.model!r}")
    if t.adv_enabled and cfg.data.name != "ShapeNet55":
        raise NotImplementedError("the adversarial branch belongs to the ShapeNet-55 track; "
                                  "GeoSpecNet's GAN is train_net_gan")
    if t.sp != 1:
        raise NotImplementedError(f"sp={t.sp}: sequence parallelism is multi-GPU work "
                                  "(ROADMAP queue A item 15)")
    if t.dp != "gspmd":
        raise NotImplementedError(f"dp={t.dp}: shard_map data parallelism is multi-GPU work "
                                  "(ROADMAP queue A item 15)")
    if t.precision not in ("f32", "bf16"):
        raise ValueError(f"precision must be f32 or bf16, got {t.precision!r}")


def train_net(cfg, max_epochs: Optional[int] = None, max_steps: Optional[int] = None,
              device: Optional[str] = None):
    """A full training run: per epoch, the train loader's batches through
    the train step at the reference LR schedule, validation with the val
    loader keyed by the same epoch, and the best / periodic checkpoints;
    resumes from ``cfg.weights`` (a checkpoint of this port) at the epoch
    after the saved one. ``cfg.train.precision`` "bf16" runs the whole run,
    validation included, in bf16 mode.

    PCN validates on the val split with ``eval_pcn``. ShapeNet-55 validates
    on the test split with ``eval_55`` at ``cfg.data.mode``, and each batch's
    crops (sizes and directions) are drawn on the host from a generator
    keyed by (seed, epoch, 55), once a batch, so that a resumed run replays
    the straight run; ``cfg.train.adv_enabled`` trains the discriminator
    beside it (its state is not checkpointed).

    ``max_epochs`` / ``max_steps`` bound the run for smoke tests. Returns
    ``(state, best_metric)``.
    """
    return _train(cfg, max_epochs, max_steps, device, gan=False)


def train_net_gan(cfg, max_epochs: Optional[int] = None, max_steps: Optional[int] = None,
                  device: Optional[str] = None):
    """GeoSpecNet's GAN run on PCN data: ``train_net``'s loop (loaders,
    schedule, ``eval_pcn`` validation of the generator each epoch, best /
    periodic checkpoints, resume, epoch log) with ``make_gan_train_step`` as
    the step, both optimizers at the schedule's LR. Checkpoints hold both
    networks and both optimizers; ``Train/g_loss`` and ``Train/d_loss`` are
    logged. Returns ``(GANTrainState, best_metric)``."""
    return _train(cfg, max_epochs, max_steps, device, gan=True)


def _train(cfg, max_epochs: Optional[int], max_steps: Optional[int], device: Optional[str],
           gan: bool):
    check_supported(cfg)
    is_55 = cfg.data.name == "ShapeNet55"
    if gan and is_55:
        raise ValueError("train_net_gan trains on PCN data; the ShapeNet-55 track's adversarial "
                         "branch is cfg.train.adv_enabled")
    device = resolve_device(device)
    set_seed(cfg.seed)
    tcfg = cfg.train
    with mixed_precision(tcfg.precision == "bf16"):
        # The Loader pads a short batch by repeating its rows, as the
        # reference duplicates an odd batch on the 55 track.
        train_loader = Loader(make_dataset(cfg, "train", seed=cfg.seed), tcfg.batch_size,
                              shuffle=True, seed=cfg.seed, num_workers=cfg.data.num_workers)
        val_loader = Loader(make_dataset(cfg, "test" if is_55 else "val", seed=cfg.seed),
                            tcfg.batch_size, shuffle=False, num_workers=cfg.data.num_workers)
        model = build_model(cfg, device=device, seed=cfg.seed)
        logging.info("Parameters: %d", sum(p.numel() for p in model.parameters()))
        render_fn = make_renderer(cfg).get_img
        dev = next(model.parameters()).device
        scalars = ("loss",)
        if gan:
            state = create_gan_state(cfg, model, seed=cfg.seed)
            logging.info("Discriminator parameters: %d",
                         sum(p.numel() for p in state.d_model.parameters()))
            gan_step = make_gan_train_step(tcfg.gan_weight, render_fn)
            scalars = ("g_loss", "d_loss")

            def step(state, partial, gt, weights, lr):
                return gan_step(state, partial, gt, weights, lr, lr)
        elif tcfg.adv_enabled:
            state = init_state(cfg, model)
            adv = create_adv55_state(cfg, dev, seed=cfg.seed)
            adv_step = make_adv55_train_step(
                model, state.optimizer, sqrt_loss=tcfg.sqrt_loss, lambda_g=tcfg.adv_lambda_g,
                d_steps=tcfg.adv_d_steps, render_fn=render_fn, crop_n_out=cfg.data.n_points)

            def step(state, *batch_and_lr):
                state, _, metrics = adv_step(state, adv, *batch_and_lr, tcfg.adv_d_lr)
                return state, metrics
        else:
            state = init_state(cfg, model)
            step = make_train_step(model, state.optimizer, tcfg.sqrt_loss, render_fn,
                                   partial_matching=tcfg.partial_matching,
                                   crop_n_out=cfg.data.n_points if is_55 else None)
        lr_fn = make_lr_fn(cfg)

        ckpts = CheckpointManager(cfg.out_path, tcfg.save_freq)
        start_epoch = 1
        if cfg.weights:
            state, saved_epoch, ckpts.best_metric = restore_checkpoint(cfg.weights, state)
            start_epoch = saved_epoch + 1
            logging.info("Resumed from %s at epoch %d", cfg.weights, saved_epoch)
        n_epochs = min(tcfg.n_epochs, max_epochs or tcfg.n_epochs)
        global_step = state.step
        logger = SummaryLogger(os.path.join(cfg.out_path, "logs"))
        timer = StepTimer()

        for epoch in range(start_epoch, n_epochs + 1):
            # Data randomness derives from (seed, epoch): a resumed run
            # replays the straight run's batches exactly.
            train_loader.set_epoch(epoch)
            crop_rng = np.random.RandomState(
                np.random.SeedSequence([cfg.seed, epoch, 55]).generate_state(1)[0])
            epoch_t0 = time.time()
            timer.reset()
            losses = AverageMeter(["cdc", "cd1", "cd2"])
            totals = AverageMeter(list(scalars))
            data_time, batch_time = AverageMeter(), AverageMeter()
            pending = []  # (step, lr, metrics on the device), read after the epoch

            def consume(entries):
                vals = None
                for step_i, lr_i, metrics in entries:
                    vals = [float(metrics[k]) * 1e3 for k in ("cdc", "cd1", "cd2")]
                    losses.update(vals)
                    totals.update([float(metrics[k]) for k in scalars])
                    for key in scalars:
                        logger.add_scalar(f"Train/{key}", float(metrics[key]), step_i)
                    logger.add_scalar("Train/lr", lr_i, step_i)
                return vals

            n_batches = 0
            for batch in train_loader:
                timer.mark_data()
                lr = lr_fn(global_step + 1, epoch - 1)
                gt = torch.as_tensor(batch.data["gtcloud"], device=dev)
                # One device: every row, the loader's repeated pad rows too,
                # has weight 1, as the JAX package's pad_batch gives them.
                weights = torch.ones(gt.shape[0], device=dev)
                if is_55:
                    num_crop, direction = random_crop_params(crop_rng, *gt.shape[:2])
                    state, metrics = step(state, gt, torch.as_tensor(direction, device=dev),
                                          torch.as_tensor(num_crop, device=dev), weights, lr)
                else:
                    partial = torch.as_tensor(batch.data["partial_cloud"], device=dev)
                    state, metrics = step(state, partial, gt, weights, lr)
                global_step += 1
                # Reading the metrics now would wait for the step; they are
                # read one step late (--progress) or after the epoch.
                pending.append((global_step, lr, metrics))
                if tcfg.progress and len(pending) > 1:
                    step_i, lr_i, _ = pending[0]
                    vals = consume([pending.pop(0)])
                    sys.stderr.write(f"\repoch {epoch} step {step_i} losses(x1e3) "
                                     f"cdc={vals[0]:.3f} cd1={vals[1]:.3f} cd2={vals[2]:.3f} "
                                     f"lr={lr_i:.2e}  ")
                    sys.stderr.flush()
                n_batches += 1
                timer.mark_batch()
                data_time.update(timer.data_time)
                batch_time.update(timer.batch_time)
                if max_steps is not None and global_step >= max_steps:
                    break
            consume(pending)
            if tcfg.progress and n_batches:
                sys.stderr.write("\n")
            wall = time.time() - epoch_t0
            logging.info("Epoch %d/%d t=%.1fs data=%.3fs/it host=%.3fs/it step=%.3fs/it "
                         "losses(x1e3)=%s %s", epoch, n_epochs, wall, data_time.avg(),
                         batch_time.avg(), wall / max(n_batches, 1),
                         [f"{v:.3f}" for v in losses.avg()],
                         " ".join(f"{k}={totals.avg(i):.4f}" for i, k in enumerate(scalars)))

            # The val loader is keyed by the true epoch too, so validation (and
            # with it the best checkpoint) is the same in a resumed run.
            val_loader.set_epoch(epoch)
            evaluate = eval_55 if is_55 else eval_pcn
            val_cd = evaluate(cfg, model, val_loader, logger, epoch)
            improved = ckpts.maybe_save(state, epoch, val_cd)
            logging.info("Epoch %d val CD=%.4f best=%.4f%s", epoch, val_cd, ckpts.best_metric,
                         " *" if improved else "")
            if max_steps is not None and global_step >= max_steps:
                break
        logger.close()
    return state, ckpts.best_metric


def load_weights_into_state(state: TrainState, cfg) -> TrainState:
    """``cfg.weights`` (a checkpoint of this port) loaded into ``state``; no-op
    without weights."""
    if cfg.weights:
        state, _, _ = restore_checkpoint(cfg.weights, state)
    return state


def test_net(cfg, mode: Optional[str] = None, device: Optional[str] = None) -> float:
    """Evaluation of ``cfg.weights`` on the test split: the per-category
    table (PCN: CD-L1×10³ / DCD / F1; ShapeNet-55: CD-L2×10³ / DCD / F1 over
    the 8 corners at crop difficulty ``mode``, default ``cfg.data.mode``);
    returns the mean CD. ``cfg.train.precision`` "bf16" evaluates in bf16
    mode."""
    check_supported(cfg)
    device = resolve_device(device)
    set_seed(cfg.seed)
    with mixed_precision(cfg.train.precision == "bf16"):
        model = build_model(cfg, device=device, seed=cfg.seed)
        state = load_weights_into_state(init_state(cfg, model), cfg)
        loader = Loader(make_dataset(cfg, "test", seed=cfg.seed), cfg.train.batch_size,
                        shuffle=False, num_workers=cfg.data.num_workers)
        if cfg.data.name == "ShapeNet55":
            return eval_55(cfg, state.model, loader, mode=mode)
        return eval_pcn(cfg, state.model, loader)

