#!/usr/bin/env python3
"""Drive the PyTorch port's PCN, ShapeNet-55, GeoSpecNet, PointSea and KITTI
paths on one CUDA card: evaluation, the train steps in f32 and in bf16 mode,
the adversarial 55 step, GeoSpecNet's GAN step, the ``main_pcn`` /
``main_55`` / ``main_geospec`` / ``main_pointsea`` / ``main_kitti`` entry
points, ``--complete``, the EMD auction and PointNet++'s modules.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
1. build the hand-written kernels from ``svdformer_pointsea_tpu_torch/csrc``
   (one nvcc per source, in parallel);
2. hold each f32 kernel against its plain PyTorch version on the card: K1
   and K2 at every training (B = 12) and evaluation (B = 8) site with their
   launch plans, bit for bit and on a repeat, K1 on duplicated targets across
   tile and split boundaries under 1-8 splits, K2 at B = 40, on a coarse
   grid and on its quirk inputs under C = 1, 2, 4, 8; at B = 4, K3 at every
   attention site (and at dh 256) without and with its row statistics, q x 1
   and q x 8, against the naive forward in f32 and the plain forward in f64
   (O bit-equal with and without statistics and on a repeat); at every
   training attention site K5 (dQ) and K4 (dK, dV) through the flash Function against
   autograd through the naive math and against their own second run (bit
   for bit: no atomics), also with q x 8 (a large spread of scores, held
   against the naive autograd in f64, whose f32 run is itself near the
   bound there); the
   split pass (``split_bf16x3``, the three bf16 planes of q, k, v and dO that
   the f32 K3, K4 and K5 take) against its plain version, bit for bit;
3. the same for the bf16 kernels at every attention site and at dh 256: bf16
   K3 without and with statistics (``flash_attn_bf16_fwd.cu``), K5 and K4
   (``flash_attn_bf16_bwd.cu``; all TMA / wgmma kernels) against their bf16
   plain versions (|Δ| ≤ 1e-2 · max|ref|, LSE 1e-5 relative), O bit-equal
   with and without statistics and on a repeat, a second bf16 backward
   bit-equal, and an f16 input refused; all of them also on large-spread
   cases (q × 8: the running max moves between key tiles); ``-Xptxas -v`` of
   both bf16 sources (no spill in any K3, K4 or K5 instance at dh 64, 96,
   128; the dynamic shared memory from each launcher's export) and their
   SASS (``HGMMA``, ``UTMALDG``); the same reports for the f32 K3, K4 and K5
   on the split planes (``flash_attn_split_fwd.cu``, ``flash_attn_split_bwd.cu``);
   ptxas of K1 and K2 (no spill in any instance) and their SASS (no FFMA, which
   would round otherwise than the plain versions; K2's REDUX, mbarrier and
   cluster-barrier instructions);
4. evaluation main path: ``eval_pcn`` on a full-width PCN SVDFormer (random
   weights from a seeded generator) over 3 synthetic batches of 8, with the
   launch counters zeroed just before and read just after; every kernel of
   the path must have launched. The same batches run under
   ``reference_ops()`` (plain versions only); per-sample CD-L1×10³ must agree
   within 0.01, and a repeat of each batch must give the same bits (the
   port's scatters add in a fixed order, ``ops/scatter.py``);
5. train main path, f32: two full-width models from ``build_model`` (seed 0)
   take one ``make_train_step`` step on one synthetic batch of 12 (3 pad
   rows), one with the kernels (counters zeroed before, read after: K1, K2,
   K3 with statistics, K4 and K5 must all have launched, the flash kernels
   12 times each and the split 48: q, k and v in each forward, dO in each
   backward) and one under
   ``reference_ops()``, both with PyTorch's deterministic algorithms; loss
   and parts must agree within 1e-4 relative and Adam's first moment per
   parameter within 1e-3 relative (L2; parameters whose exact gradient is 0
   hold noise below 1e-6). Then 5 more steps at the schedule's LR: finite
   losses, moved BN running statistics;
6. train main path, bf16 mode (``set_mixed_precision``): the same step with
   kernels and under ``reference_ops()`` (the bf16 plain versions); per step
   exactly 12 launches each of the bf16 K3 with statistics, K4 and K5, no f32
   flash launch, K1 8 and K2 6; loss, parts and first moments within the
   bf16 bounds below;
7. the entry point: a synthetic PCN tree in the dataset's layout and sizes
   (complete clouds of 16,384 points, 8 partial scans of 1,536-2,559 points
   per training model) in a temporary directory that becomes the working
   directory, so ``pcn_config()``'s paths resolve; ``main_pcn(["--precision",
   "bf16", "--epochs", "2", ...])`` trains 3 batches of 12 an epoch,
   validates and writes ``ckpt-best.pt``; the checkpoint reloads;
   ``main_pcn(["--test", "--weights", ckpt, ...])`` in bf16 and in f32; per
   sample CD-L1×10³ of the test set with kernels vs ``reference_ops()`` within
   0.01 in both modes;
8. timing (CUDA events, kernels and plain ops in turns): eval completions/s
   at B = 8 and train ms/step and peak memory at B = 12, in f32 and in bf16
   mode; each kernel against its plain version and its bound (per training
   batch of 12, and K3 per evaluation batch of 8; K1 and K2 per site, with
   their plans, device times (CUDA graphs) and floors, K2 in µs a round; the
   attention kernels
   beside ``scaled_dot_product_attention`` forward / backward as a
   yardstick: f32 on its memory-efficient backend, bf16 on its flash
   backend; the bf16 K3, K4 and K5 with their TFLOP/s, the floor their
   exponentials set, their device times from CUDA graphs beside SDPA's, and
   for the backward the di pass's, so that di + K5 + K4 stands beside SDPA's
   one flash backward call; the f32 K3, K4 and K5 with their shares of the
   split-rate bound and of the FP32 pipes', the f32 K3's device time beside
   SDPA's memory-efficient forward per training and per evaluation batch, and
   di + split + K5 + K4 beside SDPA's memory-efficient backward in device
   time); a profiler breakdown of both train steps and of an evaluation
   batch in f32 and in bf16 mode by kernel family (device kernels only, no
   user annotation);
9. the ShapeNet-55 track at full width (``shapenet55_config()``: batch 16,
   gt 8192, the attention decoder): K1 and K2 at every 55 site and on the
   crop's masked 8192-point blocks bit for bit; one f32 and one bf16 55
   train step (crop, render, forward, ``get_loss_pm``, AdamW) and one
   adversarial step with the kernels and under ``reference_ops()``, with
   exact launch counts and the PCN bounds; ``eval_55`` over the 8 corners
   (per sample and corner |ΔCD-L2×10³| <= 0.01, default algorithms, repeats
   bit-equal); ``main_55 --epochs 1`` on a synthetic ShapeNet-55 tree, then
   ``--test`` in f32 and bf16; the 55 train ms/step, eval completions/s and
   K1 / K2 per site;
10. GeoSpecNet at full width (``geospec_config()``: the spectral point
   encoder, SDG decoders, PointDiscriminator, PCN sizes): one f32 and one
   bf16 GAN step (render, one generator forward, D's step on gt and the
   detached P2, then the generator's step on ``get_loss_pm`` + 0.05 BCE
   through the updated D) with the kernels and under ``reference_ops()``
   from one state, deterministic algorithms: exact launch counts, every loss
   within the PCN bounds, G's and D's first moments too; one eval batch of 8
   under the default algorithms (|ΔCD-L1×10³| <= 0.01, exact launches,
   repeat bit-equal); ``main_geospec --epochs 1`` on a synthetic PCN tree,
   then ``--test``; GAN ms/step at B 12 in f32 and bf16 (kernels and plain
   in turns), peak memory, a profile of the f32 GAN step, eval completions/s;
11. PointSea at full width (``pointsea_config()``: PCN data and sizes, the
   realistic voxel renderer, ResNet-18 on 224² renders, two-stage view
   fusion, the path-selection SDGs): ``PCViewsReal`` on the card against
   itself on the CPU at B 12 (grid bit for bit, images within 1e-6);
   ``eval_pcn`` over 2 batches of 8 with exact launches, then each batch
   with the kernels and under ``reference_ops()`` in f32 and in bf16 mode
   (per-sample |ΔCD-L1×10³| <= 0.01, default algorithms, repeats
   bit-equal); one f32 and one bf16 train step with the kernels and under
   ``reference_ops()`` from one state, deterministic algorithms: exact
   launches, losses and first moments within the PCN bounds (PointSea's own
   zero-gradient list), then 5 more steps (finite, running statistics
   moved); ``main_pointsea --epochs 1`` on a synthetic PCN tree, then
   ``--test`` in f32 and bf16; train ms/step in f32 and bf16 at B 12, eval
   completions/s at B 8, the render and the trunk alone, peak memory, and a
   profile of the f32 step;
12. the remaining surfaces: K2 on KITTI's zero-padded partials (60-511 valid
   points of 2048, fewer than the picks) under C = 1, 2, 4, 8 and K1 with
   zero-padded queries, bit for bit; ``main_kitti`` in f32 and bf16 on a
   ``write_kitti_tree`` tree of 36 scans with a full-width PCN checkpoint
   from a seed (exact launches, one PCD a scan, per-sample fidelity kernels
   vs ``reference_ops()``, repeats bit-equal); ``main_pcn --complete`` on
   10 scans of 300-5000 points (exact launches, the completions mapped back
   into each scan's frame against the plain versions'); the EMD auction on
   the card against the CPU (train point bit for bit on quantized inputs,
   a permuted copy at the evaluation point); PointNet++ at its published
   widths card against CPU; KITTI completions/s and the ``--complete``
   forward in f32 and bf16, the EMD's ms a call.

Prints the card's name and power limit, a ``{"kernels": [...]}`` JSON line, and
as its last line ``{"ok": true, "device": {...}}``. Exits non-zero without a
result when no CUDA device is visible or the repository is missing.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, List

import numpy as np

REPO = Path(__file__).resolve().parent
SEED = 0
B_MAIN = 8
B_TRAIN = 12  # pcn_config().train.batch_size: the call shapes of the kernel timings
CD_GATE = 0.01  # |ΔCD-L1×10³| per sample (docs/PARITY.md)
NN_TOL = 1e-6
FLASH_TOL = 2e-5
FLASH_BWD_TOL = 2e-4  # atol and rtol of tests/test_flash_vjp.py
LOSS_RTOL = 1e-4  # the kernels' f32 sum order
MU_RTOL = 1e-3
MU_ATOL = 1e-9
NOISE_MU = 1e-6  # first moment of a parameter whose exact gradient is 0
BF16_REL = 1e-2  # |Δ| / max|ref| of a bf16 kernel output vs its plain version
LSE_RTOL = 1e-5  # the log-sum-exp stays f32
# bf16 train step, kernels vs reference_ops() (the bf16 plain versions), as
# predicted in PERF.md before the first run of this phase. The image trunk's
# parameters are held apart: it computes in bf16, so each of their gradients
# is a bf16-rounded sum over ~1.8 M bf16 terms that mostly cancel, and a
# one-ulp change anywhere upstream moves it (the atomics of the render alone
# move its worst leaf by 0.31).
BF16_LOSS_RTOL = 1e-4
BF16_MU_RTOL = 5e-2
BF16_TRUNK = "encoder.img_trunk."
BF16_TRUNK_MU_RTOL = 0.5
# The bf16 K3 on a large spread: q scaled by 8, so that the running max moves
# between key tiles and the accumulator's rescale is exercised.
SPREAD = 8.0
SPREAD_SITES = [(512, 512, 96), (2048, 2048, 64), (2048, 2048, 128), (2048, 2048, 256)]
# MUFU: 16 exponentials a clock per SM, 132 SMs (H100 SXM).
EXP_PER_CLOCK = 16 * 132
# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, bf16 dense
# on the tensor cores, HBM3.
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
HBM_BYTES_S = 3.35e12

# (Lq, Lk, dh) of every attention site the PCN SVDFormer sends to the flash
# kernels, in call order: SDG1 (512 tokens, hidden 768) then SDG2 (2048 tokens,
# hidden 512). The evaluation path and the train step share them.
FLASH_SITES = [
    (512, 512, 96), (512, 512, 96), (512, 512, 64), (512, 512, 96), (512, 512, 96), (512, 512, 64),
    (2048, 2048, 64), (2048, 2048, 64), (2048, 2048, 128), (2048, 512, 64), (2048, 2048, 64),
    (2048, 2048, 128),
]
# (N, M) of every NN search per evaluation batch: SDG1, SDG2, then both
# directions of calc_cd and of calc_dcd at 16384 points; per train step: SDG1,
# SDG2, then both directions of the loss pyramid's three chamfers.
NN_SITES = [(512, 2048), (2048, 2048)] + [(16384, 16384)] * 4
NN_TRAIN_SITES = [(512, 2048), (2048, 2048), (256, 256), (256, 256), (2048, 2048), (2048, 2048),
                  (16384, 16384), (16384, 16384)]
# (N, npoint) of every FPS per evaluation batch: SA1, SA2, LocalEncoder, merge;
# per train step also the loss pyramid's ground truths.
FPS_SITES = [(2048, 512), (512, 128), (2048, 512), (2304, 512)]
FPS_TRAIN_SITES = FPS_SITES + [(16384, 2048), (2048, 256)]
# The evaluation path splits q, k and v for each f32 K3.
EVAL_KERNELS = ("nn_distance", "fps", "flash_attn", "split_bf16x3")
TRAIN_KERNELS = ("nn_distance", "fps", "flash_attn_stats", "flash_attn_bwd_dkv",
                 "flash_attn_bwd_dq", "split_bf16x3")
# Flash launches of one f32 train step: 12 attention sites, each forward
# splitting q, k and v (the planes are saved for the backward) and each
# backward dO.
F32_STEP_FLASH = {"flash_attn_stats": 12, "flash_attn_bwd_dq": 12, "flash_attn_bwd_dkv": 12,
                  "split_bf16x3": 48}
BF16_KERNELS = ("flash_attn_bf16", "flash_attn_stats_bf16", "flash_attn_bwd_dkv_bf16",
                "flash_attn_bwd_dq_bf16")
# Launches of one bf16-mode train step: every training attention site on the
# bf16 kernels, none on the f32 ones; K1 and K2 as in f32.
BF16_STEP_LAUNCHES = {"nn_distance": 8, "fps": 6, "flash_attn": 0, "flash_attn_stats": 0,
                      "flash_attn_bwd_dkv": 0, "flash_attn_bwd_dq": 0, "split_bf16x3": 0,
                      "flash_attn_bf16": 0,
                      "flash_attn_stats_bf16": 12, "flash_attn_bwd_dkv_bf16": 12,
                      "flash_attn_bwd_dq_bf16": 12}
# The synthetic PCN tree of the entry-point phase: 3 batches of 12 an epoch.
TREE_MODELS = {"train": 36, "val": 16, "test": 16}

# The ShapeNet-55 track (shapenet55_config(): batch 16, gt 8192, partial
# 2048, step 2 / 4, merge and local 1024, the attention decoder).
B_55 = 16
CD_GATE_55 = 0.01  # |ΔCD-L2×10³| per sample and corner: the metric gate on the 55 metric
# (Lq, Lk, dh) of the flash sites of the 55 SVDFormer in call order: SDG1
# (1024 tokens, hidden 768: sa1, cross1 against the 1024 local features) and
# SDG2 (2048 tokens, hidden 512: sa1, decoder1, cross1, decoder2). SDG1's
# decoders (dh 32) take the naive math, as in the JAX package.
FLASH_SITES_55 = [(1024, 1024, 96), (1024, 1024, 96), (2048, 2048, 64), (2048, 2048, 64),
                  (2048, 1024, 64), (2048, 2048, 64)]
ATTN_SITES = sorted(set(FLASH_SITES) | set(FLASH_SITES_55))
# (N, M) of K1 per 55 train step: SDG1, SDG2, both directions of the loss
# pyramid's three chamfers, the partial-matching term; per eval corner: SDG1,
# SDG2 and both directions of calc_cd and calc_dcd.
NN_TRAIN_SITES_55 = [(1024, 2048), (2048, 2048), (256, 256), (256, 256), (2048, 2048),
                     (2048, 2048), (8192, 8192), (8192, 8192), (2048, 8192)]
NN_EVAL_SITES_55 = [(1024, 2048), (2048, 2048)] + [(8192, 8192)] * 4
# (N, npoint) of K2 per 55 train step: the crop's masked block, SA1, SA2, the
# LocalEncoder, the merge, the loss pyramid's ground truths; per eval corner
# the crop's kept points (6144 easy, 4096 median; hard keeps 2048 and takes
# no FPS) and the model's four.
FPS_TRAIN_SITES_55 = [(8192, 2048), (2048, 512), (512, 128), (2048, 1024), (2304, 1024),
                      (8192, 2048), (2048, 256)]
FPS_EVAL_SITES_55 = {"easy": (6144, 2048), "median": (4096, 2048)}
FPS_MODEL_SITES_55 = [(2048, 512), (512, 128), (2048, 1024), (2304, 1024)]
# Launches of one 55 train step: f32 (6 flash sites, the split of q, k, v in
# each forward and of dO in each backward) and bf16 mode.
F32_STEP_55 = {"nn_distance": 9, "fps": 7, "flash_attn": 0, "flash_attn_stats": 6,
               "flash_attn_bwd_dkv": 6, "flash_attn_bwd_dq": 6, "split_bf16x3": 24,
               "flash_attn_bf16": 0, "flash_attn_stats_bf16": 0, "flash_attn_bwd_dkv_bf16": 0,
               "flash_attn_bwd_dq_bf16": 0}
BF16_STEP_55 = dict(F32_STEP_55, flash_attn_stats=0, flash_attn_bwd_dkv=0, flash_attn_bwd_dq=0,
                    split_bf16x3=0, flash_attn_stats_bf16=6, flash_attn_bwd_dkv_bf16=6,
                    flash_attn_bwd_dq_bf16=6)
# The synthetic ShapeNet-55 tree of main_55: 2 batches of 16 an epoch, 1 test batch.
TREE_MODELS_55 = {"train": 32, "test": 16}
# GeoSpecNet (geospec_config(): PCN data and sizes, the spectral point
# encoder, SDG decoders, PointDiscriminator). Launches of one GAN step: the
# generator's forward as SVDFormer's (K1 in SDG1 and SDG2, K2 at SA1, SA2,
# the LocalEncoder and the merge, the 12 flash sites), get_loss_pm's pyramid
# (K1 both ways at 256², 2048², 16384², one way 2048 -> 16384; K2 16384 ->
# 2048 -> 256); the discriminator and the spectral adapters' kNN (torch.topk
# over 128 points) launch none.
GEO_STEP = dict(F32_STEP_55, nn_distance=9, fps=6, flash_attn_stats=12, flash_attn_bwd_dkv=12,
                flash_attn_bwd_dq=12, split_bf16x3=48)
GEO_BF16_STEP = dict(BF16_STEP_LAUNCHES, nn_distance=9)
# One GeoSpecNet eval batch of 8: K1 in SDG1, SDG2 and both ways of calc_cd
# and calc_dcd, K2 4, K3 12 with the split of q, k, v.
GEO_EVAL = {name: 0 for name in F32_STEP_55}
GEO_EVAL.update(nn_distance=6, fps=4, flash_attn=12, split_bf16x3=36)
# The synthetic PCN tree of main_geospec: 1 batch of 12 an epoch.
TREE_MODELS_GEO = {"train": 12, "val": 8, "test": 8}
# PointSea (pointsea_config(): PCN data and sizes). Its flash sites are 6 at
# (512, 512, 96) in SDG1 and 5 at (2048, 2048, 64) and 1 at (2048, 512, 64) in
# SDG2; its view attentions (49 and 3 tokens) and seed attention (128) take
# the naive math. A train step: K1 in both SDGs and the loss pyramid (8), K2
# at SA1, SA2, the local encoder, the merge and the loss's ground truths (6);
# an eval batch: K1 in both SDGs, calc_cd and calc_dcd (6), K2 4.
PS_STEP = dict(GEO_STEP, nn_distance=8)
PS_BF16_STEP = dict(BF16_STEP_LAUNCHES)
PS_EVAL = dict(GEO_EVAL)
PS_BF16_EVAL = dict(GEO_EVAL, flash_attn=0, split_bf16x3=0, flash_attn_bf16=12)
# The synthetic PCN tree of main_pointsea: 1 batch of 12 an epoch.
TREE_MODELS_PS = {"train": 12, "val": 8, "test": 8}
IMG_TOL = 1e-6  # the realistic renders on the card vs the CPU (the Gaussian's sum order)
# The remaining surfaces. KITTI: a full-width PCN SVDFormer evaluated zero-shot
# on synthetic car scans, three batches of 12; per batch K1 3 (SDG1, SDG2, the
# fidelity's NN search), K2 4, K3 12 and the split 36 (bf16: the bf16 K3 12).
KITTI_SCANS = 36
KITTI_EVAL = dict(GEO_EVAL, nn_distance=3)
KITTI_BF16_EVAL = dict(KITTI_EVAL, flash_attn=0, split_bf16x3=0, flash_attn_bf16=12)
FIDELITY_GATE = 0.01  # |Δfidelity×10³| per sample: the metric gate (a mean distance, as CD-L1)
# --complete: 10 scans of 300-5000 points in one batch of 10: K1 2 (SDG1, SDG2),
# K2 4, K3 12, split 36; completions held to the CPU tests' 2e-3 (PCN frame).
COMPLETE_SCANS = 10
COMPLETE_LAUNCHES = dict(KITTI_EVAL, nn_distance=2)
COMPLETE_ATOL = 2e-3
# KITTI's zero-padded partials at K2 (valid points of 2048; SA1 picks 512, SA2
# 128 of them) and at K1 (the fidelity's queries).
KITTI_VALID = (60, 137, 300, 511)
# The EMD auction: the train point at B 8 x 2048 on coordinates quantized to
# 2^-6 (exact distances: card and CPU bit-equal), a permuted copy at the
# evaluation point at B 2 x 8192.
EMD_TRAIN = (0.005, 50)
EMD_EVAL = (0.002, 10000)
# PointNet++ at its published widths (Qi et al., NeurIPS 2017), B 8 x 2048:
# the SSG classification stack, the MSG first layer, two FP modules back to
# 2048 points, the vanilla PointNet extractor. K2 once a sampling SA / MSG.
PN2_RTOL = 1e-5  # card vs CPU, relative to the output's largest entry
PN2_LAUNCHES = {"fps": 3}
SOURCES = {  # kernel -> (source in the repo, the TPU kernel it replaces)
    "nn_distance": ("svdformer_pointsea_tpu_torch/csrc/nn_distance.cu",
                    "svdformer_pointsea_tpu/ops/nn_pallas.py:59"),
    "fps": ("svdformer_pointsea_tpu_torch/csrc/fps.cu", "svdformer_pointsea_tpu/ops/fps.py:68"),
    "flash_attn": ("svdformer_pointsea_tpu_torch/csrc/flash_attn_split_fwd.cu",
                   "svdformer_pointsea_tpu/nn/flash_vjp.py:153"),
    "flash_attn_stats": ("svdformer_pointsea_tpu_torch/csrc/flash_attn_split_fwd.cu",
                         "svdformer_pointsea_tpu/nn/flash_vjp.py:160"),
    "flash_attn_bwd_dkv": ("svdformer_pointsea_tpu_torch/csrc/flash_attn_split_bwd.cu",
                           "svdformer_pointsea_tpu/nn/flash_vjp.py:171"),
    "flash_attn_bwd_dq": ("svdformer_pointsea_tpu_torch/csrc/flash_attn_split_bwd.cu",
                          "svdformer_pointsea_tpu/nn/flash_vjp.py:49"),
    # Part of the f32 K3 / K4 / K5 port: the planes of q, k, v and dO.
    "split_bf16x3": ("svdformer_pointsea_tpu_torch/csrc/flash_attn_split_bwd.cu",
                     "svdformer_pointsea_tpu/nn/flash_vjp.py:166"),
    "flash_attn_bf16": ("svdformer_pointsea_tpu_torch/csrc/flash_attn_bf16_fwd.cu",
                        "svdformer_pointsea_tpu/nn/flash_vjp.py:153"),
    "flash_attn_stats_bf16": ("svdformer_pointsea_tpu_torch/csrc/flash_attn_bf16_fwd.cu",
                              "svdformer_pointsea_tpu/nn/flash_vjp.py:160"),
    "flash_attn_bwd_dkv_bf16": ("svdformer_pointsea_tpu_torch/csrc/flash_attn_bf16_bwd.cu",
                                "svdformer_pointsea_tpu/nn/flash_vjp.py:171"),
    "flash_attn_bwd_dq_bf16": ("svdformer_pointsea_tpu_torch/csrc/flash_attn_bf16_bwd.cu",
                               "svdformer_pointsea_tpu/nn/flash_vjp.py:49"),
}
# The TMA / wgmma sources: ptxas and SASS reports; per kernel, its label and
# the C export that returns the dynamic shared memory its launcher requests
# at a head dim.
WGMMA_SOURCES = ("flash_attn_bf16_fwd", "flash_attn_bf16_bwd", "flash_attn_split_fwd",
                 "flash_attn_split_bwd")
POINT_SOURCES = ("nn_distance", "fps")  # K1 and K2: CUDA-core kernels, bit-equal to plain
SMEM_EXPORTS = {
    "wgmma_fwd_kernel": ("bf16", "flash_attn_bf16_fwd", "flash_attn_bf16_fwd_smem"),
    "bwd_dq_kernel": ("bf16", "flash_attn_bf16_bwd", "flash_attn_bf16_bwd_dq_smem"),
    "bwd_dkv_kernel": ("bf16", "flash_attn_bf16_bwd", "flash_attn_bf16_bwd_dkv_smem"),
    "split_fwd_kernel": ("f32 split", "flash_attn_split_fwd", "flash_attn_split_fwd_smem"),
    "split_bwd_dq_kernel": ("f32 split", "flash_attn_split_bwd", "flash_attn_split_bwd_dq_smem"),
    "split_bwd_dkv_kernel": ("f32 split", "flash_attn_split_bwd", "flash_attn_split_bwd_dkv_smem"),
}
# Device-kernel name patterns of the train step's profile, first match wins.
PROFILE_FAMILIES = [
    ("K3 flash forward (f32, split)", r"split_fwd_kernel"),
    ("K4 flash dK/dV (f32, split)", r"split_bwd_dkv_kernel"),
    ("K5 flash dQ (f32, split)", r"split_bwd_dq_kernel"),
    ("split pass (f32 backward)", r"split_bf16x3_kernel"),
    ("K3 bf16 flash forward", r"fwd_kernel"),  # the f32 names matched first
    ("K4 bf16 flash dK/dV", r"bwd_dkv_kernel"),
    ("K5 bf16 flash dQ", r"bwd_dq_kernel"),
    ("K1 NN distance", r"nn_one_way_kernel"),
    ("K2 FPS", r"fps_kernel"),
    ("max-pools (PointSea's render and trunk)", r"max_pool"),
    ("Adam (foreach)", r"multi_tensor|adam"),
    ("gather / scatter / index", r"index|scatter|gather"),
    ("reductions / norms / softmax", r"reduce|norm|softmax|topk|sort|radix"),
    ("elementwise", r"elementwise"),
    ("convolutions (cuDNN)", r"conv|cudnn|dgrad|wgrad|fprop|winograd|implicit"),
    ("GEMMs (cuBLAS / CUTLASS)", r"gemm|cutlass|xmma|splitk"),
]


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn: Callable[[], object], iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn: Callable[[], object], reps: int = 10, replays: int = 5) -> float:
    """Device time (ms) of one ``fn()``: ``reps`` calls captured in a CUDA
    graph and replayed, so that no host time between launches enters it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up outside the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


# The f32 K3, K4 and K5 run on the bf16 tensor cores, six products of split
# parts for each product of the f32 function.
SPLIT_FLOPS = BF16_FLOPS / 6
SPLIT_KERNELS = ("flash_attn", "flash_attn_stats", "flash_attn_bwd_dq", "flash_attn_bwd_dkv")


def peak_flops(name: str) -> float:
    if name in SPLIT_KERNELS:
        return SPLIT_FLOPS
    return BF16_FLOPS if name.endswith("_bf16") else F32_FLOPS


def bound_ms(ops: float, nbytes: float, flops: float = F32_FLOPS) -> float:
    """Least time (ms) for ``ops`` operations at ``flops`` per second and
    ``nbytes`` of device memory traffic on an H100 SXM."""
    return 1e3 * max(ops / flops, nbytes / HBM_BYTES_S)


_ATTN_FLOPS = {"flash_attn": 4, "flash_attn_stats": 4, "flash_attn_bwd_dq": 6,
               "flash_attn_bwd_dkv": 8}


def attention_work(b: int, h: int, lq: int, lk: int, dh: int, kernel: str):
    """(operations, bytes) of one attention kernel call: 4 (K3), 6 (K5) or 8
    (K4) x B h Lq Lk dh flops; each operand read once, each output written
    once, at 4 bytes a value (f32) or 2 (the bf16 kernels' q, k, v, o, do, dq,
    dk, dv; lse and di stay f32). The f32 K4 and K5 are counted on their f32
    operands: the bytes of the split pass that makes their bf16 planes are
    counted on its own row (``split_work``)."""
    base = kernel[:-len("_bf16")] if kernel.endswith("_bf16") else kernel
    elem = 2 if base != kernel else 4
    qd, kd, rows = b * h * lq * dh, b * h * lk * dh, b * h * lq
    mats, vecs = {"flash_attn": (2 * qd + 2 * kd, 0),            # q, k, v -> o
                  "flash_attn_stats": (2 * qd + 2 * kd, rows),   # ... and lse
                  "flash_attn_bwd_dq": (3 * qd + 2 * kd, 2 * rows),   # q, do, k, v, lse, di -> dq
                  "flash_attn_bwd_dkv": (2 * qd + 4 * kd, 2 * rows)}[base]  # ... -> dk, dv
    return _ATTN_FLOPS[base] * b * h * lq * lk * dh, elem * mats + 4 * vecs


def split_work(n: int):
    """(operations, bytes) of one split of n f32 values: 4 subtractions and 3
    roundings a value (the bound is the bytes), 4 read and 6 written."""
    return 7 * n, 10 * n


@dataclass
class Batch:
    data: Dict[str, np.ndarray]
    taxonomy_ids: List[str]
    valid: int


def synthetic_batches(rng: np.random.RandomState, n_batches: int = 3, bs: int = B_MAIN,
                      n_partial: int = 2048) -> List[Batch]:
    """Ellipsoid surfaces (gt, 16384 points) and a one-sided crop of each
    (partial, ``n_partial`` points); two taxonomies; the last batch has 3 pad rows."""
    batches = []
    for bi in range(n_batches):
        gts, partials = [], []
        for _ in range(bs):
            axes = rng.uniform(0.2, 0.45, size=3)
            v = rng.randn(4 * 16384, 3)
            v /= np.linalg.norm(v, axis=1, keepdims=True)
            pts = (v * axes).astype(np.float32)
            gts.append(pts[:16384])
            cut = pts[pts @ rng.randn(3) > 0]
            partials.append(cut[rng.choice(len(cut), n_partial, replace=len(cut) < n_partial)])
        valid = bs if bi < n_batches - 1 else bs - 3
        batches.append(Batch(
            data={"partial_cloud": np.stack(partials), "gtcloud": np.stack(gts)},
            taxonomy_ids=["02691156" if i % 2 == 0 else "03001627" for i in range(bs)],
            valid=valid,
        ))
    return batches


def first_moment_gap(torch, run, ref, check: bool, rtol: float = MU_RTOL, apart=None,
                     family: str = "svdformer"):
    """Worst relative L2 gap of Adam's first moment per parameter between two
    runs of one step, the largest |mu| among zero-gradient parameters (by
    the list of the model ``family``), and the worst gap among the
    parameters named by ``apart`` = (prefix, rtol), held to their own bound;
    with ``check``, fails beyond the bounds (``rtol``, NOISE_MU)."""
    from svdformer_pointsea_tpu_torch.nn import has_zero_gradient

    (model, state, _), (model_r, state_r, _) = run, ref
    worst, worst_noise, worst_apart = (0.0, ""), (0.0, ""), (0.0, "")
    params_r = dict(model_r.named_parameters())
    for name, p in model.named_parameters():
        mu = state.optimizer.state[p]["exp_avg"]
        mu_r = state_r.optimizer.state[params_r[name]]["exp_avg"]
        if has_zero_gradient(name, family):
            noise = max(mu.abs().max().item(), mu_r.abs().max().item())
            worst_noise = max(worst_noise, (noise, name))
            if check and not noise <= NOISE_MU:
                fail(f"first moment of {name} (exact gradient 0) is {noise}")
            continue
        diff, norm = torch.linalg.norm(mu - mu_r).item(), torch.linalg.norm(mu_r).item()
        gap = (diff / max(norm, 1e-30), name)
        bound = rtol
        if apart is not None and name.startswith(apart[0]):
            worst_apart, bound = max(worst_apart, gap), apart[1]
        else:
            worst = max(worst, gap)
        if check and not diff <= bound * norm + MU_ATOL:
            fail(f"Adam first moment of {name}: ‖Δ‖ {diff} vs ‖ref‖ {norm}")
    return worst, worst_noise, worst_apart


def nn_phase(torch, ops, kernels, g) -> float:
    """K1 against its plain version at every training site (B 12) and every
    evaluation site (B 8): d and idx bit-equal, a repeat bit-equal, and the
    distance at the chosen index within NN_TOL; then duplicated targets on
    either side of a 256-point tile and of every split boundary, under the
    plan's split and under 1, 2, 4 and 8 splits. Returns the max abs error."""
    dev = torch.device("cuda")
    sm = kernels.sm_count(dev)
    worst = 0.0
    for bs, sites in ((B_TRAIN, NN_TRAIN_SITES), (B_MAIN, NN_SITES)):
        for n, m in sorted(set(sites)):
            a = torch.rand(bs, n, 3, device=dev, generator=g) - 0.5
            b = torch.rand(bs, m, 3, device=dev, generator=g) - 0.5
            d, i = ops.nn_one_way(a, b)
            d2, i2 = ops.nn_one_way(a, b)
            torch.cuda.synchronize()
            dp, ip = ops.nn_one_way_plain(a, b)
            chosen = b.gather(1, i.long()[..., None].expand(-1, -1, 3))
            d_at_idx = ((a - chosen) ** 2).sum(-1)
            e = max((d - dp).abs().max().item(), (d_at_idx - dp).abs().max().item())
            equal = torch.equal(d, dp) and torch.equal(i, ip)
            repeat = torch.equal(d, d2) and torch.equal(i, i2)
            print(f"K1 nn_distance B{bs} {n}->{m}, plan {tuple(ops.nn_launch_plan(bs, n, m, sm))}: "
                  f"max|Δd| {e:.3e} (argmin checked by distance); d and idx bit-equal to the plain "
                  f"version {equal}, on a repeat {repeat}")
            if not (e <= NN_TOL and equal and repeat):
                fail(f"nn_distance B{bs} {n}->{m} differs from its plain version or its repeat")
            worst = max(worst, e)
    for bs, n, m in ((B_TRAIN, 256, 256), (B_TRAIN, 2048, 2048), (B_MAIN, 512, 2048)):
        a = torch.rand(bs, n, 3, device=dev, generator=g) - 0.5
        b = torch.rand(bs, m, 3, device=dev, generator=g) - 0.5
        cuts = {256} | {k * -(-m // s) for s in (2, 4, 8) for k in range(1, s)}
        cuts = sorted(j for j in cuts if 0 < j < m)
        for k, j in enumerate(cuts):
            b[:, j] = b[:, j - 1]
            a[:, 2 * k] = b[:, j - 1]  # distance 0 to both
            a[:, 2 * k + 1] = b[:, j - 1] + 1e-4  # the same distance to both
        dp, ip = ops.nn_one_way_plain(a, b)
        same = []
        for splits in (None, 1, 2, 4, 8):
            plan = ops.nn_launch_plan(bs, n, m, sm, splits=splits)
            d, i = ops.distances._nn_one_way_kernel(a, b, plan)
            same.append(torch.equal(d, dp) and torch.equal(i, ip))
        print(f"K1 tie B{bs} {n}->{m}: targets duplicated across {len(cuts)} tile and split "
              f"boundaries; d and idx bit-equal to the plain version under the plan's split and "
              f"under 1, 2, 4, 8 splits: {same}")
        if not all(same):
            fail(f"nn_distance ties at B{bs} {n}->{m} resolve otherwise than the plain version")
    return worst


def fps_phase(torch, ops, kernels, g) -> float:
    """K2 against its plain version at every training site (B 12, 16384 ->
    2048 included) and every evaluation site (B 8), with a repeat; at B 40
    (more clusters than the card holds at once); on the quirk case (points
    near the origin never picked, an all-invalid row, duplicated points, a
    coarse grid of many equal distances) under C = 1, 2, 4, 8; and on a
    coarse grid at (16384, 2048), B 12. Returns the max index difference."""
    dev = torch.device("cuda")
    sm = kernels.sm_count(dev)
    quirk = torch.rand(4, 2048, 3, device=dev, generator=g) + 0.5
    quirk[0, 10:400] = 0.0  # near-origin points are never picked
    quirk[0, 400:410] = 0.01
    quirk[1] = 0.0  # all-invalid row: every pick falls back to 0
    quirk[2, 1000:] = quirk[2, :1048].clone()  # duplicated points: ties
    quirk[3] = torch.round(quirk[3] * 4) / 4  # a coarse grid: many equal distances
    grid = torch.round((torch.rand(B_TRAIN, 16384, 3, device=dev, generator=g) - 0.5) * 8) / 8
    cases = []
    for bs, sites in ((B_TRAIN, FPS_TRAIN_SITES), (B_MAIN, FPS_SITES)):
        for n, m in sorted(set(sites)):
            cases.append((f"B{bs} {n}->{m}", torch.rand(bs, n, 3, device=dev, generator=g) - 0.5, m,
                          None))
    wave = torch.rand(40, 16384, 3, device=dev, generator=g) - 0.5
    cases += [("B40 16384->512", wave, 512, None), ("B40 16384->512, C 8", wave, 512, 8),
              ("grid B12 16384->2048", grid, 2048, None)]
    cases += [(f"quirks B4 2048->512, C {c}", quirk, 512, c) for c in (1, 2, 4, 8)]
    worst = 0.0
    for name, x, m, cluster in cases:
        plan = ops.fps_launch_plan(x.shape[0], x.shape[1], m, sm, cluster=cluster)
        i = ops.fps._fps_kernel(x, m, plan)
        again = ops.fps._fps_kernel(x, m, plan)
        torch.cuda.synchronize()
        ip = ops.furthest_point_sample_ref(x, m)
        bad = int((i != ip).sum().item())
        repeat = torch.equal(i, again)
        print(f"K2 fps {name}, plan {tuple(plan)}: {bad} index mismatches; repeat bit-equal {repeat}")
        if bad or not repeat:
            fail(f"fps {name}: {bad} indices differ from the plain version, repeat {repeat}")
        worst = max(worst, float((i - ip).abs().max().item()))
        if name.startswith("quirks"):
            if bool((i[0, 1:, None] == torch.arange(10, 410, device=dev)).any()) or bool(i[1].any()):
                fail("fps quirk semantics (origin skip / all-invalid fallback) broken")
    picked = ops.furthest_point_sample(quirk, 512)
    if not torch.equal(picked, ops.furthest_point_sample_ref(quirk, 512)):
        fail("fps through its wrapper differs on the quirk case")
    return worst


def kernel_phase(torch, ops, flash, g) -> Dict[str, float]:
    """Kernel vs plain version: K1 and K2 at the training and evaluation
    shapes (``nn_phase``, ``fps_phase``), the f32 flash kernels at B = 4.
    Returns the max abs error per kernel."""
    from svdformer_pointsea_tpu_torch import kernels

    dev = "cuda"
    err = {"nn_distance": nn_phase(torch, ops, kernels, g), "fps": fps_phase(torch, ops, kernels, g)}

    # K3 without and with statistics (the split of q, k and v included) at
    # every site and at dh 256 with q x 1, at every site with q x SPREAD: O
    # and LSE against the naive forward in f32 and the plain forward in f64,
    # both within FLASH_TOL at q x 1, the f64 one with q x SPREAD (where the
    # f32 naive math is itself about FLASH_TOL from the f64 truth: its own
    # distance is printed beside); O bit-equal with and without statistics
    # and on a repeat.
    err["flash_attn"] = err["flash_attn_stats"] = 0.0
    k3_cases = ([(1.0, site) for site in ATTN_SITES + [(512, 512, 256),
                                                                     (2048, 2048, 256)]]
                + [(SPREAD, site) for site in ATTN_SITES])
    for spread, (lq, lk, dh) in k3_cases:
        q, k, v = (torch.randn(4, n_, 8, dh, device=dev, generator=g) for n_ in (lq, lk, lk))
        q = q * spread
        o = flash.flash_attention(q, k, v)
        o_s, lse = flash._flash_kernel(q, k, v, stats=True)
        o_rep, lse_rep = flash._flash_kernel(q, k, v, stats=True)
        torch.cuda.synchronize()
        if not (torch.equal(o, o_s) and torch.equal(o, o_rep) and torch.equal(lse, lse_rep)):
            fail(f"K3 at ({lq}, {lk}, {dh}) x {spread:g}: O with and without statistics, or a "
                 "repeat, differs")
        o_n, (_, lse_p) = flash.naive_attention(q, k, v), flash.attention_fwd_plain(q, k, v)
        o64, lse64 = flash.attention_fwd_plain(q.double(), k.double(), v.double())
        e_o, e_l = (o - o_n).abs().max().item(), (lse - lse_p).abs().max().item()
        e64 = [(o.double() - o64).abs().max().item(), (lse.double() - lse64).abs().max().item()]
        own64 = [(o_n.double() - o64).abs().max().item(), (lse_p.double() - lse64).abs().max().item()]
        print(f"K3 flash_attn / flash_attn_stats (q x {spread:g}) Lq {lq} Lk {lk} dh {dh}: O, lse "
              f"max|Δ| vs f32 naive {e_o:.3e}, {e_l:.3e}; vs f64 {e64[0]:.3e}, {e64[1]:.3e} (f32 "
              f"naive vs f64 {own64[0]:.3e}, {own64[1]:.3e}); bit-equal without statistics and on "
              "a repeat")
        gated = max(e64) if spread != 1.0 else max(e_o, e_l, *e64)
        if not gated <= FLASH_TOL:
            fail(f"K3 at ({lq}, {lk}, {dh}) x {spread:g} outside {FLASH_TOL}: {gated}")
        if spread == 1.0:
            err["flash_attn"] = max(err["flash_attn"], e_o)
            err["flash_attn_stats"] = max(err["flash_attn_stats"], e_o, e_l)
        del o, o_s, o_rep, o_n, o64

    # Training: K3 with statistics, then the split and K5 / K4 through the
    # Function's backward; each site also with q x SPREAD, where the backward
    # is held to the same bound (K3's O and lse are printed there, not gated)
    # against the naive autograd in f64: with the large spread the naive f32
    # math itself uses much of the bound at |dk| ~ 10, so it is no yardstick
    # there; its own excess over the f64 truth is printed beside the kernels'.
    for name in ("flash_attn_bwd_dq", "flash_attn_bwd_dkv", "split_bf16x3"):
        err[name] = 0.0
    for spread in (1.0, SPREAD):
        for lq, lk, dh in ATTN_SITES:
            q, k, v, do = (torch.randn(4, n_, 8, dh, device=dev, generator=g)
                           for n_ in (lq, lk, lk, lq))
            q = q * spread
            for x in (q, do):
                planes = flash.split_bf16x3(x)
                torch.cuda.synchronize()
                bad = int((planes.view(torch.int16)
                           != flash.split_bf16x3_plain(x).view(torch.int16)).sum().item())
                if bad:
                    fail(f"split_bf16x3 at ({lq}, {lk}, {dh}) x {spread:g}: {bad} parts differ")
            o, lse = flash._flash_kernel(q, k, v, stats=True)
            torch.cuda.synchronize()
            o_p, lse_p = flash.attention_fwd_plain(q, k, v)
            e3 = max((o - o_p).abs().max().item(), (lse - lse_p).abs().max().item())
            ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
            got = torch.autograd.grad(flash.flash_attention_train(*ins), ins, do)
            again = torch.autograd.grad(flash.flash_attention_train(*ins), ins, do)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail(f"K4 / K5 at ({lq}, {lk}, {dh}) x {spread:g} gave two answers for one input")
            ref_dtype = torch.float32 if spread == 1.0 else torch.float64
            ref_ins = [x.to(ref_dtype).requires_grad_(True) for x in (q, k, v)]
            want = torch.autograd.grad(flash.naive_attention(*ref_ins), ref_ins, do.to(ref_dtype))
            label = "" if spread == 1.0 else f" (q x {spread:g}, naive in f64)"
            line = (f"K3+stats/K5/K4{label} Lq {lq} Lk {lk} dh {dh}: O, lse max|Δ| {e3:.3e}; split "
                    "bit-equal")
            if spread != 1.0:
                f32_ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
                f32_naive = torch.autograd.grad(flash.naive_attention(*f32_ins), f32_ins, do)
                line += "; f32 naive's own excess " + ", ".join(
                    f"{((a - b).abs() - FLASH_BWD_TOL * b.abs()).max().item():.2e}"
                    for a, b in zip(f32_naive, want))
                del f32_ins, f32_naive
            if spread == 1.0:
                if not e3 <= FLASH_TOL:
                    fail(f"flash_attn_stats ({lq}, {lk}, {dh}) differs by {e3}")
                err["flash_attn_stats"] = max(err["flash_attn_stats"], e3)
            for gname, kname, a, b in (("dq", "flash_attn_bwd_dq", got[0], want[0]),
                                       ("dk", "flash_attn_bwd_dkv", got[1], want[1]),
                                       ("dv", "flash_attn_bwd_dkv", got[2], want[2])):
                e = (a - b).abs().max().item()
                excess = ((a - b).abs() - FLASH_BWD_TOL * b.abs()).max().item()
                line += f"; {gname} max|Δ| {e:.3e} (excess {excess:.2e})"
                if not excess <= FLASH_BWD_TOL:
                    fail(f"{gname} at ({lq}, {lk}, {dh}) x {spread:g} outside atol/rtol "
                         f"{FLASH_BWD_TOL}: {excess}")
                err[kname] = max(err[kname], e)
            print(line)
            del ins, ref_ins, got, again, want
    return err


def ptxas_report_start(kernels, tmp: str):
    """Start ``nvcc -Xptxas -v`` on the wgmma flash sources and on K1's and
    K2's (compile only) in the background; ``ptxas_report_print`` and
    ``points_report`` read them."""
    procs = {}
    for src in WGMMA_SOURCES + POINT_SOURCES:
        cmd = [kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-Xptxas", "-v", "-c", "-o", os.path.join(tmp, f"{src}.o"),
               str(kernels.CSRC / f"{src}.cu")]
        procs[src] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
    return procs


def ptxas_report_print(kernels, procs) -> None:
    """Registers and spills per wgmma kernel instance (the bf16 K3, K5, K4;
    the f32 K5, K4 on split planes), and the dynamic shared memory its
    launcher requests, read from the built library's export
    (``SMEM_EXPORTS``). Fails if an instance spills at dh 64, 96 or 128;
    prints ptxas's performance warnings."""
    import ctypes

    pattern = "|".join(sorted(SMEM_EXPORTS, key=len, reverse=True))  # the longest name first
    for src in WGMMA_SOURCES:
        proc = procs[src]
        out, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            fail(f"nvcc -Xptxas -v failed for {src}.cu:\n{out}")
        name = None
        for line in out.splitlines():
            m = re.search(rf"({pattern})ILi(\d+)E", line)
            if "C75" in line:  # e.g. wgmma serialised, setmaxnreg ignored
                print(f"ptxas warning ({src}.cu): " + re.sub(r"'_Z\S+'", "", line.strip()))
            if m and "Compiling entry" in line:
                name = (m.group(1), int(m.group(2)))
            elif name and "spill" in line:
                spills = line.strip()
                spilled = re.search(r"(\d+) bytes spill stores", line).group(1) != "0"
            elif name and "Used" in line and "registers" in line:
                regs = re.search(r"Used (\d+) registers", line).group(1)
                kind, dh = name
                label, lib, export = SMEM_EXPORTS[kind]
                smem_fn = getattr(kernels._libs[lib], export)
                smem_fn.argtypes, smem_fn.restype = [ctypes.c_int], ctypes.c_int
                if spilled and dh != 256:
                    fail(f"the {label} {kind} spills at dh {dh}: {spills}")
                print(f"ptxas {label} {kind} dh {dh}: {regs} registers, {spills}; dynamic shared "
                      f"memory {smem_fn(dh) / 1000:.1f} KB")
                name = None


def sass_report(kernels) -> None:
    """Counts of the Hopper instructions in the SASS of each wgmma library:
    HGMMA (wgmma), UTMALDG / UTMASTG (TMA load / store), MUFU.EX2; fails if
    either library lacks the first two. Prints "not available" without
    cuobjdump."""
    import shutil

    tool = Path(kernels._nvcc()).parent / "cuobjdump"
    tool = str(tool) if tool.exists() else shutil.which("cuobjdump")
    for src in WGMMA_SOURCES:
        if tool is None:
            print(f"SASS of {src}.cu: not available (no cuobjdump)")
            continue
        sass = subprocess.run([tool, "-sass", str(kernels._lib_path(src))],
                              capture_output=True, text=True).stdout
        counts = {op: len(re.findall(rf"\b{re.escape(op)}\b", sass))
                  for op in ("HGMMA", "UTMALDG", "UTMASTG", "MUFU.EX2")}
        print(f"SASS of {src}.cu (4 instances a kernel): "
              + ", ".join(f"{op} {n}" for op, n in counts.items()))
        if not (counts["HGMMA"] and counts["UTMALDG"]):
            fail(f"the SASS of {src}.cu holds no HGMMA or no UTMALDG")


def points_report(kernels, procs) -> None:
    """ptxas's registers and spills for every instance of K1 and K2, and the
    SASS of both libraries: fails on a spill, or on an FFMA (a contracted
    multiply-add would round otherwise than the plain versions); prints K2's
    REDUX (warp reductions), SYNCS (mbarrier) and cluster-barrier
    instructions."""
    import shutil

    for src in POINT_SOURCES:
        out, _ = procs[src].communicate(timeout=600)
        if procs[src].returncode != 0:
            fail(f"nvcc -Xptxas -v failed for {src}.cu:\n{out}")
        name, lines = None, []
        for line in out.splitlines():
            m = re.search(r"(fps_kernel|nn_one_way_kernel)I(\w+?)EEv", line)
            if m and "Compiling entry" in line:
                args = re.findall(r"L([bi])(\d+)E", m.group(2) + "E")
                name = f"{m.group(1)}<{', '.join(v if t == 'i' else ('true', 'false')[v == '0'] for t, v in args)}>"
            elif name and "spill" in line:
                spills = re.search(r"(\d+) bytes spill stores", line).group(1)
            elif name and "Used" in line and "registers" in line:
                regs = re.search(r"Used (\d+) registers", line).group(1)
                lines.append(f"{name} {regs}")
                if spills != "0":
                    fail(f"{src}.cu: {name} spills ({line.strip()})")
                name = None
        print(f"ptxas {src}.cu, registers per instance, no spill: " + "; ".join(lines))
    tool = Path(kernels._nvcc()).parent / "cuobjdump"
    tool = str(tool) if tool.exists() else shutil.which("cuobjdump")
    if tool is None:
        fail("no cuobjdump: the FFMA count of K1 and K2 cannot be read")
    for src in POINT_SOURCES:
        sass = subprocess.run([tool, "-sass", str(kernels._lib_path(src))], capture_output=True,
                              text=True, check=True).stdout
        counts = {op: len(re.findall(rf"\b{op}\b", sass))
                  for op in ("FFMA", "FADD", "FMUL", "REDUX", "SYNCS")}
        barriers = {op: len(re.findall(rf"\b{op}\b", sass))
                    for op in sorted(set(re.findall(r"\b(\w*CGA\w*)\b", sass)))}
        text = ", ".join(f"{op} {n}" for op, n in counts.items())
        if src == "fps":
            text += ", cluster barrier " + ", ".join(f"{op} {n}" for op, n in barriers.items())
        print(f"SASS of {src}.cu: {text}")
        if counts["FFMA"]:
            fail(f"the SASS of {src}.cu holds {counts['FFMA']} FFMA: a contraction breaks bit equality")
        if src == "fps" and not (counts["REDUX"] and counts["SYNCS"] and barriers):
            fail("the SASS of fps.cu holds no REDUX, no mbarrier (SYNCS) or no cluster barrier")


def rel_err(got, want) -> float:
    """|Δ| / max|ref| in f32."""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def bf16_kernel_phase(torch, kernels, flash, g) -> Dict[str, float]:
    """The bf16 K3 (without and with statistics), K5 and K4 against their
    bf16 plain versions at every attention site, at dh 256 and on the
    large-spread sites (q x SPREAD), B = 4: O, dq, dk, dv within BF16_REL
    of max|ref|, LSE within LSE_RTOL; a second backward bit-equal; an f16
    input refused. Returns the max abs error per kernel."""
    bf = torch.bfloat16
    err = {name: 0.0 for name in BF16_KERNELS}
    for lq, lk, dh in ATTN_SITES + [(512, 512, 256), (2048, 2048, 256)]:
        q, k, v, do = (torch.randn(4, n_, 8, dh, device="cuda", generator=g).to(bf)
                       for n_ in (lq, lk, lk, lq))
        o_eval = flash.flash_attention(q, k, v)
        ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = flash.flash_attention_train(*ins)
        got = torch.autograd.grad(out, ins, do)
        again = torch.autograd.grad(flash.flash_attention_train(*ins), ins, do)
        o, lse = flash._flash_kernel(q, k, v, stats=True)
        o_rep, lse_rep = flash._flash_kernel(q, k, v, stats=True)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"bf16 K4 / K5 at ({lq}, {lk}, {dh}) gave two answers for one input")
        if not (torch.equal(o, out) and torch.equal(o, o_eval)):
            fail(f"bf16 K3 with and without statistics differ at ({lq}, {lk}, {dh})")
        if not (torch.equal(o, o_rep) and torch.equal(lse, lse_rep)):
            fail(f"bf16 K3 gave two answers for one input at ({lq}, {lk}, {dh})")
        o_p, lse_p = flash.attention_fwd_plain_bf16(q, k, v)
        di = flash.attention_di(o, do)
        dk_p, dv_p = flash.attention_bwd_dkv_plain_bf16(q, k, v, lse, do, di)
        dq_p = flash.attention_bwd_dq_plain_bf16(q, k, v, lse, do, di)
        lse_rel = ((lse - lse_p).abs() / lse_p.abs()).max().item()
        rels = {"O": rel_err(o, o_p), "dq": rel_err(got[0], dq_p), "dk": rel_err(got[1], dk_p),
                "dv": rel_err(got[2], dv_p)}
        print(f"bf16 K3/K3+stats/K5/K4 Lq {lq} Lk {lk} dh {dh}: |Δ|/max|ref| "
              + ", ".join(f"{n} {e:.3e}" for n, e in rels.items()) + f"; lse rel {lse_rel:.3e}")
        if not (max(rels.values()) <= BF16_REL and lse_rel <= LSE_RTOL):
            fail(f"bf16 flash kernels at ({lq}, {lk}, {dh}) outside their tolerance")
        abs_o = (o.float() - o_p.float()).abs().max().item()
        err["flash_attn_bf16"] = max(err["flash_attn_bf16"], abs_o)
        err["flash_attn_stats_bf16"] = max(err["flash_attn_stats_bf16"], abs_o,
                                           (lse - lse_p).abs().max().item())
        err["flash_attn_bwd_dq_bf16"] = max(err["flash_attn_bwd_dq_bf16"],
                                            (got[0].float() - dq_p.float()).abs().max().item())
        err["flash_attn_bwd_dkv_bf16"] = max(
            err["flash_attn_bwd_dkv_bf16"], (got[1].float() - dk_p.float()).abs().max().item(),
            (got[2].float() - dv_p.float()).abs().max().item())
        del ins, got, again, o_p, dk_p, dv_p, dq_p
    for lq, lk, dh in SPREAD_SITES:
        q, k, v, do = (torch.randn(4, n_, 8, dh, device="cuda", generator=g).to(bf)
                       for n_ in (lq, lk, lk, lq))
        q = (q.float() * SPREAD).to(bf)
        o, lse = flash._flash_kernel(q, k, v, stats=True)
        o_eval = flash._flash_kernel(q, k, v)
        di = flash.attention_di(o, do)
        got = flash._bwd_kernels(q, k, v, lse, do, di)
        torch.cuda.synchronize()
        o_p, lse_p = flash.attention_fwd_plain_bf16(q, k, v)
        dk_p, dv_p = flash.attention_bwd_dkv_plain_bf16(q, k, v, lse, do, di)
        dq_p = flash.attention_bwd_dq_plain_bf16(q, k, v, lse, do, di)
        rels = {"O": rel_err(o, o_p), "dq": rel_err(got[0], dq_p), "dk": rel_err(got[1], dk_p),
                "dv": rel_err(got[2], dv_p)}
        lse_rel = ((lse - lse_p).abs() / lse_p.abs()).max().item()
        print(f"bf16 K3+stats/K5/K4 large spread (q x {SPREAD:g}) Lq {lq} Lk {lk} dh {dh}: "
              "|Δ|/max|ref| " + ", ".join(f"{n} {e:.3e}" for n, e in rels.items())
              + f"; lse rel {lse_rel:.3e}; O without statistics bit-equal {torch.equal(o, o_eval)}")
        if not (max(rels.values()) <= BF16_REL and lse_rel <= LSE_RTOL and torch.equal(o, o_eval)):
            fail(f"bf16 flash kernels on the large spread at ({lq}, {lk}, {dh}) outside their "
                 "tolerance")
        abs_o = (o.float() - o_p.float()).abs().max().item()
        err["flash_attn_bf16"] = max(err["flash_attn_bf16"], abs_o)
        err["flash_attn_stats_bf16"] = max(err["flash_attn_stats_bf16"], abs_o,
                                           (lse - lse_p).abs().max().item())
        err["flash_attn_bwd_dq_bf16"] = max(err["flash_attn_bwd_dq_bf16"],
                                            (got[0].float() - dq_p.float()).abs().max().item())
        err["flash_attn_bwd_dkv_bf16"] = max(
            err["flash_attn_bwd_dkv_bf16"], (got[1].float() - dk_p.float()).abs().max().item(),
            (got[2].float() - dv_p.float()).abs().max().item())
        del got, o_p, dk_p, dv_p, dq_p
    before = dict(kernels.launches)
    try:
        flash.flash_attention_train(*(x.half().requires_grad_(True) for x in (q, k, v)))
    except ValueError as e:
        print(f"f16 into the flash Function refused: {e}")
    else:
        fail("an f16 CUDA input to the flash Function did not raise")
    if kernels.launches != before:
        fail("a refused f16 input launched a kernel")
    return err


def eval_phase(torch, kernels, cfg, model, batches):
    """eval_pcn with kernels (the counted main path) and under reference_ops()."""
    from svdformer_pointsea_tpu_torch.render import make_renderer
    from svdformer_pointsea_tpu_torch.train.evaluate import eval_pcn, make_pcn_eval_fn

    kernels.reset_launches()
    mean_cd = eval_pcn(cfg, model, batches)
    launches = dict(kernels.launches)
    print(f"eval main path launches: {launches}")
    for name in EVAL_KERNELS:
        if launches[name] == 0:
            fail(f"kernel {name} was not launched on the evaluation path")
    if any(launches[name] for name in kernels.KERNEL_NAMES if name not in EVAL_KERNELS):
        fail("the evaluation path launched a training kernel")
    with kernels.reference_ops():
        mean_cd_ref = eval_pcn(cfg, model, batches)
    if kernels.launches != launches:
        fail("a kernel launched under reference_ops()")
    print(f"mean CD-L1×10³: kernels {mean_cd:.6f}, plain {mean_cd_ref:.6f}")

    eval_fn = make_pcn_eval_fn(model, make_renderer(cfg))
    worst, repeats = 0.0, []
    for batch in batches:
        partial = torch.as_tensor(batch.data["partial_cloud"], device="cuda")
        gt = torch.as_tensor(batch.data["gtcloud"], device="cuda")
        m_k = eval_fn(partial, gt)[:, :batch.valid].cpu()
        repeats.append(torch.equal(eval_fn(partial, gt)[:, :batch.valid].cpu(), m_k))
        with kernels.reference_ops():
            m_r = eval_fn(partial, gt)[:, :batch.valid].cpu()
        if not (torch.isfinite(m_k).all() and torch.isfinite(m_r).all()):
            fail("non-finite CD / DCD / F1")
        worst = max(worst, (m_k[0] - m_r[0]).abs().max().item())
    print(f"per-sample |ΔCD-L1×10³| kernels vs plain (default algorithms): max {worst:.3e} (gate "
          f"{CD_GATE}); repeat of each batch bit-equal {repeats}")
    if not worst <= CD_GATE:
        fail(f"CD-L1×10³ differs by {worst} between kernels and plain ops")
    if not all(repeats):
        fail("a repeat of the PCN evaluation gave other bits")

    partial = torch.as_tensor(batches[0].data["partial_cloud"], device="cuda")
    render = make_renderer(cfg)
    with torch.inference_mode():
        depth = render.get_img(partial)
        outs = model(partial, depth)
        with kernels.reference_ops():
            outs_ref = model(partial, depth)
    for name, o, o_ref, n in zip(("coarse", "fine1", "fine2"), outs, outs_ref, (256, 2048, 16384)):
        if o.shape != (B_MAIN, n, 3) or not torch.isfinite(o).all():
            fail(f"{name}: shape {tuple(o.shape)} or non-finite values")
        print(f"{name} {tuple(o.shape)}: max|Δ| kernels vs plain {(o - o_ref).abs().max().item():.3e}")
    return launches, eval_fn


def train_phase(torch, kernels, cfg, batch):
    """One train step with kernels (the counted main path) and one under
    reference_ops() from the same initial state, then 5 more kernel steps.
    Returns the launches of the first and its metrics."""
    from svdformer_pointsea_tpu_torch.nn.layers import BatchNorm
    from svdformer_pointsea_tpu_torch.render import make_renderer
    from svdformer_pointsea_tpu_torch.train import (build_model, init_state, make_lr_fn,
                                                    make_train_step)

    partial = torch.as_tensor(batch.data["partial_cloud"], device="cuda")
    gt = torch.as_tensor(batch.data["gtcloud"], device="cuda")
    weights = torch.zeros(partial.shape[0], device="cuda")
    weights[:batch.valid] = 1.0
    render = make_renderer(cfg)
    lr_fn = make_lr_fn(cfg)
    runs = {}
    for mode in ("kernels", "plain", "kernels, atomics"):
        model = build_model(cfg, seed=SEED)  # on the card: its default device
        state = init_state(cfg, model)
        step = make_train_step(model, state.optimizer, cfg.train.sqrt_loss, render.get_img)
        runs[mode] = (model, state, step)
    print(f"train: PCN SVDFormer on {next(runs['kernels'][0].parameters()).device}, "
          f"B {partial.shape[0]} ({batch.valid} rows of weight 1), partial {partial.shape[1]}, "
          f"gt {gt.shape[1]}")

    # Both steps run with PyTorch's deterministic algorithms (cuDNN's backward
    # convolutions and the image trunk's max-pool backward add with atomics
    # otherwise; the port's own scatters add in a fixed order either way), so
    # that the kernels' sum order is the only difference between them: with
    # atomics, two kernel runs alone can differ by more than the bound in a
    # first-moment leaf (the run-to-run noise printed below).
    torch.use_deterministic_algorithms(True, warn_only=True)
    lr = lr_fn(1, 0)  # lr_fn(global_step + 1, epoch - 1) at step 0 of epoch 1
    model_k, state_k, step_k = runs["kernels"]
    kernels.reset_launches()
    state_k, m_k = step_k(state_k, partial, gt, weights, lr)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    print(f"train main path launches (one step): {launches}")
    for name in TRAIN_KERNELS:
        if launches[name] == 0:
            fail(f"kernel {name} was not launched on the train step")
    if any(launches[name] != n for name, n in F32_STEP_FLASH.items()):
        fail(f"train step flash launches {launches}, expected {F32_STEP_FLASH}")
    model_r, state_r, step_r = runs["plain"]
    with kernels.reference_ops():
        state_r, m_r = step_r(state_r, partial, gt, weights, lr)
    torch.cuda.synchronize()
    torch.use_deterministic_algorithms(False)
    if kernels.launches != launches:
        fail("a kernel launched under reference_ops()")

    for key in ("loss", "cdc", "cd1", "cd2"):
        a, b = m_k[key].item(), m_r[key].item()
        rel = abs(a - b) / abs(b)
        print(f"train step 1 {key}: kernels {a:.8f}, plain {b:.8f}, rel |Δ| {rel:.3e}")
        if not (math.isfinite(a) and rel <= LOSS_RTOL):
            fail(f"train {key} differs: {a} vs {b}")
    worst, worst_noise, _ = first_moment_gap(torch, runs["kernels"], runs["plain"], check=True)
    print(f"Adam first moment kernels vs plain: worst leaf {worst[1]} rel ‖Δ‖ {worst[0]:.3e} "
          f"(bound {MU_RTOL}); zero-gradient leaves max |mu| {worst_noise[0]:.3e} "
          f"({worst_noise[1]})")
    model_a, state_a, step_a = runs["kernels, atomics"]
    step_a(state_a, partial, gt, weights, lr)
    noise, _, _ = first_moment_gap(torch, runs["kernels, atomics"], runs["kernels"], check=False)
    print(f"run-to-run noise with atomics (kernels vs kernels, default algorithms): worst leaf "
          f"{noise[1]} rel ‖Δ‖ {noise[0]:.3e}")
    del runs, model_r, state_r, step_r, model_a, state_a, step_a

    bns = [m for m in model_k.modules() if isinstance(m, BatchNorm)]
    before = [(m.running_mean.clone(), m.running_var.clone()) for m in bns]
    losses = []
    for _ in range(5):
        lr = lr_fn(state_k.step + 1, 0)
        state_k, m = step_k(state_k, partial, gt, weights, lr)
        losses.append(m["loss"].item())
    print(f"train steps 2-6 at lr {lr_fn(2, 0):.3e}..{lr:.3e}: losses {losses}")
    if not all(math.isfinite(x) for x in losses):
        fail("non-finite training loss")
    still = sum(torch.equal(m.running_mean, a) or torch.equal(m.running_var, b)
                for m, (a, b) in zip(bns, before))
    if still:
        fail(f"{still} of {len(bns)} BatchNorms kept their running statistics")
    print(f"BN running statistics moved in all {len(bns)} BatchNorms; step count {state_k.step}")
    return launches, m_k


def bf16_train_phase(torch, kernels, cfg, batch):
    """The train step in bf16 mode: one step with kernels (the counted main
    path; exactly BF16_STEP_LAUNCHES) and one under reference_ops() (the
    bf16 plain versions) from the same initial state, both under PyTorch's
    deterministic algorithms; then 2 more kernel steps. Returns the launches
    of the first and its metrics."""
    from svdformer_pointsea_tpu_torch.nn import mixed_precision
    from svdformer_pointsea_tpu_torch.render import make_renderer
    from svdformer_pointsea_tpu_torch.train import (build_model, init_state, make_lr_fn,
                                                    make_train_step)

    partial = torch.as_tensor(batch.data["partial_cloud"], device="cuda")
    gt = torch.as_tensor(batch.data["gtcloud"], device="cuda")
    weights = torch.zeros(partial.shape[0], device="cuda")
    weights[:batch.valid] = 1.0
    render = make_renderer(cfg)
    lr = make_lr_fn(cfg)(1, 0)
    runs = {}
    for mode in ("kernels", "plain", "kernels, atomics"):
        model = build_model(cfg, seed=SEED)
        state = init_state(cfg, model)
        runs[mode] = (model, state, make_train_step(model, state.optimizer, cfg.train.sqrt_loss,
                                                    render.get_img))
    with mixed_precision(True):
        torch.use_deterministic_algorithms(True, warn_only=True)
        model_k, state_k, step_k = runs["kernels"]
        kernels.reset_launches()
        state_k, m_k = step_k(state_k, partial, gt, weights, lr)
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        model_r, state_r, step_r = runs["plain"]
        with kernels.reference_ops():
            state_r, m_r = step_r(state_r, partial, gt, weights, lr)
        torch.cuda.synchronize()
        torch.use_deterministic_algorithms(False)
    print(f"bf16 train main path launches (one step): {launches}")
    if launches != BF16_STEP_LAUNCHES:
        fail(f"bf16 train step launches {launches}, expected {BF16_STEP_LAUNCHES}")
    if kernels.launches != launches:
        fail("a kernel launched under reference_ops()")
    for key in ("loss", "cdc", "cd1", "cd2"):
        a, b = m_k[key].item(), m_r[key].item()
        rel = abs(a - b) / abs(b)
        print(f"bf16 train step 1 {key}: kernels {a:.8f}, plain {b:.8f}, rel |Δ| {rel:.3e} "
              f"(bound {BF16_LOSS_RTOL})")
        if not (math.isfinite(a) and rel <= BF16_LOSS_RTOL):
            fail(f"bf16 train {key} differs: {a} vs {b}")
    worst, worst_noise, worst_trunk = first_moment_gap(
        torch, runs["kernels"], runs["plain"], check=True, rtol=BF16_MU_RTOL,
        apart=(BF16_TRUNK, BF16_TRUNK_MU_RTOL))
    print(f"bf16 Adam first moment kernels vs plain: worst leaf {worst[1]} rel ‖Δ‖ "
          f"{worst[0]:.3e} (bound {BF16_MU_RTOL}); bf16 image trunk worst leaf {worst_trunk[1]} "
          f"{worst_trunk[0]:.3e} (bound {BF16_TRUNK_MU_RTOL}); zero-gradient leaves max |mu| "
          f"{worst_noise[0]:.3e} ({worst_noise[1]}, bound {NOISE_MU})")
    model_a, state_a, step_a = runs["kernels, atomics"]
    with mixed_precision(True):
        step_a(state_a, partial, gt, weights, lr)
    noise, _, noise_trunk = first_moment_gap(torch, runs["kernels, atomics"], runs["kernels"],
                                             check=False, apart=(BF16_TRUNK, math.inf))
    print(f"bf16 run-to-run noise with atomics (kernels vs kernels, default algorithms): worst "
          f"leaf {noise[1]} rel ‖Δ‖ {noise[0]:.3e}; image trunk {noise_trunk[1]} "
          f"{noise_trunk[0]:.3e}")
    del runs, model_r, state_r, step_r, model_a, state_a, step_a
    losses = []
    with mixed_precision(True):
        for _ in range(2):
            state_k, m = step_k(state_k, partial, gt, weights, lr)
            losses.append(m["loss"].item())
    print(f"bf16 train steps 2-3: losses {losses}")
    if not all(math.isfinite(x) for x in losses):
        fail("non-finite bf16 training loss")
    return launches, m_k


def entry_point_phase(torch, kernels) -> Dict[str, Dict[str, int]]:
    """main_pcn on a synthetic PCN tree: --precision bf16 training for 2
    epochs, then --test in bf16 and in f32 from the best checkpoint, and the
    per-sample test CD with kernels vs reference_ops() in both modes."""
    from svdformer_pointsea_tpu_torch.cli import main_pcn
    from svdformer_pointsea_tpu_torch.configs import pcn_config
    from svdformer_pointsea_tpu_torch.data import Loader, make_dataset
    from svdformer_pointsea_tpu_torch.data.synthetic import write_pcn_tree
    from svdformer_pointsea_tpu_torch.nn import mixed_precision
    from svdformer_pointsea_tpu_torch.render import make_renderer
    from svdformer_pointsea_tpu_torch.train import (build_model, init_state, restore_checkpoint)
    from svdformer_pointsea_tpu_torch.train.evaluate import make_pcn_eval_fn

    launches = {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        write_pcn_tree(root, np.random.RandomState(SEED + 2), TREE_MODELS)
        print(f"main_pcn: synthetic PCN tree {TREE_MODELS}, 8 scans per training model, "
              f"written in {time.perf_counter() - t0:.1f} s")
        os.chdir(root)
        try:
            out = os.path.join(root, "out")
            kernels.reset_launches()
            t0 = time.perf_counter()
            state, best = main_pcn(["--precision", "bf16", "--epochs", "2", "--out", out])
            torch.cuda.synchronize()
            launches["main_pcn train"] = dict(kernels.launches)
            print(f"main_pcn --precision bf16 --epochs 2: {state.step} steps, best val CD "
                  f"{best:.4f}, {time.perf_counter() - t0:.1f} s; launches "
                  f"{launches['main_pcn train']}")
            if state.step != 2 * (TREE_MODELS["train"] // 12):
                fail(f"main_pcn took {state.step} steps")
            for name in BF16_KERNELS:
                if launches["main_pcn train"][name] == 0:
                    fail(f"kernel {name} was not launched by main_pcn --precision bf16")
            losses = [json.loads(line) for line in open(os.path.join(out, "logs",
                                                                     "scalars.jsonl"))]
            train_losses = [r["value"] for r in losses if r["tag"] == "Train/loss"]
            if len(train_losses) != state.step or not all(map(math.isfinite, train_losses)):
                fail(f"main_pcn train losses {train_losses}")
            ckpt = os.path.join(out, "checkpoints", "ckpt-best.pt")
            cfg = pcn_config()
            fresh = init_state(cfg, build_model(cfg, seed=SEED + 5))
            loaded, epoch, best_saved = restore_checkpoint(ckpt, fresh)
            same = all(torch.equal(a, b) for a, b in zip(loaded.model.state_dict().values(),
                                                         state.model.state_dict().values()))
            print(f"checkpoint {os.path.basename(ckpt)} reloaded: epoch {epoch}, step "
                  f"{loaded.step}, best {best_saved:.4f}, equal to the trained model: {same}")
            if best_saved != best or (epoch == 2 and not same):
                fail("the best checkpoint did not reload as saved")
            del state
            results = {}
            for precision in ("bf16", "f32"):
                kernels.reset_launches()
                mean_cd = main_pcn(["--test", "--weights", ckpt, "--precision", precision])
                torch.cuda.synchronize()
                launches[f"main_pcn --test {precision}"] = dict(kernels.launches)
                results[precision] = mean_cd
                k3 = "flash_attn_bf16" if precision == "bf16" else "flash_attn"
                print(f"main_pcn --test --precision {precision}: mean CD-L1×10³ {mean_cd:.6f}; "
                      f"launches {kernels.launches}")
                if not math.isfinite(mean_cd) or kernels.launches[k3] == 0:
                    fail(f"main_pcn --test {precision}")
            # Per-sample test CD, kernels vs reference_ops(), in both modes.
            model = loaded.model.eval()
            eval_fn = make_pcn_eval_fn(model, make_renderer(cfg))
            loader = Loader(make_dataset(cfg, "test", seed=cfg.seed), cfg.train.batch_size)
            for precision in ("bf16", "f32"):
                worst = 0.0
                with mixed_precision(precision == "bf16"):
                    for batch in loader:
                        partial = torch.as_tensor(batch.data["partial_cloud"], device="cuda")
                        gt = torch.as_tensor(batch.data["gtcloud"], device="cuda")
                        m_k = eval_fn(partial, gt)[:, :batch.valid].cpu()
                        with kernels.reference_ops():
                            m_r = eval_fn(partial, gt)[:, :batch.valid].cpu()
                        if not (torch.isfinite(m_k).all() and torch.isfinite(m_r).all()):
                            fail("non-finite test metrics")
                        worst = max(worst, (m_k[0] - m_r[0]).abs().max().item())
                print(f"test set per-sample |ΔCD-L1×10³| kernels vs plain, {precision}: max "
                      f"{worst:.3e} (gate {CD_GATE})")
                if not worst <= CD_GATE:
                    fail(f"{precision} test CD differs by {worst} between kernels and plain")
            print(f"bf16 vs f32 test mean CD-L1×10³: {results['bf16']:.6f} vs "
                  f"{results['f32']:.6f} (shift {results['bf16'] - results['f32']:+.3e})")
        finally:
            os.chdir(cwd)
    return launches


def sm_clock_mhz(field: str = "clocks.max.sm") -> float:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={field}", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.strip().splitlines()[0])


def sdpa_flash_backward(torch, qt, kt, vt, dot) -> Callable[[], object]:
    """One call of SDPA's flash backward (the aten op under
    ``scaled_dot_product_attention``'s flash backend) on (B, h, L, dh)
    views, from its forward's outputs computed here once: dq, dk, dv, and its
    own rowsum(O ∘ dO) inside."""
    fwd = torch.ops.aten._scaled_dot_product_flash_attention(qt, kt, vt)
    o, lse, cum_q, cum_k, max_q, max_k, seed, offset = fwd[:8]
    bwd = torch.ops.aten._scaled_dot_product_flash_attention_backward
    return lambda: bwd(dot, qt, kt, vt, o, lse, cum_q, cum_k, max_q, max_k, 0.0, False, seed,
                       offset)


def sdpa_efficient_forward(torch, qt, kt, vt, stats: bool) -> Callable[[], object]:
    """One call of SDPA's memory-efficient forward (the aten op under
    ``scaled_dot_product_attention``'s memory-efficient backend, f32) on (B,
    h, L, dh) views: O, and with ``stats`` its row log-sum-exp, as the
    training forward computes it."""
    return lambda: torch.ops.aten._scaled_dot_product_efficient_attention(qt, kt, vt, None, stats)


def sdpa_efficient_backward(torch, qt, kt, vt, dot) -> Callable[[], object]:
    """One call of SDPA's memory-efficient backward (the aten op under
    ``scaled_dot_product_attention``'s memory-efficient backend, f32) on (B,
    h, L, dh) views, from its forward's outputs computed here once: dq, dk,
    dv, and its own rowsum(O ∘ dO) inside."""
    o, lse, seed, offset = torch.ops.aten._scaled_dot_product_efficient_attention(
        qt, kt, vt, None, True)
    bwd = torch.ops.aten._scaled_dot_product_efficient_attention_backward
    return lambda: bwd(dot, qt, kt, vt, None, o, lse, seed, offset, 0.0, [True, True, True, False])


def kernel_and_plain_ms(kernels, fn: Callable[[], object], iters: int):
    """CUDA-event ms of ``fn`` with the kernels, then with the plain versions."""
    k_ms = cuda_ms(fn, iters)
    with kernels.reference_ops():
        p_ms = cuda_ms(fn, max(1, iters // 2), warmup=1)
    return k_ms, p_ms


def time_k1_site(torch, ops, kernels, g, bs: int, n: int, m: int, sm: int, clock_hz: float,
                 label: str = ""):
    """K1 at one site: its and the plain version's time, its device time (CUDA
    graph), the FP32 issue floor (8 unfused instructions a pair at 128 a
    clock per SM; 11 with the compare and two selects of the running argmin)
    and the flop bound, printed; returns (ms, plain ms, device ms, floor,
    operations, bytes): 3 sub, 3 mul, 2 add, 1 compare a pair, the clouds
    read once, d and idx written once."""
    a = torch.rand(bs, n, 3, device="cuda", generator=g) - 0.5
    b = torch.rand(bs, m, 3, device="cuda", generator=g) - 0.5
    k_ms, p_ms = kernel_and_plain_ms(kernels, lambda: ops.nn_one_way(a, b), 10)
    dev_ms = graph_ms(lambda: ops.nn_one_way(a, b), reps=3 if n * m >= 8192 ** 2 else 10,
                      replays=3)
    floor = 1e3 * bs * n * m * 8 / (128 * sm * clock_hz)
    ops_, bytes_ = 9 * bs * n * m, 12 * bs * (n + m) + 8 * bs * n
    print(f"time{label} K1 nn_distance B{bs} {n}->{m}, plan "
          f"{tuple(ops.nn_launch_plan(bs, n, m, sm))}: {k_ms:.4f} ms, plain {p_ms:.4f} ms; "
          f"device (CUDA graph) {dev_ms:.4f} ms; FP32 issue floor {floor:.4f} ms "
          f"({100 * floor / dev_ms:.1f} %; {11 * floor / 8:.4f} ms at 11 a pair, "
          f"{1100 * floor / 8 / dev_ms:.1f} %), flop bound "
          f"{bound_ms(ops_, bytes_):.4f} ms")
    return k_ms, p_ms, dev_ms, floor, ops_, bytes_


def time_k2_site(torch, ops, kernels, g, bs: int, n: int, m: int, sm: int, clock_hz: float,
                 label: str = "", x=None):
    """K2 at one site (on ``x`` if given, else uniform points): its and the
    plain version's time, its device time (CUDA graph), µs a round and the
    floors of a round on one SM (12 B a point at 128 B a clock) and on the
    plan's C SMs (N / C points x 8 FP32 instructions at 128 a clock),
    printed; returns (ms, plain ms, device ms, floor on C SMs, operations,
    bytes): per round and point 8 for the distance, 1 min, 1 argmax compare."""
    if x is None:
        x = torch.rand(bs, n, 3, device="cuda", generator=g) - 0.5
    k_ms, p_ms = kernel_and_plain_ms(kernels, lambda: ops.furthest_point_sample(x, m),
                                     10 if n < 8192 else 4)
    dev_ms = graph_ms(lambda: ops.furthest_point_sample(x, m), reps=2 if n >= 8192 else 5,
                      replays=3)
    plan = ops.fps_launch_plan(bs, n, m, sm)
    one_sm = 1e3 * (m - 1) * n * 12 / 128 / clock_hz
    floor = 1e3 * (m - 1) * -(-n // plan.cluster) * 8 / 128 / clock_hz
    print(f"time{label} K2 fps B{bs} {n}->{m}, plan {tuple(plan)}: {k_ms:.4f} ms, plain "
          f"{p_ms:.4f} ms; device (CUDA graph) {dev_ms:.4f} ms, "
          f"{1e3 * dev_ms / (m - 1):.3f} µs a round; floors: one SM {one_sm:.4f} ms "
          f"({1e3 * one_sm / (m - 1):.3f} µs a round), the plan's C SMs {floor:.4f} ms "
          f"({1e3 * floor / (m - 1):.3f} µs a round)")
    return k_ms, p_ms, dev_ms, floor, 10 * bs * n * m, 12 * bs * n + 4 * bs * m


def print_point_sums(sums, per: str, bs: int) -> None:
    for name, r in sums.items():
        print(f"time {name} per {per} batch of {bs}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
              f"ms; device (CUDA graph) {r['device_ms']:.4f} ms, floor {r['floor_ms']:.4f} ms "
              f"({100 * r['floor_ms'] / r['device_ms']:.1f} %; K1: the FP32 issue floor at 8 a "
              "pair, K2: the plan's C SMs)")


def kernel_times(torch, ops, flash, kernels, g) -> Dict[str, Dict[str, float]]:
    """Kernel, plain and library time (ms) and bound summed over the calls one
    training batch of 12 makes (K1, K2, K3 with statistics, K4, K5, f32 and
    bf16) or one evaluation batch of 8 (K3 without statistics, the only
    kernel that runs in evaluation alone), each call shape timed on its own.
    The library yardstick is scaled_dot_product_attention on the same
    tensors: its memory-efficient backend for f32, its flash backend for
    bf16. The bf16 K3, K4 and K5 rows also sum their flops, the floor
    their exponentials set (B h Lq Lk at EXP_PER_CLOCK a clock, at the SM
    clock ``nvidia-smi`` reads as its maximum) and their device times beside
    SDPA's (``graph_ms``: where the host is slow, a call at the 512-token
    sites takes as long on the host as on the card); K4 and K5 beside SDPA's
    one flash backward call, whose device time includes its own di, so the
    di pass's device time is summed too (on the K5 row). The f32 K4 and K5
    likewise, beside SDPA's memory-efficient backward, with the split pass
    that makes their planes (its own row: bytes-bound, no library call), and
    each with its bound at the split rate and at the FP32 pipes' peak."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    dev = "cuda"
    out = {name: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0,
                  "library_ms": None} for name in kernels.KERNEL_NAMES}
    clock_mhz = sm_clock_mhz()
    for name in BF16_KERNELS:
        out[name].update(flop=0.0, exp_floor_ms=0.0, device_ms=0.0, library_device_ms=0.0)
    out["flash_attn_bwd_dq_bf16"]["di_device_ms"] = 0.0
    for name in SPLIT_KERNELS:
        out[name].update(flop=0.0, fp32_ms=0.0, device_ms=0.0, library_device_ms=0.0)
    for name in ("flash_attn", "flash_attn_stats"):
        out[name]["wrapper_device_ms"] = 0.0
    out["flash_attn_bwd_dq"]["di_device_ms"] = 0.0
    out["split_bf16x3"]["device_ms"] = 0.0

    def exp_floor_ms(b, lq, lk):
        return 1e3 * b * 8 * lq * lk / (EXP_PER_CLOCK * clock_mhz * 1e6)

    def k3_bf16(name, b, lq, lk, dh, k_ms, lib, sdpa_fn, q, k, v, stats):
        """Adds the bf16 K3's flops, exponential floor and device times;
        returns the text for its timing line."""
        r = out[name]
        flop = 4 * b * 8 * lq * lk * dh
        floor = exp_floor_ms(b, lq, lk)
        dev = graph_ms(lambda: flash._flash_kernel(q, k, v, stats=stats))
        with torch.no_grad():
            lib_dev = graph_ms(sdpa_fn)
        r["flop"] += flop
        r["exp_floor_ms"] += floor
        r["device_ms"] += dev
        r["library_device_ms"] += lib_dev
        return (f" [{flop / k_ms / 1e9:.1f} TFLOP/s, {k_ms / lib:.3f} x sdpa, exp floor "
                f"{floor:.4f} ms; device (CUDA graph) {dev:.4f} ms, {flop / dev / 1e9:.1f} "
                f"TFLOP/s, sdpa {lib_dev:.4f} ms, {dev / lib_dev:.3f} x sdpa]")

    def k3_f32(name, b, lq, lk, dh, k_ms, lib, q, k, v, stats):
        """Adds the f32 K3's flops, FP32-pipe bound and device times: through
        the wrapper (the split of q, k and v, then K3), K3 alone on the
        planes, and SDPA's memory-efficient forward; returns the text for its
        timing line."""
        r = out[name]
        flop = 4 * b * 8 * lq * lk * dh
        planes = [flash.split_bf16x3(x) for x in (q, k, v)]
        o = torch.empty_like(q)
        lse = torch.empty(b, 8, lq, device=dev) if stats else None
        ptrs = [x.data_ptr() for x in planes] + [o.data_ptr(), lse.data_ptr() if stats else None]
        alone = graph_ms(lambda: kernels.launch(name, q.device, *ptrs, b, 8, lq, lk, dh,
                                                1.0 / math.sqrt(dh)))
        wrapper = graph_ms(lambda: flash._flash_kernel(q, k, v, stats=stats))
        with torch.no_grad():
            lib_dev = graph_ms(sdpa_efficient_forward(torch, *(x.transpose(1, 2) for x in (q, k, v)),
                                                      stats))
        r["flop"] += flop
        r["fp32_ms"] += 1e3 * flop / F32_FLOPS
        r["device_ms"] += alone
        r["wrapper_device_ms"] += wrapper
        r["library_device_ms"] += lib_dev
        bound = bound_ms(*attention_work(b, 8, lq, lk, dh, name), SPLIT_FLOPS)
        return (f" [{k_ms / lib:.3f} x sdpa; device (CUDA graph) split + K3 {wrapper:.4f} ms, K3 "
                f"alone {alone:.4f} ms ({flop / alone / 1e9:.1f} TFLOP/s, {100 * bound / alone:.1f} "
                f"% of the split-rate bound), sdpa {lib_dev:.4f} ms, {wrapper / lib_dev:.3f} x sdpa]")

    def bwd_device(sfx, b, lq, lk, dh, k_ms, run, run_di, run_sdpa, run_split=None):
        """Adds K5's and K4's flops and device times (``k_ms``, ``run``: per
        kernel name), their exponential floors (bf16) or FP32-pipe bounds
        (f32), the di pass's, the split's (f32) and SDPA's backward's device
        times; returns the text for the timing line."""
        floor = exp_floor_ms(b, lq, lk)
        dev = {name: graph_ms(fn) for name, fn in run.items()}
        dev_di = graph_ms(run_di)
        dev_split = graph_ms(run_split) if run_split else 0.0
        with torch.no_grad():
            lib_dev = graph_ms(run_sdpa)
        text = []
        for base, label in (("flash_attn_bwd_dq", "K5"), ("flash_attn_bwd_dkv", "K4")):
            r = out[base + sfx]
            flop = _ATTN_FLOPS[base] * b * 8 * lq * lk * dh
            r["flop"] += flop
            if sfx:
                r["exp_floor_ms"] += floor
            else:
                r["fp32_ms"] += 1e3 * flop / F32_FLOPS
            r["device_ms"] += dev[base + sfx]
            r["library_device_ms"] += lib_dev
            text.append(f"{label} {flop / k_ms[base + sfx] / 1e9:.1f} TFLOP/s, device "
                        f"{dev[base + sfx]:.4f} ms ({flop / dev[base + sfx] / 1e9:.1f} TFLOP/s)")
        out["flash_attn_bwd_dq" + sfx]["di_device_ms"] += dev_di
        total = dev_di + dev_split + sum(dev.values())
        if run_split:
            out["split_bf16x3"]["device_ms"] += dev_split
            passes = f"device di pass {dev_di:.4f} ms, split {dev_split:.4f} ms, di + split + K5 + K4"
        else:
            passes = f"exp floor {floor:.4f} ms each; device di pass {dev_di:.4f} ms, di + K5 + K4"
        return (" [" + "; ".join(text) + f"; {passes} {total:.4f} ms, sdpa bwd {lib_dev:.4f} ms, "
                f"{total / lib_dev:.3f} x sdpa]")

    def add(name, k_ms, p_ms, ops, nbytes, lib_ms=None):
        r = out[name]
        r["ms"] += k_ms
        r["plain_ms"] += p_ms
        r["bound_ms"] += bound_ms(ops, nbytes, peak_flops(name))
        r["ops_ms"] += 1e3 * ops / peak_flops(name)
        r["bytes_ms"] += 1e3 * nbytes / HBM_BYTES_S
        if lib_ms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + lib_ms

    def both(fn, iters):
        return kernel_and_plain_ms(kernels, fn, iters)

    # K1 and K2: per training batch of 12 (the step's sites) for the report,
    # and per evaluation batch of 8 printed beside it; each site with its
    # launch plan, the kernel's device time (CUDA graph) and its floors. K1:
    # the FP32 issue floor, 8 unfused instructions a pair at 128 a clock per
    # SM (11 with the compare and two selects of the running argmin). K2: a
    # round's floor on one SM (12 B a point at 128 B a clock) and on the
    # plan's C SMs (N / C points x 8 FP32 instructions at 128 a clock).
    clock_hz = clock_mhz * 1e6
    sm = kernels.sm_count(torch.device(dev))
    out["nn_distance"]["device_ms"] = 0.0
    out["fps"]["device_ms"] = 0.0
    for bs, nn_sites, fps_sites, per in ((B_MAIN, NN_SITES, FPS_SITES, "eval"),
                                         (B_TRAIN, NN_TRAIN_SITES, FPS_TRAIN_SITES, "train")):
        sums = {name: {"ms": 0.0, "plain_ms": 0.0, "device_ms": 0.0, "floor_ms": 0.0}
                for name in ("nn_distance", "fps")}
        for n, m in nn_sites:
            k_ms, p_ms, dev_ms, floor, ops_, bytes_ = time_k1_site(torch, ops, kernels, g, bs, n,
                                                                   m, sm, clock_hz)
            for key, v in zip(("ms", "plain_ms", "device_ms", "floor_ms"), (k_ms, p_ms, dev_ms, floor)):
                sums["nn_distance"][key] += v
            if per == "train":
                add("nn_distance", k_ms, p_ms, ops_, bytes_)
                out["nn_distance"]["device_ms"] += dev_ms
        for n, m in fps_sites:
            k_ms, p_ms, dev_ms, floor, ops_, bytes_ = time_k2_site(torch, ops, kernels, g, bs, n,
                                                                   m, sm, clock_hz)
            for key, v in zip(("ms", "plain_ms", "device_ms", "floor_ms"), (k_ms, p_ms, dev_ms, floor)):
                sums["fps"][key] += v
            if per == "train":
                add("fps", k_ms, p_ms, ops_, bytes_)
                out["fps"]["device_ms"] += dev_ms
        print_point_sums(sums, per, bs)

    for sfx, dtype, backend in (("", torch.float32, SDPBackend.EFFICIENT_ATTENTION),
                                ("_bf16", torch.bfloat16, SDPBackend.FLASH_ATTENTION)):
        def sdpa(*a):
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(*a)

        fwd_plain = flash.attention_fwd_plain_bf16 if sfx else flash.attention_fwd_plain
        dq_plain = flash.attention_bwd_dq_plain_bf16 if sfx else flash.attention_bwd_dq_plain
        dkv_plain = flash.attention_bwd_dkv_plain_bf16 if sfx else flash.attention_bwd_dkv_plain
        for lq, lk, dh in FLASH_SITES:
            q, k, v = (torch.randn(B_MAIN, n_, 8, dh, device=dev, generator=g).to(dtype)
                       for n_ in (lq, lk, lk))
            k_ms, p_ms = both(lambda: flash.flash_attention(q, k, v), 10)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            lib = cuda_ms(lambda: sdpa(qt, kt, vt), 10)
            name = "flash_attn" + sfx
            add(name, k_ms, p_ms, *attention_work(B_MAIN, 8, lq, lk, dh, name), lib)
            extra = (k3_bf16(name, B_MAIN, lq, lk, dh, k_ms, lib, lambda: sdpa(qt, kt, vt), q, k,
                             v, False) if sfx
                     else k3_f32(name, B_MAIN, lq, lk, dh, k_ms, lib, q, k, v, False))
            print(f"time K3{sfx} ({lq}, {lk}, {dh}): {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                  f"sdpa {lib:.4f} ms{extra}")

        for lq, lk, dh in FLASH_SITES:
            q, k, v, do = (torch.randn(B_TRAIN, n_, 8, dh, device=dev, generator=g).to(dtype)
                           for n_ in (lq, lk, lk, lq))
            k3 = cuda_ms(lambda: flash._flash_kernel(q, k, v, stats=True), 5)
            p3 = cuda_ms(lambda: fwd_plain(q, k, v), 2, warmup=1)
            qt, kt, vt = (x.transpose(1, 2).requires_grad_(True) for x in (q, k, v))
            lib_f = cuda_ms(lambda: sdpa(qt, kt, vt), 5)
            o, lse = flash._flash_kernel(q, k, v, stats=True)
            di = flash.attention_di(o, do)
            ops_in = (q, k, v, do)
            if not sfx:  # the f32 K4 and K5 take the split planes; the split is timed on its own
                split_ms, split_plain = both(lambda: [flash.split_bf16x3(x) for x in (q, k, v, do)], 5)
                add("split_bf16x3", split_ms, split_plain, *split_work(sum(x.numel() for x in ops_in)))
                ops_in = [flash.split_bf16x3(x) for x in ops_in]
            ptrs = [x.data_ptr() for x in (*ops_in[:3], lse, ops_in[3], di)]
            dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
            shape = (B_TRAIN, 8, lq, lk, dh, 1.0 / math.sqrt(dh))
            run = {"flash_attn_bwd_dq" + sfx: lambda: kernels.launch(
                       "flash_attn_bwd_dq" + sfx, q.device, *ptrs, dq.data_ptr(), *shape),
                   "flash_attn_bwd_dkv" + sfx: lambda: kernels.launch(
                       "flash_attn_bwd_dkv" + sfx, q.device, *ptrs, dk.data_ptr(), dv.data_ptr(),
                       *shape)}
            bwd_ms = {name: cuda_ms(fn, 5) for name, fn in run.items()}
            k5, k4 = bwd_ms["flash_attn_bwd_dq" + sfx], bwd_ms["flash_attn_bwd_dkv" + sfx]
            p5 = cuda_ms(lambda: dq_plain(q, k, v, lse, do, di), 2, warmup=1)
            p4 = cuda_ms(lambda: dkv_plain(q, k, v, lse, do, di), 2, warmup=1)
            out_t = sdpa(qt, kt, vt)
            dot = do.transpose(1, 2)
            lib_b = cuda_ms(lambda: torch.autograd.grad(out_t, (qt, kt, vt), dot,
                                                        retain_graph=True), 5)
            for name, k_ms, p_ms, lib in (("flash_attn_stats" + sfx, k3, p3, lib_f),
                                          ("flash_attn_bwd_dq" + sfx, k5, p5, lib_b),
                                          ("flash_attn_bwd_dkv" + sfx, k4, p4, lib_b)):
                add(name, k_ms, p_ms, *attention_work(B_TRAIN, 8, lq, lk, dh, name), lib)
            extra = ""
            detached = [x.detach() for x in (qt, kt, vt)]
            if sfx:
                extra = k3_bf16("flash_attn_stats_bf16", B_TRAIN, lq, lk, dh, k3, lib_f,
                                lambda: sdpa(*detached), q, k, v, True)
                extra_bwd = bwd_device(sfx, B_TRAIN, lq, lk, dh, bwd_ms, run,
                                       lambda: flash.attention_di(o, do),
                                       sdpa_flash_backward(torch, *detached, dot))
            else:
                extra = k3_f32("flash_attn_stats", B_TRAIN, lq, lk, dh, k3, lib_f, q, k, v, True)
                extra_bwd = bwd_device(sfx, B_TRAIN, lq, lk, dh, bwd_ms, run,
                                       lambda: flash.attention_di(o, do),
                                       sdpa_efficient_backward(torch, *detached, dot),
                                       lambda: [flash.split_bf16x3(x) for x in (q, k, v, do)])
                extra_bwd += f"; split {split_ms:.4f} / plain {split_plain:.4f} ms"
            print(f"time{sfx} B{B_TRAIN} ({lq}, {lk}, {dh}): K3+stats {k3:.4f} / plain {p3:.4f} "
                  f"/ sdpa fwd {lib_f:.4f} ms{extra}; K5 {k5:.4f} / plain {p5:.4f} ms; K4 "
                  f"{k4:.4f} / plain {p4:.4f} ms; sdpa bwd (dq, dk, dv) {lib_b:.4f} ms{extra_bwd}")
            del out_t, qt, kt, vt
    print(f"SM clock {sm_clock_mhz('clocks.sm'):.0f} MHz after the timings (max {clock_mhz:.0f})")
    for name in BF16_KERNELS:
        r = out[name]
        per = f"eval batch of {B_MAIN}" if name == "flash_attn_bf16" else f"training batch of {B_TRAIN}"
        lib = "sdpa bwd" if "_bwd" in name else "sdpa"
        print(f"time {name} per {per}: {r['ms']:.4f} ms ({r['flop'] / r['ms'] / 1e9:.1f} TFLOP/s, "
              f"{100 * r['bound_ms'] / r['ms']:.1f} % of the bound {r['bound_ms']:.4f} ms; "
              f"exponential floor {r['exp_floor_ms']:.4f} ms at {clock_mhz:.0f} MHz); {lib} "
              f"{r['library_ms']:.4f} ms, ratio {r['ms'] / r['library_ms']:.3f}; device (CUDA "
              f"graph) {r['device_ms']:.4f} ms ({r['flop'] / r['device_ms'] / 1e9:.1f} TFLOP/s, "
              f"{100 * r['bound_ms'] / r['device_ms']:.1f} % of the bound), {lib} "
              f"{r['library_device_ms']:.4f} ms, ratio "
              f"{r['device_ms'] / r['library_device_ms']:.3f}")
    for name in SPLIT_KERNELS:
        r = out[name]
        per = f"eval batch of {B_MAIN}" if name == "flash_attn" else f"training batch of {B_TRAIN}"
        lib = "sdpa bwd" if "_bwd" in name else "sdpa fwd"
        print(f"time {name} (f32, split) per {per}: {r['ms']:.4f} ms "
              f"({r['flop'] / r['ms'] / 1e9:.1f} TFLOP/s, {100 * r['bound_ms'] / r['ms']:.1f} % of "
              f"the split-rate bound {r['bound_ms']:.4f} ms at {SPLIT_FLOPS / 1e12:.1f} TFLOP/s; FP32 "
              f"pipes' bound {r['fp32_ms']:.4f} ms, {100 * r['fp32_ms'] / r['ms']:.1f} %); {lib} "
              f"{r['library_ms']:.4f} ms, ratio {r['ms'] / r['library_ms']:.3f}; device (CUDA "
              f"graph) {r['device_ms']:.4f} ms ({r['flop'] / r['device_ms'] / 1e9:.1f} TFLOP/s, "
              f"{100 * r['bound_ms'] / r['device_ms']:.1f} % of the split-rate bound, "
              f"{100 * r['fp32_ms'] / r['device_ms']:.1f} % of the FP32 pipes'), {lib} "
              f"{r['library_device_ms']:.4f} ms")
    for name, per in (("flash_attn_stats", f"training batch of {B_TRAIN}, with statistics"),
                      ("flash_attn", f"eval batch of {B_MAIN}")):
        r = out[name]
        print(f"time f32 K3 per {per}, device (CUDA graph): split of q, k, v + K3 "
              f"{r['wrapper_device_ms']:.4f} ms (K3 alone {r['device_ms']:.4f}); sdpa "
              f"memory-efficient forward {r['library_device_ms']:.4f} ms; ratio "
              f"{r['wrapper_device_ms'] / r['library_device_ms']:.3f} (K3 alone "
              f"{r['device_ms'] / r['library_device_ms']:.3f})")
    r = out["split_bf16x3"]
    print(f"time split_bf16x3 per training batch of {B_TRAIN}: {r['ms']:.4f} ms, plain "
          f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms (bytes); device (CUDA graph) "
          f"{r['device_ms']:.4f} ms, {100 * r['bound_ms'] / r['device_ms']:.1f} % of the bound")
    r5, r4 = out["flash_attn_bwd_dq"], out["flash_attn_bwd_dkv"]
    total = r5["di_device_ms"] + r["device_ms"] + r5["device_ms"] + r4["device_ms"]
    print(f"time f32 backward per training batch of {B_TRAIN}, device (CUDA graph): di + split + K5 "
          f"+ K4 = {r5['di_device_ms']:.4f} + {r['device_ms']:.4f} + {r5['device_ms']:.4f} + "
          f"{r4['device_ms']:.4f} = {total:.4f} ms; sdpa memory-efficient backward "
          f"{r5['library_device_ms']:.4f} ms; ratio {total / r5['library_device_ms']:.3f}")
    r5, r4 = out["flash_attn_bwd_dq_bf16"], out["flash_attn_bwd_dkv_bf16"]
    total = r5["di_device_ms"] + r5["device_ms"] + r4["device_ms"]
    print(f"time bf16 backward per training batch of {B_TRAIN}, device (CUDA graph): di pass "
          f"{r5['di_device_ms']:.4f} + K5 {r5['device_ms']:.4f} + K4 {r4['device_ms']:.4f} = "
          f"{total:.4f} ms; sdpa flash backward {r5['library_device_ms']:.4f} ms; ratio "
          f"{total / r5['library_device_ms']:.3f}")
    return out


def train_times(torch, kernels, run, label: str = "train") -> Dict[str, List[float]]:
    """Train ms/step at B 12 (CUDA events, 3 steps after 1 warm-up) and peak
    memory, kernels and plain ops in turns."""
    model, state, step, partial, gt, weights = run
    ms = {"kernels": [], "plain": []}
    peak = {}
    box = [state]

    def one():
        box[0], _ = step(box[0], partial, gt, weights, 1e-6)

    for mode in ("plain", "kernels", "kernels", "plain"):
        ctx = kernels.reference_ops() if mode == "plain" else contextlib.nullcontext()
        with ctx:
            ms[mode].append(cuda_ms(one, iters=3, warmup=1))
            torch.cuda.reset_peak_memory_stats()
            one()
            torch.cuda.synchronize()
            peak[mode] = torch.cuda.max_memory_allocated() / 2**30
    print(f"{label} ms/step at B=12 (render + forward + loss + backward + Adam): kernels "
          + ", ".join(f"{x:.2f}" for x in ms["kernels"]) + "; plain "
          + ", ".join(f"{x:.2f}" for x in ms["plain"]))
    print(f"{label} peak memory: kernels {peak['kernels']:.2f} GiB, plain {peak['plain']:.2f} GiB")
    return ms


def kernel_profile(torch, fn: Callable[[], object], label: str = "train") -> None:
    """Device time of two calls of ``fn`` (a kernel train step or evaluation
    batch) by kernel family (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 2
    fam: Dict[str, float] = {}
    top = []
    for ev in prof.key_averages():
        # Device kernels only: no CPU op, and no user annotation (such as
        # "Optimizer.step#Adam.step"), whose device span covers the kernels
        # it brackets and the gaps between them.
        if ev.device_type != DeviceType.CUDA or getattr(ev, "is_user_annotation", False):
            continue
        dev_us = ev.self_device_time_total
        family = next((f for f, pat in PROFILE_FAMILIES if re.search(pat, ev.key, re.I)),
                      "other")
        fam[family] = fam.get(family, 0.0) + dev_us / 2e3
        top.append((dev_us / 2e3, ev.key[:90]))
    busy = sum(fam.values())
    if busy == 0:
        print("profile: the profiler recorded no device time")
        return
    unit = "batch" if "eval" in label else "step"
    print(f"profile per {label} {unit}: host wall {wall_ms:.2f} ms (profiler on), device busy "
          f"{busy:.2f} ms ({100 * busy / wall_ms:.1f} %)")
    for family, v in sorted(fam.items(), key=lambda kv: -kv[1]):
        print(f"profile {label}  {family:32s} {v:9.3f} ms  {100 * v / busy:5.1f} %")
    for v, key in sorted(top, reverse=True)[:12]:
        print(f"profile {label} top kernel {v:9.3f} ms  {key}")


def ellipsoids_55(rng: np.random.RandomState, n: int = 8192) -> np.ndarray:
    """(B_55, n, 3) f32 points on random ellipsoids, normalised into the unit
    sphere as ShapeNet55Dataset normalises its clouds."""
    from svdformer_pointsea_tpu_torch.data.transforms import pc_norm

    out = []
    for _ in range(B_55):
        axes = rng.uniform(0.2, 0.45, size=3)
        v = rng.randn(n, 3)
        out.append(pc_norm((v / np.linalg.norm(v, axis=1, keepdims=True) * axes)
                           .astype(np.float32)).astype(np.float32))
    return np.stack(out)


def masked_block(gt, direction, num_crop):
    """The 55 train step's input to K2: each cloud sorted by distance to its
    direction, its kept block shifted to index 0, the other rows zeroed."""
    from svdformer_pointsea_tpu_torch.data import crop

    s = crop._sorted_by_direction(gt, direction)
    return crop.masked_block(s, num_crop, gt.shape[1] - num_crop).contiguous()


def points_55_phase(torch, ops, kernels, g) -> Dict[str, float]:
    """K1 and K2 at every site of the 55 track at B 16 against their plain
    versions, bit for bit and on a repeat, each with its plan; K2 on the
    crop's masked 8192-point blocks keeping 2048, 4096 and 6144 points (and
    random_partial, the train step's crop, kernels against plain), with no
    zero row picked. Returns the max abs error per kernel."""
    from svdformer_pointsea_tpu_torch.data import random_partial

    dev = torch.device("cuda")
    sm = kernels.sm_count(dev)
    worst = {"nn_distance": 0.0, "fps": 0.0}
    for n, m in sorted(set(NN_TRAIN_SITES_55) | set(NN_EVAL_SITES_55)):
        a = torch.rand(B_55, n, 3, device=dev, generator=g) - 0.5
        b = torch.rand(B_55, m, 3, device=dev, generator=g) - 0.5
        d, i = ops.nn_one_way(a, b)
        d2, i2 = ops.nn_one_way(a, b)
        dp, ip = ops.nn_one_way_plain(a, b)
        equal = torch.equal(d, dp) and torch.equal(i, ip)
        repeat = torch.equal(d, d2) and torch.equal(i, i2)
        e = (d - dp).abs().max().item()
        print(f"55 K1 nn_distance B{B_55} {n}->{m}, plan "
              f"{tuple(ops.nn_launch_plan(B_55, n, m, sm))}: d and idx bit-equal to the plain "
              f"version {equal}, on a repeat {repeat}")
        if not (equal and repeat):
            fail(f"55 nn_distance B{B_55} {n}->{m} differs from its plain version or its repeat")
        worst["nn_distance"] = max(worst["nn_distance"], e)
    gt = torch.as_tensor(ellipsoids_55(np.random.RandomState(SEED + 10)), device=dev)
    cases = [(f"{n}->{m}", torch.rand(B_55, n, 3, device=dev, generator=g) - 0.5, m)
             for n, m in sorted(set(FPS_TRAIN_SITES_55) | set(FPS_MODEL_SITES_55)
                                | set(FPS_EVAL_SITES_55.values()))]
    direction = torch.nn.functional.normalize(torch.randn(B_55, 3, device=dev, generator=g), dim=-1)
    for kept in (2048, 4096, 6144):
        num_crop = torch.full((B_55,), 8192 - kept, dtype=torch.int32, device=dev)
        cases.append((f"masked crop block 8192 (kept {kept})->2048",
                      masked_block(gt, direction, num_crop), 2048))
    for name, x, m in cases:
        plan = ops.fps_launch_plan(B_55, x.shape[1], m, sm)
        i = ops.furthest_point_sample(x, m)
        again = ops.furthest_point_sample(x, m)
        ip = ops.furthest_point_sample_ref(x, m)
        bad = int((i != ip).sum().item())
        repeat = torch.equal(i, again)
        zero_picked = int((x.gather(1, i.long()[..., None].expand(-1, -1, 3)).square().sum(-1)
                           <= 1e-3).sum().item())
        print(f"55 K2 fps B{B_55} {name}, plan {tuple(plan)}: {bad} index mismatches; repeat "
              f"bit-equal {repeat}; zero rows picked {zero_picked}")
        if bad or not repeat or (name.startswith("masked") and zero_picked):
            fail(f"55 fps {name}: {bad} indices differ from the plain version, repeat {repeat}, "
                 f"{zero_picked} zero rows picked")
        worst["fps"] = max(worst["fps"], float((i - ip).abs().max().item()))
    num_crop = torch.as_tensor(np.random.RandomState(SEED + 11).randint(2048, 6145, B_55),
                               dtype=torch.int32, device=dev)
    part = random_partial(gt, direction, num_crop, 2048)
    with kernels.reference_ops():
        part_ref = random_partial(gt, direction, num_crop, 2048)
    print(f"55 crop: random_partial at crop sizes {num_crop.min().item()}-"
          f"{num_crop.max().item()} bit-equal to its plain version {torch.equal(part, part_ref)}")
    if not torch.equal(part, part_ref):
        fail("the 55 train step's crop differs between K2 and its plain version")
    return worst


def batch_55(torch, seed: int):
    """One 55 train batch of 16 on the card: gt, the host's crop draw (as
    train_net draws it) and row weights (3 pad rows of weight 0)."""
    from svdformer_pointsea_tpu_torch.data import random_crop_params

    gt = ellipsoids_55(np.random.RandomState(seed))
    num_crop, direction = random_crop_params(np.random.RandomState(seed + 1), B_55, gt.shape[1])
    weights = torch.ones(B_55, device="cuda")
    weights[-3:] = 0.0
    return tuple(torch.as_tensor(x, device="cuda") for x in (gt, direction, num_crop)) + (weights,)


def train_55_phase(torch, kernels, cfg, batch, precision: str):
    """One 55 train step (crop, render, forward, get_loss_pm, AdamW) with the
    kernels (the counted main path; exactly F32_STEP_55 or BF16_STEP_55
    launches) and one under reference_ops() from the same state, both with
    deterministic algorithms; loss and parts within the PCN bounds of the
    precision, AdamW's first moment per parameter too; then 2 more kernel
    steps with finite losses."""
    from svdformer_pointsea_tpu_torch.nn import mixed_precision
    from svdformer_pointsea_tpu_torch.render import make_renderer
    from svdformer_pointsea_tpu_torch.train import (build_model, init_state, make_lr_fn,
                                                    make_train_step)

    bf16 = precision == "bf16"
    lr = make_lr_fn(cfg)(1, 0)
    runs = {}
    for mode in ("kernels", "plain"):
        model = build_model(cfg, seed=SEED)
        state = init_state(cfg, model)
        runs[mode] = (model, state, make_train_step(
            model, state.optimizer, cfg.train.sqrt_loss, make_renderer(cfg).get_img,
            partial_matching=True, crop_n_out=cfg.data.n_points))
    with mixed_precision(bf16):
        torch.use_deterministic_algorithms(True, warn_only=True)
        model_k, state_k, step_k = runs["kernels"]
        kernels.reset_launches()
        state_k, m_k = step_k(state_k, *batch, lr)
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        model_r, state_r, step_r = runs["plain"]
        with kernels.reference_ops():
            state_r, m_r = step_r(state_r, *batch, lr)
        torch.cuda.synchronize()
        torch.use_deterministic_algorithms(False)
    label = f"55 {precision} train"
    want = BF16_STEP_55 if bf16 else F32_STEP_55
    print(f"{label} main path launches (one step): {launches}")
    if launches != want:
        fail(f"{label} step launches {launches}, expected {want}")
    if kernels.launches != launches:
        fail("a kernel launched under reference_ops()")
    loss_rtol = BF16_LOSS_RTOL if bf16 else LOSS_RTOL
    for key in ("loss", "cdc", "cd1", "cd2"):
        a, b = m_k[key].item(), m_r[key].item()
        rel = abs(a - b) / abs(b)
        print(f"{label} step 1 {key}: kernels {a:.8f}, plain {b:.8f}, rel |Δ| {rel:.3e} "
              f"(bound {loss_rtol})")
        if not (math.isfinite(a) and rel <= loss_rtol):
            fail(f"{label} {key} differs: {a} vs {b}")
    kw = dict(rtol=BF16_MU_RTOL, apart=(BF16_TRUNK, BF16_TRUNK_MU_RTOL)) if bf16 else {}
    worst, worst_noise, worst_trunk = first_moment_gap(torch, runs["kernels"], runs["plain"],
                                                       check=True, **kw)
    print(f"{label} AdamW first moment kernels vs plain: worst leaf {worst[1]} rel ‖Δ‖ "
          f"{worst[0]:.3e} (bound {kw.get('rtol', MU_RTOL)})"
          + (f"; bf16 image trunk {worst_trunk[1]} {worst_trunk[0]:.3e} (bound "
             f"{BF16_TRUNK_MU_RTOL})" if bf16 else "")
          + f"; zero-gradient leaves max |mu| {worst_noise[0]:.3e} ({worst_noise[1]})")
    del runs, model_r, state_r, step_r
    losses = []
    with mixed_precision(bf16):
        for _ in range(2):
            state_k, m = step_k(state_k, *batch, lr)
            losses.append(m["loss"].item())
    print(f"{label} steps 2-3: losses {losses}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite {label} loss")
    return launches, m_k


def eval_55_phase(torch, kernels, cfg, model, gt, precision: str, modes):
    """eval_55 over the 8 corners of one batch of 16 at ``modes[0]`` (the
    counted main path), then make_55_eval_fn at every mode of ``modes`` with
    the kernels and under reference_ops(), with the default algorithms: per
    sample and corner |ΔCD-L2×10³| <= CD_GATE_55, DCD and F1 finite, and a
    repeat with the kernels bit-equal (the render's splat adds in a fixed
    order: a last-bit change of the coarse points could flip a pick of the
    merge's FPS)."""
    from svdformer_pointsea_tpu_torch.data import FIXED_CORNERS
    from svdformer_pointsea_tpu_torch.nn import mixed_precision
    from svdformer_pointsea_tpu_torch.render import make_renderer
    from svdformer_pointsea_tpu_torch.train.evaluate import CROP_RATIO, eval_55, make_55_eval_fn

    corners = torch.as_tensor(FIXED_CORNERS, device="cuda")
    batch = Batch(data={"gtcloud": gt.cpu().numpy()},
                  taxonomy_ids=["02691156" if i % 2 == 0 else "03001627" for i in range(B_55)],
                  valid=B_55)
    with mixed_precision(precision == "bf16"):
        kernels.reset_launches()
        mean_cd = eval_55(cfg, model, [batch], mode=modes[0])
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        print(f"55 {precision} eval main path launches (8 corners, {modes[0]}): {launches}; mean "
              f"CD-L2×10³ {mean_cd:.6f}")
        k3 = "flash_attn_bf16" if precision == "bf16" else "flash_attn"
        for name in ("nn_distance", "fps", k3):
            if launches[name] == 0:
                fail(f"kernel {name} was not launched on the 55 {precision} evaluation path")
        for mode in modes:
            eval_fn = make_55_eval_fn(model, make_renderer(cfg),
                                      int(cfg.data.gt_points * CROP_RATIO[mode]),
                                      n_sample=cfg.data.n_points)
            m_k = eval_fn(gt, corners).cpu()
            again = eval_fn(gt, corners).cpu()
            with kernels.reference_ops():
                m_r = eval_fn(gt, corners).cpu()
            if not (torch.isfinite(m_k).all() and torch.isfinite(m_r).all()):
                fail(f"non-finite 55 {precision} CD / DCD / F1 at {mode}")
            worst = (m_k[:, 0] - m_r[:, 0]).abs().max().item()
            noise = (again[:, 0] - m_k[:, 0]).abs().max().item()
            print(f"55 {precision} eval {mode}, 8 corners x {B_55}: per-sample |ΔCD-L2×10³| "
                  f"kernels vs plain (default algorithms) max {worst:.3e} (gate {CD_GATE_55}); "
                  f"repeat bit-equal {torch.equal(again, m_k)} (run-to-run noise {noise:.3e}); "
                  f"mean CD-L2×10³ {m_k[:, 0].mean().item():.4f}, DCD "
                  f"{m_k[:, 1].mean().item():.4f}, F1 {m_k[:, 2].mean().item():.4f}")
            if not worst <= CD_GATE_55:
                fail(f"55 {precision} CD-L2×10³ at {mode} differs by {worst}")
            if not torch.equal(again, m_k):
                fail(f"a repeat of the 55 {precision} evaluation at {mode} gave other bits")
    return launches


def adv_55_phase(torch, kernels, cfg, batch):
    """One adversarial 55 step (d_steps 1) with the kernels and under
    reference_ops() from one state, deterministic algorithms: the generator's
    loss, its BCE term, the D loss and the pyramid parts within LOSS_RTOL;
    both networks' parameters moved."""
    from svdformer_pointsea_tpu_torch.nn import has_zero_gradient
    from svdformer_pointsea_tpu_torch.render import make_renderer
    from svdformer_pointsea_tpu_torch.train import build_model, init_state, make_lr_fn
    from svdformer_pointsea_tpu_torch.train.gan import create_adv55_state, make_adv55_train_step

    lr, t = make_lr_fn(cfg)(1, 0), cfg.train
    runs, before = {}, None
    for mode in ("kernels", "plain"):
        model = build_model(cfg, seed=SEED)
        state = init_state(cfg, model)
        adv = create_adv55_state(cfg, "cuda", seed=SEED)
        if before is None:
            before = ({n: p.clone() for n, p in model.named_parameters()},
                      {n: p.clone() for n, p in adv.model.named_parameters()})
        runs[mode] = (state, adv, make_adv55_train_step(
            model, state.optimizer, sqrt_loss=t.sqrt_loss, lambda_g=t.adv_lambda_g, d_steps=1,
            render_fn=make_renderer(cfg).get_img, crop_n_out=cfg.data.n_points))
    torch.use_deterministic_algorithms(True, warn_only=True)
    state, adv, step = runs["kernels"]
    kernels.reset_launches()
    state, adv, m_k = step(state, adv, *batch, lr, t.adv_d_lr)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    state_r, adv_r, step_r = runs["plain"]
    with kernels.reference_ops():
        _, _, m_r = step_r(state_r, adv_r, *batch, lr, t.adv_d_lr)
    torch.cuda.synchronize()
    torch.use_deterministic_algorithms(False)
    print(f"55 adversarial step launches: {launches}")
    if any(launches[name] != n for name, n in F32_STEP_55.items()):
        fail(f"55 adversarial step launches {launches}, expected {F32_STEP_55}")
    for key in ("loss", "d_loss", "gan", "cdc", "cd1", "cd2"):
        a, b = m_k[key].item(), m_r[key].item()
        rel = abs(a - b) / abs(b)
        print(f"55 adversarial step {key}: kernels {a:.8f}, plain {b:.8f}, rel |Δ| {rel:.3e} "
              f"(bound {LOSS_RTOL})")
        if not (math.isfinite(a) and rel <= LOSS_RTOL):
            fail(f"55 adversarial {key} differs: {a} vs {b}")
    g_moved = sum(not torch.equal(p, before[0][n]) for n, p in state.model.named_parameters())
    d_moved = sum(not torch.equal(p, before[1][n]) for n, p in adv.model.named_parameters())
    n_g, n_d = len(before[0]), len(before[1])
    print(f"55 adversarial step: generator parameters moved {g_moved} of {n_g}, discriminator "
          f"{d_moved} of {n_d}")
    if d_moved != n_d or g_moved < n_g - sum(map(has_zero_gradient, before[0])):
        fail("the adversarial step left parameters of a network unchanged")
    return launches


def entry_55_phase(torch, kernels) -> Dict[str, Dict[str, int]]:
    """main_55 on a synthetic ShapeNet-55 tree (write_55_tree: 32 train and
    16 test clouds of 8192 points): --epochs 1 (2 steps, validation by
    eval_55, checkpoints), then --test --mode easy in f32 and in bf16, and the
    test set's per-sample, per-corner CD with kernels vs reference_ops()."""
    from svdformer_pointsea_tpu_torch.cli import main_55
    from svdformer_pointsea_tpu_torch.configs import shapenet55_config
    from svdformer_pointsea_tpu_torch.data import FIXED_CORNERS, Loader, make_dataset
    from svdformer_pointsea_tpu_torch.data.synthetic import write_55_tree
    from svdformer_pointsea_tpu_torch.nn import mixed_precision
    from svdformer_pointsea_tpu_torch.render import make_renderer
    from svdformer_pointsea_tpu_torch.train import build_model, init_state, restore_checkpoint
    from svdformer_pointsea_tpu_torch.train.evaluate import CROP_RATIO, make_55_eval_fn

    launches = {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as root:
        write_55_tree(root, np.random.RandomState(SEED + 3), TREE_MODELS_55)
        os.chdir(root)
        try:
            out = os.path.join(root, "out")
            kernels.reset_launches()
            t0 = time.perf_counter()
            state, best = main_55(["--epochs", "1", "--out", out])
            torch.cuda.synchronize()
            launches["main_55 train"] = dict(kernels.launches)
            print(f"main_55 --epochs 1: {state.step} steps, best val CD-L2×10³ {best:.4f}, "
                  f"{time.perf_counter() - t0:.1f} s; launches {launches['main_55 train']}")
            if state.step != TREE_MODELS_55["train"] // B_55 or not math.isfinite(best):
                fail(f"main_55 took {state.step} steps, best {best}")
            for name in TRAIN_KERNELS:
                if launches["main_55 train"][name] == 0:
                    fail(f"kernel {name} was not launched by main_55")
            ckpt = os.path.join(out, "checkpoints", "ckpt-best.pt")
            del state
            for precision in ("f32", "bf16"):
                kernels.reset_launches()
                mean_cd = main_55(["--test", "--mode", "easy", "--weights", ckpt,
                                   "--precision", precision])
                torch.cuda.synchronize()
                launches[f"main_55 --test {precision}"] = dict(kernels.launches)
                k3 = "flash_attn_bf16" if precision == "bf16" else "flash_attn"
                print(f"main_55 --test --mode easy --precision {precision}: mean CD-L2×10³ "
                      f"{mean_cd:.6f}; launches {kernels.launches}")
                if not math.isfinite(mean_cd) or kernels.launches[k3] == 0:
                    fail(f"main_55 --test {precision}")
            cfg = shapenet55_config()
            loaded, _, _ = restore_checkpoint(ckpt, init_state(cfg, build_model(cfg, seed=SEED)))
            eval_fn = make_55_eval_fn(loaded.model, make_renderer(cfg),
                                      int(cfg.data.gt_points * CROP_RATIO["easy"]))
            corners = torch.as_tensor(FIXED_CORNERS, device="cuda")
            for precision in ("f32", "bf16"):
                worst = 0.0
                with mixed_precision(precision == "bf16"):
                    for batch in Loader(make_dataset(cfg, "test"), B_55):
                        gt = torch.as_tensor(batch.data["gtcloud"], device="cuda")
                        m_k = eval_fn(gt, corners)[:, :, :batch.valid].cpu()
                        with kernels.reference_ops():
                            m_r = eval_fn(gt, corners)[:, :, :batch.valid].cpu()
                        if not (torch.isfinite(m_k).all() and torch.isfinite(m_r).all()):
                            fail("non-finite 55 test metrics")
                        worst = max(worst, (m_k[:, 0] - m_r[:, 0]).abs().max().item())
                print(f"55 test set per-sample |ΔCD-L2×10³| kernels vs plain (default "
                      f"algorithms), {precision}: max {worst:.3e} (gate {CD_GATE_55})")
                if not worst <= CD_GATE_55:
                    fail(f"55 {precision} test CD differs by {worst} between kernels and plain")
        finally:
            os.chdir(cwd)
    return launches


def times_55(torch, ops, kernels, cfg, batch, eval_gt, g) -> Dict[str, float]:
    """55 timings: train ms/step at B 16 in f32 and bf16 mode (3 steps after
    1 warm-up, twice) with a profile of each, eval completions/s (a
    completion = one sample at one corner; 8 corners of 16 a call) in f32 and
    bf16 mode, and K1 / K2 per site of a 55 train batch (the crop's K2 on a
    masked block keeping 4096 points) and of an eval corner, with their
    device times and floors. Returns the per-train-batch sums."""
    from svdformer_pointsea_tpu_torch.data import FIXED_CORNERS
    from svdformer_pointsea_tpu_torch.nn import mixed_precision
    from svdformer_pointsea_tpu_torch.render import make_renderer
    from svdformer_pointsea_tpu_torch.train import build_model, init_state, make_train_step
    from svdformer_pointsea_tpu_torch.train.evaluate import CROP_RATIO, make_55_eval_fn

    model = build_model(cfg, seed=SEED)
    state = init_state(cfg, model)
    step = make_train_step(model, state.optimizer, cfg.train.sqrt_loss, make_renderer(cfg).get_img,
                           partial_matching=True, crop_n_out=cfg.data.n_points)
    box = [state]

    def one():
        box[0], _ = step(box[0], *batch, 1e-6)

    for precision in ("f32", "bf16"):
        with mixed_precision(precision == "bf16"):
            ms = [cuda_ms(one, iters=3, warmup=1) for _ in range(2)]
            torch.cuda.reset_peak_memory_stats()
            one()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2**30
            print(f"55 {precision} train ms/step at B={B_55} (crop + render + forward + "
                  f"get_loss_pm + backward + AdamW): kernels " + ", ".join(f"{x:.2f}" for x in ms)
                  + f"; peak memory {peak:.2f} GiB")
            kernel_profile(torch, one, f"55 {precision} train")
    corners = torch.as_tensor(FIXED_CORNERS, device="cuda")
    eval_fn = make_55_eval_fn(model, make_renderer(cfg),
                              int(cfg.data.gt_points * CROP_RATIO[cfg.data.mode]))
    for precision in ("f32", "bf16"):
        with mixed_precision(precision == "bf16"):
            rates = [8 * B_55 * 1000.0 / cuda_ms(lambda: eval_fn(eval_gt, corners), iters=2,
                                                 warmup=1) for _ in range(2)]
        print(f"55 {precision} eval completions/s ({cfg.data.mode}, 8 corners x {B_55} a call: "
              "crop + FPS + render + forward + CD/DCD/F1): kernels "
              + ", ".join(f"{r:.2f}" for r in rates))
    del model, state, step, box, eval_fn
    torch.cuda.empty_cache()

    clock_hz = sm_clock_mhz() * 1e6
    sm = kernels.sm_count(torch.device("cuda"))
    gt = batch[0]
    kept = torch.full((B_55,), 4096, dtype=torch.int32, device="cuda")
    block = masked_block(gt, batch[1], gt.shape[1] - kept)
    totals = {}
    for per, nn_sites, fps_sites in (
            ("55 train", NN_TRAIN_SITES_55, FPS_TRAIN_SITES_55),
            ("55 eval corner", NN_EVAL_SITES_55,
             [FPS_EVAL_SITES_55[cfg.data.mode]] + FPS_MODEL_SITES_55)):
        sums = {name: {"ms": 0.0, "plain_ms": 0.0, "device_ms": 0.0, "floor_ms": 0.0}
                for name in ("nn_distance", "fps")}
        for n, m in nn_sites:
            r = time_k1_site(torch, ops, kernels, g, B_55, n, m, sm, clock_hz, label=" 55")
            for key, v in zip(("ms", "plain_ms", "device_ms", "floor_ms"), r[:4]):
                sums["nn_distance"][key] += v
        for j, (n, m) in enumerate(fps_sites):
            x = block if per == "55 train" and j == 0 else None
            r = time_k2_site(torch, ops, kernels, g, B_55, n, m, sm, clock_hz, label=" 55", x=x)
            for key, v in zip(("ms", "plain_ms", "device_ms", "floor_ms"), r[:4]):
                sums["fps"][key] += v
        print_point_sums(sums, per, B_55)
        totals[per] = sums
    return totals


def geospec_gan_phase(torch, kernels, cfg, batch, precision: str):
    """One GeoSpecNet GAN step in f32 or bf16 mode with the kernels (the
    counted main path) and one under reference_ops(), from one state (seed
    SEED), both with PyTorch's deterministic algorithms (cuDNN's backward
    convolutions and the trunk's max-pool backward add with atomics
    otherwise): exact launches (GEO_STEP / GEO_BF16_STEP), every metric
    within the precision's loss bound, the first moments of G's and D's Adam
    within the PCN bounds, D's running means moved. Returns the launches and
    the kernels' state."""
    from svdformer_pointsea_tpu_torch.nn import mixed_precision
    from svdformer_pointsea_tpu_torch.render import make_renderer
    from svdformer_pointsea_tpu_torch.train import build_model, make_lr_fn
    from svdformer_pointsea_tpu_torch.train.gan import create_gan_state, make_gan_train_step

    bf16 = precision == "bf16"
    lr = make_lr_fn(cfg)(1, 0)
    step = make_gan_train_step(cfg.train.gan_weight, make_renderer(cfg).get_img)
    states = {mode: create_gan_state(cfg, build_model(cfg, seed=SEED), seed=SEED)
              for mode in ("kernels", "plain")}
    with mixed_precision(bf16):
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            kernels.reset_launches()
            states["kernels"], m_k = step(states["kernels"], *batch, lr, lr)
            torch.cuda.synchronize()
            launches = dict(kernels.launches)
            with kernels.reference_ops():
                states["plain"], m_r = step(states["plain"], *batch, lr, lr)
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    if kernels.launches != launches:
        fail("a kernel launched under reference_ops()")
    label = f"geospec {precision} GAN step"
    want = GEO_BF16_STEP if bf16 else GEO_STEP
    print(f"{label} main path launches: {launches}")
    if launches != want:
        fail(f"{label} launches {launches}, expected {want}")
    loss_rtol = BF16_LOSS_RTOL if bf16 else LOSS_RTOL
    for key in ("g_loss", "d_loss", "recon", "gan", "cdc", "cd1", "cd2"):
        a, b = m_k[key].item(), m_r[key].item()
        rel = abs(a - b) / abs(b)
        print(f"{label} {key}: kernels {a:.8f}, plain {b:.8f}, rel |Δ| {rel:.3e} (bound "
              f"{loss_rtol})")
        if not (math.isfinite(a) and rel <= loss_rtol):
            fail(f"{label} {key} differs: {a} vs {b}")
    k, r = states["kernels"], states["plain"]
    kw = dict(rtol=BF16_MU_RTOL, apart=(BF16_TRUNK, BF16_TRUNK_MU_RTOL)) if bf16 else {}
    worst, noise, trunk = first_moment_gap(torch, (k.model, k, None), (r.model, r, None),
                                           check=True, **kw)
    worst_d, noise_d, _ = first_moment_gap(
        torch, (k.d_model, SimpleNamespace(optimizer=k.d_optimizer), None),
        (r.d_model, SimpleNamespace(optimizer=r.d_optimizer), None), check=True, **kw)
    print(f"{label} Adam first moment kernels vs plain: G worst leaf {worst[1]} rel ‖Δ‖ "
          f"{worst[0]:.3e}" + (f" (bf16 image trunk {trunk[1]} {trunk[0]:.3e})" if bf16 else "")
          + f", zero-gradient max |mu| {noise[0]:.3e} ({noise[1]}); D worst leaf {worst_d[1]} "
          f"{worst_d[0]:.3e}, zero-gradient max |mu| {noise_d[0]:.3e} ({noise_d[1]}); bound "
          f"{kw.get('rtol', MU_RTOL)}")
    stats = [b for n, b in k.d_model.named_buffers() if n.endswith("running_mean")]
    if any(torch.equal(b, torch.zeros_like(b)) for b in stats):
        fail(f"{label}: a running mean of D did not move")
    return launches, states["kernels"]


def geospec_eval_phase(torch, kernels, cfg, model, batch):
    """One GeoSpecNet eval batch of 8 under the default algorithms: exact
    launches (GEO_EVAL), per-sample |ΔCD-L1×10³| kernels vs reference_ops()
    <= CD_GATE, and a repeat with the kernels bit-equal."""
    from svdformer_pointsea_tpu_torch.render import make_renderer
    from svdformer_pointsea_tpu_torch.train.evaluate import make_pcn_eval_fn

    eval_fn = make_pcn_eval_fn(model, make_renderer(cfg))
    partial = torch.as_tensor(batch.data["partial_cloud"], device="cuda")
    gt = torch.as_tensor(batch.data["gtcloud"], device="cuda")
    kernels.reset_launches()
    m_k = eval_fn(partial, gt).cpu()
    launches = dict(kernels.launches)
    print(f"geospec eval main path launches (one batch of {B_MAIN}): {launches}")
    if launches != GEO_EVAL:
        fail(f"geospec eval launches {launches}, expected {GEO_EVAL}")
    again = eval_fn(partial, gt).cpu()
    with kernels.reference_ops():
        m_r = eval_fn(partial, gt).cpu()
    if not (torch.isfinite(m_k).all() and torch.isfinite(m_r).all()):
        fail("non-finite geospec CD / DCD / F1")
    worst = (m_k[0] - m_r[0]).abs().max().item()
    print(f"geospec eval per-sample |ΔCD-L1×10³| kernels vs plain (default algorithms): max "
          f"{worst:.3e} (gate {CD_GATE}); repeat bit-equal {torch.equal(again, m_k)}; mean "
          f"CD-L1×10³ {m_k[0].mean().item():.4f}")
    if not worst <= CD_GATE:
        fail(f"geospec CD-L1×10³ differs by {worst} between kernels and plain")
    if not torch.equal(again, m_k):
        fail("a repeat of the geospec evaluation gave other bits")
    return launches, eval_fn


def geospec_entry_phase(torch, kernels) -> Dict[str, Dict[str, int]]:
    """main_geospec on a synthetic PCN tree (12 train models: one GAN step an
    epoch): --epochs 1 (validation by eval_pcn, checkpoints of both networks),
    then --test of the best checkpoint's generator."""
    from svdformer_pointsea_tpu_torch.cli import main_geospec
    from svdformer_pointsea_tpu_torch.data.synthetic import write_pcn_tree

    launches = {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as root:
        write_pcn_tree(root, np.random.RandomState(SEED + 4), TREE_MODELS_GEO)
        os.chdir(root)
        try:
            out = os.path.join(root, "out")
            kernels.reset_launches()
            t0 = time.perf_counter()
            state, best = main_geospec(["--epochs", "1", "--out", out])
            torch.cuda.synchronize()
            launches["main_geospec train"] = dict(kernels.launches)
            print(f"main_geospec --epochs 1: {state.step} GAN step(s), best val CD-L1×10³ "
                  f"{best:.4f}, {time.perf_counter() - t0:.1f} s; launches "
                  f"{launches['main_geospec train']}")
            if state.step != TREE_MODELS_GEO["train"] // B_TRAIN or not math.isfinite(best):
                fail(f"main_geospec took {state.step} steps, best {best}")
            for name in TRAIN_KERNELS + ("flash_attn",):
                if launches["main_geospec train"][name] == 0:
                    fail(f"kernel {name} was not launched by main_geospec")
            ckpt = os.path.join(out, "checkpoints", "ckpt-best.pt")
            payload = torch.load(ckpt, map_location="cpu", weights_only=True)
            if not {"model", "optimizer", "d_model", "d_optimizer"} <= set(payload):
                fail(f"the GAN checkpoint holds {sorted(payload)}")
            del state, payload
            kernels.reset_launches()
            mean_cd = main_geospec(["--test", "--weights", ckpt])
            torch.cuda.synchronize()
            launches["main_geospec --test"] = dict(kernels.launches)
            print(f"main_geospec --test: mean CD-L1×10³ {mean_cd:.6f}; launches "
                  f"{kernels.launches}")
            if not math.isfinite(mean_cd) or kernels.launches["flash_attn"] == 0:
                fail("main_geospec --test")
        finally:
            os.chdir(cwd)
    return launches


def geospec_times(torch, kernels, cfg, batch, eval_fn, eval_batch) -> Dict[str, List[float]]:
    """GAN ms/step at B 12 in f32 and bf16 mode (3 steps after 1 warm-up,
    kernels and plain in turns) with peak memory, a profile of the f32 GAN
    step, and eval completions/s at B 8 (5 calls after 1 warm-up, twice)."""
    from svdformer_pointsea_tpu_torch.nn import mixed_precision
    from svdformer_pointsea_tpu_torch.render import make_renderer
    from svdformer_pointsea_tpu_torch.train import build_model
    from svdformer_pointsea_tpu_torch.train.gan import create_gan_state, make_gan_train_step

    box = [create_gan_state(cfg, build_model(cfg, seed=SEED), seed=SEED)]
    step = make_gan_train_step(cfg.train.gan_weight, make_renderer(cfg).get_img)

    def one():
        box[0], _ = step(box[0], *batch, 1e-6, 1e-6)

    out = {}
    for precision in ("f32", "bf16"):
        ms, peak = {"kernels": [], "plain": []}, {}
        with mixed_precision(precision == "bf16"):
            for mode in ("plain", "kernels", "kernels", "plain"):
                ctx = kernels.reference_ops() if mode == "plain" else contextlib.nullcontext()
                with ctx:
                    ms[mode].append(cuda_ms(one, iters=3, warmup=1))
                    torch.cuda.reset_peak_memory_stats()
                    one()
                    torch.cuda.synchronize()
                    peak[mode] = torch.cuda.max_memory_allocated() / 2**30
            print(f"geospec {precision} GAN ms/step at B={B_TRAIN} (render + G forward + D on gt "
                  "and P2 + D's Adam + get_loss_pm + D(P2) + backward + G's Adam): kernels "
                  + ", ".join(f"{x:.2f}" for x in ms["kernels"]) + "; plain "
                  + ", ".join(f"{x:.2f}" for x in ms["plain"]) + f"; peak memory kernels "
                  f"{peak['kernels']:.2f} GiB, plain {peak['plain']:.2f} GiB")
            if precision == "f32":
                kernel_profile(torch, one, "geospec f32 GAN")
        out[precision] = ms["kernels"]
    del box, step
    torch.cuda.empty_cache()
    partial = torch.as_tensor(eval_batch.data["partial_cloud"], device="cuda")
    gt = torch.as_tensor(eval_batch.data["gtcloud"], device="cuda")
    rates = [B_MAIN * 1000.0 / cuda_ms(lambda: eval_fn(partial, gt), iters=5, warmup=1)
             for _ in range(2)]
    torch.cuda.reset_peak_memory_stats()
    eval_fn(partial, gt)
    torch.cuda.synchronize()
    print(f"geospec f32 eval completions/s at B={B_MAIN} (render + forward + CD/DCD/F1): kernels "
          + ", ".join(f"{r:.2f}" for r in rates)
          + f"; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return out


def pointsea_render_phase(torch, batch) -> None:
    """PCViewsReal on the card against itself on the CPU at B 12: the grids
    bit for bit (a scatter-max gives the same bits in any order), the images
    within IMG_TOL (the Gaussian's sum order)."""
    from svdformer_pointsea_tpu_torch.render import PCViewsReal

    render = PCViewsReal(trans=-0.7)
    pts = torch.as_tensor(batch.data["partial_cloud"])
    grid, img = render.grid(pts.cuda()).cpu(), render.get_img(pts.cuda()).cpu()
    grid_ref, img_ref = render.grid(pts), render.get_img(pts)
    mismatches = (grid != grid_ref).sum().item()
    err = (img - img_ref).abs().max().item()
    print(f"pointsea render B{pts.shape[0]}x{pts.shape[1]} -> grids {tuple(grid.shape)}, images "
          f"{tuple(img.shape)}: card vs CPU grid mismatches {mismatches} of {grid.numel()} "
          f"(occupied {(grid > 0).sum().item()}), images max|Δ| {err:.3e} (bound {IMG_TOL})")
    if mismatches or not err <= IMG_TOL or not torch.isfinite(img).all():
        fail("PCViewsReal on the card differs from the CPU")


def pointsea_eval_phase(torch, kernels, cfg, model, batches, precision: str):
    """eval_pcn over ``batches`` in f32 or bf16 mode with exact launches (the
    counted main path), then each batch with the kernels, again, and under
    reference_ops(), default algorithms: per-sample |ΔCD-L1×10³| <= CD_GATE and
    repeats bit-equal. Returns the launches and the eval function."""
    from svdformer_pointsea_tpu_torch.nn import mixed_precision
    from svdformer_pointsea_tpu_torch.render import make_renderer
    from svdformer_pointsea_tpu_torch.train.evaluate import eval_pcn, make_pcn_eval_fn

    bf16 = precision == "bf16"
    want = {k: len(batches) * v for k, v in (PS_BF16_EVAL if bf16 else PS_EVAL).items()}
    eval_fn = make_pcn_eval_fn(model, make_renderer(cfg))
    worst, repeats = 0.0, []
    with mixed_precision(bf16):
        kernels.reset_launches()
        mean_cd = eval_pcn(cfg, model, batches)
        launches = dict(kernels.launches)
        print(f"pointsea {precision} eval main path launches ({len(batches)} batches of {B_MAIN}): "
              f"{launches}; mean CD-L1×10³ {mean_cd:.6f}")
        if launches != want:
            fail(f"pointsea {precision} eval launches {launches}, expected {want}")
        for batch in batches:
            partial = torch.as_tensor(batch.data["partial_cloud"], device="cuda")
            gt = torch.as_tensor(batch.data["gtcloud"], device="cuda")
            m_k = eval_fn(partial, gt)[:, :batch.valid].cpu()
            repeats.append(torch.equal(eval_fn(partial, gt)[:, :batch.valid].cpu(), m_k))
            with kernels.reference_ops():
                m_r = eval_fn(partial, gt)[:, :batch.valid].cpu()
            if not (torch.isfinite(m_k).all() and torch.isfinite(m_r).all()):
                fail("non-finite pointsea CD / DCD / F1")
            worst = max(worst, (m_k[0] - m_r[0]).abs().max().item())
    print(f"pointsea {precision} eval per-sample |ΔCD-L1×10³| kernels vs plain (default "
          f"algorithms): max {worst:.3e} (gate {CD_GATE}); repeat of each batch bit-equal "
          f"{repeats}")
    if not worst <= CD_GATE:
        fail(f"pointsea {precision} CD-L1×10³ differs by {worst} between kernels and plain")
    if not all(repeats):
        fail(f"a repeat of the pointsea {precision} evaluation gave other bits")
    return launches, eval_fn


def pointsea_train_phase(torch, kernels, cfg, batch, precision: str):
    """One PointSea train step in f32 or bf16 mode with the kernels (the
    counted main path) and one under reference_ops(), from one state (seed
    SEED), both with PyTorch's deterministic algorithms: exact launches
    (PS_STEP / PS_BF16_STEP), the loss and its parts within the precision's
    bound, Adam's first moments within the PCN bounds (PointSea's
    zero-gradient list; in bf16 the image trunk apart). Then 5 more kernel
    steps: finite losses, every BatchNorm's running statistics moved.
    Returns the launches and the first step's metrics."""
    from svdformer_pointsea_tpu_torch.nn import mixed_precision
    from svdformer_pointsea_tpu_torch.nn.layers import BatchNorm
    from svdformer_pointsea_tpu_torch.render import make_renderer
    from svdformer_pointsea_tpu_torch.train import (build_model, init_state, make_lr_fn,
                                                    make_train_step)

    bf16 = precision == "bf16"
    lr_fn = make_lr_fn(cfg)
    lr = lr_fn(1, 0)
    render = make_renderer(cfg)
    runs = {}
    for mode in ("kernels", "plain"):
        model = build_model(cfg, seed=SEED)
        state = init_state(cfg, model)
        runs[mode] = (model, state, make_train_step(model, state.optimizer, cfg.train.sqrt_loss,
                                                    render.get_img))
    label = f"pointsea {precision} train step"
    with mixed_precision(bf16):
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            model_k, state_k, step_k = runs["kernels"]
            kernels.reset_launches()
            state_k, m_k = step_k(state_k, *batch, lr)
            torch.cuda.synchronize()
            launches = dict(kernels.launches)
            model_r, state_r, step_r = runs["plain"]
            with kernels.reference_ops():
                state_r, m_r = step_r(state_r, *batch, lr)
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    want = PS_BF16_STEP if bf16 else PS_STEP
    print(f"{label} main path launches: {launches}")
    if launches != want:
        fail(f"{label} launches {launches}, expected {want}")
    if kernels.launches != launches:
        fail("a kernel launched under reference_ops()")
    loss_rtol = BF16_LOSS_RTOL if bf16 else LOSS_RTOL
    for key in ("loss", "cdc", "cd1", "cd2"):
        a, b = m_k[key].item(), m_r[key].item()
        rel = abs(a - b) / abs(b)
        print(f"{label} 1 {key}: kernels {a:.8f}, plain {b:.8f}, rel |Δ| {rel:.3e} (bound "
              f"{loss_rtol})")
        if not (math.isfinite(a) and rel <= loss_rtol):
            fail(f"{label} {key} differs: {a} vs {b}")
    kw = dict(rtol=BF16_MU_RTOL, apart=(BF16_TRUNK, BF16_TRUNK_MU_RTOL)) if bf16 else {}
    worst, noise, trunk = first_moment_gap(torch, runs["kernels"], (model_r, state_r, None),
                                           check=True, family="pointsea", **kw)
    print(f"{label} Adam first moment kernels vs plain: worst leaf {worst[1]} rel ‖Δ‖ "
          f"{worst[0]:.3e}" + (f" (bf16 ResNet-18 {trunk[1]} {trunk[0]:.3e}, bound "
                               f"{BF16_TRUNK_MU_RTOL})" if bf16 else "")
          + f", bound {kw.get('rtol', MU_RTOL)}; zero-gradient leaves (PointSea's list) max |mu| "
          f"{noise[0]:.3e} ({noise[1]}, bound {NOISE_MU})")
    del runs, model_r, state_r, step_r
    bns = [m for m in model_k.modules() if isinstance(m, BatchNorm)]
    before = [(m.running_mean.clone(), m.running_var.clone()) for m in bns]
    losses = []
    with mixed_precision(bf16):
        for _ in range(5):
            lr = lr_fn(state_k.step + 1, 0)
            state_k, m = step_k(state_k, *batch, lr)
            losses.append(m["loss"].item())
    still = sum(torch.equal(m.running_mean, a) or torch.equal(m.running_var, b)
                for m, (a, b) in zip(bns, before))
    print(f"{label}s 2-6: losses {losses}; running statistics moved in "
          f"{len(bns) - still} of {len(bns)} BatchNorms")
    if not all(math.isfinite(x) for x in losses) or still:
        fail(f"{label}s 2-6: losses {losses}, {still} BatchNorms kept their statistics")
    return launches, m_k


def pointsea_entry_phase(torch, kernels) -> Dict[str, Dict[str, int]]:
    """main_pointsea on a synthetic PCN tree (12 train models: one step an
    epoch): --epochs 1 (validation by eval_pcn, checkpoints), then --test of
    the best checkpoint in f32 and in bf16."""
    from svdformer_pointsea_tpu_torch.cli import main_pointsea
    from svdformer_pointsea_tpu_torch.data.synthetic import write_pcn_tree

    launches = {}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as root:
        write_pcn_tree(root, np.random.RandomState(SEED + 5), TREE_MODELS_PS)
        os.chdir(root)
        try:
            out = os.path.join(root, "out")
            kernels.reset_launches()
            t0 = time.perf_counter()
            state, best = main_pointsea(["--epochs", "1", "--out", out])
            torch.cuda.synchronize()
            launches["main_pointsea train"] = dict(kernels.launches)
            print(f"main_pointsea --epochs 1: {state.step} step(s), best val CD-L1×10³ "
                  f"{best:.4f}, {time.perf_counter() - t0:.1f} s; launches "
                  f"{launches['main_pointsea train']}")
            if state.step != TREE_MODELS_PS["train"] // B_TRAIN or not math.isfinite(best):
                fail(f"main_pointsea took {state.step} steps, best {best}")
            for name in TRAIN_KERNELS + ("flash_attn",):
                if launches["main_pointsea train"][name] == 0:
                    fail(f"kernel {name} was not launched by main_pointsea")
            ckpt = os.path.join(out, "checkpoints", "ckpt-best.pt")
            del state
            for precision in ("f32", "bf16"):
                kernels.reset_launches()
                mean_cd = main_pointsea(["--test", "--weights", ckpt, "--precision", precision])
                torch.cuda.synchronize()
                launches[f"main_pointsea --test {precision}"] = dict(kernels.launches)
                k3 = "flash_attn_bf16" if precision == "bf16" else "flash_attn"
                print(f"main_pointsea --test --precision {precision}: mean CD-L1×10³ "
                      f"{mean_cd:.6f}; launches {kernels.launches}")
                if not math.isfinite(mean_cd) or kernels.launches[k3] == 0:
                    fail(f"main_pointsea --test --precision {precision}")
        finally:
            os.chdir(cwd)
    return launches


def pointsea_times(torch, kernels, cfg, batch, eval_fn, eval_batch) -> Dict[str, List[float]]:
    """Train ms/step at B 12 in f32 and bf16 mode (3 steps after 1 warm-up,
    kernels and plain in turns) with peak memory, a profile of the f32 step,
    the render of B 12 and ResNet-18's train-mode forward on its 36 images
    alone, and eval completions/s at B 8 in f32 and bf16 (5 calls after 1
    warm-up, twice)."""
    from svdformer_pointsea_tpu_torch.nn import mixed_precision
    from svdformer_pointsea_tpu_torch.render import make_renderer
    from svdformer_pointsea_tpu_torch.train import build_model, init_state, make_train_step

    model = build_model(cfg, seed=SEED)
    state = init_state(cfg, model)
    render = make_renderer(cfg)
    box = [state]
    step = make_train_step(model, state.optimizer, cfg.train.sqrt_loss, render.get_img)

    def one():
        box[0], _ = step(box[0], *batch, 1e-6)

    out = {}
    for precision in ("f32", "bf16"):
        ms, peak = {"kernels": [], "plain": []}, {}
        with mixed_precision(precision == "bf16"):
            for mode in ("plain", "kernels", "kernels", "plain"):
                ctx = kernels.reference_ops() if mode == "plain" else contextlib.nullcontext()
                with ctx:
                    ms[mode].append(cuda_ms(one, iters=3, warmup=1))
                    torch.cuda.reset_peak_memory_stats()
                    one()
                    torch.cuda.synchronize()
                    peak[mode] = torch.cuda.max_memory_allocated() / 2**30
            print(f"pointsea {precision} train ms/step at B={B_TRAIN} (render + forward + loss + "
                  "backward + Adam): kernels " + ", ".join(f"{x:.2f}" for x in ms["kernels"])
                  + "; plain " + ", ".join(f"{x:.2f}" for x in ms["plain"]) + f"; peak memory "
                  f"kernels {peak['kernels']:.2f} GiB, plain {peak['plain']:.2f} GiB")
            if precision == "f32":
                kernel_profile(torch, one, "pointsea f32 train")
            partial = batch[0]
            depth = render.get_img(partial)
            with torch.no_grad():
                trunk_ms = cuda_ms(lambda: model.encoder.img_trunk(depth), iters=5, warmup=1)
            print(f"pointsea {precision}: realistic render of B={B_TRAIN} "
                  f"{cuda_ms(lambda: render.get_img(partial), iters=5, warmup=1):.3f} ms; "
                  f"ResNet-18 train-mode forward on {depth.shape[0]} images of "
                  f"{depth.shape[-1]}² {trunk_ms:.3f} ms")
        out[precision] = ms["kernels"]
    del box, step, model, state
    torch.cuda.empty_cache()
    partial = torch.as_tensor(eval_batch.data["partial_cloud"], device="cuda")
    gt = torch.as_tensor(eval_batch.data["gtcloud"], device="cuda")
    for precision in ("f32", "bf16"):
        with mixed_precision(precision == "bf16"):
            rates = [B_MAIN * 1000.0 / cuda_ms(lambda: eval_fn(partial, gt), iters=5, warmup=1)
                     for _ in range(2)]
            torch.cuda.reset_peak_memory_stats()
            eval_fn(partial, gt)
            torch.cuda.synchronize()
        print(f"pointsea {precision} eval completions/s at B={B_MAIN} (render + forward + "
              "CD/DCD/F1): kernels " + ", ".join(f"{r:.2f}" for r in rates)
              + f"; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        out[f"{precision} eval"] = rates
    return out


def kitti_points_phase(torch, ops, kernels, g) -> Dict[str, float]:
    """K2 on KITTI's zero-padded partials: 60, 137, 300 and 511 valid points
    of 2048 (fewer than SA1's 512 picks, and than SA2's 128 but one), 2048 ->
    512 and -> 128 at B 12 under C = 1, 2, 4, 8, bit-equal to the plain
    version and on a repeat; K1 with zero-padded queries (the fidelity's
    2048 -> 16384), bit for bit. Returns the max error per kernel."""
    dev = torch.device("cuda")
    sm = kernels.sm_count(dev)
    for valid in KITTI_VALID:
        x = torch.zeros(B_TRAIN, 2048, 3, device=dev)
        x[:, :valid] = (torch.rand(B_TRAIN, valid, 3, device=dev, generator=g) - 0.5) * 0.8
        for m in (512, 128):
            want = ops.furthest_point_sample_ref(x, m)
            same = []
            for c in (1, 2, 4, 8):
                plan = ops.fps_launch_plan(B_TRAIN, 2048, m, sm, cluster=c)
                i = ops.fps._fps_kernel(x, m, plan)
                same.append(torch.equal(i, want) and torch.equal(i, ops.fps._fps_kernel(x, m, plan)))
            fallback = valid >= m or not bool(want[:, valid:].any())
            print(f"K2 fps KITTI zero-padded B{B_TRAIN} 2048 ({valid} valid) -> {m}: bit-equal to "
                  f"the plain version and on a repeat under C = 1, 2, 4, 8: {same}; picks past "
                  f"the valid points fall back to index 0: {fallback}")
            if not (all(same) and fallback):
                fail(f"fps on zero-padded KITTI partials ({valid} valid, -> {m}) differs")
    a = torch.zeros(B_TRAIN, 2048, 3, device=dev)
    for r in range(B_TRAIN):
        v = (KITTI_VALID + (2048,))[r % (len(KITTI_VALID) + 1)]
        a[r, :v] = (torch.rand(v, 3, device=dev, generator=g) - 0.5) * 0.8
    b = torch.rand(B_TRAIN, 16384, 3, device=dev, generator=g) - 0.5
    d, i = ops.nn_one_way(a, b)
    d2, i2 = ops.nn_one_way(a, b)
    dp, ip = ops.nn_one_way_plain(a, b)
    equal, repeat = torch.equal(d, dp) and torch.equal(i, ip), torch.equal(d, d2) and torch.equal(i, i2)
    err = (d - dp).abs().max().item()
    print(f"K1 nn_distance KITTI fidelity B{B_TRAIN} 2048 (zero-padded) -> 16384: d and idx "
          f"bit-equal to the plain version {equal}, on a repeat {repeat}")
    if not (equal and repeat):
        fail("nn_distance with zero-padded queries differs from its plain version")
    return {"fps": 0.0, "nn_distance": err}


def kitti_phase(torch, kernels, root: str, ckpt: str):
    """main_kitti (the working directory ``root`` holds a write_kitti_tree
    tree of KITTI_SCANS scans) with the full-width PCN checkpoint ``ckpt``,
    in f32 and in bf16: exact launches (3 batches of 12), the KITTI line, one
    PCD a scan. Then each batch through the eval function with the kernels,
    again, and under reference_ops(), default algorithms: per-sample
    |Δfidelity×10³| <= FIDELITY_GATE in f32; in bf16 mode within the gate or
    within the bf16 mode's own shift of that sample's plain fidelity from
    f32, where that is larger (a mean over a scan's few real points carries
    bf16's rounding: PERF.md §6); repeats bit-equal. Returns the
    launches, the eval function and the first batch."""
    from svdformer_pointsea_tpu_torch.cli import main_kitti
    from svdformer_pointsea_tpu_torch.configs import kitti_config
    from svdformer_pointsea_tpu_torch.data import Loader, make_dataset
    from svdformer_pointsea_tpu_torch.nn import mixed_precision
    from svdformer_pointsea_tpu_torch.render import make_renderer
    from svdformer_pointsea_tpu_torch.train import (build_model, init_state,
                                                    load_weights_into_state)
    from svdformer_pointsea_tpu_torch.train.evaluate import make_kitti_eval_fn

    launches = {}
    n_batches = -(-KITTI_SCANS // B_TRAIN)
    for precision in ("f32", "bf16"):
        out = os.path.join(root, f"out_{precision}")
        kernels.reset_launches()
        t0 = time.perf_counter()
        mean = main_kitti(["--weights", ckpt, "--out", out, "--precision", precision])
        torch.cuda.synchronize()
        got = dict(kernels.launches)
        want = {k: n_batches * v
                for k, v in (KITTI_BF16_EVAL if precision == "bf16" else KITTI_EVAL).items()}
        written = [f for f in os.listdir(os.path.join(out, "benchmark")) if f.endswith(".pcd")]
        print(f"main_kitti --precision {precision}: mean fidelity {mean:.6f} over "
              f"{KITTI_SCANS} scans, {len(written)} PCDs written, "
              f"{time.perf_counter() - t0:.1f} s; launches {got}")
        if got != want:
            fail(f"main_kitti {precision} launches {got}, expected {want}")
        if len(written) != KITTI_SCANS or not math.isfinite(mean):
            fail(f"main_kitti {precision}: {len(written)} PCDs, mean fidelity {mean}")
        launches[f"kitti_{precision}_eval"] = got
    cfg = kitti_config().replace(weights=ckpt)
    model = load_weights_into_state(init_state(cfg, build_model(cfg, seed=SEED)), cfg).model
    eval_fn = make_kitti_eval_fn(model, make_renderer(cfg))
    batches = list(Loader(make_dataset(cfg, "test", seed=cfg.seed), cfg.train.batch_size))
    rows = np.concatenate([b.data["partial_cloud"][:b.valid] for b in batches])
    real = (np.abs(rows).sum(-1) > 0).sum(1)
    print(f"KITTI scans: real points per scan {real.min()}-{real.max()} of {rows.shape[1]}, "
          f"{(real < rows.shape[1]).sum()} of {len(real)} zero-padded")
    plain_f32 = []  # the plain versions' f32 fidelity of each batch
    for precision in ("f32", "bf16"):
        worst, over, repeats = 0.0, 0.0, []
        with mixed_precision(precision == "bf16"):
            for bi, batch in enumerate(batches):
                partial = torch.as_tensor(batch.data["partial_cloud"], device="cuda")
                comp, f_k = eval_fn(partial)
                comp2, f_k2 = eval_fn(partial)
                repeats.append(torch.equal(comp, comp2) and torch.equal(f_k, f_k2))
                with kernels.reference_ops():
                    _, f_r = eval_fn(partial)
                f_k, f_r = f_k[:batch.valid].cpu() * 1e3, f_r[:batch.valid].cpu() * 1e3
                if not (torch.isfinite(f_k).all() and torch.isfinite(f_r).all()):
                    fail("non-finite KITTI fidelity")
                gap = (f_k - f_r).abs()
                if precision == "f32":
                    plain_f32.append(f_r)
                    bound = torch.full_like(gap, FIDELITY_GATE)
                else:  # the gate, or the bf16 mode's own shift of this sample from f32
                    bound = (f_r - plain_f32[bi]).abs().clamp_min(FIDELITY_GATE)
                worst = max(worst, gap.max().item())
                over = max(over, (gap / bound).max().item())
        print(f"kitti {precision} per-sample |Δfidelity×10³| kernels vs plain (default algorithms): "
              f"max {worst:.3e}, at most {over:.3f} of its bound (" + (
                  f"{FIDELITY_GATE}" if precision == "f32" else
                  f"{FIDELITY_GATE}, or the plain bf16 fidelity's own shift from f32 where larger")
              + f"); repeat of each batch bit-equal {repeats}")
        if not over <= 1.0:
            fail(f"kitti {precision} fidelity differs by {worst} (×10³) between kernels and plain")
        if not all(repeats):
            fail(f"a repeat of the kitti {precision} evaluation gave other bits")
    return launches, eval_fn, batches[0]


def complete_scans(rng: np.random.RandomState, root: str) -> str:
    """COMPLETE_SCANS one-sided crops of ellipsoids (semi-axes 0.2-0.45),
    300-5000 points each, away from the origin, as .pcd, .npy and .txt."""
    from svdformer_pointsea_tpu_torch.data import IO

    scans = os.path.join(root, "scans")
    os.makedirs(scans)
    for i in range(COMPLETE_SCANS):
        n = rng.randint(300, 5001)
        v = rng.randn(4 * n, 3)
        pts = v / np.linalg.norm(v, axis=1, keepdims=True) * rng.uniform(0.2, 0.45, size=3)
        cut = (pts[pts @ rng.randn(3) > 0][:n] + rng.uniform(-5, 5, size=3)).astype(np.float32)
        path = os.path.join(scans, f"scan{i}{('.pcd', '.npy', '.txt')[i % 3]}")
        (np.savetxt if path.endswith(".txt") else IO.put)(path, cut)
    return scans


def complete_phase(torch, kernels, root: str, ckpt: str):
    """main_pcn --complete on COMPLETE_SCANS scans (one batch) with the
    full-width PCN checkpoint: exact launches, one <stem>_completion.pcd a
    scan; each written completion against the plain versions' completion of
    the same resampled batch mapped back into its scan's frame (``/ scale +
    centroid``), within COMPLETE_ATOL in the PCN frame. Returns the launches,
    the call's seconds, the model and the batch."""
    from svdformer_pointsea_tpu_torch.cli import main_pcn
    from svdformer_pointsea_tpu_torch.configs import pcn_config
    from svdformer_pointsea_tpu_torch.data import read_pcd
    from svdformer_pointsea_tpu_torch.render import make_renderer
    from svdformer_pointsea_tpu_torch.train import (build_model, infer, init_state,
                                                    load_weights_into_state)

    scans = complete_scans(np.random.RandomState(SEED + 31), root)
    kernels.reset_launches()
    t0 = time.perf_counter()
    outs = main_pcn(["--complete", scans, "--weights", ckpt])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    print(f"main_pcn --complete ({COMPLETE_SCANS} scans of 300-5000 points, .pcd / .npy / .txt): "
          f"{len(outs)} completions written, {wall:.1f} s (model build and checkpoint load "
          f"included); launches {launches}")
    if launches != COMPLETE_LAUNCHES:
        fail(f"--complete launches {launches}, expected {COMPLETE_LAUNCHES}")
    cfg = pcn_config().replace(weights=ckpt)
    model = load_weights_into_state(init_state(cfg, build_model(cfg, seed=SEED)), cfg).model.eval()
    render = make_renderer(cfg)
    files = infer._collect_inputs(scans)
    if not len(outs) == len(files) == COMPLETE_SCANS:
        fail(f"--complete wrote {len(outs)} completions for {len(files)} scans")
    rng = np.random.RandomState(1)  # infer_files' default seed: the same draws, in file order
    frames, rows = [], []
    for f in files:
        xyz = infer._load_xyz(f)
        pts, centroid, scale = infer._to_pcn_frame(xyz)
        frames.append((xyz, centroid, scale))
        rows.append(infer._resample(pts, cfg.data.n_points, rng))
    batch = torch.as_tensor(np.stack(rows), device="cuda")
    with kernels.reference_ops(), torch.inference_mode():
        plain = model(batch, render.get_img(batch))[-1].cpu().numpy()
    worst, offsets = 0.0, []
    for out, (xyz, centroid, scale), comp in zip(outs, frames, plain):
        written = read_pcd(out)
        worst = max(worst, float(np.abs(written - (comp / scale + centroid)).max()) * scale)
        offsets.append(float(np.abs(written.mean(0) - xyz.mean(0)).max()))
    print(f"--complete completions in their scans' frames vs the plain versions' mapped back: max "
          f"|Δ| {worst:.3e} in the PCN frame (bound {COMPLETE_ATOL}); completion centroid - scan "
          f"centroid {min(offsets):.3f}-{max(offsets):.3f} per axis (random weights)")
    if not worst <= COMPLETE_ATOL:
        fail(f"--complete completions differ by {worst} from the plain versions'")
    return launches, wall, model, batch


def remaining_times(torch, kernels, eval_fn, kitti_batch, model, complete_batch) -> None:
    """KITTI completions/s at B 12 (render + forward + fidelity) in f32 and
    bf16 mode, and --complete's forward in scans/s, kernels and plain in
    turns (plain, kernels, kernels, plain; 5 calls after 1 warm-up)."""
    from svdformer_pointsea_tpu_torch.nn import mixed_precision
    from svdformer_pointsea_tpu_torch.render import make_renderer
    from svdformer_pointsea_tpu_torch.configs import pcn_config

    partial = torch.as_tensor(kitti_batch.data["partial_cloud"], device="cuda")
    render = make_renderer(pcn_config())

    def complete():
        with torch.inference_mode():
            model(complete_batch, render.get_img(complete_batch))

    for label, fn, n in (("kitti", lambda: eval_fn(partial), partial.shape[0]),
                         ("--complete forward", complete, complete_batch.shape[0])):
        for precision in ("f32", "bf16"):
            rates = {"kernels": [], "plain": []}
            with mixed_precision(precision == "bf16"):
                for mode in ("plain", "kernels", "kernels", "plain"):
                    ctx = kernels.reference_ops() if mode == "plain" else contextlib.nullcontext()
                    with ctx:
                        rates[mode].append(n * 1000.0 / cuda_ms(fn, iters=5, warmup=1))
            print(f"{label} {precision} {'completions' if label == 'kitti' else 'scans'}/s at "
                  f"B={n}: kernels " + ", ".join(f"{r:.2f}" for r in rates["kernels"])
                  + "; plain " + ", ".join(f"{r:.2f}" for r in rates["plain"]))


def emd_phase(torch) -> None:
    """The EMD auction on the card against the CPU: at the train point, B 8 x
    2048 on coordinates quantized to 2^-6, dist, assignment and the gradient
    of Σ w·dist bit-equal (and every budgeted iteration used where points are
    left unassigned); a permuted copy at B 2 x 8192 at the evaluation point
    converges with 0 unassigned in the CPU's iteration count. Prints the ms a
    call at both points."""
    from svdformer_pointsea_tpu_torch.ops import (earth_mover_distance, emd_convergence,
                                                  emd_unassigned)

    gen = torch.Generator().manual_seed(SEED + 32)
    x1 = torch.randint(0, 64, (B_MAIN, 2048, 3), generator=gen) / 64.0
    x2 = torch.randint(0, 64, (B_MAIN, 2048, 3), generator=gen) / 64.0
    w = torch.randint(-8, 8, (B_MAIN, 2048), generator=gen) / 8.0
    res = {}
    for dev in ("cuda", "cpu"):
        a = x1.detach().to(dev).requires_grad_(True)
        dist, assignment = earth_mover_distance(a, x2.to(dev), *EMD_TRAIN)
        (dist * w.to(dev)).sum().backward()
        res[dev] = (dist.detach().cpu(), assignment.cpu(), a.grad.cpu())
    equal = [torch.equal(c, p) for c, p in zip(res["cuda"], res["cpu"])]
    x1c, x2c = x1.cuda(), x2.cuda()
    _, _, used = emd_convergence(x1c, x2c, *EMD_TRAIN)
    unassigned = emd_unassigned(res["cpu"][1])
    full = int(used) == EMD_TRAIN[1] if int(unassigned.sum()) else True
    train_ms = [cuda_ms(lambda: emd_convergence(x1c, x2c, *EMD_TRAIN), iters=3, warmup=1)
                for _ in range(2)]
    print(f"EMD train point (eps {EMD_TRAIN[0]}, iters {EMD_TRAIN[1]}) B{B_MAIN}x2048 quantized, "
          f"card vs CPU: dist, assignment, gradient bit-equal {equal}; unassigned per sample "
          f"{unassigned.tolist()}, iterations used {int(used)} (all of the budget: {full}); "
          f"{', '.join(f'{t:.2f}' for t in train_ms)} ms a call on the card")
    if not (all(equal) and full):
        fail("the EMD auction on the card differs from the CPU")
    x = torch.rand(2, 8192, 3, generator=gen)
    perm = torch.stack([torch.randperm(8192, generator=gen) for _ in range(2)])
    y = x.gather(1, perm[..., None].expand(-1, -1, 3))
    xc, yc = x.cuda(), y.cuda()
    d_c, a_c, u_c = emd_convergence(xc, yc, *EMD_EVAL)
    d_p, a_p, u_p = emd_convergence(x, y, *EMD_EVAL)
    eval_ms = [cuda_ms(lambda: emd_convergence(xc, yc, *EMD_EVAL), iters=3, warmup=1)
               for _ in range(2)]
    ok = (int(emd_unassigned(a_c).max()) == 0 and int(u_c) == int(u_p)
          and torch.equal(a_c.cpu(), a_p) and torch.equal(a_c.cpu(), perm.argsort(1).int()))
    print(f"EMD evaluation point (eps {EMD_EVAL[0]}, iters {EMD_EVAL[1]}) permuted copy B2x8192: "
          f"unassigned {emd_unassigned(a_c).tolist()}, iterations used card {int(u_c)} / CPU "
          f"{int(u_p)}, sum of dist {d_c.sum().item():.3e}, assignment the inverse permutation "
          f"{ok}; {', '.join(f'{t:.2f}' for t in eval_ms)} ms a call on the card")
    if not ok:
        fail("the EMD auction did not converge on the permuted copy as on the CPU")


def pointnet2_phase(torch, ops, kernels) -> Dict[str, int]:
    """PointNet++ at its published widths, B 8 x 2048 quantized to 2^-6,
    eval mode, on the card against the same modules on the CPU: the SSG
    classification stack (SA 512 / 0.2 / 32 [64, 64, 128], SA 128 / 0.4 / 64
    [128, 128, 256], group-all [256, 512, 1024]), the MSG first layer (512,
    radii 0.1 / 0.2 / 0.4, 16 / 32 / 128 points, [32, 32, 64], [64, 64, 128],
    [64, 96, 128]), two FP modules back to 2048 points and the vanilla
    PointNet extractor (64, 128) -> 1024 with its per-point features. Every
    output within PN2_RTOL of its largest entry, the ball-query indices and
    the FPS centres bit-equal, K2 launched once a sampling module. Returns
    the launches."""
    import copy

    from svdformer_pointsea_tpu_torch.nn import (PointNetFeatureExtractor, PointNetFPModule,
                                                 PointNetSAModule, PointNetSAModuleMSG)

    torch.manual_seed(SEED + 33)
    radii, nsamples = (0.1, 0.2, 0.4), (16, 32, 128)
    mods = {
        "sa1": PointNetSAModule(512, 32, 0.2, 0, (64, 64, 128)),
        "sa2": PointNetSAModule(128, 64, 0.4, 128, (128, 128, 256)),
        "sa3": PointNetSAModule(None, None, None, 256, (256, 512, 1024), group_all=True),
        "msg": PointNetSAModuleMSG(512, radii, nsamples, 0,
                                   ((32, 32, 64), (64, 64, 128), (64, 96, 128))),
        "fp2": PointNetFPModule(256 + 128, (256, 256), use_points1=True),
        "fp1": PointNetFPModule(256, (256, 128)),
        "pointnet": PointNetFeatureExtractor(3, 1024, (64, 128), global_feat=False),
    }
    rng = np.random.RandomState(SEED + 33)
    xyz = torch.as_tensor((rng.randint(0, 64, size=(B_MAIN, 2048, 3)) / 64.0).astype(np.float32))

    def run(m, x):
        with torch.no_grad():
            l1_xyz, l1 = m["sa1"](x, None)
            l2_xyz, l2 = m["sa2"](l1_xyz, l1)
            _, l3 = m["sa3"](l2_xyz, l2)
            m_xyz, m_feat = m["msg"](x, None)
            f2 = m["fp2"](l1_xyz, l2_xyz, l1, l2)
            f1 = m["fp1"](x, l1_xyz, None, f2)
            pn = m["pointnet"](x)
        return {"sa1": l1, "sa2": l2, "sa3": l3, "msg": m_feat, "fp2": f2, "fp1": f1,
                "pointnet": pn, "sa1 centres": l1_xyz, "sa2 centres": l2_xyz,
                "msg centres": m_xyz}

    cpu = {k: copy.deepcopy(v).eval() for k, v in mods.items()}
    card = {k: v.cuda().eval() for k, v in mods.items()}
    x = xyz.cuda()
    kernels.reset_launches()
    got = run(card, x)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    want = run(cpu, xyz)
    worst = {k: (got[k].cpu() - want[k]).abs().max().item() / want[k].abs().max().item()
             for k in ("sa1", "sa2", "sa3", "msg", "fp2", "fp1", "pointnet")}
    centres = all(torch.equal(got[k].cpu(), want[k]) for k in
                  ("sa1 centres", "sa2 centres", "msg centres"))
    plain = torch.equal(got["sa1 centres"], ops.gather_points(
        x, ops.furthest_point_sample_ref(x, 512)))
    sites = [(0.2, 32, "sa1", None), (0.4, 64, "sa2", "sa1 centres")] + [
        (r, k, "msg", None) for r, k in zip(radii, nsamples)]
    balls = []
    for r, k, centres_of, src in sites:
        pts_c, pts_p = (x, xyz) if src is None else (got[src], want[src])
        key = centres_of + " centres"
        balls.append(torch.equal(ops.ball_query(r, k, pts_c, got[key]).cpu(),
                                 ops.ball_query(r, k, pts_p, want[key])))
    with torch.no_grad():
        ms = cuda_ms(lambda: run(card, x), iters=3, warmup=1)
    print(f"PointNet++ B{B_MAIN}x2048 (published widths) card vs CPU: max |Δ| / max|ref| "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()) + f" (bound {PN2_RTOL}); FPS "
          f"centres bit-equal {centres} (K2 vs plain on the card {plain}); ball-query indices "
          f"bit-equal {balls}; launches {launches}; {ms:.2f} ms for the whole set on the card")
    if not (max(worst.values()) <= PN2_RTOL and centres and plain and all(balls)):
        fail("PointNet++ modules on the card differ from the CPU")
    if {k: v for k, v in launches.items() if v} != PN2_LAUNCHES:
        fail(f"PointNet++ launches {launches}, expected {PN2_LAUNCHES}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; nothing was run", file=sys.stderr)
        return 1
    if not (REPO / "svdformer_pointsea_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port's package is not beside {__file__}; nothing was run",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from svdformer_pointsea_tpu_torch import kernels, ops
    from svdformer_pointsea_tpu_torch.configs import (geospec_config, pcn_config,
                                                      pointsea_config, shapenet55_config)
    from svdformer_pointsea_tpu_torch.nn import flash, mixed_precision
    from svdformer_pointsea_tpu_torch.render import make_renderer
    from svdformer_pointsea_tpu_torch.data.synthetic import write_kitti_tree
    from svdformer_pointsea_tpu_torch.train import (build_model, init_state, make_train_step,
                                                    save_checkpoint)
    from svdformer_pointsea_tpu_torch.train.evaluate import disable_tf32

    t_start = time.perf_counter()
    smi = smi_line()
    print(smi)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    disable_tf32()
    scratch = tempfile.TemporaryDirectory()
    ptxas = ptxas_report_start(kernels, scratch.name)
    print(f"kernel build: {kernels.build():.1f} s")

    g = torch.Generator(device="cuda").manual_seed(SEED)
    max_err = kernel_phase(torch, ops, flash, g)
    max_err.update(bf16_kernel_phase(torch, kernels, flash, g))
    ptxas_report_print(kernels, ptxas)
    points_report(kernels, ptxas)
    scratch.cleanup()
    sass_report(kernels)

    # Evaluation main path: eval_pcn on a full-width PCN SVDFormer.
    cfg = pcn_config()
    model = build_model(cfg, seed=SEED).eval()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"SVDFormer (PCN, step {cfg.network.step1}/{cfg.network.step2}, merge "
          f"{cfg.network.merge_points}, local {cfg.network.local_points}, render "
          f"{cfg.network.resolution}²): {n_params / 1e6:.2f} M parameters")
    batches = synthetic_batches(np.random.RandomState(SEED))
    eval_launches, eval_fn = eval_phase(torch, kernels, cfg, model, batches)
    paths = {"eval": eval_launches}

    # Train main path: make_train_step on full-width models from build_model,
    # in f32 and in bf16 mode.
    train_batch = synthetic_batches(np.random.RandomState(SEED + 1), n_batches=1,
                                    bs=cfg.train.batch_size, n_partial=cfg.data.n_points)[0]
    paths["train_step"], m_f32 = train_phase(torch, kernels, cfg, train_batch)
    torch.cuda.empty_cache()
    paths["bf16_train_step"], m_bf16 = bf16_train_phase(torch, kernels, cfg, train_batch)
    torch.cuda.empty_cache()
    print("bf16 vs f32 train step 1 from one initial state (kernels): " + ", ".join(
        f"{key} {m_bf16[key].item():.8f} vs {m_f32[key].item():.8f} (rel shift "
        f"{(m_bf16[key] / m_f32[key] - 1).item():+.3e})" for key in ("loss", "cdc", "cd1", "cd2")))

    # The entry point: main_pcn --precision bf16 on a synthetic PCN tree.
    entry = entry_point_phase(torch, kernels)
    paths.update(entry)
    torch.cuda.empty_cache()

    # Timing: eval completions/s at B = 8 and train ms/step at B = 12, in f32
    # and in bf16 mode, kernels and plain in turns.
    partial = torch.as_tensor(batches[0].data["partial_cloud"], device="cuda")
    gt = torch.as_tensor(batches[0].data["gtcloud"], device="cuda")
    step_ms = {}
    for precision in ("f32", "bf16"):
        with mixed_precision(precision == "bf16"):
            rates = {"kernels": [], "plain": []}
            for mode in ("plain", "kernels", "kernels", "plain"):
                ctx = kernels.reference_ops() if mode == "plain" else contextlib.nullcontext()
                with ctx:
                    ms = cuda_ms(lambda: eval_fn(partial, gt), iters=5, warmup=1)
                rates[mode].append(B_MAIN * 1000.0 / ms)
            print(f"{precision} eval completions/s at B=8 (render + forward + CD/DCD/F1): "
                  "kernels " + ", ".join(f"{r:.2f}" for r in rates["kernels"]) + "; plain "
                  + ", ".join(f"{r:.2f}" for r in rates["plain"]))
            kernel_profile(torch, lambda: eval_fn(partial, gt), f"{precision} eval")
    del model, eval_fn
    for precision in ("f32", "bf16"):
        label = "train" if precision == "f32" else "bf16 train"
        tmodel = build_model(cfg, seed=SEED)
        tstate = init_state(cfg, tmodel)
        tstep = make_train_step(tmodel, tstate.optimizer, cfg.train.sqrt_loss,
                                make_renderer(cfg).get_img)
        weights = torch.zeros(B_TRAIN, device="cuda")
        weights[:train_batch.valid] = 1.0
        run = (tmodel, tstate, tstep) + tuple(
            torch.as_tensor(x, device="cuda") for x in (train_batch.data["partial_cloud"],
                                                        train_batch.data["gtcloud"])) + (weights,)
        with mixed_precision(precision == "bf16"):
            step_ms[precision] = train_times(torch, kernels, run, label)
            kernel_profile(torch, lambda: tstep(tstate, *run[3:], 1e-6), label)
        del run, tmodel, tstate, tstep
        torch.cuda.empty_cache()

    times = kernel_times(torch, ops, flash, kernels, g)
    for sfx, precision in (("", "f32"), ("_bf16", "bf16")):
        attn = sum(times[n + sfx]["ms"] for n in ("flash_attn_stats", "flash_attn_bwd_dq",
                                                  "flash_attn_bwd_dkv"))
        mean_step = sum(step_ms[precision]["kernels"]) / len(step_ms[precision]["kernels"])
        print(f"{precision}: K3+stats + K5 + K4 per training batch: {attn:.3f} ms, "
              f"{100 * attn / mean_step:.1f} % of the {mean_step:.2f} ms kernel train step")
    # The ShapeNet-55 track: K1 and K2 at its sites, the f32 and bf16 train
    # steps, eval_55, the adversarial step, main_55, its timings.
    t55 = time.perf_counter()
    cfg55 = shapenet55_config()
    for name, e in points_55_phase(torch, ops, kernels, g).items():
        max_err[name] = max(max_err[name], e)
    batch55 = batch_55(torch, SEED + 20)
    paths["55_train_step"], _ = train_55_phase(torch, kernels, cfg55, batch55, "f32")
    torch.cuda.empty_cache()
    paths["55_bf16_train_step"], _ = train_55_phase(torch, kernels, cfg55, batch55, "bf16")
    torch.cuda.empty_cache()
    model55 = build_model(cfg55, seed=SEED).eval()
    print(f"SVDFormer (ShapeNet-55, step {cfg55.network.step1}/{cfg55.network.step2}, merge "
          f"{cfg55.network.merge_points}, local {cfg55.network.local_points}, decoder "
          f"{cfg55.network.decoder}, gt {cfg55.data.gt_points}): "
          f"{sum(p.numel() for p in model55.parameters()) / 1e6:.2f} M parameters")
    eval_gt = torch.as_tensor(ellipsoids_55(np.random.RandomState(SEED + 21)), device="cuda")
    paths["55_eval"] = eval_55_phase(torch, kernels, cfg55, model55, eval_gt, "f32",
                                     ("easy", "median", "hard"))
    paths["55_bf16_eval"] = eval_55_phase(torch, kernels, cfg55, model55, eval_gt, "bf16",
                                          ("easy",))
    del model55
    torch.cuda.empty_cache()
    adv_cfg = shapenet55_config(adv=True)
    paths["55_adv_step"] = adv_55_phase(torch, kernels, adv_cfg, batch55)
    torch.cuda.empty_cache()
    paths.update(entry_55_phase(torch, kernels))
    torch.cuda.empty_cache()
    points55 = times_55(torch, ops, kernels, cfg55, batch55, eval_gt, g)
    print(f"ShapeNet-55 part: {time.perf_counter() - t55:.1f} s")
    del batch55, eval_gt
    torch.cuda.empty_cache()

    # GeoSpecNet and its GAN trainer on PCN data: the f32 and bf16 GAN steps,
    # an eval batch, main_geospec, the timings.
    tgeo = time.perf_counter()
    cfg_geo = geospec_config()
    weights = torch.zeros(B_TRAIN, device="cuda")
    weights[:train_batch.valid] = 1.0
    gan_batch = tuple(torch.as_tensor(train_batch.data[k], device="cuda")
                      for k in ("partial_cloud", "gtcloud")) + (weights,)
    paths["geospec_gan_step"], gstate = geospec_gan_phase(torch, kernels, cfg_geo, gan_batch, "f32")
    print(f"GeoSpecNet (PCN, spectral point encoder, SDG decoders): "
          f"{sum(p.numel() for p in gstate.model.parameters()) / 1e6:.2f} M parameters; "
          f"PointDiscriminator {sum(p.numel() for p in gstate.d_model.parameters())}")
    del gstate
    torch.cuda.empty_cache()
    paths["geospec_bf16_gan_step"], _ = geospec_gan_phase(torch, kernels, cfg_geo, gan_batch, "bf16")
    torch.cuda.empty_cache()
    geo_model = build_model(cfg_geo, seed=SEED).eval()
    paths["geospec_eval"], geo_eval_fn = geospec_eval_phase(torch, kernels, cfg_geo, geo_model,
                                                            batches[0])
    paths.update(geospec_entry_phase(torch, kernels))
    torch.cuda.empty_cache()
    geospec_times(torch, kernels, cfg_geo, gan_batch, geo_eval_fn, batches[0])
    del geo_model, geo_eval_fn
    print(f"GeoSpecNet part: {time.perf_counter() - tgeo:.1f} s")
    torch.cuda.empty_cache()

    # PointSea on PCN data: the realistic render on the card vs the CPU, the
    # eval path and the f32 and bf16 train steps, main_pointsea, the timings.
    tps = time.perf_counter()
    cfg_ps = pointsea_config()
    pointsea_render_phase(torch, train_batch)
    ps_model = build_model(cfg_ps, seed=SEED).eval()
    print(f"PointSea (PCN, step {cfg_ps.network.step1}/{cfg_ps.network.step2}, merge "
          f"{cfg_ps.network.merge_points}, local {cfg_ps.network.local_points}, ResNet-18 on "
          f"224² renders): {sum(p.numel() for p in ps_model.parameters()) / 1e6:.2f} M "
          f"parameters, of which ResNet-18 "
          f"{sum(p.numel() for p in ps_model.encoder.img_trunk.parameters()) / 1e6:.2f} M")
    ps_batches = batches[:2]
    paths["pointsea_eval"], ps_eval_fn = pointsea_eval_phase(torch, kernels, cfg_ps, ps_model,
                                                             ps_batches, "f32")
    paths["pointsea_bf16_eval"], _ = pointsea_eval_phase(torch, kernels, cfg_ps, ps_model,
                                                         ps_batches, "bf16")
    torch.cuda.empty_cache()
    for precision in ("f32", "bf16"):
        key = "pointsea_train_step" if precision == "f32" else "pointsea_bf16_train_step"
        paths[key], _ = pointsea_train_phase(torch, kernels, cfg_ps, gan_batch, precision)
        torch.cuda.empty_cache()
    paths.update(pointsea_entry_phase(torch, kernels))
    torch.cuda.empty_cache()
    pointsea_times(torch, kernels, cfg_ps, gan_batch, ps_eval_fn, batches[0])
    del ps_model, ps_eval_fn
    print(f"PointSea part: {time.perf_counter() - tps:.1f} s")
    torch.cuda.empty_cache()

    # The remaining surfaces: K2 / K1 on KITTI's zero-padded scans, main_kitti
    # and main_pcn --complete with a full-width PCN checkpoint, the EMD
    # auction, PointNet++'s modules, the timings.
    trest = time.perf_counter()
    for name, e in kitti_points_phase(torch, ops, kernels, g).items():
        max_err[name] = max(max_err[name], e)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as root:
        write_kitti_tree(root, np.random.RandomState(SEED + 30), KITTI_SCANS)
        ckpt = os.path.join(root, "svdformer-pcn-seed.pt")
        save_checkpoint(ckpt, init_state(cfg, build_model(cfg, seed=SEED)), 1, 0.0)
        os.chdir(root)
        try:
            kitti, kitti_eval_fn, kitti_batch = kitti_phase(torch, kernels, root, ckpt)
            paths.update(kitti)
            paths["complete"], _, c_model, c_batch = complete_phase(torch, kernels, root, ckpt)
        finally:
            os.chdir(cwd)
    remaining_times(torch, kernels, kitti_eval_fn, kitti_batch, c_model, c_batch)
    del kitti_eval_fn, c_model, c_batch
    torch.cuda.empty_cache()
    emd_phase(torch)
    paths["pointnet2"] = pointnet2_phase(torch, ops, kernels)
    print(f"Remaining-surfaces part: {time.perf_counter() - trest:.1f} s")

    report = {"kernels": []}
    for name in kernels.KERNEL_NAMES:
        t = times[name]
        by_path = {path: counts[name] for path, counts in paths.items()}
        report["kernels"].append({
            "name": name, "route": "cuda", "source": SOURCES[name][0], "replaces": SOURCES[name][1],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max_err[name], "ms": round(t["ms"], 4),
            "plain_ms": round(t["plain_ms"], 4), "bound_ms": round(t["bound_ms"], 4),
            "bound_by": "operations" if t["ops_ms"] >= t["bytes_ms"] else "bytes",
            "library_ms": None if t["library_ms"] is None else round(t["library_ms"], 4),
            "per": (f"eval batch of {B_MAIN}" if name.startswith("flash_attn")
                    and "_stats" not in name and "_bwd" not in name
                    else f"training batch of {B_TRAIN}"),
        })
        if "library_device_ms" in t:  # its and SDPA's device times (CUDA graph)
            report["kernels"][-1].update({key: round(t[key], 4) for key in
                                          ("device_ms", "wrapper_device_ms", "library_device_ms")
                                          if key in t})
        elif "device_ms" in t:  # K1, K2 and the split pass: no library call
            report["kernels"][-1]["device_ms"] = round(t["device_ms"], 4)
        if name in points55["55 train"]:  # K1, K2 per 55 train batch of 16
            r55 = points55["55 train"][name]
            report["kernels"][-1]["per_55_train_batch"] = {
                key: round(r55[key], 4) for key in ("ms", "plain_ms", "device_ms")}
    for row in report["kernels"]:
        if not all(math.isfinite(row[k]) for k in ("max_abs_err", "ms", "plain_ms", "bound_ms")):
            fail(f"non-finite measurement in {row}")
        if row["launches"] == 0:
            fail(f"kernel {row['name']} was launched on no main path")
    print(f"chip_smoke wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(report))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
