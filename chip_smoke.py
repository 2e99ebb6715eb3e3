#!/usr/bin/env python3
"""Drive the PyTorch port's PCN evaluation path and PCN train step on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
1. build the hand-written kernels from ``svdformer_pointsea_tpu_torch/csrc``
   (one nvcc per source, in parallel);
2. hold each kernel against its plain PyTorch version on the card (B = 4):
   K1 / K2 / K3 at the evaluation shapes plus FPS's quirk inputs; at every
   training attention site K3 with its row statistics against the plain
   forward, K5 (dQ) and K4 (dK, dV) through the flash Function against
   autograd through the naive math and against their own second run (bit
   for bit: no atomics), and a bf16 input refused;
3. evaluation main path: ``eval_pcn`` on a full-width PCN SVDFormer (random
   weights from a seeded generator) over 3 synthetic batches of 8, with the
   launch counters zeroed just before and read just after; every kernel of
   the path must have launched. The same batches run under
   ``reference_ops()`` (plain versions only); per-sample CD-L1×10³ must agree
   within 0.01;
4. train main path: two full-width models from ``build_model`` (seed 0) take
   one ``make_train_step`` step on one synthetic batch of 12 (3 pad rows),
   one with the kernels (counters zeroed before, read after: K1, K2, K3 with
   statistics, K4 and K5 must all have launched) and one under
   ``reference_ops()``, both with PyTorch's deterministic algorithms; loss
   and parts must agree within 1e-4 relative and Adam's first moment per
   parameter within 1e-3 relative (L2; parameters whose exact gradient is 0
   hold noise below 1e-6). Then 5 more steps at the schedule's LR: finite
   losses, moved BN running statistics;
5. timing (CUDA events, kernels and plain ops in turns): eval completions/s
   at B = 8, train ms/step and peak memory at B = 12, each kernel against its
   plain version and its bound (per training batch of 12, and K1-K3 per
   evaluation batch of 8; the attention kernels beside
   ``scaled_dot_product_attention`` forward / backward as a yardstick), and a
   profiler breakdown of the train step by kernel family.

Prints the card's name and power limit, a ``{"kernels": [...]}`` JSON line, and
as its last line ``{"ok": true, "device": {...}}``. Exits non-zero without a
result when no CUDA device is visible or the repository is missing.
"""

from __future__ import annotations

import contextlib
import json
import math
import re
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path
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
# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3.
F32_FLOPS = 67e12
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
EVAL_KERNELS = ("nn_distance", "fps", "flash_attn")
TRAIN_KERNELS = ("nn_distance", "fps", "flash_attn_stats", "flash_attn_bwd_dkv",
                 "flash_attn_bwd_dq")
SOURCES = {  # kernel -> (source in the repo, the TPU kernel it replaces)
    "nn_distance": ("svdformer_pointsea_tpu_torch/csrc/nn_distance.cu",
                    "svdformer_pointsea_tpu/ops/nn_pallas.py:59"),
    "fps": ("svdformer_pointsea_tpu_torch/csrc/fps.cu", "svdformer_pointsea_tpu/ops/fps.py:68"),
    "flash_attn": ("svdformer_pointsea_tpu_torch/csrc/flash_attn.cu",
                   "svdformer_pointsea_tpu/nn/flash_vjp.py:153"),
    "flash_attn_stats": ("svdformer_pointsea_tpu_torch/csrc/flash_attn.cu",
                         "svdformer_pointsea_tpu/nn/flash_vjp.py:160"),
    "flash_attn_bwd_dkv": ("svdformer_pointsea_tpu_torch/csrc/flash_attn_bwd.cu",
                           "svdformer_pointsea_tpu/nn/flash_vjp.py:171"),
    "flash_attn_bwd_dq": ("svdformer_pointsea_tpu_torch/csrc/flash_attn_bwd.cu",
                          "svdformer_pointsea_tpu/nn/flash_vjp.py:49"),
}
# Device-kernel name patterns of the train step's profile, first match wins.
PROFILE_FAMILIES = [
    ("K3 flash forward", r"flash_fwd_kernel"),
    ("K4 flash dK/dV", r"flash_bwd_dkv_kernel"),
    ("K5 flash dQ", r"flash_bwd_dq_kernel"),
    ("K1 NN distance", r"nn_one_way_kernel"),
    ("K2 FPS", r"fps_kernel"),
    ("Adam (foreach)", r"multi_tensor|adam"),
    ("gather / scatter / index", r"index|scatter|gather"),
    ("reductions / norms / softmax", r"reduce|norm|softmax|topk|sort|radix"),
    ("elementwise", r"elementwise"),
    ("convolutions (cuDNN)", r"conv|cudnn|dgrad|wgrad|fprop|winograd|implicit"),
    ("GEMMs (cuBLAS f32)", r"gemm|cutlass|xmma|splitk"),
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


def bound_ms(ops: float, nbytes: float) -> float:
    """Least time (ms) for ``ops`` f32 operations and ``nbytes`` of device
    memory traffic on an H100 SXM."""
    return 1e3 * max(ops / F32_FLOPS, nbytes / HBM_BYTES_S)


_ATTN_FLOPS = {"flash_attn": 4, "flash_attn_stats": 4, "flash_attn_bwd_dq": 6,
               "flash_attn_bwd_dkv": 8}


def attention_work(b: int, h: int, lq: int, lk: int, dh: int, kernel: str):
    """(operations, bytes) of one attention kernel call: 4 (K3), 6 (K5) or 8
    (K4) x B h Lq Lk dh flops; each operand read once, each output written once."""
    qd, kd, rows = b * h * lq * dh, b * h * lk * dh, b * h * lq
    values = {"flash_attn": 2 * qd + 2 * kd,                 # q, k, v -> o
              "flash_attn_stats": 2 * qd + 2 * kd + rows,    # ... and lse
              "flash_attn_bwd_dq": 3 * qd + 2 * kd + 2 * rows,   # q, do, k, v, lse, di -> dq
              "flash_attn_bwd_dkv": 2 * qd + 4 * kd + 2 * rows}  # ... -> dk, dv
    return _ATTN_FLOPS[kernel] * b * h * lq * lk * dh, 4 * values[kernel]


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


def first_moment_gap(torch, run, ref, check: bool):
    from svdformer_pointsea_tpu_torch.nn import has_zero_gradient

    """Worst relative L2 gap of Adam's first moment per parameter between two
    runs of one step, and the largest |mu| among zero-gradient parameters;
    with ``check``, fails beyond MU_RTOL / NOISE_MU."""
    (model, state, _), (model_r, state_r, _) = run, ref
    worst, worst_noise = (0.0, ""), (0.0, "")
    params_r = dict(model_r.named_parameters())
    for name, p in model.named_parameters():
        mu = state.optimizer.state[p]["exp_avg"]
        mu_r = state_r.optimizer.state[params_r[name]]["exp_avg"]
        if has_zero_gradient(name):
            noise = max(mu.abs().max().item(), mu_r.abs().max().item())
            worst_noise = max(worst_noise, (noise, name))
            if check and not noise <= NOISE_MU:
                fail(f"first moment of {name} (exact gradient 0) is {noise}")
            continue
        diff, norm = torch.linalg.norm(mu - mu_r).item(), torch.linalg.norm(mu_r).item()
        worst = max(worst, (diff / max(norm, 1e-30), name))
        if check and not diff <= MU_RTOL * norm + MU_ATOL:
            fail(f"Adam first moment of {name}: ‖Δ‖ {diff} vs ‖ref‖ {norm}")
    return worst, worst_noise


def kernel_phase(torch, ops, flash, g) -> Dict[str, float]:
    """Kernel vs plain version at the evaluation and training shapes, B = 4.
    Returns the max abs error per kernel."""
    dev = "cuda"
    err = {}

    err["nn_distance"] = 0.0
    for n, m in sorted(set(NN_SITES)):
        a = torch.rand(4, n, 3, device=dev, generator=g) - 0.5
        b = torch.rand(4, m, 3, device=dev, generator=g) - 0.5
        d, i = ops.nn_one_way(a, b)
        torch.cuda.synchronize()
        dp, _ = ops.nn_one_way_plain(a, b)
        chosen = b.gather(1, i.long()[..., None].expand(-1, -1, 3))
        d_at_idx = ((a - chosen) ** 2).sum(-1)
        e = max((d - dp).abs().max().item(), (d_at_idx - dp).abs().max().item())
        print(f"K1 nn_distance {n}->{m}: max|Δd| {e:.3e} (argmin checked by distance)")
        if not e <= NN_TOL:
            fail(f"nn_distance {n}->{m} differs by {e}")
        err["nn_distance"] = max(err["nn_distance"], e)

    fps_cases = []
    for n, m in [(2048, 512), (2304, 512), (512, 128), (16384, 2048), (2048, 256)]:
        fps_cases.append((f"{n}->{m}", torch.rand(4, n, 3, device=dev, generator=g) - 0.5, m))
    quirk = torch.rand(4, 2048, 3, device=dev, generator=g) + 0.5
    quirk[0, 10:400] = 0.0  # near-origin points are never picked
    quirk[0, 400:410] = 0.01
    quirk[1] = 0.0  # all-invalid row: every pick falls back to 0
    quirk[2, 1000:] = quirk[2, :1048].clone()  # duplicated points: ties
    quirk[3] = torch.round(quirk[3] * 4) / 4  # a coarse grid: many equal distances
    fps_cases.append(("quirks 2048->512", quirk, 512))
    err["fps"] = 0.0
    for name, x, m in fps_cases:
        i = ops.furthest_point_sample(x, m)
        torch.cuda.synchronize()
        ip = ops.furthest_point_sample_ref(x, m)
        bad = int((i != ip).sum().item())
        print(f"K2 fps {name}: {bad} index mismatches")
        if bad:
            fail(f"fps {name}: {bad} indices differ")
        err["fps"] = max(err["fps"], float((i - ip).abs().max().item()))
    picked = ops.furthest_point_sample(quirk, 512)
    if bool((picked[0, 1:, None] == torch.arange(10, 410, device=dev)).any()) or bool(picked[1].any()):
        fail("fps quirk semantics (origin skip / all-invalid fallback) broken")

    err["flash_attn"] = 0.0
    for lq, lk, dh in sorted(set(FLASH_SITES)) + [(512, 512, 256), (2048, 2048, 256)]:
        q, k, v = (torch.randn(4, n_, 8, dh, device=dev, generator=g) for n_ in (lq, lk, lk))
        o = flash.flash_attention(q, k, v)
        torch.cuda.synchronize()
        e = (o - flash.naive_attention(q, k, v)).abs().max().item()
        print(f"K3 flash_attn Lq {lq} Lk {lk} dh {dh}: max|Δ| {e:.3e}")
        if not e <= FLASH_TOL:
            fail(f"flash_attn ({lq}, {lk}, {dh}) differs by {e}")
        err["flash_attn"] = max(err["flash_attn"], e)

    # Training: K3 with statistics, then K5 / K4 through the Function's backward.
    for name in ("flash_attn_stats", "flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
        err[name] = 0.0
    for lq, lk, dh in sorted(set(FLASH_SITES)):
        q, k, v, do = (torch.randn(4, n_, 8, dh, device=dev, generator=g)
                       for n_ in (lq, lk, lk, lq))
        o, lse = flash._flash_kernel(q, k, v, stats=True)
        torch.cuda.synchronize()
        o_p, lse_p = flash.attention_fwd_plain(q, k, v)
        e3 = max((o - o_p).abs().max().item(), (lse - lse_p).abs().max().item())
        ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
        got = torch.autograd.grad(flash.flash_attention_train(*ins), ins, do)
        again = torch.autograd.grad(flash.flash_attention_train(*ins), ins, do)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"K4 / K5 at ({lq}, {lk}, {dh}) gave two answers for one input")
        ref_ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
        want = torch.autograd.grad(flash.naive_attention(*ref_ins), ref_ins, do)
        line = f"K3+stats/K5/K4 Lq {lq} Lk {lk} dh {dh}: O, lse max|Δ| {e3:.3e}"
        if not e3 <= FLASH_TOL:
            fail(f"flash_attn_stats ({lq}, {lk}, {dh}) differs by {e3}")
        err["flash_attn_stats"] = max(err["flash_attn_stats"], e3)
        for gname, kname, a, b in (("dq", "flash_attn_bwd_dq", got[0], want[0]),
                                   ("dk", "flash_attn_bwd_dkv", got[1], want[1]),
                                   ("dv", "flash_attn_bwd_dkv", got[2], want[2])):
            e = (a - b).abs().max().item()
            excess = ((a - b).abs() - FLASH_BWD_TOL * b.abs()).max().item()
            line += f"; {gname} max|Δ| {e:.3e}"
            if not excess <= FLASH_BWD_TOL:
                fail(f"{gname} at ({lq}, {lk}, {dh}) outside atol/rtol {FLASH_BWD_TOL}: {excess}")
            err[kname] = max(err[kname], e)
        print(line)
        del ins, ref_ins, got, again, want
    bf = [x.to(torch.bfloat16).requires_grad_(True) for x in (q, k, v)]
    try:
        flash.flash_attention_train(*bf)
    except ValueError as e:
        print(f"bf16 into the flash Function refused: {e}")
    else:
        fail("a bf16 CUDA input to the flash Function did not raise")
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
    worst = 0.0
    for batch in batches:
        partial = torch.as_tensor(batch.data["partial_cloud"], device="cuda")
        gt = torch.as_tensor(batch.data["gtcloud"], device="cuda")
        m_k = eval_fn(partial, gt)[:, :batch.valid].cpu()
        with kernels.reference_ops():
            m_r = eval_fn(partial, gt)[:, :batch.valid].cpu()
        if not (torch.isfinite(m_k).all() and torch.isfinite(m_r).all()):
            fail("non-finite CD / DCD / F1")
        worst = max(worst, (m_k[0] - m_r[0]).abs().max().item())
    print(f"per-sample |ΔCD-L1×10³| kernels vs plain: max {worst:.3e} (gate {CD_GATE})")
    if not worst <= CD_GATE:
        fail(f"CD-L1×10³ differs by {worst} between kernels and plain ops")

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
    reference_ops() from the same initial state, then 5 more kernel steps."""
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

    # Both steps run with PyTorch's deterministic algorithms (index_add_
    # without atomics in the render and the chamfer backward, deterministic
    # cuDNN), so that the kernels' sum order is the only difference between
    # them: with atomics, two kernel runs alone can differ by more than the
    # bound in a first-moment leaf (the run-to-run noise printed below).
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
    worst, worst_noise = first_moment_gap(torch, runs["kernels"], runs["plain"], check=True)
    print(f"Adam first moment kernels vs plain: worst leaf {worst[1]} rel ‖Δ‖ {worst[0]:.3e} "
          f"(bound {MU_RTOL}); zero-gradient leaves max |mu| {worst_noise[0]:.3e} "
          f"({worst_noise[1]})")
    model_a, state_a, step_a = runs["kernels, atomics"]
    step_a(state_a, partial, gt, weights, lr)
    noise, _ = first_moment_gap(torch, runs["kernels, atomics"], runs["kernels"], check=False)
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
    return launches, (model_k, state_k, step_k, partial, gt, weights)


def kernel_times(torch, ops, flash, kernels, g) -> Dict[str, Dict[str, float]]:
    """Kernel, plain and library time (ms) and bound summed over the calls one
    training batch of 12 makes (K1, K2, K3 with statistics, K4, K5) or one
    evaluation batch of 8 (K3 without statistics, the only kernel that runs
    in evaluation alone), each call shape timed on its own. The library
    yardstick is scaled_dot_product_attention on its memory-efficient (f32)
    backend, on the same tensors."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def sdpa(*a):
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(*a)

    dev = "cuda"
    out = {name: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0,
                  "library_ms": None} for name in kernels.KERNEL_NAMES}

    def add(name, k_ms, p_ms, ops, nbytes, lib_ms=None):
        r = out[name]
        r["ms"] += k_ms
        r["plain_ms"] += p_ms
        r["bound_ms"] += bound_ms(ops, nbytes)
        r["ops_ms"] += 1e3 * ops / F32_FLOPS
        r["bytes_ms"] += 1e3 * nbytes / HBM_BYTES_S
        if lib_ms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + lib_ms

    def both(fn, iters):
        k_ms = cuda_ms(fn, iters)
        with kernels.reference_ops():
            p_ms = cuda_ms(fn, max(1, iters // 2), warmup=1)
        return k_ms, p_ms

    # K1 and K2: per training batch of 12 (the step's sites) for the report,
    # and per evaluation batch of 8 printed beside it.
    for bs, nn_sites, fps_sites, per in ((B_MAIN, NN_SITES, FPS_SITES, "eval"),
                                         (B_TRAIN, NN_TRAIN_SITES, FPS_TRAIN_SITES, "train")):
        sums = {"nn_distance": [0.0, 0.0], "fps": [0.0, 0.0]}
        for n, m in nn_sites:
            a = torch.rand(bs, n, 3, device=dev, generator=g) - 0.5
            b = torch.rand(bs, m, 3, device=dev, generator=g) - 0.5
            k_ms, p_ms = both(lambda: ops.nn_one_way(a, b), 10)
            sums["nn_distance"][0] += k_ms
            sums["nn_distance"][1] += p_ms
            if per == "train":  # 3 sub, 3 mul, 2 add, 1 compare a pair; clouds in, d, idx out
                add("nn_distance", k_ms, p_ms, 9 * bs * n * m, 12 * bs * (n + m) + 8 * bs * n)
            print(f"time K1 nn_distance B{bs} {n}->{m}: {k_ms:.4f} ms, plain {p_ms:.4f} ms")
        for n, m in fps_sites:
            x = torch.rand(bs, n, 3, device=dev, generator=g) - 0.5
            k_ms, p_ms = both(lambda: ops.furthest_point_sample(x, m), 10 if n < 16384 else 4)
            sums["fps"][0] += k_ms
            sums["fps"][1] += p_ms
            if per == "train":  # per round and point: 8 for the distance, 1 min, 1 argmax compare
                add("fps", k_ms, p_ms, 10 * bs * n * m, 12 * bs * n + 4 * bs * m)
            print(f"time K2 fps B{bs} {n}->{m}: {k_ms:.4f} ms, plain {p_ms:.4f} ms")
        for name, (k_ms, p_ms) in sums.items():
            print(f"time {name} per {per} batch of {bs}: {k_ms:.4f} ms, plain {p_ms:.4f} ms")
    for lq, lk, dh in FLASH_SITES:
        q, k, v = (torch.randn(B_MAIN, n_, 8, dh, device=dev, generator=g) for n_ in (lq, lk, lk))
        k_ms, p_ms = both(lambda: flash.flash_attention(q, k, v), 10)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = cuda_ms(lambda: sdpa(qt, kt, vt), 10)
        add("flash_attn", k_ms, p_ms, *attention_work(B_MAIN, 8, lq, lk, dh, "flash_attn"), lib)
        print(f"time K3 flash_attn ({lq}, {lk}, {dh}): {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
              f"sdpa {lib:.4f} ms")

    for lq, lk, dh in FLASH_SITES:
        q, k, v, do = (torch.randn(B_TRAIN, n_, 8, dh, device=dev, generator=g)
                       for n_ in (lq, lk, lk, lq))
        k3 = cuda_ms(lambda: flash._flash_kernel(q, k, v, stats=True), 5)
        p3 = cuda_ms(lambda: flash.attention_fwd_plain(q, k, v), 2, warmup=1)
        qt, kt, vt = (x.transpose(1, 2).requires_grad_(True) for x in (q, k, v))
        lib_f = cuda_ms(lambda: sdpa(qt, kt, vt), 5)
        o, lse = flash._flash_kernel(q, k, v, stats=True)
        di = (o * do).sum(-1).transpose(1, 2).contiguous()
        ptrs = [x.data_ptr() for x in (q, k, v, lse, do, di)]
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        scale = 1.0 / math.sqrt(dh)
        shape = (B_TRAIN, 8, lq, lk, dh, scale)
        k5 = cuda_ms(lambda: kernels.launch("flash_attn_bwd_dq", q.device, *ptrs, dq.data_ptr(),
                                            *shape), 5)
        k4 = cuda_ms(lambda: kernels.launch("flash_attn_bwd_dkv", q.device, *ptrs, dk.data_ptr(),
                                            dv.data_ptr(), *shape), 5)
        p5 = cuda_ms(lambda: flash.attention_bwd_dq_plain(q, k, v, lse, do, di), 2, warmup=1)
        p4 = cuda_ms(lambda: flash.attention_bwd_dkv_plain(q, k, v, lse, do, di), 2, warmup=1)
        out_t = sdpa(qt, kt, vt)
        dot = do.transpose(1, 2)
        lib_b = cuda_ms(lambda: torch.autograd.grad(out_t, (qt, kt, vt), dot, retain_graph=True), 5)
        for name, k_ms, p_ms, lib in (("flash_attn_stats", k3, p3, lib_f),
                                      ("flash_attn_bwd_dq", k5, p5, lib_b),
                                      ("flash_attn_bwd_dkv", k4, p4, lib_b)):
            add(name, k_ms, p_ms, *attention_work(B_TRAIN, 8, lq, lk, dh, name), lib)
        print(f"time B{B_TRAIN} ({lq}, {lk}, {dh}): K3+stats {k3:.4f} / plain {p3:.4f} / sdpa fwd "
              f"{lib_f:.4f} ms; K5 {k5:.4f} / plain {p5:.4f} ms; K4 {k4:.4f} / plain {p4:.4f} ms; "
              f"sdpa bwd (dq, dk, dv) {lib_b:.4f} ms")
        del out_t, qt, kt, vt
    return out


def train_times(torch, kernels, run) -> Dict[str, List[float]]:
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
    print("train ms/step at B=12 (render + forward + loss + backward + Adam): kernels "
          + ", ".join(f"{x:.2f}" for x in ms["kernels"]) + "; plain "
          + ", ".join(f"{x:.2f}" for x in ms["plain"]))
    print(f"train peak memory: kernels {peak['kernels']:.2f} GiB, plain {peak['plain']:.2f} GiB")
    return ms


def train_profile(torch, run) -> None:
    """Device time of two kernel train steps by kernel family (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model, state, step, partial, gt, weights = run
    step(state, partial, gt, weights, 1e-6)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            step(state, partial, gt, weights, 1e-6)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 2
    fam: Dict[str, float] = {}
    top = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:  # device kernels only, no CPU op
            continue
        dev_us = ev.self_device_time_total
        label = next((f for f, pat in PROFILE_FAMILIES if re.search(pat, ev.key, re.I)), "other")
        fam[label] = fam.get(label, 0.0) + dev_us / 2e3
        top.append((dev_us / 2e3, ev.key[:90]))
    busy = sum(fam.values())
    if busy == 0:
        print("profile: the profiler recorded no device time")
        return
    print(f"profile per train step: host wall {wall_ms:.2f} ms (profiler on), device busy "
          f"{busy:.2f} ms ({100 * busy / wall_ms:.1f} %)")
    for label, v in sorted(fam.items(), key=lambda kv: -kv[1]):
        print(f"profile  {label:32s} {v:9.3f} ms  {100 * v / busy:5.1f} %")
    for v, key in sorted(top, reverse=True)[:12]:
        print(f"profile top kernel {v:9.3f} ms  {key}")


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
    from svdformer_pointsea_tpu_torch.configs import pcn_config
    from svdformer_pointsea_tpu_torch.nn import flash
    from svdformer_pointsea_tpu_torch.train import build_model
    from svdformer_pointsea_tpu_torch.train.evaluate import disable_tf32

    t_start = time.perf_counter()
    smi = smi_line()
    print(smi)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    disable_tf32()
    print(f"kernel build: {kernels.build():.1f} s")

    g = torch.Generator(device="cuda").manual_seed(SEED)
    max_err = kernel_phase(torch, ops, flash, g)

    # Evaluation main path: eval_pcn on a full-width PCN SVDFormer.
    cfg = pcn_config()
    model = build_model(cfg, seed=SEED).eval()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"SVDFormer (PCN, step {cfg.network.step1}/{cfg.network.step2}, merge "
          f"{cfg.network.merge_points}, local {cfg.network.local_points}, render "
          f"{cfg.network.resolution}²): {n_params / 1e6:.2f} M parameters")
    batches = synthetic_batches(np.random.RandomState(SEED))
    eval_launches, eval_fn = eval_phase(torch, kernels, cfg, model, batches)

    # Train main path: make_train_step on full-width models from build_model.
    train_batch = synthetic_batches(np.random.RandomState(SEED + 1), n_batches=1,
                                    bs=cfg.train.batch_size, n_partial=cfg.data.n_points)[0]
    train_launches, run = train_phase(torch, kernels, cfg, train_batch)

    # Timing: eval completions/s at B = 8, kernels and plain in turns.
    partial = torch.as_tensor(batches[0].data["partial_cloud"], device="cuda")
    gt = torch.as_tensor(batches[0].data["gtcloud"], device="cuda")
    rates = {"kernels": [], "plain": []}
    for mode in ("plain", "kernels", "kernels", "plain"):
        ctx = kernels.reference_ops() if mode == "plain" else contextlib.nullcontext()
        with ctx:
            ms = cuda_ms(lambda: eval_fn(partial, gt), iters=5, warmup=1)
        rates[mode].append(B_MAIN * 1000.0 / ms)
    print("eval completions/s at B=8 (render + forward + CD/DCD/F1): kernels "
          + ", ".join(f"{r:.2f}" for r in rates["kernels"]) + "; plain "
          + ", ".join(f"{r:.2f}" for r in rates["plain"]))
    del model
    step_ms = train_times(torch, kernels, run)
    train_profile(torch, run)
    del run
    torch.cuda.empty_cache()

    times = kernel_times(torch, ops, flash, kernels, g)
    train_attn = sum(times[n]["ms"] for n in ("flash_attn_stats", "flash_attn_bwd_dq",
                                              "flash_attn_bwd_dkv"))
    mean_step = sum(step_ms["kernels"]) / len(step_ms["kernels"])
    print(f"K3+stats + K5 + K4 per training batch: {train_attn:.3f} ms, "
          f"{100 * train_attn / mean_step:.1f} % of the {mean_step:.2f} ms kernel train step")
    report = {"kernels": []}
    for name in kernels.KERNEL_NAMES:
        t = times[name]
        report["kernels"].append({
            "name": name, "route": "cuda", "source": SOURCES[name][0], "replaces": SOURCES[name][1],
            "launches": eval_launches[name] + train_launches[name],
            "launches_by_path": {"eval": eval_launches[name], "train_step": train_launches[name]},
            "max_abs_err": max_err[name], "ms": round(t["ms"], 4),
            "plain_ms": round(t["plain_ms"], 4), "bound_ms": round(t["bound_ms"], 4),
            "bound_by": "operations" if t["ops_ms"] >= t["bytes_ms"] else "bytes",
            "library_ms": None if t["library_ms"] is None else round(t["library_ms"], 4),
            "per": "eval batch of 8" if name == "flash_attn" else f"training batch of {B_TRAIN}",
        })
    for row in report["kernels"]:
        if not all(math.isfinite(row[k]) for k in ("max_abs_err", "ms", "plain_ms", "bound_ms")):
            fail(f"non-finite measurement in {row}")
    print(f"chip_smoke wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(report))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
