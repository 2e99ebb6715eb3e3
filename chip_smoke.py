#!/usr/bin/env python3
"""Drive the PyTorch port's PCN evaluation path once on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
1. build the hand-written kernels from ``svdformer_pointsea_tpu_torch/csrc``
   (one nvcc per source, in parallel);
2. hold each kernel against its plain PyTorch version on the card, at the
   shapes the evaluation path gives it (B = 4), plus FPS's quirk inputs;
3. run ``eval_pcn`` on a full-width PCN SVDFormer (random weights from a
   seeded generator) over 3 synthetic batches of 8, with the launch counters
   zeroed just before and read just after; every kernel must have launched.
   The same batches run under ``reference_ops()`` (plain versions only), and
   per-sample CD-L1×10³ must agree within 0.01;
4. time eval completions/s at B = 8 with kernels and with plain ops, and each
   kernel against its plain version at the B = 8 evaluation shapes (CUDA events).

Prints the card's name and power limit, a ``{"kernels": [...]}`` JSON line, and
as its last line ``{"ok": true, "device": {...}}``. Exits non-zero without a
result when no CUDA device is visible or the repository is missing.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

import numpy as np

REPO = Path(__file__).resolve().parent
SEED = 0
B_MAIN = 8
CD_GATE = 0.01  # |ΔCD-L1×10³| per sample (docs/PARITY.md)
NN_TOL = 1e-6
FLASH_TOL = 2e-5

# (Lq, Lk, dh) of every attention site the PCN evaluation sends to K3, in
# call order: SDG1 (512 tokens, hidden 768) then SDG2 (2048 tokens, hidden 512).
FLASH_SITES = [
    (512, 512, 96), (512, 512, 96), (512, 512, 64), (512, 512, 96), (512, 512, 96), (512, 512, 64),
    (2048, 2048, 64), (2048, 2048, 64), (2048, 2048, 128), (2048, 512, 64), (2048, 2048, 64),
    (2048, 2048, 128),
]
# (N, M) of every NN search per evaluation batch: SDG1, SDG2, then both
# directions of calc_cd and of calc_dcd at 16384 points.
NN_SITES = [(512, 2048), (2048, 2048)] + [(16384, 16384)] * 4
# (N, npoint) of every FPS per evaluation batch: SA1, SA2, LocalEncoder, merge.
FPS_SITES = [(2048, 512), (512, 128), (2048, 512), (2304, 512)]


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


@dataclass
class Batch:
    data: Dict[str, np.ndarray]
    taxonomy_ids: List[str]
    valid: int


def synthetic_batches(rng: np.random.RandomState, n_batches: int = 3, bs: int = B_MAIN) -> List[Batch]:
    """Ellipsoid surfaces (gt, 16384 points) and a one-sided crop of each
    (partial, 2048 points); two taxonomies; the last batch is padded."""
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
            partials.append(cut[rng.choice(len(cut), 2048, replace=len(cut) < 2048)])
        valid = bs if bi < n_batches - 1 else bs - 3
        batches.append(Batch(
            data={"partial_cloud": np.stack(partials), "gtcloud": np.stack(gts)},
            taxonomy_ids=["02691156" if i % 2 == 0 else "03001627" for i in range(bs)],
            valid=valid,
        ))
    return batches


def kernel_phase(torch, ops, layers, g) -> Dict[str, float]:
    """Kernel vs plain version at the evaluation shapes, B = 4. Returns the
    max abs error per kernel."""
    dev = "cuda"
    err = {"nn_distance": 0.0, "fps": 0.0, "flash_attn": 0.0}

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
    for n, m in [(2048, 512), (2304, 512), (512, 128), (16384, 2048)]:
        fps_cases.append((f"{n}->{m}", torch.rand(4, n, 3, device=dev, generator=g) - 0.5, m))
    quirk = torch.rand(4, 2048, 3, device=dev, generator=g) + 0.5
    quirk[0, 10:400] = 0.0  # near-origin points are never picked
    quirk[0, 400:410] = 0.01
    quirk[1] = 0.0  # all-invalid row: every pick falls back to 0
    quirk[2, 1000:] = quirk[2, :1048].clone()  # duplicated points: ties
    quirk[3] = torch.round(quirk[3] * 4) / 4  # a coarse grid: many equal distances
    fps_cases.append(("quirks 2048->512", quirk, 512))
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

    for lq, lk, dh in sorted(set(FLASH_SITES)) + [(512, 512, 256), (2048, 2048, 256)]:
        q, k, v = (torch.randn(4, n_, 8, dh, device=dev, generator=g) for n_ in (lq, lk, lk))
        o = layers.flash_attention(q, k, v)
        torch.cuda.synchronize()
        e = (o - layers.naive_attention(q, k, v)).abs().max().item()
        print(f"K3 flash_attn Lq {lq} Lk {lk} dh {dh}: max|Δ| {e:.3e}")
        if not e <= FLASH_TOL:
            fail(f"flash_attn ({lq}, {lk}, {dh}) differs by {e}")
        err["flash_attn"] = max(err["flash_attn"], e)
    return err


def kernel_times(torch, ops, layers, kernels, g) -> Dict[str, Dict[str, float]]:
    """Kernel and plain time (ms) summed over the calls one B = 8 evaluation
    batch makes, each call shape timed on its own."""
    dev = "cuda"
    out = {name: {"ms": 0.0, "plain_ms": 0.0} for name in kernels.KERNEL_NAMES}

    def both(name, fn, iters):
        k_ms = cuda_ms(fn, iters)
        with kernels.reference_ops():
            p_ms = cuda_ms(fn, max(1, iters // 2), warmup=1)
        out[name]["ms"] += k_ms
        out[name]["plain_ms"] += p_ms
        return k_ms, p_ms

    for n, m in NN_SITES:
        a = torch.rand(B_MAIN, n, 3, device=dev, generator=g) - 0.5
        b = torch.rand(B_MAIN, m, 3, device=dev, generator=g) - 0.5
        print("time K1 nn_distance %d->%d: %.4f ms, plain %.4f ms" % ((n, m) + both(
            "nn_distance", lambda: ops.nn_one_way(a, b), 10)))
    for n, m in FPS_SITES:
        x = torch.rand(B_MAIN, n, 3, device=dev, generator=g) - 0.5
        print("time K2 fps %d->%d: %.4f ms, plain %.4f ms" % ((n, m) + both(
            "fps", lambda: ops.furthest_point_sample(x, m), 10)))
    for lq, lk, dh in FLASH_SITES:
        q, k, v = (torch.randn(B_MAIN, n_, 8, dh, device=dev, generator=g) for n_ in (lq, lk, lk))
        print("time K3 flash_attn (%d, %d, %d): %.4f ms, plain %.4f ms" % ((lq, lk, dh) + both(
            "flash_attn", lambda: layers.scaled_attention(q, k, v), 10)))
    return out


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
    from svdformer_pointsea_tpu_torch.nn import SVDFormer, init_parameters, layers
    from svdformer_pointsea_tpu_torch.render import make_renderer
    from svdformer_pointsea_tpu_torch.train.evaluate import disable_tf32, eval_pcn, make_pcn_eval_fn

    smi = smi_line()
    print(smi)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    disable_tf32()
    print(f"kernel build: {kernels.build():.1f} s")

    g = torch.Generator(device="cuda").manual_seed(SEED)
    max_err = kernel_phase(torch, ops, layers, g)

    # Main path: eval_pcn on a full-width PCN SVDFormer.
    cfg = pcn_config()
    model = SVDFormer.from_config(cfg.network)
    init_parameters(model, torch.Generator().manual_seed(SEED))
    model = model.cuda().eval()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"SVDFormer (PCN, step {cfg.network.step1}/{cfg.network.step2}, merge "
          f"{cfg.network.merge_points}, local {cfg.network.local_points}, render "
          f"{cfg.network.resolution}²): {n_params / 1e6:.2f} M parameters")
    batches = synthetic_batches(np.random.RandomState(SEED))

    kernels.reset_launches()
    mean_cd = eval_pcn(cfg, model, batches)
    launches = dict(kernels.launches)
    print(f"main path launches: {launches}")
    for name, count in launches.items():
        if count == 0:
            fail(f"kernel {name} was not launched on the main path")
    with kernels.reference_ops():
        mean_cd_ref = eval_pcn(cfg, model, batches)
    if any(kernels.launches[n] != launches[n] for n in launches):
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

    # Timing: completions/s at B = 8, kernels and plain in turns.
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

    times = kernel_times(torch, ops, layers, kernels, g)
    sources = {
        "nn_distance": ("svdformer_pointsea_tpu_torch/csrc/nn_distance.cu",
                        "svdformer_pointsea_tpu/ops/nn_pallas.py:59"),
        "fps": ("svdformer_pointsea_tpu_torch/csrc/fps.cu", "svdformer_pointsea_tpu/ops/fps.py:68"),
        "flash_attn": ("svdformer_pointsea_tpu_torch/csrc/flash_attn.cu",
                       "svdformer_pointsea_tpu/nn/flash_vjp.py:158"),
    }
    report = {"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0], "replaces": sources[name][1],
         "launches": launches[name], "max_abs_err": max_err[name],
         "ms": round(times[name]["ms"], 4), "plain_ms": round(times[name]["plain_ms"], 4)}
        for name in kernels.KERNEL_NAMES
    ]}
    for row in report["kernels"]:
        if not all(math.isfinite(row[k]) for k in ("max_abs_err", "ms", "plain_ms")):
            fail(f"non-finite measurement in {row}")
    print(json.dumps(report))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
