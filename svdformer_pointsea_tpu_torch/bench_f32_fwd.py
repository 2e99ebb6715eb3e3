"""Time the port's f32 flash forward, K3 on the split planes of q, k and v,
beside another f32 build of K3 and beside SDPA's memory-efficient forward, at
every attention site of the PCN SVDFormer: with row statistics at the train
step's batch of 12, without them at evaluation's batch of 8. Also each
build's error against an f64 forward, and the host cost of one launch.

    python3 -m svdformer_pointsea_tpu_torch.bench_f32_fwd OTHER.cu

Run from the root of a checkout, on a CUDA card with ``nvcc``. ``OTHER.cu``
is a CUDA source whose ``flash_attn_fwd_launch`` takes f32 q, k, v with the
port's other arguments, for example an earlier commit's
``csrc/flash_attn.cu`` (the FMA kernel) unpacked with ``git archive``. The
port is timed through its wrapper (the split of q, k and v, then K3) and as
K3 alone on planes made beforehand; the split alone beside them. The other
build, the host timer and the CUDA-event and CUDA-graph timers are
``bench_bf16_fwd.py``'s and ``chip_smoke.py``'s. Errors are max|Δ| of O and
LSE against the plain forward in f64, with q x 1 (timed) and with q x 8 (a
large spread of scores; the f32 naive math's own distance printed beside).
Exits non-zero if either build's O or LSE leaves atol 2e-5 of the f64
forward with q x 1 at any site, or if a repeat gives other bits.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import sys
from pathlib import Path

import torch

from svdformer_pointsea_tpu_torch import kernels
from svdformer_pointsea_tpu_torch.bench_bf16_bwd import launcher
from svdformer_pointsea_tpu_torch.bench_bf16_fwd import HEADS, build_other, host_us
from svdformer_pointsea_tpu_torch.nn import flash

TOL = 2e-5  # atol, chip_smoke.FLASH_TOL


def bind(fn):
    """``fn`` with the port's K3 argument types (pointers, ints, the scale,
    the stream)."""
    fn.argtypes = kernels._ENTRY["flash_attn"][2]
    fn.restype = ctypes.c_int
    return fn


def errors(o, lse, ref):
    """[max|ΔO|, max|ΔLSE|] against ``ref`` = (O, LSE) in f64 (LSE of None: 0)."""
    e_l = 0.0 if lse is None else (lse.double() - ref[1]).abs().max().item()
    return [(o.double() - ref[0]).abs().max().item(), e_l]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, help="CUDA source of the other f32 K3 build")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_f32_fwd: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke as cs

    from svdformer_pointsea_tpu_torch.train.evaluate import disable_tf32

    disable_tf32()
    print(cs.smi_line())
    fns = {"other": bind(build_other(args.other).flash_attn_fwd_launch),  # the port builds meanwhile
           "port": bind(getattr(kernels._libs["flash_attn_split_fwd"],
                                kernels._ENTRY["flash_attn"][1]))}
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    ok = True
    for label, b, stats in (("train", cs.B_TRAIN, True), ("eval", cs.B_MAIN, False)):
        sums: dict = {}
        dev_sums: dict = {}
        worst: dict = {}
        for lq, lk, dh in cs.FLASH_SITES:
            shape = (b, HEADS, lq, lk, dh, 1.0 / math.sqrt(dh))
            for spread in (1.0, cs.SPREAD):
                q, k, v = (torch.randn(b, n, HEADS, dh, device="cuda", generator=g)
                           for n in (lq, lk, lk))
                q = q * spread
                planes = [flash.split_bf16x3(x) for x in (q, k, v)]
                ref = flash.attention_fwd_plain(q.double(), k.double(), v.double())
                operands = {"port": planes, "other": [q, k, v]}
                calls, outs = {}, {}
                for build, fn in fns.items():
                    o = torch.empty_like(q)
                    lse = torch.empty(b, HEADS, lq, device="cuda") if stats else None
                    outs[build] = (o, lse)
                    calls[build] = launcher(fn, *(x.data_ptr() for x in operands[build]),
                                            o.data_ptr(), None if lse is None else lse.data_ptr(),
                                            *shape)
                errs = {}
                for build, call in calls.items():
                    first = []
                    for _ in range(2):
                        call()
                        torch.cuda.synchronize()
                        first.append([x.clone() for x in outs[build] if x is not None])
                    ok &= all(torch.equal(x, y) for x, y in zip(*first))
                    errs[build] = errors(*outs[build], ref)
                wrapped = flash._flash_kernel(q, k, v, stats=stats)
                wrapped = wrapped if stats else (wrapped, None)
                ok &= all(torch.equal(x, y) for x, y in zip(wrapped, outs["port"]) if x is not None)
                naive = flash.attention_fwd_plain(q, k, v)
                errs["f32 naive"] = errors(naive[0], naive[1] if stats else None, ref)
                del ref, naive, wrapped
                key = f"q x {spread:g}"
                for build, e in errs.items():
                    worst[(build, key)] = max(worst.get((build, key), 0.0), *e)
                    if spread == 1.0 and build != "f32 naive":
                        ok &= max(e) <= TOL
                text = "; ".join(f"{n} O {e[0]:.2e}" + (f", lse {e[1]:.2e}" if stats else "")
                                 for n, e in errs.items())
                if spread != 1.0:
                    print(f"{label} B{b} ({lq}, {lk}, {dh}) q x {spread:g}: max|Δ| vs f64 {text}")
                    continue
                calls["port via wrapper"] = lambda: flash._flash_kernel(q, k, v, stats=stats)
                calls["split"] = lambda: [flash.split_bf16x3(x) for x in (q, k, v)]
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                calls["sdpa"] = cs.sdpa_efficient_forward(torch, qt, kt, vt, stats)
                ms, dev = {}, {}
                with torch.no_grad():
                    for name, fn in calls.items():
                        ms[name] = cs.cuda_ms(fn, 10)
                        dev[name] = cs.graph_ms(fn)
                        sums[name] = sums.get(name, 0.0) + ms[name]
                        dev_sums[name] = dev_sums.get(name, 0.0) + dev[name]
                flop = 4 * b * HEADS * lq * lk * dh
                print(f"{label} B{b} ({lq}, {lk}, {dh}) stats {stats}: ms "
                      + ", ".join(f"{n} {ms[n]:.4f}" for n in calls) + "; device "
                      + ", ".join(f"{n} {dev[n]:.4f}" for n in calls)
                      + f"; port {flop / dev['port'] / 1e9:.1f} TFLOP/s alone, other / port via "
                      f"wrapper {dev['other'] / dev['port via wrapper']:.2f} x, port via wrapper / "
                      f"sdpa {dev['port via wrapper'] / dev['sdpa']:.3f}; max|Δ| vs f64 {text}")
        print(f"{label} per batch of {b}: ms " + ", ".join(f"{n} {v:.4f}" for n, v in sums.items())
              + "; device " + ", ".join(f"{n} {v:.4f}" for n, v in dev_sums.items())
              + f"; other / port via wrapper {dev_sums['other'] / dev_sums['port via wrapper']:.2f} "
              f"x, port via wrapper / sdpa {dev_sums['port via wrapper'] / dev_sums['sdpa']:.3f}, "
              f"port alone / sdpa {dev_sums['port'] / dev_sums['sdpa']:.3f}; worst max|Δ| vs f64 "
              + ", ".join(f"{n} ({k}) {e:.2e}" for (n, k), e in worst.items()))

    # Host cost of the C entry points alone, outputs allocated beforehand.
    stream = torch.cuda.current_stream().cuda_stream
    f32 = [torch.zeros(1, 512, HEADS, 64, device="cuda") for _ in range(4)]
    planes = [torch.zeros(3, 1, 512, HEADS, 64, device="cuda", dtype=torch.bfloat16)
              for _ in range(3)]
    lse = torch.zeros(1, HEADS, 512, device="cuda")
    ins = {"port": planes, "other": f32[:3]}
    shape = (1, HEADS, 512, 512, 64, 0.125, stream)
    per = {build: host_us(lambda fn=fn, p=[x.data_ptr() for x in ins[build]]:
                          fn(*p, f32[3].data_ptr(), lse.data_ptr(), *shape))
           for build, fn in fns.items()}
    print("host µs per launch with statistics, B 1 (512, 512, 64): "
          + ", ".join(f"{name} {us:.2f}" for name, us in per.items()))
    print(cs.smi_line())
    if not ok:
        print(f"bench_f32_fwd: a build's O or LSE is outside atol {TOL} of the f64 forward with "
              "q x 1, or not repeatable", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
