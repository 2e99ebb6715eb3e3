"""Time the port's f32 flash backward, the split pass and K5 (dQ) and K4 (dK,
dV) on the split planes, beside another f32 build of K5 and K4 and beside
SDPA's memory-efficient backward, at every attention site of the PCN
SVDFormer's train step (batch 12), with the di pass (rowsum(O ∘ dO)) that the
port runs outside its kernels and SDPA inside its one call. Also each build's
error against an f64 backward, and the host cost of one launch.

    python3 -m svdformer_pointsea_tpu_torch.bench_f32_bwd OTHER.cu

Run from the root of a checkout, on a CUDA card with ``nvcc``. ``OTHER.cu``
is a CUDA source whose ``flash_attn_bwd_dq_launch`` and
``flash_attn_bwd_dkv_launch`` take f32 q, k, v, lse, dout, di and the outputs
with the port's other arguments, for example an earlier commit's
``csrc/flash_attn_bwd.cu`` (the FMA kernels) unpacked with ``git archive``.
Both builds are called through ``ctypes``; the other build, the host timer
and the CUDA-event and CUDA-graph timers are ``bench_bf16_fwd.py``'s and
``chip_smoke.py``'s. Errors are max|Δ| / max|ref| of dq, dk and dv against
the plain backward in f64 on the same residuals. Exits non-zero if either
build's dq, dk or dv is outside atol = rtol = 2e-4 of that reference at any
site, or if a repeat gives other bits.
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

TOL = 2e-4  # atol and rtol, chip_smoke.FLASH_BWD_TOL
OTHER_ENTRY = {"K5": "flash_attn_bwd_dq_launch", "K4": "flash_attn_bwd_dkv_launch"}


def bind(lib, entries):
    """{"K5": dQ entry point, "K4": dK / dV entry point} of a library, with
    the port's argument types (pointers, ints, the scale, the stream)."""
    fns = {}
    for label, name in (("K5", "flash_attn_bwd_dq"), ("K4", "flash_attn_bwd_dkv")):
        fn = getattr(lib, entries[label])
        fn.argtypes = kernels._ENTRY[name][2]
        fn.restype = ctypes.c_int
        fns[label] = fn
    return fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, help="CUDA source of the other f32 K4 / K5 build")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_f32_bwd: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke as cs

    from svdformer_pointsea_tpu_torch.train.evaluate import disable_tf32

    disable_tf32()
    print(cs.smi_line())
    other = bind(build_other(args.other), OTHER_ENTRY)  # the port's kernels build meanwhile
    port = bind(kernels._libs["flash_attn_split_bwd"],
                {label: kernels._ENTRY[name][1]
                 for label, name in (("K5", "flash_attn_bwd_dq"), ("K4", "flash_attn_bwd_dkv"))})
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    b = cs.B_TRAIN
    ok = True
    sums: dict = {}
    dev_sums: dict = {}
    worst: dict = {}
    for lq, lk, dh in cs.FLASH_SITES:
        q, k, v, do = (torch.randn(b, n, HEADS, dh, device="cuda", generator=g)
                       for n in (lq, lk, lk, lq))
        o, lse = flash._flash_kernel(q, k, v, stats=True)
        di = flash.attention_di(o, do)
        ref64 = [x.double() for x in (q, k, v, lse, do, di)]
        ref = (flash.attention_bwd_dq_plain(*ref64), *flash.attention_bwd_dkv_plain(*ref64))
        del ref64
        planes = [flash.split_bf16x3(x) for x in (q, k, v, do)]
        shape = (b, HEADS, lq, lk, dh, 1.0 / math.sqrt(dh))
        operands = {"port": [*planes[:3], lse, planes[3], di], "other": [q, k, v, lse, do, di]}
        calls, outs = {}, {}
        for build, fns in (("port", port), ("other", other)):
            ptrs = [x.data_ptr() for x in operands[build]]
            dq, dk, dv = outs[build] = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
            calls[f"{build} K5"] = launcher(fns["K5"], *ptrs, dq.data_ptr(), *shape)
            calls[f"{build} K4"] = launcher(fns["K4"], *ptrs, dk.data_ptr(), dv.data_ptr(), *shape)
        calls["split"] = lambda: [flash.split_bf16x3(x) for x in (q, k, v, do)]
        calls["di"] = lambda: flash.attention_di(o, do)
        dot = do.transpose(1, 2)
        sdpa = cs.sdpa_efficient_backward(torch, *(x.transpose(1, 2) for x in (q, k, v)), dot)
        calls["sdpa"] = sdpa
        got = {}
        for build in ("port", "other"):
            first = []
            for _ in range(2):
                calls[f"{build} K5"]()
                calls[f"{build} K4"]()
                torch.cuda.synchronize()
                first.append([x.clone() for x in outs[build]])
            ok &= all(torch.equal(x, y) for x, y in zip(*first))
            got[build] = first[0]
        got["sdpa"] = [x.transpose(1, 2) for x in sdpa()[:3]]
        errs = {}
        for build, grads in got.items():
            errs[build] = max(((x.double() - r).abs().max() / r.abs().max()).item()
                              for x, r in zip(grads, ref))
            worst[build] = max(worst.get(build, 0.0), errs[build])
            if build != "sdpa":
                ok &= all(torch.allclose(x.double(), r, atol=TOL, rtol=TOL)
                          for x, r in zip(grads, ref))
        del ref, got
        ms, dev = {}, {}
        with torch.no_grad():
            for name, fn in calls.items():
                ms[name] = cs.cuda_ms(fn, 10)
                dev[name] = cs.graph_ms(fn)
                sums[name] = sums.get(name, 0.0) + ms[name]
                dev_sums[name] = dev_sums.get(name, 0.0) + dev[name]
        port_total = dev["di"] + dev["split"] + dev["port K5"] + dev["port K4"]
        other_total = dev["di"] + dev["other K5"] + dev["other K4"]
        flop = 14 * b * HEADS * lq * lk * dh  # K5 6, K4 8 x B h Lq Lk dh
        print(f"B{b} ({lq}, {lk}, {dh}): ms " + ", ".join(f"{n} {ms[n]:.4f}" for n in calls)
              + "; device " + ", ".join(f"{n} {dev[n]:.4f}" for n in calls)
              + f"; device di + split + K5 + K4 port {port_total:.4f} ("
              f"{flop / (dev['port K5'] + dev['port K4']) / 1e9:.1f} TFLOP/s in K5 + K4), di + K5 "
              f"+ K4 other {other_total:.4f}, sdpa {dev['sdpa']:.4f}; other / port "
              f"{other_total / port_total:.2f} x, port / sdpa {port_total / dev['sdpa']:.3f}; "
              "|Δ|/max|ref| vs f64 " + ", ".join(f"{n} {e:.2e}" for n, e in errs.items()))
    port_total = dev_sums["di"] + dev_sums["split"] + dev_sums["port K5"] + dev_sums["port K4"]
    other_total = dev_sums["di"] + dev_sums["other K5"] + dev_sums["other K4"]
    print(f"per training batch of {b}: ms " + ", ".join(f"{n} {v:.4f}" for n, v in sums.items())
          + "; device " + ", ".join(f"{n} {v:.4f}" for n, v in dev_sums.items())
          + f"; device di + split + K5 + K4 port {port_total:.4f}, di + K5 + K4 other "
          f"{other_total:.4f}, sdpa {dev_sums['sdpa']:.4f}; other / port "
          f"{other_total / port_total:.2f} x, port / sdpa {port_total / dev_sums['sdpa']:.3f}; "
          "worst |Δ|/max|ref| vs f64 " + ", ".join(f"{n} {e:.2e}" for n, e in worst.items()))

    # Host cost of the C entry points alone, outputs allocated beforehand.
    stream = torch.cuda.current_stream().cuda_stream
    f32 = [torch.zeros(1, 512, HEADS, 64, device="cuda") for _ in range(7)]
    planes = [torch.zeros(3, 1, 512, HEADS, 64, device="cuda", dtype=torch.bfloat16)
              for _ in range(4)]
    lse, di = (torch.zeros(1, HEADS, 512, device="cuda") for _ in range(2))
    ins = {"port": [*planes[:3], lse, planes[3], di], "other": [*f32[:3], lse, f32[3], di]}
    shape = (1, HEADS, 512, 512, 64, 0.125, stream)
    outs = [x.data_ptr() for x in f32[4:]]
    per = {}
    for build, fns in (("port", port), ("other", other)):
        ptrs = [x.data_ptr() for x in ins[build]]
        per[f"{build} K5"] = host_us(lambda fn=fns["K5"], p=ptrs: fn(*p, outs[0], *shape))
        per[f"{build} K4"] = host_us(lambda fn=fns["K4"], p=ptrs: fn(*p, outs[1], outs[2], *shape))
    print("host µs per launch, B 1 (512, 512, 64): "
          + ", ".join(f"{name} {us:.2f}" for name, us in per.items()))
    print(cs.smi_line())
    if not ok:
        print(f"bench_f32_bwd: a build's dq, dk or dv is outside atol = rtol = {TOL} of the f64 "
              "backward or not repeatable", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
