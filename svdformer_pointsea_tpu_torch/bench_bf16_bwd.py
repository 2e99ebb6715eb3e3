"""Time the port's bf16 flash backward, K5 (dQ) and K4 (dK, dV), beside
another build of it and beside SDPA's flash backward at every attention site
of the PCN SVDFormer's train step (batch 12), with the di pass (rowsum(O ∘
dO)) that the port runs outside its kernels and SDPA inside its one call.
Also the host cost of one launch.

    python3 -m svdformer_pointsea_tpu_torch.bench_bf16_bwd OTHER.cu

Run from the root of a checkout, on a CUDA card with ``nvcc``. ``OTHER.cu``
is a CUDA source whose ``flash_attn_bf16_bwd_dq_launch`` and
``flash_attn_bf16_bwd_dkv_launch`` have the port's C signatures, for example
an earlier commit's ``csrc/flash_attn_bf16.cu`` unpacked with ``git
archive``. Both builds are called through the same ``ctypes`` path; the
other build and the timers are ``bench_bf16_fwd.py``'s and ``chip_smoke.py``'s
(CUDA events around repeated calls, and the device time of calls replayed
from a CUDA graph). Exits non-zero if either build's dq, dk or dv is further
than 1e-2 · max|ref| from the plain versions at any site, or if a repeat
gives other bits.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import sys
from pathlib import Path

import torch

from svdformer_pointsea_tpu_torch import kernels
from svdformer_pointsea_tpu_torch.bench_bf16_fwd import HEADS, build_other, host_us
from svdformer_pointsea_tpu_torch.nn import flash

KERNELS = {"K5": "flash_attn_bwd_dq_bf16", "K4": "flash_attn_bwd_dkv_bf16"}


def bind(lib):
    """{"K5": dQ entry point, "K4": dK / dV entry point} of a library."""
    fns = {}
    for label, name in KERNELS.items():
        fn = getattr(lib, kernels._ENTRY[name][1])
        fn.argtypes = kernels._ENTRY[name][2]
        fn.restype = ctypes.c_int
        fns[label] = fn
    return fns


def launcher(fn, *args):
    """A call of the C entry point ``fn`` on the current stream that raises
    on a CUDA error."""
    def call():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{fn.__name__} failed: error {err}")
    return call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, help="CUDA source of the other bf16 K4 / K5 build")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_bf16_bwd: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke as cs

    from svdformer_pointsea_tpu_torch.train.evaluate import disable_tf32

    disable_tf32()
    print(cs.smi_line())
    other = bind(build_other(args.other))  # the port's kernels build meanwhile
    builds = {"port": bind(kernels._libs["flash_attn_bf16_bwd"]), "other": other}
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    b = cs.B_TRAIN
    ok = True
    sums: dict = {}
    dev_sums: dict = {}
    for lq, lk, dh in cs.FLASH_SITES:
        q, k, v, do = (torch.randn(b, n, HEADS, dh, device="cuda", generator=g)
                       .to(torch.bfloat16) for n in (lq, lk, lk, lq))
        o, lse = flash._flash_kernel(q, k, v, stats=True)
        di = flash.attention_di(o, do)
        want = (flash.attention_bwd_dq_plain_bf16(q, k, v, lse, do, di),
                *flash.attention_bwd_dkv_plain_bf16(q, k, v, lse, do, di))
        ptrs = [x.data_ptr() for x in (q, k, v, lse, do, di)]
        shape = (b, HEADS, lq, lk, dh, 1.0 / math.sqrt(dh))
        calls, errs, outs = {}, {}, {}
        for build, fns in builds.items():
            dq, dk, dv = outs[build] = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
            calls[f"{build} K5"] = launcher(fns["K5"], *ptrs, dq.data_ptr(), *shape)
            calls[f"{build} K4"] = launcher(fns["K4"], *ptrs, dk.data_ptr(), dv.data_ptr(), *shape)
            first = []
            for _ in range(2):
                calls[f"{build} K5"]()
                calls[f"{build} K4"]()
                torch.cuda.synchronize()
                first.append([x.clone() for x in (dq, dk, dv)])
            ok &= all(torch.equal(x, y) for x, y in zip(*first))
            errs[build] = max(cs.rel_err(x, y) for x, y in zip(first[0], want))
        calls["di"] = lambda: flash.attention_di(o, do)
        calls["sdpa"] = cs.sdpa_flash_backward(torch, *(x.transpose(1, 2) for x in (q, k, v, do)))
        ok &= all(e <= cs.BF16_REL for e in errs.values())
        ms, dev = {}, {}
        with torch.no_grad():
            for name, fn in calls.items():
                ms[name] = cs.cuda_ms(fn, 10)
                dev[name] = cs.graph_ms(fn)
                sums[name] = sums.get(name, 0.0) + ms[name]
                dev_sums[name] = dev_sums.get(name, 0.0) + dev[name]
        total = {build: dev["di"] + dev[f"{build} K5"] + dev[f"{build} K4"] for build in builds}
        flop = 14 * b * HEADS * lq * lk * dh  # K5 6, K4 8 x B h Lq Lk dh
        print(f"B{b} ({lq}, {lk}, {dh}): ms " + ", ".join(f"{n} {ms[n]:.4f}" for n in calls)
              + "; device " + ", ".join(f"{n} {dev[n]:.4f}" for n in calls)
              + f"; device di + K5 + K4 port {total['port']:.4f} ("
              f"{flop / (dev['port K5'] + dev['port K4']) / 1e9:.1f} TFLOP/s in K5 + K4), other "
              f"{total['other']:.4f}, sdpa {dev['sdpa']:.4f}; other / port "
              f"{total['other'] / total['port']:.2f} x, port / sdpa {total['port'] / dev['sdpa']:.3f}"
              f"; |Δ|/max|ref| port {errs['port']:.2e}, other {errs['other']:.2e}")
    total = {build: dev_sums["di"] + dev_sums[f"{build} K5"] + dev_sums[f"{build} K4"]
             for build in builds}
    print(f"per training batch of {b}: ms " + ", ".join(f"{n} {v:.4f}" for n, v in sums.items())
          + "; device " + ", ".join(f"{n} {v:.4f}" for n, v in dev_sums.items())
          + f"; device di + K5 + K4 port {total['port']:.4f}, other {total['other']:.4f}, sdpa "
          f"{dev_sums['sdpa']:.4f}; other / port {total['other'] / total['port']:.2f} x, port / "
          f"sdpa {total['port'] / dev_sums['sdpa']:.3f}")

    # Host cost of the C entry points alone, outputs allocated beforehand.
    stream = torch.cuda.current_stream().cuda_stream
    q, k, v, do, dq, dk, dv = (torch.zeros(1, 512, HEADS, 64, device="cuda", dtype=torch.bfloat16)
                               for _ in range(7))
    lse, di = (torch.zeros(1, HEADS, 512, device="cuda") for _ in range(2))
    ptrs = [x.data_ptr() for x in (q, k, v, lse, do, di)]
    shape = (1, HEADS, 512, 512, 64, 0.125, stream)
    per = {}
    for build, fns in builds.items():
        per[f"{build} K5"] = host_us(lambda fn=fns["K5"]: fn(*ptrs, dq.data_ptr(), *shape))
        per[f"{build} K4"] = host_us(lambda fn=fns["K4"]: fn(*ptrs, dk.data_ptr(), dv.data_ptr(),
                                                             *shape))
    print("host µs per launch, B 1 (512, 512, 64): "
          + ", ".join(f"{name} {us:.2f}" for name, us in per.items()))
    print(cs.smi_line())
    if not ok:
        print("bench_bf16_bwd: a build's dq, dk or dv is outside 1e-2 · max|ref| or not "
              "repeatable", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
