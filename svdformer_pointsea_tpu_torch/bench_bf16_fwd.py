"""Time the port's bf16 flash forward (K3) beside another build of it and
beside ``scaled_dot_product_attention`` on its flash backend, at every
attention site of the PCN SVDFormer: with row statistics at the train step's
batch of 12, without them at evaluation's batch of 8. Also the host cost of
one launch.

    python3 -m svdformer_pointsea_tpu_torch.bench_bf16_fwd OTHER.cu

Run from the root of a checkout, on a CUDA card with ``nvcc``. ``OTHER.cu``
is a CUDA source whose ``flash_attn_bf16_fwd_launch`` has the port's C
signature, for example an earlier commit's ``csrc/flash_attn_bf16.cu``
unpacked with ``git archive``. Both kernels are called through the same
``ctypes`` path. Each time is taken two ways, with ``chip_smoke.py``'s
timers: CUDA events around repeated calls, which include host time where the
host is the slower, and the device time of calls replayed from a CUDA graph.
Exits non-zero if either kernel's O is further than 1e-2 · max|ref| from the
plain version at any site.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

from svdformer_pointsea_tpu_torch import kernels
from svdformer_pointsea_tpu_torch.nn import flash

HEADS = 8


def bind(lib: ctypes.CDLL):
    fn = lib.flash_attn_bf16_fwd_launch
    fn.argtypes = kernels._ENTRY["flash_attn_bf16"][2]
    fn.restype = ctypes.c_int
    return fn


def forward(fn, q, k, v, stats: bool):
    """O of one launch of the C entry point ``fn`` on the current stream."""
    B, Lq, H, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(B, H, Lq, dtype=torch.float32, device=q.device) if stats else None
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             None if lse is None else lse.data_ptr(), B, H, Lq, k.shape[1], D,
             1.0 / math.sqrt(D), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attn_bf16_fwd_launch failed: error {err}")
    return o


def build_other(other: Path) -> ctypes.CDLL:
    """Compile ``other`` with the port's nvcc flags into the build directory
    while the port's own kernels build, and load it; raises if nvcc fails."""
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = kernels.BUILD_DIR / f"libother-{other.stem}-{os.getpid()}.so"
    proc = subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(so),
                             str(other.resolve())], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    kernels.build()
    out, _ = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {other}:\n{out}")
    return ctypes.CDLL(str(so))


def host_us(fn, n: int = 400) -> float:
    """Host µs per call of ``fn`` (the launches queue; the card is not waited for)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, help="CUDA source of the other bf16 K3 build")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_bf16_fwd: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke as cs
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from svdformer_pointsea_tpu_torch.train.evaluate import disable_tf32

    disable_tf32()
    print(cs.smi_line())
    fns = {"port": bind(kernels._libs["flash_attn_bf16_fwd"]), "other": bind(build_other(args.other))}

    def sdpa(qt, kt, vt):
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            return F.scaled_dot_product_attention(qt, kt, vt)

    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    ok = True
    for label, batch, stats in (("train", cs.B_TRAIN, True), ("eval", cs.B_MAIN, False)):
        sums = {key: 0.0 for key in ("port", "other", "sdpa")}
        dev_sums = dict(sums)
        for lq, lk, dh in cs.FLASH_SITES:
            q, k, v = (torch.randn(batch, n, HEADS, dh, device="cuda", generator=g)
                       .to(torch.bfloat16) for n in (lq, lk, lk))
            o_p, _ = flash.attention_fwd_plain_bf16(q, k, v)
            calls = {name: (lambda fn=fn: forward(fn, q, k, v, stats)) for name, fn in fns.items()}
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            calls["sdpa"] = lambda: sdpa(qt, kt, vt)
            errs = {name: cs.rel_err(calls[name](), o_p) for name in fns}
            ok &= all(e <= cs.BF16_REL for e in errs.values())
            ms, dev = {}, {}
            with torch.no_grad():
                for name, fn in calls.items():
                    ms[name] = cs.cuda_ms(fn, 10)
                    dev[name] = cs.graph_ms(fn)
                    sums[name] += ms[name]
                    dev_sums[name] += dev[name]
            flop = 4 * batch * HEADS * lq * lk * dh
            print(f"{label} B{batch} ({lq}, {lk}, {dh}) stats {stats}: ms port / other / sdpa "
                  + " / ".join(f"{ms[n]:.4f}" for n in calls) + "; device "
                  + " / ".join(f"{dev[n]:.4f}" for n in calls)
                  + f"; port {flop / dev['port'] / 1e9:.1f} TFLOP/s, other / port "
                  f"{dev['other'] / dev['port']:.2f} x; |Δ|/max|ref| port {errs['port']:.2e}, "
                  f"other {errs['other']:.2e}")
        print(f"{label} per batch of {batch}: ms port / other / sdpa "
              + " / ".join(f"{sums[n]:.4f}" for n in sums) + "; device "
              + " / ".join(f"{dev_sums[n]:.4f}" for n in dev_sums)
              + f"; other / port {dev_sums['other'] / dev_sums['port']:.2f} x, port / sdpa "
              f"{dev_sums['port'] / dev_sums['sdpa']:.3f}")

    # Host cost of the C entry points alone, outputs allocated beforehand
    # (the f32 K3's: bench_f32_fwd.py).
    bf = [torch.randn(1, 512, HEADS, 64, device="cuda", generator=g).to(torch.bfloat16)
          for _ in range(4)]  # q, k, v, o, kept alive while timed
    shape = [None, 1, HEADS, 512, 512, 64, 0.125, torch.cuda.current_stream().cuda_stream]
    per = {f"bf16 {name}": host_us(lambda fn=fn: fn(*(x.data_ptr() for x in bf), *shape))
           for name, fn in fns.items()}
    print("host µs per launch, B 1 (512, 512, 64): "
          + ", ".join(f"{name} {us:.2f}" for name, us in per.items()))
    print(cs.smi_line())
    if not ok:
        print("bench_bf16_fwd: a kernel's O is outside 1e-2 · max|ref|", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
