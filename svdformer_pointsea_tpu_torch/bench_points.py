"""Time the port's K1 (nearest-neighbour search) and K2 (farthest point
sampling) beside another build of each at every main-path site: the train
step's sites at batch 12 and evaluation's at batch 8. Then the port's K1 and
K2 under every launch plan their kernels take, at each of those sites: the
timings that the rules of ``ops/distances.py::nn_launch_plan`` and
``ops/fps.py::fps_launch_plan`` were chosen from. Also the host cost of one
launch.

    python3 -m svdformer_pointsea_tpu_torch.bench_points NN.cu FPS.cu

Run from the root of a checkout, on a CUDA card with ``nvcc``. ``NN.cu`` and
``FPS.cu`` are CUDA sources of a K1 and a K2 with the C signatures from before
the launch plans, ``nn_one_way_launch(a, b, dmin, idx, batch, n, m, stream)``
and ``fps_launch(xyz, out, batch, n, npoint, stream)``: for example commit
f209ec1's ``csrc/nn_distance.cu`` and ``csrc/fps.cu``, unpacked with ``git
archive``. The port runs through its wrappers (``ops.nn_one_way``,
``ops.furthest_point_sample``, each with its launch plan), the other build
through ``ctypes`` on outputs allocated beforehand; both are built with the
port's nvcc flags (``bench_bf16_fwd.build_other``). Times, with
``chip_smoke.py``'s timers: CUDA events around repeated calls (host time
included where the host is the slower) and the device time of calls replayed
from a CUDA graph, the two builds in turns (other, port, port, other). Exits
non-zero if either build differs from the plain version in one index or one
bit of d at any site, or if a repeat gives other bits.

The plan sweep: K1 with 128 or 256 threads, 2 or 4 queries a thread, 1, 2, 4
or 8 splits of the targets and a vote every 4 targets or none; K2 with a
cluster of 1, 2, 4, 8 or 16 CTAs a sample and 4 or 16 points a thread, with
the fewest whole warps that cover a CTA's points. Each plan's device time is
that of calls replayed from a CUDA graph; per site the chosen plan's time and
the fastest plans are printed. It also fails if any plan differs from the
plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import sys
from collections import Counter
from pathlib import Path

import torch

from svdformer_pointsea_tpu_torch import kernels, ops
from svdformer_pointsea_tpu_torch.ops import distances, fps
from svdformer_pointsea_tpu_torch.bench_bf16_bwd import launcher
from svdformer_pointsea_tpu_torch.bench_bf16_fwd import build_other, host_us

_P, _I = ctypes.c_void_p, ctypes.c_int


def bind(lib: ctypes.CDLL, name: str, argtypes):
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def in_turns(cs, calls, iters: int, reps: int):
    """{build: (events ms, device ms)} of each call, timed other, port, port,
    other, each figure the mean of its two turns."""
    ms = {name: [] for name in calls}
    dev = {name: [] for name in calls}
    for name in ("other", "port", "port", "other"):
        ms[name].append(cs.cuda_ms(calls[name], iters))
        dev[name].append(cs.graph_ms(calls[name], reps=reps, replays=3))
    return {name: (sum(ms[name]) / 2, sum(dev[name]) / 2) for name in calls}


def nn_plans(m: int):
    for threads, q, splits, vote in itertools.product((128, 256), distances.NN_QUERIES_PER_THREAD,
                                                      (1, 2, 4, 8), distances.NN_VOTES):
        plan = distances.NnPlan(threads, q, splits, -(-m // splits), vote)
        try:
            distances.check_nn_plan(m, plan)
        except ValueError:
            continue
        yield plan


def fps_plans(n: int):
    for cluster, ppt in itertools.product(fps.FPS_CLUSTERS, fps.FPS_POINTS_PER_THREAD):
        chunk = -(-n // cluster)
        plan = fps.FpsPlan(cluster, max(32, -(-chunk // (32 * ppt)) * 32), ppt)
        try:
            fps.check_fps_plan(n, plan)
        except ValueError:
            continue
        if ppt == fps.FPS_POINTS_PER_THREAD[0] or plan.threads * ppt < 2 * chunk:
            yield plan  # else fewer points a thread cover it


def sweep(cs, label: str, chosen, plans, call, want, reps: int) -> bool:
    """Times ``call(plan)`` for the chosen plan and every one of ``plans``,
    prints the chosen plan's time beside the fastest, and returns whether
    every plan gave ``want`` bit for bit."""
    ok, times = True, []
    for plan in dict.fromkeys([chosen, *plans]):
        got = call(plan)
        got = got if isinstance(got, tuple) else (got,)
        ok &= all(torch.equal(x, y) for x, y in zip(got, want))
        times.append((cs.graph_ms(lambda: call(plan), reps=reps, replays=2), plan))
    times.sort(key=lambda tp: tp[0])
    mine = next(t for t, p in times if p == chosen)
    print(f"{label} plans: chosen {tuple(chosen)} {mine:.4f} ms, {mine / times[0][0]:.3f} x the "
          "fastest; fastest " + "; ".join(f"{tuple(p)} {t:.4f}" for t, p in times[:6])
          + f"; every plan bit-equal to the plain version {ok}", flush=True)
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("nn", type=Path, help="CUDA source of the other K1 build")
    ap.add_argument("fps", type=Path, help="CUDA source of the other K2 build")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_points: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke as cs

    print(cs.smi_line())
    old_nn = bind(build_other(args.nn), "nn_one_way_launch", [_P, _P, _P, _P, _I, _I, _I, _P])
    old_fps = bind(build_other(args.fps), "fps_launch", [_P, _P, _I, _I, _I, _P])
    dev = torch.device("cuda")
    sm = kernels.sm_count(dev)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    ok = True
    for label, bs, nn_sites, fps_sites in (
            ("train", cs.B_TRAIN, cs.NN_TRAIN_SITES, cs.FPS_TRAIN_SITES),
            ("eval", cs.B_MAIN, cs.NN_SITES, cs.FPS_SITES)):
        sums = {("K1", b): [0.0, 0.0] for b in ("other", "port")}
        sums.update({("K2", b): [0.0, 0.0] for b in ("other", "port")})
        for (n, m), count in Counter(nn_sites).items():
            a = torch.rand(bs, n, 3, device=dev, generator=g) - 0.5
            b = torch.rand(bs, m, 3, device=dev, generator=g) - 0.5
            dp, ip = ops.nn_one_way_plain(a, b)
            d_o = torch.empty(bs, n, device=dev)
            i_o = torch.empty(bs, n, dtype=torch.int32, device=dev)
            calls = {"other": launcher(old_nn, a.data_ptr(), b.data_ptr(), d_o.data_ptr(),
                                       i_o.data_ptr(), bs, n, m),
                     "port": lambda: ops.nn_one_way(a, b)}
            outs = []
            for _ in range(2):
                calls["other"]()
                outs.append((d_o.clone(), i_o.clone()) + ops.nn_one_way(a, b))
            torch.cuda.synchronize()
            same = [torch.equal(o[0], dp) and torch.equal(o[1], ip) for o in outs]
            same += [torch.equal(o[2], dp) and torch.equal(o[3], ip) for o in outs]
            ok &= all(same)
            t = in_turns(cs, calls, 3 if n == 16384 else 10, 3 if n == 16384 else 10)
            for build, (ms, dv) in t.items():
                sums[("K1", build)][0] += count * ms
                sums[("K1", build)][1] += count * dv
            chosen = ops.nn_launch_plan(bs, n, m, sm)
            print(f"{label} B{bs} K1 ({n}, {m}) x {count}, plan {tuple(chosen)}: ms other "
                  f"{t['other'][0]:.4f}, port {t['port'][0]:.4f}; device other {t['other'][1]:.4f}, "
                  f"port {t['port'][1]:.4f}, other / port {t['other'][1] / t['port'][1]:.2f} x; "
                  f"bit-equal to the plain version and on a repeat: other {all(same[:2])}, port "
                  f"{all(same[2:])}")
            ok &= sweep(cs, f"{label} B{bs} K1 ({n}, {m})", chosen, nn_plans(m),
                        lambda plan: distances._nn_one_way_kernel(a, b, plan), (dp, ip),
                        3 if n * m > 1e8 else 10)
        for (n, m), count in Counter(fps_sites).items():
            x = torch.rand(bs, n, 3, device=dev, generator=g) - 0.5
            ip = ops.furthest_point_sample_ref(x, m)
            out = torch.empty(bs, m, dtype=torch.int32, device=dev)
            calls = {"other": launcher(old_fps, x.data_ptr(), out.data_ptr(), bs, n, m),
                     "port": lambda: ops.furthest_point_sample(x, m)}
            outs = []
            for _ in range(2):
                calls["other"]()
                outs.append((out.clone(), ops.furthest_point_sample(x, m)))
            torch.cuda.synchronize()
            same = [torch.equal(o[0], ip) for o in outs] + [torch.equal(o[1], ip) for o in outs]
            ok &= all(same)
            t = in_turns(cs, calls, 3 if n == 16384 else 10, 2 if n == 16384 else 5)
            for build, (ms, dv) in t.items():
                sums[("K2", build)][0] += count * ms
                sums[("K2", build)][1] += count * dv
            chosen = ops.fps_launch_plan(bs, n, m, sm)
            print(f"{label} B{bs} K2 ({n}, {m}) x {count}, plan {tuple(chosen)}: ms other "
                  f"{t['other'][0]:.4f}, port {t['port'][0]:.4f}; device other {t['other'][1]:.4f}, "
                  f"port {t['port'][1]:.4f} ({1e3 * t['port'][1] / (m - 1):.3f} µs a round, other "
                  f"{1e3 * t['other'][1] / (m - 1):.3f}), other / port "
                  f"{t['other'][1] / t['port'][1]:.2f} x; bit-equal to the plain version and on a "
                  f"repeat: other {all(same[:2])}, port {all(same[2:])}")
            ok &= sweep(cs, f"{label} B{bs} K2 ({n}, {m})", chosen, fps_plans(n),
                        lambda plan: fps._fps_kernel(x, m, plan), (ip,), 2 if n > 4096 else 5)
        for kern in ("K1", "K2"):
            (o_ms, o_dev), (p_ms, p_dev) = sums[(kern, "other")], sums[(kern, "port")]
            print(f"{label} {kern} per batch of {bs}: ms other {o_ms:.4f}, port {p_ms:.4f}; device "
                  f"other {o_dev:.4f}, port {p_dev:.4f}, other / port {o_dev / p_dev:.2f} x")

    # Host cost of one launch: the other build's C entry point alone, and the
    # port's wrapper (plan, checks, outputs and the C entry point).
    a = torch.rand(8, 512, 3, device=dev, generator=g)
    b = torch.rand(8, 2048, 3, device=dev, generator=g)
    d_o = torch.empty(8, 512, device=dev)
    i_o = torch.empty(8, 512, dtype=torch.int32, device=dev)
    out = torch.empty(8, 128, dtype=torch.int32, device=dev)
    per = {"K1 other": host_us(launcher(old_nn, a.data_ptr(), b.data_ptr(), d_o.data_ptr(),
                                        i_o.data_ptr(), 8, 512, 2048)),
           "K1 port": host_us(lambda: ops.nn_one_way(a, b)),
           "K2 other": host_us(launcher(old_fps, a.data_ptr(), out.data_ptr(), 8, 512, 128)),
           "K2 port": host_us(lambda: ops.furthest_point_sample(a, 128))}
    print("host µs per call, B 8, K1 (512, 2048), K2 (512, 128): "
          + ", ".join(f"{name} {us:.2f}" for name, us in per.items()))
    print(cs.smi_line())
    if not ok:
        print("bench_points: a build or a plan differs from the plain version, or a repeat gives "
              "other bits", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
