"""Time the PCN train step and evaluation of one checkout of the port on the
card, so that two commits can be compared on one card in turns.

    python3 svdformer_pointsea_tpu_torch/bench_step.py [--repo DIR]

``DIR`` (default: this checkout) is the root of the checkout whose package
is timed; the synthetic data and the CUDA-event timer are this checkout's
``chip_smoke.py``'s, so both sides see the same inputs. Prints one JSON line:
train ms/step at B 12 (render + forward + loss + backward + Adam on a
full-width PCN SVDFormer, 3 steps after 1 warm-up) and evaluation
completions/s at B 8 (render + forward + CD / DCD / F1, 5 calls after 1
warm-up), each in f32 and in bf16 mode, with the card's name and power
limit. To compare commits, unpack the other one with ``git archive`` into a
directory that ``.gitignore`` lists and run the two in turns: other, this,
this, other.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", type=Path, default=HERE, help="root of the checkout to time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_step: no CUDA device is visible", file=sys.stderr)
        return 1
    # Run as a script, this file's own directory leads sys.path: drop it, so
    # that only DIR's package can be imported.
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != Path(__file__).resolve().parent]
    spec = importlib.util.spec_from_file_location("chip_smoke_here", HERE / "chip_smoke.py")
    cs = sys.modules[spec.name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, str(args.repo.resolve()))
    from svdformer_pointsea_tpu_torch import kernels
    from svdformer_pointsea_tpu_torch.configs import pcn_config
    from svdformer_pointsea_tpu_torch.nn import mixed_precision
    from svdformer_pointsea_tpu_torch.render import make_renderer
    from svdformer_pointsea_tpu_torch.train import build_model, init_state, make_train_step
    from svdformer_pointsea_tpu_torch.train.evaluate import disable_tf32, make_pcn_eval_fn

    if Path(kernels.__file__).resolve().parent.parent != args.repo.resolve():
        print(f"bench_step: imported {kernels.__file__}, not the package of {args.repo}",
              file=sys.stderr)
        return 1
    disable_tf32()
    kernels.build()
    cfg = pcn_config()
    out = {"repo": str(args.repo), "train_ms": {}, "eval_per_s": {}}

    batch = cs.synthetic_batches(np.random.RandomState(cs.SEED), n_batches=1)[0]
    partial, gt = (torch.as_tensor(batch.data[k], device="cuda") for k in ("partial_cloud", "gtcloud"))
    model = build_model(cfg, seed=cs.SEED).eval()
    eval_fn = make_pcn_eval_fn(model, make_renderer(cfg))
    for precision in ("f32", "bf16"):
        with mixed_precision(precision == "bf16"):
            ms = cs.cuda_ms(lambda: eval_fn(partial, gt), iters=5, warmup=1)
        out["eval_per_s"][precision] = cs.B_MAIN * 1000.0 / ms
    del model, eval_fn
    torch.cuda.empty_cache()

    batch = cs.synthetic_batches(np.random.RandomState(cs.SEED + 1), n_batches=1, bs=cs.B_TRAIN,
                                 n_partial=cfg.data.n_points)[0]
    partial, gt = (torch.as_tensor(batch.data[k], device="cuda") for k in ("partial_cloud", "gtcloud"))
    weights = torch.zeros(cs.B_TRAIN, device="cuda")
    weights[:batch.valid] = 1.0
    for precision in ("f32", "bf16"):
        model = build_model(cfg, seed=cs.SEED)
        state = [init_state(cfg, model)]
        step = make_train_step(model, state[0].optimizer, cfg.train.sqrt_loss,
                               make_renderer(cfg).get_img)

        def one():
            state[0], _ = step(state[0], partial, gt, weights, 1e-6)

        with mixed_precision(precision == "bf16"):
            out["train_ms"][precision] = cs.cuda_ms(one, iters=3, warmup=1)
        del model, state, step
        torch.cuda.empty_cache()
    out["device"] = cs.smi_line()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
