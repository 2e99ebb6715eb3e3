"""Command-line entry points of the PCN, ShapeNet-55, GeoSpecNet, PointSea
and KITTI tracks (semantics of svdformer_pointsea_tpu/cli.py ``main_pcn`` /
``main_55`` / ``main_geospec`` / ``main_pointsea`` / ``main_kitti``):
training by default, evaluation of ``--weights`` with ``--test`` or
``--inference`` (KITTI evaluates only), and on every track ``--complete PATH``:
completion of a user's scans with ``--weights`` (``train/infer.py``).

    python -m svdformer_pointsea_tpu_torch.cli pcn [--test|--inference] [--weights CKPT]
        [--out DIR] [--epochs N] [--precision f32|bf16] [--progress]
        [--complete PATH [--no-normalize]]
    python -m svdformer_pointsea_tpu_torch.cli 55 [the same flags]
        [--mode easy|median|hard] [--dataset 55|34|unseen21]
    python -m svdformer_pointsea_tpu_torch.cli geospec [the same flags as pcn] [--run_id N]
    python -m svdformer_pointsea_tpu_torch.cli pointsea [the same flags as pcn]
    python -m svdformer_pointsea_tpu_torch.cli kitti --weights CKPT [the same flags as pcn]

They run on the CUDA card unless the ``main_*`` function is called with
``device="cpu"``. The JAX package's ``--sp`` (> 1) and ``--dp shard_map``
are parsed and refused with the ROADMAP item that ports them.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sys
from pprint import pprint
from typing import Optional, Sequence

from svdformer_pointsea_tpu_torch.configs import (
    Config,
    geospec_config,
    kitti_config,
    pcn_config,
    pointsea_config,
    shapenet34_config,
    shapenet55_config,
)


def _parser(track: str = "pcn") -> argparse.ArgumentParser:
    model = {"geospec": "GeoSpecNet on pcn", "pointsea": "PointSea on pcn",
             "kitti": "a PCN-trained SVDFormer on kitti"}.get(track, f"SVDFormer on {track}")
    p = argparse.ArgumentParser(description=f"{model}, PyTorch / CUDA port")
    p.add_argument("--test", action="store_true", help="evaluate --weights on the test split")
    p.add_argument("--inference", action="store_true", help="the same as --test")
    p.add_argument("--weights", default=None, help="checkpoint to resume from or to evaluate")
    p.add_argument("--out", default=None, help="output directory")
    p.add_argument("--epochs", type=int, default=None, help="number of epochs")
    p.add_argument("--precision", default=None, choices=["f32", "bf16"],
                   help="f32 (default, reference-faithful) or bf16: bf16 image trunk and "
                        "flash-attention kernels, f32 parameters and optimizer")
    p.add_argument("--progress", action="store_true", help="live per-batch loss line")
    p.add_argument("--complete", default=None, metavar="PATH",
                   help="complete a .pcd/.npy/.h5/.txt file or a directory of them with "
                        "--weights, writing <stem>_completion.pcd beside each (or under --out)")
    p.add_argument("--no-normalize", action="store_true",
                   help="with --complete: feed the scans as they are, not moved into the PCN "
                        "frame (centroid at the origin, largest radius 0.5) and back")
    # Flags of the JAX package that this port refuses (ROADMAP queue A).
    p.add_argument("--sp", type=int, default=None, help="not ported: multi-GPU, item 15")
    p.add_argument("--dp", default=None, choices=["gspmd", "shard_map"],
                   help="not ported beyond one card: multi-GPU, item 15")
    if track == "55":
        p.add_argument("--mode", default=None, choices=["easy", "median", "hard"],
                       help="evaluation crop difficulty (default easy)")
        p.add_argument("--dataset", default="55", choices=["55", "34", "unseen21"],
                       help="index preset: ShapeNet-55, ShapeNet-34, or ShapeNet-Unseen21 "
                            "(a 34-trained model on the 21 held-out categories)")
    if track == "geospec":
        p.add_argument("--run_id", type=int, default=0,
                       help="run tag: a nonzero N writes to <out_path>_N")
    return p


def _refuse_unported(args) -> None:
    if args.sp is not None and args.sp > 1:
        raise SystemExit(f"--sp {args.sp}: sequence parallelism is multi-GPU work, "
                         "not ported yet (ROADMAP queue A item 15)")
    if args.dp == "shard_map":
        raise SystemExit("--dp shard_map: multi-GPU data parallelism is not ported yet "
                         "(ROADMAP queue A item 15)")


def _apply_overrides(cfg: Config, args) -> Config:
    train = {}
    if args.epochs is not None:
        train["n_epochs"] = args.epochs
    if args.precision:
        train["precision"] = args.precision
    if args.progress:
        train["progress"] = True
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, **train))
    if args.weights:
        cfg = cfg.replace(weights=args.weights)
    if args.out:
        cfg = cfg.replace(out_path=args.out)
    return cfg


def _dispatch(cfg: Config, args, device: Optional[str], **test_kw):
    from svdformer_pointsea_tpu_torch import train

    print("Use config:")
    pprint(cfg)
    if args.complete is not None:
        if cfg.weights is None:
            raise SystemExit("--complete needs a trained checkpoint (--weights)!")
        from svdformer_pointsea_tpu_torch.train.infer import infer_files

        outs = infer_files(cfg, args.complete, out_dir=args.out, normalize=not args.no_normalize,
                           device=device)
        print(f"wrote {len(outs)} completions")
        return outs
    if not args.test and not args.inference:
        if cfg.network.model == "geospecnet":
            return train.train_net_gan(cfg, device=device)
        return train.train_net(cfg, device=device)
    if cfg.weights is None:
        raise SystemExit("Please specify the path to a checkpoint (--weights)!")
    return train.test_net(cfg, device=device, **test_kw)


def _setup(track: str, argv):
    logging.basicConfig(format="[%(levelname)s] %(asctime)s %(message)s", level=logging.INFO)
    args = _parser(track).parse_args(argv)
    _refuse_unported(args)
    return args


def main_pcn(argv: Optional[Sequence[str]] = None, device: Optional[str] = None):
    """Train, or with ``--test`` / ``--inference`` evaluate, SVDFormer on PCN.
    Returns ``train_net``'s ``(state, best_metric)`` or ``test_net``'s mean CD."""
    args = _setup("pcn", argv)
    return _dispatch(_apply_overrides(pcn_config(), args), args, device)


def main_55(argv: Optional[Sequence[str]] = None, device: Optional[str] = None):
    """Train, or with ``--test`` / ``--inference`` evaluate, SVDFormer on
    ShapeNet-55 (``--dataset 34``: ShapeNet-34, ``unseen21``: its Unseen-21
    split), evaluating at the crop difficulty ``--mode``. Returns
    ``train_net``'s ``(state, best_metric)`` or ``test_net``'s mean CD."""
    args = _setup("55", argv)
    mode = args.mode or "easy"
    if args.dataset == "55":
        cfg = shapenet55_config(mode=mode)
    else:
        cfg = shapenet34_config(unseen=args.dataset == "unseen21", mode=mode)
    return _dispatch(_apply_overrides(cfg, args), args, device, mode=args.mode)


def main_geospec(argv: Optional[Sequence[str]] = None, device: Optional[str] = None):
    """Train GeoSpecNet with its discriminator on PCN (``train_net_gan``), or
    with ``--test`` / ``--inference`` evaluate the generator of ``--weights``;
    ``--run_id N`` (nonzero) appends ``_N`` to the output path. Returns
    ``train_net_gan``'s ``(state, best_metric)`` or ``test_net``'s mean CD."""
    args = _setup("geospec", argv)
    cfg = geospec_config()
    if args.run_id:
        cfg = cfg.replace(out_path=f"{cfg.out_path}_{args.run_id}")
    return _dispatch(_apply_overrides(cfg, args), args, device)


def main_pointsea(argv: Optional[Sequence[str]] = None, device: Optional[str] = None):
    """Train, or with ``--test`` / ``--inference`` evaluate, PointSea on PCN
    (``train_net`` / ``test_net`` with the realistic renderer). Returns
    ``train_net``'s ``(state, best_metric)`` or ``test_net``'s mean CD."""
    args = _setup("pointsea", argv)
    return _dispatch(_apply_overrides(pointsea_config(), args), args, device)


def main_kitti(argv: Optional[Sequence[str]] = None, device: Optional[str] = None):
    """Evaluate a PCN-trained SVDFormer (``--weights``, required) on KITTI's
    car scans, zero-shot: always ``--test``. Returns ``test_net``'s mean
    fidelity (or, with ``--complete``, the completions written)."""
    args = _setup("kitti", argv)
    args.test = True
    return _dispatch(_apply_overrides(kitti_config(), args), args, device)


_TRACKS = {"pcn": main_pcn, "55": main_55, "geospec": main_geospec, "pointsea": main_pointsea,
           "kitti": main_kitti}


def main(argv: Optional[Sequence[str]] = None):
    """``python -m svdformer_pointsea_tpu_torch.cli <track> [flags]``, the
    track one of ``pcn``, ``55``, ``geospec``, ``pointsea`` and ``kitti``."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in _TRACKS:
        track = argv[0] if argv else "no track"
        raise SystemExit(f"usage: python -m svdformer_pointsea_tpu_torch.cli "
                         f"{'|'.join(_TRACKS)} [flags] (got {track})")
    return _TRACKS[argv[0]](argv[1:])


if __name__ == "__main__":
    main()
