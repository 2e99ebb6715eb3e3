"""Completion of a user's own scans (semantics of
svdformer_pointsea_tpu/train/infer.py, ``--complete PATH``): a ``.pcd``,
``.npy``, ``.h5`` or ``.txt`` file, or a directory of them, each completed
and written as ``<stem>_completion.pcd`` beside it (or under ``out_dir``).

Each scan is optionally moved into the PCN frame (centroid at the origin,
largest radius 0.5), resampled to the model's partial size as PCN's
``UpSamplePoints`` does (every real point kept, topped up by repeats; a
random subset when longer), completed in batches of a fixed size (the last
one filled by repeating its scans, whose completions are dropped) and mapped
back into the scan's frame.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from svdformer_pointsea_tpu_torch.data.io import IO
from svdformer_pointsea_tpu_torch.nn.precision import mixed_precision
from svdformer_pointsea_tpu_torch.render import make_renderer
from svdformer_pointsea_tpu_torch.train.evaluate import disable_tf32

SUPPORTED_EXTS = (".pcd", ".npy", ".h5", ".txt")


def _load_xyz(path: str) -> np.ndarray:
    """The xyz columns (N, 3) f32 of a point file: a 2-D array of at least 3
    columns (xyz first, then e.g. intensity or colour), or a flat xyz
    stream; anything else raises."""
    pts = np.asarray(IO.get(path), dtype=np.float32)
    if pts.ndim == 1 and pts.size % 3 == 0:
        pts = pts.reshape(-1, 3)
    if pts.ndim != 2 or pts.shape[1] < 3:
        raise ValueError(f"{path}: expected an (N, >=3) point array (xyz in the first "
                         f"three columns), got shape {pts.shape}")
    if pts.shape[0] == 0:
        raise ValueError(f"{path}: empty point cloud")
    return np.ascontiguousarray(pts[:, :3])


def _collect_inputs(path: str) -> List[str]:
    """``path`` if it is a supported file, else the supported files of the
    directory ``path`` (earlier completions left out), sorted."""
    if os.path.isdir(path):
        files = sorted(os.path.join(path, f) for f in os.listdir(path)
                       if f.lower().endswith(SUPPORTED_EXTS)
                       and not f.lower().endswith("_completion.pcd"))
        if not files:
            raise FileNotFoundError(f"no {'/'.join(SUPPORTED_EXTS)} files under {path}")
        return files
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if not path.lower().endswith(SUPPORTED_EXTS):
        raise ValueError(f"unsupported input {path!r} (expected one of {SUPPORTED_EXTS})")
    return [path]


def _resample(pts: np.ndarray, n: int, rng: np.random.RandomState) -> np.ndarray:
    """``n`` rows of ``pts``: a subset without replacement of a longer scan;
    every row of a shorter one, topped up with rows drawn with replacement
    (never zeros)."""
    m = pts.shape[0]
    if m >= n:
        idx = rng.choice(m, n, replace=False)
    else:
        idx = np.concatenate([np.arange(m), rng.choice(m, n - m, replace=True)])
    return pts[idx]


def _to_pcn_frame(pts: np.ndarray) -> Tuple[np.ndarray, np.ndarray, float]:
    """(the scan centred with its largest radius scaled to 0.5, centroid,
    scale)."""
    centroid = pts.mean(axis=0)
    centered = pts - centroid
    radius = float(np.linalg.norm(centered, axis=1).max())
    scale = (0.5 / radius) if radius > 0 else 1.0
    return centered * scale, centroid, scale


def infer_files(cfg, path: str, out_dir: Optional[str] = None, batch_size: Optional[int] = None,
                normalize: bool = True, seed: int = 1, device: Optional[str] = None) -> List[str]:
    """Complete every point file at ``path`` with the model of ``cfg``
    (``cfg.weights``: a checkpoint of this port; without it the weights are
    random, with a warning) on ``device`` (default: the CUDA card), in bf16
    mode where ``cfg.train.precision`` says so; returns the written paths.
    The batch holds ``batch_size`` scans (default: the files' count, at most
    ``cfg.train.batch_size``); the resampling draws come from
    ``RandomState(seed)``, file by file."""
    from svdformer_pointsea_tpu_torch.train.loop import (build_model, init_state,
                                                         load_weights_into_state)

    files = _collect_inputs(path)
    with mixed_precision(cfg.train.precision == "bf16"):
        model = build_model(cfg, device=device, seed=cfg.seed)
        if cfg.weights:
            model = load_weights_into_state(init_state(cfg, model), cfg).model
        else:
            logging.warning("infer_files: no --weights given: completing with random weights "
                            "(a smoke test; the completions mean nothing)")
        render = make_renderer(cfg)
        disable_tf32()
        model.eval()
        dev = next(model.parameters()).device
        B = int(batch_size or min(len(files), cfg.train.batch_size))
        rng = np.random.RandomState(seed)
        outputs: List[str] = []
        for lo in range(0, len(files), B):
            chunk = files[lo:lo + B]
            frames, rows = [], []
            for f in chunk:
                pts = _load_xyz(f)
                if normalize:
                    pts, centroid, scale = _to_pcn_frame(pts)
                else:
                    centroid, scale = np.zeros(3, np.float32), 1.0
                frames.append((centroid, scale))
                rows.append(_resample(pts, cfg.data.n_points, rng))
            batch = torch.as_tensor(np.stack([rows[i % len(rows)] for i in range(B)]), device=dev)
            with torch.inference_mode():
                completions = model(batch, render.get_img(batch))[-1][:len(chunk)]
            for f, (centroid, scale), comp in zip(chunk, frames, completions.float().cpu().numpy()):
                dest_dir = out_dir or os.path.dirname(f) or "."
                os.makedirs(dest_dir, exist_ok=True)
                dest = os.path.join(dest_dir,
                                    f"{os.path.splitext(os.path.basename(f))[0]}_completion.pcd")
                IO.put(dest, (comp / scale + centroid).astype(np.float32))
                outputs.append(dest)
                logging.info("completed %s -> %s", f, dest)
    return outputs
