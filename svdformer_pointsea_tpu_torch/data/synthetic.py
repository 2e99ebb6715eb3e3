"""A synthetic dataset in the PCN layout, for runs where the real PCN files
are absent: ``datasets/ShapeNet.json`` and ``dataset/PCN/<subset>/complete/
<taxonomy>/<model>.pcd`` with ``partial/<taxonomy>/<model>/<NN>.pcd`` beside
it, under one root, so ``configs.pcn_config()``'s relative paths resolve with
that root as the working directory."""

from __future__ import annotations

import json
import os
from typing import Dict, Sequence, Tuple

import numpy as np

from svdformer_pointsea_tpu_torch.data.io import write_pcd

TAXONOMIES = ("02691156", "03001627")  # PCN's plane and chair ids


def write_pcn_tree(root: str, rng: np.random.RandomState, models: Dict[str, int],
                   n_renderings: int = 8, gt_points: int = 16384,
                   partial_points: Tuple[int, int] = (1536, 2560),
                   taxonomies: Sequence[str] = TAXONOMIES) -> None:
    """Write ``models[subset]`` models per subset (train, val, test), spread
    over ``taxonomies``. Each complete cloud is ``gt_points`` points on a
    random ellipsoid; each partial scan (``n_renderings`` per training and
    validation model, scan 00 for a test model) is a one-sided crop of it
    with a point count drawn from ``partial_points``, so the loader both
    up-samples and down-samples partials to ``n_points``."""
    index = [{"taxonomy_id": tax, "taxonomy_name": tax, "train": [], "val": [], "test": []}
             for tax in taxonomies]
    for subset, count in models.items():
        for i in range(count):
            entry = index[i % len(index)]
            mid = f"{subset}{i:04d}"
            entry[subset].append(mid)
            axes = rng.uniform(0.2, 0.45, size=3)
            v = rng.randn(gt_points, 3)
            gt = (v / np.linalg.norm(v, axis=1, keepdims=True) * axes).astype(np.float32)
            base = os.path.join(root, "dataset", "PCN", subset)
            os.makedirs(os.path.join(base, "complete", entry["taxonomy_id"]), exist_ok=True)
            write_pcd(os.path.join(base, "complete", entry["taxonomy_id"], f"{mid}.pcd"), gt)
            pdir = os.path.join(base, "partial", entry["taxonomy_id"], mid)
            os.makedirs(pdir, exist_ok=True)
            for r in range(n_renderings if subset == "train" else 1):
                cut = gt[gt @ rng.randn(3) > 0]
                n = rng.randint(*partial_points)
                pick = rng.choice(len(cut), n, replace=len(cut) < n)
                write_pcd(os.path.join(pdir, f"{r:02d}.pcd"), cut[pick])
    os.makedirs(os.path.join(root, "datasets"), exist_ok=True)
    with open(os.path.join(root, "datasets", "ShapeNet.json"), "w") as f:
        json.dump(index, f)
