"""Synthetic datasets for runs where the real files are absent, under one
root, so that a configuration's relative paths resolve with that root as the
working directory:

- PCN (``configs.pcn_config()``): ``datasets/ShapeNet.json`` and
  ``dataset/PCN/<subset>/complete/<taxonomy>/<model>.pcd`` with
  ``partial/<taxonomy>/<model>/<NN>.pcd`` beside it;
- ShapeNet-55 (``configs.shapenet55_config()``): ``datasets/ShapeNet55/
  {train,test}.txt`` and ``shapenet_pc/<taxonomy>-<model>.npy``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Sequence, Tuple

import numpy as np

from svdformer_pointsea_tpu_torch.data.io import write_pcd

TAXONOMIES = ("02691156", "03001627")  # PCN's plane and chair ids


def _ellipsoid(rng: np.random.RandomState, n: int) -> np.ndarray:
    """n points on a random ellipsoid's surface, semi-axes 0.2-0.45."""
    axes = rng.uniform(0.2, 0.45, size=3)
    v = rng.randn(n, 3)
    return (v / np.linalg.norm(v, axis=1, keepdims=True) * axes).astype(np.float32)


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
            gt = _ellipsoid(rng, gt_points)
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


def write_55_tree(root: str, rng: np.random.RandomState, models: Dict[str, int],
                  gt_points: int = 8192, taxonomies: Sequence[str] = TAXONOMIES,
                  index_dir: str = "ShapeNet55") -> None:
    """Write ``models["train"]`` and ``models["test"]`` complete clouds of
    ``gt_points`` points on random ellipsoids as ``shapenet_pc/<taxonomy>-
    <model>.npy``, spread over ``taxonomies``, and their index files
    ``datasets/<index_dir>/{train,test}.txt``."""
    os.makedirs(os.path.join(root, "shapenet_pc"), exist_ok=True)
    os.makedirs(os.path.join(root, "datasets", index_dir), exist_ok=True)
    for subset in ("train", "test"):
        names = []
        for i in range(models.get(subset, 0)):
            name = f"{taxonomies[i % len(taxonomies)]}-{subset}{i:04d}.npy"
            np.save(os.path.join(root, "shapenet_pc", name), _ellipsoid(rng, gt_points))
            names.append(name)
        with open(os.path.join(root, "datasets", index_dir, f"{subset}.txt"), "w") as f:
            f.write("\n".join(names) + "\n")
