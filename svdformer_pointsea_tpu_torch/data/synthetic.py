"""Synthetic datasets for runs where the real files are absent, under one
root, so that a configuration's relative paths resolve with that root as the
working directory:

- PCN (``configs.pcn_config()``): ``datasets/ShapeNet.json`` and
  ``dataset/PCN/<subset>/complete/<taxonomy>/<model>.pcd`` with
  ``partial/<taxonomy>/<model>/<NN>.pcd`` beside it;
- ShapeNet-55 (``configs.shapenet55_config()``): ``datasets/ShapeNet55/
  {train,test}.txt`` and ``shapenet_pc/<taxonomy>-<model>.npy``;
- KITTI (``configs.kitti_config()``): ``datasets/KITTI.json``,
  ``dataset/KITTI/cars/<id>.pcd`` and ``dataset/KITTI/bboxes/<id>.txt``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Tuple

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


KITTI_CAR = "02958343"  # ShapeNet's car taxonomy, KITTI.json's one category


def _box_scan(rng: np.random.RandomState, n: int):
    """A car-sized box (length 3.5-4.5, width 1.5-1.8, height 1.4-1.6) on
    the ground 1.7 below a sensor at the origin, yawed at random and 5-30
    ahead, and ``n`` points on two or three of its faces the sensor sees
    (the near side, the near end, sometimes the roof), with 1 cm noise.
    Returns (points (n, 3), the 8 corners (8, 3)): corners 0-3 on the
    ground, 0 -> 3 along the length, 4-7 above them."""
    length, width, height = rng.uniform(3.5, 4.5), rng.uniform(1.5, 1.8), rng.uniform(1.4, 1.6)
    yaw = rng.uniform(-np.pi, np.pi)
    rot = np.asarray([[np.cos(yaw), -np.sin(yaw), 0.0], [np.sin(yaw), np.cos(yaw), 0.0],
                      [0.0, 0.0, 1.0]])
    offset = np.asarray([rng.uniform(5.0, 30.0), rng.uniform(-10.0, 10.0), -1.7])
    hl, hw = length / 2, width / 2
    local = np.asarray([[-hl, -hw, 0], [-hl, hw, 0], [hl, hw, 0], [hl, -hw, 0]], np.float64)
    corners = np.concatenate([local, local + [0, 0, height]])
    sensor = rot.T @ -offset  # the sensor in the box's frame
    side, end = np.sign(sensor[1]) * hw, np.sign(sensor[0]) * hl
    faces = [lambda u, v: np.stack([(2 * u - 1) * hl, np.full_like(u, side), v * height], -1),
             lambda u, v: np.stack([np.full_like(u, end), (2 * u - 1) * hw, v * height], -1)]
    if rng.rand() < 0.5:
        faces.append(lambda u, v: np.stack([(2 * u - 1) * hl, (2 * v - 1) * hw,
                                            np.full_like(u, height)], -1))
    which = rng.randint(len(faces), size=n)
    u, v = rng.rand(n), rng.rand(n)
    pts = np.empty((n, 3))
    for i, face in enumerate(faces):
        pts[which == i] = face(u[which == i], v[which == i])
    pts += 0.01 * rng.randn(n, 3)
    return ((pts @ rot.T) + offset).astype(np.float32), corners @ rot.T + offset


def write_kitti_tree(root: str, rng: np.random.RandomState, n_scans: int,
                     points: Tuple[int, int] = (60, 3000), n_points: int = 2048) -> List[str]:
    """Write ``n_scans`` synthetic car scans in KITTI's layout: each a
    :func:`_box_scan`, its corners as text, and the index of one category
    with only ``test`` ids. Returns the ids. Point counts lie in ``points``:
    most are drawn log-uniformly below the model's ``n_points``, so that the
    loader zero-pads them, as it does most real scans; every eighth scan
    (ids 7, 15, ...) is drawn uniformly above it."""
    cars = os.path.join(root, "dataset", "KITTI", "cars")
    boxes = os.path.join(root, "dataset", "KITTI", "bboxes")
    os.makedirs(cars, exist_ok=True)
    os.makedirs(boxes, exist_ok=True)
    ids = []
    for i in range(n_scans):
        if i % 8 == 7:
            n = rng.randint(n_points + 1, points[1] + 1)
        else:
            n = int(np.exp(rng.uniform(np.log(points[0]), np.log(n_points))))
        pts, corners = _box_scan(rng, n)
        sid = f"frame_{i}_car_0"
        write_pcd(os.path.join(cars, f"{sid}.pcd"), pts)
        np.savetxt(os.path.join(boxes, f"{sid}.txt"), corners, fmt="%.6f")
        ids.append(sid)
    os.makedirs(os.path.join(root, "datasets"), exist_ok=True)
    with open(os.path.join(root, "datasets", "KITTI.json"), "w") as f:
        json.dump([{"taxonomy_id": KITTI_CAR, "taxonomy_name": "car", "test": ids}], f)
    return ids
