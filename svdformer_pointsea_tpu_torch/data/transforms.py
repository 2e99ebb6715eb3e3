"""The numpy point-cloud transforms of the PCN and KITTI pipelines and
ShapeNet-55's normalisation (semantics of
svdformer_pointsea_tpu/data/transforms.py): every random draw comes from the
``np.random.RandomState`` the caller passes, in the JAX package's order, so
the same state gives the same arrays. The image transforms are ROADMAP queue
A."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def up_sample_points(ptcloud: np.ndarray, n_points: int, rng: np.random.RandomState) -> np.ndarray:
    """Exactly ``n_points`` rows: a random subset of a larger cloud, or a
    smaller one tiled and topped up with a random permutation of its rows."""
    curr = ptcloud.shape[0]
    need = n_points - curr
    if need < 0:
        return ptcloud[rng.permutation(n_points)]
    while curr <= need:
        ptcloud = np.tile(ptcloud, (2, 1))
        need -= curr
        curr *= 2
    choice = rng.permutation(need)
    return np.concatenate([ptcloud, ptcloud[choice]])


def random_sample_points(ptcloud: np.ndarray, n_points: int,
                         rng: np.random.RandomState) -> np.ndarray:
    """A random subset of at most ``n_points`` rows, zero-padded to
    ``n_points``."""
    choice = rng.permutation(ptcloud.shape[0])
    ptcloud = ptcloud[choice[:n_points]]
    if ptcloud.shape[0] < n_points:
        zeros = np.zeros((n_points - ptcloud.shape[0], 3), ptcloud.dtype)
        ptcloud = np.concatenate([ptcloud, zeros])
    return ptcloud


def pc_norm(pc: np.ndarray) -> np.ndarray:
    """Centre on the centroid and scale into the unit sphere."""
    centroid = np.mean(pc, axis=0)
    pc = pc - centroid
    m = np.max(np.sqrt(np.sum(pc**2, axis=1)))
    return pc / m


_MIRROR_X = np.diag([-1.0, 1.0, 1.0]).astype(np.float32)
_MIRROR_Z = np.diag([1.0, 1.0, -1.0]).astype(np.float32)


def random_mirror_matrix(rnd_value: float) -> np.ndarray:
    """Mirror in x and z, x, z or none, by the quartile of ``rnd_value``."""
    m = np.eye(3, dtype=np.float32)
    if rnd_value <= 0.25:
        m = _MIRROR_Z @ _MIRROR_X @ m
    elif rnd_value <= 0.5:
        m = _MIRROR_X @ m
    elif rnd_value <= 0.75:
        m = _MIRROR_Z @ m
    return m


def random_mirror_points(ptcloud: np.ndarray, rnd_value: float) -> np.ndarray:
    m = random_mirror_matrix(rnd_value)
    out = ptcloud.copy()
    out[:, :3] = ptcloud[:, :3] @ m.T
    return out


def random_rotate_points(ptcloud: np.ndarray, rnd_value: float) -> np.ndarray:
    """Rotation about +y by 2π·``rnd_value``."""
    angle = 2 * np.pi * rnd_value
    c, s = np.cos(angle), np.sin(angle)
    rot = np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    out = ptcloud.copy()
    out[:, :3] = ptcloud[:, :3] @ rot.T
    return out


def scale_points(ptcloud: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """Scale by a random 0.85 to 0.94 in steps of 0.01."""
    return ptcloud * (rng.randint(85, 95) * 0.01)


def random_clip_points(ptcloud: np.ndarray, rng: np.random.RandomState, sigma: float = 0.01,
                       clip: float = 0.05) -> np.ndarray:
    """Gaussian jitter of ``sigma``, clipped to ±``clip``."""
    noise = np.clip(sigma * rng.randn(*ptcloud.shape), -clip, clip)
    return ptcloud + noise.astype(np.float32)


def normalize_object_pose(ptcloud: np.ndarray, bbox: np.ndarray):
    """KITTI's pose normalisation from the car's 8 bounding-box corners
    (corner 0 to corner 3 along its length), in f64: centre the box, turn
    its length onto +x, scale the length to 1, then swap y and z into the
    PCN frame (y up). Returns (the cloud, the box), both f32. The JAX
    package stores the fully normalised box, where the original rotated and
    scaled only its local copy; nothing reads the box afterwards."""
    bbox = bbox.copy().astype(np.float64)
    center = (bbox.min(0) + bbox.max(0)) / 2
    bbox -= center
    yaw = np.arctan2(bbox[3, 1] - bbox[0, 1], bbox[3, 0] - bbox[0, 0])
    rotation = np.asarray([[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0],
                           [0, 0, 1]])
    bbox = bbox @ rotation
    scale = bbox[3, 0] - bbox[0, 0]
    bbox /= scale
    ptcloud = (ptcloud - center) @ rotation / scale
    ptcloud = ptcloud @ np.asarray([[1, 0, 0], [0, 0, 1], [0, 1, 0]], ptcloud.dtype)
    return ptcloud.astype(np.float32), bbox.astype(np.float32)


class Compose:
    """A pipeline of ``{callback, parameters, objects}`` steps over a sample
    dict. Each step draws one ``uniform(0, 1)`` first, shared by every object
    it transforms (so the partial and complete clouds mirror alike).
    ``NormalizeObjectPose`` runs once on the whole sample, on the cloud and
    box that its ``input_keys`` name."""

    def __init__(self, steps: Sequence[Dict], rng: np.random.RandomState):
        self.steps = steps
        self.rng = rng

    def __call__(self, data: Dict[str, np.ndarray],
                 rng: "np.random.RandomState | None" = None) -> Dict[str, np.ndarray]:
        r = self.rng if rng is None else rng
        for step in self.steps:
            cb = step["callback"]
            params = step.get("parameters", {})
            objects = step.get("objects", ())
            rnd_value = r.uniform(0, 1)
            if cb == "NormalizeObjectPose":
                keys = params["input_keys"]
                data[keys["ptcloud"]], data[keys["bbox"]] = normalize_object_pose(
                    data[keys["ptcloud"]], data[keys["bbox"]])
                continue
            for k in list(data.keys()):
                if k not in objects:
                    continue
                if cb == "UpSamplePoints":
                    data[k] = up_sample_points(data[k], params["n_points"], r)
                elif cb == "RandomSamplePoints":
                    data[k] = random_sample_points(data[k], params["n_points"], r)
                elif cb == "RandomMirrorPoints":
                    data[k] = random_mirror_points(data[k], rnd_value)
                elif cb == "RandomRotatePoints":
                    data[k] = random_rotate_points(data[k], rnd_value)
                elif cb == "ScalePoints":
                    data[k] = scale_points(data[k], r)
                elif cb == "RandomClipPoints":
                    data[k] = random_clip_points(data[k], r, sigma=params.get("sigma", 0.01),
                                                 clip=params.get("clip", 0.05))
                elif cb == "ToArray":
                    data[k] = np.ascontiguousarray(data[k], np.float32)
                else:
                    raise ValueError(f"transform {cb} is not ported (the image transforms "
                                     "are ROADMAP queue A)")
        return data
