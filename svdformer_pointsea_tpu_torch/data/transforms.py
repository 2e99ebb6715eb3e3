"""The numpy transforms of the PCN pipelines and ShapeNet-55's normalisation
(semantics of svdformer_pointsea_tpu/data/transforms.py): every random draw
comes from the ``np.random.RandomState`` the caller passes, in the JAX
package's order, so the same state gives the same arrays."""

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


class Compose:
    """A pipeline of ``{callback, parameters, objects}`` steps over a sample
    dict. Each step draws one ``uniform(0, 1)`` first, shared by every object
    it transforms (so the partial and complete clouds mirror alike)."""

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
            for k in list(data.keys()):
                if k not in objects:
                    continue
                if cb == "UpSamplePoints":
                    data[k] = up_sample_points(data[k], params["n_points"], r)
                elif cb == "RandomMirrorPoints":
                    data[k] = random_mirror_points(data[k], rnd_value)
                elif cb == "ToArray":
                    data[k] = np.ascontiguousarray(data[k], np.float32)
                else:
                    raise ValueError(f"transform {cb} is not ported (the PCN pipelines "
                                     "use UpSamplePoints, RandomMirrorPoints and ToArray)")
        return data
