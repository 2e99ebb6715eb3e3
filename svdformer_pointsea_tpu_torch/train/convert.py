"""Weights from the JAX package to the port.

``params_from_jax`` walks a flax ``{"params", "batch_stats"}`` tree (numpy or
array leaves; nothing of JAX is imported) and returns the port's
``state_dict``, for ``model.load_state_dict(..., strict=True)``. The port's
modules carry the JAX tree's names, so the walk only renames leaves and
transforms layouts:

- Dense ``kernel`` (in, out) -> Linear ``weight`` (out, in);
- Conv ``kernel`` HWIO -> Conv2d ``weight`` OIHW;
- LayerNorm / BatchNorm ``scale`` -> ``weight``; ``bias`` stays;
- BatchNorm ``mean`` / ``var`` -> ``running_mean`` / ``running_var``;
- a raw parameter (``SpectralAdapter.freq_gate``) keeps its name and layout.

Every leaf keeps all its values. In particular the seed layer
``encoder.ps`` keeps its full (64 * 128) bias: a JAX-trained tree need not
repeat one value per channel as the original ConvTranspose1d bias does.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Tuple

import numpy as np
import torch

_STATS = {"mean": "running_mean", "var": "running_var"}
_RAW = {"freq_gate"}  # parameters that are not a layer's kernel, scale or bias


def _leaf(collection: str, key: str, arr: np.ndarray) -> Tuple[str, np.ndarray]:
    if collection == "batch_stats":
        return _STATS[key], arr
    if key == "kernel":
        if arr.ndim == 2:
            return "weight", arr.T
        if arr.ndim == 4:
            return "weight", arr.transpose(3, 2, 0, 1)
        raise ValueError(f"kernel of rank {arr.ndim}")
    if key == "scale":
        return "weight", arr
    if key in ("bias", *_RAW):
        return key, arr
    raise KeyError(f"unhandled parameter leaf {key!r}")


def params_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX variables tree -> the port's ``state_dict`` (f32 CPU tensors, copied)."""
    state: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping, prefix: Tuple[str, ...], collection: str) -> None:
        for key, val in tree.items():
            if isinstance(val, Mapping):
                walk(val, prefix + (key,), collection)
                continue
            name, arr = _leaf(collection, key, np.asarray(val, dtype=np.float32))
            state[".".join(prefix + (name,))] = torch.tensor(np.ascontiguousarray(arr))

    for collection in ("params", "batch_stats"):
        walk(variables.get(collection, {}), (), collection)
    return state
