"""Helpers that hold the PyTorch port against the JAX package on the CPU.

Inputs and weights come from numpy seeds and go to both sides as numpy
arrays. A test module that imports :func:`jax_reference_modes` and lists it in
``pytestmark`` runs JAX with exact kNN and without the Pallas flash path.
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svdformer_pointsea_tpu import nn as jnn
from svdformer_pointsea_tpu import ops as jops
from svdformer_pointsea_tpu.nn import layers as jax_layers
from svdformer_pointsea_tpu.nn import precision as jax_precision
from svdformer_pointsea_tpu.ops import distances as jax_distances
from svdformer_pointsea_tpu_torch.train.convert import params_from_jax


@pytest.fixture(scope="module")
def jax_reference_modes():
    """Exact kNN and no Pallas flash attention in the JAX package for one
    test module; the modes it had come back afterwards."""
    knn, flash = jax_distances._KNN_MODE, jax_layers._FLASH_ENABLED
    jops.set_knn_mode("exact")
    jnn.set_flash_attention(False)
    yield
    jops.set_knn_mode(knn)
    jnn.set_flash_attention(flash)


@pytest.fixture
def jax_difference_form_nn(monkeypatch):
    """The JAX package's NN search in the difference form for one test.

    Off the TPU, the JAX package computes nearest distances in the matmul
    form |a|² − 2a·b + |b|² (ops/distances.py:186-209), whose cancellation
    error is ~1e-8 absolute: at a close pair that is a relative error of
    1e-5 or more in d, and twice that in the gradient of sqrt(d). Its TPU
    kernel K1 (ops/nn_pallas.py) and the port use the difference form
    (dx·dx + dy·dy) + dz·dz, so a test of the loss's gradient holds the port
    against that form.
    """

    def nn_one_way(a, b):
        diff = a.astype(jnp.float32)[:, :, None, :] - b.astype(jnp.float32)[:, None, :, :]
        d = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] + diff[..., 2] * diff[..., 2]
        return jnp.min(d, axis=-1), jnp.argmin(d, axis=-1).astype(jnp.int32)

    monkeypatch.setattr(jax_distances, "_nn_one_way", nn_one_way)


def _blocked_sum(a, axis=None, keepdims=False, block: int = 512):
    """``jnp.sum`` in two levels: the reduced elements in blocks of ``block``,
    each block summed, then the block sums, with an optimization barrier
    between so that XLA keeps the two levels apart. The rounding error of a
    sum of n grows with about n / block + block additions instead of n."""
    a = jnp.asarray(a)
    axes = tuple(range(a.ndim)) if axis is None else tuple(
        int(d) % a.ndim for d in np.atleast_1d(axis))
    keep = tuple(d for d in range(a.ndim) if d not in axes)
    x = jnp.transpose(a, axes + keep).reshape((-1,) + tuple(a.shape[d] for d in keep))
    pad = (-x.shape[0]) % block
    if pad:
        x = jnp.concatenate([x, jnp.zeros((pad,) + x.shape[1:], x.dtype)])
    part = jax.lax.optimization_barrier(jnp.sum(x.reshape((-1, block) + x.shape[1:]), axis=1))
    out = jnp.sum(part, axis=0)
    return jnp.expand_dims(out, axes) if keepdims else out


class _BlockedSums:
    """``jax.numpy`` with :func:`_blocked_sum` as its ``sum``."""

    sum = staticmethod(_blocked_sum)

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture
def jax_blocked_bn_sums(monkeypatch):
    """The JAX package's train-mode BatchNorm moments summed in blocks for one
    test (``jnp.sum`` in nn/layers.py, where the BatchNorms sum).

    Off the TPU, XLA sums a reduction over the leading axes of a channels-last
    tensor one row after another, so that its rounding error grows with the
    number of rows, and adding one value many times rounds the same way each
    time. A realistic render repeats its background value over most of its
    224² pixels: the batch sums of ResNet-18's BatchNorms then lose digits,
    and the E[x²] - mean² variance amplifies that, so the JAX
    trunk's train-mode output strays from an f64 evaluation far more than
    the port's (whose CPU and CUDA sums are cascaded or tree-shaped). A test
    of the train step on such renders holds the port against blocked sums.
    """
    monkeypatch.setattr(jax_layers, "jnp", _BlockedSums())


@contextlib.contextmanager
def jax_mixed_precision(enabled: bool = True):
    """The JAX package's mixed-precision switch set to ``enabled`` for the
    block (trace inside it: the switch is read at trace time), restored after."""
    prev = jax_precision.mixed_precision_enabled()
    jax_precision.set_mixed_precision(enabled)
    try:
        yield
    finally:
        jax_precision.set_mixed_precision(prev)


# eval_shape results by (module, input shapes past the batch axis, kwargs):
# a model's variables do not depend on its batch size, and tracing a whole
# model's init takes seconds, which several test modules would repeat.
_SHAPES: dict = {}


def jax_variables(module, *args, seed: int = 0, **kwargs):
    """Random numpy variables for a flax ``module`` (shapes from
    ``eval_shape``, so nothing is compiled; traced once per module and input
    shape in a process): Dense / Conv kernels ~ N(0, 1/fan_in), biases and
    BatchNorm shifts ~ 0.1 N(0, 1), scales ~ 1 + 0.1 N(0, 1), running means
    ~ 0.1 N(0, 1), running variances ~ U(0.5, 1.5)."""
    key = (type(module), repr(module), tuple(np.shape(a)[1:] for a in args),
           tuple(sorted(kwargs.items())))
    if key not in _SHAPES:
        _SHAPES[key] = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args, **kwargs)
    shapes = _SHAPES[key]
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "var":
            v = rng.uniform(0.5, 1.5, s.shape)
        elif name in ("mean", "bias"):
            v = 0.1 * rng.randn(*s.shape)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.randn(*s.shape)
        else:
            v = rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def load_port(module: torch.nn.Module, variables) -> torch.nn.Module:
    """Load JAX ``variables`` into the port ``module`` (strict) in eval mode."""
    module.load_state_dict(params_from_jax(variables), strict=True)
    return module.eval()


def t(x) -> torch.Tensor:
    """numpy / JAX array -> CPU torch tensor (a copy)."""
    return torch.from_numpy(np.array(x))


def close(port_out, jax_out, atol: float, rtol: float = 0.0) -> None:
    np.testing.assert_allclose(
        port_out.detach().numpy() if isinstance(port_out, torch.Tensor) else np.asarray(port_out),
        np.asarray(jax_out), atol=atol, rtol=rtol)
