"""The mixed-precision switch (counterpart of svdformer_pointsea_tpu/nn/precision.py).

``set_mixed_precision(True)`` (``--precision bf16``) changes two things, each
read when the module runs:

- the image trunk (``nn/resnet.py``) computes in bf16: each convolution takes
  its input and weight in bf16 and gives a bf16 output; each BatchNorm takes
  its batch moments in f32 from the upcast input and applies a bf16 affine
  (``mul`` and ``shift`` rounded to bf16); the final mean pools in f32;
- an attention site that the flash kernels take (a CUDA tensor of eligible
  shape, ``nn/layers.py::scaled_attention``) casts q, k and v to bf16 and its
  output back to the input's dtype, so the bf16 flash kernels run.

Parameters, optimizer state, losses, chamfer / metrics, FPS and K1 stay f32.
Off by default: f32 is the reference-faithful path.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

_MIXED_PRECISION = False


def set_mixed_precision(enabled: bool) -> None:
    """bf16 compute for the image trunk and the flash-attention inputs."""
    global _MIXED_PRECISION
    _MIXED_PRECISION = bool(enabled)


def mixed_precision_enabled() -> bool:
    return _MIXED_PRECISION


@contextlib.contextmanager
def mixed_precision(enabled: bool) -> Iterator[None]:
    """The switch set to ``enabled`` inside the block, restored after it."""
    prev = _MIXED_PRECISION
    set_mixed_precision(enabled)
    try:
        yield
    finally:
        set_mixed_precision(prev)
