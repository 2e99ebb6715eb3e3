"""Build, bind and count the port's hand-written CUDA kernels.

Each ``csrc/<source>.cu`` has plain C entry points and is compiled on first
use with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into its own shared
library under ``build/torch_kernels/`` of the checkout, then loaded with
``ctypes``. One source may hold several kernels (``flash_attn_split_bwd.cu``:
the f32 K4 and K5 and the split pass that feeds them; ``flash_attn_bf16_bwd.cu``:
the bf16 K4 and K5) or serve two kernel names (``flash_attn_split_fwd.cu`` and
``flash_attn_bf16_fwd.cu``: K3 without and with its row statistics), each with
its own launch counter. The tensor-core sources include ``csrc/sm90.cuh`` (the
f32 ones through ``csrc/split.cuh``), and K1 and K2 (``nn_distance.cu``,
``fps.cu``) the mbarrier and thread-block-cluster helpers of
``csrc/cluster.cuh``, which ``sm90.cuh`` includes too; a library's name
hashes its source, the headers and the flags. Nothing is compiled or loaded
at import time, so the package imports on a machine without a GPU or a CUDA
toolkit.

Every wrapper in ``ops/`` and ``nn/`` decides its path the same way
(:func:`use_kernel`): a CPU tensor takes the plain PyTorch version, a CUDA
tensor launches the kernel or raises. :func:`reference_ops` forces the plain
versions on CUDA tensors too, so that a run can hold the kernels against them.
``launches`` counts kernel launches per kernel name; only a wrapper that has
just launched its kernel adds to it.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterator

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# kernel name -> (source csrc/<source>.cu, C entry point, argtypes). A source
# may serve several names: the name is what the launch counters count.
_ENTRY = {
    # K1 and K2 take their launch plans (ops/distances.py::nn_launch_plan,
    # ops/fps.py::fps_launch_plan) as their last integer arguments.
    "nn_distance": ("nn_distance", "nn_one_way_launch",
                    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    "fps": ("fps", "fps_launch", [_P, _P, _I, _I, _I, _I, _I, _I, _P]),
    # The f32 K3 without and with the row statistics (one kernel, lse null or
    # not), K4 and K5, all on the bf16 tensor cores, on the three bf16 planes
    # (hi, mid, lo) of q, k, v and dO that the split pass makes.
    "flash_attn": ("flash_attn_split_fwd", "flash_attn_split_fwd_launch",
                   [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]),
    "flash_attn_stats": ("flash_attn_split_fwd", "flash_attn_split_fwd_launch",
                         [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]),
    "flash_attn_bwd_dkv": ("flash_attn_split_bwd", "flash_attn_split_bwd_dkv_launch",
                           [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]),
    "flash_attn_bwd_dq": ("flash_attn_split_bwd", "flash_attn_split_bwd_dq_launch",
                          [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]),
    "split_bf16x3": ("flash_attn_split_bwd", "split_bf16x3_launch", [_P, _P, _L, _P]),
    # The bf16 instances of K3 (without and with statistics), K4 and K5, on
    # TMA and wgmma (--precision bf16).
    "flash_attn_bf16": ("flash_attn_bf16_fwd", "flash_attn_bf16_fwd_launch",
                        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]),
    "flash_attn_stats_bf16": ("flash_attn_bf16_fwd", "flash_attn_bf16_fwd_launch",
                              [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]),
    "flash_attn_bwd_dkv_bf16": ("flash_attn_bf16_bwd", "flash_attn_bf16_bwd_dkv_launch",
                                [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]),
    "flash_attn_bwd_dq_bf16": ("flash_attn_bf16_bwd", "flash_attn_bf16_bwd_dq_launch",
                               [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]),
}
KERNEL_NAMES = tuple(_ENTRY)
SOURCES = tuple(dict.fromkeys(src for src, _, _ in _ENTRY.values()))

launches: Dict[str, int] = {name: 0 for name in KERNEL_NAMES}

_libs: Dict[str, ctypes.CDLL] = {}  # source -> loaded library
_lock = threading.Lock()
_plain_forced = False
_sm_counts: Dict[int, int] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@contextlib.contextmanager
def reference_ops() -> Iterator[None]:
    """Run every wrapper's plain PyTorch version, on CUDA tensors too."""
    global _plain_forced
    prev = _plain_forced
    _plain_forced = True
    try:
        yield
    finally:
        _plain_forced = prev


def use_kernel(t: torch.Tensor) -> bool:
    """True: launch the kernel (CUDA tensor). False: plain version (CPU
    tensor, or inside :func:`reference_ops`). Other devices raise."""
    if t.device.type == "cuda":
        return not _plain_forced
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"no kernel and no plain path for device {t.device}")


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built on this machine")


def _lib_path(source: str) -> Path:
    src = b"".join(p.read_bytes() for p in [CSRC / f"{source}.cu", *sorted(CSRC.glob("*.cuh"))])
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{source}-{tag}.so"


def _compile(source: str) -> Path:
    out = _lib_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{source}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}.cu:\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    return out


def build(sources=SOURCES) -> float:
    """Compile (one nvcc per source, all at once) and load the kernels.
    Returns the wall seconds it took; already-loaded sources cost nothing."""
    t0 = time.perf_counter()
    with _lock:
        todo = [src for src in sources if src not in _libs]
        if todo:
            with ThreadPoolExecutor(len(todo)) as pool:
                paths = list(pool.map(_compile, todo))
            for src, path in zip(todo, paths):
                _libs[src] = ctypes.CDLL(str(path))
            for src, fn_name, argtypes in _ENTRY.values():
                if src in todo:
                    fn = getattr(_libs[src], fn_name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
    return time.perf_counter() - t0


def launch(name: str, device: torch.device, *args) -> None:
    """Call kernel ``name``'s C entry point on ``device``'s current stream
    (the stream goes last) and count the launch; raises on a CUDA error."""
    src, fn_name, _ = _ENTRY[name]
    if src not in _libs:
        build((src,))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(_libs[src], fn_name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {err}")
    launches[name] += 1


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the card ``device`` (the launch plans of
    K1 and K2 size their grids by it)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sm_counts[index]


def check_cuda_input(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
                     align: int = 4) -> None:
    """The kernels take contiguous CUDA tensors of one dtype whose data
    pointer is a multiple of ``align`` bytes."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"{name}: expected a contiguous, {align}-byte aligned tensor")
