"""Point-cloud files: the PCD reader and writer, and ``IO``, which reads
``.pcd``, ``.npy``, ``.txt`` and ``.h5`` files and writes ``.pcd``, ``.npy``
and ``.h5`` by extension (semantics of svdformer_pointsea_tpu/data/io.py
``_read_pcd_python``, ``write_pcd`` and ``IO``).

The JAX package reads PCD through a native C++ parser with this numpy reader
as its fallback; the port has the numpy reader only. The native reader, the
byte cache and the image and EXR readers are listed in ROADMAP queue A.
``h5py`` is imported only where an ``.h5`` file is read or written.
"""

from __future__ import annotations

import os

import numpy as np


def read_pcd(file_path: str) -> np.ndarray:
    """The xyz columns of an ascii or uncompressed binary PCD file, (N, 3) f32."""
    with open(file_path, "rb") as f:
        fields, sizes, types, counts = [], [], [], []
        npoints = None
        mode = None
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            if line.startswith("FIELDS"):
                fields = line.split()[1:]
            elif line.startswith("SIZE"):
                sizes = [int(x) for x in line.split()[1:]]
            elif line.startswith("TYPE"):
                types = line.split()[1:]
            elif line.startswith("COUNT"):
                counts = [int(x) for x in line.split()[1:]]
            elif line.startswith("POINTS"):
                npoints = int(line.split()[1])
            elif line.startswith("DATA"):
                mode = line.split()[1]
                break
            elif not line and f.tell() == os.fstat(f.fileno()).st_size:
                raise ValueError(f"truncated PCD header: {file_path}")
        if not counts:
            counts = [1] * len(fields)
        if mode == "ascii":
            data = np.loadtxt(f, dtype=np.float32).reshape(npoints, -1)
            cols, col = {}, 0
            for name, cnt in zip(fields, counts):
                cols[name] = col
                col += cnt
            return np.stack([data[:, cols[c]] for c in "xyz"], -1).astype(np.float32)
        if mode == "binary":
            np_types = {"F": "f", "I": "i", "U": "u"}
            dt = np.dtype([(name, f"<{np_types[t]}{s}", (c,))
                           for name, t, s, c in zip(fields, types, sizes, counts)])
            raw = np.frombuffer(f.read(dt.itemsize * npoints), dtype=dt, count=npoints)
            return np.stack([raw[c][:, 0] for c in "xyz"], -1).astype(np.float32)
        raise ValueError(f"PCD DATA {mode} is not supported: {file_path}")


def write_pcd(file_path: str, points: np.ndarray) -> None:
    """Write (N, 3) points as an ascii PCD file."""
    points = np.asarray(points, np.float32)
    n = len(points)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA ascii\n"
    )
    with open(file_path, "w") as f:
        f.write(header)
        np.savetxt(f, points, fmt="%.8g")


def read_npy(file_path: str) -> np.ndarray:
    """The array of a ``.npy`` file (ShapeNet-55's complete clouds, (N, 3))."""
    return np.load(file_path)


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError(".h5 point files need the h5py package, which is not installed") from e
    return h5py


class IO:
    """Point files by extension: ``get`` reads ``.pcd`` (xyz), ``.npy``,
    ``.txt`` (``np.loadtxt``: KITTI's bounding boxes) and ``.h5`` (the
    ``data`` dataset); ``put`` writes ``.pcd``, ``.npy`` and ``.h5``."""

    @classmethod
    def get(cls, file_path: str) -> np.ndarray:
        ext = os.path.splitext(file_path)[1]
        if ext == ".pcd":
            return read_pcd(file_path)
        if ext == ".npy":
            return read_npy(file_path)
        if ext == ".txt":
            return np.loadtxt(file_path)
        if ext == ".h5":
            with _h5py().File(file_path, "r") as f:
                return f["data"][()]
        raise ValueError(f"Unsupported file extension: {ext}")

    @classmethod
    def put(cls, file_path: str, content: np.ndarray) -> None:
        ext = os.path.splitext(file_path)[1]
        if ext == ".pcd":
            write_pcd(file_path, content)
        elif ext == ".h5":
            with _h5py().File(file_path, "w") as f:
                f.create_dataset("data", data=content)
        elif ext == ".npy":
            np.save(file_path, content)
        else:
            raise ValueError(f"Unsupported file extension: {ext}")
