"""A point cloud drawn as an image (semantics of
svdformer_pointsea_tpu/utils/viz.py): matplotlib's 3-D scatter, for looking
at completions. matplotlib is imported only when a cloud is drawn."""

from __future__ import annotations

import numpy as np


def get_ptcloud_img(ptcloud: np.ndarray, roll: float = 30.0, pitch: float = -45.0) -> np.ndarray:
    """(N, 3) points, y up, drawn from elevation ``roll`` and azimuth
    ``pitch`` into an (800, 800, 3) uint8 image, coloured by height."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("get_ptcloud_img needs the matplotlib package, which is not "
                          "installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 8))
    x, z, y = ptcloud.transpose(1, 0)
    ax = fig.add_subplot(111, projection="3d")
    ax.axis("off")
    ax.view_init(roll, pitch)
    lim = float(np.max(np.abs(ptcloud))) or 0.5
    ax.set_xbound(-lim, lim)
    ax.set_ybound(-lim, lim)
    ax.set_zbound(-lim, lim)
    ax.scatter(x, y, z, zdir="z", c=y, cmap="jet", s=1)
    fig.canvas.draw()
    img = np.frombuffer(fig.canvas.buffer_rgba(), dtype=np.uint8)
    w, h = fig.canvas.get_width_height()
    img = img.reshape(h, w, 4)[..., :3].copy()
    plt.close(fig)
    return img
