"""PointSea's realistic voxel renderer (semantics of
svdformer_pointsea_tpu/render/realistic.py ``PCViewsReal``).

Each of three views rotates the cloud (a fixed view rotation, then a per-view
tilt), shifts it, normalises it into a (depth 8, 224, 224) grid and keeps
the largest depth per voxel by a scatter-max; a 7 x 7 max-pool densifies the
grid, a 3 x 3 Gaussian smooths it, a max over depth squeezes it, and each
image is divided by its own peak and inverted, then repeated to 3 channels
for the ResNet-18 trunk.

The arithmetic follows the JAX package as XLA compiles it on the CPU, so
that the grid is bit-equal to it: the projections round as XLA's dot does
(a fused multiply-add chain over the 3 coordinates, reproduced here in f64,
where each product is exact), and the depth coordinate's ``/ (1 + bias) *
(depth - 2)`` is one multiplication by the folded f32 constant. A scatter-max
gives the same bits in any order, so the grid is bit-equal on the card too.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from svdformer_pointsea_tpu_torch.render.pcviews import euler2mat

# Realistic projection parameters (models_PointSea/mv_utils_zs.py:10-13).
PARAMS = {
    "maxpoolz": 1,
    "maxpoolxy": 7,
    "maxpoolpadz": 0,
    "maxpoolpadxy": 3,
    "convz": 1,
    "convxy": 3,
    "convsigmaxy": 3,
    "convsigmaz": 1,
    "convpadz": 0,
    "convpadxy": 1,
    "imgbias": 0.0,
    "depth_bias": 0.2,
    "obj_ratio": 0.8,
    "bg_clr": 0.0,
    "resolution": 224,
    "depth": 8,
}


def get_2d_gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    center = ksize // 2
    xs = np.arange(ksize, dtype=np.float32) - center
    k1 = np.exp(-(xs**2) / (2 * sigma**2))
    k = k1[:, None] @ k1[None, :]
    return k / k.sum()


def get_3d_gaussian_kernel(ksize: int, depth: int, sigma: float, zsigma: float) -> np.ndarray:
    k2 = get_2d_gaussian_kernel(ksize, sigma)
    zs = np.arange(depth, dtype=np.float32) - depth // 2
    zk = np.exp(-(zs**2) / (2 * zsigma**2))
    k3 = np.repeat(k2[None], depth, axis=0) * zk[:, None, None]
    return (k3 / k3.sum()).astype(np.float32)


def _rotate(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """x (..., 3) @ m (..., 3, 3) in f32, rounded as a fused multiply-add
    chain over k = 0, 1, 2: each f64 product of two f32 values is exact, so
    one f64 add and a round to f32 is the fused multiply-add's single
    rounding."""
    x64, m64 = x.double().unsqueeze(-1), m.double()
    acc = (x64[..., 0, :] * m64[..., 0, :]).float()
    for k in (1, 2):
        acc = (x64[..., k, :] * m64[..., k, :] + acc.double()).float()
    return acc


def points2grid(points: torch.Tensor, resolution: int = 224, depth: int = 8) -> torch.Tensor:
    """Quantise clouds into occupancy grids: (B, P, 3) -> (B, depth,
    resolution, resolution), each voxel holding the largest (clipped) depth
    coordinate that lands in it, 0 elsewhere. x and y are ceil'd and clipped
    to [1, resolution - 2]; the voxel's depth index is the *unclipped* ceil of
    z, as in the reference, and an index past the grid is dropped."""
    pmax, pmin = points.amax(dim=1), points.amin(dim=1)
    pcent = (pmax + pmin) / 2
    prange = (pmax - pmin).amax(dim=-1)[:, None, None]
    pts = (points - pcent[:, None, :]) / prange * 2.0
    ratio = torch.tensor(PARAMS["obj_ratio"], dtype=torch.float32, device=points.device)
    bias = PARAMS["depth_bias"]
    # XLA folds "/ (1 + bias) * (depth - 2)" into one f32 constant.
    z_scale = torch.tensor(np.float32(depth - 2) / np.float32(1 + bias), dtype=torch.float32,
                           device=points.device)
    _x = torch.ceil((pts[:, :, 0] * ratio + 1) / 2 * resolution)
    _y = torch.ceil((pts[:, :, 1] * ratio + 1) / 2 * resolution)
    _z = ((pts[:, :, 2] + 1) / 2 + bias) * z_scale
    z_int = torch.ceil(_z)
    _x = _x.clamp(1, resolution - 2)
    _y = _y.clamp(1, resolution - 2)
    _z = _z.clamp(1, depth - 2)
    # The index in f32, as the reference computes it (exact: < 2^24), then truncated.
    coords = (z_int * (resolution * resolution) + _y * resolution + _x).to(torch.int32).long()
    B = points.shape[0]
    size = depth * resolution * resolution
    # A dropped index goes to one slot past the grids, cut off afterwards.
    rows = torch.where((coords >= 0) & (coords < size),
                       coords + torch.arange(B, device=points.device)[:, None] * size, B * size)
    flat = torch.full((B * size + 1,), PARAMS["bg_clr"], dtype=torch.float32,
                      device=points.device)
    flat.scatter_reduce_(0, rows.reshape(-1), _z.reshape(-1), reduce="amax")
    return flat[:-1].reshape(B, depth, resolution, resolution).transpose(2, 3)


def grid2image(grid: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Densify (7 x 7 max-pool, padded with -inf), smooth (3 x 3 Gaussian,
    zero padding), squeeze depth by a max, divide each image by its peak and
    invert: (B, D, H, W) -> (B, 3, H, W)."""
    x = F.max_pool3d(grid[:, None], (PARAMS["maxpoolz"], PARAMS["maxpoolxy"], PARAMS["maxpoolxy"]),
                     stride=1, padding=(PARAMS["maxpoolpadz"], PARAMS["maxpoolpadxy"],
                                        PARAMS["maxpoolpadxy"]))
    x = F.conv3d(x, kernel.reshape(1, 1, *kernel.shape),
                 padding=(PARAMS["convpadz"], PARAMS["convpadxy"], PARAMS["convpadxy"]))
    img = x.amax(dim=2)  # (B, 1, H, W)
    img = 1 - img / img.amax(dim=(-1, -2), keepdim=True)
    return img.repeat(1, 3, 1, 1)


class PCViewsReal:
    """Three realistic self-views with per-view tilts (models_PointSea/
    mv_utils_zs.py:136-195). ``get_img(points)`` maps (B, P, 3) to images
    (B * 3, 3, 224, 224), batch-major view-minor, NCHW for the ResNet-18
    trunk, without gradient."""

    _VIEWS = np.asarray(
        [
            [[0 * np.pi / 2, 0, np.pi / 2], [-0.5, -0.5, 0.0]],
            [[1 * np.pi / 2, 0, np.pi / 2], [-0.5, -0.5, 0.0]],
            [[0, -np.pi / 2, np.pi / 2], [-0.5, -0.5, 0.0]],
        ],
        np.float32,
    )
    _VIEW_BIAS = np.asarray([[0, np.pi / 9, 0], [0, np.pi / 9, 0], [0, np.pi / 15, 0]],
                            np.float32)

    def __init__(self, trans: float = -0.7):
        self.num_views = 3
        views = self._VIEWS.copy()
        views[:, 1, 2] = trans
        # Stored pre-transposed so that a projection is points @ rot.
        self.rot = torch.from_numpy(np.ascontiguousarray(
            np.transpose(euler2mat(views[:, 0, :]), (0, 2, 1))))
        self.rot_bias = torch.from_numpy(np.ascontiguousarray(
            np.transpose(euler2mat(self._VIEW_BIAS), (0, 2, 1))))
        self.translation = torch.from_numpy(views[:, 1, :].reshape(3, 1, 3))
        self.kernel = torch.from_numpy(get_3d_gaussian_kernel(
            PARAMS["convxy"], PARAMS["convz"], sigma=PARAMS["convsigmaxy"],
            zsigma=PARAMS["convsigmaz"]))

    def grid(self, points: torch.Tensor) -> torch.Tensor:
        """points (B, P, 3) -> occupancy grids (B * 3, 8, 224, 224)."""
        dev = points.device
        B = points.shape[0]
        proj = _rotate(points.float()[:, None], self.rot.to(dev)[None, :, None])  # (B, V, P, 3)
        proj = _rotate(proj, self.rot_bias.to(dev)[None, :, None])
        proj = proj - self.translation.to(dev)[None]
        return points2grid(proj.reshape(B * self.num_views, -1, 3), PARAMS["resolution"],
                           PARAMS["depth"])

    @torch.no_grad()
    def get_img(self, points: torch.Tensor) -> torch.Tensor:
        return grid2image(self.grid(points), self.kernel.to(points.device))
