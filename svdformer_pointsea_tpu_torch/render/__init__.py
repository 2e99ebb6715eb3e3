"""Point cloud -> multi-view images: SVDFormer's depth views and PointSea's
realistic voxel renders."""

from svdformer_pointsea_tpu_torch.render.pcviews import PCViews, euler2mat, points2depth
from svdformer_pointsea_tpu_torch.render.realistic import PCViewsReal, points2grid

__all__ = ["PCViews", "PCViewsReal", "euler2mat", "points2depth", "points2grid", "make_renderer"]


def make_renderer(cfg):
    """The renderer of a config's model family: PointSea's realistic voxel
    renderer, or the SVDFormer / GeoSpecNet self-view depth renderer. Both
    have ``get_img(points)``."""
    if cfg.network.model == "pointsea":
        return PCViewsReal(trans=-cfg.network.view_distance)
    return PCViews(trans=-cfg.network.view_distance, resolution=cfg.network.resolution)
