"""Point cloud -> multi-view depth images."""

from svdformer_pointsea_tpu_torch.render.pcviews import PCViews, euler2mat, points2depth

__all__ = ["PCViews", "euler2mat", "points2depth", "make_renderer"]


def make_renderer(cfg) -> PCViews:
    """The SVDFormer self-view renderer for a config."""
    return PCViews(trans=-cfg.network.view_distance, resolution=cfg.network.resolution)
