"""The data layer: PCD and npy files, transforms, the PCN and ShapeNet-55
datasets, online crops and the threaded loader."""

from svdformer_pointsea_tpu_torch.data.crop import (
    FIXED_CORNERS,
    crop_fixed,
    crop_random_resampled,
    random_crop_params,
    random_partial,
)
from svdformer_pointsea_tpu_torch.data.datasets import PCNDataset, ShapeNet55Dataset, make_dataset
from svdformer_pointsea_tpu_torch.data.io import read_npy, read_pcd, write_pcd
from svdformer_pointsea_tpu_torch.data.pipeline import Batch, Loader

__all__ = ["FIXED_CORNERS", "Batch", "Loader", "PCNDataset", "ShapeNet55Dataset", "crop_fixed",
           "crop_random_resampled", "make_dataset", "random_crop_params", "random_partial",
           "read_npy", "read_pcd", "write_pcd"]
