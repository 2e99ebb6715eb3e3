"""The data layer: point files, transforms, the PCN, ShapeNet-55 and KITTI
datasets, online crops and the threaded loader."""

from svdformer_pointsea_tpu_torch.data.crop import (
    FIXED_CORNERS,
    crop_fixed,
    crop_random_resampled,
    random_crop_params,
    random_partial,
)
from svdformer_pointsea_tpu_torch.data.datasets import (
    KITTIDataset,
    PCNDataset,
    ShapeNet55Dataset,
    make_dataset,
)
from svdformer_pointsea_tpu_torch.data.io import IO, read_npy, read_pcd, write_pcd
from svdformer_pointsea_tpu_torch.data.pipeline import Batch, Loader

__all__ = ["FIXED_CORNERS", "IO", "Batch", "KITTIDataset", "Loader", "PCNDataset",
           "ShapeNet55Dataset", "crop_fixed", "crop_random_resampled", "make_dataset",
           "random_crop_params", "random_partial", "read_npy", "read_pcd", "write_pcd"]
