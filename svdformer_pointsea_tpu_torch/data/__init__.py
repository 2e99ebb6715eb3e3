"""The PCN data layer: PCD files, transforms, the dataset and the threaded loader."""

from svdformer_pointsea_tpu_torch.data.datasets import PCNDataset, make_dataset
from svdformer_pointsea_tpu_torch.data.io import read_pcd, write_pcd
from svdformer_pointsea_tpu_torch.data.pipeline import Batch, Loader

__all__ = ["Batch", "Loader", "PCNDataset", "make_dataset", "read_pcd", "write_pcd"]
