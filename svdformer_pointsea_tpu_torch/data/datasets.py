"""The PCN, ShapeNet-55 and KITTI datasets (semantics of
svdformer_pointsea_tpu/data/datasets.py ``PCNDataset``, ``ShapeNet55Dataset``,
``KITTIDataset`` and ``make_dataset``): PCN's ShapeNet.json index, partial
scans and complete clouds as PCD files; ShapeNet-55's index files and
complete clouds as ``.npy`` files; KITTI's KITTI.json index, car scans as
PCD files and bounding boxes as text, at ``cfg.data``'s paths."""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import List

import numpy as np

from svdformer_pointsea_tpu_torch.data.io import IO, read_npy, read_pcd
from svdformer_pointsea_tpu_torch.data.transforms import Compose, pc_norm

SUBSETS = ("train", "val", "test")


@dataclasses.dataclass
class Sample:
    taxonomy_id: str
    model_id: str
    partial_paths: List[str]
    gt_path: str


class PCNDataset:
    """PCN partial scans and complete clouds. A training sample picks one of
    its ``n_renderings`` scans at random; the transforms resample the partial
    cloud to ``n_points`` and (train only) mirror both clouds alike."""

    def __init__(self, cfg, subset: str, seed: int = 0):
        if subset not in SUBSETS:
            raise ValueError(f"subset {subset!r} not in {SUBSETS}")
        self.subset = subset
        self.rng = np.random.RandomState(seed)
        self.samples = self._index(cfg, subset)
        steps = [{"callback": "UpSamplePoints", "parameters": {"n_points": cfg.data.n_points},
                  "objects": ["partial_cloud"]}]
        if subset == "train":
            steps.append({"callback": "RandomMirrorPoints",
                          "objects": ["partial_cloud", "gtcloud"]})
        steps.append({"callback": "ToArray", "objects": ["partial_cloud", "gtcloud"]})
        self.transforms = Compose(steps, self.rng)

    @staticmethod
    def _index(cfg, subset: str) -> List[Sample]:
        with open(cfg.data.category_file) as f:
            categories = json.load(f)
        n_rend = cfg.data.n_renderings if subset == "train" else 1
        samples = []
        for dc in categories:
            tax = dc["taxonomy_id"]
            for s in dc[subset]:
                gt = cfg.data.complete_points_path % (subset, tax, s)
                if subset == "test":
                    # The reference's test layout: one scan, 00, under the partial tree.
                    part = gt.replace("complete", "partial")
                    partials = [part[:-4] + "/00" + part[-4:]]
                else:
                    partials = [cfg.data.partial_points_path % (subset, tax, s, i)
                                for i in range(n_rend)]
                samples.append(Sample(tax, s, partials, gt))
        logging.info("Indexed %d %s samples", len(samples), subset)
        return samples

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int, rng=None):
        """(taxonomy id, model id, {"partial_cloud", "gtcloud"}); the Loader
        passes a RandomState per (seed, epoch, index), so threaded loading is
        deterministic; without one the dataset's own stream is used."""
        s = self.samples[idx]
        r = self.rng if rng is None else rng
        ri = r.randint(0, len(s.partial_paths)) if (
            self.subset == "train" and len(s.partial_paths) > 1) else 0
        data = {"partial_cloud": read_pcd(s.partial_paths[ri]).astype(np.float32),
                "gtcloud": read_pcd(s.gt_path).astype(np.float32)}
        return s.taxonomy_id, s.model_id, self.transforms(data, rng=rng)


class ShapeNet55Dataset:
    """ShapeNet-55 / 34 / Unseen-21 complete clouds, normalised into the unit
    sphere; the partials are cropped online by the train step and by
    ``eval_55``. ``<category_file>/train.txt`` indexes the train split and
    ``test.txt`` every other subset (validation runs on the test split), one
    ``<taxonomy>-<model>.npy`` a line, read from ``complete_points_path %
    line``. The three benchmarks differ only by their index directory."""

    def __init__(self, cfg, subset: str, seed: int = 0):
        self.subset = "train" if subset == "train" else "test"
        self.samples = []
        with open(os.path.join(cfg.data.category_file, self.subset + ".txt")) as f:
            for line in f:
                line = line.strip()
                if line:
                    tax, model = line.split("-")[0], line.split("-")[1].split(".")[0]
                    self.samples.append(Sample(tax, model, [], cfg.data.complete_points_path % line))
        logging.info("Indexed %d %s samples", len(self.samples), self.subset)

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int, rng=None):
        """(taxonomy id, model id, {"gtcloud"}); no random draw (``rng`` is
        taken for the Loader's interface)."""
        s = self.samples[idx]
        gt = pc_norm(read_npy(s.gt_path).astype(np.float32)).astype(np.float32)
        return s.taxonomy_id, s.model_id, {"gtcloud": gt}


class KITTIDataset:
    """KITTI's LiDAR car scans for zero-shot evaluation (no ground truth).
    ``KITTI.json`` lists the ``test`` ids (``subset`` is ignored); each
    sample is its scan pose-normalised by its bounding box (``gt_path``
    holds the box's path), then sampled to ``n_points`` rows, zero-padded
    where the scan is shorter: ``{"partial_cloud"}``."""

    def __init__(self, cfg, subset: str = "test", seed: int = 0):
        self.rng = np.random.RandomState(seed)
        with open(cfg.data.category_file) as f:
            categories = json.load(f)
        self.samples = [Sample(dc["taxonomy_id"], s, [cfg.data.partial_points_path % s],
                               cfg.data.bbox_path % s)
                        for dc in categories for s in dc.get("test", [])]
        logging.info("Indexed %d KITTI samples", len(self.samples))
        self.transforms = Compose([
            {"callback": "NormalizeObjectPose",
             "parameters": {"input_keys": {"ptcloud": "partial_cloud", "bbox": "bounding_box"}},
             "objects": ["partial_cloud", "bounding_box"]},
            {"callback": "RandomSamplePoints", "parameters": {"n_points": cfg.data.n_points},
             "objects": ["partial_cloud"]},
            {"callback": "ToArray", "objects": ["partial_cloud"]},
        ], self.rng)

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int, rng=None):
        """(taxonomy id, model id, {"partial_cloud"})."""
        s = self.samples[idx]
        data = {"partial_cloud": IO.get(s.partial_paths[0]).astype(np.float32),
                "bounding_box": IO.get(s.gt_path).astype(np.float32)}
        data = self.transforms(data, rng=rng)
        data.pop("bounding_box", None)
        return s.taxonomy_id, s.model_id, data


DATASET_MAPPING = {"ShapeNet": PCNDataset, "ShapeNet55": ShapeNet55Dataset, "KITTI": KITTIDataset}


def make_dataset(cfg, subset: str, seed: int = 0):
    """The dataset ``cfg.data.name`` names, over its ``subset``."""
    if cfg.data.name not in DATASET_MAPPING:
        raise NotImplementedError(f"dataset {cfg.data.name!r} is unknown: the port has "
                                  f"{sorted(DATASET_MAPPING)}")
    return DATASET_MAPPING[cfg.data.name](cfg, subset, seed=seed)
