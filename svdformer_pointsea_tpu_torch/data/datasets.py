"""The PCN dataset (semantics of svdformer_pointsea_tpu/data/datasets.py
``PCNDataset`` / ``make_dataset``): the ShapeNet.json index, partial scans and
complete clouds as PCD files at ``cfg.data``'s paths."""

from __future__ import annotations

import dataclasses
import json
import logging
from typing import List

import numpy as np

from svdformer_pointsea_tpu_torch.data.io import read_pcd
from svdformer_pointsea_tpu_torch.data.transforms import Compose

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


def make_dataset(cfg, subset: str, seed: int = 0) -> PCNDataset:
    if cfg.data.name != "ShapeNet":
        raise NotImplementedError(f"dataset {cfg.data.name!r} is not ported: the port has PCN "
                                  "only (ShapeNet-55 is ROADMAP queue A item 10, KITTI item 13)")
    return PCNDataset(cfg, subset, seed=seed)
