"""The port's PCN data layer vs the JAX package's on the CPU: the PCD reader,
the transforms and the dataset + loader, bit for bit. Numpy only on both
sides (the JAX package's data modules import no JAX); every file is a few
kilobytes."""

import dataclasses

import numpy as np
import pytest

from svdformer_pointsea_tpu.configs import pcn_config as jax_pcn_config
from svdformer_pointsea_tpu.data import datasets as jdatasets
from svdformer_pointsea_tpu.data import io as jio
from svdformer_pointsea_tpu.data import pipeline as jpipeline
from svdformer_pointsea_tpu.data import transforms as jtransforms
from svdformer_pointsea_tpu_torch.configs import kitti_config, pcn_config
from svdformer_pointsea_tpu_torch.data import KITTIDataset, Loader, make_dataset, read_pcd, write_pcd
from svdformer_pointsea_tpu_torch.data import transforms
from svdformer_pointsea_tpu_torch.data.synthetic import write_pcn_tree

N_POINTS = 48  # partials hold 16..99 points: both the up- and the down-sampling branch run
MODELS = {"train": 5, "val": 3, "test": 3}


def _write_binary_pcd(path, points):
    header = ("VERSION 0.7\nFIELDS x y z rgb\nSIZE 4 4 4 4\nTYPE F F F U\nCOUNT 1 1 1 1\n"
              f"WIDTH {len(points)}\nHEIGHT 1\nPOINTS {len(points)}\nDATA binary\n")
    rec = np.zeros(len(points), dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("rgb", "<u4")])
    for i, c in enumerate("xyz"):
        rec[c] = points[:, i]
    rec["rgb"] = np.arange(len(points))
    with open(path, "wb") as f:
        f.write(header.encode() + rec.tobytes())


@pytest.mark.parametrize("writer", ["port", "jax", "binary"])
def test_read_pcd_matches_jax(tmp_path, writer):
    pts = (np.random.RandomState(0).randn(37, 3) * [1e-3, 1.0, 1e3]).astype(np.float32)
    path = str(tmp_path / "cloud.pcd")
    {"port": write_pcd, "jax": jio.write_pcd, "binary": _write_binary_pcd}[writer](path, pts)
    got = read_pcd(path)
    assert got.dtype == np.float32 and got.shape == (37, 3)
    np.testing.assert_array_equal(got, jio.read_pcd(path))
    np.testing.assert_array_equal(got, jio._read_pcd_python(path))
    # "%.8g" keeps 8 significant digits: within 1 ulp of f32 after the read.
    np.testing.assert_allclose(got, pts, rtol=2e-7, atol=0)


@pytest.mark.parametrize("n_in", [5, 47, 48, 49, 200])
def test_transforms_match_jax(n_in):
    pts = np.random.RandomState(n_in).rand(n_in, 3).astype(np.float32)
    got = transforms.up_sample_points(pts, N_POINTS, np.random.RandomState(1))
    np.testing.assert_array_equal(got, jtransforms.up_sample_points(pts, N_POINTS,
                                                                    np.random.RandomState(1)))
    for rnd in (0.1, 0.3, 0.6, 0.9):
        np.testing.assert_array_equal(transforms.random_mirror_points(pts, rnd),
                                      jtransforms.random_mirror_points(pts, rnd))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("pcn")
    write_pcn_tree(str(root), np.random.RandomState(0), MODELS, n_renderings=3, gt_points=64,
                   partial_points=(16, 100))
    return root


def _configs(root):
    data = dict(category_file=f"{root}/datasets/ShapeNet.json", n_renderings=3,
                n_points=N_POINTS, gt_points=64, num_workers=3,
                partial_points_path=f"{root}/dataset/PCN/%s/partial/%s/%s/%02d.pcd",
                complete_points_path=f"{root}/dataset/PCN/%s/complete/%s/%s.pcd")
    port, jax_cfg = pcn_config(), jax_pcn_config()
    return (port.replace(data=dataclasses.replace(port.data, **data)),
            jax_cfg.replace(data=dataclasses.replace(jax_cfg.data, **data)))


@pytest.mark.parametrize("subset", ["train", "val", "test"])
def test_loader_batches_match_jax_bit_for_bit(tree, subset):
    """Two epochs of the port's PCNDataset + Loader against the JAX
    package's: the same shuffle, scan picks, resampling and mirroring, pad
    rows and valid counts (batch 2 over 5 or 3 models: the last batch pads)."""
    cfg, jcfg = _configs(tree)
    shuffle = subset == "train"
    port = Loader(make_dataset(cfg, subset, seed=7), 2, shuffle=shuffle, seed=7, num_workers=3)
    ref = jpipeline.Loader(jdatasets.make_dataset(jcfg, subset, seed=7), 2, shuffle=shuffle,
                           seed=7, num_workers=3)
    for epoch in (1, 2):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(port), list(ref)
        assert len(got) == len(want) == len(port) == -(-MODELS[subset] // 2)
        for a, b in zip(got, want):
            assert (a.taxonomy_ids, a.model_ids, a.valid) == (b.taxonomy_ids, b.model_ids, b.valid)
            assert a.data.keys() == b.data.keys()
            for key in a.data:
                assert a.data[key].dtype == np.float32
                np.testing.assert_array_equal(a.data[key], b.data[key])
        assert got[0].data["partial_cloud"].shape == (2, N_POINTS, 3)
        if epoch == 1:
            first = [b.data["partial_cloud"] for b in got]
    if shuffle:  # another epoch, other draws
        assert any(not np.array_equal(a, b.data["partial_cloud"]) for a, b in zip(first, got))


def test_make_dataset_refuses_other_tracks(tree, tmp_path):
    """KITTI builds a KITTIDataset (over its test ids, whatever the subset);
    a name the port does not know still raises."""
    cfg, _ = _configs(tree)
    (tmp_path / "KITTI.json").write_text('[{"taxonomy_id": "02958343", "test": ["a", "b"]}]')
    kitti = make_dataset(cfg.replace(data=dataclasses.replace(
        kitti_config().data, category_file=str(tmp_path / "KITTI.json"))), "train")
    assert isinstance(kitti, KITTIDataset) and [s.model_id for s in kitti.samples] == ["a", "b"]
    with pytest.raises(NotImplementedError, match="unknown"):
        make_dataset(cfg.replace(data=dataclasses.replace(cfg.data, name="ModelNet")), "train")
