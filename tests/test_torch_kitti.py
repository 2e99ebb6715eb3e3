"""The port's KITTI track and ``--complete`` vs the JAX package on the CPU:
the point files, the KITTI transforms, dataset and loader and the completion
helpers bit for bit (numpy on both sides); the KITTI evaluation function on
a tiny SVDFormer (step 2/2, merge and local 128, 16² render) at the slice's
bounds; ``eval_kitti``, ``main_kitti``, ``infer_files`` and ``main_pcn
--complete`` with the orchestration tests' stand-in model."""

import dataclasses
import logging
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_parity import (  # noqa: F401
    close,
    jax_difference_form_nn,
    jax_reference_modes,
    jax_variables,
    load_port,
    t,
)
from svdformer_pointsea_tpu.configs import kitti_config as jax_kitti_config
from svdformer_pointsea_tpu.data import datasets as jdatasets
from svdformer_pointsea_tpu.data import io as jio
from svdformer_pointsea_tpu.data import pipeline as jpipeline
from svdformer_pointsea_tpu.data import transforms as jtransforms
from svdformer_pointsea_tpu.nn import SVDFormer as JaxSVDFormer
from svdformer_pointsea_tpu.render import PCViews as JaxPCViews
from svdformer_pointsea_tpu.train import evaluate as jevaluate
from svdformer_pointsea_tpu.train import infer as jinfer
from svdformer_pointsea_tpu_torch import cli
from svdformer_pointsea_tpu_torch.configs import kitti_config, pcn_config
from svdformer_pointsea_tpu_torch.data import IO, Loader, make_dataset, read_pcd, transforms
from svdformer_pointsea_tpu_torch.data.synthetic import write_kitti_tree
from svdformer_pointsea_tpu_torch.nn import SVDFormer
from svdformer_pointsea_tpu_torch.render import make_renderer
from svdformer_pointsea_tpu_torch.train import infer, init_state, loop, save_checkpoint
from svdformer_pointsea_tpu_torch.train.evaluate import eval_kitti, make_kitti_eval_fn
from test_torch_orchestration import _tiny_model

TINY = dict(step1=2, step2=2, merge_points=128, local_points=128)
COMPLETION_ATOL = 2e-3  # tests/test_reference_parity.py's bound for whole-model outputs
FIDELITY_ATOL = 1e-5
N_POINTS = 64  # the loader's partial size in the tree tests: scans of 10..160 points


@pytest.fixture(scope="module")
def kitti_tree(tmp_path_factory):
    """10 synthetic scans (8 padded, 2 over N_POINTS) and port / JAX configs
    reading them."""
    root = tmp_path_factory.mktemp("kitti")
    ids = write_kitti_tree(str(root), np.random.RandomState(0), 10, points=(10, 160),
                           n_points=N_POINTS)
    data = dict(category_file=f"{root}/datasets/KITTI.json", n_points=N_POINTS, num_workers=3,
                partial_points_path=f"{root}/dataset/KITTI/cars/%s.pcd",
                bbox_path=f"{root}/dataset/KITTI/bboxes/%s.txt")
    port, jcfg = kitti_config(), jax_kitti_config()
    return SimpleNamespace(
        root=root, ids=ids,
        cfg=port.replace(data=dataclasses.replace(port.data, **data)),
        jcfg=jcfg.replace(data=dataclasses.replace(jcfg.data, **data)))


def test_kitti_config_matches_jax():
    port, jcfg = kitti_config(), jax_kitti_config()
    for f in dataclasses.fields(port.data):
        assert getattr(port.data, f.name) == getattr(jcfg.data, f.name), f.name
    assert (port.out_path, port.network.model, port.train.batch_size) == (
        jcfg.out_path, jcfg.network.model, jcfg.train.batch_size)


@pytest.mark.parametrize("n_in", [17, 64, 300])
def test_kitti_transforms_match_jax(kitti_tree, n_in):
    """normalize_object_pose on a synthetic scan and its box (f64 inside, the
    axis swap in the cloud's dtype), random_sample_points (zero-padded when
    short), the rotate, scale and clip transforms, bit for bit."""
    sid = kitti_tree.ids[n_in % len(kitti_tree.ids)]
    pts = read_pcd(f"{kitti_tree.root}/dataset/KITTI/cars/{sid}.pcd")
    pts = np.resize(pts, (n_in, 3))
    bbox = IO.get(f"{kitti_tree.root}/dataset/KITTI/bboxes/{sid}.txt").astype(np.float32)
    for got, want in zip(transforms.normalize_object_pose(pts, bbox),
                         jtransforms.normalize_object_pose(pts, bbox)):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    norm_box = transforms.normalize_object_pose(pts, bbox)[1]
    assert norm_box[3, 0] - norm_box[0, 0] == pytest.approx(1.0, abs=1e-6)  # unit length
    sampled = transforms.random_sample_points(pts, N_POINTS, np.random.RandomState(1))
    np.testing.assert_array_equal(
        sampled, jtransforms.random_sample_points(pts, N_POINTS, np.random.RandomState(1)))
    assert sampled.shape == (N_POINTS, 3) and (not sampled[n_in:].any())
    for rnd in (0.1, 0.7):
        np.testing.assert_array_equal(transforms.random_rotate_points(pts, rnd),
                                      jtransforms.random_rotate_points(pts, rnd))
    for fn in ("scale_points", "random_clip_points"):
        np.testing.assert_array_equal(getattr(transforms, fn)(pts, np.random.RandomState(n_in)),
                                      getattr(jtransforms, fn)(pts, np.random.RandomState(n_in)))


def test_io_reads_and_writes_as_jax(tmp_path):
    """IO by extension: .pcd, .npy, .txt and .h5 read as the JAX package
    reads them, .pcd / .npy / .h5 written so that it reads them back, and
    the same refusal of other extensions."""
    pts = np.random.RandomState(2).rand(23, 3).astype(np.float32)
    for ext in (".pcd", ".npy", ".h5"):
        path = str(tmp_path / f"cloud{ext}")
        IO.put(path, pts)
        np.testing.assert_array_equal(IO.get(path), jio.IO.get(path))
        np.testing.assert_allclose(IO.get(path), pts, rtol=2e-7, atol=0)
    txt = str(tmp_path / "box.txt")
    np.savetxt(txt, pts[:8].astype(np.float64) * 10)
    got = IO.get(txt)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, jio.IO.get(txt))
    for bad in ("cloud.ply", "cloud.png"):
        with pytest.raises(ValueError, match="Unsupported file extension"):
            IO.get(str(tmp_path / bad))
    with pytest.raises(ValueError, match="Unsupported file extension"):
        IO.put(str(tmp_path / "out.txt"), pts)


def test_kitti_loader_batches_match_jax_bit_for_bit(kitti_tree):
    """KITTIDataset + Loader against the JAX package's: the same pose
    normalisation, subsets, zero padding, ids, pad rows and valid counts
    (batch 4 over 10 scans), and no ``gtcloud``."""
    cfg, jcfg = kitti_tree.cfg, kitti_tree.jcfg
    port = Loader(make_dataset(cfg, "test", seed=3), 4, num_workers=3)
    ref = jpipeline.Loader(jdatasets.make_dataset(jcfg, "test", seed=3), 4, num_workers=3)
    got, want = list(port), list(ref)
    assert len(got) == len(want) == 3 and [b.valid for b in got] == [4, 4, 2]
    for a, b in zip(got, want):
        assert (a.taxonomy_ids, a.model_ids, a.valid) == (b.taxonomy_ids, b.model_ids, b.valid)
        assert set(a.data) == set(b.data) == {"partial_cloud"}
        assert a.data["partial_cloud"].dtype == np.float32
        np.testing.assert_array_equal(a.data["partial_cloud"], b.data["partial_cloud"])
    rows = np.concatenate([b.data["partial_cloud"] for b in got])
    real = np.abs(rows).sum(-1) > 0
    assert not real.all() and real.all(axis=1).sum() >= 1  # padded scans and full ones
    assert make_dataset(cfg, "train", seed=3).samples == make_dataset(cfg, "test", seed=3).samples


@pytest.fixture(scope="module")
def kitti_case(jax_reference_modes):
    """Two scans of N 256 (37 and 256 real points, the rest zero rows), a
    tiny SVDFormer with the same random weights on both sides."""
    rng = np.random.RandomState(7)
    partial = np.zeros((2, 256, 3), np.float32)
    partial[0, :37] = rng.rand(37, 3) * 0.4 - 0.2
    partial[1] = rng.rand(256, 3) * 0.6 - 0.3
    render = JaxPCViews(trans=-0.7, resolution=16)
    jmodel = JaxSVDFormer(**TINY)
    variables = jax_variables(jmodel, partial, np.asarray(render.get_img(jnp.asarray(partial))),
                              seed=1)
    cfg = kitti_config()
    cfg = cfg.replace(network=dataclasses.replace(cfg.network, resolution=16, **TINY))
    model = load_port(SVDFormer.from_config(cfg.network), variables)
    return SimpleNamespace(partial=partial, jmodel=jmodel, render=render, variables=variables,
                           cfg=cfg, model=model)


def test_kitti_eval_fn_matches_jax(kitti_case, jax_difference_form_nn):
    """Completions within 2e-3 and fidelity within 1e-5 of JAX's (its NN in
    the difference form, as the port's), the zero rows left out of the
    mean."""
    c = kitti_case
    want_comp, want_fid = jevaluate.make_kitti_eval_fn(c.jmodel, c.render)(
        c.variables, jnp.asarray(c.partial))
    comp, fid = make_kitti_eval_fn(c.model, make_renderer(c.cfg))(t(c.partial))
    assert comp.shape == (2, 512, 3) and fid.shape == (2,)
    close(comp, want_comp, atol=COMPLETION_ATOL)
    close(fid, want_fid, atol=FIDELITY_ATOL)
    d = ((t(c.partial)[:, :, None] - comp[:, None]) ** 2).sum(-1).min(-1).values.sqrt()
    assert fid[0].item() == pytest.approx(d[0, :37].mean().item(), rel=1e-5)
    assert fid[0].item() != pytest.approx(d[0].mean().item(), rel=1e-3)
    assert fid[1].item() == pytest.approx(d[1].mean().item(), rel=1e-5)


def test_eval_kitti_prints_and_writes_the_valid_rows(kitti_case, tmp_path, capsys):
    c = kitti_case
    _, fid = make_kitti_eval_fn(c.model, make_renderer(c.cfg))(t(c.partial))
    batches = [SimpleNamespace(data={"partial_cloud": c.partial}, model_ids=["a", "b"], valid=2),
               SimpleNamespace(data={"partial_cloud": c.partial}, model_ids=["c", "d"], valid=1)]
    mean = eval_kitti(c.cfg, c.model, batches, out_dir=str(tmp_path / "bench"))
    assert mean == pytest.approx((2 * fid[0].item() + fid[1].item()) / 3, rel=1e-6)
    assert capsys.readouterr().out.splitlines()[-1] == f"KITTI\t3\tfidelity\t{mean:.6f}"
    assert sorted(os.listdir(tmp_path / "bench")) == ["a.pcd", "b.pcd", "c.pcd"]
    assert read_pcd(str(tmp_path / "bench" / "c.pcd")).shape == (512, 3)


def _stand_in_checkpoint(cfg, path):
    """A checkpoint of this port for the stand-in model (seed 4)."""
    save_checkpoint(path, init_state(cfg, _tiny_model(cfg, device="cpu", seed=4)), 1, 0.5)
    return path


def test_main_kitti_evaluates_the_tree(kitti_tree, monkeypatch, tmp_path, capsys):
    """main_kitti on the CPU with the stand-in model: --test forced, the
    KITTI line printed, one PCD a scan under <out>/benchmark; training on
    KITTI is refused as evaluation-only."""
    monkeypatch.setattr(loop, "build_model", _tiny_model)
    tiny = kitti_tree.cfg.replace(network=dataclasses.replace(kitti_tree.cfg.network,
                                                              resolution=16),
                                  train=dataclasses.replace(kitti_tree.cfg.train, batch_size=4))
    monkeypatch.setattr(cli, "kitti_config", lambda: tiny)
    ckpt = _stand_in_checkpoint(tiny, str(tmp_path / "ckpt.pt"))
    out = tmp_path / "out"
    mean = cli.main_kitti(["--weights", ckpt, "--out", str(out)], device="cpu")
    assert np.isfinite(mean) and mean > 0
    assert capsys.readouterr().out.splitlines()[-1] == f"KITTI\t10\tfidelity\t{mean:.6f}"
    assert sorted(os.listdir(out / "benchmark")) == sorted(f"{i}.pcd" for i in kitti_tree.ids)
    with pytest.raises(NotImplementedError, match="evaluation-only"):
        loop.train_net(tiny, device="cpu")
    with pytest.raises(SystemExit, match="--weights"):
        cli.main_kitti([], device="cpu")


def test_infer_helpers_match_jax(tmp_path):
    """_load_xyz (xyz columns of wider arrays, flat streams, the refusals),
    _collect_inputs, _resample and _to_pcn_frame, bit for bit."""
    rng = np.random.RandomState(5)
    pts = (rng.rand(40, 6) * 3 + 1).astype(np.float32)
    files = {"a.npy": pts, "b.txt": pts[:, :4], "c.h5": pts[:, :3], "d.pcd": pts[:, :3],
             "e.npy": pts[:, :3].reshape(-1)}
    for name, arr in files.items():
        path = str(tmp_path / name)
        if name.endswith(".txt"):
            np.savetxt(path, arr)
        else:
            IO.put(path, arr)
        got = infer._load_xyz(path)
        assert got.shape == (40, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got, jinfer._load_xyz(path))
    for bad in (np.zeros((5, 2), np.float32), np.zeros((0, 3), np.float32)):
        np.save(str(tmp_path / "bad.npy"), bad)
        with pytest.raises(ValueError):
            infer._load_xyz(str(tmp_path / "bad.npy"))
    os.remove(tmp_path / "bad.npy")
    (tmp_path / "a_completion.pcd").write_text("")
    (tmp_path / "notes.md").write_text("")
    assert infer._collect_inputs(str(tmp_path)) == jinfer._collect_inputs(str(tmp_path)) == [
        str(tmp_path / n) for n in sorted(files)]
    assert infer._collect_inputs(str(tmp_path / "b.txt")) == [str(tmp_path / "b.txt")]
    for bad, err in ((tmp_path / "notes.md", ValueError), (tmp_path / "none.pcd", FileNotFoundError),
                     (tmp_path / "empty", FileNotFoundError)):
        (tmp_path / "empty").mkdir(exist_ok=True)
        with pytest.raises(err):
            infer._collect_inputs(str(bad))
    xyz = pts[:, :3]
    for n in (16, 40, 100):
        np.testing.assert_array_equal(infer._resample(xyz, n, np.random.RandomState(n)),
                                      jinfer._resample(xyz, n, np.random.RandomState(n)))
    for got, want in zip(infer._to_pcn_frame(xyz), jinfer._to_pcn_frame(xyz)):
        np.testing.assert_array_equal(got, want)


@pytest.fixture
def scans(tmp_path):
    """Three scans far from the origin (.npy with an intensity column, .txt,
    .h5) and the stand-in model's tiny PCN config."""
    rng = np.random.RandomState(6)
    d = tmp_path / "scans"
    d.mkdir()
    clouds = {"s1.npy": np.concatenate([rng.rand(50, 3) + [5, 0, 2], rng.rand(50, 1)], 1),
              "s2.txt": rng.rand(20, 3) * 2 - [3, 1, 0], "s3.h5": rng.rand(70, 3) * 0.5 + 10}
    for name, arr in clouds.items():
        (np.savetxt if name.endswith(".txt") else IO.put)(str(d / name), arr.astype(np.float32))
    cfg = pcn_config()
    cfg = cfg.replace(network=dataclasses.replace(cfg.network, resolution=16),
                      data=dataclasses.replace(cfg.data, n_points=32),
                      train=dataclasses.replace(cfg.train, batch_size=2))
    return SimpleNamespace(dir=d, clouds=clouds, cfg=cfg)


@pytest.mark.parametrize("normalize", [True, False])
def test_infer_files_maps_completions_back(scans, monkeypatch, tmp_path, caplog, normalize):
    """infer_files with the stand-in model: batches of 2 (the last one
    repeat-padded), each completion written as <stem>_completion.pcd, equal
    (to the PCD's 8 digits) to the model's output on the resampled scan in
    the PCN frame mapped back by ``/ scale + centroid``; without weights, a
    warning."""
    monkeypatch.setattr(loop, "build_model", _tiny_model)
    with caplog.at_level(logging.WARNING):
        outs = infer.infer_files(scans.cfg, str(scans.dir), normalize=normalize, device="cpu")
    assert "random weights" in caplog.text
    assert outs == [str(scans.dir / f"{s}_completion.pcd") for s in ("s1", "s2", "s3")]
    model = _tiny_model(scans.cfg, device="cpu", seed=scans.cfg.seed).eval()
    render = make_renderer(scans.cfg)
    rng = np.random.RandomState(1)
    for name, out in zip(sorted(scans.clouds), outs):
        xyz = jinfer._load_xyz(str(scans.dir / name))
        pts, centroid, scale = jinfer._to_pcn_frame(xyz) if normalize else (xyz, 0.0, 1.0)
        row = t(jinfer._resample(pts, 32, rng))[None].expand(2, -1, -1)
        with torch.no_grad():
            comp = model(row, render.get_img(row))[-1][0].numpy()
        np.testing.assert_allclose(read_pcd(out), comp / scale + centroid, rtol=2e-7, atol=1e-6)
        if normalize:  # the stand-in completes near its input: near the scan, in its frame
            assert np.abs(read_pcd(out).mean(0) - xyz.mean(0)).max() < 0.5 / scale


def test_main_pcn_complete_end_to_end(scans, monkeypatch, tmp_path):
    """``main_pcn --complete DIR --weights CKPT --out OUT`` with a checkpoint
    of this port: one completion a scan under OUT; a reference .pth raises
    with ROADMAP item 14."""
    monkeypatch.setattr(loop, "build_model", _tiny_model)
    monkeypatch.setattr(cli, "pcn_config", lambda: scans.cfg)
    ckpt = _stand_in_checkpoint(scans.cfg, str(tmp_path / "ckpt.pt"))
    out = tmp_path / "done"
    outs = cli.main_pcn(["--complete", str(scans.dir), "--weights", ckpt, "--out", str(out)],
                        device="cpu")
    assert sorted(os.listdir(out)) == [f"s{i}_completion.pcd" for i in (1, 2, 3)]
    assert all(read_pcd(p).shape == (64, 3) for p in outs)
    torch.save({"net": {}}, str(tmp_path / "orig.pth"))
    with pytest.raises(ValueError, match="item 14"):
        cli.main_pcn(["--complete", str(scans.dir), "--weights", str(tmp_path / "orig.pth")],
                     device="cpu")
