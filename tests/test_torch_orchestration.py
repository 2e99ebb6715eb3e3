"""The port's PCN orchestration on the CPU: ``train_net`` (epochs, the LR
schedule, validation, checkpoints, scalars, resume), ``test_net`` and the
``main_pcn`` surface, on a synthetic PCN-format tree of a few kilobytes.

The runs use a stand-in model of ~1,300 parameters with SVDFormer's interface
(the port's image trunk and a BatchNorm'd MLP), so that each checkpoint holds
kilobytes where SVDFormer's 41 M parameters and Adam moments would take
470 MB; SVDFormer's own train step is held against the JAX package in
tests/test_torch_train.py and driven through ``main_pcn`` on the card by
chip_smoke.py."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from torch import nn

from svdformer_pointsea_tpu_torch import cli
from svdformer_pointsea_tpu_torch import train as port_train
from svdformer_pointsea_tpu_torch.configs import pcn_config
from svdformer_pointsea_tpu_torch.data.synthetic import write_pcn_tree
from svdformer_pointsea_tpu_torch.nn import init_parameters, mixed_precision_enabled
from svdformer_pointsea_tpu_torch.nn.layers import SharedMLP
from svdformer_pointsea_tpu_torch.nn.resnet import ImageTrunk
from svdformer_pointsea_tpu_torch.train import loop

MODELS = {"train": 5, "val": 3, "test": 3}  # batch 2: 3 train steps an epoch, pad rows


class TinyCompletion(nn.Module):
    """partial (B, N, 3), depth (B, 3, H, W) -> (coarse, fine1, fine2) of N/2,
    N and 2N points, through an ImageTrunk (bf16 in bf16 mode) and a
    BatchNorm'd per-point MLP."""

    def __init__(self):
        super().__init__()
        self.img_trunk = ImageTrunk(feat_size=2)
        self.view = nn.Linear(3 * 16, 3)
        self.mlp = SharedMLP(3, (8, 3), if_bn=True, last_act=False)

    def forward(self, partial, depth):
        B, V = depth.shape[:2]
        f = self.img_trunk(depth.reshape(B * V, 1, *depth.shape[2:])).reshape(B, -1)
        x = partial + 0.1 * self.mlp(partial) + self.view(f)[:, None, :]
        n = x.shape[1]
        return x[:, :n // 2], x, torch.cat([x, x.flip(1)], dim=1)


def _tiny_model(cfg, device=None, seed=0):
    return init_parameters(TinyCompletion(), torch.Generator().manual_seed(seed)).to(
        loop.resolve_device(device))


@pytest.fixture
def tiny(monkeypatch, tmp_path):
    """A config over a fresh synthetic tree (partials of 16..99 points, 32 in
    the model, 3 scans per training model), with the stand-in model."""
    monkeypatch.setattr(loop, "build_model", _tiny_model)
    root = tmp_path / "pcn"
    write_pcn_tree(str(root), np.random.RandomState(0), MODELS, n_renderings=3, gt_points=64,
                   partial_points=(16, 100))
    cfg = pcn_config()
    return cfg.replace(
        network=dataclasses.replace(cfg.network, resolution=16),
        data=dataclasses.replace(
            cfg.data, category_file=f"{root}/datasets/ShapeNet.json", n_renderings=3,
            n_points=32, gt_points=64, num_workers=2,
            partial_points_path=f"{root}/dataset/PCN/%s/partial/%s/%s/%02d.pcd",
            complete_points_path=f"{root}/dataset/PCN/%s/complete/%s/%s.pcd"),
        train=dataclasses.replace(cfg.train, batch_size=2, n_epochs=2, save_freq=1,
                                  warmup_steps=2),
        out_path=str(tmp_path / "out"))


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_train_net_writes_checkpoints_and_scalars(tiny, monkeypatch, precision):
    cfg = tiny.replace(train=dataclasses.replace(tiny.train, precision=precision, progress=True))
    seen = set()
    real = loop.build_model

    def build(*args, **kw):
        model = real(*args, **kw)
        model.img_trunk.stem_conv.register_forward_hook(lambda m, i, o: seen.add(o.dtype))
        return model

    monkeypatch.setattr(loop, "build_model", build)
    state, best = port_train.train_net(cfg, device="cpu")
    assert np.isfinite(best) and state.step == 6  # 3 steps an epoch
    assert seen == {torch.bfloat16 if precision == "bf16" else torch.float32}
    assert not mixed_precision_enabled()  # the run's switch is restored
    ckpts = os.path.join(cfg.out_path, "checkpoints")
    assert sorted(os.listdir(ckpts)) == ["ckpt-best.pt", "ckpt-epoch-001.pt", "ckpt-epoch-002.pt"]
    # Hundreds of kilobytes (torch.save keeps a zip record per tensor).
    assert all(os.path.getsize(os.path.join(ckpts, n)) < 500_000 for n in os.listdir(ckpts))
    records = [json.loads(line) for line in open(os.path.join(cfg.out_path, "logs",
                                                                 "scalars.jsonl"))]
    assert {r["tag"] for r in records} >= {"Train/loss", "Train/lr", "Test/cd", "Test/dcd",
                                            "Test/f1"}
    lrs = [r["value"] for r in records if r["tag"] == "Train/lr"]
    assert lrs == [port_train.make_lr_fn(cfg)(s, e) for s, e in
                   zip(range(1, 7), (0, 0, 0, 1, 1, 1))]
    assert all(np.isfinite(r["value"]) for r in records)


def test_resume_ends_bit_equal_to_the_straight_run(tiny):
    """Two epochs straight, and one epoch then a resume from ckpt-epoch-001
    for the second: parameters, BatchNorm statistics, Adam's state, the step
    count and the best metric all equal."""
    torch.use_deterministic_algorithms(True)
    try:
        straight, best = port_train.train_net(tiny, device="cpu")
        first = os.path.join(tiny.out_path, "checkpoints", "ckpt-epoch-001.pt")
        resumed, best_r = port_train.train_net(
            tiny.replace(weights=first, out_path=tiny.out_path + "_resumed"), device="cpu")
    finally:
        torch.use_deterministic_algorithms(False)
    assert resumed.step == straight.step == 6 and best_r == best
    want = straight.model.state_dict()
    for name, got in resumed.model.state_dict().items():
        assert torch.equal(got, want[name]), name
    opt, opt_r = straight.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    assert opt.keys() == opt_r.keys()
    for key in opt:
        for field in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(opt[key][field], opt_r[key][field]), (key, field)


def test_test_net_prints_the_category_table(tiny, capsys):
    port_train.train_net(tiny.replace(train=dataclasses.replace(tiny.train, n_epochs=1)),
                         device="cpu")
    capsys.readouterr()
    best = os.path.join(tiny.out_path, "checkpoints", "ckpt-best.pt")
    mean_cd = port_train.test_net(tiny.replace(weights=best), device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].split("\t") == ["Taxonomy", "#Samples", "cd", "dcd", "f1"]
    rows = {line.split("\t")[0]: line.split("\t") for line in lines[1:]}
    assert set(rows) == {"02691156", "03001627", "Overall"}
    assert sum(int(rows[tax][1]) for tax in ("02691156", "03001627")) == MODELS["test"]
    assert np.isfinite(mean_cd) and abs(float(rows["Overall"][2]) - mean_cd) < 1e-4
    with pytest.raises(ValueError, match="item 14"):  # not a checkpoint of the port
        torch.save({"net": {}}, tiny.out_path + "/orig.pth")
        port_train.test_net(tiny.replace(weights=tiny.out_path + "/orig.pth"), device="cpu")


def test_main_pcn_parses_the_jax_flags(monkeypatch):
    calls = []
    monkeypatch.setattr(port_train, "train_net", lambda cfg, device=None: calls.append(
        ("train", cfg, device)))
    monkeypatch.setattr(port_train, "test_net", lambda cfg, device=None: calls.append(
        ("test", cfg, device)))
    cli.main_pcn(["--epochs", "3", "--precision", "bf16", "--out", "o", "--progress",
                  "--weights", "w.pt", "--sp", "1", "--dp", "gspmd"], device="cpu")
    kind, cfg, device = calls.pop()
    assert (kind, device, cfg.out_path, cfg.weights) == ("train", "cpu", "o", "w.pt")
    assert (cfg.train.n_epochs, cfg.train.precision, cfg.train.progress) == (3, "bf16", True)
    assert cfg.network == pcn_config().network and cfg.data == pcn_config().data
    for flag in ("--test", "--inference"):
        cli.main_pcn([flag, "--weights", "w.pt"], device="cpu")
        kind, cfg, device = calls.pop()
        assert (kind, device, cfg.weights, cfg.train.precision) == ("test", "cpu", "w.pt", "f32")


@pytest.mark.parametrize("argv,message", [
    (["--sp", "2"], "item 15"), (["--dp", "shard_map"], "item 15"),
    (["--complete", "scan.pcd"], "--weights"), (["--test"], "--weights"),
    (["--inference"], "--weights")])
def test_main_pcn_refuses_what_is_not_ported(argv, message):
    """What is not ported (multi-GPU) refuses with its ROADMAP item; what
    needs a checkpoint (--test, --inference, --complete) refuses without
    --weights."""
    with pytest.raises(SystemExit, match=message):
        cli.main_pcn(argv, device="cpu")


def test_cli_takes_the_pcn_track_only(monkeypatch):
    """Every track dispatches (``pcn``, ``55``, ``geospec``, ``pointsea`` and
    ``kitti``, to their main_*; kitti always evaluates); no track raises the
    usage line."""
    calls = []
    monkeypatch.setattr(port_train, "test_net", lambda cfg, device=None, mode=None: calls.append(
        (cfg.data.name, cfg.network.model, mode)))
    cli.main(["55", "--test", "--weights", "w.pt", "--mode", "hard"])
    cli.main(["pcn", "--test", "--weights", "w.pt"])
    cli.main(["geospec", "--test", "--weights", "w.pt"])
    cli.main(["pointsea", "--test", "--weights", "w.pt"])
    cli.main(["kitti", "--weights", "w.pt"])
    assert calls == [("ShapeNet55", "svdformer", "hard"), ("ShapeNet", "svdformer", None),
                     ("ShapeNet", "geospecnet", None), ("ShapeNet", "pointsea", None),
                     ("KITTI", "svdformer", None)]
    for argv in (["kittix"], []):
        with pytest.raises(SystemExit, match="usage"):
            cli.main(argv)


def test_entry_points_need_the_card_unless_cpu_is_asked(monkeypatch, tmp_path):
    """Without a card and without device="cpu", main_pcn, main_kitti,
    train_net and test_net raise before reading any data; a configuration
    the port does not run raises with its ROADMAP item, and KITTI, which has
    no ground truth, is refused training."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)  # no dataset here
    cfg = pcn_config()
    for run in (lambda: cli.main_pcn([]), lambda: port_train.train_net(cfg),
                lambda: port_train.test_net(cfg.replace(weights="w.pt")),
                lambda: cli.main_kitti(["--weights", "w.pt"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()
    for train, item in (({"sp": 2}, "item 15"), ({"dp": "shard_map"}, "item 15")):
        with pytest.raises(NotImplementedError, match=item):
            port_train.train_net(cfg.replace(train=dataclasses.replace(cfg.train, **train)),
                                 device="cpu")
    with pytest.raises(NotImplementedError, match="evaluation-only"):  # the KITTI track
        port_train.train_net(cfg.replace(data=dataclasses.replace(cfg.data, name="KITTI")),
                             device="cpu")
    # PointSea passes the checks and stops at the device, before any data.
    pointsea = cfg.replace(network=dataclasses.replace(cfg.network, model="pointsea"))
    loop.check_supported(pointsea)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_train.train_net(pointsea)
