"""PyTorch port ops vs the JAX package on the CPU: FPS, NN distance and
chamfer (with its backward), kNN grouping, metrics, the depth renderer and
the evaluation losses. The port's wrappers run their plain versions here."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from port_parity import close, jax_reference_modes, t  # noqa: F401
from svdformer_pointsea_tpu import losses as jlosses
from svdformer_pointsea_tpu import ops as jops
from svdformer_pointsea_tpu.ops.distances import _nn_one_way as jax_nn_one_way
from svdformer_pointsea_tpu.ops.nn_pallas import nn_one_way_pallas
from svdformer_pointsea_tpu.render import PCViews as JaxPCViews
from svdformer_pointsea_tpu.render.pcviews import points2depth as jax_points2depth
from svdformer_pointsea_tpu_torch import losses, ops
from svdformer_pointsea_tpu_torch.render import PCViews, points2depth

pytestmark = pytest.mark.usefixtures("jax_reference_modes")


def _fps_numpy(xyz, m):
    """Literal transcription of the pointnet2 CUDA FPS semantics."""
    B, N, _ = xyz.shape
    out = np.zeros((B, m), np.int32)
    for b in range(B):
        temp = np.full(N, 1e10, np.float32)
        valid = np.sum(xyz[b] ** 2, -1) > 1e-3
        old = 0
        for j in range(1, m):
            temp = np.minimum(temp, np.sum((xyz[b] - xyz[b, old]) ** 2, -1))
            best, besti = -1.0, 0
            for k in range(N):
                if valid[k] and temp[k] > best:
                    best, besti = temp[k], k
            out[b, j] = old = besti
    return out


@pytest.mark.parametrize("n,m", [(100, 16), (512, 128), (300, 300)])
def test_fps_matches_jax_ref(rng, n, m):
    xyz = (rng.rand(2, n, 3) - 0.5).astype(np.float32)
    got = ops.furthest_point_sample(t(xyz), m)
    assert got.dtype == torch.int32 and got.shape == (2, m)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jops.furthest_point_sample_ref(jnp.asarray(xyz), m)))


def test_fps_quirk_goldens(rng):
    xyz = rng.rand(2, 128, 3).astype(np.float32) + 0.5
    np.testing.assert_array_equal(ops.furthest_point_sample(t(xyz), 32).numpy(), _fps_numpy(xyz, 32))
    xyz = rng.rand(3, 64, 3).astype(np.float32) + 0.5
    xyz[0, 10] = 0.0
    xyz[0, 20] = 0.01  # |p|^2 = 3e-4 <= 1e-3: never picked
    xyz[1] = 0.0  # no valid point: every pick falls back to 0
    xyz[2, 32:] = xyz[2, :32]  # duplicates: ties go to the lowest index
    idx = ops.furthest_point_sample(t(xyz), 40).numpy()
    assert idx[0, 0] == 0 and 10 not in idx[0, 1:] and 20 not in idx[0, 1:]
    assert not idx[1].any()
    np.testing.assert_array_equal(idx, _fps_numpy(xyz, 40))
    np.testing.assert_array_equal(idx, np.asarray(jops.furthest_point_sample_ref(jnp.asarray(xyz), 40)))


def test_fps_subsample_and_gather(rng):
    pcd = t(rng.rand(2, 256, 3).astype(np.float32))
    assert ops.fps_subsample(pcd, 256) is pcd
    out = ops.fps_subsample(pcd, 64)
    close(out, jops.fps_subsample(jnp.asarray(pcd.numpy()), 64), atol=0)


def _check_nn(a, b, d, idx, d_ref):
    """Distances within 1e-6; argmins checked by the distance they pick."""
    np.testing.assert_allclose(d, d_ref, atol=1e-6)
    chosen = np.take_along_axis(b, idx[..., None].astype(np.int64), axis=1)
    np.testing.assert_allclose(np.sum((a - chosen) ** 2, -1), d_ref, atol=1e-6)


def test_nn_one_way_matches_pallas_interpret(rng):
    a = rng.rand(2, 300, 3).astype(np.float32)
    b = rng.rand(2, 1000, 3).astype(np.float32)
    d, idx = ops.nn_one_way(t(a), t(b))
    assert d.dtype == torch.float32 and idx.dtype == torch.int32
    with pltpu.force_tpu_interpret_mode():
        d_p, _ = nn_one_way_pallas(jnp.asarray(a), jnp.asarray(b))
    _check_nn(a, b, d.numpy(), idx.numpy(), np.asarray(d_p))


def test_nn_one_way_tie_across_a_tile_matches_pallas_interpret(rng):
    """Equal targets on either side of a 1,024-point tile (and of the port
    kernel's 256-point tiles and the Pallas kernel's 2,048-point one): the
    plain version and the Pallas kernel in interpret mode both keep the lower
    index, at distance 0 and at a distance above 0. This is the tie rule that
    K1 is held to on the card."""
    a = rng.rand(2, 16, 3).astype(np.float32)
    b = rng.rand(2, 2304, 3).astype(np.float32)
    pairs = [(1023, 1024), (255, 256), (2047, 2048), (511, 1537)]
    for q, (lo, hi) in enumerate(pairs):
        b[:, hi] = b[:, lo]
        a[:, q] = b[:, lo]  # distance 0 to both
        a[:, q + len(pairs)] = b[:, lo] + np.float32(1e-4)  # the same distance to both
    d, idx = ops.nn_one_way_plain(t(a), t(b))
    with pltpu.force_tpu_interpret_mode():
        d_p, idx_p = nn_one_way_pallas(jnp.asarray(a), jnp.asarray(b))
    want = np.array([lo for lo, _ in pairs] * 2)
    ties = slice(0, 2 * len(pairs))
    np.testing.assert_array_equal(idx.numpy()[:, ties], np.broadcast_to(want, (2, len(want))))
    np.testing.assert_array_equal(np.asarray(idx_p)[:, ties], idx.numpy()[:, ties])
    assert not d.numpy()[:, :len(pairs)].any()
    _check_nn(a, b, d.numpy(), idx.numpy(), np.asarray(d_p))


@pytest.mark.parametrize("n,m", [(256, 256), (300, 1000), (1024, 257)])
def test_nn_one_way_matches_jax(rng, n, m):
    a = rng.rand(2, n, 3).astype(np.float32)
    b = rng.rand(2, m, 3).astype(np.float32)
    d, idx = ops.nn_one_way(t(a), t(b))
    d_j, _ = jax_nn_one_way(jnp.asarray(a), jnp.asarray(b))
    _check_nn(a, b, d.numpy(), idx.numpy(), np.asarray(d_j))


def test_nn_one_way_chunks_queries(rng, monkeypatch):
    from svdformer_pointsea_tpu_torch.ops import distances

    a, b = t(rng.rand(2, 100, 3).astype(np.float32)), t(rng.rand(2, 70, 3).astype(np.float32))
    whole = ops.nn_one_way_plain(a, b)
    monkeypatch.setattr(distances, "_CHUNK_BYTES", 16 * 2 * 70 * 7)  # 7-query chunks
    chunked = ops.nn_one_way_plain(a, b)
    assert torch.equal(whole[0], chunked[0]) and torch.equal(whole[1], chunked[1])


def test_chamfer_forward_and_backward_match_jax(rng):
    x1 = rng.rand(2, 64, 3).astype(np.float32)
    x2 = rng.rand(2, 48, 3).astype(np.float32)
    w1 = rng.rand(2, 64).astype(np.float32)
    w2 = rng.rand(2, 48).astype(np.float32)

    def jloss(a, b):
        d1, d2, _, _ = jops.chamfer_distance(a, b)
        return jnp.sum(d1 * w1) + jnp.sum(d2 * w2)

    g1, g2 = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(x1), jnp.asarray(x2))
    a, b = t(x1).requires_grad_(), t(x2).requires_grad_()
    d1, d2, i1, i2 = ops.chamfer_distance(a, b)
    jd1, jd2, _, _ = jax.jit(jops.chamfer_distance)(jnp.asarray(x1), jnp.asarray(x2))
    close(d1, jd1, atol=1e-6)
    close(d2, jd2, atol=1e-6)
    ((d1 * t(w1)).sum() + (d2 * t(w2)).sum()).backward()
    close(a.grad, g1, atol=1e-5)
    close(b.grad, g2, atol=1e-5)


def test_nn_squared_distance_grad_matches_jax(rng):
    q = rng.rand(2, 64, 3).astype(np.float32)
    tg = rng.rand(2, 48, 3).astype(np.float32)
    w = np.arange(64.0, dtype=np.float32)
    gq, gt = jax.jit(jax.grad(lambda a, b: jnp.sum(jops.nn_squared_distance(a, b) * w), argnums=(0, 1)))(
        jnp.asarray(q), jnp.asarray(tg))
    a, b = t(q).requires_grad_(), t(tg).requires_grad_()
    (ops.nn_squared_distance(a, b) * t(w)).sum().backward()
    close(a.grad, gq, atol=1e-5)
    close(b.grad, gt, atol=1e-5)


def test_square_distance_and_knn_match_jax(rng):
    src = rng.rand(2, 40, 5).astype(np.float32)
    dst = rng.rand(2, 60, 5).astype(np.float32)
    close(ops.square_distance(t(src), t(dst)), jops.square_distance(jnp.asarray(src), jnp.asarray(dst)),
          atol=1e-5)
    got = ops.query_knn(8, t(dst), t(src))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jops.query_knn(8, jnp.asarray(dst), jnp.asarray(src))))


def test_grouping_matches_jax(rng):
    xyz = (rng.rand(2, 256, 3) - 0.5).astype(np.float32)
    pts = rng.rand(2, 256, 6).astype(np.float32)
    idx = rng.randint(0, 256, size=(2, 32, 8))
    close(ops.index_points(t(pts), t(idx)), jops.index_points(jnp.asarray(pts), jnp.asarray(idx)), atol=0)
    close(ops.grouping_operation(t(pts), t(idx)),
          jops.grouping_operation(jnp.asarray(pts), jnp.asarray(idx)), atol=0)
    for points, use_xyz in ((pts, True), (pts, False), (None, True)):
        got = ops.sample_and_group_knn(t(xyz), None if points is None else t(points), 64, 16, use_xyz)
        want = jax.jit(jops.sample_and_group_knn, static_argnums=(2, 3, 4))(jnp.asarray(xyz), points, 64, 16, use_xyz)
        for g, w in zip(got, want):
            close(g, w, atol=1e-7)
        got = ops.sample_and_group_all(t(xyz), None if points is None else t(points), use_xyz)
        want = jops.sample_and_group_all(jnp.asarray(xyz), points, use_xyz)
        for g, w in zip(got, want):
            close(g, w, atol=0)
    close(ops.group_local(t(pts), k=10), jax.jit(jops.group_local, static_argnums=1)(jnp.asarray(pts), 10),
          atol=0)


def test_metrics_match_jax(rng):
    x = rng.rand(2, 300, 3).astype(np.float32) * 0.1
    gt = rng.rand(2, 500, 3).astype(np.float32) * 0.1
    d1, d2, _, _ = ops.chamfer_distance(t(gt), t(x))
    jd1, jd2, _, _ = jax.jit(jops.chamfer_distance)(jnp.asarray(gt), jnp.asarray(x))
    for g, w in zip(ops.fscore(d1, d2), jax.jit(jops.fscore)(jd1, jd2)):
        close(g, w, atol=1e-6)
    got = ops.density_aware_chamfer(t(x), t(gt))
    want = jax.jit(jops.density_aware_chamfer)(jnp.asarray(x), jnp.asarray(gt))
    for g, w in zip(got, want):
        close(g, w, atol=1e-6, rtol=1e-5)


def test_bincount_gather_counts_exactly():
    from svdformer_pointsea_tpu_torch.ops.metrics import _bincount_gather

    idx = torch.tensor([[0, 2, 2, 2, 1], [4, 4, 0, 1, 4]])
    assert _bincount_gather(idx, 5).tolist() == [[1, 3, 3, 3, 1], [3, 3, 1, 1, 3]]


def test_calc_cd_and_dcd_match_jax(rng):
    out = rng.rand(2, 256, 3).astype(np.float32) * 0.2
    gt = rng.rand(2, 400, 3).astype(np.float32) * 0.2
    jcd = jax.jit(jlosses.calc_cd, static_argnames="calc_f1")
    for g, w in zip(losses.calc_cd(t(out), t(gt), calc_f1=True),
                    jcd(jnp.asarray(out), jnp.asarray(gt), calc_f1=True)):
        close(g, w, atol=1e-6, rtol=1e-5)
    for g, w in zip(losses.calc_dcd(t(out), t(gt)), jax.jit(jlosses.calc_dcd)(jnp.asarray(out), jnp.asarray(gt))):
        close(g, w, atol=1e-6, rtol=1e-5)


def test_pcviews_render_matches_jax(rng):
    pts = (rng.rand(2, 512, 3) - 0.5).astype(np.float32)
    pts[0, :5] = 0.0  # points at the camera's own depth sign boundary stay masked alike
    got = PCViews(trans=-0.7, resolution=32).get_img(t(pts))
    want = JaxPCViews(trans=-0.7, resolution=32).get_img(jnp.asarray(pts))
    assert got.shape == (2, 3, 32, 32)
    close(got, want, atol=1e-5)


def test_points2depth_splat_matches_jax(rng):
    # 4 x 4 splat with points off the image edge (the ceil + modulo-wrap path)
    # and behind the camera (negative depth: masked).
    pts = (rng.rand(2, 200, 3) * [2.4, 2.4, 1.0] - [1.2, 1.2, 0.3]).astype(np.float32)
    got = points2depth(t(pts), 16, 16, size_x=4, size_y=4)
    want = jax.jit(jax_points2depth, static_argnums=(1, 2, 3, 4))(jnp.asarray(pts), 16, 16, 4, 4)
    close(got, want, atol=1e-5, rtol=1e-5)


def test_port_imports_without_jax():
    """Every module of the port but its bench scripts imports, and none of
    them brings in jax, flax or the JAX package."""
    code = (
        "import importlib, pkgutil, sys; import svdformer_pointsea_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')\n"
        "         if not m.name.rsplit('.', 1)[-1].startswith('bench_')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert {'svdformer_pointsea_tpu_torch.data.crop', 'svdformer_pointsea_tpu_torch.train.gan', "
        "'svdformer_pointsea_tpu_torch.nn.discriminator', 'svdformer_pointsea_tpu_torch.cli', "
        "'svdformer_pointsea_tpu_torch.kernels', 'svdformer_pointsea_tpu_torch.train.loop', "
        "'svdformer_pointsea_tpu_torch.nn.geospecnet', 'svdformer_pointsea_tpu_torch.ops.scatter', "
        "'svdformer_pointsea_tpu_torch.nn.pointsea', 'svdformer_pointsea_tpu_torch.render.realistic'} "
        "<= set(names), names\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', "
        "'svdformer_pointsea_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=str(__import__("pathlib").Path(
        __file__).resolve().parent.parent))
