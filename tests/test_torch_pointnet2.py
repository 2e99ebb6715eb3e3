"""The port's PointNet++ ops and modules and its EMD auction vs the JAX
package on the CPU.

Ball query, 3-NN and the auction are discrete: one flipped comparison changes
an index. They are held bit for bit on coordinates quantized to multiples of
2⁻⁶ in [0, 1), where the matmul-form squared distance is exact on both sides
(every product and partial sum is a multiple of 2⁻¹² below 4); such inputs
are full of exact ties, which exercises the tie rules. The modules are held
at 1e-5 relative through a strict ``params_from_jax``, in eval and train
mode, with the running statistics after a train-mode call."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_parity import jax_blocked_bn_sums, jax_variables, load_port, t  # noqa: F401
from svdformer_pointsea_tpu import ops as jops
from svdformer_pointsea_tpu.nn import layers as jl
from svdformer_pointsea_tpu.ops import emd as jemd
from svdformer_pointsea_tpu_torch import ops
from svdformer_pointsea_tpu_torch.nn import layers as tl
from svdformer_pointsea_tpu_torch.ops import emd

MODULE_RTOL = 1e-5  # the modules' outputs and running statistics, relative to their largest entry
INTERP_ATOL = 1e-6  # three_interpolate on random features (the sum's order)


def _quantized(rng, *shape):
    """Coordinates on a grid of 2⁻⁶ in [0, 1)."""
    return (rng.randint(0, 64, size=shape) / 64.0).astype(np.float32)


def _eq(port, want):
    np.testing.assert_array_equal(np.asarray(port), np.asarray(want))


@pytest.mark.parametrize("radius,nsample", [(0.1, 8), (0.3, 16)])
def test_ball_query_matches_jax_bit_for_bit(radius, nsample):
    """First hits in index order, short balls padded with their first hit,
    empty balls 0 (the centres far outside the cloud), bit for bit."""
    rng = np.random.RandomState(nsample)
    xyz = _quantized(rng, 2, 96, 3)
    centres = np.concatenate([xyz[:, :20], _quantized(rng, 2, 8, 3) + 4.0], axis=1)
    want = jax.jit(jops.ball_query, static_argnums=(0, 1))(radius, nsample, xyz, centres)
    got = ops.ball_query(radius, nsample, t(xyz), t(centres))
    assert got.dtype == torch.int32 and got.shape == (2, 28, nsample)
    _eq(got, want)
    hits = (np.asarray(jops.square_distance(centres, xyz)) < radius * radius).sum(-1)
    assert (hits[:, 20:] == 0).all() and (got[:, 20:] == 0).all()
    short = (hits[:, :20] > 0) & (hits[:, :20] < nsample)
    assert short.any()  # padded with the first hit
    first = got[:, :20, :1].expand(-1, -1, nsample)
    pad = torch.arange(nsample) >= torch.as_tensor(hits[:, :20, None])
    assert torch.equal(got[:, :20][pad], first[pad])


@pytest.mark.parametrize("use_xyz", [True, False])
def test_sample_and_group_ball_matches_jax(use_xyz):
    rng = np.random.RandomState(3)
    xyz, pts = _quantized(rng, 2, 128, 3), _quantized(rng, 2, 128, 5)
    want = jax.jit(jops.sample_and_group_ball, static_argnums=(2, 3, 4, 5))(
        xyz, pts, 32, 8, 0.2, use_xyz)
    got = ops.sample_and_group_ball(t(xyz), t(pts), 32, 8, 0.2, use_xyz)
    for g, w in zip(got, want):
        _eq(g, w)


def test_three_nn_ties_to_the_lowest_index():
    """Known points duplicated (exact ties in distance): the lowest index
    first, as lax.top_k orders them; distances and indices bit for bit."""
    rng = np.random.RandomState(4)
    known = _quantized(rng, 2, 40, 3)
    known[:, 20:] = known[:, :20]  # every point twice
    known[:, 5] = known[:, 7]
    unknown = np.concatenate([known[:, :10], _quantized(rng, 2, 30, 3)], axis=1)
    d_want, i_want = jax.jit(jops.three_nn)(unknown, known)
    d_got, i_got = ops.three_nn(t(unknown), t(known))
    assert i_got.dtype == torch.int32
    _eq(d_got, d_want)
    _eq(i_got, i_want)
    ties = d_got[..., :-1] == d_got[..., 1:]
    assert ties[:, :10, 0].all() and (i_got[..., :-1] < i_got[..., 1:])[ties].all()


def test_three_interpolate_forward_and_gradient():
    rng = np.random.RandomState(5)
    points = rng.randn(2, 40, 6).astype(np.float32)
    idx = rng.randint(0, 40, size=(2, 50, 3)).astype(np.int32)
    idx[:, :5] = 7  # one row gathered many times: the backward adds into it
    weight = rng.rand(2, 50, 3).astype(np.float32)
    cot = rng.randn(2, 50, 6).astype(np.float32)

    @jax.jit
    def jax_forward_backward(p, c):
        out, vjp = jax.vjp(lambda q: jops.three_interpolate(q, idx, weight), p)
        return out, vjp(c)[0]

    want, grad = jax_forward_backward(points, cot)
    p = t(points).requires_grad_(True)
    got = ops.three_interpolate(p, t(idx), t(weight))
    got.backward(t(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=INTERP_ATOL)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(grad), atol=INTERP_ATOL)


# --- EMD ---------------------------------------------------------------------


@pytest.fixture
def chunk(request, monkeypatch):
    """The chunk over xyz2 on both sides: the whole set (what ``_pick_chunk``
    gives at test sizes) or 16 points (the merge across chunks)."""
    if request.param is not None:
        monkeypatch.setattr(emd, "_pick_chunk", lambda m, b, n: request.param)
        monkeypatch.setattr(jemd, "_pick_chunk", lambda m, b, n: request.param)
    return request.param


def _jax_emd_convergence(x1, x2, eps, iters):
    """JAX's emd_convergence, traced afresh (jit caches a trace by function,
    so a patched ``_pick_chunk`` needs a new one)."""
    return jax.jit(lambda a, b: jemd.emd_convergence(a, b, eps, iters))(x1, x2)


@pytest.mark.parametrize("chunk", [None, 16], indirect=True)
@pytest.mark.parametrize("eps,iters", [(0.005, 50), (0.002, 10000)])
def test_emd_matches_jax_bit_for_bit(chunk, eps, iters):
    """dist, assignment and the iterations used, bit for bit, at the train
    point (points left unassigned) and the evaluation point (converged)."""
    rng = np.random.RandomState(6)
    x1, x2 = _quantized(rng, 2, 64, 3), _quantized(rng, 2, 64, 3)
    x2[:, 32:48] = x2[:, :16]  # duplicated targets, in another chunk
    want = _jax_emd_convergence(x1, x2, eps, iters)
    got = emd.emd_convergence(t(x1), t(x2), eps, iters)
    for g, w in zip(got, want):
        _eq(g, w)
    unassigned = emd.emd_unassigned(got[1])
    _eq(unassigned, jemd.emd_unassigned(want[1]))
    assert (int(unassigned.sum()) > 0) == (iters == 50)
    assert int(got[2]) <= iters


def test_top2_values_across_chunks_matches_jax():
    """Within a chunk the runner-up skips every value equal to the best;
    across chunks a tie makes it equal to the best: the port's merge against
    JAX's at chunk < m, on tied values and prices."""
    rng = np.random.RandomState(7)
    x1, x2 = _quantized(rng, 2, 48, 3), _quantized(rng, 2, 64, 3)
    x2[:, 16:32] = x2[:, :16]  # ties across chunks
    x2[:, 40:44] = x2[:, 36:37]  # ties within one
    price = (rng.randint(0, 4, size=(2, 64)) / 8.0).astype(np.float32)
    for c in (8, 16, 32, 64):
        want = jax.jit(jemd._top2_values, static_argnums=3)(x1, x2, price, c)
        if c == 16:  # x2[16:32] repeats the first chunk: best and runner-up tie
            assert np.asarray(want[0] == want[1]).any()
        got = emd._top2_values(t(x1), t(x2), t(price), c)
        for g, w in zip(got, want):
            _eq(g, w)


def test_emd_gradient_goes_to_xyz1_only():
    """2·g·(xyz1 − xyz2[assignment]) on assigned rows, 0 on the rest,
    nothing to xyz2; bit for bit against JAX's custom VJP."""
    rng = np.random.RandomState(8)
    x1, x2 = _quantized(rng, 2, 64, 3), _quantized(rng, 2, 64, 3)
    g = (rng.randint(-8, 8, size=(2, 64)) / 8.0).astype(np.float32)

    def jax_loss(a, b):
        dist, _ = jemd.earth_mover_distance(a, b, 0.005, 20)
        return jnp.sum(dist * g)

    grads = jax.jit(jax.grad(jax_loss, argnums=(0, 1)))(x1, x2)
    a, b = t(x1).requires_grad_(True), t(x2).requires_grad_(True)
    dist, assignment = ops.earth_mover_distance(a, b, 0.005, 20)
    (dist * t(g)).sum().backward()
    _eq(a.grad, grads[0])
    assert b.grad is None and not np.asarray(grads[1]).any()
    assert (assignment < 0).any() and not a.grad[assignment < 0].any()


def test_emd_converges_on_a_permuted_copy_and_is_near_optimal():
    """A permuted copy: every point assigned, a bijection at distance 0, in
    JAX's iteration count. Random clouds at eps 0.001: the total cost within
    the auction's bound of scipy's exact optimum (JAX's tests/test_emd.py)."""
    scipy_opt = pytest.importorskip("scipy.optimize")
    rng = np.random.RandomState(9)
    x = rng.rand(2, 128, 3).astype(np.float32)
    y = np.take_along_axis(x, np.stack([rng.permutation(128) for _ in range(2)])[..., None], 1)
    dist, assignment, used = emd.emd_convergence(t(x), t(y), 0.002, 10000)
    assert int(emd.emd_unassigned(assignment).max()) == 0 and float(dist.sum()) < 1e-6
    assert all(len(set(a.tolist())) == 128 for a in assignment)
    assert int(used) == int(_jax_emd_convergence(x, y, 0.002, 10000)[2])
    n = 48  # the JAX test's clouds
    rng = np.random.RandomState(0)
    x1, x2 = rng.rand(1, n, 3).astype(np.float32), rng.rand(1, n, 3).astype(np.float32)
    cost = float(ops.earth_mover_distance(t(x1), t(x2), 0.001, 10000)[0].sum())
    d2 = np.sum((x1[0, :, None] - x2[0, None]) ** 2, -1)
    r, c = scipy_opt.linear_sum_assignment(d2)
    optimal = float(d2[r, c].sum())
    assert optimal - 1e-6 <= cost <= optimal + n * 0.001 * 3


def test_pick_chunk_matches_jax():
    for m, b, n in ((2048, 8, 2048), (8192, 2, 8192), (64, 2, 64), (1000, 3, 7000), (97, 64, 64)):
        assert emd._pick_chunk(m, b, n) == jemd._pick_chunk(m, b, n)


# --- PointNet++ modules ------------------------------------------------------


def _compare_module(jmod, tmod, train, *args):
    """The JAX module and the port's with the same random variables, in
    eval mode, or in train mode with the running statistics after the call.
    In train mode JAX takes its BatchNorm moments as the port does, from
    row-weighted sums (all weights 1), summed in blocks (the test's
    ``jax_blocked_bn_sums``): XLA's CPU sums the rows one after another, and
    on groups padded with repeated points (ball query's) its moments stray
    from an f64 evaluation by ~1e-4 of the output, the port's by ~4e-7."""
    variables = jax_variables(jmod, *args, seed=11)
    port = load_port(tmod, variables)
    targs = [None if a is None else t(a) for a in args]
    if train:
        with jl.bn_row_weights(jnp.ones(args[0].shape[0])):
            want, updates = jax.jit(functools.partial(jmod.apply, train=True,
                                                      mutable=["batch_stats"]))(variables, *args)
        port.train()
    else:
        want, updates = jax.jit(jmod.apply)(variables, *args), None
    with torch.no_grad():
        got = port(*targs)
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=MODULE_RTOL * np.abs(w).max())
    if train:
        state = port.state_dict()
        leaves = jax.tree_util.tree_leaves_with_path(updates["batch_stats"])
        assert leaves
        for path, leaf in leaves:
            keys = [p.key for p in path]
            name = ".".join(keys[:-1] + [{"mean": "running_mean", "var": "running_var"}[keys[-1]]])
            leaf = np.asarray(leaf)
            np.testing.assert_allclose(state[name].numpy(), leaf, rtol=0,
                                       atol=MODULE_RTOL * np.abs(leaf).max())


@pytest.mark.parametrize("train", [False, True])
def test_sa_module_matches_jax(train, jax_blocked_bn_sums):
    rng = np.random.RandomState(12)
    xyz, pts = _quantized(rng, 2, 128, 3), rng.randn(2, 128, 5).astype(np.float32)
    _compare_module(jl.PointNetSAModule(32, 8, 0.2, (16, 24)),
                    tl.PointNetSAModule(32, 8, 0.2, 5, (16, 24)), train, xyz, pts)
    _compare_module(jl.PointNetSAModule(None, None, None, (16, 24), group_all=True),
                    tl.PointNetSAModule(None, None, None, 5, (16, 24), group_all=True),
                    train, xyz, pts)


@pytest.mark.parametrize("train", [False, True])
def test_sa_msg_module_matches_jax(train, jax_blocked_bn_sums):
    rng = np.random.RandomState(13)
    xyz, pts = _quantized(rng, 2, 128, 3), rng.randn(2, 128, 4).astype(np.float32)
    mlps = ((8, 16), (16, 16), (8, 12))
    _compare_module(jl.PointNetSAModuleMSG(32, (0.1, 0.2, 0.4), (4, 8, 16), mlps),
                    tl.PointNetSAModuleMSG(32, (0.1, 0.2, 0.4), (4, 8, 16), 4, mlps),
                    train, xyz, pts)
    _compare_module(jl.PointNetSAModuleMSG(32, (0.2,), (8,), mlps[:1]),
                    tl.PointNetSAModuleMSG(32, (0.2,), (8,), 0, mlps[:1]), train, xyz, None)
    with pytest.raises(AssertionError, match="use_xyz"):
        tl.PointNetSAModuleMSG(32, (0.2,), (8,), 0, mlps[:1], use_xyz=False)(t(xyz), None)


@pytest.mark.parametrize("global_feat", [True, False])
@pytest.mark.parametrize("train", [False, True])
def test_feature_extractor_matches_jax(train, global_feat, jax_blocked_bn_sums):
    x = np.random.RandomState(14).randn(2, 64, 3).astype(np.float32)
    _compare_module(jl.PointNetFeatureExtractor(64, (16, 32), global_feat=global_feat),
                    tl.PointNetFeatureExtractor(3, 64, (16, 32), global_feat=global_feat),
                    train, x)


@pytest.mark.parametrize("train", [False, True])
def test_fp_module_matches_jax(train, jax_blocked_bn_sums):
    """Interpolation from duplicated known points (3-NN ties), with and
    without the skip features."""
    rng = np.random.RandomState(15)
    xyz1, xyz2 = _quantized(rng, 2, 96, 3), _quantized(rng, 2, 24, 3)
    xyz2[:, 12:] = xyz2[:, :12]
    p1, p2 = rng.randn(2, 96, 4).astype(np.float32), rng.randn(2, 24, 8).astype(np.float32)
    _compare_module(jl.PointNetFPModule((16, 12), use_points1=True),
                    tl.PointNetFPModule(12, (16, 12), use_points1=True), train, xyz1, xyz2, p1, p2)
    _compare_module(jl.PointNetFPModule((16,)), tl.PointNetFPModule(8, (16,)), train,
                    xyz1, xyz2, None, p2)
