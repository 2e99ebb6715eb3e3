"""Earth Mover's Distance by the auction algorithm (semantics of
svdformer_pointsea_tpu/ops/emd.py, the reference's metrics/EMD).

Every unassigned point of ``xyz1`` bids for the ``xyz2`` point of highest
value ``3 − ‖p − q‖ − price`` by its margin over the runner-up plus ``eps``;
each contested point goes to its highest bid (the lowest bidder index among
equal bids), its price rises by that bid, and its previous owner is evicted.
The iterations are dense torch ops: the values in chunks of ``xyz2``
(``_pick_chunk``), the winners by scatter-max and scatter-min, which give the
same bits in any order, and the JAX package's dropped writes as a spare
column sliced off. An iteration in which nobody is unassigned changes
nothing, so the loop reads the unassigned count (a host sync) only after
iterations 1, 2, 4, ..., 64 and then every 64, and counts the iterations
used on the device.

Contract: ``xyz1``, ``xyz2`` (B, n, 3), coordinates ideally in [0, 1];
returns the squared matched distances (B, n), 0 on rows left unassigned, and
the int32 match index (B, n), -1 where unassigned; the gradient goes to
``xyz1`` only. Operating points: train eps 0.005, iters 50; evaluation eps
0.002, iters 10000.
"""

from __future__ import annotations

import torch

_VALUE_BASE = 3.0  # the bid value is 3 − ‖p − q‖ − price
_CHUNK_BYTES = 64 * 1024 * 1024  # the (B, n, chunk) f32 value tile
_SYNC_EVERY = 64


def _pick_chunk(m: int, b: int, n: int) -> int:
    """The largest divisor of ``m`` whose (b, n, chunk) f32 tile fits in
    ``_CHUNK_BYTES``."""
    budget = max(1, _CHUNK_BYTES // max(1, 4 * b * n))
    return max(c for c in range(1, m + 1) if m % c == 0 and c <= budget)


def _top2_values(x1: torch.Tensor, x2: torch.Tensor, price: torch.Tensor, chunk: int):
    """Best and second-best value and the best index (first on ties) of
    every bidder, (B, n) each, over chunks of ``chunk`` points of ``x2``.
    Within a chunk the runner-up is the best value below the best (every
    value equal to the best is masked); across chunks a tie makes it equal
    to the best."""
    B, n, _ = x1.shape
    x1sq = (x1 * x1).sum(-1)
    v1 = torch.full((B, n), -torch.inf, device=x1.device)
    v2 = torch.full((B, n), -torch.inf, device=x1.device)
    j1 = torch.zeros(B, n, dtype=torch.int64, device=x1.device)
    for base in range(0, x2.shape[1], chunk):
        x2c, pc = x2[:, base:base + chunk], price[:, base:base + chunk]
        d2 = x1sq[:, :, None] - 2 * torch.bmm(x1, x2c.transpose(1, 2)) + (x2c * x2c).sum(-1)[:, None]
        value = _VALUE_BASE - d2.clamp_min(0.0).sqrt() - pc[:, None, :]
        cv1 = value.amax(-1)
        cj = value.argmax(-1) + base
        cv2 = torch.where(value == cv1[..., None], -torch.inf, value).amax(-1)
        v1, j1, v2 = (torch.maximum(v1, cv1), torch.where(cv1 > v1, cj, j1),
                      torch.maximum(torch.minimum(v1, cv1), torch.where(v1 >= cv1, v2, cv2)))
    return v1, v2, j1


def _auction_iteration(assignment, assignment_inv, price, x1, x2, eps: float, chunk: int):
    """One round of bids: returns the new (assignment (B, n), assignment_inv
    (B, m), price (B, m)); int64 indices, -1 for none."""
    B, n, _ = x1.shape
    m = x2.shape[1]
    unass = assignment < 0
    v1, v2, j_star = _top2_values(x1, x2, price, chunk)
    v2 = torch.where(torch.isfinite(v2), v2, v1)  # one value in all: a zero margin
    bid = torch.where(unass, v1 - v2 + eps, -torch.inf)
    max_bid = torch.full((B, m), -torch.inf, device=x1.device).scatter_reduce(
        1, j_star, bid, "amax", include_self=True)
    is_best = unass & (bid == max_bid.gather(1, j_star))
    bidders = torch.arange(n, device=x1.device).expand(B, n)
    winner = torch.full((B, m), n, device=x1.device).scatter_reduce(
        1, j_star, torch.where(is_best, bidders, n), "amin", include_self=True)
    has_winner = winner < n
    price = torch.where(has_winner, price + max_bid.clamp_min(0.0), price)
    # Evict the previous owner of each won object if it still owns it (an
    # owner's inverse entry is not cleared on eviction), then assign the
    # winners; writes to row n fall into a spare column.
    objects = torch.arange(m, device=x1.device).expand(B, m)
    prev = torch.where(has_winner, assignment_inv, -1)
    owns = assignment.gather(1, prev.clamp_min(0)) == objects
    spare = torch.cat([assignment, assignment.new_full((B, 1), -1)], 1)
    spare.scatter_(1, torch.where((prev >= 0) & owns, prev, n), -1)
    spare.scatter_(1, torch.where(has_winner, winner, n), objects)
    return spare[:, :n], torch.where(has_winner, winner, assignment_inv), price


def _emd_forward(xyz1: torch.Tensor, xyz2: torch.Tensor, eps: float, iters: int):
    x1, x2 = xyz1.float(), xyz2.float()
    B, n, _ = x1.shape
    m = x2.shape[1]
    chunk = _pick_chunk(m, B, n)
    assignment = torch.full((B, n), -1, dtype=torch.int64, device=x1.device)
    assignment_inv = torch.full((B, m), -1, dtype=torch.int64, device=x1.device)
    price = torch.zeros(B, m, device=x1.device)
    used = torch.zeros((), dtype=torch.int32, device=x1.device)
    n_unassigned = torch.tensor(B * n, device=x1.device)
    for it in range(1, iters + 1):
        used += (n_unassigned > 0).int()
        assignment, assignment_inv, price = _auction_iteration(
            assignment, assignment_inv, price, x1, x2, eps, chunk)
        n_unassigned = (assignment < 0).sum()
        check = it % _SYNC_EVERY == 0 or (it < _SYNC_EVERY and (it & (it - 1)) == 0)
        if check and int(n_unassigned) == 0:
            break
    matched = x2.gather(1, assignment.clamp_min(0)[..., None].expand(-1, -1, 3))
    sq = (x1 - matched) ** 2
    dist = torch.where(assignment >= 0, sq[..., 0] + sq[..., 1] + sq[..., 2], 0.0)
    return dist, assignment.int(), used


class _EarthMoverDistance(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xyz1, xyz2, eps, iters):
        dist, assignment, _ = _emd_forward(xyz1, xyz2, eps, iters)
        ctx.save_for_backward(xyz1, xyz2, assignment)
        ctx.mark_non_differentiable(assignment)
        return dist, assignment

    @staticmethod
    def backward(ctx, g, _g_assignment):
        xyz1, xyz2, assignment = ctx.saved_tensors
        matched = xyz2.float().gather(1, assignment.long().clamp_min(0)[..., None].expand(-1, -1, 3))
        grad1 = 2.0 * g[..., None] * (xyz1 - matched)
        return torch.where((assignment >= 0)[..., None], grad1, 0.0), None, None, None


def earth_mover_distance(xyz1: torch.Tensor, xyz2: torch.Tensor, eps: float = 0.005,
                         iters: int = 50):
    """Approximate EMD: (dist (B, n) squared matched distances, assignment
    (B, n) int32). Rows the auction leaves unassigned within ``iters`` get
    dist 0, which understates the EMD: check :func:`emd_unassigned`. The
    gradient, ``2·g·(xyz1 − xyz2[assignment])`` on assigned rows, goes to
    ``xyz1`` only."""
    return _EarthMoverDistance.apply(xyz1, xyz2, eps, iters)


def emd_unassigned(assignment: torch.Tensor) -> torch.Tensor:
    """(B,) int32 count of the points each sample left unassigned."""
    return (assignment < 0).sum(1).int()


@torch.no_grad()
def emd_convergence(xyz1: torch.Tensor, xyz2: torch.Tensor, eps: float = 0.002,
                    iters: int = 10000):
    """(dist, assignment, iters_used): ``iters_used`` (a 0-dim int32 tensor)
    is the iteration after which every point was assigned, or ``iters`` if
    the budget ran out first. No gradient."""
    return _emd_forward(xyz1, xyz2, eps, iters)
