"""Scatter-adds, and the row gather whose backward is one, that add in a
fixed order on CUDA.

On CUDA, ``index_add_`` and the backward of ``gather`` (an atomic
``scatter_add_``) add the terms that meet in one row in no fixed order, so
two runs of one input can differ in the last bits of such a row. A CUDA
scatter-add here is ``index_put_`` with ``accumulate=True``, which sorts the
flat indices stably and sums each run of equal indices in the sorted order,
with no atomics: every run gives the same bits. It is called as autograd's
indexing backward calls it, without the range check, whose ``.item()`` on
the indices' max and min would make the host wait for the device at each
call; every caller builds its indices in range. That private call was
checked on torch 2.11.0+cu128; ``tests/test_torch_kernels.py`` holds it
against ``index_add_`` on the card, so that a torch whose op differs fails
there. CPU tensors keep ``index_add_`` and ``gather``'s own backward.
"""

from __future__ import annotations

import torch


def _fixed_order(x: torch.Tensor) -> bool:
    """Whether ``x``'s scatters take the sorted path (CUDA tensors)."""
    return x.device.type == "cuda"


def scatter_add_rows(n_rows: int, idx: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Zeros of shape (n_rows, *values.shape[1:]) with ``values[i]`` added at
    row ``idx[i]`` ((L,) int64 indices, (L, ...) values)."""
    out = values.new_zeros((n_rows,) + tuple(values.shape[1:]))
    if _fixed_order(values):
        return torch.ops.aten._index_put_impl_(out, [idx], values, True, True)
    return out.index_add_(0, idx, values)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(idx)
        ctx.n = points.shape[1]
        return points.gather(1, idx[:, :, None].expand(-1, -1, points.shape[-1]))

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (idx,) = ctx.saved_tensors
        B, M, C = g.shape
        flat = (idx + torch.arange(B, device=idx.device)[:, None] * ctx.n).reshape(-1)
        return scatter_add_rows(B * ctx.n, flat, g.reshape(B * M, C)).reshape(B, ctx.n, C), None


def gather_rows(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) rows at (B, M) indices -> (B, M, C); on CUDA the backward
    adds repeated indices with :func:`scatter_add_rows`."""
    idx = idx.long()
    if _fixed_order(points) and points.requires_grad and torch.is_grad_enabled():
        return _GatherRows.apply(points, idx)
    return points.gather(1, idx[:, :, None].expand(-1, -1, points.shape[-1]))
