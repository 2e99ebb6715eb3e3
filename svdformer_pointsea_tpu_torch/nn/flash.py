"""Attention over (B, L, h, dh) with the flash kernels K3, K4 and K5.

Counterpart of svdformer_pointsea_tpu/nn/flash_vjp.py. Every function takes
and returns the port's channels-last layout: q, o, dq (B, Lq, h, dh); k, v,
dk, dv (B, Lk, h, dh); the per-row softmax statistic ``lse`` and the backward
term ``di`` are (B, h, Lq) f32.

- :func:`flash_attention`: O only (kernel K3), for evaluation;
- :class:`FlashAttention`: the differentiable version for training. Its
  forward launches K3 with the row statistics (``lse``, the log-sum-exp of
  the scaled logits: upstream's ``m`` + log ``l``) and saves q, k, v (as the
  kernels take them), o and lse; its backward launches K5 (dQ) and K4 (dK,
  dV). In f32 all three run on the bf16 tensor cores with f32 accuracy:
  :func:`split_bf16x3` turns each of q, k, v (in the forward) and dO (in the
  backward) into three bf16 planes (hi, mid, lo) whose sum is the f32 value,
  and every product is the six products of their parts. The forward saves
  the planes of q, k and v, so the backward splits dO alone.

q, k and v are all f32 or all bf16. bf16 inputs (``--precision bf16``) take
the bf16 instances of the kernels, on the tensor cores, which compute what
the upstream Pallas kernels compute on bf16 inputs: f32 scores, softmax
statistics and accumulation, with P rounded to bf16 before P·V, Pᵀ before
dV, dS (after the scale) before dK and dQ, and O, dK, dV and dQ returned in
bf16; ``lse`` and ``di`` stay f32.

Each kernel has a plain PyTorch version beside it, written out from the same
formulas (not autograd): :func:`naive_attention`, :func:`attention_fwd_plain`,
:func:`attention_bwd_dkv_plain`, :func:`attention_bwd_dq_plain` (the f32
function itself, the split's products are a device detail),
:func:`split_bf16x3_plain` and the ``_bf16`` twins. A CPU tensor takes them; a
CUDA tensor launches the kernel or raises (``kernels.use_kernel``).
"""

from __future__ import annotations

import math

import torch

from svdformer_pointsea_tpu_torch import kernels

FLASH_HEAD_DIMS = (64, 96, 128, 256)
# Lq and Lk are multiples of the kernels' row tiles: 128 rows for K3 (f32 and
# bf16) and the bf16 K4 / K5, 64 for the f32 K4 / K5.
FLASH_BLOCK = {torch.float32: 128, torch.bfloat16: 128}
FLASH_BWD_BLOCK = {torch.float32: 64, torch.bfloat16: 128}


def naive_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q kᵀ / sqrt(dh)) v over (B, L, h, dh); the plain version of K3."""
    attn = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    return torch.einsum("bhqk,bkhd->bqhd", attn.softmax(dim=-1), v)


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """S = q kᵀ · scale, (B, h, Lq, Lk)."""
    return torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(q.shape[-1]))


def attention_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """(o, lse): the plain version of K3 with its row statistics."""
    s = _scores(q, k)
    lse = torch.logsumexp(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.exp(s - lse[..., None]), v)
    return o, lse


def _dscores(q, k, v, lse, do, di):
    """(P = exp(S − lse), dS = P ∘ (dO vᵀ − di)), both (B, h, Lq, Lk)."""
    p = torch.exp(_scores(q, k) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    return p, p * (dp - di[..., None])


def attention_bwd_dkv_plain(q, k, v, lse, do, di):
    """(dk, dv) from the forward's residuals: the plain version of K4."""
    p, ds = _dscores(q, k, v, lse, do, di)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q) * (1.0 / math.sqrt(q.shape[-1]))
    return dk, dv


def attention_bwd_dq_plain(q, k, v, lse, do, di):
    """dq from the forward's residuals: the plain version of K5."""
    _, ds = _dscores(q, k, v, lse, do, di)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k) * (1.0 / math.sqrt(q.shape[-1]))


_BF16 = torch.bfloat16


def split_bf16x3_plain(x: torch.Tensor) -> torch.Tensor:
    """(3, *x.shape) bf16 planes hi, mid, lo of an f32 tensor: hi = bf16(x),
    mid = bf16(x − hi), lo = bf16(x − hi − mid), each rounded to nearest even
    from an f32 difference, which is exact, so hi + mid + lo == x for normal x.
    The plain version of the split kernel."""
    hi = x.to(_BF16)
    rest = x - hi.float()
    mid = rest.to(_BF16)
    return torch.stack((hi, mid, (rest - mid.float()).to(_BF16)))


def split_bf16x3(x: torch.Tensor) -> torch.Tensor:
    """The split of :func:`split_bf16x3_plain`: the split kernel on a CUDA
    tensor (contiguous f32, a multiple of 8 values), its plain version on CPU."""
    if not kernels.use_kernel(x):
        return split_bf16x3_plain(x)
    kernels.check_cuda_input(x, "split_bf16x3", torch.float32, x.dim(), align=16)
    if x.numel() % 8:
        raise ValueError(f"split_bf16x3 takes a multiple of 8 values, got {x.numel()}")
    out = torch.empty((3, *x.shape), dtype=_BF16, device=x.device)
    kernels.launch("split_bf16x3", x.device, x.data_ptr(), out.data_ptr(), x.numel())
    return out


def attention_fwd_plain_bf16(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """(o bf16, lse f32) from bf16 q, k, v: the plain version of the bf16 K3.
    Scores, statistics and P·V in f32; P = exp(S − m) rounded to bf16 before
    P·V and normalised after it, as the upstream kernel does within one key
    block (the kernel rounds per key tile against the running max)."""
    s = _scores(q.float(), k.float())
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(_BF16).float(), v.float())
    return (o / l.transpose(1, 2)[..., None]).to(_BF16), m[..., 0] + torch.log(l)


def _dscores_bf16(q, k, v, lse, do, di):
    """(P, dS) in f32 from bf16 operands; dS = (dP − di) ∘ P · scale, the
    value the bf16 kernels round before dK and dQ."""
    p = torch.exp(_scores(q.float(), k.float()) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, (dp - di[..., None]) * p * (1.0 / math.sqrt(q.shape[-1]))


def attention_bwd_dkv_plain_bf16(q, k, v, lse, do, di):
    """(dk, dv) in bf16: the plain version of the bf16 K4 (Pᵀ and dSᵀ
    rounded to bf16 before their products)."""
    p, ds = _dscores_bf16(q, k, v, lse, do, di)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(_BF16).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(_BF16).float(), q.float())
    return dk.to(_BF16), dv.to(_BF16)


def attention_bwd_dq_plain_bf16(q, k, v, lse, do, di):
    """dq in bf16: the plain version of the bf16 K5 (dS rounded to bf16)."""
    _, ds = _dscores_bf16(q, k, v, lse, do, di)
    return torch.einsum("bhqk,bkhd->bqhd", ds.to(_BF16).float(), k.float()).to(_BF16)


def attention_di(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """di = rowsum(o ∘ do) in f32, (B, h, Lq): the backward's row term, which
    flash_vjp.py computes outside the kernels."""
    return (o.float() * do).sum(-1).transpose(1, 2).contiguous()  # do promoted to f32


def _plain_fwd(q, k, v):
    return attention_fwd_plain_bf16(q, k, v) if q.dtype == _BF16 else attention_fwd_plain(q, k, v)


def _plain_bwd(q, k, v, lse, do, di):
    if q.dtype == _BF16:
        dk, dv = attention_bwd_dkv_plain_bf16(q, k, v, lse, do, di)
        return attention_bwd_dq_plain_bf16(q, k, v, lse, do, di), dk, dv
    dk, dv = attention_bwd_dkv_plain(q, k, v, lse, do, di)
    return attention_bwd_dq_plain(q, k, v, lse, do, di), dk, dv


def _kernel_name(base: str, dtype: torch.dtype) -> str:
    return base + "_bf16" if dtype == _BF16 else base


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, name: str, blocks=FLASH_BLOCK):
    """(B, Lq, Lk, H, D) of kernel operands q, k, v, or a ValueError before any
    launch: one dtype of ``blocks``, contiguous CUDA tensors, lengths multiples
    of the dtype's row tile."""
    if q.dtype not in blocks:
        raise ValueError(f"{name}: expected torch.float32 or torch.bfloat16, got {q.dtype}")
    for t, arg in ((q, "q"), (k, "k"), (v, "v")):
        kernels.check_cuda_input(t, f"{name} {arg}", q.dtype, 4, align=16)  # 16-byte loads
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    if k.shape != (B, Lk, H, D) or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    block = blocks[q.dtype]
    if D not in FLASH_HEAD_DIMS or Lq % block or Lk % block or Lk == 0:
        raise ValueError(f"{name} takes dh in {FLASH_HEAD_DIMS} and lengths % {block} == 0, "
                         f"got dh {D}, Lq {Lq}, Lk {Lk}")
    return B, Lq, Lk, H, D


def _operands(*xs: torch.Tensor):
    """Checked operands as the kernels take them: f32 as their split planes
    (one split launch each), bf16 as they are."""
    if xs[0].dtype == torch.float32:
        return tuple(split_bf16x3(x) for x in xs)
    return xs


def _k3(name: str, dims, ops, dtype: torch.dtype, stats: bool):
    """One K3 launch on operands ``ops`` (see :func:`_operands`): (o, lse or None)."""
    B, Lq, Lk, H, D = dims
    out = torch.empty(B, Lq, H, D, dtype=dtype, device=ops[0].device)
    lse = torch.empty(B, H, Lq, dtype=torch.float32, device=out.device) if stats else None
    kernels.launch(name, out.device, *(t.data_ptr() for t in ops), out.data_ptr(),
                   None if lse is None else lse.data_ptr(), B, H, Lq, Lk, D, 1.0 / math.sqrt(D))
    return out, lse


def _flash_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, stats: bool = False):
    """K3 (f32 or bf16, by q's dtype): o, or (o, lse) with ``stats``. f32 q,
    k, v go to the kernel as their split planes, one split launch each."""
    name = _kernel_name("flash_attn_stats" if stats else "flash_attn", q.dtype)
    dims = _check(q, k, v, name)
    out, lse = _k3(name, dims, _operands(q, k, v), q.dtype, stats)
    return (out, lse) if stats else out


def _check_residuals(dims, dtype: torch.dtype, lse, do, di) -> None:
    """dO (in the operands' dtype), lse and di as K5 and K4 take them, or a
    ValueError before any launch."""
    B, Lq, _, H, D = dims
    for t, arg, shape, dt in ((do, "do", (B, Lq, H, D), dtype),
                              (lse, "lse", (B, H, Lq), torch.float32),
                              (di, "di", (B, H, Lq), torch.float32)):
        kernels.check_cuda_input(t, f"flash_attn_bwd {arg}", dt, len(shape), align=16)
        if t.shape != shape:
            raise ValueError(f"flash_attn_bwd {arg}: expected {tuple(shape)}, got {tuple(t.shape)}")


def _bwd_launch(dims, dtype: torch.dtype, ops, lse, do, di):
    """K5 then K4 on checked forward operands ``ops`` (see :func:`_operands`)
    and residuals: (dq, dk, dv). An f32 dO is split first, one launch."""
    B, Lq, Lk, H, D = dims
    dev = do.device
    dq = torch.empty(B, Lq, H, D, dtype=dtype, device=dev)
    dk, dv = (torch.empty(B, Lk, H, D, dtype=dtype, device=dev) for _ in range(2))
    names = [_kernel_name(base, dtype) for base in ("flash_attn_bwd_dq", "flash_attn_bwd_dkv")]
    ptrs = [t.data_ptr() for t in (*ops, lse, *_operands(do), di)]
    scale = 1.0 / math.sqrt(D)
    kernels.launch(names[0], dev, *ptrs, dq.data_ptr(), B, H, Lq, Lk, D, scale)
    kernels.launch(names[1], dev, *ptrs, dk.data_ptr(), dv.data_ptr(), B, H, Lq, Lk, D, scale)
    return dq, dk, dv


def _bwd_kernels(q, k, v, lse, do, di):
    """K5 then K4 (f32 or bf16, by q's dtype): (dq, dk, dv). f32 operands go
    to the kernels as their split planes, one split launch each."""
    dims = _check(q, k, v, "flash_attn_bwd", FLASH_BWD_BLOCK)
    _check_residuals(dims, q.dtype, lse, do, di)
    return _bwd_launch(dims, q.dtype, _operands(q, k, v), lse, do, di)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Attention over (B, L, h, dh), no gradient: K3 on CUDA, its plain
    version on CPU (the naive math for f32)."""
    if kernels.use_kernel(q):
        return _flash_kernel(q.contiguous(), k.contiguous(), v.contiguous())
    if q.dtype == _BF16:
        return attention_fwd_plain_bf16(q, k, v)[0]
    return naive_attention(q, k, v)


class FlashAttention(torch.autograd.Function):
    """Differentiable attention: K3 with statistics forward, K5 + K4 backward
    (the plain versions on CPU tensors). bf16 q, k, v give a bf16 O and bf16
    gradients; the cotangent arrives in O's dtype."""

    @staticmethod
    def forward(ctx, q, k, v):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        ctx.dims = None  # the plain path
        if kernels.use_kernel(q):
            name = _kernel_name("flash_attn_stats", q.dtype)
            ctx.dims, dtype = _check(q, k, v, name), q.dtype
            q, k, v = _operands(q, k, v)  # f32: the planes, which the backward reads too
            o, lse = _k3(name, ctx.dims, (q, k, v), dtype, stats=True)
        else:
            o, lse = _plain_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        di = attention_di(o, do)
        if ctx.dims is not None:  # the backward takes the path its forward took
            _check_residuals(ctx.dims, o.dtype, lse, do, di)
            return _bwd_launch(ctx.dims, o.dtype, (q, k, v), lse, do, di)
        return _plain_bwd(q, k, v, lse, do, di)


def flash_attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Differentiable attention over (B, L, h, dh) through :class:`FlashAttention`."""
    return FlashAttention.apply(q, k, v)
