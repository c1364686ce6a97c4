"""Embedding lookup whose backward sums the table gradient in fp32: a
hand-written CUDA kernel for Hopper beside its plain PyTorch version.

Counterpart of ``datamining_recblr_tpu/ops/embedding.py``:
``embedding_lookup(table, ids)`` gathers from a bf16 copy of the table
(``:39-59``, which rounds exactly as casting after the gather) and its
VJP returns the fp32 sum of the cotangent rows of each id, cast to the
table's dtype (``:171-180``).  The JAX package computes that sum three
ways: one-hot matmuls below ``_SCATTER_MIN_V`` = 9,000 rows, a scatter-add
from there on, and the Pallas kernel ``_emb_grad_kernel`` (via
``_bwd_pallas`` :85), kept for the record.  Here one kernel serves every
V: ``embedding_grad`` (``csrc/emb_grad.cu``), a stable counting sort of
the ids followed by segment sums in a fixed order, so the gradient has
the same bits from run to run.

``embedding_grad`` on a CPU tensor computes its plain version
(``embedding_grad_plain``); on a CUDA tensor it launches its kernel or
raises.  ``launches`` on it counts its kernel launches.
"""

from __future__ import annotations

import torch

from datamining_recblr_torch.ops import _cuda

MAX_D = 512  # the kernel's lanes hold rows of up to 512 floats
_SORT_BLOCK = 2048  # ids per block of the kernel's radix sort
_PIECE = 128  # sorted entries per segment-sum piece


def embedding_grad_plain(ids, g, v: int):
    """Plain PyTorch version of ``embedding_grad``: [V, D] fp32, row v the
    sum of the rows of ``g`` [..., D] whose id in ``ids`` [...] is v."""
    d = g.shape[-1]
    out = torch.zeros((int(v), d), device=g.device, dtype=torch.float32)
    return out.index_add_(0, ids.reshape(-1).long(), g.reshape(-1, d).float())


def embedding_grad(ids, g, v: int):
    """[V, D] fp32 table gradient of ``ids`` [...] (in [0, V)) and their
    cotangent rows ``g`` [..., D] (fp32 or bf16, D <= 512), each row's sum
    in a fixed order."""
    if g.device.type == "cpu":
        return embedding_grad_plain(ids, g, v)
    _cuda.require_cuda(g)
    v = int(v)
    d = g.shape[-1]
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"g must be float32 or bfloat16, got {g.dtype}")
    if tuple(g.shape[:-1]) != tuple(ids.shape) or ids.device != g.device:
        raise ValueError(f"ids {tuple(ids.shape)} and g {tuple(g.shape)} must match up to D "
                         "and lie on one card")
    if ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"ids must be an integer tensor, got {ids.dtype}")
    if not 1 <= d <= MAX_D or v < 1:
        raise ValueError(f"unsupported shape V={v} D={d}: the kernel takes V >= 1, "
                         f"1 <= D <= {MAX_D}")
    flat_ids = ids.reshape(-1).to(torch.int32).contiguous()
    flat_g = g.reshape(-1, d).contiguous()
    n = flat_ids.numel()
    if n == 0:
        return torch.zeros((v, d), device=g.device, dtype=torch.float32)
    if n >= 2**31:
        raise ValueError(f"{n} ids: the kernel takes fewer than 2^31")
    kw = dict(device=g.device, dtype=torch.int32)
    sort = torch.empty((4, n), **kw)
    hist = torch.empty((256 * -(-n // _SORT_BLOCK),), **kw)
    seg = torch.empty((v + 1,), **kw)
    part = torch.empty((2, -(-n // _PIECE), d), device=g.device, dtype=torch.float32)
    out = torch.empty((v, d), device=g.device, dtype=torch.float32)
    lib = _cuda.library("emb_grad.cu")
    with torch.cuda.device(g.device):
        err = lib.recblr_emb_grad(
            flat_ids.data_ptr(), flat_g.data_ptr(), out.data_ptr(), sort[0].data_ptr(),
            sort[1].data_ptr(), sort[2].data_ptr(), sort[3].data_ptr(), hist.data_ptr(),
            seg.data_ptr(), part.data_ptr(), n, v, d, int(g.dtype == torch.bfloat16),
            g.device.index, _cuda.stream(g),
        )
    _cuda.check(lib, err, "embedding_grad")
    embedding_grad.launches += 1
    return out


embedding_grad.launches = 0


class _Lookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.rows, ctx.dtype = table.shape[0], table.dtype
        return table.to(torch.bfloat16)[ids]

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return embedding_grad(ids, g, ctx.rows).to(ctx.dtype), None


def embedding_lookup(table, ids):
    """``table [V, D]`` rows of ``ids`` [...] in bf16, differentiable in
    the table: its gradient is the fp32 ``embedding_grad`` of the
    cotangent, cast to the table's dtype."""
    return _Lookup.apply(table, ids)
