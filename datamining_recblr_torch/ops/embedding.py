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
V and D: ``embedding_grad`` (``csrc/emb_grad.cu``), a stable radix
sort of the ids followed by segment sums in a fixed order (in slices of
at most ``MAX_SLICE`` columns beyond that width), so the gradient has the
same bits from run to run.

The kernel's host-side plan (``sort_plan``: radix passes and digit
width; ``scratch_bytes``: its one scratch buffer) mirrors ``make_plan``
in the source; the kernel refuses a smaller buffer.

``embedding_grad`` on a CPU tensor computes its plain version
(``embedding_grad_plain``); on a CUDA tensor it launches its kernel or
raises.  ``launches`` on it counts its kernel launches.
"""

from __future__ import annotations

import functools

import torch

from datamining_recblr_torch.ops import _cuda

MAX_SLICE = 512  # columns the kernel's lanes sum at a time
MAX_DIGIT_BITS = 10  # the widest digit of a radix pass
SORT_TILE = 2048  # ids per block of the radix sort
PIECE = 32  # sorted entries per segment-sum piece
GROUP = 64  # pieces per group of a long segment


def sort_plan(v: int) -> tuple[int, int]:
    """(passes, digit width) of the kernel's radix sort of keys in [0, V]
    (ids outside [0, V) sort as V): the fewest passes of at most
    ``MAX_DIGIT_BITS`` bits, the bits shared out evenly."""
    bits = int(v).bit_length()
    passes = -(-bits // MAX_DIGIT_BITS)
    return passes, -(-bits // passes)


@functools.lru_cache(maxsize=64)
def scratch_bytes(n: int, v: int, d: int) -> int:
    """Bytes of the kernel's scratch for N ids, V rows and D columns: the
    sorted keys and values twice, the radix counts and totals of each
    pass, the per-tile counts of ids outside [0, V) and their total, each
    id's segment start and end; then, 16-byte aligned, the fp32 partial
    rows of one slice of columns: each piece's first and last run, each
    group's two sums."""
    passes, width = sort_plan(v)
    tiles = -(-n // SORT_TILE)
    pieces = -(-n // PIECE)
    groups = -(-pieces // GROUP)
    ints = 4 * n + passes * (1 << width) * (tiles + 1) + tiles + 1 + 2 * v
    ints = -(-ints // 4) * 4
    return 4 * (ints + (2 * pieces + 2 * groups) * min(d, MAX_SLICE))


def embedding_grad_plain(ids, g, v: int):
    """Plain PyTorch version of ``embedding_grad``: [V, D] fp32, row v the
    sum of the rows of ``g`` [..., D] whose id in ``ids`` [...] is v."""
    d = g.shape[-1]
    out = torch.zeros((int(v), d), device=g.device, dtype=torch.float32)
    return out.index_add_(0, ids.reshape(-1).long(), g.reshape(-1, d).float())


def embedding_grad(ids, g, v: int):
    """[V, D] fp32 table gradient of ``ids`` [...] (in [0, V)) and their
    cotangent rows ``g`` [..., D] (fp32 or bf16, any D >= 1), each row's
    sum in a fixed order."""
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
    if d < 1 or v < 1:
        raise ValueError(f"unsupported shape V={v} D={d}: the kernel takes V >= 1, D >= 1")
    flat_ids = ids.reshape(-1).contiguous()
    flat_g = g.reshape(-1, d).contiguous()
    n = flat_ids.numel()
    if n == 0:
        return torch.zeros((v, d), device=g.device, dtype=torch.float32)
    if n >= 2**31 - SORT_TILE:
        raise ValueError(f"{n} ids: the kernel takes fewer than 2^31 - {SORT_TILE}")
    nbytes = scratch_bytes(n, v, d)
    scratch = torch.empty((nbytes // 4,), device=g.device, dtype=torch.int32)
    out = torch.empty((v, d), device=g.device, dtype=torch.float32)
    lib = _cuda.library("emb_grad.cu")
    # the library selects the card itself and takes PyTorch's stream on it
    err = lib.recblr_emb_grad(
        flat_ids.data_ptr(), int(flat_ids.dtype == torch.int64), flat_g.data_ptr(),
        int(g.dtype == torch.bfloat16), out.data_ptr(), scratch.data_ptr(), nbytes, n, v, d,
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
