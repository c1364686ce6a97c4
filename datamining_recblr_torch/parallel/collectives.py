"""The collectives of a meshed step, written out (JAX has no module for
them: GSPMD inserts them from the shardings).

* ``copy_to_model``: the identity forward, a sum over ``model``
  backward.  The tower's output enters the vocab-parallel scoring
  through it: each model rank scores its slice of the catalog, so the
  output's gradient is the sum of the ranks' parts.
* ``reduce_from_model``: a sum over ``model`` forward, the identity
  backward.  A lookup from a row-sharded table leaves through it: each
  rank contributes the rows it holds and zeros elsewhere.
* ``gather_from_model``: the model ranks' rows concatenated forward, a
  sum over ``model`` and this rank's rows backward (a small sharded
  vector that every rank reads at other rows: BERT4Rec's output bias
  where its shards are not the table's).
* ``gather_over_seq``: the seq ranks' slices concatenated in seq order
  along one dim forward, a sum over ``seq`` (in fp32) and this rank's
  slice backward (the scan's (last state, product of gates) pairs,
  ``ops/seq_parallel_scan.py``, along dim 0; the attention models' K and V
  along their time axis, ``models/layers.py``).
* ``conv_halo``: the K-1 positions before this rank's time chunk,
  gathered from the earlier seq ranks (zeros before position 0); the
  backward sends each position's gradient to the rank that holds it.
* ``select_over_seq``: each row at one or several global time positions,
  read on the seq rank that holds each and summed over ``seq`` forward, a
  sum over ``seq`` backward.
* ``all_reduce_grads``: the gradient sum over ``data`` (and ``seq``):
  one all-reduce of the flattened gradients per dtype and axis.
* ``all_reduce`` / ``all_gather``: the plain collectives over one axis,
  outside autograd.

Every collective takes part on every rank in the same order, as the
ranks of one model group run the same tower on the same rows, and the
ranks of one seq group the same layers on their chunks of those rows.

Under ``seq`` everything after the top layer's selection (its tail, the
head and the loss) is the same on every seq rank.  Each of them takes
1/S of the loss (``models/base.py:weighted_mean``), so the backward of
``select_over_seq`` sums the S shares into the whole cotangent, and the
sum of the gradients over ``seq`` counts the replicated part once.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from datamining_recblr_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, SEQ_AXIS

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(t, mesh, axis: str, op: str = "sum"):
    """A reduced copy of ``t`` over the ranks of ``axis`` (``t`` itself
    when the mesh lacks the axis)."""
    group = mesh.group(axis)
    if group is None:
        return t
    out = t.detach().clone().contiguous()
    dist.all_reduce(out, op=_OPS[op], group=group)
    return out


def all_gather(t, mesh, axis: str, dim: int = 0):
    """The ranks' ``t`` of ``axis`` concatenated along ``dim`` in their
    index order, bit for bit."""
    group = mesh.group(axis)
    if group is None:
        return t
    t = t.detach().contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.size(axis))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, MODEL_AXIS), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x, mesh, MODEL_AXIS)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.rows = mesh, x.shape[0]
        return all_gather(x, mesh, MODEL_AXIS)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.mesh.index(MODEL_AXIS) * ctx.rows
        return all_reduce(g, ctx.mesh, MODEL_AXIS)[lo : lo + ctx.rows], None


def copy_to_model(x, mesh):
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x, mesh):
    return _ReduceFromModel.apply(x, mesh)


def gather_from_model(x, mesh):
    return _GatherFromModel.apply(x, mesh)


class _GatherOverSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim, ctx.rows = mesh, axis, dim, x.shape[dim]
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.mesh.index(ctx.axis) * ctx.rows
        full = all_reduce(g.float(), ctx.mesh, ctx.axis).to(g.dtype)
        return full.narrow(ctx.dim, lo, ctx.rows), None, None, None


class _ConvHalo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tail, k, mesh):
        # tail [B, n, C]: this rank's last n = min(K-1, T/S) positions; the
        # earlier ranks' tails, in order, end at this rank's first position
        # and run contiguously over the K-1 positions before it
        s, n = mesh.index(SEQ_AXIS), tail.shape[1]
        ctx.mesh, ctx.k, ctx.n = mesh, k, n
        before = all_gather(tail, mesh, SEQ_AXIS, dim=1)[:, : s * n]
        halo = before[:, max(0, s * n - (k - 1)):]
        return F.pad(halo, (0, 0, k - 1 - halo.shape[1], 0))

    @staticmethod
    def backward(ctx, g):
        mesh, k, n = ctx.mesh, ctx.k, ctx.n
        s = mesh.index(SEQ_AXIS)
        full = g.new_zeros((g.shape[0], mesh.size(SEQ_AXIS) * n, g.shape[2]),
                           dtype=torch.float32)
        used = min(s * n, k - 1)
        if used:
            full[:, s * n - used : s * n] = g[:, k - 1 - used:]
        full = all_reduce(full, mesh, SEQ_AXIS)
        return full[:, s * n : (s + 1) * n].to(g.dtype), None, None


class _SumOverSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_reduce(x, mesh, SEQ_AXIS)

    @staticmethod
    def backward(ctx, g):
        # the S seq ranks' shares of the cotangent, summed in fp32
        return all_reduce(g.float(), ctx.mesh, SEQ_AXIS).to(g.dtype), None


def gather_over_seq(x, mesh, axis: str = SEQ_AXIS, dim: int = 0):
    """The seq ranks' ``x`` concatenated in seq order along ``dim``: [n, ...]
    -> [S n, ...] at dim 0."""
    return _GatherOverSeq.apply(x, mesh, axis, dim)


def conv_halo(xb, k: int, mesh):
    """The left context of a causal conv of width ``k`` over a time axis
    sharded over ``seq``: ``xb`` [B, T/S, C] is this rank's chunk; returns
    the K-1 positions before it [B, K-1, C], zeros before position 0.
    Built from each rank's last min(K-1, T/S) positions, so it also holds
    where the halo spans several chunks (T/S < K-1)."""
    n = min(k - 1, xb.shape[1])
    if n <= 0:
        return xb[:, :0]
    return _ConvHalo.apply(xb[:, xb.shape[1] - n:], k, mesh)


def select_over_seq(v, idx, mesh):
    """Row b of ``v`` at the global time positions ``idx[b]``: ``v`` [B, T/S,
    ...] this rank's chunk of a time axis sharded over ``seq``, ``idx`` [B]
    -> [B, ...] or [B, S'] -> [B, S', ...] (BERT4Rec's cloze positions,
    spread over the chunks), the same on every seq rank.  The rank
    holding a position reads it, the others give zeros, and the sum over
    ``seq`` puts the rows together; the backward sums the cotangent over
    ``seq`` (the ranks' 1/S shares of the loss, see above)."""
    tc = v.shape[1]
    local = idx.long() - mesh.index(SEQ_AXIS) * tc
    own = (local >= 0) & (local < tc)
    rows_b = torch.arange(v.shape[0], device=v.device).view(-1, *[1] * (idx.dim() - 1))
    rows = v[rows_b, torch.where(own, local, torch.zeros_like(local))]
    own = own.view(*own.shape, *[1] * (rows.dim() - own.dim()))
    rows = torch.where(own, rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
    return _SumOverSeq.apply(rows, mesh)


def all_reduce_grads(params, mesh, axes=(DATA_AXIS,)):
    """Sum each parameter's gradient over each axis of ``axes`` in place
    (an axis the mesh lacks is skipped)."""
    groups = [g for g in (mesh.group(a) for a in axes) if g is not None]
    if not groups:
        return
    by_dtype: dict[torch.dtype, list] = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = _flatten_dense_tensors(grads)
        for group in groups:
            dist.all_reduce(flat, group=group)
        for g, r in zip(grads, _unflatten_dense_tensors(flat, grads)):
            g.copy_(r)
