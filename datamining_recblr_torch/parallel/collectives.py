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
* ``all_reduce_grads``: the gradient sum over ``data`` (one all-reduce
  of the flattened gradients per dtype).
* ``all_reduce`` / ``all_gather``: the plain collectives over one axis,
  outside autograd.

Every collective takes part on every rank in the same order, as the
ranks of one model group run the same tower on the same rows.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from datamining_recblr_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS

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


def all_reduce_grads(params, mesh, axis: str = DATA_AXIS):
    """Sum each parameter's gradient over ``axis`` in place."""
    group = mesh.group(axis)
    if group is None:
        return
    by_dtype: dict[torch.dtype, list] = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = _flatten_dense_tensors(grads)
        dist.all_reduce(flat, group=group)
        for g, r in zip(grads, _unflatten_dense_tensors(flat, grads)):
            g.copy_(r)
