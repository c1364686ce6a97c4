"""Top-k over catalog scores (counterpart of
``datamining_recblr_tpu/ops/topk.py``: ``topk_scores``, and
``sharded_topk`` for scores sharded over the mesh's ``model`` axis).

``jax.lax.top_k`` orders by the float total order (NaN above +inf, +0
above -0) and puts the lower index first among equal values; so does
``topk_scores``.  ``torch.topk`` makes no promise on ties, so it takes
more than k candidates, which are then sorted by (total-order key
descending, index ascending).  A row whose k-th candidate still ties with
its last one (a run of equal scores longer than the candidates, e.g. -inf
for a catalog mostly masked out) takes a stable sort of the whole row
instead.
"""

from __future__ import annotations

import torch

from datamining_recblr_torch.parallel.collectives import all_gather
from datamining_recblr_torch.parallel.mesh import MODEL_AXIS


def _order_keys(scores):
    """int32 keys whose order is the float32 total order of ``scores``."""
    bits = scores.float().contiguous().view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def topk_scores(scores, k: int):
    """scores [B, V] -> (values [B, k], item ids [B, k]), largest first;
    equal scores in increasing item id (k at most V)."""
    v = scores.shape[-1]
    if v == 0:
        return scores, torch.zeros(scores.shape, dtype=torch.int64, device=scores.device)
    kk = min(v, 2 * k)
    cand, ids = torch.topk(scores, kk, dim=-1)
    ids, perm = ids.sort(dim=-1)
    keys, perm = _order_keys(cand.gather(-1, perm)).sort(dim=-1, descending=True, stable=True)
    ids = ids.gather(-1, perm)[:, :k]
    if kk < v:
        # every score equal to the k-th is a candidate unless the last one ties with it
        tied = (cand[:, kk - 1] == cand[:, k - 1]) | cand[:, kk - 1].isnan()
        if bool(tied.any()):
            rows = tied.nonzero().squeeze(1)
            full = _order_keys(scores[rows]).sort(dim=-1, descending=True, stable=True)
            ids = ids.index_copy(0, rows, full.indices[:, :k])
    return scores.gather(-1, ids), ids


def sharded_topk(scores, k: int, mesh, col0: int):
    """Top-k of scores sharded over ``model``: ``scores`` [B, V_local] are
    this rank's columns [col0, col0 + V_local).  Each rank takes its own
    top-k in C6's order and offsets the ids to global items; the model
    ranks' candidates are gathered bit for bit and merged by (total-order
    key descending, item id ascending), so the result is ``topk_scores``
    of the whole row, shard boundaries included.  Returns (values, ids)
    [B, k] on every rank."""
    vals, ids = topk_scores(scores, min(k, scores.shape[-1]))
    ids = ids + col0
    short = k - vals.shape[-1]
    if short:  # a rank with fewer than k columns: -inf after every item id
        vals = torch.cat([vals, vals.new_full((vals.shape[0], short), float("-inf"))], 1)
        ids = torch.cat([ids, ids.new_full((ids.shape[0], short), 2**62)], 1)
    all_vals = all_gather(vals.float().contiguous().view(torch.int32), mesh, MODEL_AXIS, 1)
    all_ids = all_gather(ids, mesh, MODEL_AXIS, 1)
    all_ids, perm = all_ids.sort(dim=-1)
    all_vals = all_vals.contiguous().view(torch.float32).gather(-1, perm)
    order = _order_keys(all_vals).sort(dim=-1, descending=True, stable=True).indices[:, :k]
    return all_vals.gather(-1, order), all_ids.gather(-1, order)
