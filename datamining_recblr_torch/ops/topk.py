"""Top-k over catalog scores (counterpart of
``datamining_recblr_tpu/ops/topk.py:topk_scores``).

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


def _order_keys(scores):
    """int32 keys whose order is the float32 total order of ``scores``."""
    bits = scores.float().contiguous().view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def topk_scores(scores, k: int):
    """scores [B, V] -> (values [B, k], item ids [B, k]), largest first;
    equal scores in increasing item id."""
    v = scores.shape[-1]
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
