"""Top-k ranking metrics for leave-one-out evaluation and score masking
(counterpart of ``datamining_recblr_tpu/eval/metrics.py``).

Metrics come from the *rank* of the single ground-truth item.  Ties
break as ``torch.topk(sorted=True)`` does, as RecBole uses it: among
equal scores the smaller item index ranks first.  With one relevant
item per user, Recall@k == Hit@k and MAP@k == MRR@k.
"""

from __future__ import annotations

import torch

from datamining_recblr_torch.parallel.collectives import all_reduce
from datamining_recblr_torch.parallel.mesh import MODEL_AXIS


def target_ranks(scores, targets, col0: int = 0, mesh=None):
    """1-based rank of ``targets[b]`` in descending ``scores[b]``:
    (# strictly greater) + (# equal with a smaller index) + 1.
    scores: [B, V] float; targets: [B] int.

    Written, as the JAX package's, as masked reductions over the item
    axis: on a ``mesh`` ``scores`` are this rank's columns [col0, col0 +
    V) of scores sharded over ``model``, and the target's score and the
    two counts are each summed over the model ranks, so the ranks equal
    the unsharded ones exactly, ties at a shard boundary included."""
    scores = scores.float()
    idx = col0 + torch.arange(scores.shape[-1], device=scores.device)[None, :]
    tgt = targets.long()[:, None]
    tgt_score = torch.where(idx == tgt, scores, torch.zeros((), device=scores.device)).sum(
        -1, keepdim=True)
    if mesh is not None:
        tgt_score = all_reduce(tgt_score, mesh, MODEL_AXIS)
    count = (scores > tgt_score).sum(-1) + ((scores == tgt_score) & (idx < tgt)).sum(-1)
    if mesh is not None:
        count = all_reduce(count, mesh, MODEL_AXIS)
    return count + 1


_METRIC_FNS = {
    "hit": lambda rank, k: (rank <= k).float(),
    "recall": lambda rank, k: (rank <= k).float(),
    "ndcg": lambda rank, k: torch.where(
        rank <= k, 1.0 / torch.log2(rank.float() + 1.0), torch.zeros((), device=rank.device)),
    "mrr": lambda rank, k: torch.where(
        rank <= k, 1.0 / rank.float(), torch.zeros((), device=rank.device)),
    "map": lambda rank, k: torch.where(
        rank <= k, 1.0 / rank.float(), torch.zeros((), device=rank.device)),
    "precision": lambda rank, k: (rank <= k).float() / k,
}


def rank_metrics(ranks, metrics, topk, weights=None):
    """{"<metric>@<k>": (weighted sum, weight sum)} from 1-based ranks,
    as fp32 scalar tensors: callers accumulate across batches and
    divide."""
    w = torch.ones(ranks.shape, device=ranks.device) if weights is None else weights.float()
    wsum = w.sum()
    out = {}
    for name in metrics:
        fn = _METRIC_FNS[name.lower()]
        for k in topk:
            out[f"{name}@{k}"] = ((fn(ranks, k) * w).sum(), wsum)
    return out


def mask_scores(scores, pad_value=float("-inf"), history=None, col0: int = 0):
    """Mask PAD item 0 and optionally a [B, V] boolean history mask (of the
    same columns); ``col0`` is the first column's global index."""
    idx = col0 + torch.arange(scores.shape[-1], device=scores.device)[None, :]
    fill = torch.full((), pad_value, dtype=scores.dtype, device=scores.device)
    scores = torch.where(idx == 0, fill, scores)
    if history is not None:
        scores = torch.where(history, fill, scores)
    return scores
