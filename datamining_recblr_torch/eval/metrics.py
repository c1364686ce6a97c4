"""Score masking for full-catalog ranking (counterpart of
``datamining_recblr_tpu/eval/metrics.py:mask_scores``)."""

from __future__ import annotations

import torch


def mask_scores(scores, pad_value=float("-inf"), history=None):
    """Mask PAD item 0 and optionally a [B, V] boolean history mask."""
    idx = torch.arange(scores.shape[-1], device=scores.device)[None, :]
    fill = torch.full((), pad_value, dtype=scores.dtype, device=scores.device)
    scores = torch.where(idx == 0, fill, scores)
    if history is not None:
        scores = torch.where(history, fill, scores)
    return scores
