"""Top-k over catalog scores (counterpart of
``datamining_recblr_tpu/ops/topk.py:topk_scores``)."""

from __future__ import annotations

import torch


def topk_scores(scores, k: int):
    """Returns (values [B, k], item ids [B, k]), largest first."""
    return torch.topk(scores, k, dim=-1)
