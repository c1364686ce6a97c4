"""Optimizer construction (counterpart of
``datamining_recblr_tpu/train/optim.py``).

"adam" is ``torch.optim.Adam`` with eps 1e-8: its ``weight_decay`` is
L2 added to the gradient before the moment updates, the JAX package's
``add_decayed_weights`` chained before ``scale_by_adam`` (not decoupled
AdamW).  The other learners of the JAX package are not ported yet."""

from __future__ import annotations

import torch


def build_optimizer(config, params) -> torch.optim.Optimizer:
    learner = str(config.get("learner", "adam")).lower()
    lr = float(config["learning_rate"])
    wd = float(config.get("weight_decay", 0.0) or 0.0)
    if learner == "adam":
        return torch.optim.Adam(params, lr=lr, eps=1e-8, weight_decay=wd)
    raise NotImplementedError(f"learner {learner!r} is not ported; adam is")
