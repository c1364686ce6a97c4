"""Optimizer construction (counterpart of
``datamining_recblr_tpu/train/optim.py``, which builds optax
transformations).  Each learner takes the update its optax counterpart
makes:

* "adam": ``torch.optim.Adam`` with eps 1e-8; ``weight_decay`` is L2 added
  to the gradient before the moment updates (``add_decayed_weights``
  chained before ``scale_by_adam``), not decoupled;
* "adamw": ``optax.adamw(lr, weight_decay=wd)``, decoupled decay, which is
  ``torch.optim.AdamW`` with the same eps and decay;
* "sgd": ``optax.sgd(lr)``, plain SGD without momentum;
* "adagrad": ``optax.adagrad(lr)``: the accumulator starts at 0.1 and the
  step is g / sqrt(sum g^2 + 1e-7) (eps inside the root, 0 where the sum
  is 0), which ``torch.optim.Adagrad`` does not compute (eps outside);
* "rmsprop": ``optax.rmsprop(lr)``: decay 0.9, the second moment starts
  at 0 and the step is g / sqrt(nu + 1e-8) (eps inside the root), where
  ``torch.optim.RMSprop`` has alpha 0.99 and eps outside.

The JAX package applies no weight decay outside "adam" and "adamw", and
neither does the port.
"""

from __future__ import annotations

import torch


class _RootScaled(torch.optim.Optimizer):
    """p -= lr * g / sqrt(acc + eps), acc updated from g first: optax's
    ``scale_by_rss`` (adagrad: acc += g^2, starting at ``initial``, the
    step 0 where acc is 0) or ``scale_by_rms`` (rmsprop: acc = decay acc
    + (1 - decay) g^2)."""

    def __init__(self, params, lr, eps, initial, decay=None):
        super().__init__(params, dict(lr=lr, eps=eps, initial=initial, decay=decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr, eps, decay = group["lr"], group["eps"], group["decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if "acc" not in state:
                    state["acc"] = torch.full_like(p, group["initial"])
                acc = state["acc"]
                if decay is None:
                    acc.add_(g * g)
                    scale = torch.where(acc > 0, torch.rsqrt(acc + eps), torch.zeros_like(acc))
                else:
                    acc.mul_(decay).add_((1.0 - decay) * (g * g))
                    scale = torch.rsqrt(acc + eps)
                p.sub_(lr * (scale * g))
        return loss


def build_optimizer(config, params) -> torch.optim.Optimizer:
    learner = str(config.get("learner", "adam")).lower()
    lr = float(config["learning_rate"])
    wd = float(config.get("weight_decay", 0.0) or 0.0)
    if learner == "adam":
        return torch.optim.Adam(params, lr=lr, eps=1e-8, weight_decay=wd)
    if learner == "adamw":
        return torch.optim.AdamW(params, lr=lr, eps=1e-8, weight_decay=wd)
    if learner == "sgd":
        return torch.optim.SGD(params, lr=lr)
    if learner == "adagrad":
        return _RootScaled(params, lr, eps=1e-7, initial=0.1)
    if learner == "rmsprop":
        return _RootScaled(params, lr, eps=1e-8, initial=0.0, decay=0.9)
    raise ValueError(f"unknown learner {learner!r}")
