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

``opt_state_from_jax`` maps the optax state of a JAX checkpoint
(``train/jax_checkpoint.py``) onto these optimizers.
"""

from __future__ import annotations

import torch

from datamining_recblr_torch.interop import params_from_jax


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


# the fields of each learner's optax state (scale_by_adam, scale_by_rss,
# scale_by_rms) and the torch state entries they fill
OPTAX_FIELDS = {"adam": ("count", "mu", "nu"), "adagrad": ("sum_of_squares",),
                "rmsprop": ("nu",)}
TORCH_ENTRIES = {"adam": {"exp_avg": "mu", "exp_avg_sq": "nu"},
                 "adagrad": {"acc": "sum_of_squares"}, "rmsprop": {"acc": "nu"}}


def _optax_states(tree):
    """[(learner, state)] of the optax states (dicts of exactly a
    learner's fields, as a JAX checkpoint's reader gives them) in
    ``tree``."""
    if isinstance(tree, dict):
        for learner, fields in OPTAX_FIELDS.items():
            if set(tree) == set(fields):
                return [(learner, tree)]
        return [s for v in tree.values() for s in _optax_states(v)]
    if isinstance(tree, list):
        return [s for v in tree for s in _optax_states(v)]
    return []


def is_torch_state(opt_state) -> bool:
    """Whether ``opt_state`` is a torch optimizer's state dict (else the
    optax tree of a JAX checkpoint)."""
    return isinstance(opt_state, dict) and "param_groups" in opt_state


def _learner(optimizer) -> str:
    if isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW)):
        return "adam"
    if isinstance(optimizer, _RootScaled):
        return "adagrad" if optimizer.param_groups[0]["decay"] is None else "rmsprop"
    if isinstance(optimizer, torch.optim.SGD):
        return "sgd"
    raise TypeError(f"no optax state maps onto {type(optimizer).__name__}")


def opt_state_from_jax(model, optimizer, opt_state) -> dict:
    """The state dict for ``optimizer.load_state_dict`` (``optimizer``
    built by ``build_optimizer`` over ``model.parameters()``) of a JAX
    checkpoint's optax state, found by its fields wherever the chain
    holds it (``weight_decay`` moves its index), matched to the
    parameters by name:

    * adam, adamw: ``ScaleByAdamState`` -> ``step`` (optax's ``count``:
      both count a step before its update uses the count), ``exp_avg``
      (``mu``), ``exp_avg_sq`` (``nu``);
    * adagrad: ``ScaleByRssState.sum_of_squares`` -> ``acc``; rmsprop:
      ``ScaleByRmsState.nu`` -> ``acc``;
    * sgd: no state.

    Vocab-leading rows stay as the JAX run padded them
    (``parallel.sharding.shard_optimizer_state`` fits them)."""
    learner = _learner(optimizer)
    found = _optax_states(opt_state)
    want = [] if learner == "sgd" else [learner]
    if [k for k, _ in found] != want:
        raise ValueError(f"the checkpoint's optimizer states {[k for k, _ in found]} are not "
                         f"those of {learner} ({want})")
    out = {"state": {}, "param_groups": optimizer.state_dict()["param_groups"]}
    if not found:
        return out
    state = found[0][1]
    entries = TORCH_ENTRIES[learner]
    trees = {k: params_from_jax(state[f]) for k, f in entries.items()}
    for i, (name, _) in enumerate(model.named_parameters()):
        entry = {}
        if "count" in state:
            entry["step"] = torch.tensor(float(state["count"]), dtype=torch.float32)
        for k, tree in trees.items():
            if name not in tree:
                raise ValueError(f"the checkpoint's optimizer state has no {entries[k]} of "
                                 f"{name}")
            entry[k] = tree[name]
        out["state"][i] = entry
    return out
