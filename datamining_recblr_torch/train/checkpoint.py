"""Checkpoints of the port, written with ``torch.save`` (counterpart of
``datamining_recblr_tpu/train/checkpoint.py``): the parameters'
state_dict and, from the trainer, the optimizer state, the epoch and
the best score, as the JAX trainer's ``_checkpoint_state``.
``restore_checkpoint`` also reads what the JAX package writes, its
pickle and its orbax directory (``train/jax_checkpoint.py``): the
parameters as a state dict, the optimizer state as optax's tree
(``train.optim.opt_state_from_jax`` maps it)."""

from __future__ import annotations

import os

import torch

from datamining_recblr_torch.train.jax_checkpoint import jax_checkpoint_file, read_jax_checkpoint


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def checkpoint_file(path: str) -> str:
    """The file ``save_checkpoint(path, ...)`` writes: ``path`` + ``.pt``,
    absolute."""
    path = os.path.abspath(path)
    return path if path.endswith(".pt") else path + ".pt"


def save_checkpoint(path: str, state: dict) -> str:
    """Save ``{"params": state_dict, "epoch": int, ...}`` (tensors moved
    to the CPU); returns the path written (``path`` + ``.pt``)."""
    out = checkpoint_file(path)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    torch.save(_to_cpu(state), out)
    return out


def restore_checkpoint(path: str) -> dict:
    """Load a checkpoint onto the CPU: the port's ``.pt`` (``path`` or
    ``path`` + ``.pt``) where it exists, else the JAX package's, tried in
    its order (a ``.pkl``, then a ``.orbax`` directory)."""
    p = path if path.endswith(".pt") else path + ".pt"
    if os.path.isfile(p) or jax_checkpoint_file(path) is None:
        return torch.load(p, map_location="cpu", weights_only=True)
    return read_jax_checkpoint(path)
