"""Checkpoints of the port: the parameters' state_dict plus the epoch,
written with ``torch.save`` (counterpart of
``datamining_recblr_tpu/train/checkpoint.py``; reading the JAX
package's orbax checkpoints is not ported yet)."""

from __future__ import annotations

import os

import torch


def save_checkpoint(path: str, state: dict) -> str:
    """Save ``{"params": state_dict, "epoch": int, ...}``; returns the
    path written (``path`` + ``.pt``)."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    out = path if path.endswith(".pt") else path + ".pt"
    params = {k: v.detach().cpu() for k, v in state["params"].items()}
    torch.save(dict(state, params=params), out)
    return out


def restore_checkpoint(path: str) -> dict:
    """Load a checkpoint written by ``save_checkpoint``, onto the CPU."""
    p = path if path.endswith(".pt") else path + ".pt"
    return torch.load(p, map_location="cpu", weights_only=True)
