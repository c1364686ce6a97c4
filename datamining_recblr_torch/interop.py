"""Parameter interchange with the JAX package.

The JAX ``init_params`` tree (nested dicts, lists for ``layers``) and
the port's ``state_dict`` hold the same arrays under the same names:
a state_dict key is the tree path joined by dots, a list index as its
decimal string (``layers.0.grl.w_in``).  Conversion changes only dtype
and device.  Arrays cross as NumPy, so this module needs no JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """JAX parameter pytree (NumPy or array-like leaves) -> state_dict of
    CPU tensors (``load_state_dict`` moves them to the model's device)."""
    out: dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            items = node.items()
        elif isinstance(node, (list, tuple)):
            items = ((str(i), v) for i, v in enumerate(node))
        else:
            out[prefix] = torch.from_numpy(np.array(node, copy=True))
            return
        for k, v in items:
            walk(v, f"{prefix}.{k}" if prefix else str(k))

    walk(tree, "")
    return out


def params_to_jax(state_dict) -> dict:
    """state_dict -> JAX parameter tree of NumPy arrays (levels whose
    keys are all decimal indices become lists)."""
    tree: dict = {}
    for key, value in state_dict.items():
        node = tree
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value.detach().cpu().numpy()

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(tree)
