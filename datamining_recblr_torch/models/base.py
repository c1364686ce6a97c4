"""Sequential-recommender model contract (counterpart of
``datamining_recblr_tpu/models/base.py``): ``forward(item_seq,
item_seq_len) -> [B, H]``, the item embedding lookup, the vocab-padding
rule and full-catalog scoring, as an ``nn.Module`` that holds its
parameters under the JAX parameter tree's names.
"""

from __future__ import annotations

import math

import torch
from torch import nn

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}

# The JAX package pads huge catalogs to the vocab-chunked CE kernel's
# block width (ops/fused_ce.py:65-66, 244).  The port keeps the same rule
# so that padded shapes, and so interop, match.
_CE_BV = 2048


def _ce_supports(v: int, d: int) -> bool:
    """Whether the [V, D] table fits the whole-table CE kernel."""
    return v * d * 4 <= 32 * 1024 * 1024 and d <= 512


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names a device; raises without a card
    unless the caller asks for the CPU."""
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return device


def dtype_of(name) -> torch.dtype:
    return _DTYPES[str(name)]


class SequentialModel(nn.Module):
    """Base class: static hyperparameters plus the item embedding;
    subclasses register their parameters and implement ``forward``."""

    def __init__(self, config, n_items: int, max_seq_len: int, device=None):
        super().__init__()
        self.config = config
        self.n_items = int(n_items)  # includes PAD=0
        self.max_seq_len = int(max_seq_len)
        self.compute_dtype = dtype_of(config.get("compute_dtype", "float32"))
        self.param_dtype = dtype_of(config.get("param_dtype", "float32"))
        self.device = resolve_device(device)
        mesh_shape = config.get("mesh_shape") or {}
        self._vocab_mult = int(
            config.get("vocab_multiple") or mesh_shape.get("model", 1) or 1
        )
        hidden = int(config.get("hidden_size", 64) or 64)
        if not _ce_supports(self.n_items, hidden):
            self._vocab_mult = math.lcm(self._vocab_mult, _CE_BV)
        self.n_items_padded = self.pad_vocab_rows(self.n_items)

    def pad_vocab_rows(self, n: int) -> int:
        m = self._vocab_mult
        return -(-n // m) * m

    def forward(self, item_seq, item_seq_len):
        raise NotImplementedError

    def embed(self, ids):
        """Item-embedding lookup; under bf16 compute it gathers from a
        bf16 copy of the table (``ops/embedding.py:41-53`` of the JAX
        package), which rounds exactly as casting after the gather."""
        table = self.item_embedding
        if self.compute_dtype == torch.bfloat16:
            table = table.to(torch.bfloat16)
        return table[ids]

    def _mask_padded_vocab(self, logits, value=float("-inf")):
        if self.n_items_padded == self.n_items:
            return logits
        idx = torch.arange(logits.shape[-1], device=logits.device)[None, :]
        return torch.where(idx < self.n_items, logits,
                           torch.full((), value, dtype=logits.dtype, device=logits.device))

    def full_sort_scores(self, item_seq, item_seq_len):
        """[B, n_items_padded] fp32 scores against the whole catalog;
        padded vocab columns are -inf.  The operands are rounded to the
        compute dtype and multiplied in fp32, as the JAX package's
        ``preferred_element_type=f32`` product."""
        seq_output = self.forward(item_seq, item_seq_len)
        table = self.item_embedding.to(seq_output.dtype)
        logits = seq_output.float() @ table.float().T
        return self._mask_padded_vocab(logits)


def get_model(name: str):
    """Registry lookup by full name or the entry scripts' one-letter alias."""
    from datamining_recblr_torch.models.recblr import RecBLR

    registry = {"RecBLR": RecBLR, "R": RecBLR}
    if name not in registry:
        raise KeyError(f"Model {name!r} is not ported; known: {sorted(registry)}")
    return registry[name]
