"""Sequential-recommender model contract and its loss (counterpart of
``datamining_recblr_tpu/models/base.py``): ``forward(item_seq,
item_seq_len, step) -> [B, H]``, the item embedding lookup (under bf16
compute through ``ops/embedding.py``, whose backward is the table
gradient kernel), the vocab-padding rule, full-catalog scoring and the CE
training loss (on the card the whole-table CE kernel from 8,192 rows, or
the vocab-chunked one for a table beyond it once the logits would take
64 MiB, as the JAX package's gate), as an ``nn.Module`` that holds its
parameters under the JAX parameter tree's names.  The BPR loss is not
ported yet.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from datamining_recblr_torch.ops import fused_ce as FCE
from datamining_recblr_torch.ops.embedding import embedding_lookup

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}

# The JAX package pads huge catalogs to the vocab-chunked CE kernel's
# block width (ops/fused_ce.py:65-66, 244).  The port keeps the same rule
# so that padded shapes, and so interop, match.
_CE_BV = 2048


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


def ce_loss(logits, targets, weights=None):
    """Full-catalog softmax cross-entropy, mean over (weighted) rows
    (``nn.CrossEntropyLoss`` with mean reduction): logits over every item
    id including PAD = 0; a weighted mean divides by max(sum w, 1)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets.long()[:, None])[:, 0]
    return weighted_mean(logz - tgt, weights)


def weighted_mean(nll, weights=None):
    """The mean of per-row losses, or with weights sum(nll w) / max(sum w,
    1)."""
    if weights is None:
        return nll.mean()
    w = weights.float()
    return (nll * w).sum() / w.sum().clamp_min(1.0)


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
        self.loss_type = str(config.get("loss_type", "CE"))
        self.seed = int(config.get("seed", 0) or 0)
        mesh_shape = config.get("mesh_shape") or {}
        self._vocab_mult = int(
            config.get("vocab_multiple") or mesh_shape.get("model", 1) or 1
        )
        hidden = int(config.get("hidden_size", 64) or 64)
        if not FCE.supports(self.n_items, hidden):
            self._vocab_mult = math.lcm(self._vocab_mult, _CE_BV)
        self.n_items_padded = self.pad_vocab_rows(self.n_items)

    def pad_vocab_rows(self, n: int) -> int:
        m = self._vocab_mult
        return -(-n // m) * m

    def forward(self, item_seq, item_seq_len, step=None):
        """[B, H] sequence representation; dropout is on only in training
        mode with a global ``step``, which seeds its masks."""
        raise NotImplementedError

    def embed(self, ids):
        """Item-embedding lookup.  Under bf16 compute it is
        ``embedding_lookup`` (the JAX package's ``models/base.py:108-115``):
        a gather from a bf16 copy of the table, whose table gradient is
        summed in fp32 by the ``embedding_grad`` kernel on the card.
        Under fp32 it is the plain gather, ``F.embedding``."""
        if self.compute_dtype == torch.bfloat16:
            return embedding_lookup(self.item_embedding, ids)
        return F.embedding(ids, self.item_embedding)

    def _mask_padded_vocab(self, logits, value=float("-inf")):
        if self.n_items_padded == self.n_items:
            return logits
        idx = torch.arange(logits.shape[-1], device=logits.device)[None, :]
        return torch.where(idx < self.n_items, logits,
                           torch.full((), value, dtype=logits.dtype, device=logits.device))

    def full_sort_scores(self, item_seq, item_seq_len):
        """[B, n_items_padded] fp32 scores against the whole catalog
        (BERT4Rec's ``_logits``: [B, n_items]); padded vocab columns are -inf.  The operands are rounded to the
        compute dtype and multiplied in fp32, as the JAX package's
        ``preferred_element_type=f32`` product."""
        seq_output = self.forward(item_seq, item_seq_len)
        return self._mask_padded_vocab(self._logits(seq_output))

    def _logits(self, seq_output):
        table = self.item_embedding.to(seq_output.dtype)
        return seq_output.float() @ table.float().T

    def item_scores(self, seq_output, item_ids):
        """Dot-product score of seq_output[b] with item ids [B]."""
        emb = self.item_embedding[item_ids].to(seq_output.dtype)
        return (seq_output * emb).sum(-1)

    def _use_fused_ce(self, v: int, d: int, rows: int) -> bool:
        """The CE kernels' gate (the JAX package's ``_use_fused_ce`` on one
        device): on the card, the whole-table kernel when the [V, D] table
        fits it and the loss has at least ``MIN_ROWS`` rows, below which
        the JAX package keeps its XLA CE; the vocab-chunked kernel for a
        larger table once the [rows, V] fp32 logits would take
        ``CHUNK_MIN_LOGITS_BYTES``."""
        if self.device.type != "cuda":
            return False
        if FCE.supports(v, d):
            return rows >= FCE.MIN_ROWS
        return FCE.supports_chunked(v, d) and rows * v * 4 >= FCE.CHUNK_MIN_LOGITS_BYTES

    def calculate_loss(self, batch, step=None):
        """batch: item_seq [B, T], item_seq_len [B], pos_item [B] and an
        optional weight [B] (0 for padded rows).  CE over the whole
        catalog, padded vocab columns at -1e30 (on the card through a CE
        kernel where ``_use_fused_ce`` says so); dropout on in training
        mode with the global ``step``."""
        if self.loss_type != "CE":
            raise NotImplementedError(f"loss_type {self.loss_type!r} is not ported; CE is "
                                      "(BPR: ROADMAP.md queue A item 8)")
        seq_output = self.forward(batch["item_seq"], batch["item_seq_len"], step=step)
        weights = batch.get("weight")
        table = self.item_embedding
        if self._use_fused_ce(*table.shape, rows=seq_output.shape[0]):
            nll = FCE.fused_softmax_ce(seq_output, table, batch["pos_item"],
                                       valid_v=self.n_items,
                                       mm_bf16=self.compute_dtype == torch.bfloat16)
            return weighted_mean(nll, weights)
        logits = self._mask_padded_vocab(self._logits(seq_output), value=-1e30)
        return ce_loss(logits, batch["pos_item"], weights)


def get_model(name: str):
    """Registry lookup by full name or the entry scripts' one-letter alias."""
    from datamining_recblr_torch.models.bert4rec import BERT4Rec
    from datamining_recblr_torch.models.recblr import RecBLR
    from datamining_recblr_torch.models.sasrec import SASRec

    registry = {"RecBLR": RecBLR, "R": RecBLR, "SASRec": SASRec, "S": SASRec,
                "BERT4Rec": BERT4Rec, "B": BERT4Rec}
    if name not in registry:
        raise KeyError(f"Model {name!r} is not ported; known: {sorted(registry)}")
    return registry[name]
