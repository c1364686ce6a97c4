"""Sequential-recommender model contract and its loss (counterpart of
``datamining_recblr_tpu/models/base.py``): ``forward(item_seq,
item_seq_len, step) -> [B, H]``, the item embedding lookup (under bf16
compute through ``ops/embedding.py``, whose backward is the table
gradient kernel), the vocab-padding rule, full-catalog scoring and the CE
training loss (on the card the whole-table CE kernel from 8,192 rows, or
the vocab-chunked one for a table beyond it once the logits would take
64 MiB, as the JAX package's gate) or the BPR loss against one sampled
negative a row, as an ``nn.Module`` that holds its parameters under the
JAX parameter tree's names.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from datamining_recblr_torch.models.layers import normal_init, seq_size
from datamining_recblr_torch.ops import fused_ce as FCE
from datamining_recblr_torch.ops import philox
from datamining_recblr_torch.ops.embedding import embedding_lookup, gather_rows
from datamining_recblr_torch.parallel.collectives import (
    all_gather,
    all_reduce,
    copy_to_model,
    reduce_from_model,
)
from datamining_recblr_torch.parallel.input import seq_chunk
from datamining_recblr_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, SEQ_AXIS

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}

# The JAX package pads huge catalogs to the vocab-chunked CE kernel's
# block width (ops/fused_ce.py:65-66, 244).  The port keeps the same rule
# so that padded shapes, and so interop, match.
_CE_BV = 2048

BPR_GAMMA = 1e-10  # RecBole's BPRLoss gamma: -log(gamma + sigmoid(pos - neg))


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


def ce_loss(logits, targets, weights=None, mesh=None):
    """Full-catalog softmax cross-entropy, mean over (weighted) rows
    (``nn.CrossEntropyLoss`` with mean reduction): logits over every item
    id including PAD = 0; a weighted mean divides by max(sum w, 1)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets.long()[:, None])[:, 0]
    return weighted_mean(logz - tgt, weights, mesh)


def bpr_loss(pos_score, neg_score, weights=None, mesh=None):
    """RecBole's BPRLoss: ``-log(1e-10 + sigmoid(pos - neg))``, the (weighted)
    mean over rows."""
    return weighted_mean(-torch.log(BPR_GAMMA + torch.sigmoid(pos_score - neg_score)),
                         weights, mesh)


def weighted_mean(nll, weights=None, mesh=None):
    """The mean of per-row losses, or with weights sum(nll w) / max(sum w,
    1).  On a ``mesh`` the rows are this rank's part of the batch: the
    sum is its own, the count or the weight sum the global one, so the
    data ranks' results add up to the mean over the global batch.  The S
    ranks of a ``seq`` group hold the same rows, and each takes 1/S of
    their mean (``parallel/collectives.py``: the sum over ``seq`` of the
    gradients and of the loss counts them once)."""
    if weights is None:
        if mesh is None:
            return nll.mean()
        return nll.sum() / (nll.numel() * mesh.size(DATA_AXIS) * mesh.size(SEQ_AXIS))
    w = weights.float()
    if mesh is None:
        return (nll * w).sum() / w.sum().clamp_min(1.0)
    total = all_reduce(w.sum(), mesh, DATA_AXIS).clamp_min(1.0) * mesh.size(SEQ_AXIS)
    return (nll * w).sum() / total


def sharded_rows(shard, ids, lo: int, mesh, lookup):
    """Rows ``ids`` [...] of a table whose rows [lo, lo + len(shard)) this
    rank holds in ``shard``, as ``lookup(table, ids)`` of the whole
    table: the ids it holds are looked up here, the others give zero, and
    the sum over the model ranks puts each row together (its backward
    the identity, so each rank's gradient lands on its own rows)."""
    local = ids.long() - lo
    own = (local >= 0) & (local < shard.shape[0])
    rows = lookup(shard, torch.where(own, local, torch.zeros_like(local)))
    rows = torch.where(own[..., None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
    return reduce_from_model(rows, mesh)


def vocab_parallel_nll(logits, targets, lo: int, mesh):
    """Per-row softmax CE of logits sharded over ``model``: ``logits``
    [N, Vs] are the columns [lo, lo + Vs) on this rank.  The max, the sum
    of exponentials and the target's logit are each reduced over the
    model ranks; the backward gives each rank its columns' gradient."""
    logits = logits.float()
    top = all_reduce(logits.detach().amax(-1), mesh, MODEL_AXIS, "max")
    sumexp = reduce_from_model((logits - top[:, None]).exp().sum(-1), mesh)
    local = targets.long() - lo
    own = (local >= 0) & (local < logits.shape[1])
    tgt = logits.gather(-1, torch.where(own, local, torch.zeros_like(local))[:, None])[:, 0]
    tgt = reduce_from_model(torch.where(own, tgt, torch.zeros_like(tgt)), mesh)
    return sumexp.log() + top - tgt


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
        # vocab-leading rows pad to the mesh's model-axis multiple, so the
        # row-shard policy decides, never divisibility; _base_mult is an
        # unmeshed model's padding, which checkpoints keep
        mesh_shape = config.get("mesh_shape") or {}
        self._vocab_mult = int(
            config.get("vocab_multiple") or mesh_shape.get("model", 1) or 1
        )
        self._base_mult = int(config.get("vocab_multiple") or 1)
        hidden = int(config.get("hidden_size", 64) or 64)
        if not FCE.supports(self.n_items, hidden):
            self._vocab_mult = math.lcm(self._vocab_mult, _CE_BV)
            self._base_mult = math.lcm(self._base_mult, _CE_BV)
        self.n_items_padded = self.pad_vocab_rows(self.n_items)
        # set by parallel.sharding.shard_model on a mesh
        self.mesh = None
        self.shards: dict[str, tuple[int, int]] = {}  # name -> global rows held
        self.seed_offset = 0

    def pad_vocab_rows(self, n: int, meshed: bool = True) -> int:
        """``n`` rounded up to the model's padding (with ``meshed=False``
        to an unmeshed model's)."""
        m = self._vocab_mult if meshed else self._base_mult
        return -(-n // m) * m

    def vocab_rows(self) -> dict[str, int]:
        """The vocab-leading parameters and their rows before padding."""
        return {"item_embedding": self.n_items}

    def init_table(self, gen, n: int, d: int, dt):
        """The [pad_vocab_rows(n), d] item table, row 0 (PAD) zero: the
        rows an unmeshed model draws from ``gen``, then zero rows to the
        mesh's padding, so a meshed model starts from the unmeshed one's
        parameters."""
        rows = self.pad_vocab_rows(n, meshed=False)
        emb = normal_init(gen, (rows, d), dtype=dt)
        emb[0] = 0.0  # padding_idx = 0
        extra = self.pad_vocab_rows(n) - rows
        return torch.cat([emb, emb.new_zeros((extra, d))]) if extra > 0 else emb

    def step_seeds(self, step, n: int) -> list[int]:
        """``n`` dropout seeds of a training step (``philox.step_seeds``),
        each offset by ``seed_offset`` (a data index's, on a mesh)."""
        return [(s + self.seed_offset) & 0xFFFFFFFFFFFFFFFF
                for s in philox.step_seeds(self.seed, step, n)]

    def seq_shards(self) -> int:
        """The size of the mesh's ``seq`` axis (1 off a mesh): above 1 the
        time axis is sharded over it, each seq rank running its chunk."""
        return seq_size(self.mesh)

    def seq_input(self, item_seq):
        """(this rank's chunk of ``item_seq``, its first global position,
        the global T) under ``seq``: ``item_seq`` is a full window [B, T]
        (T = ``max_seq_len``), cut here, or the chunk [B, T/S] already
        (``parallel.sharding.shard_batch``'s)."""
        t = self.max_seq_len
        t0, t1 = seq_chunk(t, self.mesh)
        if item_seq.shape[1] == t:
            return item_seq[:, t0:t1], t0, t
        if item_seq.shape[1] == t1 - t0:
            return item_seq, t0, t
        raise ValueError(f"item_seq of width {item_seq.shape[1]} on a seq mesh: expected the "
                         f"window ({t}) or this rank's chunk of it ({t1 - t0})")

    def seq_window(self, item_seq):
        """The full window [B, T] under ``seq``: ``item_seq`` itself, or this
        rank's chunk gathered over ``seq`` (the attention models' lens and
        BERT4Rec's cloze draw and mask token read the whole row)."""
        if item_seq.shape[1] == self.max_seq_len:
            return item_seq
        self.seq_input(item_seq)  # raises for a width that is neither
        return all_gather(item_seq, self.mesh, SEQ_AXIS, dim=1)

    def data_row0(self, rows: int) -> int:
        """The global index of this rank's first row of a batch of which it
        holds ``rows`` (0 off a mesh)."""
        return self.mesh.index(DATA_AXIS) * rows if self.mesh is not None else 0

    def rows_of(self, name: str, ids, lookup=None):
        """Rows ``ids`` [...] of the vocab-leading parameter ``name`` (a 1-D
        one as one column, squeezed) by ``lookup`` (``gather_rows``, read
        when called, by default); from a row-sharded one, each id read on
        the rank that holds it."""
        lookup = lookup or gather_rows
        p = getattr(self, name)
        table = p[:, None] if p.dim() == 1 else p
        rng = self.shards.get(name)
        rows = (lookup(table, ids) if rng is None
                else sharded_rows(table, ids, rng[0], self.mesh, lookup))
        return rows[..., 0] if p.dim() == 1 else rows

    def score_cols(self) -> tuple[int, int]:
        """The global item columns [lo, hi) of this rank's
        ``full_sort_scores``."""
        return self.shards.get("item_embedding", (0, self.n_items_padded))

    def score_mesh(self):
        """The mesh whose ``model`` axis shards this rank's scores over the
        catalog (a row-sharded table), else None: the ranks and the top-k
        of sharded scores are reduced over it."""
        return self.mesh if "item_embedding" in self.shards else None

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
            return self.rows_of("item_embedding", ids, embedding_lookup)
        return self.rows_of("item_embedding", ids, lambda t, i: F.embedding(i, t))

    def _mask_padded_vocab(self, logits, value=float("-inf"), col0: int = 0):
        """Columns at global index >= n_items (``col0`` the first's) set to
        ``value``."""
        if col0 + logits.shape[-1] <= self.n_items:
            return logits
        idx = col0 + torch.arange(logits.shape[-1], device=logits.device)[None, :]
        return torch.where(idx < self.n_items, logits,
                           torch.full((), value, dtype=logits.dtype, device=logits.device))

    def full_sort_scores(self, item_seq, item_seq_len):
        """[B, n_items_padded] fp32 scores against the whole catalog
        (BERT4Rec's: [B, n_items]); padded vocab columns are -inf.  The
        operands are rounded to the compute dtype and multiplied in fp32,
        as the JAX package's ``preferred_element_type=f32`` product.
        On a mesh with a row-sharded table: the columns ``score_cols()``.
        """
        seq_output = self.forward(item_seq, item_seq_len)
        lo, hi = self.score_cols()
        return self._mask_padded_vocab(self._logits(seq_output)[:, : hi - lo], col0=lo)

    def _logits(self, seq_output):
        """fp32 logits against the table (this rank's rows of a sharded
        one, the output entering through ``copy_to_model``)."""
        table = self.item_embedding.to(seq_output.dtype)
        if self.score_mesh() is not None:
            seq_output = copy_to_model(seq_output, self.mesh)
        return seq_output.float() @ table.float().T

    def sharded_nll(self, x, targets):
        """Per-row CE of ``x`` [N, D] against a row-sharded table:
        ``vocab_parallel_nll`` of this rank's logits, the columns at or past
        ``n_items`` at -1e30."""
        lo = self.shards["item_embedding"][0]
        logits = self._mask_padded_vocab(self._logits(x), value=-1e30, col0=lo)
        return vocab_parallel_nll(logits, targets, lo, self.mesh)

    def item_scores(self, seq_output, item_ids):
        """Dot-product score of seq_output [..., H] with the items
        ``item_ids`` [K, ...] (K sets of ids, seq_output broadcast over
        K): the table rows gathered in its dtype, then rounded to the
        compute dtype; their table gradient is ``embedding_grad``'s."""
        emb = self.rows_of("item_embedding", item_ids).to(seq_output.dtype)
        return (seq_output * emb).sum(-1)

    def _use_fused_ce(self, v: int, d: int, rows: int) -> bool:
        """The CE kernels' gate (the JAX package's ``_use_fused_ce`` on one
        device): on the card, the whole-table kernel when the [V, D] table
        fits it and the loss has at least ``MIN_ROWS`` rows, below which
        the JAX package keeps its XLA CE; the vocab-chunked kernel for a
        larger table once the [rows, V] fp32 logits would take
        ``CHUNK_MIN_LOGITS_BYTES``.  On a mesh only against a replicated
        table and bias, ``rows`` being this rank's (a data rank's; under
        ``seq`` the selected rows, the same on each seq rank).  JAX also
        keeps its XLA CE on a mesh without a ``data`` axis, where its
        kernel has no axis to ``shard_map`` over; the port's runs on each
        rank's rows whatever the axes."""
        if self.device.type != "cuda":
            return False
        if self.mesh is not None and self.shards:
            return False
        if FCE.supports(v, d):
            return rows >= FCE.MIN_ROWS
        return FCE.supports_chunked(v, d) and rows * v * 4 >= FCE.CHUNK_MIN_LOGITS_BYTES

    def calculate_loss(self, batch, step=None):
        """batch: item_seq [B, T], item_seq_len [B], pos_item [B], under BPR
        neg_item [B], and an optional weight [B] (0 for padded rows).  CE
        over the whole catalog, padded vocab columns at -1e30 (on the card
        through a CE kernel where ``_use_fused_ce`` says so), or BPR of the
        positive's score against the negative's; dropout on in training
        mode with the global ``step``."""
        if self.loss_type not in ("CE", "BPR"):
            raise ValueError(f"unknown loss_type {self.loss_type!r} (CE / BPR)")
        seq_output = self.forward(batch["item_seq"], batch["item_seq_len"], step=step)
        weights = batch.get("weight")
        if self.loss_type == "BPR":
            ids = torch.stack([batch["pos_item"].long(), batch["neg_item"].long()])
            pos, neg = self.item_scores(seq_output, ids)  # one gather, one table gradient
            return bpr_loss(pos, neg, weights, self.mesh)
        table = self.item_embedding
        if self.score_mesh() is not None:
            nll = self.sharded_nll(seq_output, batch["pos_item"])
        elif self._use_fused_ce(*table.shape, rows=seq_output.shape[0]):
            nll = FCE.fused_softmax_ce(seq_output, table, batch["pos_item"],
                                       valid_v=self.n_items,
                                       mm_bf16=self.compute_dtype == torch.bfloat16)
        else:
            logits = self._mask_padded_vocab(self._logits(seq_output), value=-1e30)
            return ce_loss(logits, batch["pos_item"], weights, self.mesh)
        return weighted_mean(nll, weights, self.mesh)


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
