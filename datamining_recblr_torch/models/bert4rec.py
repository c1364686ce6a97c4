"""BERT4Rec baseline: bidirectional transformer with cloze training and
the mask-append test protocol, as an ``nn.Module`` (counterpart of
``datamining_recblr_tpu/models/bert4rec.py``).

The mask token id is ``n_items``, with an ``n_items + 1`` row table
padded by ``pad_vocab_rows``.  A request appends the mask token after the
history and shifts left one step (``reconstruct_test_seq``), runs the
bidirectional encoder of ``SASRec`` (on the fused composition the top
layer at the last position only), then the output head
LN(gelu(x W + b)), and scores against ``item_embedding[:n_items]`` plus
``output_bias[:n_items]``: [B, n_items].  An empty history leaves an
all-PAD row (lens 0).

Training is the cloze objective with the reference's fixed budget of
``mask_len = max(1, int(mask_ratio * max_seq_len))`` positions per row
(``cloze_draw``): each real position is masked with probability
``mask_ratio`` (a Philox draw under its own seed of (config seed, global
step)), capped at the budget by rank, replaced by the mask token, and the
masked positions are compacted to the front of ``order [B, mask_len]``
with their targets.  ``cloze_loss`` runs the encoder with the top layer at
those positions only (``fused_transformer_layer_sel`` when mask_len < T;
the unfused composition returns [B, T, D] and is gathered), the output
head, and CE over the table without the mask token's row plus the output
bias (the whole-table CE kernel from 8,192 rows on the card), weighted by
the valid slots times the row weight and divided by max(sum w, 1).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from datamining_recblr_torch.models import layers as L
from datamining_recblr_torch.models.base import ce_loss, weighted_mean
from datamining_recblr_torch.models.sasrec import SASRec
from datamining_recblr_torch.ops import fused_ce as FCE
from datamining_recblr_torch.ops import philox


class BERT4Rec(SASRec):
    causal = False

    def __init__(self, config, n_items, max_seq_len, device=None, generator=None):
        self.mask_ratio = float(config["mask_ratio"])
        super().__init__(config, n_items, max_seq_len, device=device, generator=generator)
        self.mask_token = self.n_items

    def _table_rows(self):
        return self.pad_vocab_rows(self.n_items + 1)  # + the mask token's row

    def _init_params(self, gen):
        super()._init_params(gen)
        d, dt = self.hidden_size, self.param_dtype
        self.output_ffn = L.param_tree(L.dense_init(gen, d, d, dt))
        self.output_ln = L.param_tree(L.layer_norm_init(d, dt))
        self.output_bias = nn.Parameter(
            torch.zeros((self.pad_vocab_rows(self.n_items),), dtype=dt))

    def reconstruct_test_seq(self, item_seq, item_seq_len):
        """Put the mask token at position ``item_seq_len`` and shift left
        one step."""
        b = item_seq.shape[0]
        padded = torch.cat([item_seq, item_seq.new_zeros((b, 1))], dim=1)
        padded[torch.arange(b, device=item_seq.device), item_seq_len.long()] = self.mask_token
        return padded[:, 1:]

    def encode(self, item_seq, last_only=False, select=None, step=None):
        """[B, T] -> ``(out, selected)``: the states after the embedding, the
        bidirectional encoder and the output head.  On the fused
        composition the top layer computes each row's last position only
        with ``last_only`` ([B, D]) or the positions ``select`` [B, S] only
        ([B, S, D]), and ``selected`` is True; otherwise [B, T, D] comes
        back and the caller gathers.  ``select`` with S >= T is dropped
        (it saves nothing and would make the shapes ambiguous).  The head
        is positionwise, so applying it after the selection computes the
        same values.  Dropout is on in training mode with a ``step``."""
        t = item_seq.shape[1]
        if select is not None and select.shape[1] >= t:
            select = None
        x = self._encode(item_seq, last_only, step=step, select=select)
        selected = x.dim() == 2 or (select is not None and x.shape[1] != t)
        return self.output_head(x), selected

    def forward(self, item_seq, item_seq_len, step=None):
        out, selected = self.encode(self.reconstruct_test_seq(item_seq, item_seq_len),
                                    last_only=True, step=step)
        return out if selected else L.gather_last(out, item_seq_len)

    # ------------------------------------------------------------------
    def mask_len(self, t: int) -> int:
        """The cloze budget: masked positions per row."""
        return max(1, int(self.mask_ratio * (self.max_seq_len or t)))

    def cloze_seed(self, step) -> int:
        """The cloze draw's seed: one more ``step_seeds`` entry after the
        dropout seeds (one per layer and the prologue's), so it is apart
        from every mask and a function of (config seed, step) alone."""
        return philox.step_seeds(self.seed, step, len(self.encoder) + 2)[-1]

    def cloze_draw(self, item_seq, item_seq_len, step=None):
        """The cloze positions of one step (``step`` None draws step 0's):
        ``(masked_seq [B, T], order, sel_tgt [B, mask_len] long, sel_valid
        [B, mask_len] bool)``.  Real positions are drawn with probability
        ``mask_ratio`` (with the config's ``cloze_last_only``: each row's
        last real position only), the first ``mask_len`` of them by
        position kept; ``order`` lists them ascending, its slots past a
        row's count hold position 0 and target 0 and are not valid."""
        b, t = item_seq.shape
        mask_len = self.mask_len(t)
        dev = item_seq.device
        real = item_seq != 0
        pos = torch.arange(t, device=dev)[None, :]
        if self.config.get("cloze_last_only"):
            want = real & (pos == item_seq_len.long()[:, None] - 1)
        else:
            want = real & philox.cloze_draw(self.cloze_seed(0 if step is None else step), b, t,
                                            self.mask_ratio, dev)
        rank = torch.cumsum(want, dim=1)  # 1-based rank among the drawn positions
        cloze = want & (rank <= mask_len)
        masked_seq = torch.where(cloze, torch.full_like(item_seq, self.mask_token), item_seq)
        # compaction by scatter: slot rank - 1 of a masked position, the
        # others into a spare slot that is cut off
        slot = torch.where(cloze, rank - 1, torch.full_like(rank, mask_len))
        order = torch.zeros((b, mask_len + 1), dtype=torch.long, device=dev)
        order.scatter_(1, slot, pos.expand(b, t))
        sel_tgt = torch.zeros_like(order).scatter_(1, slot, item_seq.long())
        n_masked = cloze.sum(1)
        sel_valid = torch.arange(mask_len, device=dev)[None, :] < n_masked[:, None]
        return masked_seq, order[:, :mask_len], sel_tgt[:, :mask_len], sel_valid

    def cloze_loss(self, batch, cloze, step=None):
        """The CE cloze loss of ``cloze = (masked_seq, order, sel_tgt,
        sel_valid)`` (``cloze_draw``'s), with ``batch``'s optional row
        weight [B]; dropout on in training mode with ``step``."""
        masked_seq, order, sel_tgt, sel_valid = cloze
        out, selected = self.encode(masked_seq, select=order, step=step)
        h = out.shape[-1]
        if not selected:
            out = torch.gather(out, 1, order[..., None].expand(-1, -1, h))
        w = sel_valid.float()
        if batch.get("weight") is not None:
            w = w * batch["weight"].float()[:, None]
        x = out.reshape(-1, h)
        tgt = sel_tgt.clamp_min(0).reshape(-1)
        if self._use_fused_ce(self.n_items, h, rows=x.shape[0]):
            nll = FCE.fused_softmax_ce(x, self.item_embedding[: self.n_items], tgt,
                                       bias=self.output_bias[: self.n_items],
                                       mm_bf16=self.compute_dtype == torch.bfloat16)
            return weighted_mean(nll, w.reshape(-1))
        return ce_loss(self._logits(x), tgt, w.reshape(-1))

    def calculate_loss(self, batch, step=None):
        """batch: item_seq [B, T], item_seq_len [B] and an optional weight
        [B] (0 for padded rows).  The cloze CE loss of ``step``'s draw."""
        if self.loss_type != "CE":
            raise NotImplementedError(f"loss_type {self.loss_type!r} is not ported; CE is "
                                      "(BPR: ROADMAP.md queue A item 8)")
        cloze = self.cloze_draw(batch["item_seq"], batch["item_seq_len"], step)
        return self.cloze_loss(batch, cloze, step)

    # ------------------------------------------------------------------
    def output_head(self, x):
        """LN(gelu(x W + b)), GELU in its tanh form as ``jax.nn.gelu``."""
        return L.layer_norm(self.output_ln,
                            F.gelu(L.dense(self.output_ffn, x), approximate="tanh"))

    def item_scores(self, seq_output, item_ids):
        emb = self.item_embedding[item_ids].to(seq_output.dtype)
        return (seq_output * emb).sum(-1) + self.output_bias[item_ids]

    def _logits(self, seq_output):
        """[..., n_items] fp32 scores: the table without the mask token's
        row, plus the output bias."""
        table = self.item_embedding[: self.n_items].to(seq_output.dtype)
        return (seq_output.float() @ table.float().T
                + self.output_bias[: self.n_items].float())
