"""BERT4Rec baseline, serving: bidirectional transformer with the
mask-append test protocol, as an ``nn.Module`` (counterpart of
``datamining_recblr_tpu/models/bert4rec.py``).

The mask token id is ``n_items``, with an ``n_items + 1`` row table
padded by ``pad_vocab_rows``.  A request appends the mask token after the
history and shifts left one step (``reconstruct_test_seq``), runs the
bidirectional encoder of ``SASRec`` (on the fused composition the top
layer at the last position only), then the output head
LN(gelu(x W + b)), and scores against ``item_embedding[:n_items]`` plus
``output_bias[:n_items]``: [B, n_items].  An empty history leaves an
all-PAD row (lens 0).  The cloze training is not ported yet (ROADMAP.md
queue A item 3.2: the selected-positions layer and fused CE, queue B rows
12 and 13): ``calculate_loss``, and ``forward`` in training mode with a
step, raise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from datamining_recblr_torch.models import layers as L
from datamining_recblr_torch.models.sasrec import SASRec

_NOT_PORTED = ("BERT4Rec's cloze training is not ported yet; it is the next slice of "
               "the port (ROADMAP.md queue A item 3.2: queue B rows 12 and 13)")


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

    def encode(self, item_seq, last_only=False):
        """[B, T] -> ``(out, selected)``: the states after the embedding, the
        bidirectional encoder and the output head.  With ``last_only`` on
        the fused composition the top layer computes each row's last
        position only ([B, D], ``selected`` True); otherwise [B, T, D]
        comes back and the caller gathers.  The head is positionwise, so
        applying it after the selection computes the same values."""
        x = self._encode(item_seq, last_only)
        return self.output_head(x), x.dim() == 2

    def forward(self, item_seq, item_seq_len, step=None):
        if self.training and step is not None:
            raise NotImplementedError(_NOT_PORTED)
        out, selected = self.encode(self.reconstruct_test_seq(item_seq, item_seq_len),
                                    last_only=True)
        return out if selected else L.gather_last(out, item_seq_len)

    def calculate_loss(self, batch, step=None):
        raise NotImplementedError(_NOT_PORTED)

    def output_head(self, x):
        """LN(gelu(x W + b)), GELU in its tanh form as ``jax.nn.gelu``."""
        return L.layer_norm(self.output_ln,
                            F.gelu(L.dense(self.output_ffn, x), approximate="tanh"))

    def item_scores(self, seq_output, item_ids):
        emb = self.item_embedding[item_ids].to(seq_output.dtype)
        return (seq_output * emb).sum(-1) + self.output_bias[item_ids]

    def _logits(self, seq_output):
        """[B, n_items] fp32 scores: the table without the mask token's row,
        plus the output bias."""
        table = self.item_embedding[: self.n_items].to(seq_output.dtype)
        return (seq_output.float() @ table.float().T
                + self.output_bias[: self.n_items].float())
