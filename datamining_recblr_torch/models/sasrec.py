"""SASRec baseline, serving: unidirectional self-attention tower, as an
``nn.Module`` (counterpart of ``datamining_recblr_tpu/models/sasrec.py``).

item embedding + positional embedding -> LayerNorm -> causal post-LN
transformer stack (additive -10000 mask over PAD and future keys) ->
last-position output [B, D].  On the fused composition the prologue runs
``fused_ln_dropout``, every layer below the top ``fused_transformer_layer``
and the top layer ``fused_transformer_layer_last``, which computes the
last position only.

Parameters carry the names and layouts of the JAX ``init_params``
(``item_embedding``, ``position_embedding``, ``input_ln``,
``encoder.<i>.{q,k,v,attn_out,attn_ln,ffn_1,ffn_2,ffn_ln}``), so
``interop.params_from_jax`` is a dtype and device move.  Training is not
ported yet (ROADMAP.md queue A item 3): ``calculate_loss``, and
``forward`` in training mode with a step, raise.
"""

from __future__ import annotations

import torch
from torch import nn

from datamining_recblr_torch.models import layers as L
from datamining_recblr_torch.models.base import SequentialModel

_NOT_PORTED = ("training {} is not ported yet; it is the next slice of the port "
               "(ROADMAP.md queue A item 3)")


class SASRec(SequentialModel):
    causal = True

    def __init__(self, config, n_items, max_seq_len, device=None, generator=None):
        super().__init__(config, n_items, max_seq_len, device=device)
        self.n_layers = config["n_layers"]
        self.n_heads = config["n_heads"]
        self.hidden_size = config["hidden_size"]
        self.inner_size = config["inner_size"]
        self.hidden_dropout_prob = config["hidden_dropout_prob"]
        self.attn_dropout_prob = config["attn_dropout_prob"]
        self.hidden_act = config["hidden_act"]
        if generator is None:
            generator = torch.Generator().manual_seed(self.seed)
        self._init_params(generator)
        self.to(self.device)

    def _table_rows(self):
        return self.n_items_padded

    def _init_params(self, gen):
        """The shared part of the JAX ``init_params`` trees, drawn from
        ``gen``."""
        d, dt = self.hidden_size, self.param_dtype
        emb = L.normal_init(gen, (self._table_rows(), d), dtype=dt)
        emb[0] = 0.0  # padding_idx = 0
        self.item_embedding = nn.Parameter(emb)
        self.position_embedding = nn.Parameter(
            L.normal_init(gen, (self.max_seq_len, d), dtype=dt))
        self.input_ln = L.param_tree(L.layer_norm_init(d, dt))
        self.encoder = L.param_tree(L.transformer_encoder_init(
            gen, self.n_layers, self.n_heads, d, self.inner_size, dt))

    def _check_serving(self, step):
        if self.training and step is not None:
            raise NotImplementedError(_NOT_PORTED.format(type(self).__name__))

    def _encode(self, item_seq, last_only):
        """Embedding, prologue and encoder: [B, D] when the fused top layer
        computed the last position only, else [B, T, D]."""
        t = item_seq.shape[1]
        x = self.embed(item_seq).to(self.compute_dtype)
        x = L.prologue_ln_dropout(self.input_ln, x, pos=self.position_embedding[:t])
        lens = (item_seq != 0).sum(1, dtype=torch.int32)
        return L.transformer_encoder_apply(
            self.encoder, x,
            lambda: L.attention_mask(item_seq, bidirectional=not self.causal),
            n_heads=self.n_heads, hidden_act=self.hidden_act, lens=lens,
            causal=self.causal, last_only=last_only,
        )

    def forward(self, item_seq, item_seq_len, step=None):
        self._check_serving(step)
        x = self._encode(item_seq, last_only=True)
        return x if x.dim() == 2 else L.gather_last(x, item_seq_len)

    def calculate_loss(self, batch, step=None):
        raise NotImplementedError(_NOT_PORTED.format(type(self).__name__))
