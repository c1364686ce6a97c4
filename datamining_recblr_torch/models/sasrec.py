"""SASRec baseline: unidirectional self-attention tower, as an
``nn.Module`` (counterpart of ``datamining_recblr_tpu/models/sasrec.py``).

item embedding + positional embedding -> LayerNorm -> dropout -> causal
post-LN transformer stack (additive -10000 mask over PAD and future keys)
-> last-position output [B, D], trained with the base CE loss.  On the
fused composition the prologue runs ``fused_ln_dropout``, every layer
below the top ``fused_transformer_layer`` and the top layer
``fused_transformer_layer_last``, which computes the last position only;
with grad enabled each runs its backward kernel.

Dropout (``hidden_dropout_prob`` after the prologue, W_o and the FFN;
``attn_dropout_prob`` on the probabilities) is on in training mode when
``forward`` gets the global step: the masks are Philox draws whose seeds
are a function of (config seed, step, layer) alone
(``ops/philox.py:step_seeds``), one per layer plus one for the prologue,
offset on a mesh by the data index (``SequentialModel.step_seeds``).

On a mesh with a ``seq`` axis of S > 1 each seq rank keeps its time chunk
[t0, t0 + T/S) through the whole tower: ``lens`` comes from the full
window (gathered over ``seq`` where the rank got its chunk), the
prologue adds the chunk's rows of the positional table, every layer runs
the per-op composition on the chunk against the keys and values
gathered over ``seq`` (``fused_attention`` with ``q0 = t0``), every
dropout mask is drawn at the global positions, and ``forward`` reads each
row's position clip(len - 1, 0, T - 1) on the rank that holds it
(``select_over_seq``; an empty row reads position 0, as JAX's
``gather_last``).

Parameters carry the names and layouts of the JAX ``init_params``
(``item_embedding``, ``position_embedding``, ``input_ln``,
``encoder.<i>.{q,k,v,attn_out,attn_ln,ffn_1,ffn_2,ffn_ln}``), so
``interop.params_from_jax`` is a dtype and device move.
"""

from __future__ import annotations

import torch
from torch import nn

from datamining_recblr_torch.models import layers as L
from datamining_recblr_torch.models.base import SequentialModel
from datamining_recblr_torch.parallel.collectives import select_over_seq


class SASRec(SequentialModel):
    causal = True

    def __init__(self, config, n_items, max_seq_len, device=None, generator=None):
        super().__init__(config, n_items, max_seq_len, device=device)
        self.n_layers = config["n_layers"]
        self.n_heads = config["n_heads"]
        self.hidden_size = config["hidden_size"]
        self.inner_size = config["inner_size"]
        self.hidden_dropout_prob = float(config["hidden_dropout_prob"] or 0.0)
        self.attn_dropout_prob = float(config["attn_dropout_prob"] or 0.0)
        self.hidden_act = config["hidden_act"]
        if generator is None:
            generator = torch.Generator().manual_seed(self.seed)
        self._init_params(generator)
        self.to(self.device)

    def _table_items(self):
        """The item table's rows before padding."""
        return self.n_items

    def _init_params(self, gen):
        """The shared part of the JAX ``init_params`` trees, drawn from
        ``gen``."""
        d, dt = self.hidden_size, self.param_dtype
        self.item_embedding = nn.Parameter(self.init_table(gen, self._table_items(), d, dt))
        self.position_embedding = nn.Parameter(
            L.normal_init(gen, (self.max_seq_len, d), dtype=dt))
        self.input_ln = L.param_tree(L.layer_norm_init(d, dt))
        self.encoder = L.param_tree(L.transformer_encoder_init(
            gen, self.n_layers, self.n_heads, d, self.inner_size, dt))

    def dropout_seeds(self, step):
        """(hidden p, attention p, seeds): one seed per layer plus one for
        the prologue (the last); both rates 0 outside training with a
        step."""
        n = len(self.encoder) + 1
        p = (self.hidden_dropout_prob, self.attn_dropout_prob)
        if not (self.training and step is not None and any(p)):
            return 0.0, 0.0, [0] * n
        return (*p, self.step_seeds(step, n))

    def _encode(self, item_seq, last_only, step=None, select=None):
        """Embedding, prologue and encoder: [B, D] when the fused top layer
        computed the last position only, [B, S, D] when it computed the
        positions ``select`` [B, S] only, else [B, T, D]; under ``seq``
        this rank's chunk [B, T/S, D] (``item_seq`` the full window or the
        chunk)."""
        window, t0 = item_seq, 0
        if self.seq_shards() > 1:
            window = self.seq_window(item_seq)
            item_seq, t0, _ = self.seq_input(window)
        t = item_seq.shape[1]
        p_hidden, p_attn, seeds = self.dropout_seeds(step)
        x = self.embed(item_seq).to(self.compute_dtype)
        x = L.prologue_ln_dropout(self.input_ln, x, p_hidden,
                                  pos=self.position_embedding[t0:t0 + t], seed=seeds[-1], t0=t0)
        lens = (window != 0).sum(1, dtype=torch.int32)
        return L.transformer_encoder_apply(
            self.encoder, x,
            lambda: L.attention_mask(window, bidirectional=not self.causal)[:, :, t0:t0 + t],
            n_heads=self.n_heads, hidden_act=self.hidden_act, hidden_dropout=p_hidden,
            attn_dropout=p_attn, seeds=seeds[:-1], lens=lens, causal=self.causal,
            last_only=last_only, select=select, mesh=self.mesh, t0=t0,
        )

    def last_position(self, item_seq_len):
        """Each row's position clip(len - 1, 0, T - 1) (JAX's ``gather_last``)."""
        return (item_seq_len.long() - 1).clamp(0, self.max_seq_len - 1)

    def forward(self, item_seq, item_seq_len, step=None):
        x = self._encode(item_seq, last_only=True, step=step)
        if self.seq_shards() > 1:
            return select_over_seq(x, self.last_position(item_seq_len), self.mesh)
        return x if x.dim() == 2 else L.gather_last(x, item_seq_len)
