"""RecBLR: Behavior-Dependent Linear Recurrent Unit recommender, as an
``nn.Module`` (counterpart of ``datamining_recblr_tpu/models/recblr.py``).

item embedding -> dropout -> LayerNorm -> N x (gated BD-LRU recurrent
block [+ FFN]) -> last-position output [B, D].

Parameters carry the names and layouts of the JAX ``init_params``
(``[in, out]`` weights, ``x @ w``, [B, T, C] activations), so
``interop.params_from_jax`` is a dtype and device move.

Dropout (``dropout_prob``) is on in training mode when ``forward`` gets
the global step: the masks are Philox draws whose seeds are a function
of (config seed, step, layer) alone (``ops/philox.py:step_seeds``), one
per layer plus one for the input dropout, as the JAX model draws one
seed per layer plus one for the prologue (``recblr.py:303-311``).

Two compositions, chosen by configuration as in the JAX package
(``_use_fused_layer``, ``_use_chunked_layer``, ``recblr.py:204-237``):

* fused (D <= 128, C <= 128, ``use_pallas_scan`` not "never"; T <= 512,
  or T > 512 with a chunk from ``pick_chunk(T)`` of at least max(8,
  d_conv) and d_conv <= 8): layer 0 .. N-2 run ``fused_recurrent_layer``,
  or beyond T = 512 the sequence-chunked ``fused_recurrent_layer_chunked``
  (layer 0 with the input dropout and LN folded in); the top layer runs
  ``fused_recurrent_layer_last`` up to T = 1,024, and beyond it the
  chunked layer and a gather at each row's last position (length 0 reads
  position 0).  All are differentiable through their backward kernels.
  A one-layer model applies the input dropout and LN in plain PyTorch
  first, where the JAX package calls its standalone ``fused_dropout_ln``
  kernel (not ported yet).
* unfused (everything else): the per-op composition of
  ``_gated_recurrent`` and ``_ffn``, differentiated by autograd.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from datamining_recblr_torch.models import layers as L
from datamining_recblr_torch.models.base import SequentialModel
from datamining_recblr_torch.ops.conv import causal_depthwise_conv
from datamining_recblr_torch.ops.fused_bdlru import softplus
from datamining_recblr_torch.ops import philox
from datamining_recblr_torch.ops.fused_layer import (
    fused_recurrent_layer,
    fused_recurrent_layer_last,
    supports,
)
from datamining_recblr_torch.ops.fused_layer_chunked import (
    chunk_of,
    fused_recurrent_layer_chunked,
)
from datamining_recblr_torch.ops.scan import linear_scan_serial

MAX_WHOLE_T = 512  # the whole-sequence layer kernel's T (recblr.py:204-215)
MAX_LAST_T = 1024  # the top layer's last-position kernel's T (recblr.py:336)


def _softplus_inverse(x: float) -> float:
    return math.log(math.exp(x) - 1.0)


def lambda_init(hidden: int, r_min: float = 0.9, r_max: float = 0.999):
    """Decay-rate init: linspace in softplus-inverse space so that
    ``exp(-softplus(Lambda))`` spans [r_min, r_max] across channels."""
    lo = _softplus_inverse(-math.log(r_min))
    hi = _softplus_inverse(-math.log(r_max))
    return torch.linspace(lo, hi, hidden, dtype=torch.float32)


def _last_index(lens, t):
    # JAX's take_along_axis wraps a negative index, so length 0 reads
    # position T-1 on the unfused path
    idx = lens.long() - 1
    return torch.where(idx < 0, idx + t, idx)


class RecBLR(SequentialModel):
    def __init__(self, config, n_items, max_seq_len, device=None, generator=None):
        super().__init__(config, n_items, max_seq_len, device=device)
        self.hidden_size = config["hidden_size"]
        self.num_layers = config["num_layers"]
        self.dropout_prob = float(config["dropout_prob"] or 0.0)
        self.expand = config["expand"]
        self.d_conv = config["d_conv"]
        self.bd_lru_only = bool(config["bd_lru_only"])
        self.disable_conv1d = bool(config["disable_conv1d"]) or self.bd_lru_only
        self.disable_ffn = bool(config["disable_ffn"]) or self.bd_lru_only
        self.inner_hidden = int(self.hidden_size * self.expand)
        self.scan_impl = {"auto": "auto", "always": "pallas", "never": "xla"}[
            str(config.get("use_pallas_scan", "auto"))
        ]
        if generator is None:
            generator = torch.Generator().manual_seed(int(config.get("seed", 0) or 0))
        self._init_params(generator)
        self.to(self.device)

    def _init_params(self, gen):
        """Parameter tree of the JAX ``init_params``, drawn from ``gen``."""
        d, h, k = self.hidden_size, self.inner_hidden, self.d_conv
        dt = self.param_dtype
        emb = L.normal_init(gen, (self.n_items_padded, d), dtype=dt)
        emb[0] = 0.0  # padding_idx = 0
        self.item_embedding = nn.Parameter(emb)
        self.input_ln = L.param_tree(L.layer_norm_init(d, dt))
        conv_bound = 1.0 / math.sqrt(k)

        def uniform(shape):
            return ((2 * torch.rand(shape, generator=gen) - 1) * conv_bound).to(dt)

        layers = []
        for _ in range(self.num_layers):
            layer = {
                "grl": {
                    "w_in": L.normal_init(gen, (d, 2 * h), dtype=dt),
                    "conv_w": uniform((k, h)),
                    "conv_b": uniform((h,)),
                    "w_gates": L.normal_init(gen, (h, 2 * h), dtype=dt),
                    "b_gates": torch.zeros((2 * h,), dtype=dt),
                    "Lambda": lambda_init(h),
                    "w_out": L.normal_init(gen, (h, d), dtype=dt),
                },
                "ln": L.layer_norm_init(d, dt),
            }
            if not self.disable_ffn:
                layer["ffn"] = {
                    "w1": L.dense_init(gen, d, 4 * d, dtype=dt),
                    "w2": L.dense_init(gen, 4 * d, d, dtype=dt),
                    "ln": L.layer_norm_init(d, dt),
                }
            layers.append(L.param_tree(layer))
        self.layers = nn.ModuleList(layers)

    # ------------------------------------------------------------------
    def use_fused_layer(self) -> bool:
        return (
            self.scan_impl != "xla"
            and supports(self.hidden_size, self.inner_hidden)
            and self.max_seq_len <= MAX_WHOLE_T
        )

    def use_chunked_layer(self) -> bool:
        """The long-context composition (the JAX package's
        ``_use_chunked_layer``): T > 512 in chunks of ``pick_chunk(T)``."""
        return (
            self.scan_impl != "xla"
            and supports(self.hidden_size, self.inner_hidden)
            and self.max_seq_len > MAX_WHOLE_T
            and chunk_of(self.max_seq_len, self.d_conv) > 0
        )

    def use_last_layer_kernel(self) -> bool:
        """Whether the top layer of the fused compositions runs
        ``fused_recurrent_layer_last`` (T <= 1,024) or the chunked layer
        and a gather."""
        return self.max_seq_len <= MAX_LAST_T

    @staticmethod
    def flat_layer_params(layer, use_ffn):
        """One layer's parameters under the fused kernels' names, fp32
        (the parameters themselves where they are fp32 already, so the
        kernels' gradients reach them)."""
        grl = layer["grl"]
        f32 = lambda a: a.float().contiguous()  # noqa: E731
        flat = {
            "w_in": f32(grl["w_in"]),
            "wc": f32(grl["conv_w"]),
            "bc": f32(grl["conv_b"]),
            "wg": f32(grl["w_gates"]),
            "bg": f32(grl["b_gates"]),
            "lam": f32(grl["Lambda"]),
            "w_out": f32(grl["w_out"]),
            "ln1_s": f32(layer["ln"]["scale"]),
            "ln1_b": f32(layer["ln"]["bias"]),
        }
        if use_ffn:
            ffn = layer["ffn"]
            flat.update(
                w1=f32(ffn["w1"]["w"]), b1=f32(ffn["w1"]["b"]),
                w2=f32(ffn["w2"]["w"]), b2=f32(ffn["w2"]["b"]),
                ln2_s=f32(ffn["ln"]["scale"]), ln2_b=f32(ffn["ln"]["bias"]),
            )
        return flat

    def prologue_params(self):
        return {
            "pl_s": self.input_ln["scale"].float().contiguous(),
            "pl_b": self.input_ln["bias"].float().contiguous(),
        }

    # ------------------------------------------------------------------
    def _gated_recurrent(self, p, x, lens=None):
        """Gated BD-LRU block of the unfused composition.  With ``lens``
        (top layer) the output projection runs only at each row's last
        position -> [B, 1, D]."""
        xz = x @ p["w_in"].to(x.dtype)
        xb, z = xz.chunk(2, dim=-1)
        if not self.disable_conv1d:
            xb = F.silu(causal_depthwise_conv(
                xb, p["conv_w"].to(xb.dtype), p["conv_b"].to(xb.dtype)
            ))
        # gates and scan in fp32
        xb32 = xb.float()
        g = xb32 @ p["w_gates"].float() + p["b_gates"].float()
        rec, inp = g.chunk(2, dim=-1)
        alpha = torch.exp(-softplus(p["Lambda"].float()) * torch.sigmoid(rec))
        beta = torch.sqrt(1.0 - alpha.square() + 1e-8) * torch.sigmoid(inp)
        h = linear_scan_serial(alpha, beta * xb32).to(x.dtype)
        if lens is not None:
            rows = torch.arange(x.shape[0], device=x.device)
            idx = _last_index(lens, x.shape[1])
            h = h[rows, idx][:, None]
            z = z[rows, idx][:, None]
        return (F.silu(z) * h) @ p["w_out"].to(x.dtype)

    def _ffn(self, p, x, p_drop, seed):
        y = F.silu(L.dense(p["w1"], x))
        y = L.dropout(y, p_drop, seed, philox.M2)
        y = L.dropout(L.dense(p["w2"], y), p_drop, seed, philox.M3)
        return L.layer_norm(p["ln"], y + x)

    def dropout_seeds(self, step):
        """(p, seeds): the dropout rate and one seed per layer plus one
        for the input dropout; p = 0 outside training with a step."""
        n = len(self.layers) + 1
        if not (self.training and step is not None and self.dropout_prob):
            return 0.0, [0] * n
        return self.dropout_prob, philox.step_seeds(self.seed, step, n)

    def forward(self, item_seq, item_seq_len, step=None):
        x = self.embed(item_seq).to(self.compute_dtype)
        n_layers = len(self.layers)
        p_drop, seeds = self.dropout_seeds(step)
        chunked = self.use_chunked_layer()
        if self.use_fused_layer() or chunked:
            use_conv = not self.disable_conv1d
            use_ffn = not self.disable_ffn
            layer_fn = fused_recurrent_layer_chunked if chunked else fused_recurrent_layer
            if n_layers < 2:
                x = L.layer_norm(self.input_ln, L.dropout(x, p_drop, seeds[-1]))
            for li, layer in enumerate(self.layers):
                flat = self.flat_layer_params(layer, use_ffn)
                if li == n_layers - 1 and self.use_last_layer_kernel():
                    return fused_recurrent_layer_last(
                        x, item_seq_len, flat, use_conv, use_ffn, p_drop, seeds[li]
                    )
                pro = li == 0 and n_layers >= 2
                if pro:
                    flat.update(self.prologue_params())
                x = layer_fn(x, flat, use_conv, use_ffn, pro, p_drop, seeds[li])
            return L.gather_last(x, item_seq_len)

        x = L.layer_norm(self.input_ln, L.dropout(x, p_drop, seeds[-1]))
        for li, layer in enumerate(self.layers):
            last = li == n_layers - 1
            h = self._gated_recurrent(
                layer["grl"], x, lens=item_seq_len if last else None
            )
            if last:
                rows = torch.arange(x.shape[0], device=x.device)
                x = x[rows, _last_index(item_seq_len, x.shape[1])][:, None]
            h = L.dropout(h, p_drop, seeds[li], philox.M1)
            x = L.layer_norm(layer["ln"], h + x)
            if not self.disable_ffn:
                x = self._ffn(layer["ffn"], x, p_drop, seeds[li])
        return x[:, 0] if n_layers else L.gather_last(x, item_seq_len)
