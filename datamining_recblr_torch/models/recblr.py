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
per layer plus one for the prologue, as the JAX model draws them
(``recblr.py:303-311``); on a mesh each is offset by the data index
(``SequentialModel.step_seeds``).  The input dropout takes layer 0's
seed where layer 0's kernel takes the prologue (two layers or more),
else the prologue's, in every composition, so all draw the same masks.

Two compositions, chosen by configuration as in the JAX package
(``_use_fused_layer``, ``_use_chunked_layer``, ``recblr.py:204-237``):

* fused (D <= 128, C <= 128, ``use_pallas_scan`` not "never"; T <= 512,
  where the kernels take d_conv up to min(T, 64) and raise beyond, or
  T > 512 with a chunk from ``pick_chunk(T)`` of at least max(8, d_conv)
  and d_conv <= 8): layer 0 .. N-2 run ``fused_recurrent_layer``, or
  beyond T = 512 the sequence-chunked ``fused_recurrent_layer_chunked``
  (layer 0 with the input dropout and LN folded in); the top layer runs
  ``fused_recurrent_layer_last`` up to T = 1,024, and beyond it the
  chunked layer and a gather at each row's last position (length 0 reads
  position 0).  A one-layer model runs ``fused_dropout_ln`` (the input
  dropout and LN) and then the top layer, as the JAX package does
  (``recblr.py:328-346``).  All are differentiable through their backward
  kernels.
* unfused (everything else: C > 128, T > 512 with no chunk or with
  d_conv > 8): the per-op composition of ``_gated_recurrent`` and
  ``_ffn`` in plain PyTorch, differentiated by autograd, around one
  kernel a layer as in ``recblr.py:122-176``: with C <= 128
  ``fused_bdlru`` (conv, gates and
  scan, forward and backward), beyond it ``linear_scan`` (the scan, its
  backward the kernel's reverse mode), and with ``use_pallas_scan:
  never`` the serial plain scan.  On a CPU tensor the kernels' plain
  versions run.

On a mesh with a ``seq`` axis of S > 1 (sequence parallelism, the JAX
package's ``_seq_shards() > 1``) the unfused composition runs whatever
the shapes, on this rank's time chunk [t0, t0 + T/S): the causal conv
takes the K-1 positions before the chunk from the earlier ranks
(``conv_halo``), the recurrence is ``seq_parallel_scan`` (two local scans
through ``linear_scan``, row 7 on the card, and a carry exchanged over
``seq``), the dropout masks are drawn at the chunk's global positions,
and the top layer reads h, z and the residual at each row's last
position on the rank that holds it (``select_over_seq``); its tail then
runs on [B, 1, D], the same on every seq rank.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from datamining_recblr_torch.models import layers as L
from datamining_recblr_torch.models.base import SequentialModel
from datamining_recblr_torch.ops.conv import causal_depthwise_conv
from datamining_recblr_torch.ops import philox
from datamining_recblr_torch.ops.fused_bdlru import fused_bdlru, softplus
from datamining_recblr_torch.ops.fused_bdlru import supports as bdlru_supports
from datamining_recblr_torch.ops.fused_layer import (
    fused_dropout_ln,
    fused_recurrent_layer,
    fused_recurrent_layer_last,
    supports,
)
from datamining_recblr_torch.ops.fused_layer_chunked import (
    chunk_of,
    fused_recurrent_layer_chunked,
)
from datamining_recblr_torch.ops.scan import linear_scan, linear_scan_serial
from datamining_recblr_torch.ops.seq_parallel_scan import seq_parallel_scan
from datamining_recblr_torch.parallel.collectives import conv_halo, select_over_seq

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
        self.item_embedding = nn.Parameter(self.init_table(gen, self.n_items, d, dt))
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
            and self.seq_shards() == 1
        )

    def use_chunked_layer(self) -> bool:
        """The long-context composition (the JAX package's
        ``_use_chunked_layer``): T > 512 in chunks of ``pick_chunk(T)``."""
        return (
            self.scan_impl != "xla"
            and supports(self.hidden_size, self.inner_hidden)
            and self.max_seq_len > MAX_WHOLE_T
            and chunk_of(self.max_seq_len, self.d_conv) > 0
            and self.seq_shards() == 1
        )

    def use_fused_bdlru(self) -> bool:
        """Whether the unfused composition runs ``fused_bdlru`` (C <= 128)
        rather than ``linear_scan`` or, with "never", the serial scan."""
        return (self.scan_impl != "xla" and bdlru_supports(self.inner_hidden)
                and self.seq_shards() == 1)

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
    def _at(self, idx, *vs):
        """Each [B, T', W] tensor of ``vs`` at row b's position ``idx[b]`` ->
        [B, 1, W]; under ``seq`` the tensors are this rank's chunk and
        ``idx`` global, read in one ``select_over_seq``."""
        if self.seq_shards() > 1:
            widths = [v.shape[-1] for v in vs]
            return select_over_seq(torch.cat(vs, dim=-1), idx, self.mesh)[:, None].split(
                widths, dim=-1)
        rows = torch.arange(idx.shape[0], device=idx.device)
        return tuple(v[rows, idx][:, None] for v in vs)

    def _gated_recurrent(self, p, x, last=None):
        """Gated BD-LRU block of the unfused composition.  With ``last``
        (top layer: each row's last position, ``_last_index``) the output
        projection runs only there -> [B, 1, D]."""
        xz = x @ p["w_in"].to(x.dtype)
        xb, z = xz.chunk(2, dim=-1)
        if self.use_fused_bdlru():
            # conv, gates and scan in one kernel: xb and h in the compute
            # dtype, fp32 inside
            f32 = lambda a: a.float().contiguous()  # noqa: E731
            h = fused_bdlru(xb.contiguous(), f32(p["conv_w"]), f32(p["conv_b"]),
                            f32(p["w_gates"]), f32(p["b_gates"]), f32(p["Lambda"]),
                            not self.disable_conv1d)
        else:
            seq = self.seq_shards() > 1
            if not self.disable_conv1d:
                halo = conv_halo(xb, self.d_conv, self.mesh) if seq else None
                xb = F.silu(causal_depthwise_conv(
                    xb, p["conv_w"].to(xb.dtype), p["conv_b"].to(xb.dtype), halo
                ))
            # gates and scan in fp32
            xb32 = xb.float()
            g = xb32 @ p["w_gates"].float() + p["b_gates"].float()
            rec, inp = g.chunk(2, dim=-1)
            alpha = torch.exp(-softplus(p["Lambda"].float()) * torch.sigmoid(rec))
            beta = torch.sqrt(1.0 - alpha.square() + 1e-8) * torch.sigmoid(inp)
            gates, tokens = alpha.contiguous(), (beta * xb32).contiguous()
            if seq:
                h = seq_parallel_scan(gates, tokens, self.mesh, impl=self.scan_impl)
            else:
                scan = linear_scan if self.scan_impl != "xla" else linear_scan_serial
                h = scan(gates, tokens)
            h = h.to(x.dtype)
        if last is not None:
            h, z = self._at(last, h, z)
        return (F.silu(z) * h) @ p["w_out"].to(x.dtype)

    def _ffn(self, p, x, p_drop, seed, t0=0):
        y = F.silu(L.dense(p["w1"], x))
        y = L.dropout(y, p_drop, seed, philox.M2, t0)
        y = L.dropout(L.dense(p["w2"], y), p_drop, seed, philox.M3, t0)
        return L.layer_norm(p["ln"], y + x)

    def dropout_seeds(self, step):
        """(p, seeds): the dropout rate and one seed per layer plus one
        for the input dropout; p = 0 outside training with a step."""
        n = len(self.layers) + 1
        if not (self.training and step is not None and self.dropout_prob):
            return 0.0, [0] * n
        return self.dropout_prob, self.step_seeds(step, n)

    def forward(self, item_seq, item_seq_len, step=None):
        t0, t = 0, item_seq.shape[1]
        if self.seq_shards() > 1:
            item_seq, t0, t = self.seq_input(item_seq)
        x = self.embed(item_seq).to(self.compute_dtype)
        n_layers = len(self.layers)
        p_drop, seeds = self.dropout_seeds(step)
        chunked = self.use_chunked_layer()
        if self.use_fused_layer() or chunked:
            use_conv = not self.disable_conv1d
            use_ffn = not self.disable_ffn
            layer_fn = fused_recurrent_layer_chunked if chunked else fused_recurrent_layer
            if n_layers < 2:
                # the top layer kernel has no prologue: the input dropout
                # and LN run first, as one kernel
                pro = self.prologue_params()
                x = fused_dropout_ln(x, pro["pl_s"], pro["pl_b"], p_drop, seeds[-1])
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

        # the fused compositions' masks: the input dropout under layer 0's
        # seed where its kernel takes the prologue (two layers or more);
        # at global positions, t0 on a seq rank's chunk and 0 after the
        # top layer's selection ([B, 1, D])
        pro_seed = seeds[0] if n_layers >= 2 else seeds[-1]
        x = L.layer_norm(self.input_ln, L.dropout(x, p_drop, pro_seed, philox.M0, t0))
        if not n_layers:
            return self._at((item_seq_len.long() - 1).clamp(0, t - 1), x)[0][:, 0]
        for li, layer in enumerate(self.layers):
            last = _last_index(item_seq_len, t) if li == n_layers - 1 else None
            h = self._gated_recurrent(layer["grl"], x, last)
            if last is not None:
                (x,) = self._at(last, x)
                t0 = 0
            h = L.dropout(h, p_drop, seeds[li], philox.M1, t0)
            x = L.layer_norm(layer["ln"], h + x)
            if not self.disable_ffn:
                x = self._ffn(layer["ffn"], x, p_drop, seeds[li], t0)
        return x[:, 0]
