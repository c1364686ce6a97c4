"""Shared building blocks of the models (counterpart of
``datamining_recblr_tpu/models/layers.py``): init helpers, dense, LN,
dropout and the last-position gather, and the post-LN transformer
encoder of SASRec and BERT4Rec with its two compositions.

Weights are ``[in, out]`` and applied as ``x @ w``; linear and embedding
weights ~ N(0, 0.02), biases zero, LayerNorm scale 1 and bias 0.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from datamining_recblr_torch.ops import fused_block as FB
from datamining_recblr_torch.ops import philox
from datamining_recblr_torch.ops.attention import fused_attention, prob_masks
from datamining_recblr_torch.ops.attention import supports as attention_supports
from datamining_recblr_torch.ops.fused_layer import MAX_LN_D, fused_ln_dropout

LN_EPS = 1e-12
INIT_STD = 0.02


def normal_init(generator, shape, std=INIT_STD, dtype=torch.float32):
    return (std * torch.randn(shape, generator=generator)).to(dtype)


def dense_init(generator, d_in, d_out, dtype=torch.float32):
    return {"w": normal_init(generator, (d_in, d_out), dtype=dtype),
            "b": torch.zeros((d_out,), dtype=dtype)}


def layer_norm_init(dim, dtype=torch.float32):
    return {"scale": torch.ones((dim,), dtype=dtype), "bias": torch.zeros((dim,), dtype=dtype)}


def dense(p, x):
    # JAX promotes a bf16 input against fp32 weights to fp32; torch's
    # matmul takes one dtype, so promote explicitly
    dt = torch.promote_types(x.dtype, p["w"].dtype)
    y = x.to(dt) @ p["w"].to(dt)
    if "b" in p:
        y = y + p["b"]
    return y


def layer_norm(p, x, eps=LN_EPS):
    """LN over the last axis, computed in fp32, returned in x's dtype."""
    dtype = x.dtype
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(dtype)


def dropout(x, rate, seed, mask_id=philox.M0):
    """Inverted dropout (torch semantics: kept units scaled by 1/(1-p))
    with the Philox mask of (seed, mask_id) over x's [B, T, W] (or
    [B, W]) coordinates, the masks the fused kernels draw
    (``ops/philox.py``); the identity at rate 0."""
    if not rate:
        return x
    b, w = x.shape[0], x.shape[-1]
    t = x[0].numel() // w if b else 0
    m = philox.dropout_mask(seed, mask_id, b, t, w, rate, x.device)
    return (x * m.reshape(x.shape)).to(x.dtype)


def gather_last(x, seq_len):
    """x: [B, T, H], seq_len: [B] -> [B, H] at position len-1, clipped
    to [0, T-1] (RecBole's ``gather_indexes``)."""
    idx = (seq_len.long() - 1).clamp(0, x.shape[1] - 1)
    return x[torch.arange(x.shape[0], device=x.device), idx]


def param_tree(tree):
    """Nested dict of tensors -> ParameterDict / ModuleDict (a list of
    such dicts -> ModuleList), so that state_dict keys are the JAX tree's
    paths."""
    if isinstance(tree, (list, tuple)):
        return nn.ModuleList([param_tree(v) for v in tree])
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({k: nn.Parameter(v) for k, v in tree.items()})
    return nn.ModuleDict({k: param_tree(v) for k, v in tree.items()})


# ---------------------------------------------------------------------------
# Transformer encoder (RecBole's TransformerEncoder, which both attention
# baselines delegate to): post-LN blocks, additive -10000 attention mask.
# ---------------------------------------------------------------------------

_ACTIVATIONS = {
    # jax.nn.gelu defaults to the tanh form; torch's to erf
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "silu": F.silu,
    "swish": F.silu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
}


def activation(name):
    return _ACTIVATIONS[name]


def transformer_encoder_init(generator, n_layers, n_heads, hidden_size, inner_size,
                             dtype=torch.float32):
    del n_heads  # the head count only shapes the forward
    return [
        {
            "q": dense_init(generator, hidden_size, hidden_size, dtype),
            "k": dense_init(generator, hidden_size, hidden_size, dtype),
            "v": dense_init(generator, hidden_size, hidden_size, dtype),
            "attn_out": dense_init(generator, hidden_size, hidden_size, dtype),
            "attn_ln": layer_norm_init(hidden_size, dtype),
            "ffn_1": dense_init(generator, hidden_size, inner_size, dtype),
            "ffn_2": dense_init(generator, inner_size, hidden_size, dtype),
            "ffn_ln": layer_norm_init(hidden_size, dtype),
        }
        for _ in range(n_layers)
    ]


# None: the fused composition wherever fused_block.supports passes, on any
# device (on the CPU through the kernels' plain versions); tests set False
# for the unfused composition, which the JAX package runs off the TPU
FORCE_FUSED_ATTENTION = None


def _use_fused_attention():
    return True if FORCE_FUSED_ATTENTION is None else bool(FORCE_FUSED_ATTENTION)


def prologue_ln_dropout(ln_params, x, dropout_p=0.0, pos=None, seed=0):
    """dropout(LN(x + pos)), the attention baselines' embedding prologue
    (``pos`` the [T, D] positional table), with the M0 mask of ``seed``.
    The fused composition (D <= 512) runs ``fused_ln_dropout`` and adds pos
    in fp32; the unfused one adds ``pos`` in x's dtype first, as the JAX
    package does."""
    if _use_fused_attention() and x.shape[-1] <= MAX_LN_D:
        if pos is None:
            pos = torch.zeros(x.shape[1:], device=x.device)
        return fused_ln_dropout(x, pos.float().contiguous(),
                                ln_params["scale"].float().contiguous(),
                                ln_params["bias"].float().contiguous(), dropout_p, seed)
    if pos is not None:
        x = x + pos.to(x.dtype)
    return dropout(layer_norm(ln_params, x), dropout_p, seed, philox.M0)


def _per_op_fused(lens, causal, dh):
    """Whether the per-op composition runs the masked softmax in
    ``fused_attention``: the fused composition is chosen, ``lens`` and
    ``causal`` are given and the kernels take heads of width ``dh``."""
    return (lens is not None and causal is not None and _use_fused_attention()
            and attention_supports(dh))


def _multi_head_attention(p, x, attn_mask, n_heads, hidden_dropout, attn_dropout, seed,
                          lens=None, causal=None):
    """Per-op attention block: LN(dropout_m1(attn(x) W_o + b_o) + x), each
    head's probabilities under the mask ``philox.prob_mask_id(h)``.  With
    ``lens`` and ``causal`` given, the fused composition chosen and heads
    that ``attention.supports`` (dh <= 256), the masked softmax, its
    dropout and P.V run in ``fused_attention`` (the JAX package's
    ``layers.py:224-241``); otherwise the softmax composition under the
    additive ``attn_mask`` [B, 1, T, T]."""
    b, t, h = x.shape
    dh = h // n_heads

    def split_heads(y):
        return y.reshape(b, t, n_heads, dh).transpose(1, 2)

    q, k, v = (split_heads(dense(p[n], x)) for n in ("q", "k", "v"))
    if _per_op_fused(lens, causal, dh):
        # q, k and v in dense's dtype: under bf16 compute with fp32
        # parameters that is fp32 (JAX promotes a bf16 x against an fp32
        # weight), bf16 only with bf16 parameters; ctx comes back in it
        ctx = fused_attention(q.contiguous(), k.contiguous(), v.contiguous(), lens, seed,
                              bool(causal), attn_dropout)
    else:
        scores = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(dh) + attn_mask
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        if attn_dropout:
            probs = (probs * prob_masks(seed, attn_dropout, b, n_heads, t, x.device)).to(x.dtype)
        dt = torch.promote_types(probs.dtype, v.dtype)
        ctx = probs.to(dt) @ v.to(dt)
    ctx = ctx.to(x.dtype).transpose(1, 2).reshape(b, t, h)
    out = dropout(dense(p["attn_out"], ctx), hidden_dropout, seed, philox.M1)
    return layer_norm(p["attn_ln"], out + x)


def flat_block_params(layer):
    """One encoder layer's parameters under the fused kernels' names, fp32
    (the parameters themselves where they are fp32 already)."""
    f32 = lambda a: a.float().contiguous()  # noqa: E731
    names = {"q": "q", "k": "k", "v": "v", "o": "attn_out"}
    flat = {}
    for short, name in names.items():
        flat[f"w_{short}"] = f32(layer[name]["w"])
        flat[f"b_{short}"] = f32(layer[name]["b"])
    flat.update(
        ln1_s=f32(layer["attn_ln"]["scale"]), ln1_b=f32(layer["attn_ln"]["bias"]),
        w1=f32(layer["ffn_1"]["w"]), b1=f32(layer["ffn_1"]["b"]),
        w2=f32(layer["ffn_2"]["w"]), b2=f32(layer["ffn_2"]["b"]),
        ln2_s=f32(layer["ffn_ln"]["scale"]), ln2_b=f32(layer["ffn_ln"]["bias"]),
    )
    return flat


def transformer_encoder_apply(layers, x, attn_mask, *, n_heads, hidden_act="gelu",
                              hidden_dropout=0.0, attn_dropout=0.0, seeds=None, lens=None,
                              causal=None, last_only=False, select=None):
    """The post-LN transformer stack; ``seeds`` holds one dropout seed per
    layer (None: dropout off).

    With ``lens`` (non-PAD counts) and ``causal`` given and the fused
    composition chosen (``FORCE_FUSED_ATTENTION``), each layer runs
    ``fused_transformer_layer`` where ``fused_block.supports`` passes;
    with ``last_only`` the top layer runs ``fused_transformer_layer_last``
    and [B, D] comes back, with ``select`` (int [B, S] positions) the top
    layer runs ``fused_transformer_layer_sel`` and [B, S, D] comes back;
    the caller must not gather again.  ``select`` needs a bidirectional
    stack (the selected-positions layer has no causal mask).  Where
    ``supports`` rejects the shape, each layer runs the per-op
    composition with ``fused_attention`` for the masked softmax (the JAX
    package's ``layers.py:297-302,363-381``) and [B, T, D] comes back.
    Without the fused composition, or with heads wider than
    ``attention.supports`` takes, the per-op one runs the softmax
    composition instead; ``attn_mask`` is its [B, 1, T, T] additive mask,
    or a function that builds it (called only then).  All draw the same
    Philox masks at the same coordinates, in the JAX package's order (the
    probabilities, after W_o, after the FFN)."""
    if seeds is None:
        hidden_dropout = attn_dropout = 0.0
        seeds = [0] * len(layers)
    if select is not None and causal:
        raise ValueError("select= requires a bidirectional stack; the selected-positions "
                         "layer has no causal mask")
    if lens is not None and causal is not None and _use_fused_attention():
        b, t, h = x.shape
        inner = layers[0]["ffn_1"]["w"].shape[1]
        if FB.supports(h, n_heads, inner, t, hidden_act):
            for li, p in enumerate(layers):
                fp = flat_block_params(p)
                drop = (hidden_dropout, attn_dropout, seeds[li])
                if last_only and li == len(layers) - 1:
                    return FB.fused_transformer_layer_last(x, lens, fp, n_heads, hidden_act,
                                                           *drop)
                if select is not None and li == len(layers) - 1:
                    return FB.fused_transformer_layer_sel(x, lens, select, fp, n_heads,
                                                          hidden_act, *drop)
                x = FB.fused_transformer_layer(x, lens, fp, bool(causal), n_heads, hidden_act,
                                               *drop)
            return x
    if not _per_op_fused(lens, causal, x.shape[-1] // n_heads) and callable(attn_mask):
        attn_mask = attn_mask()
    act = activation(hidden_act)
    for p, seed in zip(layers, seeds):
        x = _multi_head_attention(p, x, attn_mask, n_heads, hidden_dropout, attn_dropout,
                                  seed, lens, causal)
        y = dropout(dense(p["ffn_2"], act(dense(p["ffn_1"], x))), hidden_dropout, seed,
                    philox.M3)
        x = layer_norm(p["ffn_ln"], y + x)
    return x


def attention_mask(item_seq, bidirectional=False):
    """Additive attention mask [B, 1, T, T]: 0 to attend, -10000 where the
    key is PAD or, unless bidirectional, in the future."""
    t = item_seq.shape[1]
    keep = (item_seq != 0)[:, None, None, :]
    if not bidirectional:
        keep = keep & torch.tril(torch.ones((t, t), dtype=torch.bool,
                                            device=item_seq.device))[None, None]
    keep = keep.expand(item_seq.shape[0], 1, t, t)
    return torch.where(keep, 0.0, -10000.0).to(torch.float32)
