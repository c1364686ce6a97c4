"""Whole post-LN transformer encoder layer, forward: hand-written CUDA
kernels for Hopper, each beside its plain PyTorch version.

Counterpart of ``datamining_recblr_tpu/ops/fused_block.py``, the layer
both attention baselines (SASRec causal, BERT4Rec bidirectional) run:

    q,k,v = x W_q + b_q, ...                (per-head column slices)
    s_h   = q_h k_h^T / sqrt(dh) + mask     (key padding [+ causal], -10000)
    p_h   = softmax(s_h)                    (exp as fastmath.exp)
    r1    = LN1(sum_h (p_h v_h) W_o[h] + b_o + x)
    out   = LN2(act(r1 W_1 + b_1) W_2 + b_2 + r1)

Two kernels:

* ``fused_transformer_layer`` replaces ``_fwd_kernel`` (``fused_block.py:260``,
  via ``_block_fwd`` :404); ``csrc/fused_block.cu``.
* ``fused_transformer_layer_last`` replaces ``_last_fwd_kernel`` (:637, via
  ``_block_last_fwd`` :764): the same layer with one query per row, at the
  last valid position (a one-hot of ``pos == lens - 1``, so lens 0 selects
  nothing and the query comes from zeros), returning [B, D];
  ``csrc/fused_block_last.cu``.

The mask is additive -10000, never -inf: a row whose keys are all masked
(lens 0) softmaxes over all T keys.  ``lens`` is each row's count of
non-PAD items; keys at ``col >= lens`` are masked.  With bf16 x every
matmul operand (QK^T and P.V included) is rounded to bf16 and summed in
fp32, as ``_make_mm`` and ``_bmm`` do; softmax and LN stay fp32 and the
output has x's dtype.  Dropout is not ported yet (it lands with the
backward kernels): ``dropout_p`` must be 0.

On a CPU tensor a wrapper computes its plain version; on a CUDA tensor
it launches its kernel or raises.  ``launches`` on each public function
counts its kernel launches.
"""

from __future__ import annotations

import math

import torch

from datamining_recblr_torch.ops import _cuda, fastmath
from datamining_recblr_torch.ops.fused_layer import (
    _lens32,
    _ln,
    _require_cuda,
    _stream,
    no_attention_dropout,
)

MASK_VALUE = -10000.0
SUPPORTED_ACTS = ("gelu", "relu", "silu", "swish", "tanh", "sigmoid")
# the order of the kernels' parameter array (csrc/attn_common.cuh BlockParams)
PARAM_NAMES = (
    "w_q", "b_q", "w_k", "b_k", "w_v", "b_v", "w_o", "b_o",
    "ln1_s", "ln1_b", "w1", "b1", "w2", "b2", "ln2_s", "ln2_b",
)
# activation ids of the kernels (csrc/attn_common.cuh act_fwd)
_ACT_IDS = {"gelu": 0, "relu": 1, "silu": 2, "swish": 2, "tanh": 3, "sigmoid": 4}
_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)
_GELU_C = 0.044715
MAX_B = 2**31 - 1


def supports(d: int, n_heads: int, inner: int, t: int, act: str) -> bool:
    return d <= 128 and d % n_heads == 0 and inner <= 2048 and t <= 1024 \
        and act in SUPPORTED_ACTS


def act_fwd(name):
    """Forward half of ``_act_pair``: GELU in its tanh form, the logistic
    through tanh (``fastmath``)."""
    if name == "relu":
        return lambda x: torch.clamp_min(x, 0.0)
    if name in ("silu", "swish"):
        return fastmath.silu
    if name == "tanh":
        return torch.tanh
    if name == "sigmoid":
        return fastmath.sigmoid
    if name == "gelu":
        return lambda x: 0.5 * x * (1.0 + torch.tanh(
            _SQRT_2_OVER_PI * (x + _GELU_C * x * x * x)))
    raise ValueError(f"unsupported activation for fused block: {name}")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _mm(a, b, rb):
    """fp32 product; with ``rb`` both operands are rounded to bf16 first."""
    if rb:
        a, b = a.to(torch.bfloat16).float(), b.to(torch.bfloat16).float()
    return a @ b


def _pad_mask(lens, t, device):
    """[B, 1, T] additive key-padding rows: 0 where col < lens, else -10000."""
    col = torch.arange(t, device=device)[None, :]
    keep = col < lens.to(device=device, dtype=torch.long)[:, None]
    return torch.where(keep, 0.0, MASK_VALUE).to(torch.float32)[:, None, :]


def _attention(q, k, v, amask, n_heads, rb):
    """Per-head masked softmax attention; q [B, Q, D], k and v [B, T, D],
    amask broadcast to [B, Q, T] -> ctx [B, Q, D]."""
    dh = q.shape[-1] // n_heads
    scale = 1.0 / math.sqrt(dh)
    ctx = []
    for h in range(n_heads):
        sl = slice(h * dh, (h + 1) * dh)
        s = _mm(q[..., sl], k[..., sl].transpose(1, 2), rb) * scale + amask
        e = fastmath.exp(s - s.amax(-1, keepdim=True))
        ctx.append(_mm(e / e.sum(-1, keepdim=True), v[..., sl], rb))
    return torch.cat(ctx, -1)


def _tail(ctx, xres, p, act, rb):
    """Out-projection, LN1 residual, FFN and LN2 residual."""
    r1 = _ln(_mm(ctx, p["w_o"], rb) + p["b_o"] + xres, p["ln1_s"], p["ln1_b"])
    a1 = act_fwd(act)(_mm(r1, p["w1"], rb) + p["b1"])
    return _ln(_mm(a1, p["w2"], rb) + p["b2"] + r1, p["ln2_s"], p["ln2_b"])


def fused_transformer_layer_plain(x, lens, params, causal, n_heads, act="gelu",
                                  dropout_p=0.0):
    """Plain PyTorch version of ``fused_transformer_layer`` (any device)."""
    no_attention_dropout(dropout_p)
    p = params
    xf = x.float()
    rb = x.dtype == torch.bfloat16
    t = x.shape[1]
    q, k, v = (_mm(xf, p[f"w_{n}"], rb) + p[f"b_{n}"] for n in "qkv")
    amask = _pad_mask(lens, t, x.device)
    if causal:
        pos = torch.arange(t, device=x.device)
        amask = torch.minimum(amask, torch.where(pos[None, :] <= pos[:, None], 0.0,
                                                 MASK_VALUE)[None])
    return _tail(_attention(q, k, v, amask, n_heads, rb), xf, p, act, rb).to(x.dtype)


def fused_transformer_layer_last_plain(x, lens, params, n_heads, act="gelu",
                                       dropout_p=0.0):
    """Plain PyTorch version of ``fused_transformer_layer_last``: the query
    is the row at ``pos == lens - 1`` (zeros where lens is 0 or above T);
    the keys are masked by padding alone, which on that row is also the
    causal mask."""
    no_attention_dropout(dropout_p)
    p = params
    xf = x.float()
    rb = x.dtype == torch.bfloat16
    t = x.shape[1]
    pos = torch.arange(t, device=x.device)[None, :]
    sel = (pos == lens.to(device=x.device, dtype=torch.long)[:, None] - 1)
    xl = (sel.to(torch.float32)[:, :, None] * xf).sum(1, keepdim=True)  # [B, 1, D]
    q = _mm(xl, p["w_q"], rb) + p["b_q"]
    k, v = (_mm(xf, p[f"w_{n}"], rb) + p[f"b_{n}"] for n in "kv")
    ctx = _attention(q, k, v, _pad_mask(lens, t, x.device), n_heads, rb)
    return _tail(ctx, xl, p, act, rb)[:, 0].to(x.dtype)


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _param_list(x, params, n_heads, act, dropout_p):
    """Check x and the params against what the kernels take; return the
    kernels' parameter array in PARAM_NAMES order and (B, T, D, I)."""
    no_attention_dropout(dropout_p)
    if x.dim() != 3:
        raise ValueError(f"x must be [B, T, D], got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    b, t, d = x.shape
    inner = params["w1"].shape[1]
    if not supports(d, n_heads, inner, t, act) or not 1 <= b <= MAX_B:
        raise ValueError(
            f"unsupported shape B={b} T={t} D={d} heads={n_heads} inner={inner} "
            f"act={act}: the kernels take D <= 128, D % heads == 0, inner <= 2048, "
            f"T <= 1024 and act in {SUPPORTED_ACTS}; the JAX package runs its "
            f"fused_attention kernel there (ROADMAP.md queue B row 15, not ported)"
        )
    want = {"w_q": (d, d), "w_k": (d, d), "w_v": (d, d), "w_o": (d, d),
            "w1": (d, inner), "b1": (inner,), "w2": (inner, d)}
    plist = []
    for name in PARAM_NAMES:
        v = params[name]
        shape = want.get(name, (d,))
        if v.dtype != torch.float32 or not v.is_contiguous() \
                or v.device != x.device or tuple(v.shape) != shape:
            raise ValueError(
                f"param {name}: want contiguous float32 {shape} on {x.device}, got "
                f"{v.dtype} {tuple(v.shape)} on {v.device}"
            )
        plist.append(v)
    return plist, (b, t, d, inner)


def fused_transformer_layer(x, lens, params, causal, n_heads, act="gelu", dropout_p=0.0):
    """Complete post-LN transformer encoder layer forward.  x: [B, T, D];
    lens: int [B] non-PAD counts (keys at col >= lens are masked); params
    (all fp32): w_q/w_k/w_v/w_o [D, D], b_q/b_k/b_v/b_o [D], ln1_s/ln1_b
    [D], w1 [D, I], b1 [I], w2 [I, D], b2 [D], ln2_s/ln2_b [D]; causal adds
    the lower-triangular mask.  Returns [B, T, D] in x's dtype."""
    if x.device.type == "cpu":
        return fused_transformer_layer_plain(x, lens, params, causal, n_heads, act,
                                             dropout_p)
    _require_cuda(x)
    plist, (b, t, d, inner) = _param_list(x, params, n_heads, act, dropout_p)
    lens32 = _lens32(lens, x)
    lib = _cuda.library("fused_block.cu")
    out = torch.empty_like(x)
    qkv = torch.empty((b, t, 3 * d), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = lib.recblr_block_fwd(
            x.data_ptr(), lens32.data_ptr(), out.data_ptr(), _cuda.pointer_array(plist),
            qkv.data_ptr(), b, t, d, n_heads, inner, int(bool(causal)), _ACT_IDS[act],
            1.0 / math.sqrt(d // n_heads), int(x.dtype == torch.bfloat16),
            x.device.index, _stream(x),
        )
    _cuda.check(lib, err, "fused_transformer_layer")
    fused_transformer_layer.launches += 1
    return out


def fused_transformer_layer_last(x, lens, params, n_heads, act="gelu", dropout_p=0.0):
    """Top transformer layer forward at each row's last valid position
    only; valid for a causal stack (the last row's causal mask is its
    padding mask) and a bidirectional one.  x: [B, T, D]; lens: int [B]
    (0 or above T selects nothing); params as for
    ``fused_transformer_layer``.  Returns [B, D] in x's dtype."""
    if x.device.type == "cpu":
        return fused_transformer_layer_last_plain(x, lens, params, n_heads, act, dropout_p)
    _require_cuda(x)
    plist, (b, t, d, inner) = _param_list(x, params, n_heads, act, dropout_p)
    lens32 = _lens32(lens, x)
    lib = _cuda.library("fused_block_last.cu")
    out = torch.empty((b, d), device=x.device, dtype=x.dtype)
    kv = torch.empty((b, t, 2 * d), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = lib.recblr_block_last_fwd(
            x.data_ptr(), lens32.data_ptr(), out.data_ptr(), _cuda.pointer_array(plist),
            kv.data_ptr(), b, t, d, n_heads, inner, _ACT_IDS[act],
            1.0 / math.sqrt(d // n_heads), int(x.dtype == torch.bfloat16),
            x.device.index, _stream(x),
        )
    _cuda.check(lib, err, "fused_transformer_layer_last")
    fused_transformer_layer_last.launches += 1
    return out


fused_transformer_layer.launches = 0
fused_transformer_layer_last.launches = 0
