"""Whole post-LN transformer encoder layer, forward and backward:
hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.

Counterpart of ``datamining_recblr_tpu/ops/fused_block.py``, the layer
both attention baselines (SASRec causal, BERT4Rec bidirectional) run:

    q,k,v = x W_q + b_q, ...                (per-head column slices)
    s_h   = q_h k_h^T / sqrt(dh) + mask     (key padding [+ causal], -10000)
    p_h   = dropout_{4+h}(softmax(s_h))     (exp as fastmath.exp)
    r1    = LN1(dropout_m1(sum_h (p_h v_h) W_o[h] + b_o) + x)
    out   = LN2(dropout_m3(act(r1 W_1 + b_1) W_2 + b_2) + r1)

Six kernels:

* ``fused_transformer_layer`` replaces ``_fwd_kernel`` (``fused_block.py:260``,
  via ``_block_fwd`` :404); ``csrc/fused_block.cu``.
* its backward, ``fused_transformer_layer_bwd``, replaces ``_bwd_kernel``
  (:284, via ``_block_bwd`` :456), causal and bidirectional;
  ``csrc/fused_block_bwd.cu``.
* ``fused_transformer_layer_last`` replaces ``_last_fwd_kernel`` (:637, via
  ``_block_last_fwd`` :764): the same layer with one query per row, at the
  last valid position (a one-hot of ``pos == lens - 1``, so lens 0 selects
  nothing and the query comes from zeros), returning [B, D];
  ``csrc/fused_block_last.cu``.
* its backward, ``fused_transformer_layer_last_bwd``, replaces
  ``_last_bwd_kernel`` (:655, via ``_block_last_bwd`` :803);
  ``csrc/fused_block_last_bwd.cu``.
* ``fused_transformer_layer_sel`` replaces ``_sel_fwd_kernel`` (:968, via
  ``_block_sel_fwd`` :1125): the bidirectional layer with queries at the
  positions ``sel_idx [B, S]`` only (BERT4Rec's cloze positions; repeats
  allowed), returning [B, S, D]; ``csrc/fused_block_sel.cu``.
* its backward, ``fused_transformer_layer_sel_bwd``, replaces
  ``_sel_bwd_kernel`` (:995, via ``_block_sel_bwd`` :1184), with the
  query and residual cotangents of repeated positions added into dx;
  ``csrc/fused_block_sel_bwd.cu``.

The mask is additive -10000, never -inf: a row whose keys are all masked
(lens 0) softmaxes over all T keys.  ``lens`` is each row's count of
non-PAD items; keys at ``col >= lens`` are masked.  With bf16 x every
matmul operand (QK^T and P.V included) is rounded to bf16 and summed in
fp32, as ``_make_mm`` and ``_bmm`` do; softmax and LN stay fp32 and the
output has x's dtype.  In the backward the forward's operands are read
rounded in the same way and every gradient stays fp32 (the plain
versions round through ``_RoundBF16``, whose gradient passes unrounded);
dx has x's dtype and every weight grad is fp32.

Dropout: ``hidden_dropout_p`` on the W_o output (mask M1) and the FFN
output (M3), ``attn_dropout_p`` on each head's probabilities (mask
``philox.prob_mask_id(h)``, the key index as the channel), Philox draws
keyed by the call's ``seed`` (``ops/philox.py``).  The softmax backward
uses the undropped probabilities, ``ds = p (dp - sum dp p)`` with
``dp = dpd m``.  The last-query layer keys its masks by each row's
position ``lens - 1`` (0 where nothing is selected), the
selected-positions layer by each selected position.

A training forward keeps the [B, T, 3D] (last, sel: [B, T, 2D]) fp32
projections it computes anyway and the attention context [B, T, D]
(last: [B, D]; sel: [B, S, D], with the [B, S, D] queries) fp32 for the
backward, which recomputes the scores and the layer's tail from them.

On a CPU tensor a wrapper computes its plain version (autograd gives
the plain backward); on a CUDA tensor it launches its kernel or raises,
and with grad enabled it runs a ``torch.autograd.Function`` whose
backward is the backward kernel.  ``launches`` on each of the six
public functions counts its kernel launches.
"""

from __future__ import annotations

import math

import torch

from datamining_recblr_torch.ops import _cuda, fastmath, philox
from datamining_recblr_torch.ops.fused_layer import (
    _check_dout,
    _dropout_args,
    _grad_blocks,
    _lens32,
    _ln,
    _needs_grad,
    _require_cuda,
    _stream,
)

MASK_VALUE = -10000.0
SUPPORTED_ACTS = ("gelu", "relu", "silu", "swish", "tanh", "sigmoid")
# the order of the kernels' parameter array (csrc/attn_common.cuh
# BlockParams) and of their flat weight-grad output
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

class _RoundBF16(torch.autograd.Function):
    """A matmul operand rounded to bf16 whose gradient passes unrounded:
    the kernels round an operand as they read it and keep every gradient
    in fp32."""

    @staticmethod
    def forward(ctx, a):
        return a.to(torch.bfloat16).to(a.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


def _mm(a, b, rb):
    """fp32 product; with ``rb`` both operands are rounded to bf16 first."""
    if rb:
        a, b = _RoundBF16.apply(a), _RoundBF16.apply(b)
    return a @ b


def _pad_mask(lens, t, device):
    """[B, 1, T] additive key-padding rows: 0 where col < lens, else -10000."""
    col = torch.arange(t, device=device)[None, :]
    keep = col < lens.to(device=device, dtype=torch.long)[:, None]
    return torch.where(keep, 0.0, MASK_VALUE).to(torch.float32)[:, None, :]


def _attention(q, k, v, amask, n_heads, rb, prob_masks=None):
    """Per-head masked softmax attention; q [B, Q, D], k and v [B, T, D],
    amask broadcast to [B, Q, T], prob_masks (dropout) one [B, Q, T] per
    head or None -> ctx [B, Q, D]."""
    dh = q.shape[-1] // n_heads
    scale = 1.0 / math.sqrt(dh)
    ctx = []
    for h in range(n_heads):
        sl = slice(h * dh, (h + 1) * dh)
        s = _mm(q[..., sl], k[..., sl].transpose(1, 2), rb) * scale + amask
        e = fastmath.exp(s - s.amax(-1, keepdim=True))
        pr = e / e.sum(-1, keepdim=True)
        if prob_masks is not None:
            pr = pr * prob_masks[h]
        ctx.append(_mm(pr, v[..., sl], rb))
    return torch.cat(ctx, -1)


def _tail(ctx, xres, p, act, rb, m1=None, m3=None):
    """Out-projection, LN1 residual, FFN and LN2 residual; m1, m3 the
    dropout masks (None: none)."""
    ao = _mm(ctx, p["w_o"], rb) + p["b_o"]
    r1 = _ln((ao if m1 is None else ao * m1) + xres, p["ln1_s"], p["ln1_b"])
    a1 = act_fwd(act)(_mm(r1, p["w1"], rb) + p["b1"])
    f2 = _mm(a1, p["w2"], rb) + p["b2"]
    return _ln((f2 if m3 is None else f2 * m3) + r1, p["ln2_s"], p["ln2_b"])


def _layer_masks(hidden_p, attn_p, seed, n_heads, b, t, d, device, pos=None):
    """(m1, m3, prob masks) of one layer, None where the rate is 0.
    Without ``pos``: m1, m3 [B, T, D] and prob masks [B, T, T]; with
    ``pos`` [B] (the last-query layer): row b at position pos[b], m1, m3
    [B, 1, D] and prob masks [B, 1, T]; with ``pos`` [B, S] (the
    selected-positions layer): [B, S, D] and [B, S, T]."""
    def mask(mask_id, p, width):
        if pos is None:
            return philox.dropout_mask(seed, mask_id, b, t, width, p, device)
        m = philox.dropout_mask_at(seed, mask_id, pos, width, p)
        return m[:, None, :] if pos.dim() == 1 else m

    m1 = m3 = probs = None
    if hidden_p:
        m1, m3 = mask(philox.M1, hidden_p, d), mask(philox.M3, hidden_p, d)
    if attn_p:
        probs = [mask(philox.prob_mask_id(h), attn_p, t) for h in range(n_heads)]
    return m1, m3, probs


def last_positions(lens, t):
    """[B] long: each row's query position lens - 1, 0 where the length
    selects nothing (0 or above T): the coordinates of the last-query
    layer's masks."""
    lens = lens.long()
    return torch.where((lens >= 1) & (lens <= t), lens - 1, torch.zeros_like(lens))


def fused_transformer_layer_plain(x, lens, params, causal, n_heads, act="gelu",
                                  hidden_dropout_p=0.0, attn_dropout_p=0.0, seed=0):
    """Plain PyTorch version of ``fused_transformer_layer`` (any device;
    differentiable, and its autograd gradient is the plain version of
    ``fused_transformer_layer_bwd``)."""
    p = params
    xf = x.float()
    rb = x.dtype == torch.bfloat16
    b, t, d = x.shape
    m1, m3, probs = _layer_masks(hidden_dropout_p, attn_dropout_p, seed, n_heads, b, t, d,
                                 x.device)
    q, k, v = (_mm(xf, p[f"w_{n}"], rb) + p[f"b_{n}"] for n in "qkv")
    amask = _pad_mask(lens, t, x.device)
    if causal:
        pos = torch.arange(t, device=x.device)
        amask = torch.minimum(amask, torch.where(pos[None, :] <= pos[:, None], 0.0,
                                                 MASK_VALUE)[None])
    ctx = _attention(q, k, v, amask, n_heads, rb, probs)
    return _tail(ctx, xf, p, act, rb, m1, m3).to(x.dtype)


def sel_positions(sel_idx, t):
    """[B, S] long: the selected positions, clamped into [0, T - 1] (the
    kernels never read outside the row); the coordinates of the
    selected-positions layer's queries and masks."""
    return sel_idx.long().clamp(0, t - 1)


def fused_transformer_layer_sel_plain(x, lens, sel_idx, params, n_heads, act="gelu",
                                      hidden_dropout_p=0.0, attn_dropout_p=0.0, seed=0):
    """Plain PyTorch version of ``fused_transformer_layer_sel``: queries and
    the residual at the positions ``sel_idx [B, S]`` (repeats allowed),
    keys and values over all T, masked by padding alone (bidirectional);
    masks keyed by each selected position.  Differentiable; its autograd
    gradient (the gather's backward adds the cotangents of repeated
    positions) is the plain version of ``fused_transformer_layer_sel_bwd``."""
    p = params
    xf = x.float()
    rb = x.dtype == torch.bfloat16
    b, t, d = x.shape
    pos = sel_positions(sel_idx, t).to(x.device)
    m1, m3, probs = _layer_masks(hidden_dropout_p, attn_dropout_p, seed, n_heads, b, t, d,
                                 x.device, pos=pos)
    xq = torch.gather(xf, 1, pos[..., None].expand(-1, -1, d))  # [B, S, D]
    q = _mm(xq, p["w_q"], rb) + p["b_q"]
    k, v = (_mm(xf, p[f"w_{n}"], rb) + p[f"b_{n}"] for n in "kv")
    ctx = _attention(q, k, v, _pad_mask(lens, t, x.device), n_heads, rb, probs)
    return _tail(ctx, xq, p, act, rb, m1, m3).to(x.dtype)


def fused_transformer_layer_last_plain(x, lens, params, n_heads, act="gelu",
                                       hidden_dropout_p=0.0, attn_dropout_p=0.0, seed=0):
    """Plain PyTorch version of ``fused_transformer_layer_last``: the query
    is the row at ``pos == lens - 1`` (zeros where lens is 0 or above T);
    the keys are masked by padding alone, which on that row is also the
    causal mask.  Differentiable; its autograd gradient is the plain
    version of ``fused_transformer_layer_last_bwd``."""
    p = params
    xf = x.float()
    rb = x.dtype == torch.bfloat16
    b, t, d = x.shape
    m1, m3, probs = _layer_masks(hidden_dropout_p, attn_dropout_p, seed, n_heads, b, t, d,
                                 x.device, pos=last_positions(lens, t).to(x.device))
    pos = torch.arange(t, device=x.device)[None, :]
    sel = (pos == lens.to(device=x.device, dtype=torch.long)[:, None] - 1)
    xl = (sel.to(torch.float32)[:, :, None] * xf).sum(1, keepdim=True)  # [B, 1, D]
    q = _mm(xl, p["w_q"], rb) + p["b_q"]
    k, v = (_mm(xf, p[f"w_{n}"], rb) + p[f"b_{n}"] for n in "kv")
    ctx = _attention(q, k, v, _pad_mask(lens, t, x.device), n_heads, rb, probs)
    return _tail(ctx, xl, p, act, rb, m1, m3)[:, 0].to(x.dtype)


# ---------------------------------------------------------------------------
# argument checks
# ---------------------------------------------------------------------------

def _shapes(d, inner):
    want = {"w_q": (d, d), "w_k": (d, d), "w_v": (d, d), "w_o": (d, d),
            "w1": (d, inner), "b1": (inner,), "w2": (inner, d)}
    return {name: want.get(name, (d,)) for name in PARAM_NAMES}


def _param_list(x, params, n_heads, act):
    """Check x and the params against what the kernels take; return the
    kernels' parameter array in PARAM_NAMES order and (B, T, D, I)."""
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
    plist = []
    for name, shape in _shapes(d, inner).items():
        v = params[name]
        if v.dtype != torch.float32 or not v.is_contiguous() \
                or v.device != x.device or tuple(v.shape) != shape:
            raise ValueError(
                f"param {name}: want contiguous float32 {shape} on {x.device}, got "
                f"{v.dtype} {tuple(v.shape)} on {v.device}"
            )
        plist.append(v)
    return plist, (b, t, d, inner)


def _drop_args(hidden_p, attn_p, seed):
    """The kernels' two Dropout structs (hidden, then attention)."""
    return (*_dropout_args(hidden_p, seed), *_dropout_args(attn_p, seed))


def _check_saved(saved, shapes, x):
    if saved is None or len(saved) != len(shapes):
        raise ValueError("saved must be what the training forward returned")
    for v, shape in zip(saved, shapes):
        if v.dtype != torch.float32 or tuple(v.shape) != shape or v.device != x.device \
                or not v.is_contiguous():
            raise ValueError(f"saved tensors must be contiguous float32 {shapes} on "
                             f"{x.device}")
    return saved


def _grad_buffers(x, dims):
    """The zeroed [G, P] weight-grad partials, the [P] grads and G."""
    b, t, d, inner = dims
    size = sum(int(torch.Size(s).numel()) for s in _shapes(d, inner).values())
    g = _grad_blocks(x.device)
    partial = torch.zeros((g, size), device=x.device, dtype=torch.float32)
    grads = torch.empty((size,), device=x.device, dtype=torch.float32)
    return partial, grads, g


def _unflatten_grads(grads, dims):
    """The flat [P] grads (PARAM_NAMES order) -> {name: grad}."""
    out = {}
    o = 0
    for name, shape in _shapes(dims[2], dims[3]).items():
        n = int(torch.Size(shape).numel())
        out[name] = grads[o:o + n].view(shape)
        o += n
    return out


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _launch_fwd(x, lens32, plist, dims, causal, n_heads, act, hidden_p, attn_p, seed,
                train):
    """The layer forward; returns (out, qkv, ctx): the [B, T, 3D] fp32
    projections and, when ``train``, the [B, T, D] fp32 context."""
    b, t, d, inner = dims
    lib = _cuda.library("fused_block.cu")
    out = torch.empty_like(x)
    qkv = torch.empty((b, t, 3 * d), device=x.device, dtype=torch.float32)
    ctx = torch.empty((b, t, d), device=x.device, dtype=torch.float32) if train else None
    with torch.cuda.device(x.device):
        err = lib.recblr_block_fwd(
            x.data_ptr(), lens32.data_ptr(), out.data_ptr(), _cuda.pointer_array(plist),
            qkv.data_ptr(), None if ctx is None else ctx.data_ptr(), b, t, d, n_heads,
            inner, int(bool(causal)), _ACT_IDS[act], 1.0 / math.sqrt(d // n_heads),
            int(x.dtype == torch.bfloat16), *_drop_args(hidden_p, attn_p, seed),
            x.device.index, _stream(x),
        )
    _cuda.check(lib, err, "fused_transformer_layer")
    fused_transformer_layer.launches += 1
    return out, qkv, ctx


def _launch_last_fwd(x, lens32, plist, dims, n_heads, act, hidden_p, attn_p, seed, train):
    """The last-query layer forward; returns (out, kv, ctx): the
    [B, T, 2D] fp32 K and V projections and, when ``train``, the [B, D]
    fp32 context."""
    b, t, d, inner = dims
    lib = _cuda.library("fused_block_last.cu")
    out = torch.empty((b, d), device=x.device, dtype=x.dtype)
    kv = torch.empty((b, t, 2 * d), device=x.device, dtype=torch.float32)
    ctx = torch.empty((b, d), device=x.device, dtype=torch.float32) if train else None
    with torch.cuda.device(x.device):
        err = lib.recblr_block_last_fwd(
            x.data_ptr(), lens32.data_ptr(), out.data_ptr(), _cuda.pointer_array(plist),
            kv.data_ptr(), None if ctx is None else ctx.data_ptr(), b, t, d, n_heads, inner,
            _ACT_IDS[act], 1.0 / math.sqrt(d // n_heads), int(x.dtype == torch.bfloat16),
            *_drop_args(hidden_p, attn_p, seed), x.device.index, _stream(x),
        )
    _cuda.check(lib, err, "fused_transformer_layer_last")
    fused_transformer_layer_last.launches += 1
    return out, kv, ctx


def _sel32(sel_idx, x):
    b = x.shape[0]
    if sel_idx.dim() != 2 or sel_idx.shape[0] != b or sel_idx.shape[1] < 1 \
            or sel_idx.device != x.device:
        raise ValueError(f"sel_idx must be [{b}, S >= 1] on {x.device}")
    if sel_idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"sel_idx must be an integer tensor, got {sel_idx.dtype}")
    return sel_idx.to(torch.int32).contiguous()


def _launch_sel_fwd(x, lens32, sel32, plist, dims, n_heads, act, hidden_p, attn_p, seed,
                    train):
    """The selected-positions layer forward; returns (out, kv, q, ctx):
    the [B, T, 2D] fp32 K and V projections and, when ``train``, the
    [B, S, D] fp32 queries and context."""
    b, t, d, inner = dims
    s = sel32.shape[1]
    lib = _cuda.library("fused_block_sel.cu")
    out = torch.empty((b, s, d), device=x.device, dtype=x.dtype)
    kv = torch.empty((b, t, 2 * d), device=x.device, dtype=torch.float32)
    q = torch.empty((b, s, d), device=x.device, dtype=torch.float32) if train else None
    ctx = torch.empty_like(q) if train else None
    with torch.cuda.device(x.device):
        err = lib.recblr_block_sel_fwd(
            x.data_ptr(), lens32.data_ptr(), sel32.data_ptr(), out.data_ptr(),
            _cuda.pointer_array(plist), kv.data_ptr(), None if q is None else q.data_ptr(),
            None if ctx is None else ctx.data_ptr(), b, t, d, s, n_heads, inner, _ACT_IDS[act],
            1.0 / math.sqrt(d // n_heads), int(x.dtype == torch.bfloat16),
            *_drop_args(hidden_p, attn_p, seed), x.device.index, _stream(x),
        )
    _cuda.check(lib, err, "fused_transformer_layer_sel")
    fused_transformer_layer_sel.launches += 1
    return out, kv, q, ctx


def fused_transformer_layer_sel_train(x, lens, sel_idx, params, n_heads, act="gelu",
                                      hidden_dropout_p=0.0, attn_dropout_p=0.0, seed=0):
    """Selected-positions layer forward on the card that keeps what the
    backward reads: (out, (kv [B, T, 2D], q [B, S, D], ctx [B, S, D]) fp32)."""
    _require_cuda(x)
    plist, dims = _param_list(x, params, n_heads, act)
    out, kv, q, ctx = _launch_sel_fwd(x, _lens32(lens, x), _sel32(sel_idx, x), plist, dims,
                                      n_heads, act, hidden_dropout_p, attn_dropout_p, seed, True)
    return out, (kv, q, ctx)


def fused_transformer_layer_train(x, lens, params, causal, n_heads, act="gelu",
                                  hidden_dropout_p=0.0, attn_dropout_p=0.0, seed=0):
    """Layer forward on the card that keeps what the backward reads:
    (out, (qkv [B, T, 3D], ctx [B, T, D]) fp32)."""
    _require_cuda(x)
    plist, dims = _param_list(x, params, n_heads, act)
    out, qkv, ctx = _launch_fwd(x, _lens32(lens, x), plist, dims, causal, n_heads, act,
                                hidden_dropout_p, attn_dropout_p, seed, True)
    return out, (qkv, ctx)


def fused_transformer_layer_last_train(x, lens, params, n_heads, act="gelu",
                                       hidden_dropout_p=0.0, attn_dropout_p=0.0, seed=0):
    """Last-query layer forward on the card that keeps what the backward
    reads: (out, (kv [B, T, 2D], ctx [B, D]) fp32)."""
    _require_cuda(x)
    plist, dims = _param_list(x, params, n_heads, act)
    out, kv, ctx = _launch_last_fwd(x, _lens32(lens, x), plist, dims, n_heads, act,
                                    hidden_dropout_p, attn_dropout_p, seed, True)
    return out, (kv, ctx)


def fused_transformer_layer_bwd(x, lens, dout, params, causal, n_heads, act="gelu",
                                hidden_dropout_p=0.0, attn_dropout_p=0.0, seed=0, *,
                                saved):
    """Backward of ``fused_transformer_layer`` on the card, causal or
    bidirectional: (dx [B, T, D] in x's dtype, {param name: fp32 grad}).
    ``saved``: (qkv, ctx) kept by ``fused_transformer_layer_train`` with
    the same arguments."""
    _require_cuda(x)
    plist, dims = _param_list(x, params, n_heads, act)
    b, t, d, inner = dims
    lens32 = _lens32(lens, x)
    dout = _check_dout(dout, (b, t, d), x)
    qkv, ctx = _check_saved(saved, ((b, t, 3 * d), (b, t, d)), x)
    dctx = torch.empty((b, t, d), device=x.device, dtype=torch.float32)
    dxr = torch.empty_like(dctx)
    dqkv = torch.empty_like(qkv)
    dx = torch.empty_like(x)
    partial, grads, g = _grad_buffers(x, dims)
    lib = _cuda.library("fused_block_bwd.cu")
    with torch.cuda.device(x.device):
        err = lib.recblr_block_bwd(
            x.data_ptr(), lens32.data_ptr(), dout.data_ptr(), _cuda.pointer_array(plist),
            qkv.data_ptr(), ctx.data_ptr(), dctx.data_ptr(), dxr.data_ptr(), dqkv.data_ptr(),
            partial.data_ptr(), g, grads.data_ptr(), dx.data_ptr(), b, t, d, n_heads, inner,
            int(bool(causal)), _ACT_IDS[act], 1.0 / math.sqrt(d // n_heads),
            int(x.dtype == torch.bfloat16), *_drop_args(hidden_dropout_p, attn_dropout_p, seed),
            x.device.index, _stream(x),
        )
    _cuda.check(lib, err, "fused_transformer_layer_bwd")
    fused_transformer_layer_bwd.launches += 1
    return dx, _unflatten_grads(grads, dims)


def fused_transformer_layer_last_bwd(x, lens, dout, params, n_heads, act="gelu",
                                     hidden_dropout_p=0.0, attn_dropout_p=0.0, seed=0, *,
                                     saved):
    """Backward of ``fused_transformer_layer_last`` on the card: (dx
    [B, T, D] in x's dtype, dense: K and V reach every position, the
    query and the residual only ``lens - 1``; {param name: fp32 grad}).
    ``saved``: (kv, ctx) kept by ``fused_transformer_layer_last_train``."""
    _require_cuda(x)
    plist, dims = _param_list(x, params, n_heads, act)
    b, t, d, inner = dims
    lens32 = _lens32(lens, x)
    dout = _check_dout(dout, (b, d), x)
    kv, ctx = _check_saved(saved, ((b, t, 2 * d), (b, d)), x)
    dctx = torch.empty((b, d), device=x.device, dtype=torch.float32)
    dxr = torch.empty_like(dctx)
    dkv = torch.empty_like(kv)
    dx = torch.empty_like(x)
    partial, grads, g = _grad_buffers(x, dims)
    lib = _cuda.library("fused_block_last_bwd.cu")
    with torch.cuda.device(x.device):
        err = lib.recblr_block_last_bwd(
            x.data_ptr(), lens32.data_ptr(), dout.data_ptr(), _cuda.pointer_array(plist),
            kv.data_ptr(), ctx.data_ptr(), dctx.data_ptr(), dxr.data_ptr(), dkv.data_ptr(),
            partial.data_ptr(), g, grads.data_ptr(), dx.data_ptr(), b, t, d, n_heads, inner,
            _ACT_IDS[act], 1.0 / math.sqrt(d // n_heads), int(x.dtype == torch.bfloat16),
            *_drop_args(hidden_dropout_p, attn_dropout_p, seed), x.device.index, _stream(x),
        )
    _cuda.check(lib, err, "fused_transformer_layer_last_bwd")
    fused_transformer_layer_last_bwd.launches += 1
    return dx, _unflatten_grads(grads, dims)


def fused_transformer_layer_sel_bwd(x, lens, sel_idx, dout, params, n_heads, act="gelu",
                                    hidden_dropout_p=0.0, attn_dropout_p=0.0, seed=0, *,
                                    saved):
    """Backward of ``fused_transformer_layer_sel`` on the card: (dx
    [B, T, D] in x's dtype, dense: K and V reach every position, the query
    and the residual only the selected ones, the cotangents of repeated
    positions added; {param name: fp32 grad}).  ``saved``: (kv, q, ctx)
    kept by ``fused_transformer_layer_sel_train`` with the same arguments."""
    _require_cuda(x)
    plist, dims = _param_list(x, params, n_heads, act)
    b, t, d, inner = dims
    lens32 = _lens32(lens, x)
    sel32 = _sel32(sel_idx, x)
    s = sel32.shape[1]
    dout = _check_dout(dout, (b, s, d), x)
    kv, q, ctx = _check_saved(saved, ((b, t, 2 * d), (b, s, d), (b, s, d)), x)
    dctx = torch.empty((b, s, d), device=x.device, dtype=torch.float32)
    dxq = torch.empty_like(dctx)
    dq = torch.empty_like(dctx)
    dkv = torch.empty_like(kv)
    dx = torch.empty_like(x)
    partial, grads, g = _grad_buffers(x, dims)
    lib = _cuda.library("fused_block_sel_bwd.cu")
    with torch.cuda.device(x.device):
        err = lib.recblr_block_sel_bwd(
            x.data_ptr(), lens32.data_ptr(), sel32.data_ptr(), dout.data_ptr(),
            _cuda.pointer_array(plist), kv.data_ptr(), q.data_ptr(), ctx.data_ptr(),
            dctx.data_ptr(), dxq.data_ptr(), dq.data_ptr(), dkv.data_ptr(), partial.data_ptr(),
            g, grads.data_ptr(), dx.data_ptr(), b, t, d, s, n_heads, inner, _ACT_IDS[act],
            1.0 / math.sqrt(d // n_heads), int(x.dtype == torch.bfloat16),
            *_drop_args(hidden_dropout_p, attn_dropout_p, seed), x.device.index, _stream(x),
        )
    _cuda.check(lib, err, "fused_transformer_layer_sel_bwd")
    fused_transformer_layer_sel_bwd.launches += 1
    return dx, _unflatten_grads(grads, dims)


fused_transformer_layer_bwd.launches = 0
fused_transformer_layer_last_bwd.launches = 0
fused_transformer_layer_sel_bwd.launches = 0


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

def _param_dict(plist):
    return dict(zip(PARAM_NAMES, plist))


class _Block(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lens, opts, *plist):
        out, saved = fused_transformer_layer_train(x, lens, _param_dict(plist), *opts)
        ctx.opts = opts
        ctx.save_for_backward(x, lens, *saved, *plist)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, lens, qkv, attn, *plist = ctx.saved_tensors
        dx, grads = fused_transformer_layer_bwd(x, lens, dout, _param_dict(plist), *ctx.opts,
                                                saved=(qkv, attn))
        return (dx, None, None, *(grads[n] for n in PARAM_NAMES))


class _BlockLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lens, opts, *plist):
        out, saved = fused_transformer_layer_last_train(x, lens, _param_dict(plist), *opts)
        ctx.opts = opts
        ctx.save_for_backward(x, lens, *saved, *plist)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, lens, kv, attn, *plist = ctx.saved_tensors
        dx, grads = fused_transformer_layer_last_bwd(x, lens, dout, _param_dict(plist),
                                                     *ctx.opts, saved=(kv, attn))
        return (dx, None, None, *(grads[n] for n in PARAM_NAMES))


class _BlockSel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lens, sel_idx, opts, *plist):
        out, saved = fused_transformer_layer_sel_train(x, lens, sel_idx, _param_dict(plist),
                                                       *opts)
        ctx.opts = opts
        ctx.save_for_backward(x, lens, sel_idx, *saved, *plist)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, lens, sel_idx, kv, q, attn, *plist = ctx.saved_tensors
        dx, grads = fused_transformer_layer_sel_bwd(x, lens, sel_idx, dout, _param_dict(plist),
                                                    *ctx.opts, saved=(kv, q, attn))
        return (dx, None, None, None, *(grads[n] for n in PARAM_NAMES))


# ---------------------------------------------------------------------------
# public forwards
# ---------------------------------------------------------------------------

def fused_transformer_layer(x, lens, params, causal, n_heads, act="gelu",
                            hidden_dropout_p=0.0, attn_dropout_p=0.0, seed=0):
    """Complete post-LN transformer encoder layer forward, differentiable
    in x and every param.  x: [B, T, D]; lens: int [B] non-PAD counts
    (keys at col >= lens are masked); params (all fp32): w_q/w_k/w_v/w_o
    [D, D], b_q/b_k/b_v/b_o [D], ln1_s/ln1_b [D], w1 [D, I], b1 [I], w2
    [I, D], b2 [D], ln2_s/ln2_b [D]; causal adds the lower-triangular
    mask; the two dropout rates and the 64-bit seed of their masks.
    Returns [B, T, D] in x's dtype."""
    if x.device.type == "cpu":
        return fused_transformer_layer_plain(x, lens, params, causal, n_heads, act,
                                             hidden_dropout_p, attn_dropout_p, seed)
    _require_cuda(x)
    plist, dims = _param_list(x, params, n_heads, act)
    lens32 = _lens32(lens, x)
    if _needs_grad(x, plist):
        opts = (bool(causal), n_heads, act, float(hidden_dropout_p), float(attn_dropout_p),
                int(seed))
        return _Block.apply(x, lens32, opts, *plist)
    out, _, _ = _launch_fwd(x, lens32, plist, dims, causal, n_heads, act, hidden_dropout_p,
                            attn_dropout_p, seed, False)
    return out


def fused_transformer_layer_last(x, lens, params, n_heads, act="gelu",
                                 hidden_dropout_p=0.0, attn_dropout_p=0.0, seed=0):
    """Top transformer layer forward at each row's last valid position
    only, differentiable in x and every param; valid for a causal stack
    (the last row's causal mask is its padding mask) and a bidirectional
    one.  x: [B, T, D]; lens: int [B] (0 or above T selects nothing);
    params and dropout as for ``fused_transformer_layer``.  Returns [B, D]
    in x's dtype."""
    if x.device.type == "cpu":
        return fused_transformer_layer_last_plain(x, lens, params, n_heads, act,
                                                  hidden_dropout_p, attn_dropout_p, seed)
    _require_cuda(x)
    plist, dims = _param_list(x, params, n_heads, act)
    lens32 = _lens32(lens, x)
    if _needs_grad(x, plist):
        opts = (n_heads, act, float(hidden_dropout_p), float(attn_dropout_p), int(seed))
        return _BlockLast.apply(x, lens32, opts, *plist)
    out, _, _ = _launch_last_fwd(x, lens32, plist, dims, n_heads, act, hidden_dropout_p,
                                 attn_dropout_p, seed, False)
    return out


def fused_transformer_layer_sel(x, lens, sel_idx, params, n_heads, act="gelu",
                                hidden_dropout_p=0.0, attn_dropout_p=0.0, seed=0):
    """Top BIDIRECTIONAL transformer layer forward at the selected
    positions only (BERT4Rec's cloze positions), differentiable in x and
    every param.  x: [B, T, D]; lens: int [B] (keys at col >= lens are
    masked); sel_idx: int [B, S] positions, repeats allowed (clamped into
    [0, T - 1]); params and dropout as for ``fused_transformer_layer``, the
    masks keyed by each selected position.  Returns [B, S, D] in x's
    dtype: row [b, s] is the full bidirectional layer's output at
    position sel_idx[b, s].  Valid only as the top layer of a stack."""
    if x.device.type == "cpu":
        return fused_transformer_layer_sel_plain(x, lens, sel_idx, params, n_heads, act,
                                                 hidden_dropout_p, attn_dropout_p, seed)
    _require_cuda(x)
    plist, dims = _param_list(x, params, n_heads, act)
    lens32 = _lens32(lens, x)
    sel32 = _sel32(sel_idx, x)
    if _needs_grad(x, plist):
        opts = (n_heads, act, float(hidden_dropout_p), float(attn_dropout_p), int(seed))
        return _BlockSel.apply(x, lens32, sel32, opts, *plist)
    out, _, _, _ = _launch_sel_fwd(x, lens32, sel32, plist, dims, n_heads, act,
                                   hidden_dropout_p, attn_dropout_p, seed, False)
    return out


fused_transformer_layer.launches = 0
fused_transformer_layer_last.launches = 0
fused_transformer_layer_sel.launches = 0
