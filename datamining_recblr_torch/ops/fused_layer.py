"""Whole-layer forwards of the RecBLR RecurrentLayer: hand-written CUDA
kernels for Hopper, each beside its plain PyTorch version.

Counterpart of ``datamining_recblr_tpu/ops/fused_layer.py``, forward
only with dropout 0 (serving):

    x    = LN(x; pl_s, pl_b)                 [prologue]
    xz   = x @ W_in ;  xb, z = split(xz)
    xc   = silu(causal_conv(xb))             [use_conv]
    h    = BD-LRU scan of xc                 (gates matmul + decay math)
    y    = (silu(z) * h) @ W_out
    r1   = LN1(y + x)
    out  = LN2(silu(r1 @ W1 + b1) @ W2 + b2 + r1)   [use_ffn; else r1]

``fused_recurrent_layer`` replaces the TPU kernel ``_fwd_kernel``
(``fused_layer.py:245``, via ``_layer_fwd``); its CUDA source is
``csrc/fused_layer.cu``.  ``fused_recurrent_layer_last`` replaces
``_last_fwd_kernel`` (``fused_layer.py:826``, via ``_layer_last_fwd``):
the same layer with everything after the scan at each row's last
position only, returning [B, D]; its CUDA source is
``csrc/fused_layer_last.cu``.  Both are bound by fp32 operations at the
serving shape (~180 and ~82 kFLOP per position against a few hundred
bytes); the sources' head comments say what the design does about it.

On a CPU tensor a wrapper computes its plain version; on a CUDA tensor
it launches its kernel or raises.  ``launches`` on each wrapper counts
its kernel launches.  Params are fp32; x is fp32 or bf16 and the
output has x's dtype, with fp32 math inside.
"""

from __future__ import annotations

import torch

from datamining_recblr_torch.ops import _cuda, fastmath
from datamining_recblr_torch.ops.conv import causal_depthwise_conv
from datamining_recblr_torch.ops.fused_bdlru import _gate_math
from datamining_recblr_torch.ops.scan import linear_scan_serial

LN_EPS = 1e-12

# the order of the kernels' parameter array (csrc/common.cuh LayerParams)
PARAM_ORDER = (
    "w_in", "wc", "bc", "wg", "bg", "lam", "w_out", "ln1_s", "ln1_b",
    "w1", "b1", "w2", "b2", "ln2_s", "ln2_b", "pl_s", "pl_b",
)
_FFN_NAMES = ("w1", "b1", "w2", "b2", "ln2_s", "ln2_b")

MAX_D = 128
MAX_C = 128
MAX_K = 8      # conv halo rows the kernels hold (csrc/common.cuh MAX_K)
MAX_FFN = 512  # FFN width the kernels' shared memory holds
MAX_B = 65535  # grid dimension that carries the batch


def supports(d: int, c: int) -> bool:
    return d <= MAX_D and c <= MAX_C


def _ln(v, scale, bias):
    mu = v.mean(-1, keepdim=True)
    var = (v - mu).square().mean(-1, keepdim=True)
    return (v - mu) * torch.rsqrt(var + LN_EPS) * scale + bias


def _ffn_tail(r1, p):
    f1 = r1 @ p["w1"] + p["b1"]
    f2 = fastmath.silu(f1) @ p["w2"] + p["b2"]
    return _ln(f2 + r1, p["ln2_s"], p["ln2_b"])


def _bdlru(xb, p, use_conv):
    xc = fastmath.silu(causal_depthwise_conv(xb, p["wc"], p["bc"])) if use_conv else xb
    alpha, beta, _, _, _ = _gate_math(xc, p["wg"], p["bg"], p["lam"])
    return linear_scan_serial(alpha, beta * xc)


def fused_recurrent_layer_plain(x, params, use_conv=True, use_ffn=True,
                                prologue=False):
    """Plain PyTorch version of ``fused_recurrent_layer`` (any device)."""
    p = params
    xf = x.float()
    if prologue:
        xf = _ln(xf, p["pl_s"], p["pl_b"])
    c = p["w_in"].shape[1] // 2
    xz = xf @ p["w_in"]
    xb, z = xz[..., :c], xz[..., c:]
    h = _bdlru(xb, p, use_conv)
    y = (fastmath.silu(z) * h) @ p["w_out"]
    out = _ln(y + xf, p["ln1_s"], p["ln1_b"])
    if use_ffn:
        out = _ffn_tail(out, p)
    return out.to(x.dtype)


def fused_recurrent_layer_last_plain(x, lens, params, use_conv=True,
                                     use_ffn=True):
    """Plain PyTorch version of ``fused_recurrent_layer_last``.  The row
    is chosen by a one-hot of ``pos == lens - 1``, so a length of 0 (or
    above T) selects nothing and the tail runs on zeros."""
    p = params
    xf = x.float()
    t = xf.shape[1]
    c = p["w_in"].shape[1] // 2
    h = _bdlru(xf @ p["w_in"][:, :c], p, use_conv)
    pos = torch.arange(t, device=x.device)[None, :]
    m = (pos == lens.to(device=x.device, dtype=torch.long)[:, None] - 1)
    m = m.to(torch.float32)[:, :, None]
    xl = (m * xf).sum(1)
    hl = (m * h).sum(1)
    zl = xl @ p["w_in"][:, c:]
    yl = (fastmath.silu(zl) * hl) @ p["w_out"]
    out = _ln(yl + xl, p["ln1_s"], p["ln1_b"])
    if use_ffn:
        out = _ffn_tail(out, p)
    return out.to(x.dtype)


def _param_list(x, params, use_ffn, prologue):
    """Check x and the params against what the kernels take; return the
    kernels' parameter array in PARAM_ORDER (None where unused) and the
    sizes (B, T, D, C, K, F)."""
    if x.dim() != 3:
        raise ValueError(f"x must be [B, T, D], got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    b, t, d = x.shape
    c = params["w_out"].shape[0]
    k = params["wc"].shape[0]
    f = params["w1"].shape[1] if use_ffn else 0
    if not supports(d, c) or not 1 <= k <= min(t, MAX_K) or f > MAX_FFN \
            or not 1 <= b <= MAX_B:
        raise ValueError(
            f"unsupported shape B={b} T={t} D={d} C={c} K={k} F={f}: the "
            f"kernels take D, C <= 128, 1 <= K <= min(T, {MAX_K}), "
            f"F <= {MAX_FFN}, 1 <= B <= {MAX_B}"
        )
    want = {
        "w_in": (d, 2 * c), "wc": (k, c), "bc": (c,), "wg": (c, 2 * c),
        "bg": (2 * c,), "lam": (c,), "w_out": (c, d), "ln1_s": (d,),
        "ln1_b": (d,), "w1": (d, f), "b1": (f,), "w2": (f, d), "b2": (d,),
        "ln2_s": (d,), "ln2_b": (d,), "pl_s": (d,), "pl_b": (d,),
    }
    used = set(PARAM_ORDER[:9])
    if use_ffn:
        used |= set(_FFN_NAMES)
    if prologue:
        used |= {"pl_s", "pl_b"}
    plist = []
    for name in PARAM_ORDER:
        if name not in used:
            plist.append(None)
            continue
        v = params[name]
        if v.dtype != torch.float32 or not v.is_contiguous() \
                or v.device != x.device or tuple(v.shape) != want[name]:
            raise ValueError(
                f"param {name}: want contiguous float32 {want[name]} on "
                f"{x.device}, got {v.dtype} {tuple(v.shape)} on {v.device}"
            )
        plist.append(v)
    return plist, (b, t, d, c, k, f)


def _require_cuda(x):
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}; use cpu or cuda")


def fused_recurrent_layer(x, params, use_conv=True, use_ffn=True,
                          prologue=False):
    """Complete RecurrentLayer forward (dropout 0).  x: [B, T, D];
    params: w_in [D,2C], wc [K,C], bc [C], wg [C,2C], bg [2C], lam [C],
    w_out [C,D], ln1_s/ln1_b [D], with use_ffn w1 [D,F], b1 [F],
    w2 [F,D], b2 [D], ln2_s/ln2_b [D], with prologue pl_s/pl_b [D] (x is
    then the raw embedding block).  Returns [B, T, D] in x's dtype."""
    if x.device.type == "cpu":
        return fused_recurrent_layer_plain(x, params, use_conv, use_ffn, prologue)
    _require_cuda(x)
    plist, (b, t, d, c, k, f) = _param_list(x, params, use_ffn, prologue)
    lib = _cuda.library("fused_layer.cu")
    out = torch.empty_like(x)
    alpha = torch.empty((b, t, c), device=x.device, dtype=torch.float32)
    bxh = torch.empty_like(alpha)
    ptrs = _cuda.pointer_array(plist)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.recblr_layer_fwd(
            x.data_ptr(), out.data_ptr(), ptrs, alpha.data_ptr(), bxh.data_ptr(),
            b, t, d, c, k, f, int(use_conv), int(use_ffn), int(prologue),
            int(x.dtype == torch.bfloat16), x.device.index, stream,
        )
    _cuda.check(lib, err, "fused_recurrent_layer")
    fused_recurrent_layer.launches += 1
    return out


fused_recurrent_layer.launches = 0


def fused_recurrent_layer_last(x, lens, params, use_conv=True, use_ffn=True):
    """Top RecurrentLayer forward at each row's last valid position only
    (dropout 0).  x: [B, T, D]; lens: int [B] 1-based valid lengths (0
    selects nothing); params as for ``fused_recurrent_layer`` without
    the prologue.  Returns [B, D] in x's dtype."""
    if x.device.type == "cpu":
        return fused_recurrent_layer_last_plain(x, lens, params, use_conv, use_ffn)
    _require_cuda(x)
    plist, (b, t, d, c, k, f) = _param_list(x, params, use_ffn, False)
    if lens.shape != (b,) or lens.device != x.device:
        raise ValueError(f"lens must be [{b}] on {x.device}")
    if lens.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"lens must be an integer tensor, got {lens.dtype}")
    lens32 = lens.to(torch.int32).contiguous()
    lib = _cuda.library("fused_layer_last.cu")
    out = torch.empty((b, d), device=x.device, dtype=x.dtype)
    alpha = torch.empty((b, t, c), device=x.device, dtype=torch.float32)
    bx = torch.empty_like(alpha)
    h_last = torch.empty((b, c), device=x.device, dtype=torch.float32)
    ptrs = _cuda.pointer_array(plist)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.recblr_layer_last_fwd(
            x.data_ptr(), lens32.data_ptr(), out.data_ptr(), ptrs,
            alpha.data_ptr(), bx.data_ptr(), h_last.data_ptr(),
            b, t, d, c, k, f, int(use_conv), int(use_ffn),
            int(x.dtype == torch.bfloat16), x.device.index, stream,
        )
    _cuda.check(lib, err, "fused_recurrent_layer_last")
    fused_recurrent_layer_last.launches += 1
    return out


fused_recurrent_layer_last.launches = 0
