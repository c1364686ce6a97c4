"""The BD-LRU in one call: causal conv + SiLU + gate matmul + decay +
scan, forward and backward (counterpart of
``datamining_recblr_tpu/ops/fused_bdlru.py``; its causal conv is
``ops/conv.py``).

    xc   = silu(causal_conv(x; w_c) + b_c)     [use_conv; else x]
    g    = xc @ W_g + b_g ;  r, i = split(g)
    a    = exp(-softplus(Lambda) * sigmoid(r))
    beta = sqrt(1 - a^2 + 1e-8) * sigmoid(i)
    h    = scan(a, beta * xc)

``_gate_math`` is the gate math of every plain version of the recurrent
layer kernels.  ``fused_bdlru`` replaces the TPU kernels ``_fwd_kernel``
(via ``_fused_fwd`` :247) and ``_bwd_kernel`` (via ``_fused_bwd`` :273),
which the JAX model runs in each layer of its unfused composition when
C <= 128 (``recblr.py:122-143``): on a CUDA tensor the kernels of
``csrc/fused_bdlru.cu`` and ``csrc/fused_bdlru_bwd.cu`` (the backward
recomputes the forward from x; nothing is kept), on a CPU tensor the
plain version ``fused_bdlru_plain``.  x is in the compute dtype and h
comes back in it; the math is fp32 inside and the parameters fp32, as
the TPU kernel.  ``launches`` on ``fused_bdlru`` and ``fused_bdlru_bwd``
counts their kernel launches.
"""

from __future__ import annotations

import torch

from datamining_recblr_torch.ops import _cuda, fastmath
from datamining_recblr_torch.ops.conv import causal_depthwise_conv
from datamining_recblr_torch.ops.scan import linear_scan_serial

EPS = 1e-8
LANE = 128  # the TPU kernel keeps C on one 128-lane tile; the card's, in shared memory
# conv taps the kernels take: they hold the tile's 32 + K - 1 rows of xb in
# shared memory (csrc/common.cuh xb_rows), within its 227 KB up to K ~230
# at C 128; the whole-layer kernels take the same bound
MAX_K = 64


def supports(c: int) -> bool:
    return c <= LANE


def softplus(x):
    """log(1 + e^x) without overflow (``jax.nn.softplus``)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _gate_math(xc, wg, bg, lam):
    """xc [B, T, C] fp32 -> (alpha, beta, sigmoid(r), sigmoid(i), s)."""
    c = xc.shape[-1]
    g = xc @ wg + bg
    r, i = g[..., :c], g[..., c:]
    sr = fastmath.sigmoid(r)
    si = fastmath.sigmoid(i)
    alpha = fastmath.exp(-softplus(lam) * sr)
    s = torch.sqrt(1.0 - alpha * alpha + EPS)
    beta = s * si
    return alpha, beta, sr, si, s


def fused_bdlru_plain(x, wc, bc, wg, bg, lam, use_conv=True):
    """Plain PyTorch version of ``fused_bdlru`` (any device;
    differentiable, and its autograd gradient is the plain version of
    ``fused_bdlru_bwd``): fp32 inside, h in x's dtype."""
    xf = x.float()
    xc = fastmath.silu(causal_depthwise_conv(xf, wc, bc)) if use_conv else xf
    alpha, beta, _, _, _ = _gate_math(xc, wg, bg, lam)
    return linear_scan_serial(alpha, beta * xc).to(x.dtype)


_NAMES = ("wc", "bc", "wg", "bg", "lam")


def _checks(x, params):
    """Check x [B, T, C] and (wc, bc, wg, bg, lam) against what the kernels
    take; return (B, T, C, K)."""
    if x.dim() != 3 or x.dtype not in (torch.float32, torch.bfloat16) \
            or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous float32 or bfloat16 [B, T, C], got "
                         f"{x.dtype} {tuple(x.shape)}")
    b, t, c = x.shape
    k = params[0].shape[0] if params[0].dim() == 2 else 0
    if not supports(c) or not 1 <= k <= MAX_K or b < 1 or t < 1:
        raise ValueError(f"unsupported shape B={b} T={t} C={c} K={k}: the kernels take "
                         f"C <= {LANE}, 1 <= K <= {MAX_K}")
    want = {"wc": (k, c), "bc": (c,), "wg": (c, 2 * c), "bg": (2 * c,), "lam": (c,)}
    for name, v in zip(_NAMES, params):
        if v.dtype != torch.float32 or not v.is_contiguous() or v.device != x.device \
                or tuple(v.shape) != want[name]:
            raise ValueError(f"param {name}: want contiguous float32 {want[name]} on "
                             f"{x.device}, got {v.dtype} {tuple(v.shape)} on {v.device}")
    return b, t, c, k


def _launch_fwd(x, params, use_conv):
    b, t, c, k = _checks(x, params)
    lib = _cuda.library("fused_bdlru.cu")
    alpha = torch.empty((b, t, c), device=x.device, dtype=torch.float32)
    bx = torch.empty_like(alpha)
    h = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.recblr_bdlru_fwd(x.data_ptr(), _cuda.pointer_array(params), alpha.data_ptr(),
                                   bx.data_ptr(), h.data_ptr(), b, t, c, k, int(use_conv),
                                   int(x.dtype == torch.bfloat16), x.device.index,
                                   _cuda.stream(x))
    _cuda.check(lib, err, "fused_bdlru")
    fused_bdlru.launches += 1
    return h


def fused_bdlru_bwd(x, dh, wc, bc, wg, bg, lam, use_conv=True):
    """Backward of ``fused_bdlru`` on the card: (dx in x's dtype, dwc,
    dbc, dwg, dbg, dlam fp32), the weight grads summed over every (row,
    position) in a fixed order; without the conv dwc and dbc are 0."""
    _cuda.require_cuda(x)
    params = (wc, bc, wg, bg, lam)
    b, t, c, k = _checks(x, params)
    if tuple(dh.shape) != (b, t, c) or dh.dtype != x.dtype or dh.device != x.device:
        raise ValueError(f"dh must be {x.dtype} {(b, t, c)} on {x.device}, got {dh.dtype} "
                         f"{tuple(dh.shape)} on {dh.device}")
    dh = dh.contiguous()
    wgt = wg.t().contiguous()
    alpha = torch.empty((b, t, c), device=x.device, dtype=torch.float32)
    h = torch.empty_like(alpha)
    ds = torch.empty_like(alpha)
    sizes = (k * c, c, 2 * c * c, 2 * c, c)
    g = _cuda.grad_blocks(x.device)
    partial = torch.zeros((g, sum(sizes)), device=x.device, dtype=torch.float32)
    grads = torch.empty((sum(sizes),), device=x.device, dtype=torch.float32)
    dx = torch.empty_like(x)
    lib = _cuda.library("fused_bdlru_bwd.cu")
    with torch.cuda.device(x.device):
        err = lib.recblr_bdlru_bwd(
            x.data_ptr(), dh.data_ptr(), _cuda.pointer_array([*params, wgt]), alpha.data_ptr(),
            h.data_ptr(), ds.data_ptr(), partial.data_ptr(), g, grads.data_ptr(), dx.data_ptr(),
            b, t, c, k, int(use_conv), int(x.dtype == torch.bfloat16), x.device.index,
            _cuda.stream(x))
    _cuda.check(lib, err, "fused_bdlru_bwd")
    fused_bdlru_bwd.launches += 1
    flat = grads.split(sizes)
    return (dx, *(v.view(p.shape) for v, p in zip(flat, params)))


class _FusedBDLRU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wc, bc, wg, bg, lam, use_conv):
        ctx.use_conv = use_conv
        ctx.save_for_backward(x, wc, bc, wg, bg, lam)
        return _launch_fwd(x, (wc, bc, wg, bg, lam), use_conv)

    @staticmethod
    def backward(ctx, dh):
        x, *params = ctx.saved_tensors
        return (*fused_bdlru_bwd(x, dh.to(x.dtype), *params, ctx.use_conv), None)


def fused_bdlru(x, wc, bc, wg, bg, lam, use_conv=True):
    """h = scan(alpha(xc), beta(xc) * xc), xc = silu(conv(x)) or x,
    differentiable in x and the five parameters.  x: [B, T, C] fp32 or
    bf16 (C <= 128 on the card); wc [K, C], bc [C], wg [C, 2C], bg [2C],
    lam [C] fp32; use_conv False for the ``bd_lru_only`` / ``noconv``
    ablations.  Returns [B, T, C] in x's dtype."""
    if x.device.type == "cpu":
        return fused_bdlru_plain(x, wc, bc, wg, bg, lam, use_conv)
    _cuda.require_cuda(x)
    params = (wc, bc, wg, bg, lam)
    if _cuda.needs_grad(x, params):
        return _FusedBDLRU.apply(x, *params, bool(use_conv))
    return _launch_fwd(x, params, use_conv)


fused_bdlru.launches = 0
fused_bdlru_bwd.launches = 0
