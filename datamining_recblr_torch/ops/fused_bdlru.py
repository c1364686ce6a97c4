"""BD-LRU gate math shared by the plain versions of the fused layer
kernels (counterpart of ``_gate_math`` in
``datamining_recblr_tpu/ops/fused_bdlru.py``; its causal conv is
``ops/conv.py``).

    g    = xc @ W_g + b_g ;  r, i = split(g)
    a    = exp(-softplus(Lambda) * sigmoid(r))
    beta = sqrt(1 - a^2 + 1e-8) * sigmoid(i)
"""

from __future__ import annotations

import torch

from datamining_recblr_torch.ops import fastmath

EPS = 1e-8


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
