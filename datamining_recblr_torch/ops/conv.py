"""Causal depthwise 1-D convolution on [B, T, C] (counterpart of
``datamining_recblr_tpu/ops/conv.py`` and of ``_conv_fwd`` in
``ops/fused_bdlru.py``): K shifted multiply-adds."""

from __future__ import annotations

import torch.nn.functional as F


def _shift_right(x, j):
    """x[:, t] <- x[:, t-j] along axis 1 (j >= 1), zero before t = j."""
    t = x.shape[1]
    j = min(j, t)
    return F.pad(x[:, : t - j], (0, 0, j, 0))


def causal_depthwise_conv(x, weight, bias=None):
    """y[:, t, c] = bias[c] + sum_k weight[k, c] * x[:, t - (K-1) + k, c].

    x: [B, T, C]; weight: [K, C], tap K-1 multiplies the current step;
    bias: optional [C].  Steps before t = 0 are zero.  Returns [B, T, C].
    The bias joins the current tap before the older ones, the order in
    which the CUDA layer kernels (and the TPU kernels) sum.
    """
    k = weight.shape[0]
    y = x * weight[k - 1]
    if bias is not None:
        y = y + bias
    for j in range(1, k):
        y = y + _shift_right(x, j) * weight[k - 1 - j]
    return y
