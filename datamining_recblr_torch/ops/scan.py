"""First-order linear recurrence ``h_t = g_t * h_{t-1} + x_t`` (h_{-1} = 0).

Counterpart of ``datamining_recblr_tpu/ops/scan.py:linear_scan_serial``.
The serial loop is the spec of the scan inside both CUDA layer kernels,
which run it in the same order: one thread per (row, channel), serial
over T.  The TPU kernels sum in Hillis-Steele order instead, so the two
packages agree to rounding, not bit for bit.
"""

from __future__ import annotations

import torch


def linear_scan_serial(gates, tokens):
    """gates, tokens: [B, T, C] -> h [B, T, C] in the tokens' dtype."""
    out = torch.empty_like(tokens)
    h = torch.zeros_like(tokens[:, 0])
    for t in range(tokens.shape[1]):
        h = gates[:, t] * h + tokens[:, t]
        out[:, t] = h
    return out
