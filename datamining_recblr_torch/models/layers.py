"""Shared building blocks of the RecBLR model (counterparts of the RecBLR
pieces of ``datamining_recblr_tpu/models/layers.py``).

Weights are ``[in, out]`` and applied as ``x @ w``; linear and embedding
weights ~ N(0, 0.02), biases zero, LayerNorm scale 1 and bias 0.
"""

from __future__ import annotations

import torch

from datamining_recblr_torch.ops import philox

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
