"""Masked softmax attention with probability dropout, forward and
backward: hand-written CUDA kernels for Hopper, each beside its plain
PyTorch version.

Counterpart of ``datamining_recblr_tpu/ops/attention.py``, which the
attention baselines' per-op composition runs in every layer that the
whole-layer kernels do not take (``fused_block.supports`` rejects the
shape; ``models/layers.py:_multi_head_attention``):

    s   = q k^T / sqrt(dh) + mask   (-10000 where col >= lens, and with
                                     causal where col > row; never -inf)
    p   = softmax(s)                (max-shifted, exp as fastmath.exp)
    out = (p * m_h) v               (m_h head h's dropout mask)

Two kernels:

* ``fused_attention`` replaces ``_fwd_kernel`` (``attention.py:75``, via
  ``_attn_fwd`` :160); ``csrc/attention.cu``.
* its backward, ``fused_attention_bwd``, replaces ``_bwd_kernel`` (:94,
  via ``_attn_bwd`` :184); ``csrc/attention_bwd.cu``.

Up to dh 128 (``uses_mma``) both run their products on the tensor cores
(3xTF32 in fp32; bf16 products for q k^T and dO v^T in bf16, the fp32
probabilities and dS never rounded); wider heads take fp32 FMA kernels.

q, k and v are [B, H, T, dh], fp32 or bf16 (all one dtype), dh <= 256;
``lens`` [B] holds each row's count of keys.  Arithmetic is fp32 and the
output has q's dtype.  A row with lens 0 keeps no key and softmaxes over
all T of them.  Dropout draws the Philox mask ``philox.prob_mask_id(h)``
of the call's seed with the key as the channel and the query as the
position, the bits of ``fused_block``'s kernels and of the unfused
composition's probabilities.

The JAX VJP recomputes the probabilities from q and k; the port's
``torch.autograd.Function`` keeps the forward's fp32 output and the
log2-sum-exp of each query row [B, H, T], and the backward kernel
recomputes the probabilities from them (``csrc/attention_bwd.cu`` says
why both give the same gradients).

On a CPU tensor a wrapper computes its plain version (autograd gives the
plain backward); on a CUDA tensor it launches its kernel or raises.
``launches`` on each of the two public functions counts its kernel
launches, ``mma_launches`` those of its tensor-core kernels.
"""

from __future__ import annotations

import torch

from datamining_recblr_torch.ops import _cuda, fastmath, philox
from datamining_recblr_torch.ops.fused_block import attention_mask
from datamining_recblr_torch.ops.fused_layer import _check_dout, _dropout_args, _lens32

MAX_DH = 256  # head width the kernels' shared memory holds
MMA_MAX_DH = 128  # head width the tensor-core kernels take
_GRID_MAX = 2**31 - 1


def supports(dh: int) -> bool:
    """Whether heads of width ``dh`` take the kernels: 1 <= dh <= MAX_DH.
    Wider heads run the models' softmax composition (``models/layers.py``)."""
    return 1 <= dh <= MAX_DH


def uses_mma(dh: int) -> bool:
    """Whether heads of width ``dh`` take the tensor-core kernels
    (``csrc/attention{,_bwd}.cu`` dispatch on the same fact): dh <= 128;
    wider ones the fp32 FMA kernels."""
    return dh <= MMA_MAX_DH


def scale_of(dh: int) -> float:
    """1 / sqrt(dh) rounded to fp32 as the JAX kernel computes it
    (``1.0 / jnp.sqrt(jnp.float32(dh))``)."""
    return float(1.0 / torch.sqrt(torch.tensor(float(dh), dtype=torch.float32)))


def prob_masks(seed, p, b, h, t, device=None):
    """The probabilities' scaled keep-masks [B, H, T, T]: head h's is
    ``philox.prob_mask_id(h)`` with the query as the position."""
    return torch.stack([philox.dropout_mask(seed, philox.prob_mask_id(i), b, t, t, p, device)
                        for i in range(h)], dim=1)


def fused_attention_plain(q, k, v, lens, seed=0, causal=False, dropout_p=0.0):
    """Plain PyTorch version of ``fused_attention`` (any device;
    differentiable in q, k and v, and its autograd gradient is the plain
    version of ``fused_attention_bwd``)."""
    b, h, t, dh = q.shape
    s = (q.float() @ k.float().transpose(-1, -2)) * scale_of(dh)
    s = s + attention_mask(lens, t, causal, q.device)[:, None]
    e = fastmath.exp(s - s.amax(-1, keepdim=True).detach())
    p = e / e.sum(-1, keepdim=True)
    if dropout_p:
        p = p * prob_masks(seed, dropout_p, b, h, t, q.device)
    return (p @ v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# argument checks
# ---------------------------------------------------------------------------

def _check(q, k, v):
    """Check q, k and v against what the kernels take; return (B, H, T, dh)."""
    if q.dim() != 4:
        raise ValueError(f"q must be [B, H, T, dh], got {tuple(q.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, a in (("q", q), ("k", k), ("v", v)):
        if a.shape != q.shape or a.dtype != q.dtype or a.device != q.device:
            raise ValueError(f"{name} must be {q.dtype} {tuple(q.shape)} on {q.device}, got "
                             f"{a.dtype} {tuple(a.shape)} on {a.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, h, t, dh = q.shape
    if not (1 <= dh <= MAX_DH and min(b, h, t) >= 1 and b * h * t <= _GRID_MAX):
        raise ValueError(f"unsupported shape B={b} H={h} T={t} dh={dh}: the kernels take "
                         f"1 <= dh <= {MAX_DH} and B, H, T >= 1")
    return b, h, t, dh


def _check_saved(saved, q):
    b, h, t, dh = q.shape
    if saved is None or len(saved) != 2:
        raise ValueError("saved must be what the training forward returned")
    for a, shape in zip(saved, ((b, h, t, dh), (b, h, t))):
        if a.dtype != torch.float32 or tuple(a.shape) != shape or a.device != q.device \
                or not a.is_contiguous():
            raise ValueError(f"saved tensors must be contiguous float32 {(b, h, t, dh)} and "
                             f"{(b, h, t)} on {q.device}")
    return saved


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _launch_fwd(q, k, v, lens32, seed, causal, dropout_p, train):
    """The forward; returns (out, o32, lse): with ``train`` the fp32 output
    (``out`` itself for fp32 q) and the [B, H, T] log2-sum-exp, else
    None for both."""
    b, h, t, dh = q.shape
    bf16 = q.dtype == torch.bfloat16
    out = torch.empty_like(q)
    o32 = lse = None
    if train:
        o32 = torch.empty(q.shape, device=q.device, dtype=torch.float32) if bf16 else out
        lse = torch.empty((b, h, t), device=q.device, dtype=torch.float32)
    lib = _cuda.library("attention.cu")
    with torch.cuda.device(q.device):
        err = lib.recblr_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lens32.data_ptr(), out.data_ptr(),
            o32.data_ptr() if bf16 and train else None, None if lse is None else lse.data_ptr(),
            b, h, t, dh, int(bool(causal)), scale_of(dh), int(bf16),
            *_dropout_args(dropout_p, seed), q.device.index, _cuda.stream(q),
        )
    _cuda.check(lib, err, "fused_attention")
    fused_attention.launches += 1
    fused_attention.mma_launches += int(uses_mma(dh))
    return out, o32, lse


def fused_attention_train(q, k, v, lens, seed=0, causal=False, dropout_p=0.0):
    """Forward on the card that keeps what the backward reads:
    (out, (o32 [B, H, T, dh], lse [B, H, T]) fp32)."""
    _cuda.require_cuda(q)
    _check(q, k, v)
    out, o32, lse = _launch_fwd(q, k, v, _lens32(lens, q), seed, causal, dropout_p, True)
    return out, (o32, lse)


def fused_attention_bwd(q, k, v, lens, dout, seed=0, causal=False, dropout_p=0.0, *, saved):
    """Backward of ``fused_attention`` on the card: (dq, dk, dv) in q's
    dtype.  ``saved``: (o32, lse) kept by ``fused_attention_train`` with
    the same arguments."""
    _cuda.require_cuda(q)
    b, h, t, dh = _check(q, k, v)
    lens32 = _lens32(lens, q)
    dout = _check_dout(dout, q.shape, q)
    o32, lse = _check_saved(saved, q)
    delta = torch.empty((b, h, t), device=q.device, dtype=torch.float32)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    lib = _cuda.library("attention_bwd.cu")
    with torch.cuda.device(q.device):
        err = lib.recblr_attn_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lens32.data_ptr(), o32.data_ptr(),
            lse.data_ptr(), dout.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, h, t, dh, int(bool(causal)), scale_of(dh),
            int(q.dtype == torch.bfloat16), *_dropout_args(dropout_p, seed), q.device.index,
            _cuda.stream(q),
        )
    _cuda.check(lib, err, "fused_attention_bwd")
    fused_attention_bwd.launches += 1
    fused_attention_bwd.mma_launches += int(uses_mma(dh))
    return dq, dk, dv


fused_attention_bwd.launches = 0
fused_attention_bwd.mma_launches = 0  # those of them on the tensor cores


# ---------------------------------------------------------------------------
# autograd and the public forward
# ---------------------------------------------------------------------------

class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, lens32, opts):
        out, saved = fused_attention_train(q, k, v, lens32, *opts)
        ctx.opts = opts
        ctx.save_for_backward(q, k, v, lens32, *saved)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lens32, o32, lse = ctx.saved_tensors
        dq, dk, dv = fused_attention_bwd(q, k, v, lens32, dout, *ctx.opts, saved=(o32, lse))
        return dq, dk, dv, None, None


def fused_attention(q, k, v, lens, seed=0, causal=False, dropout_p=0.0):
    """Masked softmax attention, differentiable in q, k and v.  q, k, v:
    [B, H, T, dh] (one dtype, fp32 or bf16); lens: int [B] key counts
    (keys at col >= lens are masked); causal adds the lower-triangular
    mask; the probabilities' dropout rate and the 64-bit seed of its
    masks.  Returns [B, H, T, dh] in q's dtype."""
    if q.device.type == "cpu":
        return fused_attention_plain(q, k, v, lens, seed, causal, dropout_p)
    _cuda.require_cuda(q)
    _check(q, k, v)
    lens32 = _lens32(lens, q)
    if _cuda.needs_grad(q, (k, v)):
        return _Attention.apply(q, k, v, lens32, (int(seed), bool(causal), float(dropout_p)))
    out, _, _ = _launch_fwd(q, k, v, lens32, seed, causal, dropout_p, False)
    return out


fused_attention.launches = 0
fused_attention.mma_launches = 0  # those of them on the tensor cores
