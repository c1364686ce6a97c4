"""Counter-based dropout masks: Philox4x32-10, as plain PyTorch.

Counterpart of the TPU kernels' in-kernel PRNG draws
(``datamining_recblr_tpu/ops/fused_layer.py:67-93``, ``_dropout_mask``
and ``_draw_masks``).  The TPU PRNG's bits depend on the block shape and
the order of draws; here a mask element is a pure function of
(seed, mask id, row b, position t, channel):

    key     = (seed mod 2^32, seed >> 32)
    counter = (channel >> 2, t, b, mask id)
    bits    = word (channel & 3) of Philox4x32-10(counter, key)
    mask    = 1/keep if bits < min(keep * 2^32, 2^32 - 1) else 0

so a forward and its backward replay the same mask by construction,
and the CUDA kernels (``csrc/common.cuh`` ``drop_mask``) draw the same
bits as this module.  The arithmetic is int64 tensor arithmetic on
32-bit values, on any device.  Mask ids:

    M0      prologue (RecBLR's input dropout; the attention baselines'
            dropout after LN(x + pos), under the prologue's own seed)
    M1      after the output projection (RecBLR's W_out, the transformer
            layer's W_o)
    M2      RecBLR's FFN inner activation (the transformer layer has none)
    M3      after the FFN's output projection
    4 + h   the transformer layer's softmax probabilities of head h, with
            the key index as the channel and the query position as t

The last-position kernels key their masks by each row's real position
``lens - 1`` (position 0 where the length selects nothing), and the
selected-positions layer by each selected position, so a fused top layer
and the unfused composition draw the same bits there.
"""

from __future__ import annotations

import torch

M0, M1, M2, M3 = 0, 1, 2, 3
ATTN_PROB = 4  # mask id of head h's probabilities: ATTN_PROB + h


def prob_mask_id(head: int) -> int:
    return ATTN_PROB + int(head)

_MUL0, _MUL1 = 0xD2511F53, 0xCD9E8D57   # Random123's Philox4x32 multipliers
_BUMP0, _BUMP1 = 0x9E3779B9, 0xBB67AE85  # its Weyl key increments
_MASK32 = 0xFFFFFFFF


def _mulhilo(a, m: int):
    """(hi, lo) 32-bit words of a * m for int64 tensors a < 2^32 and a
    constant m < 2^32, without int64 overflow (16-bit halves of m)."""
    p_hi = a * (m >> 16)
    p_lo = a * (m & 0xFFFF)
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (mid >> 32), mid & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32 with 10 rounds on int64 tensors holding uint32 values
    (broadcast together); returns the four output words."""
    for r in range(10):
        if r:
            k0 = (k0 + _BUMP0) & _MASK32
            k1 = (k1 + _BUMP1) & _MASK32
        hi0, lo0 = _mulhilo(c0, _MUL0)
        hi1, lo1 = _mulhilo(c2, _MUL1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_threshold(p: float) -> int:
    """Keep iff bits < this (the TPU kernel's rule, fused_layer.py:70-73)."""
    keep = 1.0 - float(p)
    return min(int(keep * 4294967296.0), 4294967295)


def dropout_bits(seed: int, mask_id: int, b: int, t: int, width: int,
                 device=None, t0: int = 0):
    """uint32 draws as int64 [b, t, width] for rows 0..b-1, positions
    t0..t0+t-1 (a time chunk's, under sequence parallelism), channels
    0..width-1 of mask ``mask_id``."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    k0, k1 = seed & _MASK32, seed >> 32
    groups = -(-width // 4)
    kw = dict(device=device, dtype=torch.int64)
    c0 = torch.arange(groups, **kw)[None, None, :]
    c1 = torch.arange(t0, t0 + t, **kw)[None, :, None]
    c2 = torch.arange(b, **kw)[:, None, None]
    c3 = torch.full((1, 1, 1), int(mask_id), **kw)
    words = philox4x32_10(c0, c1, c2, c3, k0, k1)
    bits = torch.stack(torch.broadcast_tensors(*words), dim=-1)
    return bits.reshape(b, t, 4 * groups)[..., :width]


def dropout_mask(seed: int, mask_id: int, b: int, t: int, width: int, p: float,
                 device=None, t0: int = 0):
    """Scaled keep-mask [b, t, width] fp32 at positions t0..t0+t-1:
    1/(1-p) where kept, else 0."""
    return _scaled(dropout_bits(seed, mask_id, b, t, width, device, t0), p, device)


def dropout_mask_at(seed: int, mask_id: int, pos, width: int, p: float):
    """Scaled keep-mask of row b at the positions ``pos[b]``: ``pos`` an
    integer tensor [B] (the last-query layer) -> [B, width], or [B, S]
    (the selected-positions layer) -> [B, S, width]; element [b, s] is
    ``dropout_mask(...)[b, pos[b, s]]``."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    kw = dict(device=pos.device, dtype=torch.int64)
    groups = -(-width // 4)
    rows = torch.arange(pos.shape[0], **kw).reshape((-1,) + (1,) * pos.dim())
    words = philox4x32_10(
        torch.arange(groups, **kw), pos.to(torch.int64)[..., None], rows,
        torch.full((1,), int(mask_id), **kw), seed & _MASK32, seed >> 32)
    bits = torch.stack(torch.broadcast_tensors(*words), dim=-1)
    return _scaled(bits.reshape(*pos.shape, 4 * groups)[..., :width], p, pos.device)


def _row_words(seed: int, b: int, t: int, device=None, row0: int = 0):
    """int64 [b, t]: word (position & 3) of Philox4x32-10 at counter
    (position >> 2, row, 0, 0) under the 64-bit ``seed``, for the rows
    row0 .. row0 + b - 1."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    kw = dict(device=device, dtype=torch.int64)
    groups = -(-t // 4)
    zero = torch.zeros((1, 1), **kw)
    words = philox4x32_10(torch.arange(groups, **kw)[None, :],
                          torch.arange(row0, row0 + b, **kw)[:, None], zero, zero,
                          seed & _MASK32, seed >> 32)
    return torch.stack(torch.broadcast_tensors(*words), dim=-1).reshape(b, 4 * groups)[:, :t]


def cloze_draw(seed: int, b: int, t: int, ratio: float, device=None, row0: int = 0):
    """BERT4Rec's cloze draw: bool [b, t], True with probability ``ratio``
    at each (row, position), from ``_row_words`` under its own 64-bit
    ``seed`` (one of ``step_seeds``, apart from every dropout seed), so it
    needs no mask id and a resumed run replays it.  ``row0``: the global
    index of the first row (a data rank's part of a batch draws the
    global batch's bits)."""
    words = _row_words(seed, b, t, device, row0)
    return words < min(int(float(ratio) * 4294967296.0), 4294967295)


def uniform_ints(seed: int, b: int, t: int, lo: int, hi: int, device=None, row0: int = 0):
    """int64 [b, t] in [lo, hi): ``lo + (word * (hi - lo)) >> 32`` of
    ``_row_words`` under its own ``seed`` (BERT4Rec's BPR negatives), for
    the rows from ``row0``."""
    return lo + ((_row_words(seed, b, t, device, row0) * (int(hi) - int(lo))) >> 32)


def _scaled(bits, p, device):
    scale = torch.tensor(1.0 / (1.0 - float(p)), dtype=torch.float32, device=device)
    return torch.where(bits < keep_threshold(p), scale, torch.zeros_like(scale))


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return z ^ (z >> 31)


def step_seeds(base_seed: int, step: int, n: int) -> list[int]:
    """``n`` 64-bit dropout seeds for one training step: a function of
    (base seed, global step, index) alone, so a resumed run replays the
    same masks (the role of ``fold_in(base_rng, step)`` in the JAX
    trainer)."""
    s = _splitmix64(_splitmix64(int(base_seed) & 0xFFFFFFFFFFFFFFFF) ^ int(step))
    return [_splitmix64(s ^ _splitmix64(i + 1)) for i in range(n)]
