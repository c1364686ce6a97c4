"""The softmax cross-entropy forwards as the tensor-core kernels compute
them (``csrc/ce_mma.cuh`` ``ce_fwd_mma_tiles``: row 13's
``ce_fwd_mma_kernel``, fp32 only, and row 14's ``cce_fwd_mma_kernel`` with
``cce_lse_kernel``, fp32 and bf16; ``csrc/fused_ce.cu``
``ce_fwd_wgmma_kernel``, row 13's bf16 forward at D <= 256), emulated in
numpy on the CPU:

* the logits: with ``mm_bf16`` x and the table rounded to bf16 and summed
  in 16-deep k-tiles, otherwise both split into TF32 terms (hi = tf32(v),
  lo = tf32(v - hi)) and lo hi + hi lo + hi hi summed in 8-deep k-tiles;
  each k-tile a fresh accumulator (its products exact, summed and rounded
  to fp32 once), added to the logit in fp32 in depth order; D padded with
  zeros to 64, 128 or 256;
* the bias added, -1e30 at columns >= valid_v;
* the online (max, sum of exp) of each lane (t4 = 0..3 holds the tile's
  columns 8 j + 2 t4 and 8 j + 2 t4 + 1) over the table tiles of 4,096 / DP
  rows in order, the sum rescaled when a tile's max exceeds the running
  one; the four lanes merged in the kernel's butterfly (xor 1, then 2);
* row 13's bf16 forward on wgmma: D padded to 64, 128 or 256, 128-row
  table tiles (the lanes' columns 8 j + 2 t4 (+1), j < 16), each k16
  step's products exact and added into its accumulator truncated to fp32,
  a fresh accumulator every ``WG_KGROUP`` steps added in fp32 (one
  accumulator at DP 64 and 128);
* row 13: nll = lse - l[target] from the tensor-core logits; row 14: the vocab
  splits' partials merged as ``cce_lse_kernel`` does (lane l of a warp the
  splits l, l + 32, ..., then a butterfly over the 32 lanes) and the target
  logit x . table[t] + bias[t] with x unrounded (the table row rounded with
  ``mm_bf16``).

nll and lse are held to the JAX package's ``fused_softmax_ce`` forwards,
``_ce_fwd`` and ``_cce_fwd`` (``vocab_block`` 16: several vocab chunks),
whose Pallas kernels run in interpret mode here, at atol 1e-5, rtol 0: the
tolerance ``test_torch_fused_ce.py`` holds the plain versions to (fp32
sums in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest

from datamining_recblr_tpu.ops import fused_ce as JCE

from test_torch_fused_ce import _tf32

NEG = np.float32(-1e30)
LOG2E = np.float32(1.4426950408889634)
ATOL = 1e-5


def _exp(v):
    """exp as the kernels take it: exp2(v log2 e) in fp32."""
    return np.exp2(np.float32(v) * LOG2E).astype(np.float32)


def _bf16(a):
    """fp32 rounded to bf16 (nearest even), back in fp32."""
    bits = np.asarray(a, np.float32).view(np.uint32)
    bits = (bits + np.uint32(0x7FFF) + ((bits >> 16) & 1)) & np.uint32(0xFFFF0000)
    return bits.view(np.float32)


def _dp(d):
    return 64 if d <= 64 else 128 if d <= 128 else 256


def _logits(x, table, bias, valid_v, mm_bf16):
    """[N, V] fp32 logits as the tensor cores form them (bias and mask
    added)."""
    d = x.shape[1]
    pad = ((0, 0), (0, _dp(d) - d))
    x, table = np.pad(x, pad), np.pad(table, pad)
    if mm_bf16:
        terms, kt = [(_bf16(x), _bf16(table))], 16
    else:
        xh, th = _tf32(x), _tf32(table)
        xl, tl = _tf32(x - xh), _tf32(table - th)
        terms, kt = [(xl, th), (xh, tl), (xh, th)], 8
    acc = np.zeros((x.shape[0], table.shape[0]), np.float32)
    for k0 in range(0, x.shape[1], kt):
        sl = slice(k0, k0 + kt)
        tile = sum(a[:, sl].astype(np.float64) @ b[:, sl].T.astype(np.float64) for a, b in terms)
        acc = (acc + tile.astype(np.float32)).astype(np.float32)
    logits = (acc + bias[None, :]).astype(np.float32)
    logits[:, valid_v:] = NEG
    return logits


def _merge(m, s, om, os):
    """``ce_common.cuh`` lse_merge, elementwise."""
    nm = np.maximum(m, om)
    with np.errstate(invalid="ignore", over="ignore"):
        a = np.where(m == -np.inf, np.float32(0), s * _exp(m - nm))
        b = np.where(om == -np.inf, np.float32(0), os * _exp(om - nm))
    keep = nm == -np.inf
    return np.where(keep, m, nm), np.where(keep, s, (a + b).astype(np.float32))


def _lane_states(logits, t0, t1, dp, bv=None):
    """(m, s) [N, 4] of the four lanes over the table tiles of ``bv`` rows
    (default the mma.sync tiles' 4,096 / DP) t0 .. t1 - 1, then merged over
    the lanes: [N] each."""
    n, v = logits.shape
    bv = bv or 4096 // dp
    m = np.full((n, 4), -np.inf, np.float32)
    s = np.zeros((n, 4), np.float32)
    for vt in range(t0, t1):
        for t4 in range(4):
            cols = [vt * bv + 8 * j + 2 * t4 + q for j in range(bv // 8) for q in range(2)]
            cols = [c for c in cols if c < v]
            if not cols:
                continue
            tmax = logits[:, cols].max(1)
            grow = tmax > m[:, t4]
            with np.errstate(invalid="ignore", over="ignore"):
                s[:, t4] = np.where(grow, s[:, t4] * _exp(m[:, t4] - tmax), s[:, t4])
            m[:, t4] = np.where(grow, tmax, m[:, t4])
            live = m[:, t4] != -np.inf
            for c in cols:
                with np.errstate(invalid="ignore"):
                    s[:, t4] = np.where(live, s[:, t4] + _exp(logits[:, c] - m[:, t4]), s[:, t4])
    for o in (1, 2):
        m, s = _merge(m, s, m[:, np.arange(4) ^ o], s[:, np.arange(4) ^ o])
    return m[:, 0], s[:, 0]


def ce_fwd_scheme(x, table, bias, targets, valid_v):
    """Row 13's tensor-core forward (fp32, 3xTF32): (nll, lse) [N] fp32."""
    logits = _logits(x, table, bias, valid_v, False)
    dp = _dp(x.shape[1])
    m, s = _lane_states(logits, 0, -(-table.shape[0] // (4096 // dp)), dp)
    lse = (m + np.log(s)).astype(np.float32)
    tl = logits[np.arange(x.shape[0]), targets]
    return (lse - tl).astype(np.float32), lse


def cce_fwd_scheme(x, table, bias, targets, valid_v, mm_bf16, splits):
    """Row 14's tensor-core forward and ``cce_lse_kernel``: (nll, lse)."""
    logits = _logits(x, table, bias, valid_v, mm_bf16)
    dp = _dp(x.shape[1])
    ntiles = -(-table.shape[0] // (4096 // dp))
    tps = -(-ntiles // splits)
    parts = [_lane_states(logits, sp * tps, min(ntiles, (sp + 1) * tps), dp)
             for sp in range(splits)]
    n = x.shape[0]
    m = np.full((n, 32), -np.inf, np.float32)
    s = np.zeros((n, 32), np.float32)
    for sp, (pm, ps) in enumerate(parts):
        m[:, sp % 32], s[:, sp % 32] = _merge(m[:, sp % 32], s[:, sp % 32], pm, ps)
    for o in (16, 8, 4, 2, 1):
        m, s = _merge(m, s, m[:, np.arange(32) ^ o], s[:, np.arange(32) ^ o])
    lse = (m[:, 0] + np.log(s[:, 0])).astype(np.float32)
    trow = table[targets]
    if mm_bf16:
        trow = _bf16(trow)
    # lane l sums the columns l, l + 32, ... as an FMA chain, then the lanes
    # in a butterfly
    d = x.shape[1]
    lanes = np.zeros((n, 32), np.float32)
    for d0 in range(0, d, 32):
        w = min(32, d - d0)
        lanes[:, :w] = (lanes[:, :w].astype(np.float64)
                        + x[:, d0:d0 + w].astype(np.float64) * trow[:, d0:d0 + w]
                        ).astype(np.float32)
    for o in (16, 8, 4, 2, 1):
        lanes = (lanes + lanes[:, np.arange(32) ^ o]).astype(np.float32)
    tl = (lanes[:, 0] + bias[targets]).astype(np.float32)
    return (lse - tl).astype(np.float32), lse


# row 13's bf16 forward on wgmma (``csrc/fused_ce.cu`` ce_fwd_wgmma_kernel):
# D padded to DP (64, 128 or 256: 4, 8 or 16 k16 steps), 128-row table
# tiles, at most WG_KGROUP k16 steps an accumulator
WG_BV, WG_KGROUP = 128, 8


def _truncate(v64):
    """fp64 to fp32 toward zero: a tensor core's fp32 sum."""
    f = v64.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v64)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _wgmma_logits(x, table, bias, valid_v, kgroup):
    """[N, V] fp32 logits as ce_fwd_wgmma_kernel forms them: round(x)
    round(table)^T over D padded to DP in k16 steps (each step's 16
    products exact), every step added into its accumulator and truncated
    to fp32 (the first step of an accumulator into zero); an accumulator of
    ``kgroup`` steps, each further one added to the first in fp32
    (nearest); then the bias, -1e30 at columns >= valid_v."""
    dp = _dp(x.shape[1])
    pad = ((0, 0), (0, dp - x.shape[1]))
    xb, tb = _bf16(np.pad(x, pad)).astype(np.float64), _bf16(np.pad(table, pad)).astype(np.float64)
    acc = None
    for g0 in range(0, dp, 16 * kgroup):
        part = np.zeros((x.shape[0], table.shape[0]), np.float32)
        for k0 in range(g0, min(dp, g0 + 16 * kgroup), 16):
            part = _truncate(part.astype(np.float64) + xb[:, k0:k0 + 16] @ tb[:, k0:k0 + 16].T)
        acc = part if acc is None else (acc + part).astype(np.float32)
    logits = (acc + bias[None, :]).astype(np.float32)
    logits[:, valid_v:] = NEG
    return logits


def ce_fwd_wgmma_scheme(x, table, bias, targets, valid_v, kgroup=WG_KGROUP):
    """Row 13's bf16 forward at D <= 256: (nll, lse) [N] fp32, the online
    state of each lane over the 128-row tiles (columns 8 j + 2 t4 + q of a
    tile, j < 16), the four lanes merged in the butterfly (the same for a
    row whichever unit of rows and round of its block it falls in)."""
    logits = _wgmma_logits(x, table, bias, valid_v, kgroup)
    m, s = _lane_states(logits, 0, -(-table.shape[0] // WG_BV), _dp(x.shape[1]), WG_BV)
    lse = (m + np.log(s)).astype(np.float32)
    tl = logits[np.arange(x.shape[0]), targets]
    return (lse - tl).astype(np.float32), lse


def _case(seed, n, v, d, valid_v):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    table = (0.3 * rng.standard_normal((v, d))).astype(np.float32)
    bias = rng.standard_normal(v).astype(np.float32)
    tgt = rng.integers(0, valid_v, n).astype(np.int32)
    tgt[-1] = valid_v - 1  # a target in the last tile
    return x, table, bias, tgt


# (N, V, valid_v, D): V no multiple of the 64-, 32- or 16-row table tile
ROW13 = [(40, 150, 141, 50), (40, 150, 141, 64), (24, 70, 61, 200)]
ROW14 = [(40, 300, 291, 64), (24, 150, 141, 100)]


@pytest.mark.parametrize("n,v,valid_v,d", ROW13)
def test_whole_table_forward_scheme_matches_jax(n, v, valid_v, d):
    """Row 13 in fp32 on ``mma.sync`` (3xTF32; with ``mm_bf16`` it runs on
    wgmma, below; ``fused_ce.fwd_uses_mma``)."""
    x, table, bias, tgt = _case(100 + d, n, v, d, valid_v)
    nll, lse = ce_fwd_scheme(x, table, bias, tgt, valid_v)
    jx, jt, jb, jtg = (jnp.asarray(a) for a in (x, table, bias, tgt))
    want = JCE._ce_fwd(jx, jt, jb, jtg, valid_v, False)
    want_lse = JCE._cce_fwd(jx, jt, jb, jtg, valid_v, False, 16)[1]
    assert np.isfinite(nll).all() and np.isfinite(lse).all()
    np.testing.assert_allclose(nll, np.asarray(want), rtol=0, atol=ATOL)
    np.testing.assert_allclose(lse, np.asarray(want_lse), rtol=0, atol=ATOL)


@pytest.mark.parametrize("mm_bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("splits", [1, 3], ids=["one_split", "three_splits"])
@pytest.mark.parametrize("n,v,valid_v,d", ROW14)
def test_chunked_forward_scheme_matches_jax(n, v, valid_v, d, splits, mm_bf16):
    x, table, bias, tgt = _case(200 + d, n, v, d, valid_v)
    nll, lse = cce_fwd_scheme(x, table, bias, tgt, valid_v, mm_bf16, splits)
    jx, jt, jb, jtg = (jnp.asarray(a) for a in (x, table, bias, tgt))
    want_nll, want_lse = JCE._cce_fwd(jx, jt, jb, jtg, valid_v, mm_bf16, 16)
    assert np.isfinite(nll).all() and np.isfinite(lse).all()
    np.testing.assert_allclose(nll, np.asarray(want_nll), rtol=0, atol=ATOL)
    np.testing.assert_allclose(lse, np.asarray(want_lse), rtol=0, atol=ATOL)


# (N, V, valid_v, D) of row 13's bf16 forward on wgmma: V no multiple of
# its 128-row tile, masked columns, N no multiple of its 128-row unit; D
# padded to 256, and (one accumulator) to 64 and 128
ROW13_WGMMA = [(40, 300, 291, 200), (37, 150, 141, 256), (130, 400, 390, 256),
               (40, 300, 291, 50), (130, 400, 390, 64), (37, 150, 141, 128)]


@pytest.mark.parametrize("n,v,valid_v,d", ROW13_WGMMA)
def test_bf16_wgmma_forward_scheme_matches_jax(n, v, valid_v, d):
    """Row 13 with ``mm_bf16``, as ce_fwd_wgmma_kernel sums it: a fresh
    accumulator every WG_KGROUP k16 steps (at D 256 two, at D <= 128
    one)."""
    x, table, bias, tgt = _case(300 + d + n, n, v, d, valid_v)
    nll, lse = ce_fwd_wgmma_scheme(x, table, bias, tgt, valid_v)
    jx, jt, jb, jtg = (jnp.asarray(a) for a in (x, table, bias, tgt))
    want = JCE._ce_fwd(jx, jt, jb, jtg, valid_v, True)
    want_lse = JCE._cce_fwd(jx, jt, jb, jtg, valid_v, True, 16)[1]
    assert np.isfinite(nll).all() and np.isfinite(lse).all()
    np.testing.assert_allclose(nll, np.asarray(want), rtol=0, atol=ATOL)
    np.testing.assert_allclose(lse, np.asarray(want_lse), rtol=0, atol=ATOL)


def test_one_truncating_accumulator_differs_more():
    """The whole depth in one accumulator, each k16 step truncated into it
    (no fresh accumulator), puts nll or lse beyond the tolerance at D 256,
    where the kernel's k-groups stay within it."""
    x, table, bias, tgt = _case(11, 128, 600, 256, 590)
    j = [jnp.asarray(a) for a in (x, table, bias, tgt)]
    want = np.asarray(JCE._ce_fwd(*j, 590, True))
    want_lse = np.asarray(JCE._cce_fwd(*j, 590, True, 16)[1])

    def err(kgroup):
        nll, lse = ce_fwd_wgmma_scheme(x, table, bias, tgt, 590, kgroup)
        return max(float(np.abs(nll - want).max()), float(np.abs(lse - want_lse).max()))

    assert WG_KGROUP < 256 // 16
    assert err(256 // 16) > ATOL >= err(WG_KGROUP)


def test_one_tf32_product_is_not_enough():
    """The fp32 forward needs the three TF32 products: logits of one (hi
    hi) put nll beyond the tolerance, where the scheme's stay within it."""
    x, table, bias, tgt = _case(164, 40, 150, 64, 141)
    want = np.asarray(JCE._ce_fwd(*(jnp.asarray(a) for a in (x, table, bias, tgt)), 141, False))
    one = (_tf32(x).astype(np.float64) @ _tf32(table).T.astype(np.float64)).astype(np.float32)
    one = one + bias
    one[:, 141:] = NEG
    lse = one.max(1) + np.log(_exp(one - one.max(1, keepdims=True)).sum(1))
    nll = lse - one[np.arange(40), tgt]
    assert float(np.abs(nll - want).max()) > 10 * ATOL
    assert float(np.abs(ce_fwd_scheme(x, table, bias, tgt, 141)[0] - want).max()) <= ATOL


def test_every_masked_column_gives_the_plain_lse():
    """valid_v 0: every logit -1e30, so the lse is -1e30 + log(V) as the
    plain version's (the online sum counts each masked column once)."""
    x, table, bias, tgt = _case(7, 8, 150, 64, 1)
    nll, lse = ce_fwd_scheme(x, table, bias, tgt, 0)
    want = JCE._cce_fwd(*(jnp.asarray(a) for a in (x, table, bias, tgt)), 0, False, 16)[1]
    np.testing.assert_allclose(lse, np.asarray(want), rtol=1e-6)
