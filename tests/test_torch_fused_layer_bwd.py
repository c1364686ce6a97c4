"""Gradients of the port's fused-layer plain versions (autograd, the
plain versions of the backward kernels) against ``jax.vjp`` of the JAX
package's ``fused_recurrent_layer`` and ``fused_recurrent_layer_last``,
whose Pallas forward and backward kernels run in interpret mode, at
dropout 0 on the CPU.

Tolerance, fp32: dx atol 2e-5 / rtol 1e-4 as the forward tests (scan
order and matmul summation order); each weight gradient rtol 1e-4 and
atol 1e-5 * max|g| (sums over every position)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datamining_recblr_tpu.ops.fused_layer import (
    fused_recurrent_layer as j_layer,
    fused_recurrent_layer_last as j_layer_last,
)
from datamining_recblr_torch.ops import fused_layer as FL

ATOL, RTOL = 2e-5, 1e-4
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-5
K = 4
SEED = jnp.zeros((1,), jnp.int32)


def _params(rng, d, c, use_ffn=True, prologue=False):
    def r(*s):
        return (0.1 * rng.standard_normal(s)).astype(np.float32)

    p = {
        "w_in": r(d, 2 * c), "wc": r(K, c), "bc": r(c), "wg": r(c, 2 * c),
        "bg": r(2 * c), "lam": np.linspace(-6.9, 12.0, c).astype(np.float32),
        "w_out": r(c, d), "ln1_s": 1.0 + r(d), "ln1_b": r(d),
    }
    if use_ffn:
        p.update(w1=r(d, 4 * d), b1=r(4 * d), w2=r(4 * d, d), b2=r(d),
                 ln2_s=1.0 + r(d), ln2_b=r(d))
    if prologue:
        p.update(pl_s=1.0 + r(d), pl_b=r(d))
    return p


def _torch_vjp(fn, x, p, dout):
    xt = torch.from_numpy(x).requires_grad_()
    pt = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    out = fn(xt, pt)
    names = list(pt)
    grads = torch.autograd.grad(out, [xt] + [pt[n] for n in names],
                                torch.from_numpy(dout), allow_unused=True)
    gdict = {n: (g if g is not None else torch.zeros_like(pt[n])).numpy()
             for n, g in zip(names, grads[1:])}
    return out.detach().numpy(), grads[0].numpy(), gdict


def _check(got, want):
    out, dx, grads = got
    wout, wdx, wgrads = want
    np.testing.assert_allclose(out, np.asarray(wout), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(dx, np.asarray(wdx), atol=ATOL, rtol=RTOL)
    assert set(grads) == set(wgrads)
    for name, g in grads.items():
        w = np.asarray(wgrads[name])
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_REL * float(np.abs(w).max()),
                                   err_msg=name)


@pytest.mark.parametrize("use_conv", [True, False])
@pytest.mark.parametrize("use_ffn", [True, False])
@pytest.mark.parametrize("prologue", [True, False])
def test_layer_grads_match_jax(use_conv, use_ffn, prologue):
    rng = np.random.default_rng(10 + 4 * use_conv + 2 * use_ffn + prologue)
    b, t, d, c = 3, 13, 32, 64
    p = _params(rng, d, c, use_ffn, prologue)
    x = (2.0 * rng.standard_normal((b, t, d))).astype(np.float32)
    dout = rng.standard_normal((b, t, d)).astype(np.float32)
    wout, vjp = jax.vjp(
        lambda xx, pp: j_layer(xx, SEED, pp, use_conv, use_ffn, 0.0, False, prologue),
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()})
    wdx, wgrads = vjp(jnp.asarray(dout))
    got = _torch_vjp(lambda xx, pp: FL.fused_recurrent_layer(xx, pp, use_conv, use_ffn,
                                                             prologue), x, p, dout)
    _check(got, (wout, wdx, wgrads))


@pytest.mark.parametrize("use_conv", [True, False])
@pytest.mark.parametrize("use_ffn", [True, False])
def test_layer_last_grads_match_jax(use_conv, use_ffn):
    """Lengths 0 and above T select nothing (dx = 0 on that row, the LN
    and FFN grads still take its tail on zeros); 1 and T are the edges."""
    rng = np.random.default_rng(20 + 2 * use_conv + use_ffn)
    t, d, c = 13, 32, 64
    lens = np.array([0, 1, t, t + 4, 7], np.int32)
    b = len(lens)
    p = _params(rng, d, c, use_ffn)
    x = (2.0 * rng.standard_normal((b, t, d))).astype(np.float32)
    dout = rng.standard_normal((b, d)).astype(np.float32)
    wout, vjp = jax.vjp(
        lambda xx, pp: j_layer_last(xx, jnp.asarray(lens), SEED, pp, use_conv, use_ffn,
                                    0.0, False),
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()})
    wdx, wgrads = vjp(jnp.asarray(dout))
    tl = torch.from_numpy(lens)
    got = _torch_vjp(lambda xx, pp: FL.fused_recurrent_layer_last(xx, tl, pp, use_conv,
                                                                  use_ffn), x, p, dout)
    _check(got, (wout, wdx, wgrads))
    dx = got[1]
    assert not dx[0].any() and not dx[3].any()   # rows that select nothing
    assert not dx[1, 1:].any() and not dx[4, 7:].any()  # at and beyond the length


def test_dropout_plain_versions_are_inverted_dropout_of_the_philox_masks():
    """At p > 0 the plain K2 equals the same layer with the masks applied
    by hand: m1 on W_out's output, m2 on the FFN inner, m3 on its output,
    each [B, 1, .] at (row, position 0)."""
    from datamining_recblr_torch.ops import fastmath, philox

    rng = np.random.default_rng(30)
    t, d, c = 9, 16, 32
    lens = torch.tensor([3, 9, 1])
    p = {k: torch.from_numpy(v) for k, v in _params(rng, d, c).items()}
    x = torch.from_numpy(rng.standard_normal((3, t, d)).astype(np.float32))
    seed, rate = 77, 0.3
    got = FL.fused_recurrent_layer_last(x, lens, p, True, True, rate, seed)
    m = {i: philox.dropout_mask(seed, i, 3, 1, w, rate)[:, 0]
         for i, w in ((1, d), (2, 4 * d), (3, d))}
    h = FL._bdlru(x @ p["w_in"][:, :c], p, True)
    rows = torch.arange(3)
    xl, hl = x[rows, lens - 1], h[rows, lens - 1]
    y = (fastmath.silu(xl @ p["w_in"][:, c:]) * hl) @ p["w_out"] * m[1]
    r1 = FL._ln(y + xl, p["ln1_s"], p["ln1_b"])
    a1 = fastmath.silu(r1 @ p["w1"] + p["b1"]) * m[2]
    want = FL._ln((a1 @ p["w2"] + p["b2"]) * m[3] + r1, p["ln2_s"], p["ln2_b"])
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    assert not torch.equal(got, FL.fused_recurrent_layer_last(x, lens, p))


def test_stash_policy_follows_the_jax_package():
    from datamining_recblr_tpu.ops.fused_layer import _stash_policy

    for b, t, c in [(2048, 200, 128), (8, 256, 128), (8, 257, 128), (4096, 256, 128)]:
        # the port keeps two [B, T, C] fp32 arrays (alpha and h)
        assert FL.stash_policy(b, t, c) == _stash_policy(t, 2 * b * t * c * 4)


# ---------------------------------------------------------------------------
# the backward kernels' weight grads on the tensor cores, emulated in numpy
# ---------------------------------------------------------------------------

ITEM_ROWS = 32  # positions an item of A', C1' and C2' (csrc/common.cuh TT)


def _tf32(a):
    """fp32 rounded to TF32 (10 mantissa bits, nearest, ties away from
    zero), as ``csrc/mma_tile.cuh`` tf32_bits."""
    bits = np.asarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _item_grad(a, b):
    """One item's weight grad a^T b as ``csrc/common_bwd.cuh`` mm_tc takes
    it: A read transposed, the depth the item's rows (a ragged item padded
    with zero rows to a multiple of 8); both operands split into TF32 terms
    (hi = tf32(v), lo = tf32(v - hi)); per 8-deep k-tile a fresh
    accumulator of lo hi + hi lo + hi hi (exact products, summed and
    rounded to fp32 once), added to the running sum in fp32."""
    pad = -a.shape[0] % 8
    a = np.pad(np.asarray(a, np.float32), ((0, pad), (0, 0)))
    b = np.pad(np.asarray(b, np.float32), ((0, pad), (0, 0)))
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    acc = np.zeros((a.shape[1], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[0], 8):
        sl = slice(k0, k0 + 8)
        tile = sum(u[sl].T.astype(np.float64) @ w[sl].astype(np.float64)
                   for u, w in ((al, bh), (ah, bl), (ah, bh)))
        acc = (acc + tile.astype(np.float32)).astype(np.float32)
    return acc


def _weight_grad_scheme(a, b, blocks):
    """sum over every position of a^T b ([B, T, M] and [B, T, N]) as the
    backward kernels sum a weight grad: items of (row, ITEM_ROWS
    positions), block g of ``blocks`` walking items g, g + blocks, ... and
    adding each item's grad into its fp32 partial, then the partials added
    in block order (reduce_partials_kernel)."""
    b_, t = a.shape[:2]
    tiles = -(-t // ITEM_ROWS)
    partial = np.zeros((blocks, a.shape[2], b.shape[2]), np.float32)
    for w in range(b_ * tiles):
        row, t0 = w // tiles, (w % tiles) * ITEM_ROWS
        g = w % blocks
        item = _item_grad(a[row, t0:t0 + ITEM_ROWS], b[row, t0:t0 + ITEM_ROWS])
        partial[g] = (partial[g] + item).astype(np.float32)
    out = np.zeros(partial.shape[1:], np.float32)
    for g in range(blocks):
        out = (out + partial[g]).astype(np.float32)
    return out


def _layer_operands(x, p):
    """The operands of the W_in grad (x, d xz: C2') and of the W_out grad
    (silu(z) h, dy: A') of the plain layer at p = 0 without the prologue,
    from autograd through the plain version's own steps."""
    from datamining_recblr_torch.ops import fastmath

    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    xt = torch.from_numpy(x)
    c = p["w_in"].shape[1] // 2
    xz = (xt @ pt["w_in"]).requires_grad_()
    yin = fastmath.silu(xz[..., c:]) * FL._bdlru(xz[..., :c], pt, True)
    y = yin @ pt["w_out"]
    out = FL._ffn_tail(FL._ln(y + xt, pt["ln1_s"], pt["ln1_b"]), pt)
    torch.testing.assert_close(out, FL.fused_recurrent_layer_plain(xt, pt), atol=0, rtol=0)
    return out, xz, yin, y


@pytest.mark.parametrize("weight", ["w_in", "w_out"])
@pytest.mark.parametrize("b,t,d,c", [(3, 45, 48, 96), (2, 200, 64, 128), (4, 70, 50, 70)])
def test_tensor_core_weight_grads_keep_fp32(weight, b, t, d, c):
    """The weight grads of rows 2 and 4 on the tensor cores (3xTF32 with
    the item's rows as the depth, ragged rows zero, a fresh accumulator
    per 8-deep k-tile, per-block partials reduced in order): within 1e-6
    of the largest value from the fp64 sum, as an fp32 sum is, where one
    TF32 product is not; and the JAX package's gradient of the same
    weight within the backward tests' tolerance.  Widths 48, 50, 70 and
    96 are no multiple of 16, T 45 and 70 end in a ragged item."""
    rng = np.random.default_rng(40 + t + d)
    p = _params(rng, d, c)
    x = (2.0 * rng.standard_normal((b, t, d))).astype(np.float32)
    dout = rng.standard_normal((b, t, d)).astype(np.float32)
    out, xz, yin, y = _layer_operands(x, p)
    if weight == "w_in":
        dxz, = torch.autograd.grad(out, xz, torch.from_numpy(dout))
        a, g = x, dxz.numpy()
    else:
        dy, = torch.autograd.grad(out, y, torch.from_numpy(dout))
        a, g = yin.detach().numpy(), dy.numpy()
    got = _weight_grad_scheme(a, g, blocks=5)
    exact = np.einsum("btm,btn->mn", a.astype(np.float64), g.astype(np.float64))
    scale = float(np.abs(exact).max())
    assert float(np.abs(got - exact).max()) <= 1e-6 * scale
    tf32 = np.einsum("btm,btn->mn", _tf32(a).astype(np.float64), _tf32(g).astype(np.float64))
    assert float(np.abs(tf32 - exact).max()) > 1e-6 * scale
    _, vjp = jax.vjp(lambda pp: j_layer(jnp.asarray(x), SEED, pp, True, True, 0.0, False),
                     {k: jnp.asarray(v) for k, v in p.items()})
    want = np.asarray(vjp(jnp.asarray(dout))[0][weight])
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL_REL * float(np.abs(want).max()))
