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
