"""The port's fused-layer forwards and their pieces against the JAX
package, on the CPU.

The JAX side runs the Pallas kernels in interpret mode (dropout 0); the
port's wrappers take their plain PyTorch versions for a CPU tensor.
Tolerance for fp32: atol 2e-5 / rtol 1e-4, from the two scan orders
(Hillis-Steele in the TPU kernel, serial in the port) and fp32 matmul
summation order."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datamining_recblr_tpu.ops import conv as jconv
from datamining_recblr_tpu.ops import fastmath as jfastmath
from datamining_recblr_tpu.ops import scan as jscan
from datamining_recblr_tpu.ops.fused_layer import (
    fused_recurrent_layer as j_layer,
    fused_recurrent_layer_last as j_layer_last,
)
from datamining_recblr_torch.ops import conv, fastmath, fused_bdlru, scan
from datamining_recblr_torch.ops import fused_layer as FL

# the JAX ops package exports a function of the same name as this module
jbdlru = importlib.import_module("datamining_recblr_tpu.ops.fused_bdlru")

ATOL, RTOL = 2e-5, 1e-4
K = 4


def _params(rng, d, c, use_ffn=True, prologue=False):
    def r(*s):
        return (0.1 * rng.standard_normal(s)).astype(np.float32)

    p = {
        "w_in": r(d, 2 * c), "wc": r(K, c), "bc": r(c), "wg": r(c, 2 * c),
        "bg": r(2 * c),
        # spans fast and slow decay, and a softplus argument far from 0
        "lam": np.linspace(-6.9, 12.0, c).astype(np.float32),
        "w_out": r(c, d),
        "ln1_s": 1.0 + r(d), "ln1_b": r(d),
    }
    if use_ffn:
        p.update(w1=r(d, 4 * d), b1=r(4 * d), w2=r(4 * d, d), b2=r(d),
                 ln2_s=1.0 + r(d), ln2_b=r(d))
    if prologue:
        p.update(pl_s=1.0 + r(d), pl_b=r(d))
    return p


def _torch(p):
    return {k: torch.from_numpy(v) for k, v in p.items()}


def _jax(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


SEED = jnp.zeros((1,), jnp.int32)


@pytest.mark.parametrize("use_conv", [True, False])
@pytest.mark.parametrize("use_ffn", [True, False])
@pytest.mark.parametrize("prologue", [True, False])
def test_layer_matches_jax(use_conv, use_ffn, prologue):
    rng = np.random.default_rng(4 * use_conv + 2 * use_ffn + prologue)
    b, t, d, c = 3, 13, 32, 64
    p = _params(rng, d, c, use_ffn, prologue)
    x = (2.0 * rng.standard_normal((b, t, d))).astype(np.float32)
    want = j_layer(jnp.asarray(x), SEED, _jax(p), use_conv, use_ffn, 0.0,
                   False, prologue)
    got = FL.fused_recurrent_layer(torch.from_numpy(x), _torch(p), use_conv,
                                   use_ffn, prologue)
    assert got.dtype == torch.float32 and got.shape == (b, t, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("use_conv", [True, False])
@pytest.mark.parametrize("use_ffn", [True, False])
def test_layer_last_matches_jax(use_conv, use_ffn):
    rng = np.random.default_rng(10 + 2 * use_conv + use_ffn)
    b, t, d, c = 5, 16, 16, 32
    p = _params(rng, d, c, use_ffn)
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    lens = np.array([0, 1, t, 7, t - 1], np.int32)  # empty, single, full
    want = j_layer_last(jnp.asarray(x), jnp.asarray(lens), SEED, _jax(p),
                        use_conv, use_ffn, 0.0)
    got = FL.fused_recurrent_layer_last(torch.from_numpy(x),
                                        torch.from_numpy(lens), _torch(p),
                                        use_conv, use_ffn)
    assert got.shape == (b, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_layer_last_length_zero_is_the_tail_on_zeros():
    """lens = 0 selects no row: x_last = 0 and h_last = 0, unlike
    gather_last, which would clip to position 0."""
    rng = np.random.default_rng(3)
    b, t, d, c = 2, 12, 16, 32
    p = _torch(_params(rng, d, c))
    x = torch.from_numpy(rng.standard_normal((b, t, d)).astype(np.float32))
    lens = torch.tensor([0, 0])
    got = FL.fused_recurrent_layer_last(x, lens, p)
    want = FL._ffn_tail(FL._ln(torch.zeros((b, d)), p["ln1_s"], p["ln1_b"]), p)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    # the output does not depend on x at all
    got2 = FL.fused_recurrent_layer_last(x + 1.0, lens, p)
    torch.testing.assert_close(got, got2, atol=0, rtol=0)


def test_layer_bf16_io_rounds_like_fp32():
    rng = np.random.default_rng(5)
    b, t, d, c = 3, 12, 32, 64
    p = _torch(_params(rng, d, c, prologue=True))
    x = torch.from_numpy(rng.standard_normal((b, t, d)).astype(np.float32))
    xb = x.to(torch.bfloat16)
    got = FL.fused_recurrent_layer(xb, p, prologue=True)
    assert got.dtype == torch.bfloat16
    want = FL.fused_recurrent_layer(xb.float(), p, prologue=True)
    torch.testing.assert_close(got, want.to(torch.bfloat16), atol=0, rtol=0)


def test_cpu_calls_do_not_count_launches():
    before = (FL.fused_recurrent_layer.launches,
              FL.fused_recurrent_layer_last.launches)
    rng = np.random.default_rng(6)
    p = _torch(_params(rng, 16, 32))
    x = torch.from_numpy(rng.standard_normal((2, 12, 16)).astype(np.float32))
    FL.fused_recurrent_layer(x, p)
    FL.fused_recurrent_layer_last(x, torch.tensor([3, 12]), p)
    after = (FL.fused_recurrent_layer.launches,
             FL.fused_recurrent_layer_last.launches)
    assert before == after == (0, 0)


def test_wrapper_rejects_other_devices():
    rng = np.random.default_rng(7)
    p = _torch(_params(rng, 16, 32))
    x = torch.zeros((2, 12, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        FL.fused_recurrent_layer(x, p)


def test_conv_and_bdlru_pieces_match_jax():
    rng = np.random.default_rng(8)
    b, t, c = 3, 14, 32
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    wc = rng.standard_normal((K, c)).astype(np.float32)
    bc = rng.standard_normal((c,)).astype(np.float32)
    wg = (0.2 * rng.standard_normal((c, 2 * c))).astype(np.float32)
    bg = rng.standard_normal((2 * c,)).astype(np.float32)
    lam = np.linspace(-5.0, 40.0, c).astype(np.float32)
    tx, twc, tbc = map(torch.from_numpy, (x, wc, bc))
    np.testing.assert_allclose(
        conv.causal_depthwise_conv(tx, twc, tbc).numpy(),
        np.asarray(jconv.causal_depthwise_conv(jnp.asarray(x), wc, bc)),
        atol=ATOL, rtol=RTOL,
    )
    # fewer steps than taps: causal, so the first steps of the long input
    torch.testing.assert_close(conv.causal_depthwise_conv(tx[:, :2], twc, tbc),
                               conv.causal_depthwise_conv(tx, twc, tbc)[:, :2],
                               atol=0, rtol=0)
    got = fused_bdlru._gate_math(tx, *map(torch.from_numpy, (wg, bg, lam)))
    want = jbdlru._gate_math(jnp.asarray(x), wg, bg, lam)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(fastmath.silu(tx).numpy(),
                               np.asarray(jfastmath.silu(jnp.asarray(x))),
                               atol=1e-6, rtol=1e-6)


def test_serial_scan_matches_jax():
    rng = np.random.default_rng(9)
    g = rng.uniform(0.5, 1.0, (3, 15, 8)).astype(np.float32)
    x = rng.standard_normal((3, 15, 8)).astype(np.float32)
    got = scan.linear_scan_serial(torch.from_numpy(g), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), jscan.linear_scan_serial(g, x),
                               atol=0, rtol=0)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jscan.linear_scan(jnp.asarray(g), jnp.asarray(x))),
        atol=ATOL, rtol=RTOL,
    )
