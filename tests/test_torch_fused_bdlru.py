"""The port's ``fused_bdlru`` (conv + SiLU + gate matmul + decay + scan,
queue B row 8) on the CPU: its plain version and the plain version's
autograd gradients against the JAX package's ``fused_bdlru`` (its Pallas
kernels in interpret mode), with and without the conv.  Tolerances of
``tests/test_fused_bdlru.py:43,61``: the forward within 2e-5, the
gradients within rtol 3e-4 / atol 3e-5."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datamining_recblr_torch.ops import fused_bdlru as FBD

# the JAX ops package exports a function of the same name as this module
jbdlru = importlib.import_module("datamining_recblr_tpu.ops.fused_bdlru")

NAMES = ("dx", "dwc", "dbc", "dwg", "dbg", "dlam")


def _case(rng, b, t, c, k=4):
    """x, wc, bc, wg, bg, lam as the JAX test draws them."""
    return [
        rng.standard_normal((b, t, c)).astype(np.float32),
        (0.3 * rng.standard_normal((k, c))).astype(np.float32),
        (0.3 * rng.standard_normal((c,))).astype(np.float32),
        (0.1 * rng.standard_normal((c, 2 * c))).astype(np.float32),
        (0.1 * rng.standard_normal((2 * c,))).astype(np.float32),
        np.linspace(-2.2, -6.9, c).astype(np.float32),
    ]


@pytest.mark.parametrize("b,t,c", [(4, 12, 128), (3, 9, 64), (10, 24, 128)])
@pytest.mark.parametrize("use_conv", [True, False])
def test_forward_matches_jax(b, t, c, use_conv):
    args = _case(np.random.default_rng(b + t + c), b, t, c)
    want = np.asarray(jbdlru.fused_bdlru(*map(jnp.asarray, args), use_conv))
    got = FBD.fused_bdlru(*map(torch.from_numpy, args), use_conv)
    assert got.dtype == torch.float32 and got.shape == (b, t, c)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("use_conv", [True, False])
def test_gradients_match_jax(use_conv):
    """dx and the five weight grads; without the conv dwc and dbc are 0 on
    both sides (the plain version does not read them)."""
    rng = np.random.default_rng(17)
    args = _case(rng, 5, 10, 32, k=3)  # batch not a multiple of the JAX block
    cot = rng.standard_normal(args[0].shape).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jbdlru.fused_bdlru(*a, use_conv), *map(jnp.asarray, args))
    want = vjp(jnp.asarray(cot))
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    FBD.fused_bdlru(*ts, use_conv).backward(torch.from_numpy(cot))
    for t, w, name in zip(ts, want, NAMES):
        g = t.grad if t.grad is not None else torch.zeros_like(t)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=3e-4, atol=3e-5, err_msg=name)
    if not use_conv:
        assert not np.asarray(want[1]).any() and not np.asarray(want[2]).any()


def test_long_odd_sequence_matches_jax():
    """T 515, no multiple of 8 (the sequence the chunked layer cannot
    take), one row per JAX block."""
    args = _case(np.random.default_rng(5), 2, 515, 32)
    want = np.asarray(jbdlru.fused_bdlru(*map(jnp.asarray, args), True))
    got = FBD.fused_bdlru(*map(torch.from_numpy, args), True)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_bf16_input_returns_bf16_rounded_once():
    args = [torch.from_numpy(a) for a in _case(np.random.default_rng(6), 3, 12, 64)]
    xb = args[0].to(torch.bfloat16)
    got = FBD.fused_bdlru(xb, *args[1:])
    assert got.dtype == torch.bfloat16
    want = FBD.fused_bdlru(xb.float(), *args[1:])
    torch.testing.assert_close(got, want.to(torch.bfloat16), atol=0, rtol=0)


def test_supports_is_the_jax_rule():
    for c in (1, 64, 128, 129, 144, 256):
        assert FBD.supports(c) == jbdlru.supports(c)


def test_cpu_calls_do_not_count_launches():
    ts = [torch.from_numpy(a).requires_grad_() for a in _case(np.random.default_rng(7), 2, 6, 8)]
    FBD.fused_bdlru(*ts).sum().backward()
    assert (FBD.fused_bdlru.launches, FBD.fused_bdlru_bwd.launches) == (0, 0)


def test_wrapper_rejects_other_devices():
    args = [torch.zeros(a.shape, device="meta") for a in _case(np.random.default_rng(8), 2, 6, 8)]
    with pytest.raises(ValueError, match="no kernel"):
        FBD.fused_bdlru(*args)
