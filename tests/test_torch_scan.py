"""The port's linear scan (``ops/scan.py``, queue B row 7) on the CPU
against the JAX package's Pallas scan in interpret mode: the forward and
the reverse mode as plain versions, and the ``LinearScan`` VJP (the
reverse scan of the cotangent on shift_left(gates), d_gates =
shift_right(h) * d_states) against ``jax.vjp`` of ``linear_scan_pallas``.
Tolerance 1e-5, as ``tests/test_pallas_scan.py:34,47`` (Hillis-Steele on
the TPU side, serial here)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datamining_recblr_tpu.ops.pallas_scan import _scan_fwd_pallas, linear_scan_pallas
from datamining_recblr_tpu.ops.scan import linear_scan as j_linear_scan
from datamining_recblr_torch.ops import scan as SC

TOL = dict(rtol=1e-5, atol=1e-5)


def _case(rng, b, t, c):
    gates = rng.uniform(0.3, 0.999, size=(b, t, c)).astype(np.float32)
    tokens = rng.standard_normal((b, t, c)).astype(np.float32)
    return gates, tokens


# the JAX tests' shapes (exact tile, channel padding, batch + channel
# padding, T 200 at C 256, one step) and C 200, no multiple of 32
SHAPES = [(2, 8, 128), (3, 16, 130), (10, 24, 64), (1, 200, 256), (2, 1, 128), (2, 9, 200)]


@pytest.mark.parametrize("b,t,c", SHAPES)
def test_forward_matches_jax(b, t, c):
    g, x = _case(np.random.default_rng(b * 1000 + t + c), b, t, c)
    want = np.asarray(linear_scan_pallas(jnp.asarray(g), jnp.asarray(x)))
    got = SC.linear_scan(torch.from_numpy(g), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(j_linear_scan(jnp.asarray(g), jnp.asarray(x), impl="pallas")),
        **TOL)


@pytest.mark.parametrize("b,t,c", [(3, 16, 130), (2, 9, 200), (2, 1, 128)])
def test_reverse_matches_jax(b, t, c):
    g, x = _case(np.random.default_rng(7 + t), b, t, c)
    want = np.asarray(_scan_fwd_pallas(jnp.asarray(g), jnp.asarray(x), reverse=True))
    got = SC.linear_scan_reverse(torch.from_numpy(g), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("b,t,c", [(3, 12, 140), (2, 20, 256)])
def test_vjp_matches_jax(b, t, c):
    """The card's autograd.Function, run here on the plain scans: its
    backward is the JAX package's custom VJP; the serial scan's autograd
    gradient is the same."""
    rng = np.random.default_rng(99 + c)
    g, x = _case(rng, b, t, c)
    cot = rng.standard_normal((b, t, c)).astype(np.float32)
    _, vjp = jax.vjp(linear_scan_pallas, jnp.asarray(g), jnp.asarray(x))
    want = [np.asarray(w) for w in vjp(jnp.asarray(cot))]
    for fn in (SC.LinearScan.apply, SC.linear_scan):
        gt, xt = (torch.from_numpy(a).requires_grad_() for a in (g, x))
        fn(gt, xt).backward(torch.from_numpy(cot))
        np.testing.assert_allclose(gt.grad.numpy(), want[0], **TOL)
        np.testing.assert_allclose(xt.grad.numpy(), want[1], **TOL)


def test_cpu_calls_do_not_count_launches():
    g, x = _case(np.random.default_rng(1), 2, 6, 8)
    gt, xt = (torch.from_numpy(a).requires_grad_() for a in (g, x))
    SC.LinearScan.apply(gt, xt).sum().backward()
    SC.linear_scan(gt, xt)
    assert (SC.linear_scan.launches, SC.linear_scan_reverse.launches) == (0, 0)


def test_wrapper_rejects_other_devices():
    x = torch.zeros((2, 12, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        SC.linear_scan(x, x)
    with pytest.raises(ValueError, match="no kernel"):
        SC.linear_scan_reverse(x, x)
