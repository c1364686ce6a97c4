"""The port's ``fused_dropout_ln`` (LN(dropout(x)), a one-layer RecBLR's
input dropout and LN) on the CPU: its plain version and the plain
version's autograd gradients against the JAX package's
``fused_dropout_ln`` (its Pallas kernels in interpret mode, dropout 0),
and the mask it draws at p > 0.  Tolerances of
``tests/test_fused_layer.py:147-168``: the forward within 3e-5, dx,
dscale and dbias within rtol 5e-4 / atol 5e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datamining_recblr_tpu.ops.fused_layer import fused_dropout_ln as j_dropout_ln
from datamining_recblr_torch.models import layers as L
from datamining_recblr_torch.ops import fused_layer as FL
from datamining_recblr_torch.ops import philox

SEED = jnp.zeros((1,), jnp.int32)


def _case(rng, b, t, d):
    x = (2.0 * rng.standard_normal((b, t, d))).astype(np.float32)
    s = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(d)).astype(np.float32)
    cot = rng.standard_normal((b, t, d)).astype(np.float32)
    return x, s, bias, cot


@pytest.mark.parametrize("b,t,d", [(5, 12, 32), (3, 50, 64), (2, 7, 48)])
def test_dropout_ln_and_its_gradients_match_jax(b, t, d):
    x, s, bias, cot = _case(np.random.default_rng(b * t + d), b, t, d)
    want, vjp = jax.vjp(lambda x_, s_, b_: j_dropout_ln(x_, SEED, s_, b_, 0.0),
                        jnp.asarray(x), jnp.asarray(s), jnp.asarray(bias))
    xt, st, bt = (torch.from_numpy(a).requires_grad_() for a in (x, s, bias))
    got = FL.fused_dropout_ln(xt, st, bt)
    assert got.dtype == torch.float32 and got.shape == (b, t, d)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=3e-5, atol=3e-5)
    got.backward(torch.from_numpy(cot))
    for g, w, name in zip((xt.grad, st.grad, bt.grad), vjp(jnp.asarray(cot)),
                          ("dx", "dscale", "dbias")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-4, atol=5e-5,
                                   err_msg=name)


@pytest.mark.parametrize("p", [0.2, 0.4])
def test_the_mask_is_the_plain_dropout_of_x(p):
    """At p > 0 the fused composition is LN(layers.dropout(x, p, seed)):
    the M0 mask of the seed at the same coordinates, and dx is 0 exactly
    where it drops."""
    x, s, bias, cot = _case(np.random.default_rng(3), 4, 50, 64)
    seed = 1234567
    xt = torch.from_numpy(x).requires_grad_()
    st, bt = torch.from_numpy(s), torch.from_numpy(bias)
    got = FL.fused_dropout_ln(xt, st, bt, p, seed)
    want = L.layer_norm({"scale": st, "bias": bt}, L.dropout(xt.detach(), p, seed))
    torch.testing.assert_close(got.detach(), want, atol=1e-6, rtol=1e-6)
    got.backward(torch.from_numpy(cot))
    keep = philox.dropout_mask(seed, philox.M0, 4, 50, 64, p) > 0
    assert torch.equal(xt.grad != 0, keep)
    assert 0.5 < float(keep.float().mean()) < 0.9


def test_bf16_input_rounds_once():
    x, s, bias, _ = _case(np.random.default_rng(4), 3, 12, 32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    st, bt = torch.from_numpy(s), torch.from_numpy(bias)
    got = FL.fused_dropout_ln(xb, st, bt, 0.2, 77)
    assert got.dtype == torch.bfloat16
    want = FL.fused_dropout_ln(xb.float(), st, bt, 0.2, 77)
    torch.testing.assert_close(got, want.to(torch.bfloat16), atol=0, rtol=0)


def test_cpu_calls_do_not_count_launches():
    before = (FL.fused_dropout_ln.launches, FL.fused_dropout_ln_bwd.launches)
    x, s, bias, cot = _case(np.random.default_rng(5), 2, 12, 16)
    xt = torch.from_numpy(x).requires_grad_()
    FL.fused_dropout_ln(xt, torch.from_numpy(s), torch.from_numpy(bias), 0.2, 5).sum().backward()
    assert (FL.fused_dropout_ln.launches, FL.fused_dropout_ln_bwd.launches) == before == (0, 0)


def test_wrapper_rejects_other_devices():
    x = torch.zeros((2, 12, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        FL.fused_dropout_ln(x, torch.ones(16, device="meta"), torch.zeros(16, device="meta"))
