"""The port's sequence-chunked layer (``ops/fused_layer_chunked.py``)
against the JAX package's ``fused_recurrent_layer_chunked``, whose Pallas
forward and backward kernels run in interpret mode on the CPU, at dropout
0: the plain output and boundary record against ``_chunked_fwd``'s (out,
carry), and dx and every parameter gradient, both by autograd of the plain
version and by the plain backward from the record, against
``jax.value_and_grad``.

Tolerance, fp32: rtol 2e-4 / atol 2e-5, as the JAX package's own chunked
tests (``tests/test_fused_layer_chunked.py:86-95``): scan and matmul sums
in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datamining_recblr_tpu.ops import fused_layer_chunked as JFLC
from datamining_recblr_torch.ops import fused_layer as FL
from datamining_recblr_torch.ops import fused_layer_chunked as FLC

RTOL, ATOL = 2e-4, 2e-5
B, T, D, C, K, CHUNK = 4, 24, 8, 16, 4, 8
SEED = jnp.zeros((1,), jnp.int32)


def _params(rng, use_ffn, prologue):
    def r(*s, std=0.3):
        return (std * rng.standard_normal(s)).astype(np.float32)

    p = {"w_in": r(D, 2 * C), "wc": r(K, C, std=0.5), "bc": r(C), "wg": r(C, 2 * C),
         "bg": r(2 * C), "lam": np.linspace(-2.2, -6.9, C).astype(np.float32),
         "w_out": r(C, D), "ln1_s": 1.0 + r(D, std=0.1), "ln1_b": r(D, std=0.1)}
    if use_ffn:
        p.update(w1=r(D, 4 * D), b1=r(4 * D), w2=r(4 * D, D), b2=r(D),
                 ln2_s=1.0 + r(D, std=0.1), ln2_b=r(D, std=0.1))
    if prologue:
        p.update(pl_s=1.0 + r(D, std=0.1), pl_b=r(D, std=0.1))
    return p


@pytest.mark.parametrize("t,target,want", [(1024, 128, 128), (1024, 256, 256), (200, 128, 40),
                                           (1000, 128, 40), (24, 8, 8), (997, 128, 0),
                                           (520, 128, 104), (1032, 128, 24)])
def test_pick_chunk_matches_jax(t, target, want):
    assert FLC.pick_chunk(t, target) == JFLC.pick_chunk(t, target) == want


@pytest.mark.parametrize("t,k,chunk,want", [(1024, 4, 0, 128), (1024, 9, 0, 0), (997, 4, 0, 0),
                                            (24, 4, 8, 8), (24, 4, 5, 0), (16, 4, 32, 0),
                                            (1000, 8, 0, 40)])
def test_chunk_gate(t, k, chunk, want):
    """A chunk in [max(8, K), T] that divides T, and K <= 8
    (``_chunked_fwd:381``)."""
    assert FLC.chunk_of(t, k, chunk) == want


CASES = [
    pytest.param(True, True, True, id="conv-ffn-prologue"),
    pytest.param(True, True, False, id="conv-ffn"),
    pytest.param(False, True, False, id="ffn"),
    pytest.param(True, False, True, id="conv-prologue"),
    pytest.param(True, False, False, id="conv", marks=pytest.mark.slow),
    pytest.param(False, False, False, id="bare", marks=pytest.mark.slow),
    pytest.param(False, True, True, id="ffn-prologue", marks=pytest.mark.slow),
    pytest.param(False, False, True, id="prologue", marks=pytest.mark.slow),
]


@pytest.mark.parametrize("use_conv,use_ffn,prologue", CASES)
def test_chunked_layer_matches_jax(use_conv, use_ffn, prologue):
    rng = np.random.default_rng(31 + 4 * use_conv + 2 * use_ffn + prologue)
    p = _params(rng, use_ffn, prologue)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    dout = rng.standard_normal((B, T, D)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    want_out, want_carry = JFLC._chunked_fwd(jnp.asarray(x), SEED, jp, use_conv, use_ffn, 0.0,
                                             prologue=prologue, chunk=CHUNK)

    def jloss(a, q):
        out = JFLC.fused_recurrent_layer_chunked(a, SEED, q, use_conv, use_ffn, 0.0, False,
                                                 prologue, CHUNK)
        return jnp.sum(out * dout)

    _, (wdx, wgrads) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(x), jp)

    tx = torch.from_numpy(x).requires_grad_()
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    out, record = FLC.fused_recurrent_layer_chunked_plain(tx, tp, use_conv, use_ffn, prologue,
                                                          chunk=CHUNK)
    assert out.dtype == torch.float32 and record.shape == (B, T // CHUNK, FLC.REC_ROWS, C)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(record.detach().reshape(B, -1, C).numpy(),
                               np.asarray(want_carry), rtol=RTOL, atol=ATOL)
    names = list(tp)
    got = torch.autograd.grad(out, [tx] + [tp[n] for n in names], torch.from_numpy(dout),
                              allow_unused=True)
    got = [torch.zeros_like(v) if g is None else g for g, v in zip(got, [tx, *tp.values()])]
    dx_bwd, grads_bwd = FLC.fused_recurrent_layer_chunked_bwd_plain(
        torch.from_numpy(x), torch.from_numpy(dout), record.detach(),
        {k: torch.from_numpy(v) for k, v in p.items()}, use_conv, use_ffn, prologue,
        chunk=CHUNK)
    for dx in (got[0], dx_bwd):
        np.testing.assert_allclose(dx.numpy(), np.asarray(wdx), rtol=RTOL, atol=ATOL)
    for n, g in zip(names, got[1:]):
        for mine in (g, grads_bwd[n]):
            np.testing.assert_allclose(mine.numpy(), np.asarray(wgrads[n]), rtol=RTOL,
                                       atol=ATOL, err_msg=n)


@pytest.mark.parametrize("p_drop", [0.0, 0.2])
def test_chunked_plain_equals_the_whole_layer(p_drop):
    """The chunked plain version computes ``fused_recurrent_layer``'s
    function with the same masks: its output and its backward from the
    record agree with the whole-sequence plain version's, at dropout 0
    and 0.2 (the masks keyed by absolute position)."""
    rng = np.random.default_rng(37)
    p = {k: torch.from_numpy(v) for k, v in _params(rng, True, True).items()}
    x = torch.from_numpy(rng.standard_normal((B, T, D)).astype(np.float32))
    dout = torch.from_numpy(rng.standard_normal((B, T, D)).astype(np.float32))
    out, record = FLC.fused_recurrent_layer_chunked_plain(x, p, True, True, True, p_drop, 99,
                                                          chunk=CHUNK)
    xl = x.clone().requires_grad_()
    pl = {k: v.clone().requires_grad_() for k, v in p.items()}
    want = FL.fused_recurrent_layer_plain(xl, pl, True, True, True, p_drop, 99)
    torch.testing.assert_close(out, want.detach(), rtol=RTOL, atol=ATOL)
    gw = torch.autograd.grad(want, [xl, *pl.values()], dout)
    dx, grads = FLC.fused_recurrent_layer_chunked_bwd_plain(x, dout, record, p, True, True, True,
                                                            p_drop, 99, chunk=CHUNK)
    torch.testing.assert_close(dx, gw[0], rtol=RTOL, atol=ATOL)
    for n, g in zip(pl, gw[1:]):
        torch.testing.assert_close(grads[n], g, rtol=RTOL, atol=ATOL, msg=n)


def test_cpu_calls_do_not_count_launches_and_other_devices_raise():
    rng = np.random.default_rng(38)
    p = {k: torch.from_numpy(v) for k, v in _params(rng, True, False).items()}
    x = torch.from_numpy(rng.standard_normal((B, T, D)).astype(np.float32)).requires_grad_()
    before = (FLC.fused_recurrent_layer_chunked.launches,
              FLC.fused_recurrent_layer_chunked_bwd.launches)
    FLC.fused_recurrent_layer_chunked(x, p, chunk=CHUNK).sum().backward()
    assert (FLC.fused_recurrent_layer_chunked.launches,
            FLC.fused_recurrent_layer_chunked_bwd.launches) == before == (0, 0)
    with pytest.raises(ValueError, match="chunk"):
        FLC.fused_recurrent_layer_chunked(x, p, chunk=5)
    with pytest.raises(ValueError, match="no kernel"):
        FLC.fused_recurrent_layer_chunked(torch.zeros((B, T, D), device="meta"), p, chunk=CHUNK)
