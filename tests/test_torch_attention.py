"""The masked-softmax attention of the port (``ops/attention.py``) against
the JAX package's ``fused_attention`` (its Pallas kernel in interpret
mode, as ``tests/test_attention.py`` runs it), on the CPU.

q and k hold multiples of 1/8 in [-2, 2], so every score q.k is exact in
fp32 whatever the order of the sum.  At lens 0 every score carries the
-10000 of the mask, where an fp32 ulp is 2^-10: a score one ulp apart in
the two packages' sums would move its probability by 7e-4, the
function's own conditioning there and not the port's.  v and the
cotangent are standard normal.  Tolerances: fp32 atol 2e-5 / rtol 2e-5;
bf16 inputs one bf16 ulp of the value plus 1e-4 of the largest value
(both sides compute in fp32 and round the result once).  Dropout 0
against JAX, whose interpret mode stubs the TPU's bits; within the port
at dropout 0.3 the masks are the fused layer's, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datamining_recblr_tpu.ops.attention import fused_attention as j_fused_attention
from datamining_recblr_torch.ops import attention as A
from datamining_recblr_torch.ops import fused_block as FB
from datamining_recblr_torch.ops import philox

H = 2


def _inputs(seed, t, dh, dtype):
    """q, k (multiples of 1/8), v, cotangent as numpy in the test dtype's
    values, and lens [0, 1, T, 1 + a draw] of four rows."""
    rng = np.random.default_rng(seed)
    shape = (4, H, t, dh)
    q, k = (np.clip(np.round(rng.standard_normal(shape) * 8) / 8, -2, 2).astype(np.float32)
            for _ in range(2))
    v, cot = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    if dtype == "bfloat16":  # bf16 values, so that both sides start from the same inputs
        v, cot = (torch.from_numpy(a).to(torch.bfloat16).float().numpy() for a in (v, cot))
    lens = np.array([0, 1, t, 1 + rng.integers(0, t)], np.int32)
    return q, k, v, cot, lens


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _jax(a, dtype):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _assert_close(got, want, dtype, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5, err_msg=what)
    else:
        atol = 1e-4 * float(np.abs(want).max())
        np.testing.assert_allclose(got, want, atol=atol, rtol=2.0 ** -7, err_msg=what)


CASES = [(t, dh) for t in (7, 24) for dh in (32, 72)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,dh", CASES)
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidirectional"])
def test_forward_matches_jax(causal, t, dh, dtype):
    q, k, v, _, lens = _inputs(t * dh + int(causal), t, dh, dtype)
    want = j_fused_attention(_jax(q, dtype), _jax(k, dtype), _jax(v, dtype), jnp.asarray(lens),
                             jnp.zeros((1,), jnp.int32), causal, 0.0)
    before = A.fused_attention.launches
    got = A.fused_attention(_torch(q, dtype), _torch(k, dtype), _torch(v, dtype),
                            torch.from_numpy(lens), 0, causal, 0.0)
    assert A.fused_attention.launches == before  # the plain version on a CPU tensor
    assert got.dtype == getattr(torch, dtype) and got.shape == (4, H, t, dh)
    _assert_close(got, want, dtype, "out")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,dh", CASES)
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidirectional"])
def test_vjp_matches_jax(causal, t, dh, dtype):
    """dq, dk and dv: the autograd gradient of the plain version against
    the JAX kernel's VJP (its backward kernel in interpret mode)."""
    q, k, v, cot, lens = _inputs(100 + t * dh + int(causal), t, dh, dtype)
    seed = jnp.zeros((1,), jnp.int32)
    jl = jnp.asarray(lens)
    _, vjp = jax.vjp(lambda a, b, c: j_fused_attention(a, b, c, jl, seed, causal, 0.0),
                     _jax(q, dtype), _jax(k, dtype), _jax(v, dtype))
    want = vjp(_jax(cot, dtype))
    tq, tk, tv = (_torch(a, dtype).requires_grad_() for a in (q, k, v))
    out = A.fused_attention(tq, tk, tv, torch.from_numpy(lens), 0, causal, 0.0)
    out.backward(_torch(cot, dtype))
    for got, w, name in zip((tq.grad, tk.grad, tv.grad), want, ("dq", "dk", "dv")):
        assert got.dtype == getattr(torch, dtype)
        _assert_close(got, w, dtype, name)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidirectional"])
def test_dropout_masks_are_the_fused_layers(causal):
    """At dropout 0.3 each head's probabilities take the mask
    ``prob_mask_id(h)`` of the call's seed with the query as the position:
    bit for bit the mask of the fused layer's plain version (and of the
    unfused composition), so the attention agrees with the fused layer's
    at the same seed (atol 1e-6)."""
    b, t, d, seed, p = 3, 11, 16, 987654321, 0.3
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, t, d)).astype(np.float32))
               for _ in range(3))
    lens = torch.tensor([0, 5, t])
    masks = A.prob_masks(seed, p, b, H, t)
    _, _, probs = FB._layer_masks(0.0, p, seed, H, b, t, d, "cpu")
    for h in range(H):
        assert torch.equal(masks[:, h], probs[h])
        assert torch.equal(masks[:, h], philox.dropout_mask(seed, philox.prob_mask_id(h), b, t,
                                                            t, p))
    assert 0.6 < float((masks > 0).float().mean()) < 0.8

    def heads(a):
        return a.reshape(b, t, H, d // H).transpose(1, 2).contiguous()

    got = A.fused_attention(heads(q), heads(k), heads(v), lens, seed, causal, p)
    want = FB._attention(q, k, v, FB.attention_mask(lens, t, causal), H, False, probs)
    torch.testing.assert_close(got.transpose(1, 2).reshape(b, t, d), want, atol=1e-6, rtol=0)
    off = A.fused_attention(heads(q), heads(k), heads(v), lens, seed, causal, 0.0)
    assert float((off - got).abs().max()) > 0.1


def test_wrappers_on_the_cpu():
    """On a CPU tensor the forward is the plain version and counts no
    launch; the backward kernel has no CPU version and says so."""
    q = torch.zeros((1, 1, 4, 8))
    lens = torch.tensor([4])
    before = A.fused_attention.launches
    out = A.fused_attention(q, q, q, lens)
    assert A.fused_attention.launches == before and out.shape == q.shape
    with pytest.raises(ValueError, match="device cpu"):
        A.fused_attention_bwd(q, q, q, lens, q, saved=(q, torch.zeros((1, 1, 4))))
    assert A.scale_of(32) == float(np.float32(1.0) / np.sqrt(np.float32(32)))
