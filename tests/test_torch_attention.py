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


# ---------------------------------------------------------------------------
# the tensor-core kernels' arithmetic (csrc/attention{,_bwd}.cu, dh <= 128),
# modelled in numpy against the JAX kernels
# ---------------------------------------------------------------------------

F32 = np.float32
LOG2E = F32(1.4426950408889634)
BWD_C = 8  # walked rows a chunk of the backward kernels


def _fwd_kc(bf16):
    """Keys a chunk of the forward kernel (``attention.cu`` FWD_KC)."""
    return 16 if bf16 else 8


def _tf32(a):
    """fp32 rounded to TF32 (10 mantissa bits, nearest, ties away from
    zero), as ``cvt.rna.tf32.f32``."""
    bits = np.asarray(a, F32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(F32)


def _split(a):
    """``mma_tile.cuh`` tf32_split: hi = tf32(a), lo = tf32(a - hi)."""
    hi = _tf32(a)
    return hi, _tf32((np.asarray(a, F32) - hi).astype(F32))


def _f64(*arrays):
    return [np.asarray(a, np.float64) for a in arrays]


def _mm_rows(a, w, bf16):
    """a @ w^T over the last axis as ``mm_rows_t`` (scores, dP): fp32 in
    3xTF32, each 8-deep k-tile in a fresh accumulator (the products exact,
    summed once) added in fp32; bf16 values in 16-deep tiles of exact
    products summed into one fp32 accumulator."""
    acc = np.zeros(a.shape[:-1] + (w.shape[-2],), F32)
    wt = np.swapaxes(w, -1, -2)
    if bf16:
        a64, w64 = _f64(a, wt)
        for k0 in range(0, a.shape[-1], 16):
            sl = slice(k0, k0 + 16)
            acc = (acc + a64[..., sl] @ w64[..., sl, :]).astype(F32)
        return acc
    (ah, al), (wh, wl) = _split(a), _split(wt)
    ah, al, wh, wl = _f64(ah, al, wh, wl)
    for k0 in range(0, a.shape[-1], 8):
        sl = slice(k0, k0 + 8)
        tile = al[..., sl] @ wh[..., sl, :] + ah[..., sl] @ wl[..., sl, :] + ah[..., sl] @ wh[..., sl, :]
        acc = (acc + tile.astype(F32)).astype(F32)
    return acc


def _mm_c(x, w, bf16):
    """x @ w for an fp32 P or dS x whose last axis is one 8-deep k-tile, as
    ``mm_c_w``: x split in two TF32 terms, so never rounded; w fp32 in two
    terms too (3 products), a bf16 w exact in TF32 (lo 0: 2 products); the
    products summed once in a fresh accumulator."""
    xh, xl = _split(x)
    if bf16:
        xh, xl, w64 = _f64(xh, xl, w)
        return (xl @ w64 + xh @ w64).astype(F32)
    wh, wl = _split(w)
    xh, xl, wh, wl = _f64(xh, xl, wh, wl)
    return (xl @ wh + xh @ wl + xh @ wh).astype(F32)


def _fma_rows(a, w):
    """a @ w^T as FMA chains in depth order (one rounding a step): the raw
    scores of a row that keeps no key, alike in all three kernels."""
    x = np.zeros(a.shape[:-1] + (w.shape[-2],), F32)
    for d in range(a.shape[-1]):
        x = (x + a[..., :, d, None].astype(np.float64) * w[..., None, :, d]).astype(F32)
    return x


def _model_scores(raw, i, j, lens_b, t, causal, scale):
    """``attention.cuh`` masked_score: -inf where the key drops out, the
    rounded (s - 10000) + 10000 on a row that keeps no key."""
    s = (raw * scale).astype(F32)
    if lens_b < 1:
        s = ((s + F32(-10000)).astype(F32) - F32(-10000)).astype(F32)
        return np.where(j < t, s, -np.inf).astype(F32)
    keep = (j < min(lens_b, t)) & ((j <= i) if causal else True)
    return np.where(keep, s, -np.inf).astype(F32)


def _chunk(a, c0, rows):
    """Rows c0 .. c0 + rows of a [..., T, dh] array, zero beyond T."""
    out = np.zeros(a.shape[:-2] + (rows, a.shape[-1]), F32)
    part = a[..., c0:c0 + rows, :]
    out[..., :part.shape[-2], :] = part
    return out


def _model_forward(q, k, v, lens, causal, bf16):
    """``attn_fwd_mma_kernel``: the online softmax over chunks of 8 keys (16
    in bf16) below the row's key end (a chunk a query cannot weigh changes
    no bit),
    scores on the tensor cores (FMA chains on a row of lens 0), P V with
    the unnormalised weights; returns (out, lse) fp32."""
    b, h, t, dh = q.shape
    scale = F32(A.scale_of(dh))
    kc_rows = _fwd_kc(bf16)
    out = np.zeros(q.shape, F32)
    lse = np.zeros((b, h, t), F32)
    i = np.arange(t)[:, None]
    for r in range(b):
        kend = min(lens[r], t) if lens[r] >= 1 else t
        m = np.full((h, t), -np.inf, F32)
        l = np.zeros((h, t), F32)
        acc = np.zeros((h, t, dh), F32)
        for c0 in range(0, kend, kc_rows):
            kc, vc = _chunk(k[r], c0, kc_rows), _chunk(v[r], c0, kc_rows)
            raw = _fma_rows(q[r], kc) if lens[r] < 1 else _mm_rows(q[r], kc, bf16)
            s = _model_scores(raw, i, c0 + np.arange(kc_rows)[None], lens[r], t, causal, scale)
            mn = np.maximum(m, s.max(-1))
            alpha = np.where(m == -np.inf, F32(0), np.exp2((m - mn) * LOG2E)).astype(F32)
            with np.errstate(invalid="ignore"):
                e = np.where(s == -np.inf, F32(0), np.exp2((s - mn[..., None]) * LOG2E)).astype(F32)
            l = (l * alpha + e.sum(-1, dtype=F32)).astype(F32)
            m = mn
            acc = (acc * alpha[..., None]).astype(F32)
            for j0 in range(0, kc_rows, 8):
                acc = (acc + _mm_c(e[..., j0:j0 + 8], vc[..., j0:j0 + 8, :], bf16)).astype(F32)
        out[r] = (acc * (F32(1) / l)[..., None]).astype(F32)
        lse[r] = (m * LOG2E + np.log2(l)).astype(F32)
    return out, lse


def _model_backward(q, k, v, lens, dout, out, lse, causal, bf16):
    """``dkdv_mma_kernel`` and ``dq_mma_kernel``: P recomputed from the
    forward's lse, delta = rowsum(dO O), chunks of 8 queries (dK, dV) or 8
    keys (dQ), S and dP on the tensor cores (FMA chains on a row of lens 0),
    then P^T dO, dS^T Q and dS K with P and dS split, never rounded."""
    b, h, t, dh = q.shape
    scale = F32(A.scale_of(dh))
    delta = (dout.astype(np.float64) * out).sum(-1).astype(F32)
    dq, dk, dv = (np.zeros(q.shape, F32) for _ in range(3))
    for r in range(b):
        any_ = lens[r] >= 1
        kend = min(lens[r], t) if any_ else t
        for c0 in range(0, kend, BWD_C):  # dQ, 8 keys a chunk
            kc, vc = _chunk(k[r], c0, BWD_C), _chunk(v[r], c0, BWD_C)
            raw = _mm_rows(q[r], kc, bf16) if any_ else _fma_rows(q[r], kc)
            dp = _mm_rows(dout[r], vc, bf16)
            s = _model_scores(raw, np.arange(t)[:, None], c0 + np.arange(BWD_C)[None], lens[r],
                              t, causal, scale)
            p = np.where(s == -np.inf, F32(0), np.exp2(s * LOG2E - lse[r][..., None])).astype(F32)
            ds = (p * (dp - delta[r][..., None])).astype(F32)
            dq[r] = (dq[r] + _mm_c(ds, kc, bf16)).astype(F32)
        for c0 in range(0, t, BWD_C):  # dK and dV, 8 queries a chunk
            qc, oc = _chunk(q[r], c0, BWD_C), _chunk(dout[r], c0, BWD_C)
            raw = _mm_rows(k[r], qc, bf16) if any_ else _fma_rows(k[r], qc)
            dpt = _mm_rows(v[r], oc, bf16)
            qi = c0 + np.arange(BWD_C)
            s = _model_scores(raw, qi[None], np.arange(t)[:, None], lens[r], t, causal, scale)
            s = np.where(qi[None] < t, s, -np.inf)
            ls, dl = _chunk(lse[r][..., None], c0, BWD_C)[..., 0], _chunk(delta[r][..., None], c0,
                                                                          BWD_C)[..., 0]
            p = np.where(s == -np.inf, F32(0), np.exp2(s * LOG2E - ls[:, None])).astype(F32)
            dst = (p * (dpt - dl[:, None])).astype(F32)
            dv[r] = (dv[r] + _mm_c(p, oc, bf16)).astype(F32)
            dk[r] = (dk[r] + _mm_c(dst, qc, bf16)).astype(F32)
    return (dq * scale).astype(F32), (dk * scale).astype(F32), dv


@pytest.mark.parametrize("dtype,t,dh,causal", [
    ("float32", 200, 128, True), ("bfloat16", 200, 128, False),
    ("float32", 2048, 32, False), ("bfloat16", 2048, 32, True)])
def test_tensor_core_arithmetic_matches_jax(dtype, t, dh, causal):
    """The forward and backward kernels' arithmetic up to dh 128, modelled
    in numpy (3xTF32 with a fresh accumulator per 8-deep k-tile in fp32,
    bf16 products for q k^T and dO v^T in bf16, the fp32 P and dS split in
    two TF32 terms against each operand, the online softmax over the
    forward's chunks of keys, FMA depth-order scores on the row of lens 0),
    against the JAX
    kernels in interpret mode at the d256 path's head (dh 128, T 200) and
    the long path's (dh 32, T 2,048), on standard normal inputs: fp32
    within 1e-4 of the largest JAX value, bf16 that plus one bf16 ulp."""
    rng = np.random.default_rng(t + dh)
    shape = (4, H, t, dh)
    q, k, v, cot = (rng.standard_normal(shape).astype(F32) for _ in range(4))
    if dtype == "bfloat16":
        q, k, v, cot = (torch.from_numpy(a).to(torch.bfloat16).float().numpy()
                        for a in (q, k, v, cot))
    lens = np.array([0, 1, t, 1 + rng.integers(0, t)], np.int32)
    jl, seed = jnp.asarray(lens), jnp.zeros((1,), jnp.int32)
    want, vjp = jax.vjp(lambda a, b, c: j_fused_attention(a, b, c, jl, seed, causal, 0.0),
                        _jax(q, dtype), _jax(k, dtype), _jax(v, dtype))
    wgrads = vjp(_jax(cot, dtype))
    bf16 = dtype == "bfloat16"
    out, lse = _model_forward(q, k, v, lens, causal, bf16)
    grads = _model_backward(q, k, v, lens, cot, out, lse, causal, bf16)
    for name, got, w in zip(("out", "dq", "dk", "dv"), (out, *grads), (want, *wgrads)):
        _assert_close(_torch(got, dtype), w, dtype, name) if bf16 else np.testing.assert_allclose(
            got, np.asarray(w), atol=1e-4 * float(np.abs(np.asarray(w)).max()), rtol=0,
            err_msg=name)


def test_tf32_split_of_a_bf16_value_leaves_lo_zero():
    """A bf16 value (8 significant bits) is exact in TF32 (11): its split
    is (the value, 0), so a product against a bf16 operand needs 2 TF32
    products, not 3; an fp32 value's lo term is not 0."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(4096) * np.exp2(rng.integers(-30, 30, 4096))).astype(F32)
    xb = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    hi, lo = _split(xb)
    assert np.array_equal(hi, xb) and not lo.any()
    hi, lo = _split(x)
    assert np.count_nonzero(lo) > 4000
    rest = np.abs(hi.astype(np.float64) + lo - x)
    assert bool((rest <= 2.0 ** -22 * np.abs(x)).all())
