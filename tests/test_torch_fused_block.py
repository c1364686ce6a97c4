"""The port's transformer-layer forwards and the LN prologue against the
JAX package, on the CPU.

The JAX side runs its Pallas kernels in interpret mode (dropout 0); the
port's wrappers take their plain PyTorch versions for a CPU tensor.
Tolerance atol 2e-5 in fp32, the JAX package's own
(``tests/test_fused_block.py``); in bf16 one bf16 ulp of the value on
top of it, since every matmul operand is rounded on both sides and fp32
sums in another order can round a value to the neighbouring bf16."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datamining_recblr_tpu.ops import fused_block as JFB
from datamining_recblr_tpu.ops.fused_layer import fused_ln_dropout as j_ln_dropout
from datamining_recblr_torch.ops import fused_block as FB
from datamining_recblr_torch.ops import fused_layer as FL

ATOL = 2e-5
BF16_RTOL = 2.0 ** -7
SEED = jnp.zeros((1,), jnp.int32)
B, T, D, HEADS, INNER = 5, 12, 16, 2, 32
LENS = np.array([0, 1, T, 7, 4], np.int32)  # empty, one item, full, partial


def _params(rng, d=D, inner=INNER):
    def r(*s, std=0.3):
        return (std * rng.standard_normal(s)).astype(np.float32)

    p = {}
    for n in "qkvo":
        p[f"w_{n}"], p[f"b_{n}"] = r(d, d), r(d, std=0.1)
    p.update(ln1_s=1.0 + r(d, std=0.1), ln1_b=r(d, std=0.1), w1=r(d, inner),
             b1=r(inner, std=0.1), w2=r(inner, d, std=0.2), b2=r(d, std=0.1),
             ln2_s=1.0 + r(d, std=0.1), ln2_b=r(d, std=0.1))
    return p


def _inputs(seed, dtype="float32"):
    rng = np.random.default_rng(seed)
    p = _params(rng)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    if dtype == "bfloat16":
        x = torch.from_numpy(x).to(torch.bfloat16)
        return p, x, jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    return p, torch.from_numpy(x), jnp.asarray(x)


def _check(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert np.isfinite(got).all()
    rtol = BF16_RTOL if dtype == "bfloat16" else 0.0
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=rtol)


def _torch(p):
    return {k: torch.from_numpy(v) for k, v in p.items()}


def _jax(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["gelu", "relu", "silu"])
@pytest.mark.parametrize("causal", [True, False])
def test_layer_matches_jax(causal, act, dtype):
    p, x, jx = _inputs(1 + 2 * causal, dtype)
    want = JFB.fused_transformer_layer(jx, jnp.asarray(LENS), SEED, _jax(p), causal, HEADS,
                                       0.0, 0.0, act, dtype == "bfloat16")
    got = FB.fused_transformer_layer(x, torch.from_numpy(LENS), _torch(p), causal, HEADS, act)
    assert got.dtype == x.dtype and got.shape == (B, T, D)
    _check(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["gelu", "relu", "silu"])
def test_layer_last_matches_jax(act, dtype):
    p, x, jx = _inputs(7, dtype)
    want = JFB.fused_transformer_layer_last(jx, jnp.asarray(LENS), SEED, _jax(p), HEADS,
                                            0.0, 0.0, act, dtype == "bfloat16")
    got = FB.fused_transformer_layer_last(x, torch.from_numpy(LENS), _torch(p), HEADS, act)
    assert got.dtype == x.dtype and got.shape == (B, D)
    _check(got, want, dtype)


@pytest.mark.parametrize("heads", [1, 4])
def test_layer_head_counts_match_jax(heads):
    p, x, jx = _inputs(11)
    for causal in (True, False):
        want = JFB.fused_transformer_layer(jx, jnp.asarray(LENS), SEED, _jax(p), causal,
                                           heads, 0.0, 0.0, "gelu")
        _check(FB.fused_transformer_layer(x, torch.from_numpy(LENS), _torch(p), causal,
                                          heads), want, "float32")
    want = JFB.fused_transformer_layer_last(jx, jnp.asarray(LENS), SEED, _jax(p), heads,
                                            0.0, 0.0, "gelu")
    _check(FB.fused_transformer_layer_last(x, torch.from_numpy(LENS), _torch(p), heads),
           want, "float32")


def test_all_masked_row_softmaxes_over_every_key():
    """lens 0: every key is -10000, so a query attends to all T keys (the
    mask cancels in the softmax); a -inf mask would give NaN."""
    p, x, _ = _inputs(13)
    lens = torch.zeros(B, dtype=torch.int32)
    got = FB.fused_transformer_layer(x, lens, _torch(p), False, HEADS)
    assert torch.isfinite(got).all()
    want = FB.fused_transformer_layer(x, torch.full((B,), T), _torch(p), False, HEADS)
    torch.testing.assert_close(got, want, atol=5e-3, rtol=0)
    # the last-query layer: lens 0 selects no row, its query comes from zeros
    last = FB.fused_transformer_layer_last(x, lens, _torch(p), HEADS)
    q = dict(_torch(p))
    xl = torch.zeros((B, 1, D))
    ctx = FB._attention(xl @ q["w_q"] + q["b_q"], x @ q["w_k"] + q["b_k"],
                        x @ q["w_v"] + q["b_v"], torch.zeros((B, 1, T)), HEADS, False)
    torch.testing.assert_close(last, FB._tail(ctx, xl, q, "gelu", False)[:, 0],
                               atol=5e-3, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 48])
def test_ln_prologue_matches_jax(d, dtype):
    rng = np.random.default_rng(d)
    x = (2.0 * rng.standard_normal((4, 9, d)) + 0.5).astype(np.float32)
    pos = rng.standard_normal((9, d)).astype(np.float32)
    s = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    b = (0.1 * rng.standard_normal(d)).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(tx.float().numpy()).astype(getattr(jnp, dtype))
    want = j_ln_dropout(jx, jnp.asarray(pos), SEED, jnp.asarray(s), jnp.asarray(b), 0.0)
    got = FL.fused_ln_dropout(tx, *map(torch.from_numpy, (pos, s, b)))
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _check(got, want, dtype)


@pytest.mark.parametrize("name", FB.SUPPORTED_ACTS)
def test_activations_match_jax(name):
    x = np.linspace(-6.0, 6.0, 101).astype(np.float32)
    want, _ = JFB._act_pair(name)
    np.testing.assert_allclose(FB.act_fwd(name)(torch.from_numpy(x)).numpy(),
                               np.asarray(want(jnp.asarray(x))), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("shape", [(64, 2, 256, 200, "gelu"), (256, 2, 256, 200, "gelu"),
                                   (64, 3, 256, 200, "gelu"), (64, 2, 256, 2048, "gelu"),
                                   (64, 2, 4096, 200, "gelu"), (64, 2, 256, 200, "mish")])
def test_supports_matches_jax(shape):
    assert FB.supports(*shape) == JFB.supports(*shape)


def test_cpu_calls_do_not_count_launches():
    p, x, _ = _inputs(17)
    lens = torch.from_numpy(LENS)
    before = (FB.fused_transformer_layer.launches, FB.fused_transformer_layer_last.launches,
              FL.fused_ln_dropout.launches)
    FB.fused_transformer_layer(x, lens, _torch(p), True, HEADS)
    FB.fused_transformer_layer_last(x, lens, _torch(p), HEADS)
    FL.fused_ln_dropout(x, torch.zeros((T, D)), torch.ones(D), torch.zeros(D))
    after = (FB.fused_transformer_layer.launches, FB.fused_transformer_layer_last.launches,
             FL.fused_ln_dropout.launches)
    assert before == after == (0, 0, 0)


def test_wrappers_refuse_dropout_and_other_devices():
    p, x, _ = _inputs(19)
    lens = torch.from_numpy(LENS)
    with pytest.raises(NotImplementedError, match="queue A item 3"):
        FB.fused_transformer_layer(x, lens, _torch(p), True, HEADS, dropout_p=0.1)
    with pytest.raises(NotImplementedError, match="queue A item 3"):
        FB.fused_transformer_layer_last(x, lens, _torch(p), HEADS, dropout_p=0.1)
    with pytest.raises(NotImplementedError, match="queue A item 3"):
        FL.fused_ln_dropout(x, torch.zeros((T, D)), torch.ones(D), torch.zeros(D), 0.1)
    meta = torch.zeros((B, T, D), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        FB.fused_transformer_layer(meta, lens, _torch(p), True, HEADS)
    with pytest.raises(ValueError, match="no kernel"):
        FB.fused_transformer_layer_last(meta, lens, _torch(p), HEADS)
    with pytest.raises(ValueError, match="no kernel"):
        FL.fused_ln_dropout(meta, torch.zeros((T, D)), torch.ones(D), torch.zeros(D))
