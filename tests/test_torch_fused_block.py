"""The port's transformer-layer forwards and the LN prologue against the
JAX package, on the CPU.

The JAX side runs its Pallas kernels in interpret mode (dropout 0); the
port's wrappers take their plain PyTorch versions for a CPU tensor.
Tolerance atol 2e-5 in fp32, the JAX package's own
(``tests/test_fused_block.py``); in bf16 one bf16 ulp of the value on
top of it, since every matmul operand is rounded on both sides and fp32
sums in another order can round a value to the neighbouring bf16."""

import jax
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
    """The wrappers take dropout now: the prologue multiplies by the M0
    mask of its seed, and each layer draws the masks the unfused
    composition of ``models/layers.py`` draws at the same coordinates
    (the last-query layer at each row's position lens - 1).  A device
    without kernels still raises."""
    from datamining_recblr_torch.ops import philox

    p, x, _ = _inputs(19)
    lens = torch.from_numpy(LENS)
    pos, s, b = torch.zeros((T, D)), torch.ones(D), torch.zeros(D)
    got = FL.fused_ln_dropout(x, pos, s, b, 0.1, 77)
    mask = philox.dropout_mask(77, philox.M0, B, T, D, 0.1)
    torch.testing.assert_close(got, FL.fused_ln_dropout(x, pos, s, b) * mask, atol=1e-6,
                               rtol=0)
    layer = _layer_tree(_torch(p))
    drop = (0.3, 0.4, 123)
    got = FB.fused_transformer_layer(x, lens, _torch(p), True, HEADS, "gelu", *drop)
    want = _unfused_layer(layer, x, lens, True, drop)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert (got - FB.fused_transformer_layer(x, lens, _torch(p), True, HEADS)).abs().max() > 0.1
    last = FB.fused_transformer_layer_last(x, lens, _torch(p), HEADS, "gelu", *drop)
    rows = [i for i, n in enumerate(LENS) if 1 <= n <= T]
    idx = torch.from_numpy(LENS[rows]).long() - 1
    torch.testing.assert_close(last[rows], want[rows, idx], atol=1e-5, rtol=1e-5)
    meta = torch.zeros((B, T, D), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        FB.fused_transformer_layer(meta, lens, _torch(p), True, HEADS)
    with pytest.raises(ValueError, match="no kernel"):
        FB.fused_transformer_layer_last(meta, lens, _torch(p), HEADS)
    with pytest.raises(ValueError, match="no kernel"):
        FL.fused_ln_dropout(meta, torch.zeros((T, D)), torch.ones(D), torch.zeros(D))


def _layer_tree(p):
    """Flat kernel parameters -> one encoder layer of models/layers.py."""
    return {n: {"w": p[f"w_{k}"], "b": p[f"b_{k}"]}
            for k, n in (("q", "q"), ("k", "k"), ("v", "v"), ("o", "attn_out"))} | {
        "attn_ln": {"scale": p["ln1_s"], "bias": p["ln1_b"]},
        "ffn_1": {"w": p["w1"], "b": p["b1"]}, "ffn_2": {"w": p["w2"], "b": p["b2"]},
        "ffn_ln": {"scale": p["ln2_s"], "bias": p["ln2_b"]}}


def _unfused_layer(layer, x, lens, causal, drop):
    from datamining_recblr_torch.models import layers as ML

    seq = (torch.arange(T)[None, :] < lens[:, None]).long()
    mask = ML.attention_mask(seq, bidirectional=not causal)
    hidden, attn, seed = drop
    return ML.transformer_encoder_apply([layer], x, mask, n_heads=HEADS,
                                        hidden_dropout=hidden, attn_dropout=attn,
                                        seeds=[seed])


# ---------------------------------------------------------------------------
# gradients: autograd of the plain versions against jax.grad of the JAX
# package's kernels (their backward kernels in interpret mode), fp32,
# dropout 0; rtol 1e-4 and atol 1e-5 of each gradient's largest value
# (fp32 sums in another order), at least 1e-6 of the call's largest
# gradient (b_k's is zero up to rounding: the softmax ignores a shift
# that every key shares, and what is left is fp32 cancellation noise)
# ---------------------------------------------------------------------------

def _check_grads(got, want):
    top = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    for name, g in got.items():
        w = np.asarray(want[name])
        atol = max(1e-5 * float(np.abs(w).max()), 1e-6 * top)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=atol, err_msg=name)


def _torch_grads(fn, x, p, dout):
    xl = x.clone().requires_grad_()
    pl = {k: v.clone().requires_grad_() for k, v in p.items()}
    (fn(xl, pl) * dout).sum().backward()
    return {"x": xl.grad, **{k: v.grad for k, v in pl.items()}}


def _jax_grads(fn, jx, jp, dout):
    gx, gp = jax.grad(lambda a, q: jnp.sum(fn(a, q) * dout), argnums=(0, 1))(jx, jp)
    return {"x": gx, **gp}


@pytest.mark.parametrize("causal", [True, False])
def test_layer_grads_match_jax(causal):
    p, x, jx = _inputs(23 + causal)
    dout = np.random.default_rng(5).standard_normal((B, T, D)).astype(np.float32)
    lens = torch.from_numpy(LENS)
    got = _torch_grads(lambda a, q: FB.fused_transformer_layer(a, lens, q, causal, HEADS),
                       x, _torch(p), torch.from_numpy(dout))
    want = _jax_grads(lambda a, q: JFB.fused_transformer_layer(
        a, jnp.asarray(LENS), SEED, q, causal, HEADS, 0.0, 0.0, "gelu"), jx, _jax(p), dout)
    _check_grads(got, want)


def test_layer_last_grads_match_jax():
    """lens 0 selects no query: its K/V gradient is still there (uniform
    attention over every key), its query and residual gradient is not."""
    p, x, jx = _inputs(29)
    dout = np.random.default_rng(6).standard_normal((B, D)).astype(np.float32)
    lens = torch.from_numpy(LENS)
    got = _torch_grads(lambda a, q: FB.fused_transformer_layer_last(a, lens, q, HEADS),
                       x, _torch(p), torch.from_numpy(dout))
    want = _jax_grads(lambda a, q: JFB.fused_transformer_layer_last(
        a, jnp.asarray(LENS), SEED, q, HEADS, 0.0, 0.0, "gelu"), jx, _jax(p), dout)
    _check_grads(got, want)
    assert got["x"][0].abs().sum() > 0  # lens 0: K/V reach every position


@pytest.mark.parametrize("d", [16, 48])
def test_ln_prologue_grads_match_jax(d):
    rng = np.random.default_rng(31 + d)
    x = (2.0 * rng.standard_normal((4, 9, d)) + 0.5).astype(np.float32)
    pos = rng.standard_normal((9, d)).astype(np.float32)
    s = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    b = (0.1 * rng.standard_normal(d)).astype(np.float32)
    dout = rng.standard_normal((4, 9, d)).astype(np.float32)
    args = [torch.from_numpy(a).requires_grad_() for a in (x, pos, s, b)]
    (FL.fused_ln_dropout(*args) * torch.from_numpy(dout)).sum().backward()
    want = jax.grad(lambda *a: jnp.sum(j_ln_dropout(a[0], a[1], SEED, a[2], a[3], 0.0) * dout),
                    argnums=(0, 1, 2, 3))(*map(jnp.asarray, (x, pos, s, b)))
    _check_grads({n: a.grad for n, a in zip(("x", "pos", "s", "b"), args)},
                 dict(zip(("x", "pos", "s", "b"), want)))


def test_bf16_rounding_passes_gradients_unrounded():
    """In bf16 the plain versions round each matmul operand, and the
    gradient passes through the rounding unrounded: the kernels round the
    forward's operands as they read them and keep gradients fp32."""
    a = torch.tensor([1.0 + 2.0 ** -10, 3.0], requires_grad=True)
    r = FB._RoundBF16.apply(a)
    assert r.tolist() == [1.0, 3.0]
    (r * torch.tensor([0.1, 0.2])).sum().backward()
    assert a.grad.dtype == torch.float32
    torch.testing.assert_close(a.grad, torch.tensor([0.1, 0.2]), atol=0, rtol=0)


# ---------------------------------------------------------------------------
# the selected-positions layer (BERT4Rec's cloze positions): repeated
# positions (the padded cloze slots all select position 0) and a lens-0 row
# ---------------------------------------------------------------------------

S = 6
SEL = np.array([[0, 0, 0, 0, 0, 0],      # lens 0: every slot at position 0
                [0, 0, 3, 0, 0, 0],      # lens 1: a position beyond the length
                [1, 4, 4, 9, 11, 0],     # a repeat
                [2, 3, 5, 6, 0, 0],
                [0, 1, 2, 3, 3, 3]], np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_layer_sel_matches_jax(act, dtype):
    p, x, jx = _inputs(37, dtype)
    want = JFB.fused_transformer_layer_sel(jx, jnp.asarray(LENS), jnp.asarray(SEL), SEED, _jax(p),
                                           HEADS, 0.0, 0.0, act, dtype == "bfloat16")
    got = FB.fused_transformer_layer_sel(x, torch.from_numpy(LENS), torch.from_numpy(SEL),
                                         _torch(p), HEADS, act)
    assert got.dtype == x.dtype and got.shape == (B, S, D)
    _check(got, want, dtype)


def test_layer_sel_grads_match_jax():
    """dx adds the query and residual cotangents of repeated positions;
    K and V reach every position, also on the lens-0 row."""
    p, x, jx = _inputs(41)
    dout = np.random.default_rng(7).standard_normal((B, S, D)).astype(np.float32)
    lens, sel = torch.from_numpy(LENS), torch.from_numpy(SEL)
    got = _torch_grads(lambda a, q: FB.fused_transformer_layer_sel(a, lens, sel, q, HEADS),
                       x, _torch(p), torch.from_numpy(dout))
    want = _jax_grads(lambda a, q: JFB.fused_transformer_layer_sel(
        a, jnp.asarray(LENS), jnp.asarray(SEL), SEED, q, HEADS, 0.0, 0.0, "gelu"), jx, _jax(p),
        dout)
    _check_grads(got, want)
    assert got["x"][0].abs().sum() > 0


def test_layer_sel_is_the_full_layer_gathered():
    """At dropout 0.3 / 0.4 the selected-positions layer draws the masks
    the full bidirectional layer draws at the selected positions, so it is
    that layer followed by a gather (atol 1e-5: fp32 sums in another
    order); its gradient is the gathered full layer's."""
    p, x, _ = _inputs(43)
    lens, sel = torch.from_numpy(LENS), torch.from_numpy(SEL).long()
    drop = ("gelu", 0.3, 0.4, 321)
    dout = torch.from_numpy(np.random.default_rng(8).standard_normal((B, S, D)).astype(
        np.float32))
    got = _torch_grads(lambda a, q: FB.fused_transformer_layer_sel(a, lens, sel, q, HEADS,
                                                                   *drop), x, _torch(p), dout)
    want = _torch_grads(lambda a, q: torch.gather(
        FB.fused_transformer_layer(a, lens, q, False, HEADS, *drop), 1,
        sel[..., None].expand(-1, -1, D)), x, _torch(p), dout)
    for name in got:
        torch.testing.assert_close(got[name], want[name], atol=1e-5, rtol=1e-5, msg=name)
    out = FB.fused_transformer_layer_sel(x, lens, sel, _torch(p), HEADS, *drop)
    full = FB.fused_transformer_layer(x, lens, _torch(p), False, HEADS, *drop)
    torch.testing.assert_close(out, torch.gather(full, 1, sel[..., None].expand(-1, -1, D)),
                               atol=1e-5, rtol=1e-5)
    assert (out - FB.fused_transformer_layer_sel(x, lens, sel, _torch(p), HEADS)).abs().max() \
        > 0.1


def test_layer_sel_cpu_calls_do_not_count_and_refuse_other_devices():
    p, x, _ = _inputs(47)
    lens, sel = torch.from_numpy(LENS), torch.from_numpy(SEL)
    before = (FB.fused_transformer_layer_sel.launches, FB.fused_transformer_layer_sel_bwd.launches)
    xl = x.clone().requires_grad_()
    FB.fused_transformer_layer_sel(xl, lens, sel, _torch(p), HEADS).sum().backward()
    assert before == (FB.fused_transformer_layer_sel.launches,
                      FB.fused_transformer_layer_sel_bwd.launches) == (0, 0)
    with pytest.raises(ValueError, match="no kernel"):
        FB.fused_transformer_layer_sel(torch.zeros((B, T, D), device="meta"), lens, sel,
                                       _torch(p), HEADS)


def test_encoder_select_refuses_a_causal_stack():
    from datamining_recblr_torch.models import layers as ML

    p, x, _ = _inputs(53)
    with pytest.raises(ValueError, match="bidirectional"):
        ML.transformer_encoder_apply([_layer_tree(_torch(p))], x, None, n_heads=HEADS,
                                     lens=torch.from_numpy(LENS), causal=True,
                                     select=torch.from_numpy(SEL))
