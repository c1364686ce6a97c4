"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA card and skips without one; this
file imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: fp32 atol 1e-4 / rtol 1e-4 (fp32 FMA matmuls summed in
another order than cuBLAS); bf16 atol 1e-4 / rtol 2^-7, one bf16 ulp of
the output, since both sides compute in fp32 and round once.  Gradients
(the backward kernels against autograd of the plain versions): every
weight grad, and an fp32 dx, within 1e-4 * max|plain|; a bf16 dx within
one bf16 ulp of the value on top of that.  The transformer layers in
bf16 round every matmul operand, so an fp32 sum in another order can
send an operand to the other bf16 neighbour: their bf16 outputs and
gradients are held within one bf16 ulp of the value plus 2^-9 of the
largest value (``_assert_attn_close``)."""

import numpy as np
import pytest
import torch

from datamining_recblr_torch.config import Config
from datamining_recblr_torch.models import get_model
from datamining_recblr_torch.ops import fused_layer as FL
from datamining_recblr_torch.serve import Recommender

pytestmark = pytest.mark.cuda

K = 4
TOL = {
    "float32": dict(atol=1e-4, rtol=1e-4),
    "bfloat16": dict(atol=1e-4, rtol=2.0 ** -7),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _params(rng, d, c, dev, use_ffn=True, prologue=False):
    def r(*s):
        return torch.from_numpy((0.1 * rng.standard_normal(s)).astype(np.float32)).to(dev)

    p = {
        "w_in": r(d, 2 * c), "wc": r(K, c), "bc": r(c), "wg": r(c, 2 * c), "bg": r(2 * c),
        "lam": torch.linspace(-6.9, 12.0, c, device=dev),
        "w_out": r(c, d), "ln1_s": 1.0 + r(d), "ln1_b": r(d),
    }
    if use_ffn:
        p.update(w1=r(d, 4 * d), b1=r(4 * d), w2=r(4 * d, d), b2=r(d),
                 ln2_s=1.0 + r(d), ln2_b=r(d))
    if prologue:
        p.update(pl_s=1.0 + r(d), pl_b=r(d))
    return p


# (D, C, use_conv, use_ffn, prologue): the serving widths with every
# stage on, then narrower widths that are no multiple of 32 with stages off
FLAGS = [(64, 128, True, True, True), (64, 128, True, True, False),
         (48, 96, False, True, False), (48, 96, True, False, True)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,c,use_conv,use_ffn,prologue", FLAGS)
def test_layer_kernel_matches_plain(dev, dtype, d, c, use_conv, use_ffn, prologue):
    rng = np.random.default_rng(1)
    p = _params(rng, d, c, dev, use_ffn, prologue)
    x = torch.from_numpy(rng.standard_normal((5, 45, d)).astype(np.float32))
    x = x.to(dev, getattr(torch, dtype))
    before = FL.fused_recurrent_layer.launches
    got = FL.fused_recurrent_layer(x, p, use_conv, use_ffn, prologue)
    assert FL.fused_recurrent_layer.launches == before + 1
    want = FL.fused_recurrent_layer_plain(x, p, use_conv, use_ffn, prologue)
    assert got.dtype == x.dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,c,use_conv,use_ffn", [f[:4] for f in FLAGS[1:]])
def test_layer_last_kernel_matches_plain(dev, dtype, d, c, use_conv, use_ffn):
    rng = np.random.default_rng(2)
    p = _params(rng, d, c, dev, use_ffn)
    t = 45
    x = torch.from_numpy(rng.standard_normal((6, t, d)).astype(np.float32))
    x = x.to(dev, getattr(torch, dtype))
    lens = torch.tensor([0, 1, t, 17, 32, t + 3], device=dev)  # t + 3 selects nothing
    before = FL.fused_recurrent_layer_last.launches
    got = FL.fused_recurrent_layer_last(x, lens, p, use_conv, use_ffn)
    assert FL.fused_recurrent_layer_last.launches == before + 1
    want = FL.fused_recurrent_layer_last_plain(x, lens, p, use_conv, use_ffn)
    assert got.dtype == x.dtype and got.shape == (6, d)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_kernels_reject_what_they_do_not_take(dev):
    rng = np.random.default_rng(3)
    p = _params(rng, 64, 128, dev)
    x = torch.zeros((2, 16, 64), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        FL.fused_recurrent_layer(x.transpose(0, 1), p)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        FL.fused_recurrent_layer(x.half(), p)
    with pytest.raises(ValueError, match="param w_in"):
        FL.fused_recurrent_layer(x, dict(p, w_in=p["w_in"].cpu()))
    with pytest.raises(ValueError, match="unsupported shape"):
        FL.fused_recurrent_layer(x[:, :2].contiguous(), p)  # fewer steps than taps
    with pytest.raises(ValueError, match="lens"):
        FL.fused_recurrent_layer_last(x, torch.tensor([1, 2]), p)  # lens on the CPU


def test_serving_on_card_matches_cpu(dev):
    cfg = Config(model="RecBLR", config_dict={"hidden_size": 64, "num_layers": 2,
                                               "MAX_ITEM_LIST_LENGTH": 40})
    cpu = get_model("RecBLR")(cfg, 300, 40, device="cpu")
    card = get_model("RecBLR")(cfg, 300, 40, device=dev)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(4)
    seqs = [[], [7], list(rng.integers(1, 300, 55)), list(rng.integers(1, 300, 12))]
    before = (FL.fused_recurrent_layer.launches, FL.fused_recurrent_layer_last.launches)
    ids, vals = Recommender(card, top_k=10).recommend(seqs)
    after = (FL.fused_recurrent_layer.launches, FL.fused_recurrent_layer_last.launches)
    assert (after[0] - before[0], after[1] - before[1]) == (1, 1)
    want_ids, want_vals = Recommender(cpu, top_k=10).recommend(seqs)
    np.testing.assert_allclose(vals, want_vals, atol=1e-4, rtol=1e-4)
    # ids may differ only where the CPU's scores tie within tolerance
    for i, j in zip(*np.nonzero(ids != want_ids)):
        row = dict(zip(want_ids[i].tolist(), want_vals[i].tolist()))
        assert abs(row.get(int(ids[i, j]), want_vals[i, -1]) - want_vals[i, j]) <= 1e-4


# ---------------------------------------------------------------------------
# backward kernels
# ---------------------------------------------------------------------------

GRAD_RTOL = 1e-4


def _plain_vjp(fn, x, p, dout):
    xl = x.detach().clone().requires_grad_()
    pl = {k: v.detach().clone().requires_grad_() for k, v in p.items()}
    out = fn(xl, pl)
    names = list(pl)
    g = torch.autograd.grad(out, [xl] + [pl[n] for n in names], dout, allow_unused=True)
    grads = {n: (v if v is not None else torch.zeros_like(pl[n])) for n, v in zip(names, g[1:])}
    return out.detach(), g[0], grads


def _assert_grads(got, want, dtype):
    (out, dx, grads), (wout, wdx, wgrads) = got, want
    torch.testing.assert_close(out.float(), wout.float(), **TOL[dtype])
    scale = float(wdx.float().abs().max())
    rtol = 2.0 ** -7 if dtype == "bfloat16" else 0.0
    assert bool(((dx.float() - wdx.float()).abs()
                 <= rtol * wdx.float().abs() + GRAD_RTOL * scale).all()), "dx"
    assert set(grads) == set(wgrads)
    for k, g in grads.items():
        w = wgrads[k]
        assert float((g - w).abs().max()) <= GRAD_RTOL * float(w.abs().max()), k


@pytest.mark.parametrize("p_drop", [0.0, 0.2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,c,use_conv,use_ffn,prologue", FLAGS)
def test_layer_bwd_kernel_matches_plain(dev, dtype, p_drop, d, c, use_conv, use_ffn,
                                        prologue):
    rng = np.random.default_rng(5)
    p = _params(rng, d, c, dev, use_ffn, prologue)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal((5, 45, d)).astype(np.float32)).to(dev, dt)
    dout = torch.from_numpy(rng.standard_normal((5, 45, d)).astype(np.float32)).to(dev, dt)
    flags = (use_conv, use_ffn, prologue, p_drop, 99)
    before = FL.fused_recurrent_layer_bwd.launches
    out, saved = FL.fused_recurrent_layer_train(x, p, *flags)
    dx, grads = FL.fused_recurrent_layer_bwd(x, dout, p, *flags, saved=saved)
    assert FL.fused_recurrent_layer_bwd.launches == before + 1
    assert dx.dtype == dt and dx.shape == x.shape
    want = _plain_vjp(lambda a, q: FL.fused_recurrent_layer_plain(a, q, *flags), x, p, dout)
    _assert_grads((out, dx, grads), want, dtype)
    # without the stash the backward recomputes alpha and h: same result
    dx2, grads2 = FL.fused_recurrent_layer_bwd(x, dout, p, *flags)
    torch.testing.assert_close(dx2, dx, atol=0, rtol=0)
    for k in grads:
        torch.testing.assert_close(grads2[k], grads[k], atol=0, rtol=0)


@pytest.mark.parametrize("p_drop", [0.0, 0.2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,c,use_conv,use_ffn", [f[:4] for f in FLAGS[1:]])
def test_layer_last_bwd_kernel_matches_plain(dev, dtype, p_drop, d, c, use_conv, use_ffn):
    rng = np.random.default_rng(6)
    p = _params(rng, d, c, dev, use_ffn)
    t = 45
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal((6, t, d)).astype(np.float32)).to(dev, dt)
    dout = torch.from_numpy(rng.standard_normal((6, d)).astype(np.float32)).to(dev, dt)
    lens = torch.tensor([0, 1, t, 17, 32, t + 3], device=dev)  # 0, t + 3 select nothing
    flags = (use_conv, use_ffn, p_drop, 99)
    before = FL.fused_recurrent_layer_last_bwd.launches
    out, saved = FL.fused_recurrent_layer_last_train(x, lens, p, *flags)
    dx, grads = FL.fused_recurrent_layer_last_bwd(x, lens, dout, p, *flags, saved=saved)
    assert FL.fused_recurrent_layer_last_bwd.launches == before + 1
    want = _plain_vjp(lambda a, q: FL.fused_recurrent_layer_last_plain(a, lens, q, *flags),
                      x, p, dout)
    _assert_grads((out, dx, grads), want, dtype)
    # dx is 0 on rows that select nothing and at and beyond each length
    assert not dx[0].any() and not dx[5].any()
    assert not dx[1, 1:].any() and not dx[3, 17:].any()
    dx2, _ = FL.fused_recurrent_layer_last_bwd(x, lens, dout, p, *flags)
    torch.testing.assert_close(dx2, dx, atol=0, rtol=0)


def test_dropout_mask_bits_match_plain(dev):
    """W_in = 0, FFN off: K1's dx is LN_pl'(dv1) * m0, zero exactly where
    the prologue mask drops."""
    from datamining_recblr_torch.ops import philox

    rng = np.random.default_rng(7)
    p = _params(rng, 64, 128, dev, use_ffn=False, prologue=True)
    p["w_in"] = torch.zeros_like(p["w_in"])
    x = torch.from_numpy(rng.standard_normal((7, 50, 64)).astype(np.float32)).to(dev)
    dout = torch.from_numpy(rng.standard_normal((7, 50, 64)).astype(np.float32)).to(dev)
    dx, _ = FL.fused_recurrent_layer_bwd(x, dout, p, True, False, True, 0.2, 31337)
    want = philox.dropout_mask(31337, philox.M0, 7, 50, 64, 0.2, dev) > 0
    assert torch.equal(dx != 0, want)


def test_backward_wrappers_reject_what_they_do_not_take(dev):
    rng = np.random.default_rng(8)
    p = _params(rng, 64, 128, dev)
    x = torch.zeros((2, 16, 64), device=dev)
    dout = torch.zeros_like(x)
    with pytest.raises(ValueError, match="dout"):
        FL.fused_recurrent_layer_bwd(x, dout[:, :8], p)
    with pytest.raises(ValueError, match="dout"):
        FL.fused_recurrent_layer_bwd(x, dout.to(torch.bfloat16), p)
    with pytest.raises(ValueError, match="saved"):
        FL.fused_recurrent_layer_bwd(x, dout, p, saved=(torch.zeros((2, 16, 64), device=dev),) * 2)
    with pytest.raises(ValueError, match="dropout_p"):
        FL.fused_recurrent_layer_bwd(x, dout, p, dropout_p=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        FL.fused_recurrent_layer_bwd(x.transpose(0, 1), dout, p)
    with pytest.raises(ValueError, match="dout"):
        FL.fused_recurrent_layer_last_bwd(x, torch.tensor([1, 2], device=dev), dout, p)
    with pytest.raises(ValueError, match="lens"):
        FL.fused_recurrent_layer_last_bwd(x, torch.tensor([1, 2]), dout[:, 0], p)
    with pytest.raises(ValueError, match="no kernel"):
        FL.fused_recurrent_layer_bwd(x.cpu(), dout.cpu(), p)


def test_train_step_through_kernels_matches_plain(dev):
    """One CE step of RecBLR (dropout 0.2) through the four kernels: one
    launch of each, and the loss and every parameter gradient as the
    same step through the plain versions."""
    cfg = Config(model="RecBLR", config_dict={"hidden_size": 64, "num_layers": 2,
                                               "MAX_ITEM_LIST_LENGTH": 40})
    model = get_model("RecBLR")(cfg, 300, 40, device=dev)
    rng = np.random.default_rng(9)
    lens = torch.from_numpy(rng.integers(1, 41, 64).astype(np.int32)).to(dev)
    seq = torch.from_numpy(rng.integers(1, 300, (64, 40))).to(dev)
    seq = torch.where(torch.arange(40, device=dev)[None] < lens[:, None], seq, 0)
    batch = {"item_seq": seq, "item_seq_len": lens,
             "pos_item": torch.from_numpy(rng.integers(1, 300, 64)).to(dev)}
    model.train()
    counted = (FL.fused_recurrent_layer, FL.fused_recurrent_layer_last,
               FL.fused_recurrent_layer_bwd, FL.fused_recurrent_layer_last_bwd)
    before = [f.launches for f in counted]
    loss = model.calculate_loss(batch, step=11)
    loss.backward()
    assert [f.launches - b for f, b in zip(counted, before)] == [1, 1, 1, 1]
    got = {k: v.grad.clone() for k, v in model.named_parameters()}
    model.zero_grad()
    # the same model through the plain versions: same seeds, same masks
    p_drop, seeds = model.dropout_seeds(11)
    x = model.embed(seq)
    for li, layer in enumerate(model.layers):
        flat = model.flat_layer_params(layer, True)
        if li == 1:
            x = FL.fused_recurrent_layer_last_plain(x, lens, flat, True, True, p_drop, seeds[1])
        else:
            flat.update(model.prologue_params())
            x = FL.fused_recurrent_layer_plain(x, flat, True, True, True, p_drop, seeds[0])
    from datamining_recblr_torch.models.base import ce_loss

    want = ce_loss(model._mask_padded_vocab(model._logits(x), value=-1e30),
                   batch["pos_item"])
    want.backward()
    assert abs(float(loss.detach()) - float(want.detach())) <= 1e-4 * abs(float(want.detach()))
    for k, v in model.named_parameters():
        assert float((got[k] - v.grad).abs().max()) <= GRAD_RTOL * float(v.grad.abs().max()), k


# ---------------------------------------------------------------------------
# the attention baselines' kernels: LN prologue and transformer layers
# ---------------------------------------------------------------------------

def _assert_attn_close(got, want, dtype):
    """fp32 as TOL.  bf16: one bf16 ulp of the value plus 2^-9 of the
    largest value.  Both sides round every matmul operand to bf16, and an
    fp32 sum taken in another order can send an operand to the other bf16
    neighbour: one FFN activation near 1 moves by 2^-7, times a weight,
    which shifts an output by a share of the layer's scale, not of the
    output's own size (7.5e-4 of the largest value on an H100)."""
    if dtype == "float32":
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
        return
    atol = 2.0 ** -9 * float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=2.0 ** -7)


def _block_params(rng, d, inner, dev):
    def r(*s, std=0.1):
        return torch.from_numpy((std * rng.standard_normal(s)).astype(np.float32)).to(dev)

    p = {}
    for n in "qkvo":
        p[f"w_{n}"], p[f"b_{n}"] = r(d, d), r(d)
    p.update(ln1_s=1.0 + r(d), ln1_b=r(d), w1=r(d, inner), b1=r(inner), w2=r(inner, d),
             b2=r(d), ln2_s=1.0 + r(d), ln2_b=r(d))
    return p


# (D, heads, inner): the serving widths, then a narrow one with 3 heads of
# 16 and an FFN of more than one 256-column chunk, then heads of 15 (no
# multiple of 8: zero-padded to 16 in the forward's tensor-core tiles)
BLOCK_SHAPES = [(64, 2, 256), (48, 3, 320), (45, 3, 320)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["gelu", "relu"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d,heads,inner", BLOCK_SHAPES)
def test_block_kernel_matches_plain(dev, d, heads, inner, causal, act, dtype):
    from datamining_recblr_torch.ops import fused_block as FB

    rng = np.random.default_rng(10)
    p = _block_params(rng, d, inner, dev)
    t = 45
    x = torch.from_numpy(rng.standard_normal((6, t, d)).astype(np.float32))
    x = x.to(dev, getattr(torch, dtype))
    lens = torch.tensor([0, 1, t, 17, 32, 40], device=dev)
    before = FB.fused_transformer_layer.launches
    got = FB.fused_transformer_layer(x, lens, p, causal, heads, act)
    assert FB.fused_transformer_layer.launches == before + 1
    want = FB.fused_transformer_layer_plain(x, lens, p, causal, heads, act)
    assert got.dtype == x.dtype and got.shape == x.shape
    _assert_attn_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["gelu", "silu"])
@pytest.mark.parametrize("d,heads,inner", BLOCK_SHAPES)
def test_block_last_kernel_matches_plain(dev, d, heads, inner, act, dtype):
    from datamining_recblr_torch.ops import fused_block as FB

    rng = np.random.default_rng(11)
    p = _block_params(rng, d, inner, dev)
    t = 45
    x = torch.from_numpy(rng.standard_normal((6, t, d)).astype(np.float32))
    x = x.to(dev, getattr(torch, dtype))
    lens = torch.tensor([0, 1, t, 17, 32, t + 3], device=dev)  # 0, t + 3 select nothing
    before = FB.fused_transformer_layer_last.launches
    got = FB.fused_transformer_layer_last(x, lens, p, heads, act)
    assert FB.fused_transformer_layer_last.launches == before + 1
    want = FB.fused_transformer_layer_last_plain(x, lens, p, heads, act)
    assert got.dtype == x.dtype and got.shape == (6, d)
    _assert_attn_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_kernels_at_the_largest_supported_shape(dev, dtype):
    """D 128, 4 heads, FFN 2048 (eight 256-column chunks), T 1024: the
    layer's query tile shrinks to 16 rows to fit shared memory."""
    from datamining_recblr_torch.ops import fused_block as FB

    rng = np.random.default_rng(15)
    d, heads, inner, t = 128, 4, 2048, 1024
    p = _block_params(rng, d, inner, dev)
    x = torch.from_numpy(rng.standard_normal((2, t, d)).astype(np.float32))
    x = x.to(dev, getattr(torch, dtype))
    lens = torch.tensor([0, 1000], device=dev)
    for causal in (True, False):
        before = FB.fused_transformer_layer.launches
        got = FB.fused_transformer_layer(x, lens, p, causal, heads)
        assert FB.fused_transformer_layer.launches == before + 1
        _assert_attn_close(got, FB.fused_transformer_layer_plain(x, lens, p, causal, heads),
                           dtype)
    before = FB.fused_transformer_layer_last.launches
    got = FB.fused_transformer_layer_last(x, lens, p, heads)
    assert FB.fused_transformer_layer_last.launches == before + 1
    _assert_attn_close(got, FB.fused_transformer_layer_last_plain(x, lens, p, heads), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,heads,inner", [(64, 2, 256), (128, 1, 512)])
def test_block_forwards_at_t_1024(dev, d, heads, inner, dtype):
    """The three forwards at T 1,024 (the longest `supports` takes) with
    lengths 0, 1, 17 and T: the full layer's query tiles visit 1, 17 or up
    to T keys, and all T on the lens-0 row; at dropout 0.2 the masks of the
    visited keys match the plain version's.  One head of 128 takes the
    smallest key chunk (64 keys) and the tail's widest tiles.  One launch a
    call each."""
    from datamining_recblr_torch.ops import fused_block as FB

    rng = np.random.default_rng(24)
    t = 1024
    p = _block_params(rng, d, inner, dev)
    x = torch.from_numpy(rng.standard_normal((4, t, d)).astype(np.float32))
    x = x.to(dev, getattr(torch, dtype))
    lens = torch.tensor([0, 1, 17, t], device=dev)
    sel = _sel_idx(rng, 4, t, 24, dev)
    for drop in (("gelu",), ("gelu", 0.2, 0.2, 77)):
        for causal in (True, False):
            before = FB.fused_transformer_layer.launches
            got = FB.fused_transformer_layer(x, lens, p, causal, heads, *drop)
            assert FB.fused_transformer_layer.launches == before + 1
            _assert_attn_close(
                got, FB.fused_transformer_layer_plain(x, lens, p, causal, heads, *drop), dtype)
        before = FB.fused_transformer_layer_last.launches
        got = FB.fused_transformer_layer_last(x, lens, p, heads, *drop)
        assert FB.fused_transformer_layer_last.launches == before + 1
        _assert_attn_close(got, FB.fused_transformer_layer_last_plain(x, lens, p, heads, *drop),
                           dtype)
        before = FB.fused_transformer_layer_sel.launches
        got = FB.fused_transformer_layer_sel(x, lens, sel, p, heads, *drop)
        assert FB.fused_transformer_layer_sel.launches == before + 1
        _assert_attn_close(
            got, FB.fused_transformer_layer_sel_plain(x, lens, sel, p, heads, *drop), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 48, 512, 30, 33])
def test_ln_prologue_kernel_matches_plain(dev, d, dtype):
    rng = np.random.default_rng(12)
    t = 45
    x = torch.from_numpy((2 * rng.standard_normal((6, t, d)) + 1).astype(np.float32))
    x = x.to(dev, getattr(torch, dtype))
    pos, s, b = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
                 for shape in ((t, d), (d,), (d,)))
    before = FL.fused_ln_dropout.launches
    got = FL.fused_ln_dropout(x, pos, s, b)
    assert FL.fused_ln_dropout.launches == before + 1
    want = FL.fused_ln_dropout_plain(x, pos, s, b)
    assert got.dtype == x.dtype and got.shape == x.shape
    _assert_attn_close(got, want, dtype)


def test_attention_wrappers_reject_what_they_do_not_take(dev):
    from datamining_recblr_torch.ops import fused_block as FB

    rng = np.random.default_rng(13)
    p = _block_params(rng, 64, 256, dev)
    x = torch.zeros((2, 16, 64), device=dev)
    lens = torch.tensor([3, 16], device=dev)
    # dropout: the kernels apply the Philox masks the plain versions draw
    xr = torch.from_numpy(rng.standard_normal((2, 16, 64)).astype(np.float32)).to(dev)
    for got, want in (
        (FB.fused_transformer_layer(xr, lens, p, True, 2, "gelu", 0.2, 0.2, 5),
         FB.fused_transformer_layer_plain(xr, lens, p, True, 2, "gelu", 0.2, 0.2, 5)),
        (FB.fused_transformer_layer_last(xr, lens, p, 2, "gelu", 0.2, 0.2, 5),
         FB.fused_transformer_layer_last_plain(xr, lens, p, 2, "gelu", 0.2, 0.2, 5)),
        (FL.fused_ln_dropout(xr, xr[0], p["ln1_s"], p["ln1_b"], 0.2, 5),
         FL.fused_ln_dropout_plain(xr, xr[0], p["ln1_s"], p["ln1_b"], 0.2, 5)),
    ):
        torch.testing.assert_close(got, want, **TOL["float32"])
    with pytest.raises(ValueError, match="fused_attention there"):
        FB.fused_transformer_layer(x, lens, p, True, 3)  # D % heads != 0
    with pytest.raises(ValueError, match="fused_attention there"):
        FB.fused_transformer_layer_last(x, lens, p, 2, act="mish")
    with pytest.raises(ValueError, match="contiguous"):
        FB.fused_transformer_layer(x.transpose(0, 1), lens, p, True, 2)
    with pytest.raises(ValueError, match="param w_q"):
        FB.fused_transformer_layer(x, lens, dict(p, w_q=p["w_q"].cpu()), True, 2)
    with pytest.raises(ValueError, match="lens"):
        FB.fused_transformer_layer_last(x, lens.cpu(), p, 2)
    with pytest.raises(ValueError, match="pos"):
        FL.fused_ln_dropout(x, x[0, :8], p["ln1_s"], p["ln1_b"])


@pytest.mark.parametrize("name", ["SASRec", "BERT4Rec"])
def test_baseline_serving_on_card_matches_cpu(dev, name):
    from datamining_recblr_torch.ops import fused_block as FB

    cfg = Config(model=name, config_dict={"MAX_ITEM_LIST_LENGTH": 40})
    cpu = get_model(name)(cfg, 300, 40, device="cpu")
    card = get_model(name)(cfg, 300, 40, device=dev)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(14)
    seqs = [[], [7], list(rng.integers(1, 300, 55)), list(rng.integers(1, 300, 12))]
    counted = (FL.fused_ln_dropout, FB.fused_transformer_layer,
               FB.fused_transformer_layer_last)
    before = [f.launches for f in counted]
    ids, vals = Recommender(card, top_k=10).recommend(seqs)
    assert [f.launches - n for f, n in zip(counted, before)] == [1, 1, 1]
    want_ids, want_vals = Recommender(cpu, top_k=10).recommend(seqs)
    np.testing.assert_allclose(vals, want_vals, atol=1e-4, rtol=1e-4)
    for i, j in zip(*np.nonzero(ids != want_ids)):
        row = dict(zip(want_ids[i].tolist(), want_vals[i].tolist()))
        assert abs(row.get(int(ids[i, j]), want_vals[i, -1]) - want_vals[i, j]) <= 1e-4


# ---------------------------------------------------------------------------
# the attention baselines' backward kernels and SASRec training
# ---------------------------------------------------------------------------

def _assert_attn_grads(got, want, dtype):
    """Output, dx and every weight grad: fp32 within GRAD_RTOL of the
    largest plain value, as chip_smoke.py holds them (elementwise TOL is
    too tight for a row of lens 0: its scores sit at -10000, where an fp32
    ulp is 2^-10, so a last-bit difference in a dot product can move a
    score by 2^-10); bf16 as ``_assert_attn_close``.  Each absolute
    tolerance is at least 1e-6 of the largest gradient of the call: b_k's
    is zero up to rounding (the softmax ignores a shift that every key
    shares)."""
    (out, dx, grads), (wout, wdx, wgrads) = got, want
    assert set(grads) == set(wgrads)
    pairs = [("out", out, wout), ("dx", dx, wdx)] + [(k, v, wgrads[k])
                                                     for k, v in grads.items()]
    top = max(float(w.float().abs().max()) for _, _, w in pairs)
    for name, g, w in pairs:
        assert bool(torch.isfinite(g).all()), name
        g, w = g.float(), w.float()
        floor = 1e-6 * top
        if dtype == "float32":
            assert float((g - w).abs().max()) \
                <= max(GRAD_RTOL * float(w.abs().max()), floor), name
        else:
            atol = max(2.0 ** -9 * float(w.abs().max()), floor)
            assert bool(((g - w).abs() <= 2.0 ** -7 * w.abs() + atol).all()), name


@pytest.mark.parametrize("p_drop", [0.0, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d,heads,inner", BLOCK_SHAPES)
def test_block_bwd_kernel_matches_plain(dev, d, heads, inner, causal, dtype, p_drop):
    from datamining_recblr_torch.ops import fused_block as FB

    rng = np.random.default_rng(16)
    p = _block_params(rng, d, inner, dev)
    t = 45
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal((6, t, d)).astype(np.float32)).to(dev, dt)
    dout = torch.from_numpy(rng.standard_normal((6, t, d)).astype(np.float32)).to(dev, dt)
    lens = torch.tensor([0, 1, t, 17, 32, 40], device=dev)
    flags = (causal, heads, "gelu", p_drop, p_drop, 4321)
    before = FB.fused_transformer_layer_bwd.launches
    out, saved = FB.fused_transformer_layer_train(x, lens, p, *flags)
    dx, grads = FB.fused_transformer_layer_bwd(x, lens, dout, p, *flags, saved=saved)
    assert FB.fused_transformer_layer_bwd.launches == before + 1
    assert dx.dtype == dt and dx.shape == x.shape
    want = _plain_vjp(lambda a, q: FB.fused_transformer_layer_plain(a, lens, q, *flags),
                      x, p, dout)
    _assert_attn_grads((out, dx, grads), want, dtype)
    # deterministic: the same call gives the same bits
    dx2, grads2 = FB.fused_transformer_layer_bwd(x, lens, dout, p, *flags, saved=saved)
    assert torch.equal(dx2, dx) and all(torch.equal(grads2[k], grads[k]) for k in grads)


# (D, heads, inner, T, lens): shapes the backward's tiles (64-row items,
# 32-query and 64-key tiles) do not divide: T 200 with lengths that end
# inside a key tile, T 1,024 (the largest `supports` takes, keys in tiles
# and dk, dv in device memory) and D 128 (one head of 128, two of 64)
UNTILED_SHAPES = [
    (64, 2, 256, 200, [0, 1, 200, 71, 130, 193]),
    (64, 2, 256, 1024, [0, 1, 1024, 600]),
    (128, 1, 320, 90, [0, 1, 90, 37, 65]),
    (128, 2, 512, 200, [0, 1, 200, 129]),
]


@pytest.mark.parametrize("p_drop", [0.0, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d,heads,inner,t,lens", UNTILED_SHAPES)
def test_block_bwd_kernel_at_shapes_the_tiles_do_not_divide(dev, d, heads, inner, t, lens,
                                                          causal, dtype, p_drop):
    """As test_block_bwd_kernel_matches_plain, with x on a 1/8 grid and the
    Q/K projections on a 1/32 grid, so that every score is exact in fp32
    whatever the order of its sum: the lens-0 row scores at -10000, where
    an fp32 ulp is 2^-10, and a last-bit difference there moves its
    gradients beyond GRAD_RTOL at these widths, on any implementation."""
    from datamining_recblr_torch.ops import fused_block as FB

    rng = np.random.default_rng(19)
    p = _block_params(rng, d, inner, dev)
    for name in ("w_q", "b_q", "w_k", "b_k"):
        p[name] = torch.round(p[name] * 32.0) / 32.0
    dt = getattr(torch, dtype)
    b = len(lens)
    x = torch.from_numpy(np.round(rng.standard_normal((b, t, d)) * 8.0).astype(np.float32) / 8.0)
    x = x.to(dev, dt)
    dout = torch.from_numpy(rng.standard_normal((b, t, d)).astype(np.float32)).to(dev, dt)
    lens = torch.tensor(lens, device=dev)
    flags = (causal, heads, "gelu", p_drop, p_drop, 97)
    before = FB.fused_transformer_layer_bwd.launches
    out, saved = FB.fused_transformer_layer_train(x, lens, p, *flags)
    dx, grads = FB.fused_transformer_layer_bwd(x, lens, dout, p, *flags, saved=saved)
    assert FB.fused_transformer_layer_bwd.launches == before + 1
    assert dx.dtype == dt and dx.shape == x.shape
    want = _plain_vjp(lambda a, q: FB.fused_transformer_layer_plain(a, lens, q, *flags),
                      x, p, dout)
    _assert_attn_grads((out, dx, grads), want, dtype)
    dx2, grads2 = FB.fused_transformer_layer_bwd(x, lens, dout, p, *flags, saved=saved)
    assert torch.equal(dx2, dx) and all(torch.equal(grads2[k], grads[k]) for k in grads)


@pytest.mark.parametrize("p_drop", [0.0, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,heads,inner", BLOCK_SHAPES)
def test_block_last_bwd_kernel_matches_plain(dev, d, heads, inner, dtype, p_drop):
    from datamining_recblr_torch.ops import fused_block as FB

    rng = np.random.default_rng(17)
    p = _block_params(rng, d, inner, dev)
    t = 45
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal((6, t, d)).astype(np.float32)).to(dev, dt)
    dout = torch.from_numpy(rng.standard_normal((6, d)).astype(np.float32)).to(dev, dt)
    lens = torch.tensor([0, 1, t, 17, 32, t + 3], device=dev)  # 0, t + 3 select nothing
    flags = (heads, "gelu", p_drop, p_drop, 4321)
    before = FB.fused_transformer_layer_last_bwd.launches
    out, saved = FB.fused_transformer_layer_last_train(x, lens, p, *flags)
    dx, grads = FB.fused_transformer_layer_last_bwd(x, lens, dout, p, *flags, saved=saved)
    assert FB.fused_transformer_layer_last_bwd.launches == before + 1
    want = _plain_vjp(lambda a, q: FB.fused_transformer_layer_last_plain(a, lens, q, *flags),
                      x, p, dout)
    _assert_attn_grads((out, dx, grads), want, dtype)
    # rows that select nothing still attend to every key: dx is not 0 there
    assert dx[0].abs().sum() > 0 and dx[5].abs().sum() > 0
    # deterministic: the same call gives the same bits
    dx2, grads2 = FB.fused_transformer_layer_last_bwd(x, lens, dout, p, *flags, saved=saved)
    assert torch.equal(dx2, dx) and all(torch.equal(grads2[k], grads[k]) for k in grads)


@pytest.mark.parametrize("p_drop", [0.0, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 48, 512, 16, 128])
def test_ln_prologue_bwd_kernel_matches_plain(dev, d, dtype, p_drop):
    rng = np.random.default_rng(18)
    t = 45
    dt = getattr(torch, dtype)
    x = torch.from_numpy((2 * rng.standard_normal((300, t, d)) + 1).astype(np.float32))
    x = x.to(dev, dt)
    dout = torch.from_numpy(rng.standard_normal((300, t, d)).astype(np.float32)).to(dev, dt)
    p = {name: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
         for name, shape in (("pos", (t, d)), ("s", (d,)), ("b", (d,)))}
    before = FL.fused_ln_dropout_bwd.launches
    dx, dpos, ds, db = FL.fused_ln_dropout_bwd(x, p["pos"], dout, p["s"], p["b"], p_drop, 7)
    assert FL.fused_ln_dropout_bwd.launches == before + 1
    out = FL.fused_ln_dropout(x, p["pos"], p["s"], p["b"], p_drop, 7)
    want = _plain_vjp(lambda a, q: FL.fused_ln_dropout_plain(a, q["pos"], q["s"], q["b"],
                                                             p_drop, 7), x, p, dout)
    _assert_grads((out, dx, {"pos": dpos, "s": ds, "b": db}), want, dtype)
    again = FL.fused_ln_dropout_bwd(x, p["pos"], dout, p["s"], p["b"], p_drop, 7)
    assert all(torch.equal(a, b) for a, b in zip(again, (dx, dpos, ds, db)))


@pytest.mark.parametrize("pre", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 64, 128, 30])
def test_ln_bwd_kernels_at_a_batch_no_row_group_divides(dev, d, pre, dtype):
    """Rows 6 (pre False) and 5 (pre True) at B 301 (nine chunks of 34
    rows, the last of 29, walked two rows at a time) and T 23 (no whole
    tile of positions), D 30 without 16-byte rows among the widths; the
    same bits on a rerun."""
    rng = np.random.default_rng(19 + d)
    b, t = 301, 23
    dt = getattr(torch, dtype)
    x = torch.from_numpy((2 * rng.standard_normal((b, t, d)) + 1).astype(np.float32)).to(dev, dt)
    dout = torch.from_numpy(rng.standard_normal((b, t, d)).astype(np.float32)).to(dev, dt)
    p = {name: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
         for name, shape in (("pos", (t, d)), ("s", (d,)), ("b", (d,)))}
    if pre:
        del p["pos"]
        got = FL.fused_dropout_ln_bwd(x, dout, p["s"], p["b"], 0.3, 11)
        out = FL.fused_dropout_ln(x, p["s"], p["b"], 0.3, 11)
        want = _plain_vjp(lambda a, q: FL.fused_dropout_ln_plain(a, q["s"], q["b"], 0.3, 11),
                          x, p, dout)
        again = FL.fused_dropout_ln_bwd(x, dout, p["s"], p["b"], 0.3, 11)
        _assert_grads((out, got[0], {"s": got[1], "b": got[2]}), want, dtype)
    else:
        got = FL.fused_ln_dropout_bwd(x, p["pos"], dout, p["s"], p["b"], 0.3, 11)
        out = FL.fused_ln_dropout(x, p["pos"], p["s"], p["b"], 0.3, 11)
        want = _plain_vjp(lambda a, q: FL.fused_ln_dropout_plain(a, q["pos"], q["s"], q["b"],
                                                                 0.3, 11), x, p, dout)
        again = FL.fused_ln_dropout_bwd(x, p["pos"], dout, p["s"], p["b"], 0.3, 11)
        _assert_grads((out, got[0], {"pos": got[1], "s": got[2], "b": got[3]}), want, dtype)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


def test_attention_mask_bits_match_plain(dev):
    """Each new mask as a kernel draws it, bit for bit against the plain
    Philox mask: M0 from the prologue with scale 0 and bias 1 (its output
    is the mask); M1 and M3 from the sign of a layer output whose only
    signal is that mask; each head's probability mask from the context a
    training forward keeps, with v_h the identity on T = dh keys."""
    from datamining_recblr_torch.ops import fused_block as FB
    from datamining_recblr_torch.ops import philox

    b, t, d, heads, p_drop, seed = 5, 32, 64, 2, 0.5, 2024
    zeros = lambda *s: torch.zeros(s, device=dev)  # noqa: E731
    out = FL.fused_ln_dropout(torch.randn((b, t, d), device=dev), zeros(t, d), zeros(d),
                              torch.ones(d, device=dev), p_drop, seed)
    assert torch.equal(out != 0, philox.dropout_mask(seed, philox.M0, b, t, d, p_drop, dev) > 0)
    lens = torch.full((b,), t, device=dev)
    base = {n: zeros(d, d) for n in ("w_q", "w_k", "w_v", "w_o")}
    base.update({n: zeros(d) for n in ("b_q", "b_k", "b_v", "b_o", "ln1_b", "b2", "ln2_b")},
                ln1_s=torch.ones(d, device=dev), ln2_s=torch.ones(d, device=dev),
                w1=zeros(d, 256), b1=zeros(256), w2=zeros(256, d))
    lens_last = torch.tensor([t, 1, 7, 20, t], device=dev)
    qpos = FB.last_positions(lens_last, t)
    for mask_id, name in ((philox.M1, "b_o"), (philox.M3, "b2")):
        p = dict(base, **{name: torch.ones(d, device=dev)})
        out = FB.fused_transformer_layer(zeros(b, t, d), lens, p, True, heads, "gelu",
                                         p_drop, 0.0, seed)
        assert torch.equal(out > 0, philox.dropout_mask(seed, mask_id, b, t, d, p_drop, dev) > 0)
        out = FB.fused_transformer_layer_last(zeros(b, t, d), lens_last, p, heads, "gelu",
                                              p_drop, 0.0, seed)
        assert torch.equal(out > 0, philox.dropout_mask_at(seed, mask_id, qpos, d, p_drop) > 0)
    # probabilities: x[j] = e_j and W_v the identity on each head's columns
    dh = d // heads
    x = torch.eye(t, d, device=dev).expand(b, t, d).contiguous()
    w_v = torch.zeros((d, d), device=dev)
    for h in range(heads):
        w_v[:dh, h * dh:(h + 1) * dh] = torch.eye(dh, device=dev)
    p = dict(base, w_v=w_v, w_q=0.3 * torch.randn((d, d), device=dev),
             w_k=0.3 * torch.randn((d, d), device=dev))
    _, (_, ctx) = FB.fused_transformer_layer_train(x, lens, p, False, heads, "gelu", 0.0,
                                                   p_drop, seed)
    _, (_, ctx_last) = FB.fused_transformer_layer_last_train(x, lens_last, p, heads, "gelu",
                                                             0.0, p_drop, seed)
    for h in range(heads):
        want = philox.dropout_mask(seed, philox.prob_mask_id(h), b, t, t, p_drop, dev) > 0
        assert torch.equal(ctx[..., h * dh:(h + 1) * dh] != 0, want), h
        want = philox.dropout_mask_at(seed, philox.prob_mask_id(h), qpos, t, p_drop) > 0
        valid = torch.arange(t, device=dev)[None, :] < lens_last[:, None]
        assert torch.equal(ctx_last[:, h * dh:(h + 1) * dh] != 0, want & valid), h


def test_training_wrappers_return_a_gradient_path(dev):
    """With grad enabled, a kernel wrapper's output carries its backward
    (it used to come back without a grad_fn, dropping every gradient)."""
    from datamining_recblr_torch.ops import fused_block as FB

    rng = np.random.default_rng(19)
    p = {k: v.requires_grad_() for k, v in _block_params(rng, 64, 256, dev).items()}
    x = torch.from_numpy(rng.standard_normal((3, 20, 64)).astype(np.float32)).to(dev)
    x.requires_grad_()
    lens = torch.tensor([0, 5, 20], device=dev)
    pos = torch.zeros((20, 64), device=dev, requires_grad=True)
    for out in (FB.fused_transformer_layer(x, lens, p, True, 2),
                FB.fused_transformer_layer_last(x, lens, p, 2),
                FL.fused_ln_dropout(x, pos, p["ln1_s"], p["ln1_b"])):
        assert out.grad_fn is not None
        x.grad = None
        out.float().square().sum().backward()
        assert x.grad is not None and x.grad.abs().sum() > 0
    assert pos.grad is not None and p["w_q"].grad is not None


def test_sasrec_train_step_through_kernels_matches_plain(dev):
    """One CE step of SASRec (dropout 0.5 / 0.5) through the six kernels:
    one launch of each, and the loss and every parameter gradient as the
    same step through the plain versions (loss rtol 1e-4, gradients
    within GRAD_RTOL of each gradient's largest value, at least 1e-6 of
    the largest gradient of all: b_k's is zero up to rounding)."""
    from datamining_recblr_torch.models import layers as ML
    from datamining_recblr_torch.models.base import ce_loss
    from datamining_recblr_torch.ops import fused_block as FB

    cfg = Config(model="SASRec", config_dict={"MAX_ITEM_LIST_LENGTH": 40})
    model = get_model("SASRec")(cfg, 300, 40, device=dev)
    rng = np.random.default_rng(20)
    lens = torch.from_numpy(rng.integers(1, 41, 64).astype(np.int32)).to(dev)
    seq = torch.from_numpy(rng.integers(1, 300, (64, 40))).to(dev)
    seq = torch.where(torch.arange(40, device=dev)[None] < lens[:, None], seq, 0)
    batch = {"item_seq": seq, "item_seq_len": lens,
             "pos_item": torch.from_numpy(rng.integers(1, 300, 64)).to(dev)}
    model.train()
    counted = (FL.fused_ln_dropout, FB.fused_transformer_layer, FB.fused_transformer_layer_last,
               FL.fused_ln_dropout_bwd, FB.fused_transformer_layer_bwd,
               FB.fused_transformer_layer_last_bwd)
    before = [f.launches for f in counted]
    loss = model.calculate_loss(batch, step=11)
    loss.backward()
    assert [f.launches - n for f, n in zip(counted, before)] == [1] * 6
    got = {k: v.grad.clone() for k, v in model.named_parameters()}
    model.zero_grad()
    p_hidden, p_attn, seeds = model.dropout_seeds(11)
    assert (p_hidden, p_attn) == (0.5, 0.5)
    x = FL.fused_ln_dropout_plain(model.embed(seq), model.position_embedding[:40],
                                  model.input_ln["scale"], model.input_ln["bias"], p_hidden,
                                  seeds[-1])
    n = (seq != 0).sum(1)
    x = FB.fused_transformer_layer_plain(x, n, ML.flat_block_params(model.encoder[0]), True, 2,
                                         "gelu", p_hidden, p_attn, seeds[0])
    x = FB.fused_transformer_layer_last_plain(x, n, ML.flat_block_params(model.encoder[1]), 2,
                                              "gelu", p_hidden, p_attn, seeds[1])
    want = ce_loss(model._mask_padded_vocab(model._logits(x), value=-1e30), batch["pos_item"])
    want.backward()
    assert abs(float(loss.detach()) - float(want.detach())) <= 1e-4 * abs(float(want.detach()))
    top = max(float(v.grad.abs().max()) for v in model.parameters())
    for k, v in model.named_parameters():
        tol = max(GRAD_RTOL * float(v.grad.abs().max()), 1e-6 * top)
        assert float((got[k] - v.grad).abs().max()) <= tol, k


# ---------------------------------------------------------------------------
# BERT4Rec training: the selected-positions layer and the whole-table CE
# ---------------------------------------------------------------------------

def _sel_idx(rng, b, t, s, dev):
    """[B, S] positions with repeats: each row's last slots all 0 (the
    padded cloze slots), some positions twice, some beyond the length."""
    idx = np.sort(rng.integers(0, t, (b, s)), axis=1)
    idx[:, -3:] = 0
    idx[:, 1] = idx[:, 2]
    return torch.from_numpy(idx).to(dev)


@pytest.mark.parametrize("p_drop", [0.0, 0.2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,heads,inner", BLOCK_SHAPES)
def test_block_sel_kernels_match_plain(dev, d, heads, inner, dtype, p_drop):
    """Forward and backward of the selected-positions layer against the
    plain version by autograd, lengths 0, 1 and T, repeated positions; the
    backward gives the same bits on a rerun."""
    from datamining_recblr_torch.ops import fused_block as FB

    rng = np.random.default_rng(21)
    p = _block_params(rng, d, inner, dev)
    t, s = 45, 12
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal((6, t, d)).astype(np.float32)).to(dev, dt)
    dout = torch.from_numpy(rng.standard_normal((6, s, d)).astype(np.float32)).to(dev, dt)
    lens = torch.tensor([0, 1, t, 17, 32, 40], device=dev)
    sel = _sel_idx(rng, 6, t, s, dev)
    flags = (heads, "gelu", p_drop, p_drop, 987)
    before = (FB.fused_transformer_layer_sel.launches, FB.fused_transformer_layer_sel_bwd.launches)
    got = FB.fused_transformer_layer_sel(x, lens, sel, p, *flags)
    out, saved = FB.fused_transformer_layer_sel_train(x, lens, sel, p, *flags)
    dx, grads = FB.fused_transformer_layer_sel_bwd(x, lens, sel, dout, p, *flags, saved=saved)
    assert (FB.fused_transformer_layer_sel.launches - before[0],
            FB.fused_transformer_layer_sel_bwd.launches - before[1]) == (2, 1)
    assert got.dtype == dt and got.shape == (6, s, d) and dx.shape == x.shape
    assert torch.equal(got, out)
    want = _plain_vjp(lambda a, q: FB.fused_transformer_layer_sel_plain(a, lens, sel, q, *flags),
                      x, p, dout)
    _assert_attn_grads((out, dx, grads), want, dtype)
    dx2, grads2 = FB.fused_transformer_layer_sel_bwd(x, lens, sel, dout, p, *flags, saved=saved)
    assert torch.equal(dx2, dx) and all(torch.equal(grads2[k], grads[k]) for k in grads)


def test_block_sel_equals_the_full_layer_gathered(dev):
    """At dropout 0.2 the selected-positions layer is the full
    bidirectional layer at the selected positions, masks included."""
    from datamining_recblr_torch.ops import fused_block as FB

    rng = np.random.default_rng(22)
    p = _block_params(rng, 64, 256, dev)
    x = torch.from_numpy(rng.standard_normal((4, 40, 64)).astype(np.float32)).to(dev)
    lens = torch.tensor([3, 40, 1, 25], device=dev)
    sel = _sel_idx(rng, 4, 40, 8, dev)
    drop = ("gelu", 0.2, 0.2, 31)
    got = FB.fused_transformer_layer_sel(x, lens, sel, p, 2, *drop)
    full = FB.fused_transformer_layer(x, lens, p, False, 2, *drop)
    want = torch.gather(full, 1, sel[..., None].expand(-1, -1, 64))
    torch.testing.assert_close(got, want, **TOL["float32"])


# (N, V, valid_v, D): BERT4Rec's width with N no multiple of the 128-row
# block and masked columns, a narrow D no multiple of 16, a D no multiple of
# 8, D 200 and 256 (the backward's widest tensor-core tiles, 16 table rows),
# a catalog smaller than one tile, and D 300, whose backward stays on the
# fp32 FMA kernels (16 x 16 tiles)
CE_SHAPES = [(1000, 300, 290, 64), (517, 211, 211, 48), (300, 97, 90, 200), (70, 40, 40, 64),
             (300, 97, 90, 36), (257, 300, 290, 256), (129, 70, 66, 300)]


@pytest.mark.parametrize("mm_bf16", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,v,valid_v,d", CE_SHAPES)
def test_ce_kernels_match_plain(dev, n, v, valid_v, d, dtype, mm_bf16):
    """nll, dx, dtable and dbias against the plain version by autograd
    (nll atol 1e-4 + rtol 1e-5: an fp32 logsumexp in another order;
    gradients within GRAD_RTOL of the largest value, a bf16 dx one bf16
    ulp on top); the backward takes the tensor-core kernels exactly at
    D <= 256 and gives the same bits on a rerun."""
    from datamining_recblr_torch.ops import fused_ce as FCE

    rng = np.random.default_rng(23)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dev, dt)
    table = torch.from_numpy((0.3 * rng.standard_normal((v, d))).astype(np.float32)).to(dev)
    bias = torch.from_numpy(rng.standard_normal(v).astype(np.float32)).to(dev)
    tgt = torch.from_numpy(rng.integers(0, valid_v, n)).to(dev)
    dnll = torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32)).to(dev)
    args = (tgt, bias, valid_v, mm_bf16)
    bwd = FCE.fused_softmax_ce_bwd
    before = (FCE.fused_softmax_ce.launches, bwd.launches, bwd.mma_launches)
    nll, lse = FCE.fused_softmax_ce_train(x, table, *args)
    dx, dtab, dbias = bwd(x, table, tgt, dnll, bias, valid_v, mm_bf16, lse=lse)
    mma = d <= 256
    assert FCE.bwd_uses_mma(d, mm_bf16) == mma
    assert (FCE.fused_softmax_ce.launches - before[0], bwd.launches - before[1],
            bwd.mma_launches - before[2]) == (1, 1, int(mma))
    assert nll.shape == (n,) and dx.dtype == dt and dtab.shape == (v, d)
    xl, tl, bl = (a.detach().clone().requires_grad_() for a in (x, table, bias))
    want = FCE.fused_softmax_ce_plain(xl, tl, tgt, bl, valid_v, mm_bf16)
    want.backward(dnll)
    torch.testing.assert_close(nll, want.detach(), atol=1e-4, rtol=1e-5)
    scale = float(xl.grad.float().abs().max())
    rtol = 2.0 ** -7 if dtype == "bfloat16" else 0.0
    assert bool(((dx.float() - xl.grad.float()).abs()
                 <= rtol * xl.grad.float().abs() + GRAD_RTOL * scale).all()), "dx"
    for name, g, w in (("dtable", dtab, tl.grad), ("dbias", dbias, bl.grad)):
        assert float((g - w).abs().max()) <= GRAD_RTOL * float(w.abs().max()), name
    dx2, dtab2, dbias2 = FCE.fused_softmax_ce_bwd(x, table, tgt, dnll, bias, valid_v, mm_bf16,
                                                  lse=lse)
    assert torch.equal(dx2, dx) and torch.equal(dtab2, dtab) and torch.equal(dbias2, dbias)


# (N, V, valid_v, D) of the forwards: N no multiple of the 128-row block, V
# no multiple of the 64-, 32-, 16- or (wgmma, bf16) 128-row table tile,
# masked columns; row 13 at D 50, 64, 128, 136, 200 and 256 (its
# tensor-core widths), and at D 50, 100 and 256 with more 128-row units
# than the card has multiprocessors (the wgmma kernel's persistent blocks
# take several; at D 50 some two rounds of two units, some a round of two
# and one of one), row 14 at D 64, 100 and 128 with many vocab splits
CE_FWD_SHAPES = [(1000, 300, 290, 50), (1000, 300, 290, 64), (517, 211, 200, 128),
                 (300, 131, 129, 136), (300, 97, 90, 200), (257, 300, 290, 256),
                 (20_001, 389, 380, 256), (40_001, 389, 380, 50), (20_001, 389, 380, 100)]
CCE_FWD_SHAPES = [(300, 5000, 4990, 64), (257, 3001, 2990, 100), (129, 4000, 3999, 128)]


def _ce_fwd_case(rng, n, v, valid_v, d, dtype, table_dtype, dev):
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dev, dtype)
    table = torch.from_numpy((0.3 * rng.standard_normal((v, d))).astype(np.float32)).to(
        dev, table_dtype)
    bias = torch.from_numpy(rng.standard_normal(v).astype(np.float32)).to(dev, table_dtype)
    tgt = torch.from_numpy(rng.integers(0, valid_v, n)).to(dev)
    tgt[::5] = valid_v - 1  # targets in the last tile
    return x, table, bias, tgt


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mm_bf16", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunked,n,v,valid_v,d",
                         [(False, *s) for s in CE_FWD_SHAPES] + [(True, *s) for s in CCE_FWD_SHAPES])
def test_ce_forward_kernels_match_plain(dev, chunked, n, v, valid_v, d, dtype, mm_bf16,
                                        table_dtype):
    """Rows 13 and 14 forward: nll and lse against the plain version (atol
    1e-4 + rtol 1e-5: an fp32 logsumexp in another order), with a bias (in
    the table's dtype), masked columns and targets in the last tile; the
    tensor-core kernel runs exactly where the gate says (row 13:
    ``fwd_uses_mma``, at D <= 256, on wgmma with ``mm_bf16``; row 14:
    ``chunked_fwd_uses_mma``, at D <= 128, with more than one vocab
    split), and a rerun gives the same bits."""
    from datamining_recblr_torch.ops import fused_ce as FCE

    rng = np.random.default_rng(57 + d)
    x, table, bias, tgt = _ce_fwd_case(rng, n, v, valid_v, d, getattr(torch, dtype),
                                       getattr(torch, table_dtype), dev)
    if chunked:
        train, counted = FCE.fused_softmax_ce_chunked_train, FCE.fused_softmax_ce_chunked
        mma = FCE.chunked_fwd_uses_mma(d, mm_bf16)
        assert FCE._vocab_splits(n, v, d, x.device) > 1
        want = FCE.fused_softmax_ce_chunked_fwd_plain(x, table, tgt, bias, valid_v, mm_bf16)
    else:
        train, counted = FCE.fused_softmax_ce_train, FCE.fused_softmax_ce
        mma = FCE.fwd_uses_mma(d, mm_bf16)
        want = FCE._plain_fwd(x, table, bias.float(), tgt, valid_v, mm_bf16)
    assert mma == (d <= (128 if chunked else 256))
    before = (counted.launches, train.mma_launches)
    nll, lse = train(x, table, tgt, bias, valid_v, mm_bf16)
    assert (counted.launches - before[0], train.mma_launches - before[1]) == (1, int(mma))
    assert nll.shape == lse.shape == (n,) and nll.dtype == lse.dtype == torch.float32
    torch.testing.assert_close(nll, want[0], atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(lse, want[1], atol=1e-4, rtol=1e-5)
    nll2, lse2 = train(x, table, tgt, bias, valid_v, mm_bf16)
    assert torch.equal(nll2, nll) and torch.equal(lse2, lse)


@pytest.mark.parametrize("chunked,d,mm_bf16,mma",
                         [(False, 256, False, True), (False, 256, True, True),
                          (False, 128, True, True),
                          (False, 300, False, False), (False, 300, True, False),
                          (True, 128, False, True), (True, 128, True, True),
                          (True, 200, False, False), (True, 200, True, False)])
def test_ce_forwards_count_mma_launches_by_their_gates(dev, chunked, d, mm_bf16, mma):
    """Beyond its tensor-core width a forward runs the fp32 FMA kernel and
    counts no launch on the tensor cores: row 13 at D 300 (with
    ``mm_bf16`` at D 128 and 256 it runs on wgmma), row 14 at D 200; both
    agree with the plain version there too."""
    from datamining_recblr_torch.ops import fused_ce as FCE

    rng = np.random.default_rng(58)
    x, table, bias, tgt = _ce_fwd_case(rng, 200, 150, 141, d, torch.float32, torch.float32,
                                       dev)
    train = FCE.fused_softmax_ce_chunked_train if chunked else FCE.fused_softmax_ce_train
    gate = FCE.chunked_fwd_uses_mma if chunked else FCE.fwd_uses_mma
    assert gate(d, mm_bf16) == mma
    before = train.mma_launches
    nll, lse = train(x, table, tgt, bias, 141, mm_bf16)
    assert train.mma_launches - before == int(mma)
    plain = FCE.fused_softmax_ce_chunked_fwd_plain if chunked else FCE._plain_fwd
    want = (plain(x, table, tgt, bias, 141, mm_bf16) if chunked
            else plain(x, table, bias, tgt, 141, mm_bf16))
    torch.testing.assert_close(nll, want[0], atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(lse, want[1], atol=1e-4, rtol=1e-5)


def test_ce_wrapper_rejects_what_it_does_not_take(dev):
    from datamining_recblr_torch.ops import fused_ce as FCE

    x = torch.zeros((8, 64), device=dev)
    table = torch.zeros((20, 64), device=dev)
    tgt = torch.zeros(8, dtype=torch.long, device=dev)
    with pytest.raises(ValueError, match="D <= 512"):
        FCE.fused_softmax_ce(torch.zeros((8, 1024), device=dev),
                             torch.zeros((20, 1024), device=dev), tgt)
    with pytest.raises(ValueError, match="table"):
        FCE.fused_softmax_ce(x, table.long(), tgt)
    with pytest.raises(ValueError, match="targets"):
        FCE.fused_softmax_ce(x, table, tgt[:4])
    with pytest.raises(ValueError, match="valid_v"):
        FCE.fused_softmax_ce(x, table, tgt, valid_v=21)
    with pytest.raises(ValueError, match="lse"):
        FCE.fused_softmax_ce_bwd(x, table, tgt, torch.ones(8, device=dev), lse=None)


def test_bert4rec_wrappers_return_a_gradient_path(dev):
    """With grad enabled, the selected-positions layer and the CE return a
    tensor whose backward runs their backward kernels."""
    from datamining_recblr_torch.ops import fused_block as FB
    from datamining_recblr_torch.ops import fused_ce as FCE

    rng = np.random.default_rng(24)
    p = {k: v.requires_grad_() for k, v in _block_params(rng, 64, 256, dev).items()}
    x = torch.from_numpy(rng.standard_normal((3, 20, 64)).astype(np.float32)).to(dev)
    x.requires_grad_()
    out = FB.fused_transformer_layer_sel(x, torch.tensor([0, 5, 20], device=dev),
                                         _sel_idx(rng, 3, 20, 6, dev), p, 2)
    assert out.grad_fn is not None
    table = torch.randn((30, 64), device=dev, requires_grad=True)
    nll = FCE.fused_softmax_ce(out.reshape(-1, 64), table,
                               torch.arange(18, device=dev) % 30)
    assert nll.grad_fn is not None
    before = (FB.fused_transformer_layer_sel_bwd.launches, FCE.fused_softmax_ce_bwd.launches)
    nll.sum().backward()
    assert (FB.fused_transformer_layer_sel_bwd.launches - before[0],
            FCE.fused_softmax_ce_bwd.launches - before[1]) == (1, 1)
    assert x.grad.abs().sum() > 0 and table.grad.abs().sum() > 0 and p["w_q"].grad is not None


def _plain_cloze_loss(model, batch, step):
    """BERT4Rec's cloze loss of ``step``'s draw through the plain versions
    of its kernels (the same seeds, so the same masks)."""
    from datamining_recblr_torch.models import layers as ML
    from datamining_recblr_torch.ops import fused_block as FB
    from datamining_recblr_torch.ops import fused_ce as FCE

    seq, order, tgt, valid = model.cloze_draw(batch["item_seq"], batch["item_seq_len"], step)
    p_hidden, p_attn, seeds = model.dropout_seeds(step)
    t = seq.shape[1]
    x = FL.fused_ln_dropout_plain(model.embed(seq).to(model.compute_dtype),
                                  model.position_embedding[:t].float(),
                                  model.input_ln["scale"], model.input_ln["bias"], p_hidden,
                                  seeds[-1])
    lens = (seq != 0).sum(1)
    drop = (model.hidden_act, p_hidden, p_attn)
    for li, layer in enumerate(model.encoder):
        flat = ML.flat_block_params(layer)
        if li == len(model.encoder) - 1:
            x = FB.fused_transformer_layer_sel_plain(x, lens, order, flat, model.n_heads, *drop,
                                                     seeds[li])
        else:
            x = FB.fused_transformer_layer_plain(x, lens, flat, False, model.n_heads, *drop,
                                                 seeds[li])
    out = model.output_head(x)
    nll = FCE.fused_softmax_ce_plain(out.reshape(-1, out.shape[-1]),
                                     model.item_embedding[: model.n_items],
                                     tgt.reshape(-1), model.output_bias[: model.n_items],
                                     mm_bf16=model.compute_dtype == torch.bfloat16)
    w = valid.float() * batch["weight"].float()[:, None]
    return (nll.reshape(valid.shape) * w).sum() / w.sum().clamp_min(1.0)


def test_bert4rec_train_step_through_kernels_matches_plain(dev):
    """One cloze step of BERT4Rec (dropout 0.2 / 0.2, 256 rows of T 200:
    10,240 CE rows, so the CE kernel runs) through its eight kernel entry
    points, one call each, against the same step through the plain
    versions (loss rtol 1e-4, gradients within GRAD_RTOL of each
    gradient's largest value, at least 1e-6 of the largest of all)."""
    from datamining_recblr_torch.ops import fused_block as FB
    from datamining_recblr_torch.ops import fused_ce as FCE

    t = 200
    model = get_model("BERT4Rec")(Config(model="BERT4Rec", config_dict={
        "MAX_ITEM_LIST_LENGTH": t}), 300, t, device=dev)
    rng = np.random.default_rng(25)
    lens = torch.from_numpy(rng.integers(1, t + 1, 256).astype(np.int32)).to(dev)
    seq = torch.from_numpy(rng.integers(1, 300, (256, t))).to(dev)
    seq = torch.where(torch.arange(t, device=dev)[None] < lens[:, None], seq, 0)
    weight = torch.ones(256, device=dev)
    weight[-5:] = 0.0
    batch = {"item_seq": seq, "item_seq_len": lens, "weight": weight}
    model.train()
    counted = (FL.fused_ln_dropout, FB.fused_transformer_layer, FB.fused_transformer_layer_sel,
               FCE.fused_softmax_ce, FL.fused_ln_dropout_bwd, FB.fused_transformer_layer_bwd,
               FB.fused_transformer_layer_sel_bwd, FCE.fused_softmax_ce_bwd)
    before = [f.launches for f in counted]
    loss = model.calculate_loss(batch, step=13)
    loss.backward()
    assert [f.launches - n for f, n in zip(counted, before)] == [1] * 8
    got = {k: v.grad.clone() for k, v in model.named_parameters()}
    model.zero_grad()
    want = _plain_cloze_loss(model, batch, 13)
    want.backward()
    assert abs(float(loss.detach()) - float(want.detach())) <= 1e-4 * abs(float(want.detach()))
    top = max(float(v.grad.abs().max()) for v in model.parameters())
    for k, v in model.named_parameters():
        tol = max(GRAD_RTOL * float(v.grad.abs().max()), 1e-6 * top)
        assert float((got[k] - v.grad).abs().max()) <= tol, k


def test_base_ce_takes_the_kernel_from_min_rows(dev):
    """RecBLR's CE at 8,192 rows goes through the CE kernel with the
    padded vocab columns masked (valid_v = n_items), as the plain CE."""
    from datamining_recblr_torch.models.base import ce_loss
    from datamining_recblr_torch.ops import fused_ce as FCE

    cfg = Config(model="RecBLR", config_dict={"hidden_size": 64, "num_layers": 1,
                                               "MAX_ITEM_LIST_LENGTH": 8, "dropout_prob": 0.0,
                                               "vocab_multiple": 64})
    model = get_model("RecBLR")(cfg, 300, 8, device=dev)
    assert model.n_items_padded == 320
    rng = np.random.default_rng(26)
    n = FCE.MIN_ROWS
    lens = torch.from_numpy(rng.integers(1, 9, n).astype(np.int32)).to(dev)
    seq = torch.from_numpy(rng.integers(1, 300, (n, 8))).to(dev)
    seq = torch.where(torch.arange(8, device=dev)[None] < lens[:, None], seq, 0)
    batch = {"item_seq": seq, "item_seq_len": lens,
             "pos_item": torch.from_numpy(rng.integers(1, 300, n)).to(dev)}
    before = FCE.fused_softmax_ce.launches
    loss = model.calculate_loss(batch)
    assert FCE.fused_softmax_ce.launches == before + 1
    with torch.no_grad():
        out = model(seq, lens)
        want = ce_loss(model._mask_padded_vocab(model._logits(out), value=-1e30),
                       batch["pos_item"])
    assert abs(float(loss.detach()) - float(want)) <= 1e-5 * abs(float(want))


# ---------------------------------------------------------------------------
# the long-context path: the chunked layer, the vocab-chunked CE and the
# table gradient
# ---------------------------------------------------------------------------

def _assert_close_dtype(got, want, dtype):
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("p_drop", [0.0, 0.2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_layer_kernels_match_plain_and_k1(dev, dtype, p_drop):
    """Row 9 at T 1,024 (chunks of 128): the forward's output and record
    against the plain version, its backward (from the kernel's record)
    against autograd of the plain version, and both against K1 and K1's
    backward on its recompute branch (the same function and masks)."""
    from datamining_recblr_torch.ops import fused_layer_chunked as FLC

    rng = np.random.default_rng(51)
    dt = getattr(torch, dtype)
    t = 1024
    p = _params(rng, 64, 128, dev, prologue=True)
    x = torch.from_numpy(rng.standard_normal((4, t, 64)).astype(np.float32)).to(dev, dt)
    dout = torch.from_numpy(rng.standard_normal((4, t, 64)).astype(np.float32)).to(dev, dt)
    args = (True, True, True, p_drop, 77)
    before = (FLC.fused_recurrent_layer_chunked.launches,
              FLC.fused_recurrent_layer_chunked_bwd.launches)
    out, record = FLC.fused_recurrent_layer_chunked_train(x, p, *args)
    dx, grads = FLC.fused_recurrent_layer_chunked_bwd(x, dout, record, p, *args)
    assert (FLC.fused_recurrent_layer_chunked.launches - before[0],
            FLC.fused_recurrent_layer_chunked_bwd.launches - before[1]) == (1, 1)
    want, wrec = FLC.fused_recurrent_layer_chunked_plain(x, p, *args)
    _assert_close_dtype(out, want, dtype)
    torch.testing.assert_close(record, wrec, atol=1e-4, rtol=1e-4)
    wout, wdx, wgrads = _plain_vjp(
        lambda a, q: FLC.fused_recurrent_layer_chunked_plain(a, q, *args)[0], x, p, dout)
    _assert_grads((out, dx, grads), (wout, wdx, wgrads), dtype)
    k1, saved = FL.fused_recurrent_layer_train(x, p, *args)
    assert saved is None  # beyond the stash policy: K1's backward recomputes
    kdx, kgrads = FL.fused_recurrent_layer_bwd(x, dout, p, *args, saved=None)
    _assert_grads((out, dx, grads), (k1, kdx, kgrads), dtype)
    dx2, grads2 = FLC.fused_recurrent_layer_chunked_bwd(x, dout, record, p, *args)
    assert torch.equal(dx2, dx) and all(torch.equal(grads2[k], v) for k, v in grads.items())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k2_recompute_branch_at_1024(dev, dtype):
    """The top layer's kernels at T 1,024, beyond the stash policy: the
    backward recomputes alpha and h, against autograd of the plain
    version."""
    rng = np.random.default_rng(52)
    dt = getattr(torch, dtype)
    t = 1024
    p = _params(rng, 64, 128, dev)
    x = torch.from_numpy(rng.standard_normal((4, t, 64)).astype(np.float32)).to(dev, dt)
    lens = torch.tensor([1, t, 600, 0], device=dev)
    dout = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32)).to(dev, dt)
    out, saved = FL.fused_recurrent_layer_last_train(x, lens, p, True, True, 0.2, 5)
    assert saved is None
    dx, grads = FL.fused_recurrent_layer_last_bwd(x, lens, dout, p, True, True, 0.2, 5)
    wout, wdx, wgrads = _plain_vjp(lambda a, q: FL.fused_recurrent_layer_last_plain(
        a, lens, q, True, True, 0.2, 5), x, p, dout)
    _assert_grads((out, dx, grads), (wout, wdx, wgrads), dtype)


# (N, V, valid_v, D, edge): the XLong loss (512 rows, 329,728 padded
# rows), more row blocks than the vocab splits need at a small V, D > 128
# (the fp32 FMA backward also with mm_bf16), and shapes the tensor-core
# tiles do not divide: D 16 and 72 (not a multiple of 16), N 257 (128-row
# blocks and 64-row chunks), V 1,000 with 997 valid (64-row tiles).  With
# ``edge`` every target lies in one 64-row vocab tile and every seventh row
# has dnll 0.
CCE_SHAPES = [(512, 329_728, 329_722, 64, False), (1000, 300, 290, 64, False),
              (300, 97, 90, 200, False), (257, 1000, 997, 16, True), (257, 1000, 997, 72, True)]


@pytest.mark.parametrize("mm_bf16", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,v,valid_v,d,edge", CCE_SHAPES)
def test_chunked_ce_kernels_match_plain(dev, n, v, valid_v, d, edge, dtype, mm_bf16):
    """Row 14: nll, dx, dtable and dbias against the chunked plain version
    by autograd (nll atol 1e-4 + rtol 1e-5; gradients within GRAD_RTOL of
    the largest value, a bf16 dx one bf16 ulp on top); the backward takes
    the tensor-core kernels exactly with mm_bf16 at D <= 128 and gives the
    same bits on a rerun."""
    from datamining_recblr_torch.ops import fused_ce as FCE

    rng = np.random.default_rng(53)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dev, dt)
    table = torch.from_numpy((0.3 * rng.standard_normal((v, d))).astype(np.float32)).to(dev)
    bias = torch.from_numpy(rng.standard_normal(v).astype(np.float32)).to(dev)
    tgt = torch.from_numpy(rng.integers(128, 192, n) if edge
                           else rng.integers(0, valid_v, n)).to(dev)
    tgt[:3] = tgt[3]  # a repeated target
    dnll = torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32)).to(dev)
    if edge:
        dnll[::7] = 0.0
    bwd = FCE.fused_softmax_ce_chunked_bwd
    before = (FCE.fused_softmax_ce_chunked.launches, bwd.launches, bwd.mma_launches)
    nll, lse = FCE.fused_softmax_ce_chunked_train(x, table, tgt, bias, valid_v, mm_bf16)
    dx, dtab, dbias = bwd(x, table, tgt, dnll, bias, valid_v, mm_bf16, lse=lse)
    mma = mm_bf16 and d <= 128
    assert FCE.chunked_bwd_uses_mma(d, mm_bf16) == mma
    assert (FCE.fused_softmax_ce_chunked.launches - before[0], bwd.launches - before[1],
            bwd.mma_launches - before[2]) == (1, 1, int(mma))
    xl, tl, bl = (a.detach().clone().requires_grad_() for a in (x, table, bias))
    want = FCE.fused_softmax_ce_chunked_plain(xl, tl, tgt, bl, valid_v, mm_bf16)
    want.backward(dnll)
    torch.testing.assert_close(nll, want.detach(), atol=1e-4, rtol=1e-5)
    scale = float(xl.grad.float().abs().max())
    rtol = 2.0 ** -7 if dtype == "bfloat16" else 0.0
    assert bool(((dx.float() - xl.grad.float()).abs()
                 <= rtol * xl.grad.float().abs() + GRAD_RTOL * scale).all()), "dx"
    for name, g, w in (("dtable", dtab, tl.grad), ("dbias", dbias, bl.grad)):
        assert float((g - w).abs().max()) <= GRAD_RTOL * float(w.abs().max()), name
    dx2, dtab2, dbias2 = FCE.fused_softmax_ce_chunked_bwd(x, table, tgt, dnll, bias, valid_v,
                                                          mm_bf16, lse=lse)
    assert torch.equal(dx2, dx) and torch.equal(dtab2, dtab) and torch.equal(dbias2, dbias)


@pytest.mark.parametrize("chunked", [False, True], ids=["whole_table", "chunked"])
def test_ce_takes_a_bf16_table_and_bias(dev, chunked):
    """Both CE kernels take a bf16 table and bias, upcast inside, and
    return their gradients in bf16: as the plain version's."""
    from datamining_recblr_torch.ops import fused_ce as FCE

    rng = np.random.default_rng(54)
    x = torch.from_numpy(rng.standard_normal((600, 64)).astype(np.float32)).to(dev)
    table = torch.from_numpy(rng.standard_normal((300, 64)).astype(np.float32)).to(
        dev, torch.bfloat16)
    bias = torch.from_numpy(rng.standard_normal(300).astype(np.float32)).to(dev, torch.bfloat16)
    tgt = torch.from_numpy(rng.integers(0, 300, 600)).to(dev)
    grads = []
    pair = ((FCE.fused_softmax_ce_chunked, FCE.fused_softmax_ce_chunked_plain) if chunked
            else (FCE.fused_softmax_ce, FCE.fused_softmax_ce_plain))
    for fn in pair:
        tl, bl = table.clone().requires_grad_(), bias.clone().requires_grad_()
        nll = fn(x, tl, tgt, bl)
        nll.sum().backward()
        assert tl.grad.dtype == bl.grad.dtype == torch.bfloat16
        grads.append((nll.detach(), tl.grad.float(), bl.grad.float()))
    (nll, dt, db), (wnll, wdt, wdb) = grads
    torch.testing.assert_close(nll, wnll, atol=1e-4, rtol=1e-5)
    for g, w in ((dt, wdt), (db, wdb)):
        assert bool(((g - w).abs() <= 2.0 ** -7 * w.abs() + GRAD_RTOL * w.abs().max()).all())


def _assert_embedding_grad(ids, g, v):
    """Row 16 on ``ids`` and ``g``: one launch; within 1e-6 of its largest
    value of the exact sum (fp64 ``index_add_`` over the ids in [0, V)),
    and within 1e-4 of the plain version's (``index_add_`` into fp32 zeros,
    whose atomic sums round in any order); the same bits on a rerun."""
    from datamining_recblr_torch.ops import embedding as E

    before = E.embedding_grad.launches
    got = E.embedding_grad(ids, g, v)
    assert E.embedding_grad.launches == before + 1
    flat = ids.reshape(-1)
    ok = (flat >= 0) & (flat < v)
    g2 = g.reshape(flat.numel(), -1)
    want = E.embedding_grad_plain(flat[ok], g2[ok], v)
    exact = torch.zeros(want.shape, device=g.device, dtype=torch.float64).index_add_(
        0, flat[ok], g2[ok].double())
    scale = float(exact.abs().max())
    assert float((got.double() - exact).abs().max()) <= 1e-6 * scale
    assert float((got - want).abs().max()) <= 1e-4 * scale
    assert torch.equal(E.embedding_grad(ids, g, v), got)
    return got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("v,n,d", [(329_728, 524_288, 64), (300, 5000, 48), (20, 100_000, 8),
                                   (300, 5000, 520), (1023, 60_000, 64), (1024, 60_000, 64),
                                   (2**20 - 1, 300_000, 16), (2**20, 300_000, 16)])
def test_embedding_grad_kernel_matches_plain(dev, v, n, d, dtype):
    """Row 16 (``_assert_embedding_grad``) with id 0 at about half of the
    ids: at XLong (PAD's segment over ~8,200 pieces, ~130 groups); D 520
    walks the columns in slices of 512 and 8, one launch all the same; V
    at and just past the edges of the radix passes (one pass of 10 bits up
    to 1,023, two of 6 from 1,024, two of 10 up to 2^20 - 1, three of 7
    from 2^20), with int64 ids."""
    rng = np.random.default_rng(55)
    ids = rng.integers(0, v, n)
    ids[rng.random(n) < 0.5] = 0
    ids = torch.from_numpy(ids).to(dev)
    g = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dev,
                                                                           getattr(torch, dtype))
    _assert_embedding_grad(ids, g, v)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["one_id", "one_id_last", "outside", "int32_bench"])
def test_embedding_grad_kernel_matches_plain_on_skewed_ids(dev, case, dtype):
    """Row 16 (``_assert_embedding_grad``) where every id is equal (one
    segment over all 8,200 pieces, at id 0 and at V - 1), where a fifth of
    the ids lie outside [0, V) (left out) and PAD at a third, and on the
    bench step's int32 ids of shape [2,048, 200] with its lengths (PAD after
    each, about half)."""
    rng = np.random.default_rng(56)
    d = 64
    if case == "one_id" or case == "one_id_last":
        v, n = 3417, 262_144
        ids = np.full(n, 0 if case == "one_id" else v - 1)
    elif case == "outside":
        v, n = 5000, 200_000
        ids = rng.integers(-10, v + 10, n)
        ids[rng.random(n) < 0.2] = v + rng.integers(0, 3)
        ids[rng.random(n) < 0.33] = 0
    else:
        v, t = 3417, 200
        lens = rng.integers(2, t + 1, (2048, 1))
        ids = np.where(np.arange(t)[None] < lens, rng.integers(1, v, (2048, t)), 0)
        ids = ids.astype(np.int32)
    ids = torch.from_numpy(ids).to(dev)
    g = torch.from_numpy(rng.standard_normal(tuple(ids.shape) + (d,)).astype(np.float32)).to(
        dev, getattr(torch, dtype))
    _assert_embedding_grad(ids, g, v)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["edges", "pad_half", "d520"])
def test_embedding_grad_kernel_sums_in_the_schedule_order(dev, case, dtype):
    """Row 16's bits equal those of its order of sums emulated in numpy
    (``tests/emb_grad_schedule.py``: compensated fp32 sums of the sorted
    pieces, the group sums and the row sums): segments on and just off
    piece and group edges; PAD at half of 60,000 ids; D 520 (two column
    slices)."""
    from emb_grad_schedule import edge_ids, schedule_sum

    from datamining_recblr_torch.ops import embedding as E

    rng = np.random.default_rng(57)
    v, d = (300, 8) if case == "edges" else (9216, 8) if case == "pad_half" else (300, 520)
    if case == "edges":
        ids = edge_ids(rng, v)
    else:
        n = 60_000 if case == "pad_half" else 8000
        ids = rng.integers(1, v, n)
        ids[rng.random(n) < 0.5] = 0
    g = torch.from_numpy(rng.standard_normal((ids.size, d)).astype(np.float32)).to(
        getattr(torch, dtype))
    want = schedule_sum(ids, g.float().numpy(), v)
    got = E.embedding_grad(torch.from_numpy(ids).to(dev), g.to(dev), v)
    assert torch.equal(got.cpu(), torch.from_numpy(want))


def test_bf16_train_step_launches_the_table_gradient_kernel(dev):
    """A bf16 RecBLR step's table gradient goes through row 16 once."""
    from datamining_recblr_torch.ops import embedding as E

    cfg = Config(model="RecBLR", config_dict={"hidden_size": 64, "num_layers": 2,
                                               "MAX_ITEM_LIST_LENGTH": 40,
                                               "compute_dtype": "bfloat16"})
    model = get_model("RecBLR")(cfg, 300, 40, device=dev)
    rng = np.random.default_rng(56)
    seq = torch.from_numpy(rng.integers(0, 300, (64, 40))).to(dev)
    batch = {"item_seq": seq, "item_seq_len": torch.full((64,), 40, device=dev),
             "pos_item": torch.from_numpy(rng.integers(1, 300, 64)).to(dev)}
    model.train()
    before = E.embedding_grad.launches
    model.calculate_loss(batch, step=1).backward()
    assert E.embedding_grad.launches == before + 1
    assert model.item_embedding.grad.dtype == torch.float32


def test_bf16_train_step_at_hidden_520_sums_the_table_gradient_on_the_card(dev, monkeypatch):
    """A bf16 RecBLR step at hidden 520 (above the 512 columns row 16 sums
    at a time): one launch of ``embedding_grad``, the loss and every
    gradient as the same step with the plain gather (whose table gradient
    is autograd's fp32 sum): within GRAD_RTOL of each one's largest
    value."""
    import torch.nn.functional as F

    from datamining_recblr_torch.ops import embedding as E

    cfg = Config(model="RecBLR", config_dict={"hidden_size": 520, "num_layers": 2,
                                               "MAX_ITEM_LIST_LENGTH": 20,
                                               "compute_dtype": "bfloat16"})
    model = get_model("RecBLR")(cfg, 300, 20, device=dev)
    rng = np.random.default_rng(57)
    seq = torch.from_numpy(rng.integers(0, 300, (32, 20))).to(dev)
    batch = {"item_seq": seq, "item_seq_len": torch.full((32,), 20, device=dev),
             "pos_item": torch.from_numpy(rng.integers(1, 300, 32)).to(dev)}
    model.train()
    before = E.embedding_grad.launches
    loss = model.calculate_loss(batch, step=1)
    loss.backward()
    assert E.embedding_grad.launches == before + 1
    got = {k: v.grad.clone() for k, v in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    monkeypatch.setattr(model, "embed", lambda ids: F.embedding(ids, model.item_embedding).to(
        torch.bfloat16))
    want = model.calculate_loss(batch, step=1)
    want.backward()
    assert E.embedding_grad.launches == before + 1
    assert abs(float(loss.detach()) - float(want.detach())) <= 1e-5 * abs(float(want.detach()))
    for k, v in model.named_parameters():
        assert float((got[k] - v.grad).abs().max()) <= GRAD_RTOL * float(v.grad.abs().max()), k


# ---------------------------------------------------------------------------
# outside the whole-layer kernels: LN(dropout(x)) of a one-layer RecBLR, the
# linear scan (C > 128) and the standalone BD-LRU (C <= 128, T > 512 with no
# chunk)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p_drop", [0.0, 0.2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 48, 512, 30, 33])
def test_dropout_ln_kernels_match_plain(dev, d, dtype, p_drop):
    rng = np.random.default_rng(60)
    dt = getattr(torch, dtype)
    x = torch.from_numpy((2 * rng.standard_normal((6, 50, d))).astype(np.float32)).to(dev, dt)
    dout = torch.from_numpy(rng.standard_normal((6, 50, d)).astype(np.float32)).to(dev, dt)
    q = {"s": torch.from_numpy((1 + 0.1 * rng.standard_normal(d)).astype(np.float32)).to(dev),
         "b": torch.from_numpy((0.1 * rng.standard_normal(d)).astype(np.float32)).to(dev)}
    before = (FL.fused_dropout_ln.launches, FL.fused_dropout_ln_bwd.launches)
    out = FL.fused_dropout_ln(x, q["s"], q["b"], p_drop, 4321)
    dx, ds, db = FL.fused_dropout_ln_bwd(x, dout, q["s"], q["b"], p_drop, 4321)
    assert (FL.fused_dropout_ln.launches, FL.fused_dropout_ln_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert out.dtype == dx.dtype == dt and ds.dtype == db.dtype == torch.float32
    want = _plain_vjp(lambda a, p: FL.fused_dropout_ln_plain(a, p["s"], p["b"], p_drop, 4321),
                      x, q, dout)
    _assert_grads((out, dx, {"s": ds, "b": db}), want, dtype)
    again = FL.fused_dropout_ln_bwd(x, dout, q["s"], q["b"], p_drop, 4321)
    assert all(torch.equal(a, b) for a, b in zip(again, (dx, ds, db)))


def test_dropout_ln_mask_bits_match_plain(dev):
    """dx = LN'(dv) * m0: zero exactly where the mask of layers.dropout(x)
    drops, so the backward replays the forward's bits at the same
    coordinates."""
    from datamining_recblr_torch.ops import philox

    rng = np.random.default_rng(61)
    x = torch.from_numpy(rng.standard_normal((7, 50, 64)).astype(np.float32)).to(dev)
    dout = torch.from_numpy(rng.standard_normal((7, 50, 64)).astype(np.float32)).to(dev)
    ones, zeros = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    dx, _, _ = FL.fused_dropout_ln_bwd(x, dout, ones, zeros, 0.4, 31337)
    want = philox.dropout_mask(31337, philox.M0, 7, 50, 64, 0.4, dev) > 0
    assert torch.equal(dx != 0, want)


@pytest.mark.parametrize("pre", [False, True])
@pytest.mark.parametrize("p_drop", [0.0, 0.3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [30, 33, 64, 512])
def test_ln_forwards_at_a_row_count_no_row_group_divides(dev, d, dtype, p_drop, pre):
    """Rows 6 (pre False) and 5 (pre True) forward at B 7, T 45 (315 rows:
    an odd count, so the last segment of two rows holds one), D 30 and 33
    (no 16-byte rows), 64 and 512 (four groups a lane): one launch, the
    plain version's values, the same bits on a rerun."""
    rng = np.random.default_rng(63 + d)
    b, t = 7, 45
    dt = getattr(torch, dtype)
    x = torch.from_numpy((2 * rng.standard_normal((b, t, d)) + 1).astype(np.float32)).to(dev, dt)
    pos, s, bias = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
                    for shape in ((t, d), (d,), (d,)))
    fn, args, plain = ((FL.fused_dropout_ln, (x, s, bias, p_drop, 12), FL.fused_dropout_ln_plain)
                       if pre else (FL.fused_ln_dropout, (x, pos, s, bias, p_drop, 12),
                                    FL.fused_ln_dropout_plain))
    before = fn.launches
    got = fn(*args)
    assert fn.launches == before + 1 and got.dtype == dt and got.shape == x.shape
    _assert_attn_close(got, plain(*args), dtype)
    assert torch.equal(fn(*args), got)


@pytest.mark.parametrize("pre", [False, True])
@pytest.mark.parametrize("d", [30, 33, 64, 512])
def test_ln_forward_mask_bits_match_plain(dev, d, pre):
    """The forwards' M0 mask bit for bit against the plain Philox mask at
    B 5, T 41: the prologue with scale 0 and bias 1 returns its mask; LN
    of dropout(ones) is above 0 exactly where the mask keeps (and 0 on a
    row the mask keeps or drops whole)."""
    from datamining_recblr_torch.ops import philox

    b, t, p_drop, seed = 5, 41, 0.4, 777
    ones, zeros = torch.ones(d, device=dev), torch.zeros(d, device=dev)
    want = philox.dropout_mask(seed, philox.M0, b, t, d, p_drop, dev) > 0
    if pre:
        out = FL.fused_dropout_ln(torch.ones((b, t, d), device=dev), ones, zeros, p_drop, seed)
        whole = want.all(-1, keepdim=True) | ~want.any(-1, keepdim=True)
        assert torch.equal((out > 0) | (whole & want), want)
        assert not bool((out[whole.expand_as(out)] != 0).any())
    else:
        out = FL.fused_ln_dropout(torch.randn((b, t, d), device=dev), zeros.expand(t, d)
                                  .contiguous(), zeros, ones, p_drop, seed)
        assert torch.equal(out != 0, want)


@pytest.mark.parametrize("c", [256, 200])
def test_linear_scan_kernels_match_plain(dev, c):
    from datamining_recblr_torch.ops import scan as SC

    rng = np.random.default_rng(62)
    g = torch.from_numpy(rng.uniform(0.3, 0.999, (5, 45, c)).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.standard_normal((5, 45, c)).astype(np.float32)).to(dev)
    dh = torch.from_numpy(rng.standard_normal((5, 45, c)).astype(np.float32)).to(dev)
    before = (SC.linear_scan.launches, SC.linear_scan_reverse.launches)
    h = SC.linear_scan(g, x)
    r = SC.linear_scan_reverse(g, x)
    assert (SC.linear_scan.launches, SC.linear_scan_reverse.launches) == (
        before[0] + 1, before[1] + 1)
    torch.testing.assert_close(h, SC.linear_scan_serial(g, x), **TOL["float32"])
    torch.testing.assert_close(r, SC.linear_scan_reverse_serial(g, x), **TOL["float32"])
    gl, xl = g.clone().requires_grad_(), x.clone().requires_grad_()
    SC.linear_scan(gl, xl).backward(dh)
    assert SC.linear_scan_reverse.launches == before[1] + 2
    want = torch.autograd.grad(SC.linear_scan_serial(g.requires_grad_(), x.requires_grad_()),
                               [g, x], dh)
    for got, w in zip((gl.grad, xl.grad), want):
        assert float((got - w).abs().max()) <= GRAD_RTOL * float(w.abs().max())


def test_seq_parallel_scan_matches_one_launch(dev, tmp_path):
    """``seq_parallel_scan`` over four simulated shards: four gloo ranks
    sharing the card, each holding a [B, T/4, C] chunk, against one
    ``linear_scan`` launch over the whole T (forward and both gradients);
    each rank launches row 7 twice forward and twice in reverse."""
    from torch_mesh_worker import launch

    from datamining_recblr_torch.ops import scan as SC

    rng = np.random.default_rng(64)
    g, x, dh = (rng.uniform(0.3, 0.999, (5, 64, 160)).astype(np.float32),
                rng.standard_normal((5, 64, 160)).astype(np.float32),
                rng.standard_normal((5, 64, 160)).astype(np.float32))
    ranks = launch({"cases": [("scan", "seq_scan", dict(gates=g, tokens=x, cot=dh,
                                                        mesh_shape={"seq": 4},
                                                        device="cuda"))]}, 4, tmp_path)
    gt = torch.from_numpy(g).to(dev).requires_grad_()
    xt = torch.from_numpy(x).to(dev).requires_grad_()
    h = SC.linear_scan(gt, xt)
    h.backward(torch.from_numpy(dh).to(dev))
    for r, res in enumerate(ranks):
        got = res["scan"]
        t0, t1 = got["chunk"]
        assert (t0, t1) == (16 * r, 16 * (r + 1))
        assert got["launches"] == (2, 2)
        torch.testing.assert_close(got["h"], h.detach()[:, t0:t1].cpu(), **TOL["float32"])
        for mine, want in ((got["dg"], gt.grad), (got["dx"], xt.grad)):
            want = want[:, t0:t1].cpu()
            assert float((mine - want).abs().max()) <= GRAD_RTOL * float(want.abs().max())


def _bdlru_params(rng, c, dev, k=K):
    def r(*s, std=0.3):
        return torch.from_numpy((std * rng.standard_normal(s)).astype(np.float32)).to(dev)

    return {"wc": r(k, c), "bc": r(c), "wg": r(c, 2 * c, std=0.1), "bg": r(2 * c, std=0.1),
            "lam": torch.linspace(-6.9, 12.0, c, device=dev)}


@pytest.mark.parametrize("use_conv", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [128, 96])
def test_bdlru_kernels_match_plain(dev, c, dtype, use_conv):
    """Output, dx and the five weight grads against autograd of the plain
    version; T 77 ends in a partial tile; without the conv dwc and dbc are
    0 on both sides."""
    from datamining_recblr_torch.ops import fused_bdlru as FBD

    rng = np.random.default_rng(63)
    dt = getattr(torch, dtype)
    p = _bdlru_params(rng, c, dev)
    x = torch.from_numpy(rng.standard_normal((5, 77, c)).astype(np.float32)).to(dev, dt)
    dh = torch.from_numpy(rng.standard_normal((5, 77, c)).astype(np.float32)).to(dev, dt)
    names = list(p)
    before = (FBD.fused_bdlru.launches, FBD.fused_bdlru_bwd.launches)
    out = FBD.fused_bdlru(x, *p.values(), use_conv)
    dx, *grads = FBD.fused_bdlru_bwd(x, dh, *p.values(), use_conv)
    assert (FBD.fused_bdlru.launches, FBD.fused_bdlru_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert out.dtype == dx.dtype == dt
    want = _plain_vjp(lambda a, q: FBD.fused_bdlru_plain(a, *q.values(), use_conv), x, p, dh)
    _assert_grads((out, dx, dict(zip(names, grads))), want, dtype)
    if not use_conv:
        assert not grads[0].any() and not grads[1].any()


@pytest.mark.parametrize("k", [9, 16])
def test_bdlru_kernels_take_more_taps_than_the_layer_kernels(dev, k):
    """d_conv beyond the whole-layer kernels' 8 (the model's unfused
    composition at T > 512): the standalone BD-LRU sizes its halo to K."""
    from datamining_recblr_torch.ops import fused_bdlru as FBD

    rng = np.random.default_rng(66)
    p = _bdlru_params(rng, 128, dev, k=k)
    x = torch.from_numpy(rng.standard_normal((3, 70, 128)).astype(np.float32)).to(dev)
    dh = torch.from_numpy(rng.standard_normal((3, 70, 128)).astype(np.float32)).to(dev)
    out = FBD.fused_bdlru(x, *p.values())
    dx, *grads = FBD.fused_bdlru_bwd(x, dh, *p.values())
    want = _plain_vjp(lambda a, q: FBD.fused_bdlru_plain(a, *q.values()), x, p, dh)
    _assert_grads((out, dx, dict(zip(p, grads))), want, "float32")


def test_slice_wrappers_return_a_gradient_path(dev):
    """With grad enabled, the three new wrappers' outputs carry their
    backward kernels (the fault repaired for the attention wrappers)."""
    from datamining_recblr_torch.ops import fused_bdlru as FBD
    from datamining_recblr_torch.ops import scan as SC

    rng = np.random.default_rng(64)
    x = torch.from_numpy(rng.standard_normal((3, 20, 64)).astype(np.float32)).to(dev)
    x.requires_grad_()
    s = torch.ones(64, device=dev, requires_grad=True)
    b = torch.zeros(64, device=dev, requires_grad=True)
    p = {k: v.requires_grad_() for k, v in _bdlru_params(rng, 64, dev).items()}
    g = torch.full((3, 20, 64), 0.9, device=dev, requires_grad=True)
    before = (FL.fused_dropout_ln_bwd.launches, SC.linear_scan_reverse.launches,
              FBD.fused_bdlru_bwd.launches)
    for out in (FL.fused_dropout_ln(x, s, b, 0.2, 5), SC.linear_scan(g, x),
                FBD.fused_bdlru(x, *p.values())):
        assert out.grad_fn is not None
        x.grad = None
        out.square().sum().backward()
        assert x.grad is not None and x.grad.abs().sum() > 0
    assert s.grad is not None and g.grad is not None and p["wg"].grad is not None
    assert (FL.fused_dropout_ln_bwd.launches, SC.linear_scan_reverse.launches,
            FBD.fused_bdlru_bwd.launches) == tuple(n + 1 for n in before)


# (config, T, batch, {wrapper: launches a step}): a one-layer model at H&M's
# length and dropout (row 5 then K2); C 256 (row 7 a layer); C 128 at T 515
# (row 8 a layer)
SLICE_STEPS = {
    "one_layer_hm": ({"num_layers": 1, "dropout_prob": 0.4}, 50, 64,
                     ("fused_dropout_ln", "fused_dropout_ln_bwd", "fused_recurrent_layer_last",
                      "fused_recurrent_layer_last_bwd"), 1),
    "wide": ({"expand": 4, "dropout_prob": 0.2}, 40, 32,
             ("linear_scan", "linear_scan_reverse"), 2),
    "long_odd": ({"dropout_prob": 0.2}, 515, 8, ("fused_bdlru", "fused_bdlru_bwd"), 2),
    "long_odd_k9": ({"dropout_prob": 0.2, "d_conv": 9}, 515, 8,
                    ("fused_bdlru", "fused_bdlru_bwd"), 2),
}


@pytest.mark.parametrize("case", list(SLICE_STEPS))
def test_slice_train_step_through_kernels_matches_plain(dev, case, monkeypatch):
    """One CE step of RecBLR (hidden 64, fp32) on each path outside the
    whole-layer kernels: the launches of its kernels, and the loss and
    every parameter gradient as the same step with each wrapper swapped
    for its plain version (same seeds, same masks)."""
    from datamining_recblr_torch.models import recblr as RB
    from datamining_recblr_torch.models.base import ce_loss
    from datamining_recblr_torch.ops import fused_bdlru as FBD
    from datamining_recblr_torch.ops import scan as SC

    overrides, t, b, names, per_step = SLICE_STEPS[case]
    cfg = Config(model="RecBLR", config_dict={"hidden_size": 64, "num_layers": 2,
                                               "MAX_ITEM_LIST_LENGTH": t, **overrides})
    model = get_model("RecBLR")(cfg, 300, t, device=dev)
    assert model.use_fused_layer() == (case == "one_layer_hm")
    rng = np.random.default_rng(65)
    lens = torch.from_numpy(rng.integers(1, t + 1, b).astype(np.int32)).to(dev)
    seq = torch.from_numpy(rng.integers(1, 300, (b, t))).to(dev)
    seq = torch.where(torch.arange(t, device=dev)[None] < lens[:, None], seq, 0)
    batch = {"item_seq": seq, "item_seq_len": lens,
             "pos_item": torch.from_numpy(rng.integers(1, 300, b)).to(dev)}
    fns = {n: getattr(mod, n) for mod in (FL, SC, FBD) for n in names if hasattr(mod, n)}
    before = {n: f.launches for n, f in fns.items()}
    model.train()
    loss = model.calculate_loss(batch, step=11)
    loss.backward()
    launches = {n: f.launches - before[n] for n, f in fns.items()}
    assert launches == dict.fromkeys(names, per_step)
    got = {k: v.grad.clone() for k, v in model.named_parameters()}
    model.zero_grad()
    for n, plain in (("fused_dropout_ln", FL.fused_dropout_ln_plain),
                     ("fused_recurrent_layer_last", FL.fused_recurrent_layer_last_plain),
                     ("linear_scan", SC.linear_scan_serial),
                     ("fused_bdlru", FBD.fused_bdlru_plain)):
        monkeypatch.setattr(RB, n, plain)
    out = model(seq, lens, step=11)
    want = ce_loss(model._mask_padded_vocab(model._logits(out), value=-1e30), batch["pos_item"])
    want.backward()
    assert abs(float(loss.detach()) - float(want.detach())) <= 1e-4 * abs(float(want.detach()))
    for k, v in model.named_parameters():
        assert float((got[k] - v.grad).abs().max()) <= GRAD_RTOL * float(v.grad.abs().max()), k


# ---------------------------------------------------------------------------
# d_conv above 8 in the whole-layer kernels: the halo is sized to K
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [9, 16, 64])
def test_layer_kernels_take_up_to_64_taps(dev, k):
    """K1 and K2, forward and backward, with K conv taps against autograd
    of their plain versions (T 70 >= K, ending in a partial tile)."""
    rng = np.random.default_rng(80 + k)
    p = _params(rng, 64, 128, dev, prologue=True)
    p["wc"] = torch.from_numpy((0.1 * rng.standard_normal((k, 128))).astype(np.float32)).to(dev)
    t = 70
    x = torch.from_numpy(rng.standard_normal((3, t, 64)).astype(np.float32)).to(dev)
    dout = torch.from_numpy(rng.standard_normal((3, t, 64)).astype(np.float32)).to(dev)
    flags = (True, True, True, 0.2, 7)
    out, saved = FL.fused_recurrent_layer_train(x, p, *flags)
    dx, grads = FL.fused_recurrent_layer_bwd(x, dout, p, *flags, saved=saved)
    want = _plain_vjp(lambda a, q: FL.fused_recurrent_layer_plain(a, q, *flags), x, p, dout)
    _assert_grads((out, dx, grads), want, "float32")
    lens = torch.tensor([1, t, 40], device=dev)
    q = {n: v for n, v in p.items() if n not in ("pl_s", "pl_b")}
    last = (True, True, 0.2, 7)
    out, saved = FL.fused_recurrent_layer_last_train(x, lens, q, *last)
    dx, grads = FL.fused_recurrent_layer_last_bwd(x, lens, dout[:, 0], q, *last, saved=saved)
    want = _plain_vjp(lambda a, r: FL.fused_recurrent_layer_last_plain(a, lens, r, *last), x, q,
                      dout[:, 0])
    _assert_grads((out, dx, grads), want, "float32")


def test_layer_kernels_name_the_tap_bound(dev):
    rng = np.random.default_rng(90)
    p = _params(rng, 64, 128, dev)
    p["wc"] = torch.zeros((65, 128), device=dev)
    x = torch.zeros((2, 80, 64), device=dev)
    with pytest.raises(ValueError, match="K <= min\\(T, 64\\)"):
        FL.fused_recurrent_layer(x, p)
    with pytest.raises(ValueError, match="K <= min\\(T, 64\\)"):
        FL.fused_recurrent_layer_last(x, torch.tensor([3, 80], device=dev), p)


# ---------------------------------------------------------------------------
# rows 2 and 4 on the tensor cores: widths, taps and lengths the tiles meet
# ---------------------------------------------------------------------------

def _odd_params(rng, d, c, f, k, dev):
    p = _params(rng, d, c, dev, prologue=True)

    def r(*s):
        return torch.from_numpy((0.1 * rng.standard_normal(s)).astype(np.float32)).to(dev)

    p.update(wc=r(k, c), w1=r(d, f), b1=r(f), w2=r(f, d))
    return p


# (D, C, FFN, d_conv K, T): widths no multiple of 16 with 9 and 64 taps, T
# 45 (ending in a ragged item) and 200 (the bench length), and the bench
# widths at T 45
ODD_BWD_SHAPES = [(50, 70, 100, 9, 45), (50, 70, 100, 64, 200), (48, 96, 100, 9, 200),
                  (64, 128, 256, 4, 45)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,c,f,k,t", ODD_BWD_SHAPES)
def test_tensor_core_backwards_at_odd_widths_taps_and_lengths(dev, d, c, f, k, t, dtype):
    """Rows 2 and 4, their products on the tensor cores (3xTF32), against
    autograd of their plain versions at p 0.2 (``_assert_grads``: GRAD_RTOL,
    a bf16 dx within one bf16 ulp on top); row 4 with rows of lengths 0, 1,
    T, above T and one ending inside an item.  A rerun of each backward
    gives the same bits."""
    rng = np.random.default_rng(100 + d + k + t)
    p = _odd_params(rng, d, c, f, k, dev)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal((5, t, d)).astype(np.float32)).to(dev, dt)
    dout = torch.from_numpy(rng.standard_normal((5, t, d)).astype(np.float32)).to(dev, dt)
    flags = (True, True, True, 0.2, 123)
    out, saved = FL.fused_recurrent_layer_train(x, p, *flags)
    dx, grads = FL.fused_recurrent_layer_bwd(x, dout, p, *flags, saved=saved)
    want = _plain_vjp(lambda a, q: FL.fused_recurrent_layer_plain(a, q, *flags), x, p, dout)
    _assert_grads((out, dx, grads), want, dtype)
    dx2, grads2 = FL.fused_recurrent_layer_bwd(x, dout, p, *flags, saved=saved)
    assert torch.equal(dx2, dx) and all(torch.equal(grads2[n], g) for n, g in grads.items())

    q = {n: v for n, v in p.items() if n not in ("pl_s", "pl_b")}
    lens = torch.tensor([0, 1, t, t + 3, 17], device=dev)  # 0 and t + 3 select nothing
    last = (True, True, 0.2, 123)
    d2 = dout[:, 0].contiguous()
    out, saved = FL.fused_recurrent_layer_last_train(x, lens, q, *last)
    dx, grads = FL.fused_recurrent_layer_last_bwd(x, lens, d2, q, *last, saved=saved)
    want = _plain_vjp(lambda a, r: FL.fused_recurrent_layer_last_plain(a, lens, r, *last), x, q,
                      d2)
    _assert_grads((out, dx, grads), want, dtype)
    assert not dx[0].any() and not dx[3].any()
    assert not dx[1, 1:].any() and not dx[4, 17:].any()
    dx2, grads2 = FL.fused_recurrent_layer_last_bwd(x, lens, d2, q, *last, saved=saved)
    assert torch.equal(dx2, dx) and all(torch.equal(grads2[n], g) for n, g in grads.items())


def test_bench_shape_backwards_run_the_tensor_core_kernels(dev):
    """At the bench widths (D 64, C 128, FFN 256, T 200) rows 2 and 4 run
    A', C1' and C2' as the tensor-core kernels, by the names torch.profiler
    records."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(110)
    p = _params(rng, 64, 128, dev, prologue=True)
    q = {n: v for n, v in p.items() if n not in ("pl_s", "pl_b")}
    x = torch.from_numpy(rng.standard_normal((8, 200, 64)).astype(np.float32)).to(dev)
    dout = torch.from_numpy(rng.standard_normal((8, 200, 64)).astype(np.float32)).to(dev)
    lens = torch.tensor([200, 1, 150, 77, 200, 3, 64, 199], device=dev)
    for call in (lambda: FL.fused_recurrent_layer_bwd(x, dout, p, True, True, True, 0.2, 5),
                 lambda: FL.fused_recurrent_layer_last_bwd(x, lens, dout[:, 0].contiguous(), q,
                                                           True, True, 0.2, 5)):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()]
        for kernel in ("tail_bwd_mma_kernel", "gate_bwd_mma_kernel", "inproj_bwd_mma_kernel"):
            assert any(kernel in n for n in names), kernel


# ---------------------------------------------------------------------------
# serving's top-k on the card: ties go to the lower item id
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("v,k", [(329_728, 10), (3_417, 10), (60, 7)])
def test_topk_breaks_ties_by_index_on_the_card(dev, v, k):
    """``topk_scores`` on CUDA scores with many ties (integer scores, one
    value at every seventh column, a row of -inf but for three columns):
    the ids of a stable descending sort, as jax.lax.top_k gives."""
    from datamining_recblr_torch.ops.topk import topk_scores

    rng = np.random.default_rng(180 + v)
    s = rng.integers(-3, 4, (6, v)).astype(np.float32)
    s[1] = 0.0
    s[1, ::7] = 1.0
    s[2] = -np.inf
    s[2, [v - 1, 5, v // 2]] = 2.0
    want = np.argsort(-s, axis=1, kind="stable")[:, :k]
    vals, ids = topk_scores(torch.from_numpy(s).to(dev), k)
    np.testing.assert_array_equal(ids.cpu().numpy(), want)
    np.testing.assert_array_equal(vals.cpu().numpy(), np.take_along_axis(s, want, 1))


# ---------------------------------------------------------------------------
# rows 1, 3, 8 and 9 forwards on the tensor cores (csrc/layer_fwd.cuh)
# ---------------------------------------------------------------------------

# (D, C, FFN, d_conv K, T): widths above 64, where the tail takes its
# 16-tile instantiation (one block an SM): the wrappers' largest widths
# with 64 taps and the largest FFN (phase A's largest shared memory), and
# D 96 at T 45
WIDE_FWD_SHAPES = [(128, 128, 512, 64, 200), (96, 128, 200, 9, 45)]


@pytest.mark.parametrize("p_drop", [0.0, 0.2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,c,f,k,t", ODD_BWD_SHAPES + WIDE_FWD_SHAPES)
def test_tensor_core_forwards_at_odd_widths_taps_and_lengths(dev, d, c, f, k, t, dtype, p_drop):
    """Rows 1 and 3, their products on the tensor cores (3xTF32), against
    their plain versions at TOL, at widths no multiple of 16, 9 and 64
    taps, T 45 and 200, and at D 96 and 128; row 3 with rows of lengths 0,
    1, T, above T and one ending inside a tile.  A rerun gives the same bits, the stash
    (alpha, h) included."""
    rng = np.random.default_rng(130 + d + k + t)
    p = _odd_params(rng, d, c, f, k, dev)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal((5, t, d)).astype(np.float32)).to(dev, dt)
    flags = (True, True, True, p_drop, 321)
    before = FL.fused_recurrent_layer.launches
    out, saved = FL.fused_recurrent_layer_train(x, p, *flags)
    assert FL.fused_recurrent_layer.launches == before + 1
    want = FL.fused_recurrent_layer_plain(x, p, *flags)
    assert out.dtype == dt and out.shape == x.shape
    torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])
    out2, saved2 = FL.fused_recurrent_layer_train(x, p, *flags)
    assert torch.equal(out2, out) and all(torch.equal(a, b) for a, b in zip(saved2, saved))

    q = {n: v for n, v in p.items() if n not in ("pl_s", "pl_b")}
    lens = torch.tensor([0, 1, t, t + 3, 17], device=dev)  # 0 and t + 3 select nothing
    last = (True, True, p_drop, 321)
    before = FL.fused_recurrent_layer_last.launches
    out, saved = FL.fused_recurrent_layer_last_train(x, lens, q, *last)
    assert FL.fused_recurrent_layer_last.launches == before + 1
    want = FL.fused_recurrent_layer_last_plain(x, lens, q, *last)
    assert out.dtype == dt and out.shape == (5, d)
    torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])
    out2, saved2 = FL.fused_recurrent_layer_last_train(x, lens, q, *last)
    assert torch.equal(out2, out)
    for a, b in zip(saved2, saved):  # the stash holds the positions below each length
        for row, n in ((1, 1), (2, t), (4, 17)):
            assert torch.equal(a[row, :n], b[row, :n])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bdlru_forward_at_64_taps(dev, dtype):
    """Row 8's forward with 64 taps (a halo of 63 rows, T 130 ending inside
    a tile) against its plain version at TOL; a rerun gives the same bits."""
    from datamining_recblr_torch.ops import fused_bdlru as FBD

    rng = np.random.default_rng(140)
    p = _bdlru_params(rng, 128, dev, k=64)
    x = torch.from_numpy(rng.standard_normal((3, 130, 128)).astype(np.float32))
    x = x.to(dev, getattr(torch, dtype))
    before = FBD.fused_bdlru.launches
    out = FBD.fused_bdlru(x, *p.values())
    assert FBD.fused_bdlru.launches == before + 1
    want = FBD.fused_bdlru_plain(x, *p.values())
    torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])
    assert torch.equal(FBD.fused_bdlru(x, *p.values()), out)


# (D, C, FFN, d_conv K, T): XLong's widths at T 1,024 (chunks of 128),
# widths no multiple of 16 at T 520 (chunks of 104) with 8 taps, and the
# wrappers' largest widths and FFN (the tail's 16-tile instantiation)
CHUNKED_FWD_SHAPES = [(64, 128, 256, 4, 1024), (50, 70, 100, 8, 520), (128, 128, 512, 8, 1024)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,c,f,k,t", CHUNKED_FWD_SHAPES)
def test_chunked_forward_output_and_record(dev, d, c, f, k, t, dtype):
    """Row 9's forward at p 0.2: the output against the plain version at
    TOL, its record (entering states, conv tails) against the plain record
    at atol / rtol 1e-4; a rerun gives the same bits."""
    from datamining_recblr_torch.ops import fused_layer_chunked as FLC

    rng = np.random.default_rng(150 + d + t)
    p = _odd_params(rng, d, c, f, k, dev)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal((2, t, d)).astype(np.float32)).to(dev, dt)
    args = (True, True, True, 0.2, 91)
    out, record = FLC.fused_recurrent_layer_chunked_train(x, p, *args)
    want, wrec = FLC.fused_recurrent_layer_chunked_plain(x, p, *args)
    _assert_close_dtype(out, want, dtype)
    torch.testing.assert_close(record, wrec, atol=1e-4, rtol=1e-4)
    out2, record2 = FLC.fused_recurrent_layer_chunked_train(x, p, *args)
    assert torch.equal(out2, out) and torch.equal(record2, record)


def test_bench_shape_forwards_run_the_tensor_core_kernels(dev):
    """At the bench widths rows 1, 3 and 9 run phase A and the tail as the
    tensor-core kernels, and row 8 runs phase A so, by the names
    torch.profiler records; the FMA kernels they replace run nowhere."""
    from torch.profiler import ProfilerActivity, profile

    from datamining_recblr_torch.ops import fused_bdlru as FBD
    from datamining_recblr_torch.ops import fused_layer_chunked as FLC

    rng = np.random.default_rng(160)
    p = _params(rng, 64, 128, dev, prologue=True)
    q = {n: v for n, v in p.items() if n not in ("pl_s", "pl_b")}
    x = torch.from_numpy(rng.standard_normal((8, 200, 64)).astype(np.float32)).to(dev)
    xl = torch.from_numpy(rng.standard_normal((2, 1024, 64)).astype(np.float32)).to(dev)
    xb = torch.from_numpy(rng.standard_normal((2, 1020, 128)).astype(np.float32)).to(dev)
    lens = torch.tensor([200, 1, 150, 77, 200, 3, 64, 199], device=dev)
    pb = _bdlru_params(rng, 128, dev)
    for call, kernels in (
            (lambda: FL.fused_recurrent_layer_train(x, p, True, True, True, 0.2, 5),
             ("phase_a_mma_kernel", "tail_mma_kernel")),
            (lambda: FL.fused_recurrent_layer_last_train(x, lens, q, True, True, 0.2, 5),
             ("phase_a_mma_kernel", "tail_mma_kernel")),
            (lambda: FLC.fused_recurrent_layer_chunked_train(xl, p, True, True, True, 0.2, 5),
             ("phase_a_mma_kernel", "tail_mma_kernel")),
            (lambda: FBD.fused_bdlru(xb, *pb.values()), ("phase_a_mma_kernel",))):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()]
        for kernel in kernels:
            assert any(kernel in n for n in names), kernel
        assert not any("phase_a_kernel" in n or "tail_kernel" in n for n in names), names


# sha256 (first 16 hex digits) of dx and every weight grad of rows 2 and 4
# from _bwd_bits's input, as the commit before the forward's redesign
# (fcce0fd) computed them on an NVIDIA H100 80GB HBM3: the backward phases
# A', C1' and C2' keep their bits now that their product helpers live in
# mma_tile.cuh
PARENT_BWD_BITS = {
    "float32": {"row2": "948132ea11b0e536", "row4": "47e69b317cf6f40d"},
    "bfloat16": {"row2": "794dbae4ae57fe79", "row4": "c9cd5d0584663b89"},
}


def _bwd_bits(dev, dtype):
    """{row: digest} of rows 2 and 4's backwards on one fixed input, with
    alpha and h given (no recompute), so only A', C1', C2', the reverse
    scans and the reduction produce the bits."""
    import hashlib

    rng = np.random.default_rng(170)
    d, c, f, k, t, b = 50, 70, 100, 9, 45, 5
    p = _odd_params(rng, d, c, f, k, dev)
    q = {n: v for n, v in p.items() if n not in ("pl_s", "pl_b")}
    dt = getattr(torch, dtype)

    def r(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)

    x, dout = r(b, t, d).to(dt), r(b, t, d).to(dt)
    alpha = torch.from_numpy(rng.uniform(0.3, 0.99, (b, t, c)).astype(np.float32)).to(dev)
    h = r(b, t, c)
    lens = torch.tensor([0, 1, t, t + 3, 17], device=dev)
    got = {
        "row2": FL.fused_recurrent_layer_bwd(x, dout, p, True, True, True, 0.2, 11,
                                             saved=(alpha, h)),
        "row4": FL.fused_recurrent_layer_last_bwd(x, lens, dout[:, 0].contiguous(), q, True,
                                                  True, 0.2, 11, saved=(alpha, h.clone())),
    }
    bits = {}
    for row, (dx, grads) in got.items():
        digest = hashlib.sha256(dx.float().cpu().numpy().tobytes())
        for name in FL.PARAM_ORDER:
            if name in grads:
                digest.update(grads[name].cpu().numpy().tobytes())
        bits[row] = digest.hexdigest()[:16]
    return bits


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_phases_keep_the_parents_bits(dev, dtype):
    assert _bwd_bits(dev, dtype) == PARENT_BWD_BITS[dtype]


# ---------------------------------------------------------------------------
# queue B row 15: the masked-softmax attention (ops/attention.py)
# ---------------------------------------------------------------------------

# [B, H, T, dh]: d256, the attention baselines at hidden 256 (2 heads, T
# 200, batch 2,048); long, SASRec at hidden 64 (2 heads) and T 2,048
ATTN_SHAPES = {"d256": (2048, 2, 200, 128), "long": (4, 2, 2048, 32)}


def _attn_inputs(rng, shape, dev, dt):
    b, h, t, dh = shape
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dt)
                     for _ in range(4))
    lens = rng.integers(1, t + 1, b)
    lens[:3] = [0, 1, t]
    return q, k, v, dout, torch.from_numpy(lens).to(dev)


def _assert_row15(got, want, dtype, what, floor=0.0):
    """fp32: within 1e-4 of the largest plain value (a row of lens 0 sits
    at -10000, where an fp32 ulp is 2^-10: ``_assert_attn_grads``); bf16:
    one bf16 ulp of the value plus 1e-4 of the largest value (both sides
    compute in fp32 and round once).  ``floor``: the least absolute
    tolerance (a gradient that is 0 up to rounding)."""
    g, w = got.detach().float(), want.detach().float()
    assert bool(torch.isfinite(g).all()), what
    top = float(w.abs().max())
    rtol = 2.0 ** -7 if dtype == "bfloat16" else 0.0
    assert bool(((g - w).abs() <= rtol * w.abs() + max(1e-4 * top, floor)).all()), what


def _row15_counts(A):
    """Launches of row 15's forward and backward, and of their tensor-core
    kernels."""
    return (A.fused_attention.launches, A.fused_attention.mma_launches,
            A.fused_attention_bwd.launches, A.fused_attention_bwd.mma_launches)


@pytest.mark.parametrize("p_drop", [0.0, 0.2])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidirectional"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(ATTN_SHAPES))
def test_attention_kernels_match_plain(dev, shape, dtype, causal, p_drop):
    """Forward and backward (dq, dk, dv) against autograd of the plain
    version, rows of lens 0, 1 and T among the batch."""
    from datamining_recblr_torch.ops import attention as A

    rng = np.random.default_rng(70)
    dt = getattr(torch, dtype)
    q, k, v, dout, lens = _attn_inputs(rng, ATTN_SHAPES[shape], dev, dt)
    args = (4242, causal, p_drop)
    before = _row15_counts(A)
    out, saved = A.fused_attention_train(q, k, v, lens, *args)
    grads = A.fused_attention_bwd(q, k, v, lens, dout, *args, saved=saved)
    assert _row15_counts(A) == tuple(n + 1 for n in before)  # dh 128, 32: the tensor cores
    assert out.dtype == dt and all(g.dtype == dt for g in grads)
    with torch.no_grad():
        torch.testing.assert_close(A.fused_attention(q, k, v, lens, *args), out, atol=0, rtol=0)
    leaves = [a.clone().requires_grad_() for a in (q, k, v)]
    want = A.fused_attention_plain(*leaves, lens, *args)
    wgrads = torch.autograd.grad(want, leaves, dout)
    for what, g, w in zip(("out", "dq", "dk", "dv"), (out, *grads), (want, *wgrads)):
        _assert_row15(g, w, dtype, what)


@pytest.mark.parametrize("t", [1, 17, 200, 2048])
@pytest.mark.parametrize("dh", [8, 15, 32, 72, 128, 200, 256])
def test_row15_kernels_at_every_tile_shape(dev, dh, t):
    """Forward and backward (dq, dk, dv) against autograd of the plain
    version where the tiles meet their edges: T ragged against 64-row tiles
    and chunks of 8 and 16 rows, T 1, odd and narrow dh, and the FMA
    kernels' widths above 128; rows of lens 0, 1 and T in every batch,
    causal and bidirectional, p 0 and 0.2, fp32 and bf16.  The tensor-core
    kernels run up to dh 128 (``mma_launches``), and a rerun's dq, dk, dv
    are the same bits.  Bound: ``_assert_row15``, at least 1e-6 of the
    call's largest gradient (at T 1, dq and dk are 0 up to rounding)."""
    from datamining_recblr_torch.ops import attention as A

    assert A.uses_mma(dh) == (dh <= 128)
    mma = int(A.uses_mma(dh))
    rng = np.random.default_rng(dh * 10000 + t)
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        q, k, v, dout, lens = _attn_inputs(rng, (4 if t == 2048 else 6, 2, t, dh), dev, dt)
        for causal in (True, False):
            for p_drop in (0.0, 0.2):
                args = (4242, causal, p_drop)
                what = f"{dtype} causal={causal} p={p_drop}"
                before = _row15_counts(A)
                out, saved = A.fused_attention_train(q, k, v, lens, *args)
                grads = A.fused_attention_bwd(q, k, v, lens, dout, *args, saved=saved)
                assert _row15_counts(A) == (before[0] + 1, before[1] + mma, before[2] + 1,
                                            before[3] + mma), what
                again = A.fused_attention_bwd(q, k, v, lens, dout, *args, saved=saved)
                assert all(torch.equal(g, a) for g, a in zip(grads, again)), what
                leaves = [a.clone().requires_grad_() for a in (q, k, v)]
                want = A.fused_attention_plain(*leaves, lens, *args)
                wgrads = torch.autograd.grad(want, leaves, dout)
                floor = 1e-6 * max(float(w.abs().max()) for w in wgrads)
                for name, g, w in zip(("out", "dq", "dk", "dv"), (out, *grads), (want, *wgrads)):
                    _assert_row15(g, w, dtype, f"{name} {what}", floor)


@pytest.mark.parametrize("dh", [8, 15, 32, 64, 72, 128, 200, 256])
def test_row15_mask_bits_match_plain(dev, dh):
    """Each head's probability mask as the forward draws it, bit for bit:
    T = dh keys and v the identity, so out[b, h, i, j] = p_ij m_ij, with
    every p_ij > 0 where the key is kept (lens T, and a row of lens 0)."""
    from datamining_recblr_torch.ops import attention as A
    from datamining_recblr_torch.ops import philox

    rng = np.random.default_rng(71)
    b, h, t, seed, pd = 16, 2, dh, 24680, 0.2
    q, k = (torch.from_numpy(rng.standard_normal((b, h, t, dh)).astype(np.float32)).to(dev)
            for _ in range(2))
    v = torch.eye(t, device=dev).expand(b, h, t, dh).contiguous()
    lens = torch.full((b,), t, device=dev)
    lens[3] = 0
    masks = A.prob_masks(seed, pd, b, h, t, dev) > 0
    for causal in (False, True):
        out = A.fused_attention(q, k, v, lens, seed, causal, pd)
        want = masks.clone()
        if causal:
            keep = torch.ones((t, t), dtype=torch.bool, device=dev).tril()
            want[lens > 0] &= keep
        assert torch.equal(out != 0, want), causal
    assert torch.equal(masks[:, 1], philox.dropout_mask(seed, philox.prob_mask_id(1), b, t, t,
                                                        pd, dev) > 0)


def test_attention_wrappers_raise_rather_than_fall_back(dev):
    from datamining_recblr_torch.ops import attention as A

    q = torch.zeros((2, 2, 16, 264), device=dev)
    lens = torch.tensor([3, 16], device=dev)
    with pytest.raises(ValueError, match="dh <= 256"):
        A.fused_attention(q, q, q, lens)
    q = torch.zeros((2, 2, 16, 32), device=dev)
    with pytest.raises(ValueError, match="q must be contiguous"):
        A.fused_attention(q.transpose(2, 3).contiguous().transpose(2, 3), q, q, lens)
    with pytest.raises(ValueError, match="k must be"):
        A.fused_attention(q, q.half(), q, lens)
    with pytest.raises(ValueError, match="lens"):
        A.fused_attention(q, q, q, lens.cpu())
    out = A.fused_attention(q.requires_grad_(), q, q, lens)
    assert out.grad_fn is not None


@pytest.mark.parametrize("name", ["SASRec", "BERT4Rec"])
def test_rejected_shape_train_step_goes_through_row_15(dev, name, monkeypatch):
    """A shape ``fused_block.supports`` rejects (hidden 144) trains on the
    card: one forward launch of row 15 a layer and one backward, and the
    loss and every gradient equal the same step with the plain attention
    (1e-4 of each gradient's largest value, at least 1e-6 of the largest
    of all: b_k's is zero up to rounding)."""
    from datamining_recblr_torch.models import layers as L
    from datamining_recblr_torch.ops import attention as A

    t = 30
    cfg = Config(model=name, config_dict={
        "MAX_ITEM_LIST_LENGTH": t, "hidden_size": 144, "inner_size": 288, "n_heads": 2,
        "n_layers": 2, "hidden_dropout_prob": 0.2, "attn_dropout_prob": 0.2, "mask_ratio": 0.2})
    model = get_model(name)(cfg, 300, t, generator=torch.Generator().manual_seed(3))
    rng = np.random.default_rng(72)
    lens = rng.integers(1, t + 1, 64)
    lens[:2] = [1, t]
    seq = np.where(np.arange(t)[None] < lens[:, None], rng.integers(1, 300, (64, t)), 0)
    batch = {"item_seq": torch.from_numpy(seq).to(dev),
             "item_seq_len": torch.from_numpy(lens).to(dev),
             "pos_item": torch.from_numpy(rng.integers(1, 300, 64)).to(dev),
             "weight": torch.ones(64, device=dev)}
    model.train()
    got = {}
    for kernel in (True, False):
        if not kernel:
            monkeypatch.setattr(L, "fused_attention", A.fused_attention_plain)
        before = (A.fused_attention.launches, A.fused_attention_bwd.launches)
        model.zero_grad(set_to_none=True)
        loss = model.calculate_loss(batch, step=5)
        loss.backward()
        launches = (A.fused_attention.launches - before[0],
                    A.fused_attention_bwd.launches - before[1])
        assert launches == ((2, 2) if kernel else (0, 0))
        got[kernel] = (float(loss.detach()), {k: v.grad.clone() for k, v in
                                              model.named_parameters()})
    assert abs(got[True][0] - got[False][0]) <= 1e-5 * abs(got[False][0])
    top = max(float(w.abs().max()) for w in got[False][1].values())
    for pname, g in got[True][1].items():
        w = got[False][1][pname]
        assert float((g - w).abs().max()) <= max(1e-4 * float(w.abs().max()), 1e-6 * top), pname


@pytest.mark.parametrize("name", ["SASRec", "BERT4Rec"])
def test_heads_wider_than_256_train_and_serve_on_the_card(dev, name):
    """Hidden 528 with 2 heads (dh 264, beyond row 15) on the card: no
    launch of the attention kernels, and one train step's loss and every
    gradient, and one recommend(), as the same model on the CPU
    (``test_torch_baselines.py`` holds that one against the JAX package):
    the loss within 1e-5, each gradient within GRAD_RTOL of its largest
    value (at least 1e-6 of the largest of all: b_k's is zero up to
    rounding), scores within 1e-4."""
    from datamining_recblr_torch.ops import attention as A

    t = 20
    cfg = Config(model=name, config_dict={
        "MAX_ITEM_LIST_LENGTH": t, "hidden_size": 528, "inner_size": 2112, "n_heads": 2,
        "n_layers": 2, "hidden_dropout_prob": 0.2, "attn_dropout_prob": 0.2, "mask_ratio": 0.2})
    cpu = get_model(name)(cfg, 300, t, device="cpu")
    card = get_model(name)(cfg, 300, t, device=dev)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(73)
    lens = rng.integers(1, t + 1, 32)
    lens[:2] = [1, t]
    seq = np.where(np.arange(t)[None] < lens[:, None], rng.integers(1, 300, (32, t)), 0)
    pos = rng.integers(1, 300, 32)
    requests = [rng.integers(1, 300, k).tolist() for k in (0, 1, 5, t, t + 7)]
    got = {}
    for model in (card, cpu):
        d = model.device
        batch = {"item_seq": torch.from_numpy(seq).to(d),
                 "item_seq_len": torch.from_numpy(lens).to(d),
                 "pos_item": torch.from_numpy(pos).to(d),
                 "weight": torch.ones(32, device=d)}
        before = (A.fused_attention.launches, A.fused_attention_bwd.launches)
        model.train()
        model.zero_grad(set_to_none=True)
        loss = model.calculate_loss(batch, step=5)
        loss.backward()
        model.eval()
        ids, vals = Recommender(model, top_k=10).recommend(requests)
        assert (A.fused_attention.launches, A.fused_attention_bwd.launches) == before
        got[d.type] = (float(loss.detach()), {k: v.grad.cpu() for k, v in
                                              model.named_parameters()}, ids, vals)
    (loss, grads, ids, vals), (wloss, wgrads, wids, wvals) = got["cuda"], got["cpu"]
    assert np.isfinite(loss) and abs(loss - wloss) <= 1e-5 * abs(wloss)
    top = max(float(w.abs().max()) for w in wgrads.values())
    for pname, g in grads.items():
        w = wgrads[pname]
        assert float((g - w).abs().max()) <= max(GRAD_RTOL * float(w.abs().max()),
                                                 1e-6 * top), pname
    assert np.isfinite(vals).all() and float(np.abs(vals - wvals).max()) <= 1e-4


@pytest.mark.parametrize("name", ["RecBLR", "BERT4Rec"])
def test_bpr_gathers_take_the_table_gradient_kernel(dev, name, monkeypatch):
    """The BPR scores' gathers (``ops/embedding.py:gather_rows``, through
    ``SequentialModel.rows_of``): on the card their table gradient is
    ``embedding_grad``'s, the same values as the plain gather's backward
    (fp32 sums in another order), one launch for the table and, in
    BERT4Rec, one for the output bias."""
    from datamining_recblr_torch.models import base as MB
    from datamining_recblr_torch.ops import embedding as E

    cfg = Config(model=name, config_dict={"hidden_size": 32, "MAX_ITEM_LIST_LENGTH": 20,
                                          "inner_size": 64, "loss_type": "BPR",
                                          "dropout_prob": 0.0, "hidden_dropout_prob": 0.0,
                                          "attn_dropout_prob": 0.0})
    model = get_model(name)(cfg, 300, 20, generator=torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    batch = {"item_seq": torch.randint(1, 300, (64, 20), generator=gen).to(dev),
             "item_seq_len": torch.full((64,), 20, device=dev),
             "pos_item": torch.randint(1, 300, (64,), generator=gen).to(dev),
             "neg_item": torch.randint(1, 300, (64,), generator=gen).to(dev)}
    model.train()
    E.embedding_grad.launches = 0
    model.calculate_loss(batch, step=1).backward()
    assert E.embedding_grad.launches == (1 if name == "RecBLR" else 2)
    got = {k: p.grad.clone() for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    monkeypatch.setattr(MB, "gather_rows", lambda t, i: t[i])
    model.calculate_loss(batch, step=1).backward()
    assert E.embedding_grad.launches == (1 if name == "RecBLR" else 2)  # none more
    for k, p in model.named_parameters():
        want = p.grad
        assert float((got[k] - want).abs().max()) <= 1e-5 * max(float(want.abs().max()), 1e-3), k


def test_cold_start_counts_the_held_out_batches(dev, tmp_path):
    """``run_unseen_experiment`` on the card at a small size, mode pre:
    rows 1 and 3 launch once a train step and once an eval batch, the
    held-out users' batches among them, rows 2 and 4 once a train step."""
    from datamining_recblr_torch.data.synthetic import write_stat_matched_dataset
    from datamining_recblr_torch.unseen.pipeline import run_unseen_experiment

    write_stat_matched_dataset(str(tmp_path / "dataset"), "beauty-synth", out_name="cold",
                               n_users=700, n_items=400, n_inters=7_000, n_clusters=10)
    cfg = Config(model="RecBLR", config_dict={
        "dataset": "cold", "data_path": str(tmp_path / "dataset"), "MAX_ITEM_LIST_LENGTH": 50,
        "epochs": 1, "train_batch_size": 512, "eval_batch_size": 16,
        "user_inter_num_interval": "[5,inf)", "item_inter_num_interval": "[5,inf)",
        "checkpoint_dir": str(tmp_path / "saved"), "log_dir": str(tmp_path / "log")})
    counted = (FL.fused_recurrent_layer, FL.fused_recurrent_layer_last,
               FL.fused_recurrent_layer_bwd, FL.fused_recurrent_layer_last_bwd)
    before = [fn.launches for fn in counted]
    out = run_unseen_experiment(mode="pre", config=cfg, test_size=0.2,
                                plot_dir=str(tmp_path / "plot"))
    data = out["experiment"]["data"]
    assert out["experiment"]["model"].device.type == "cuda"
    steps = -(-len(data.train) // 512)
    held = -(-out["n_evaluated"] // 16)
    batches = -(-len(data.valid) // 16) + -(-len(data.test) // 16) + held
    assert held >= 2
    assert [fn.launches - b for fn, b in zip(counted, before)] == [
        steps + batches, steps + batches, steps, steps]
    assert all(np.isfinite(v) for v in out["unseen_result"].values())


def test_probe_gather_kernel_equals_indexing(dev):
    """Queue B row 17e's kernel against ``tab[ids]`` bit for bit, at an N
    that is no multiple of the default 4,096 rows a block, with negative
    ids, int32 and int64 ids, bf16 and fp32 tables, rows of 16-byte
    vectors and of 2-byte ones, and a block height of a few rows."""
    from datamining_recblr_torch.probes import emb_gather as EG

    gen = torch.Generator().manual_seed(27)
    n = 10_001
    for d, dtype in ((64, torch.bfloat16), (64, torch.float32), (3, torch.bfloat16),
                     (5, torch.float32)):
        tab = torch.randn((3417, d), generator=gen).to(dtype).to(dev)
        ids = torch.randint(-3417, 3417, (n,), generator=gen).to(dev)
        for id_dtype in (torch.int32, torch.int64):
            for bn in (EG.BN, 7):
                before = EG.gather.launches
                got = EG.gather(ids.to(id_dtype), tab, bn)
                assert EG.gather.launches == before + 1
                assert torch.equal(got, tab[ids.long()]), (d, dtype, id_dtype, bn)
    torch.cuda.synchronize()


def test_probe_mask_kernels_agree_at_the_xlong_shape(dev):
    """Queue B row 17f's two kernels at the chunked layer's XLong shape (B
    512, T 1,024 in chunks of 128, D 64, FFN 256): the forward-order and
    the reversed-order masks bit for bit, and both against the plain
    masks on every row."""
    from datamining_recblr_torch.probes import mask_replay_check as MR

    sizes = dict(nb=64, nc=8, bt=8, tc=128, d=64, ff=256)
    before = (MR.masks_forward.launches, MR.masks_reversed.launches)
    fwd = MR.masks_forward(MR.SEED, MR.KP, device=dev, **sizes)
    rev = MR.masks_reversed(MR.SEED, MR.KP, device=dev, **sizes)
    assert (MR.masks_forward.launches, MR.masks_reversed.launches) == (before[0] + 1,
                                                                        before[1] + 1)
    plain = MR.masks_plain(MR.SEED, MR.KP, device=dev, **sizes)
    for k, (a, b, p) in enumerate(zip(fwd, rev, plain)):
        assert a.shape == (512, 1024, MR.widths(64, 256)[k])
        assert torch.equal(a, b), k
        assert torch.equal(a, p), k
        assert abs(MR.drop_fraction(a) - (1 - MR.KP)) <= 0.01, k


@pytest.mark.parametrize("nb,nc,bt,tc,d,ff", [(3, 1, 5, 7, 4, 12), (2, 3, 3, 5, 12, 4),
                                              (1, 3, 8, 16, 4, 4)])
def test_probe_mask_reversed_kernel_on_ragged_shapes(dev, nb, nc, bt, tc, d, ff):
    """Row 17f's reversed kernel (a block per row block and chunk, the
    chunk index flipped, four channels a thread) at one and three chunks,
    widths 4 and 12 and blocks no power of two: bit for bit the forward
    kernel's masks and the plain ones (``ops/philox.py``)."""
    from datamining_recblr_torch.probes import mask_replay_check as MR

    sizes = dict(nb=nb, nc=nc, bt=bt, tc=tc, d=d, ff=ff)
    before = MR.masks_reversed.launches
    rev = MR.masks_reversed(MR.SEED, MR.KP, device=dev, **sizes)
    assert MR.masks_reversed.launches == before + 1
    fwd = MR.masks_forward(MR.SEED, MR.KP, device=dev, **sizes)
    plain = MR.masks_plain(MR.SEED, MR.KP, device=dev, **sizes)
    for k, (a, b, p) in enumerate(zip(rev, fwd, plain)):
        assert a.shape == (nb * bt, nc * tc, MR.widths(d, ff)[k])
        assert torch.equal(a, b), k
        assert torch.equal(a, p), k


def test_probe_ce_mm_kernel_matches_plain_on_ragged_shapes(dev):
    """Queue B row 17d's wgmma / TMA kernel against ``mm_plain`` at every
    block height, on shapes that are no multiple of its 128 x 128 tiles
    (N 1,001, 37 and 129 rows; V 1,004, 4, 132 and 3,456), within the
    smoke's MXU_TOL (atol = rtol = 1e-5: bf16 products are exact in fp32,
    sums of 64 in another order); one launch a call, and a rerun gives
    the same bits."""
    from datamining_recblr_torch.probes import ce_mxu as CE

    for n, v in ((1001, 1004), (37, 4), (129, 3456), (300, 132)):
        x, table, _, _ = CE.inputs(n, v, dev)
        want = CE.mm_plain(x, table)
        for bn in CE.BNS:
            before = CE.mm.launches
            got = CE.mm(x, table, bn)
            assert CE.mm.launches == before + 1
            assert got.shape == (n, v) and got.is_contiguous()
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
            assert torch.equal(CE.mm(x, table, bn), got), (n, v, bn)
    torch.cuda.synchronize()


@pytest.mark.parametrize("c", [32, 160])
@pytest.mark.parametrize("t", [1, 2, 31, 33, 200, 454, 512])
def test_probe_scan_flat_kernel_matches_plain(dev, t, c):
    """Queue B row 17c's flat scan (a warp per 32 positions in registers)
    against ``scan_flat_plain`` at T below, at and across a warp's 32
    positions, at the probe's 200 and up to 512, with one and five
    32-channel slices, within the smoke's SCAN_RTOL (1e-5 of the largest
    |h|: fmaf against a multiply and an add); one launch a call, and a
    rerun gives the same bits."""
    from datamining_recblr_torch.probes import scan_chunked as SCP

    rng = np.random.default_rng(17 + t + c)
    g = torch.from_numpy(rng.uniform(0.9, 0.999, size=(3, t, c)).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.standard_normal((3, t, c)).astype(np.float32)).to(dev)
    before = SCP.scan_flat.launches
    got = SCP.scan_flat(g, x)
    assert SCP.scan_flat.launches == before + 1
    want = SCP.scan_flat_plain(g, x)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert torch.equal(SCP.scan_flat(g, x), got)
    torch.cuda.synchronize()


@pytest.mark.parametrize("nm,nv", [(1, 12), (16, 48), (16, 5)])
def test_probe_unit_overlap_kernel_matches_plain(dev, nm, nv):
    """Queue B row 17a's wgmma chains against ``run_plain`` in all five
    modes at grid 2 (3,200 rows, 50 warpgroup tiles), nm 1 and 16, with
    more and fewer elementwise steps than products, within FP32_TOL (1e-4:
    3xTF32 products in one fp32 accumulator, a few 1e-6 after 16)."""
    from datamining_recblr_torch.probes import unit_overlap as UO

    x, x2, w, a, b = UO.inputs(2, dev)
    for mode in UO.MODES:
        before = UO.run.launches
        got = UO.run(x, x2, w, a, b, mode, nm, nv, 2)
        assert UO.run.launches == before + 1
        want = UO.run_plain(x, x2, w, a, b, mode, nm, nv)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4, msg=mode)
    torch.cuda.synchronize()
