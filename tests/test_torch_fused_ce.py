"""The port's whole-table softmax cross-entropy (``ops/fused_ce.py``)
against the JAX package's ``fused_softmax_ce``, whose Pallas kernels run
in interpret mode on the CPU: nll, dx, dtable and dbias, with a bias and
masked vocab columns, in fp32 and with bf16 products.

Tolerances: nll atol 1e-5 (values up to ~13; fp32 sums in another
order); every gradient within 1e-5 of its largest value in fp32 and 4e-5
with ``mm_bf16``, where both sides round the same operands to bf16 and
sum in fp32, and a g near a bf16 rounding boundary may round the other
way in dx."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datamining_recblr_tpu.ops import fused_ce as JCE
from datamining_recblr_torch.ops import fused_ce as FCE


def _case(seed, n=37, v=53, d=24, x_scale=1.0):
    rng = np.random.default_rng(seed)
    x = (x_scale * rng.standard_normal((n, d))).astype(np.float32)
    table = (0.5 * rng.standard_normal((v, d))).astype(np.float32)
    bias = rng.standard_normal(v).astype(np.float32)
    dnll = rng.uniform(0.0, 1.0, n).astype(np.float32)
    return rng, x, table, bias, dnll


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("mm_bf16", [False, True])
@pytest.mark.parametrize("with_bias,valid", [(False, None), (True, None), (True, 45)],
                         ids=["plain", "bias", "bias_masked"])
def test_ce_matches_jax(with_bias, valid, mm_bf16):
    rng, x, table, bias, dnll = _case(3 + 2 * mm_bf16 + (valid or 0))
    v = table.shape[0]
    tgt = rng.integers(0, valid or v, x.shape[0]).astype(np.int32)

    def jloss(a, t, b):
        nll = JCE.fused_softmax_ce(a, t, jnp.asarray(tgt), bias=b if with_bias else None,
                                   valid_v=valid,
                                   mm_bf16=mm_bf16)
        return jnp.sum(nll * dnll), nll

    (_, want), grads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(table), jnp.asarray(bias))
    tx, tt, tb = (torch.from_numpy(a).requires_grad_() for a in (x, table, bias))
    got = FCE.fused_softmax_ce(tx, tt, torch.from_numpy(tgt).long(),
                               bias=tb if with_bias else None, valid_v=valid, mm_bf16=mm_bf16)
    assert got.dtype == torch.float32 and got.shape == (x.shape[0],)
    (got * torch.from_numpy(dnll)).sum().backward()
    tol = 4e-5 if mm_bf16 else 1e-5
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    _close(tx.grad, grads[0], tol)
    _close(tt.grad, grads[1], tol)
    if with_bias:
        _close(tb.grad, grads[2], tol)
    else:
        assert tb.grad is None


def test_ce_bf16_input_and_the_rounding_of_each_product():
    """A bf16 x gives a bf16 dx.  With mm_bf16 the logits and dx round
    their operands (dx: g and the table) and dtable does not round g or
    x: the plain backward rounds exactly there."""
    rng, x, table, bias, dnll = _case(11, x_scale=3.0)
    tgt = torch.from_numpy(rng.integers(0, table.shape[0], x.shape[0]))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    dx, dtab, dbias = FCE.fused_softmax_ce_bwd_plain(xb, torch.from_numpy(table), tgt,
                                                     torch.from_numpy(dnll),
                                                     torch.from_numpy(bias), mm_bf16=True)
    assert dx.dtype == torch.bfloat16 and dtab.dtype == dbias.dtype == torch.float32
    xf = torch.from_numpy(x)
    rb = lambda a: a.to(torch.bfloat16).float()  # noqa: E731
    logits = rb(xf) @ rb(torch.from_numpy(table)).t() + torch.from_numpy(bias)
    g = (torch.softmax(logits, -1) - torch.nn.functional.one_hot(tgt, table.shape[0]).float()) \
        * torch.from_numpy(dnll)[:, None]
    _, dtab32, _ = FCE.fused_softmax_ce_bwd_plain(xf, torch.from_numpy(table), tgt,
                                                   torch.from_numpy(dnll),
                                                   torch.from_numpy(bias), mm_bf16=True)
    torch.testing.assert_close(dtab32, g.t() @ xf, atol=1e-5, rtol=1e-5)
    dx32, _, _ = FCE.fused_softmax_ce_bwd_plain(xf, torch.from_numpy(table), tgt,
                                                torch.from_numpy(dnll), torch.from_numpy(bias),
                                                mm_bf16=True)
    torch.testing.assert_close(dx32, rb(g) @ rb(torch.from_numpy(table)), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", [(3417, 64), (131072, 64), (131073, 64), (1000, 512),
                                   (1000, 513)])
def test_supports_and_min_rows_match_jax(shape):
    assert FCE.supports(*shape) == JCE.supports(*shape)
    assert FCE.MIN_ROWS == JCE.MIN_ROWS == 8192


def test_cpu_calls_do_not_count_launches_and_other_devices_raise():
    _, x, table, bias, _ = _case(13)
    tgt = torch.zeros(x.shape[0], dtype=torch.long)
    before = (FCE.fused_softmax_ce.launches, FCE.fused_softmax_ce_bwd.launches)
    tx = torch.from_numpy(x).requires_grad_()
    FCE.fused_softmax_ce(tx, torch.from_numpy(table), tgt).sum().backward()
    assert (FCE.fused_softmax_ce.launches, FCE.fused_softmax_ce_bwd.launches) == before == (0, 0)
    with pytest.raises(ValueError, match="no kernel"):
        FCE.fused_softmax_ce(torch.zeros((4, 24), device="meta"), torch.from_numpy(table),
                             tgt[:4])


# ---------------------------------------------------------------------------
# the vocab-chunked path (queue B row 14) and tables of any float type
# ---------------------------------------------------------------------------

def test_chunked_gate_matches_jax():
    for shape in [(329_728, 64), (3417, 64), (1000, 512), (1000, 513)]:
        assert FCE.supports_chunked(*shape) == JCE.supports_chunked(*shape)
    assert FCE.CHUNK_MIN_LOGITS_BYTES == JCE.CHUNK_MIN_LOGITS_BYTES == 64 * 1024 * 1024


@pytest.mark.parametrize("mm_bf16", [False, True])
@pytest.mark.parametrize("n", [24, 600], ids=["one_row_block", "two_row_blocks"])
def test_chunked_ce_matches_jax(n, mm_bf16):
    """The chunked plain forward's nll and lse against ``_cce_fwd``, its
    plain backward's dx, dtable and dbias against ``_cce_bwd`` (one row
    block at N 24, the two-kernel backward at N 600 > ``_BN_CAP``), and
    ``fused_softmax_ce_chunked``'s autograd against ``jax.grad`` of
    ``fused_softmax_ce(vocab_block=16)``: V 37 (a padded tail in 16-wide
    chunks), valid_v 33, a bias, the target logits at x unrounded."""
    v, valid = 37, 33
    rng, x, table, bias, dnll = _case(41 + n + mm_bf16, n=n, v=v)
    tgt = rng.integers(0, valid, n).astype(np.int32)
    jx, jt, jb, jtg = (jnp.asarray(a) for a in (x, table, bias, tgt))
    wnll, wlse = JCE._cce_fwd(jx, jt, jb, jtg, valid, mm_bf16, 16)
    wdx, wdt, wdb = JCE._cce_bwd(jx, jt, jb, jtg, wlse, jnp.asarray(dnll), valid, mm_bf16, 16)
    tx, tt, tb = (torch.from_numpy(a) for a in (x, table, bias))
    ttg = torch.from_numpy(tgt).long()
    nll, lse = FCE.fused_softmax_ce_chunked_fwd_plain(tx, tt, ttg, tb, valid, mm_bf16)
    np.testing.assert_allclose(nll.numpy(), np.asarray(wnll), rtol=0, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(wlse), rtol=0, atol=1e-5)
    dx, dt, db = FCE.fused_softmax_ce_chunked_bwd_plain(tx, tt, ttg, torch.from_numpy(dnll), tb,
                                                        valid, mm_bf16, lse=lse)
    tol = 4e-5 if mm_bf16 else 1e-5
    _close(dx, wdx, tol)
    _close(dt, wdt, tol)
    _close(db, wdb, tol)

    def jloss(a, t, b):
        out = JCE.fused_softmax_ce(a, t, jtg, bias=b, valid_v=valid, mm_bf16=mm_bf16,
                                   vocab_block=16)
        return jnp.sum(out * dnll)

    grads = jax.grad(jloss, argnums=(0, 1, 2))(jx, jt, jb)
    ax, at, ab = (torch.from_numpy(a).requires_grad_() for a in (x, table, bias))
    got = FCE.fused_softmax_ce_chunked(ax, at, ttg, bias=ab, valid_v=valid, mm_bf16=mm_bf16)
    (got * torch.from_numpy(dnll)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(wnll), rtol=0, atol=1e-5)
    for mine, want in zip((ax.grad, at.grad, ab.grad), grads):
        _close(mine, want, tol)


@pytest.mark.parametrize("chunked", [False, True], ids=["whole_table", "chunked"])
def test_bf16_table_and_bias(chunked):
    """A bf16 table and bias on both paths: upcast inside, nll as JAX's, and
    the table and bias gradients returned in bf16, within one bf16 ulp of
    JAX's (both round the same fp32 sum once, up to its order)."""
    rng, x, table, bias, dnll = _case(53, n=24, v=37)
    tgt = rng.integers(0, 37, 24).astype(np.int32)
    tab16 = torch.from_numpy(table).to(torch.bfloat16)
    bias16 = torch.from_numpy(bias).to(torch.bfloat16)
    jt = jnp.asarray(tab16.float().numpy()).astype(jnp.bfloat16)
    jb = jnp.asarray(bias16.float().numpy()).astype(jnp.bfloat16)

    def jloss(t, b):
        nll = JCE.fused_softmax_ce(jnp.asarray(x), t, jnp.asarray(tgt), bias=b,
                                   vocab_block=16 if chunked else None)
        return jnp.sum(nll * dnll), nll

    (_, want), (wdt, wdb) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(jt, jb)
    assert wdt.dtype == wdb.dtype == jnp.bfloat16
    at, ab = tab16.clone().requires_grad_(), bias16.clone().requires_grad_()
    ce = FCE.fused_softmax_ce_chunked if chunked else FCE.fused_softmax_ce
    got = ce(torch.from_numpy(x), at, torch.from_numpy(tgt).long(), bias=ab)
    (got * torch.from_numpy(dnll)).sum().backward()
    assert at.grad.dtype == ab.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    for mine, w in ((at.grad, wdt), (ab.grad, wdb)):
        w32 = np.asarray(w.astype(jnp.float32))
        err = np.abs(mine.float().numpy() - w32)
        assert (err <= 2.0 ** -8 * np.abs(w32) + 1e-6).all()


def _tf32(a):
    """fp32 rounded to TF32 (10 mantissa bits, nearest, ties away from
    zero): the low 13 bits cleared after adding half of their range, as
    ``cvt.rna.tf32.f32``."""
    bits = np.asarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def test_tf32_split_of_g_keeps_the_chunked_dtable():
    """The tensor-core backward's dtable (``csrc/fused_ce_chunked.cu`` pass
    (b)) takes g = hi + lo, hi = tf32(g), lo = tf32(g - hi), against a bf16
    x, which TF32 holds exactly: hi^T x + lo^T x (fp32 sums) lands within
    1e-6 of the largest value of the fp32 g^T x of the chunked plain
    version, while hi^T x alone (g rounded once) does not."""
    _, x, table, bias, dnll = _case(81, n=300, v=97, d=24)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    t = torch.from_numpy(table)
    b = torch.from_numpy(bias)
    lse = FCE.fused_softmax_ce_chunked_fwd_plain(xb, t, torch.zeros(300, dtype=torch.long), b,
                                                 90, True)[1]
    g = (FCE.fastmath.exp(FCE._chunked_logits(xb, t, b, 90, True) - lse[:, None])
         * torch.from_numpy(dnll)[:, None]).numpy()
    xf = xb.float().numpy()
    assert np.array_equal(_tf32(xf), xf)
    hi = _tf32(g)
    lo = _tf32(g - hi)
    assert np.array_equal(_tf32(lo), lo) and np.abs(g - hi - lo).max() <= 2.0 ** -22 * np.abs(g).max()
    want = g.T.astype(np.float64) @ xf.astype(np.float64)
    ref = g.T @ xf  # the plain version's fp32 product
    got = hi.T @ xf + lo.T @ xf
    scale = float(np.abs(want).max())
    assert float(np.abs(ref - want).max()) <= 1e-6 * scale
    assert float(np.abs(got - ref).max()) <= 1e-6 * scale
    assert float(np.abs(hi.T @ xf - ref).max()) > 1e-6 * scale


@pytest.mark.parametrize("d,mm_bf16,mma", [(64, True, True), (128, True, True),
                                           (129, True, False), (200, True, False),
                                           (64, False, False), (16, False, False)])
def test_chunked_bwd_takes_the_tensor_cores_with_bf16_products_up_to_d_128(d, mm_bf16, mma):
    assert FCE.chunked_bwd_uses_mma(d, mm_bf16) == mma


# ---------------------------------------------------------------------------
# the whole-table backward on the tensor cores (queue B row 13)
# ---------------------------------------------------------------------------

def _split(a):
    """The two-term TF32 split of ``csrc/mma_tile.cuh`` ``tf32_split``."""
    hi = _tf32(a)
    return hi, _tf32(np.asarray(a, np.float32) - hi)


def _3xtf32(a, b):
    """a @ b as the 3xTF32 backward computes it: hi hi + hi lo + lo hi,
    each product of TF32 values exact in fp32, fp32 sums."""
    ah, al = _split(a)
    bh, bl = _split(b)
    return al @ bh + ah @ bl + ah @ bh


@pytest.mark.parametrize("product", ["logits", "dx", "dtable"])
def test_3xtf32_keeps_the_whole_table_products_at_fp32(product):
    """The fp32 backward's products on the tensor cores (``csrc/fused_ce.cu``
    without mm_bf16): the logits x table^T, dx = g table and dtable = g^T x
    with g = (softmax - onehot) dnll of the whole-table plain version, each
    operand split in two TF32 terms.  hi hi + hi lo + lo hi lands within
    1e-6 of the largest value of the plain fp32 product, one TF32 product
    (hi hi) does not."""
    rng, x, table, bias, dnll = _case(91, n=300, v=97, d=24, x_scale=2.0)
    tgt = rng.integers(0, 90, 300)
    tx, tt, tb = (torch.from_numpy(a) for a in (x, table, bias))
    logits = FCE._logits(tx, tt, tb, 90, False)
    e = FCE.fastmath.exp(logits - logits.amax(-1, keepdim=True))
    g = ((e / e.sum(-1, keepdim=True) - FCE._onehot(torch.from_numpy(tgt), 97).float())
         * torch.from_numpy(dnll)[:, None]).numpy()
    a, b = {"logits": (x, table.T), "dx": (g, table), "dtable": (g.T, x)}[product]
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    ref = a @ b  # the plain version's fp32 product
    want = a.astype(np.float64) @ b.astype(np.float64)
    scale = float(np.abs(want).max())
    assert float(np.abs(ref - want).max()) <= 1e-6 * scale
    assert float(np.abs(_3xtf32(a, b) - ref).max()) <= 1e-6 * scale
    assert float(np.abs(_tf32(a) @ _tf32(b) - ref).max()) > 1e-6 * scale


def test_bf16_dx_rounds_g_with_its_one_hot_term():
    """With mm_bf16 the whole-table dx is round(g) round(table) with the
    one-hot term inside g before the rounding (JAX ``_ce_bwd``'s
    ``_make_mm``), unlike the chunked path, which subtracts dnll table[t]
    unrounded.  The plain backward, which the card's kernel is held to,
    agrees with ``_ce_bwd`` in dx, dtable and dbias, and the chunked
    rounding point lands measurably away from it."""
    rng, x, table, bias, dnll = _case(97, n=64, v=53, d=24, x_scale=2.0)
    tgt = rng.integers(0, 53, 64).astype(np.int32)
    dnll = (1.0 + dnll).astype(np.float32)
    wdx, wdt, wdb = JCE._ce_bwd(jnp.asarray(x), jnp.asarray(table), jnp.asarray(bias),
                                jnp.asarray(tgt), jnp.asarray(dnll), 53, True)
    tx, tt, tb = (torch.from_numpy(a) for a in (x, table, bias))
    ttg, tdn = torch.from_numpy(tgt).long(), torch.from_numpy(dnll)
    dx, dt, db = FCE.fused_softmax_ce_bwd_plain(tx, tt, ttg, tdn, tb, mm_bf16=True)
    _close(dx, wdx, 4e-5)
    _close(dt, wdt, 1e-5)
    _close(db, wdb, 1e-5)
    logits = FCE._logits(tx, tt, tb, 53, True)
    p = torch.softmax(logits, -1)
    rt = FCE._round(tt, True)
    onehot = FCE._onehot(ttg, 53).float()
    g = (p - onehot) * tdn[:, None]
    torch.testing.assert_close(dx, FCE._round(g, True) @ rt, atol=1e-5, rtol=0)
    chunked = FCE._round(p * tdn[:, None], True) @ rt - tdn[:, None] * rt[ttg]
    scale = float(np.abs(np.asarray(wdx)).max())
    assert float(np.abs(chunked.numpy() - np.asarray(wdx)).max()) > 1e-3 * scale


@pytest.mark.parametrize("mm_bf16", [False, True])
@pytest.mark.parametrize("d", [16, 64, 128, 200, 256, 257, 512])
def test_whole_table_bwd_takes_the_tensor_cores_up_to_d_256(d, mm_bf16):
    assert FCE.bwd_uses_mma(d, mm_bf16) == (d <= 256)


# ---------------------------------------------------------------------------
# the forwards on the tensor cores (rows 13 and 14)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mm_bf16", [False, True])
@pytest.mark.parametrize("d", [64, 128, 129, 256, 257])
def test_forward_gates(d, mm_bf16):
    """Row 14's forward takes the tensor cores at D <= 128 in both
    precisions; row 13's without ``mm_bf16`` where its backward does, at D
    <= 256, and with ``mm_bf16`` none (the FMA kernel keeps the lse that
    its bf16 backward's rounding of g needs)."""
    assert FCE.chunked_fwd_uses_mma(d, mm_bf16) == (d <= 128)
    assert FCE.fwd_uses_mma(d, mm_bf16) == (not mm_bf16 and d <= 256)
    assert FCE.fwd_uses_mma(d, False) == FCE.bwd_uses_mma(d, False)


class _FakeLib:
    """Stands in for a kernel library: records the forward's arguments."""

    def __init__(self):
        self.calls = []

    def recblr_ce_fwd(self, *args):
        self.calls.append(args)
        return 0

    recblr_cce_fwd = recblr_ce_fwd


@pytest.mark.parametrize("mm_bf16", [False, True])
@pytest.mark.parametrize("d", [64, 128, 129, 256, 257])
@pytest.mark.parametrize("chunked", [False, True], ids=["whole_table", "chunked"])
def test_forward_counts_mma_launches_where_its_gate_says(monkeypatch, chunked, d, mm_bf16):
    """Each forward's wrapper counts a launch on the tensor cores exactly
    where its gate sends it there (the C side dispatches on the same fact),
    and hands the kernel a 16-byte aligned table there (a copy of one that
    is not); the library is a stand-in that launches nothing."""
    import contextlib

    from datamining_recblr_torch.ops import _cuda

    lib = _FakeLib()
    monkeypatch.setattr(_cuda, "library", lambda name: lib)
    monkeypatch.setattr(_cuda, "stream", lambda x: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(FCE, "_vocab_splits", lambda n, v, d, dev: 2)
    train = FCE.fused_softmax_ce_chunked_train if chunked else FCE.fused_softmax_ce_train
    counted = FCE.fused_softmax_ce_chunked if chunked else FCE.fused_softmax_ce
    monkeypatch.setattr(train, "mma_launches", 0)
    monkeypatch.setattr(counted, "launches", 0)
    x = torch.zeros((5, d))
    table = torch.zeros((9 * d + 1,))[1:].view(9, d)  # 4 bytes past an aligned start
    launch = FCE._launch_cfwd if chunked else FCE._launch_fwd
    launch(x, table, torch.zeros(9), torch.zeros(5, dtype=torch.int32), 9, mm_bf16, True)
    mma = FCE.chunked_fwd_uses_mma(d, mm_bf16) if chunked else FCE.fwd_uses_mma(d, mm_bf16)
    assert (counted.launches, train.mma_launches) == (1, int(mma))
    table_ptr = lib.calls[0][1]
    assert (table_ptr % 16 == 0) == mma


def test_cpu_calls_count_no_mma_launches():
    """On the CPU both CE paths run their plain versions, forward and
    backward: no wrapper counts a launch on the tensor cores, and the two
    training forwards, which only launch kernels, raise."""
    _, x, table, bias, dnll = _case(17)
    tgt = torch.zeros(x.shape[0], dtype=torch.long)
    counters = (FCE.fused_softmax_ce_train, FCE.fused_softmax_ce_chunked_train,
                FCE.fused_softmax_ce_bwd, FCE.fused_softmax_ce_chunked_bwd)
    before = [f.mma_launches for f in counters]
    for ce in (FCE.fused_softmax_ce, FCE.fused_softmax_ce_chunked):
        tx = torch.from_numpy(x).requires_grad_()
        (ce(tx, torch.from_numpy(table), tgt, torch.from_numpy(bias))
         * torch.from_numpy(dnll)).sum().backward()
        assert tx.grad is not None
    for train in (FCE.fused_softmax_ce_train, FCE.fused_softmax_ce_chunked_train):
        with pytest.raises(ValueError, match="no kernel"):
            train(torch.from_numpy(x), torch.from_numpy(table), tgt)
    assert [f.mma_launches for f in counters] == before
