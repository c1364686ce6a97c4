"""The table-gradient kernel's host-side plan and its summation order, on
the CPU: ``ops/embedding.py``'s ``sort_plan`` (radix passes and digit
width) across V from 1 to 2^20 + 1 and ``scratch_bytes`` (the kernel's one
scratch buffer); and the kernel's order of sums, emulated in numpy
(``emb_grad_schedule.py``: the sorted pieces, the group sums and the row
sums, each compensated in fp32), against the JAX package's
``embedding_lookup`` VJP and an fp64 sum.

Tolerance: 1e-6 of the largest value (compensated fp32 sums of
bf16-representable cotangents against fp32 and fp64 sums in another
order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from emb_grad_schedule import G, P, edge_ids, schedule_sum

from datamining_recblr_tpu.ops import embedding as JE
from datamining_recblr_torch.ops import embedding as E

REL = 1e-6


def test_sort_plan_from_1_to_2_20_plus_1():
    """Every V in [1, 2^20 + 1]: the fewest passes of at most 10 bits that
    cover the keys [0, V] (the bit length of V), the bits shared out
    evenly; two passes up to 2^20 - 1, three from 2^20 on."""
    for v in range(1, 2**20 + 2):
        passes, width = E.sort_plan(v)
        bits = v.bit_length()
        assert 1 <= width <= E.MAX_DIGIT_BITS
        assert passes * width >= bits > (passes - 1) * E.MAX_DIGIT_BITS
        assert (passes * (width - 1) < bits), v  # no narrower width covers them
        assert passes == (1 if v < 2**10 else 2 if v < 2**20 else 3), v


@pytest.mark.parametrize("v,plan", [(1, (1, 1)), (2, (1, 2)), (1023, (1, 10)), (1024, (2, 6)),
                                    (3417, (2, 6)), (329_728, (2, 10)), (2**20 - 1, (2, 10)),
                                    (2**20, (3, 7)), (2**20 + 1, (3, 7))])
def test_sort_plan_at_the_digit_edges(v, plan):
    """The bench catalog (3,417) and XLong's padded one (329,728) take two
    passes; V at and just past each edge of the pass count."""
    assert E.sort_plan(v) == plan


@pytest.mark.parametrize("n,v,d", [(1, 1, 1), (100, 50, 8), (409_600, 3417, 64),
                                   (524_288, 329_728, 64), (5000, 300, 520), (2049, 2**20, 30)])
def test_scratch_bytes_holds_the_kernels_buffers(n, v, d):
    """The scratch holds four [N] int arrays (keys and values twice), per
    pass [radix, tiles] counts and [radix] totals, per tile the ids outside
    [0, V) and their total, two [V] segment bounds, then from a 16-byte
    edge the fp32 partial rows of one slice (at most 512 columns): two a
    piece, two a group."""
    passes, width = E.sort_plan(v)
    tiles, pieces = -(-n // E.SORT_TILE), -(-n // P)
    ints = 4 * n + passes * 2**width * tiles + passes * 2**width + tiles + 1 + 2 * v
    floats = (2 * pieces + 2 * -(-pieces // G)) * min(d, E.MAX_SLICE)
    got = E.scratch_bytes(n, v, d)
    assert got == 4 * (-(-ints // 4) * 4 + floats)
    assert E.scratch_bytes(n, v, d + 1) >= got and E.scratch_bytes(n + 1, v, d) >= got
    assert E.scratch_bytes(n, v + 1, d) >= got
    assert E.scratch_bytes(n, v, max(d, 512) + 8) == E.scratch_bytes(n, v, 512)


def _jax_vjp(ids, g, v):
    table = jnp.zeros((v, g.shape[-1]), jnp.float32)
    _, vjp = jax.vjp(lambda t: JE.embedding_lookup(t, jnp.asarray(ids)), table)
    return np.asarray(vjp(jnp.asarray(g).astype(jnp.bfloat16))[0])


def _bf16(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        torch.bfloat16).float().numpy()


def _assert_close(got, want):
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=0,
                               atol=REL * float(np.abs(want).max()))


@pytest.mark.parametrize("case", ["edges", "pad_half", "one_id", "one_id_at_v_minus_1"])
def test_schedule_matches_the_jax_vjp_and_fp64(case):
    """The kernel's order of sums against the JAX package's table gradient
    (its 9,000-row switch on both sides) and the fp64 sum: segments on and
    just off piece and group edges; PAD at half of 20,000 ids over 9,216
    rows (a segment of ~310 pieces, five groups) with a popular id inside
    one group; every id equal (one segment over all pieces), at id 0 and
    at V - 1."""
    rng = np.random.default_rng(["edges", "pad_half", "one_id", "one_id_at_v_minus_1"]
                                .index(case))
    if case == "edges":
        v = 300
        ids = edge_ids(rng, v)
    elif case == "pad_half":
        v, n = 9216, 20_000
        ids = rng.integers(1, v, n)
        ids[rng.random(n) < 0.5] = 0
        ids[rng.random(n) < 0.05] = 7
    else:
        v = 40
        ids = np.full(6000, 0 if case == "one_id" else v - 1)
    g = _bf16(rng, (ids.size, 8))
    got = schedule_sum(ids, g, v)
    exact = np.zeros((v, 8))
    np.add.at(exact, ids, g.astype(np.float64))
    _assert_close(got, exact)
    _assert_close(got, _jax_vjp(ids.astype(np.int32), g, v))


def test_schedule_leaves_out_ids_outside_the_table():
    """Ids below 0 or at and above V add nothing and write no row; the
    rows the valid ids leave out are zero."""
    rng = np.random.default_rng(9)
    v, n = 500, 12_000
    ids = rng.integers(-3, v + 3, n)
    ids[rng.random(n) < 0.4] = 0
    ids[rng.random(n) < 0.2] = v
    g = _bf16(rng, (n, 4))
    got = schedule_sum(ids, g, v)
    ok = (ids >= 0) & (ids < v)
    exact = np.zeros((v, 4))
    np.add.at(exact, ids[ok], g[ok].astype(np.float64))
    _assert_close(got, exact)
    assert not got[np.bincount(ids[ok], minlength=v) == 0].any()
