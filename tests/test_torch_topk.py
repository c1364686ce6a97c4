"""``ops/topk.py:topk_scores`` and ``Recommender.recommend`` against the
JAX package on tied scores, on the CPU: the ids must be equal exactly
(``jax.lax.top_k`` puts the lower index first among equal values and
orders floats totally, +0 above -0)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datamining_recblr_tpu.ops.topk import topk_scores as j_topk_scores
from datamining_recblr_tpu.serve import Recommender as JRecommender
from datamining_recblr_torch.ops.topk import topk_scores
from datamining_recblr_torch.serve import Recommender

from test_torch_serve import CFG, _jax_side, _port


def _every_seventh():
    s = np.zeros((2, 3417), np.float32)
    s[:, ::7] = 1.0
    s[1] = s[1, ::-1]  # the ties end the row
    return s


def _signed_zeros_and_nan():
    s = np.array([[0.0, -0.0, 1.0, -0.0, 0.0, np.nan, -np.inf, -np.inf, 2.0, -0.0]],
                 np.float32)
    return s


def _random_with_ties():
    rng = np.random.default_rng(3)
    return rng.integers(-3, 4, (5, 301)).astype(np.float32)  # every value repeats


@pytest.mark.parametrize("make,k", [(_every_seventh, 10), (_signed_zeros_and_nan, 10),
                                    (_random_with_ties, 17), (_random_with_ties, 301)])
def test_topk_ids_equal_jax_on_ties(make, k):
    s = make()
    jvals, jids = j_topk_scores(jnp.asarray(s), k)
    vals, ids = topk_scores(torch.from_numpy(s), k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    if make is _every_seventh:
        np.testing.assert_array_equal(ids[0].numpy(), np.arange(0, 70, 7))


def test_recommend_ids_equal_jax_with_slots_left_at_minus_inf():
    """60 items, history 1..55: four items are left, so three of the seven
    slots hold -inf and go to the lowest ids, as in JAX."""
    jmodel, jparams = _jax_side(CFG)
    model, params = _port(jparams, CFG)
    seqs = [list(range(1, 56))]
    jids, jvals = JRecommender(jmodel, jparams, top_k=7).recommend(seqs)
    ids, vals = Recommender(model, params, top_k=7).recommend(seqs)
    np.testing.assert_array_equal(ids, np.asarray(jids))
    assert np.isneginf(vals[0, 4:]).all()
    np.testing.assert_array_equal(ids[0, 4:], [0, 1, 2])


def test_recommend_ids_equal_jax_with_a_duplicated_item_row():
    """Item 40's embedding row copied to item 9: the two score the same
    for every user and come out next to each other, 9 first."""
    jmodel, jparams = _jax_side(CFG, seed=5)
    table = np.asarray(jparams["item_embedding"]).copy()
    table[9] = table[40]
    jparams = dict(jparams, item_embedding=jnp.asarray(table))
    model, params = _port(jparams, CFG)
    seqs = [[3, 7, 12], [40, 9, 5, 2], [11]]
    jrec = JRecommender(jmodel, jparams, top_k=59)
    jids, _ = jrec.recommend(seqs, exclude_history=False)
    ids, _ = Recommender(model, params, top_k=59).recommend(seqs, exclude_history=False)
    np.testing.assert_array_equal(ids, np.asarray(jids))
    for row in ids:
        i9, i40 = list(row).index(9), list(row).index(40)
        assert i40 == i9 + 1
