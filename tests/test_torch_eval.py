"""The port's ranking metrics and evaluator (full sort, and the sampled
uniN / popN modes with the JAX package's negatives) against the JAX
package's on the CPU.  Ranks are exact (ties: the smaller item index
first); metric values from the same parameters agree within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datamining_recblr_tpu.config import Config as JConfig
from datamining_recblr_tpu.data.dataset import build_from_dataframe as j_build
from datamining_recblr_tpu.data.synthetic import (
    generate_synthetic_interactions as j_generate,
)
from datamining_recblr_tpu.eval import metrics as jmetrics
from datamining_recblr_tpu.eval.evaluator import Evaluator as JEvaluator
from datamining_recblr_tpu.eval.evaluator import history_fn_from_data as j_history_fn
from datamining_recblr_tpu.models import get_model as j_get_model
from datamining_recblr_torch.config import Config
from datamining_recblr_torch.data.dataset import build_from_dataframe
from datamining_recblr_torch.data.synthetic import generate_synthetic_interactions
from datamining_recblr_torch.eval import metrics
from datamining_recblr_torch.eval.evaluator import (
    Evaluator,
    format_result,
    history_fn_from_data,
)
from datamining_recblr_torch.interop import params_from_jax
from datamining_recblr_torch.models import get_model

METRICS = ["Hit", "NDCG", "MRR", "Recall", "Precision", "MAP"]


def test_target_ranks_break_ties_by_index():
    scores = torch.tensor([[0.5, 0.9, 0.5, 0.5, 0.1],
                           [1.0, 1.0, 1.0, 1.0, 1.0],
                           [0.0, -1.0, 2.0, 2.0, float("-inf")]])
    targets = torch.tensor([3, 2, 4])
    got = metrics.target_ranks(scores, targets)
    assert got.tolist() == [4, 3, 5]
    want = jmetrics.target_ranks(jnp.asarray(scores.numpy()), jnp.asarray(targets.numpy()))
    assert got.tolist() == np.asarray(want).tolist()


def test_rank_metrics_match_jax():
    rng = np.random.default_rng(0)
    scores = rng.integers(0, 6, (40, 25)).astype(np.float32)  # many ties
    targets = rng.integers(1, 25, 40)
    weight = (rng.random(40) > 0.2).astype(np.float32)
    ranks = metrics.target_ranks(torch.from_numpy(scores), torch.from_numpy(targets))
    jranks = jmetrics.target_ranks(jnp.asarray(scores), jnp.asarray(targets))
    np.testing.assert_array_equal(ranks.numpy(), np.asarray(jranks))
    got = metrics.rank_metrics(ranks, METRICS, [1, 5, 10], torch.from_numpy(weight))
    want = jmetrics.rank_metrics(jranks, METRICS, [1, 5, 10], jnp.asarray(weight))
    assert set(got) == set(want)
    for k, (s, w) in want.items():
        np.testing.assert_allclose(float(got[k][0]), float(s), rtol=1e-6)
        assert float(got[k][1]) == float(w)


@pytest.mark.parametrize("impl", ["always", "never"])
@pytest.mark.parametrize("mask_history", [False, True])
def test_full_sort_evaluator_matches_jax(impl, mask_history):
    gen = dict(n_users=50, n_items=35, min_len=4, max_len=14, seed=8)
    jdata = j_build(j_generate(**gen), max_seq_len=10)
    data = build_from_dataframe(generate_synthetic_interactions(**gen), max_seq_len=10)
    cfg = {"hidden_size": 16, "num_layers": 2, "MAX_ITEM_LIST_LENGTH": 10,
           "use_pallas_scan": impl, "eval_batch_size": 16, "metrics": METRICS,
           "topk": [5, 10]}
    jmodel = j_get_model("RecBLR")(JConfig(model="RecBLR", config_dict=cfg),
                                   jdata.n_items, 10)
    jparams = jmodel.init_params(jax.random.PRNGKey(2))
    want = JEvaluator(jmodel, JConfig(model="RecBLR", config_dict=cfg)).evaluate(
        jparams, jdata.test, j_history_fn(jdata) if mask_history else None)
    model = get_model("RecBLR")(Config(model="RecBLR", config_dict=cfg), data.n_items, 10,
                                device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))
    got = Evaluator(model, Config(model="RecBLR", config_dict=cfg)).evaluate(
        data.test, history_fn_from_data(data) if mask_history else None)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5, k
    assert format_result(got).startswith("hit@10: ")


@pytest.mark.parametrize("mode", ["uni100", "pop100"])
@pytest.mark.parametrize("name", ["RecBLR", "BERT4Rec"])
def test_sampled_evaluation_is_not_ported(name, mode):
    """Once not ported, now held to the JAX package: the ``uniN`` and
    ``popN`` modes draw the JAX evaluator's negatives (``default_rng(seed)``
    per call, 4 collision rounds, the target at index 0, popularity from
    the training split), so the metrics agree within 1e-5 for RecBLR and
    for BERT4Rec with its output bias; an unknown mode still raises."""
    gen = dict(n_users=60, n_items=150, min_len=4, max_len=14, seed=8)
    jdata = j_build(j_generate(**gen), max_seq_len=10)
    data = build_from_dataframe(generate_synthetic_interactions(**gen), max_seq_len=10)
    cfg = {"hidden_size": 16, "num_layers": 2, "n_layers": 2, "n_heads": 2, "inner_size": 32,
           "MAX_ITEM_LIST_LENGTH": 10, "eval_batch_size": 16, "metrics": METRICS,
           "topk": [5, 10], "eval_args": {"mode": mode}, "seed": 11}
    jmodel = j_get_model(name)(JConfig(model=name, config_dict=cfg), jdata.n_items, 10)
    jparams = jmodel.init_params(jax.random.PRNGKey(2))
    rng = np.random.default_rng(3)  # weights away from the init, so that ranks spread
    jparams = jax.tree.map(
        lambda a: a + (0.3 * rng.standard_normal(a.shape)).astype(np.float32), jparams)
    jev = JEvaluator(jmodel, JConfig(model=name, config_dict=cfg))
    model = get_model(name)(Config(model=name, config_dict=cfg), data.n_items, 10,
                            device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))
    ev = Evaluator(model, Config(model=name, config_dict=cfg))
    assert (ev.n_negatives, ev.pop_sampling) == (jev.n_negatives, jev.pop_sampling)
    if mode.startswith("pop"):
        jev.set_item_popularity(jdata.item_popularity())
        ev.set_item_popularity(data.item_popularity())
        np.testing.assert_array_equal(ev.pop_probs, jev._pop_probs)
    want = jev.evaluate(jparams, jdata.test)
    got = ev.evaluate(data.test)
    assert list(got) == sorted(want) and 0 < got["hit@10"] < 1
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5, k
    assert ev.evaluate(data.test) == got  # each call draws anew from the seed
    with pytest.raises(ValueError, match="unsupported eval mode"):
        Evaluator(model, Config(model=name, config_dict=dict(cfg, eval_args={"mode": "x5"})))
