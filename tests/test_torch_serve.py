"""The port's serving path, interop and checkpoints against the JAX
package, on the CPU (fp32; scores atol 2e-5 / rtol 1e-4)."""

import jax
import numpy as np
import pytest
import torch

from datamining_recblr_tpu.config import Config as JConfig
from datamining_recblr_tpu.eval.metrics import mask_scores as j_mask_scores
from datamining_recblr_tpu.models import get_model as j_get_model
from datamining_recblr_tpu.serve import Recommender as JRecommender
from datamining_recblr_torch.config import Config
from datamining_recblr_torch.interop import params_from_jax, params_to_jax
from datamining_recblr_torch.models import get_model
from datamining_recblr_torch.serve import Recommender
from datamining_recblr_torch.train.checkpoint import restore_checkpoint, save_checkpoint

ATOL, RTOL = 2e-5, 1e-4
N_ITEMS, T, TOP_K = 60, 12, 7
CFG = {"hidden_size": 32, "num_layers": 2, "MAX_ITEM_LIST_LENGTH": T,
       "use_pallas_scan": "always"}


def _jax_side(cfg=CFG, seed=0):
    jmodel = j_get_model("RecBLR")(JConfig(model="RecBLR", config_dict=cfg), N_ITEMS, T)
    return jmodel, jmodel.init_params(jax.random.PRNGKey(seed))


def _port(jparams, cfg=CFG):
    model = get_model("RecBLR")(Config(model="RecBLR", config_dict=cfg), N_ITEMS, T,
                                device="cpu")
    return model, params_from_jax(jax.tree.map(np.asarray, jparams))


def _sequences():
    rng = np.random.default_rng(0)
    return [
        list(rng.integers(1, N_ITEMS, 30)),  # longer than T
        [5],                                 # length 1
        [],                                  # empty history
        list(rng.integers(1, N_ITEMS, 9)),
        [3, 3, 7, 3],                        # repeats
    ]


@pytest.mark.parametrize("exclude_history", [True, False])
@pytest.mark.parametrize("vocab_multiple", [1, 16])
def test_recommend_matches_jax(exclude_history, vocab_multiple):
    cfg = dict(CFG, vocab_multiple=vocab_multiple)
    jmodel, jparams = _jax_side(cfg)
    model, params = _port(jparams, cfg)
    seqs = _sequences()
    jids, jvals = JRecommender(jmodel, jparams, top_k=TOP_K).recommend(seqs, exclude_history)
    ids, vals = Recommender(model, params, top_k=TOP_K).recommend(seqs, exclude_history)
    assert ids.shape == vals.shape == (len(seqs), TOP_K)
    assert ids.dtype == np.int32 and vals.dtype == np.float32
    np.testing.assert_allclose(vals, np.asarray(jvals), atol=ATOL, rtol=RTOL)
    # ids may differ only where the JAX scores tie within tolerance
    b, t = len(seqs), T
    seq = np.zeros((b, t), np.int32)
    lens = np.zeros((b,), np.int32)
    hist = np.zeros((b, jmodel.n_items_padded), bool)
    for i, items in enumerate(seqs):
        w = np.asarray(items, np.int32)[-t:]
        seq[i, : len(w)] = w
        lens[i] = len(w)
        if exclude_history and len(items):
            hist[i, items] = True
    jscores = np.asarray(j_mask_scores(jmodel.full_sort_scores(jparams, seq, lens),
                                       history=hist))
    for i, j in zip(*np.nonzero(ids != np.asarray(jids))):
        np.testing.assert_allclose(jscores[i, ids[i, j]], jvals[i, j], atol=ATOL, rtol=RTOL)
    assert (ids != 0).all() and (ids < N_ITEMS).all()
    if exclude_history:
        for i, items in enumerate(seqs):
            assert not set(ids[i]) & set(items)


def test_interop_round_trips_exactly():
    _, jparams = _jax_side()
    tree = jax.tree.map(np.asarray, jparams)
    back = params_to_jax(params_from_jax(tree))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_checkpoint_round_trip_and_from_checkpoint(tmp_path):
    _, jparams = _jax_side(seed=3)
    model, params = _port(jparams)
    model.load_state_dict(params)
    path = save_checkpoint(str(tmp_path / "ck" / "m"), {"params": model.state_dict(),
                                                        "epoch": 4})
    state = restore_checkpoint(path)
    assert state["epoch"] == 4
    for k, v in model.state_dict().items():
        torch.testing.assert_close(state["params"][k], v, atol=0, rtol=0)
    rec = Recommender.from_checkpoint(path, Config(model="RecBLR", config_dict=CFG),
                                      N_ITEMS, T, top_k=TOP_K, device="cpu")
    seqs = _sequences()
    ids, vals = rec.recommend(seqs)
    ids2, vals2 = Recommender(model, top_k=TOP_K).recommend(seqs)
    np.testing.assert_array_equal(ids, ids2)
    np.testing.assert_array_equal(vals, vals2)
