"""SASRec and BERT4Rec serving in the port against the JAX package, on
the CPU, in both compositions.

The fused composition (the port's default) is held against the JAX
models with ``layers._use_fused_attention`` forced on (the Pallas
kernels in interpret mode), the unfused one (``FORCE_FUSED_ATTENTION =
False``) against the JAX models' XLA composition.  Tolerances (fp32):
seq_output atol 5e-5, scores atol 1e-4, recommended scores atol 1e-4
with ids equal except near-ties."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datamining_recblr_tpu.config import Config as JConfig
from datamining_recblr_tpu.models import get_model as j_get_model
from datamining_recblr_tpu.models import layers as JL
from datamining_recblr_tpu.serve import Recommender as JRecommender
from datamining_recblr_torch.config import Config
from datamining_recblr_torch.interop import params_from_jax, params_to_jax
from datamining_recblr_torch.models import get_model
from datamining_recblr_torch.models import layers as L
from datamining_recblr_torch.serve import Recommender

N_ITEMS, T, TOP_K = 50, 12, 7
CFG = {"MAX_ITEM_LIST_LENGTH": T, "hidden_size": 16, "inner_size": 32, "n_layers": 2,
       "n_heads": 2}
MODELS = ["SASRec", "BERT4Rec"]


@pytest.fixture(params=[True, False], ids=["fused", "unfused"])
def dispatch(request, monkeypatch):
    """Both packages on the same composition."""
    monkeypatch.setattr(JL, "_use_fused_attention", lambda: request.param)
    monkeypatch.setattr(L, "FORCE_FUSED_ATTENTION", request.param)
    return request.param


def _jax_side(name, cfg=CFG, seed=0):
    jmodel = j_get_model(name)(JConfig(model=name, config_dict=cfg), N_ITEMS, T)
    params = jmodel.init_params(jax.random.PRNGKey(seed))
    # weights well away from the N(0, 0.02) init, so that attention and
    # the FFN move the output by more than the tolerance
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: a + (0.15 * rng.standard_normal(a.shape)).astype(np.float32), params)
    return jmodel, params


def _port(name, jparams, cfg=CFG):
    model = get_model(name)(Config(model=name, config_dict=cfg), N_ITEMS, T, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))
    return model


def _batch(seed=3):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, T + 1, 6).astype(np.int32)
    lens[:3] = [0, 1, T]
    seq = rng.integers(1, N_ITEMS, (6, T)).astype(np.int32)
    return np.where(np.arange(T)[None] < lens[:, None], seq, 0), lens


@pytest.mark.parametrize("name", MODELS)
def test_forward_and_scores_match_jax(name, dispatch):
    jmodel, jparams = _jax_side(name)
    model = _port(name, jparams)
    seq, lens = _batch()
    tseq, tlens = torch.from_numpy(seq).long(), torch.from_numpy(lens)
    with torch.no_grad():
        out = model(tseq, tlens)
        scores = model.full_sort_scores(tseq, tlens)
    want = np.asarray(jmodel.forward(jparams, jnp.asarray(seq), jnp.asarray(lens)))
    want_scores = np.asarray(jmodel.full_sort_scores(jparams, jnp.asarray(seq),
                                                     jnp.asarray(lens)))
    assert out.shape == (6, 16) and scores.shape == want_scores.shape
    np.testing.assert_allclose(out.numpy(), want, atol=5e-5, rtol=0)
    np.testing.assert_allclose(scores.numpy(), want_scores, atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", MODELS)
def test_empty_history_follows_each_composition(name, dispatch):
    """lens 0 (an empty history; for BERT4Rec the mask token shifted out):
    the fused top layer selects no position, the unfused path gathers
    position 0.  The two compositions differ there, as in the JAX package."""
    jmodel, jparams = _jax_side(name, seed=5)
    model = _port(name, jparams)
    seq = np.zeros((2, T), np.int32)
    lens = np.zeros(2, np.int32)
    with torch.no_grad():
        out = model(torch.from_numpy(seq).long(), torch.from_numpy(lens))
    want = np.asarray(jmodel.forward(jparams, jnp.asarray(seq), jnp.asarray(lens)))
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), want, atol=5e-5, rtol=0)


def _sequences():
    rng = np.random.default_rng(0)
    return [
        list(rng.integers(1, N_ITEMS, 30)),  # longer than T
        [5],                                 # one item
        [],                                  # empty history (lens 0)
        list(rng.integers(1, N_ITEMS, 9)),
        list(rng.integers(1, N_ITEMS, T)),   # exactly T
        [3, 3, 7, 3],                        # repeats
    ]


@pytest.mark.parametrize("exclude_history", [True, False])
@pytest.mark.parametrize("name", MODELS)
def test_recommend_matches_jax(name, exclude_history, dispatch):
    jmodel, jparams = _jax_side(name, seed=2)
    model = _port(name, jparams)
    seqs = _sequences()
    jids, jvals = JRecommender(jmodel, jparams, top_k=TOP_K).recommend(seqs, exclude_history)
    ids, vals = Recommender(model, top_k=TOP_K).recommend(seqs, exclude_history)
    jids, jvals = np.asarray(jids), np.asarray(jvals)
    assert ids.shape == vals.shape == (len(seqs), TOP_K)
    np.testing.assert_allclose(vals, jvals, atol=1e-4, rtol=0)
    # ids may differ only where the JAX scores tie within tolerance
    for i, j in zip(*np.nonzero(ids != jids)):
        row = dict(zip(jids[i].tolist(), jvals[i].tolist()))
        assert abs(row.get(int(ids[i, j]), jvals[i, -1]) - jvals[i, j]) <= 1e-4
    assert (ids != 0).all() and (ids < N_ITEMS).all()
    if exclude_history:
        for i, items in enumerate(seqs):
            assert not set(ids[i].tolist()) & set(items)


def test_bert4rec_padded_vocab_widths_agree(dispatch):
    """With a vocab multiple the table has pad(n_items + 1) rows and the
    bias pad(n_items); scores stay [B, n_items] and the serving history
    mask is cut to them."""
    cfg = dict(CFG, vocab_multiple=16)
    jmodel, jparams = _jax_side("BERT4Rec", cfg)
    model = _port("BERT4Rec", jparams, cfg)
    assert model.item_embedding.shape[0] == 64 == jparams["item_embedding"].shape[0]
    assert model.output_bias.shape[0] == 64 and model.n_items_padded == 64
    assert model.mask_token == N_ITEMS
    seq, lens = _batch()
    with torch.no_grad():
        scores = model.full_sort_scores(torch.from_numpy(seq).long(), torch.from_numpy(lens))
    want = np.asarray(jmodel.full_sort_scores(jparams, jnp.asarray(seq), jnp.asarray(lens)))
    assert scores.shape == want.shape == (6, N_ITEMS)
    np.testing.assert_allclose(scores.numpy(), want, atol=1e-4, rtol=0)
    ids, vals = Recommender(model, top_k=TOP_K).recommend(_sequences())
    assert (ids < N_ITEMS).all() and (ids != 0).all() and np.isfinite(vals).all()


@pytest.mark.parametrize("last_only", [True, False])
def test_bert4rec_encode_matches_jax(last_only, dispatch):
    """All positions, or the last one alone where the fused top layer
    selects it; the output head on whatever comes back."""
    jmodel, jparams = _jax_side("BERT4Rec", seed=4)
    model = _port("BERT4Rec", jparams)
    seq, lens = _batch(5)
    seq = model.reconstruct_test_seq(torch.from_numpy(seq).long(), torch.from_numpy(lens))
    with torch.no_grad():
        out, selected = model.encode(seq, last_only=last_only)
    want, want_selected = jmodel.encode(jparams, jnp.asarray(seq.numpy()), last_only=last_only)
    assert selected == bool(want_selected) == (last_only and dispatch)
    assert out.shape == want.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=5e-5, rtol=0)


@pytest.mark.parametrize("name", MODELS)
def test_interop_round_trips_exactly(name):
    _, jparams = _jax_side(name)
    tree = jax.tree.map(np.asarray, jparams)
    model = _port(name, jparams)
    assert set(model.state_dict()) == set(params_from_jax(tree))
    back = params_to_jax(model.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_reconstruct_test_seq_matches_jax():
    jmodel, _ = _jax_side("BERT4Rec")
    model = _port("BERT4Rec", _jax_side("BERT4Rec")[1])
    seq, lens = _batch(7)
    want = np.asarray(jmodel.reconstruct_test_seq(jnp.asarray(seq), jnp.asarray(lens)))
    got = model.reconstruct_test_seq(torch.from_numpy(seq).long(), torch.from_numpy(lens))
    np.testing.assert_array_equal(got.numpy(), want)


def _train_batch():
    seq, lens = _batch()
    return {"item_seq": torch.from_numpy(seq).long(), "item_seq_len": torch.from_numpy(lens),
            "pos_item": torch.ones(6, dtype=torch.long)}


@pytest.mark.parametrize("alias,name", [("S", "SASRec"), ("B", "BERT4Rec")])
def test_training_is_not_ported_yet(alias, name):
    """SASRec trains (its loss reaches every parameter); BERT4Rec's cloze
    training is still the next slice and raises, naming queue A 3.2."""
    model = get_model(alias)(Config(model=name, config_dict=CFG), N_ITEMS, T, device="cpu")
    assert type(model).__name__ == name
    batch = _train_batch()
    model.train()
    if name == "SASRec":
        loss = model.calculate_loss(batch, step=0)
        loss.backward()
        assert torch.isfinite(loss)
        for pname, prm in model.named_parameters():
            assert prm.grad is not None and torch.isfinite(prm.grad).all(), pname
        assert model.item_embedding.grad.abs().sum() > 0
        assert model.position_embedding.grad.abs().sum() > 0
        assert model(batch["item_seq"], batch["item_seq_len"], step=3).shape == (6, 16)
    else:
        with pytest.raises(NotImplementedError, match="queue A item 3.2"):
            model.calculate_loss(batch, step=0)
        with pytest.raises(NotImplementedError, match="queue A item 3.2"):
            model(batch["item_seq"], batch["item_seq_len"], step=3)
    model.train(False)
    assert model(batch["item_seq"], batch["item_seq_len"]).shape == (6, 16)


def test_compositions_draw_the_same_masks(monkeypatch):
    """At dropout 0.5 / 0.5 the fused and the unfused SASRec compute the
    same output for every row with 1 <= lens <= T: both draw the Philox
    masks at the same coordinates (the top fused layer at lens - 1).
    Tolerance atol 1e-5 (fp32 sums in another order)."""
    cfg = dict(CFG, hidden_dropout_prob=0.5, attn_dropout_prob=0.5)
    _, jparams = _jax_side("SASRec", cfg, seed=6)
    model = _port("SASRec", jparams, cfg)
    batch = _train_batch()
    model.train()
    outs = {}
    for fused in (True, False):
        monkeypatch.setattr(L, "FORCE_FUSED_ATTENTION", fused)
        with torch.no_grad():
            outs[fused] = model(batch["item_seq"], batch["item_seq_len"], step=9)
    rows = batch["item_seq_len"] >= 1
    assert int(rows.sum()) == 5
    torch.testing.assert_close(outs[True][rows], outs[False][rows], atol=1e-5, rtol=0)
    model.eval()
    with torch.no_grad():
        off = model(batch["item_seq"], batch["item_seq_len"], step=9)
    assert (off[rows] - outs[False][rows]).abs().max() > 0.1


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_step_seeds_the_masks(fused, monkeypatch):
    """The same step draws the same masks, another step other masks; no
    step, or eval mode, means no dropout."""
    monkeypatch.setattr(L, "FORCE_FUSED_ATTENTION", fused)
    cfg = dict(CFG, hidden_dropout_prob=0.3, attn_dropout_prob=0.3)
    model = get_model("SASRec")(Config(model="SASRec", config_dict=cfg), N_ITEMS, T,
                                device="cpu")
    batch = _train_batch()
    model.train()
    with torch.no_grad():
        a = model.calculate_loss(batch, step=5)
        b = model.calculate_loss(batch, step=5)
        c = model.calculate_loss(batch, step=6)
        off = model.calculate_loss(batch)
        model.eval()
        ev = model.calculate_loss(batch, step=5)
    assert float(a) == float(b) and float(a) != float(c)
    assert float(off) == float(ev) != float(a)
    p_hidden, p_attn, seeds = model.dropout_seeds(5)
    assert (p_hidden, p_attn) == (0.0, 0.0)  # eval mode
    model.train()
    p_hidden, p_attn, seeds = model.dropout_seeds(5)
    assert (p_hidden, p_attn, len(seeds)) == (0.3, 0.3, 3)
    assert seeds == model.dropout_seeds(5)[2] != model.dropout_seeds(6)[2]
