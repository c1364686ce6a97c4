"""SASRec and BERT4Rec serving, and BERT4Rec's cloze training, in the
port against the JAX package, on the CPU, in both compositions.

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
    """Both baselines train now: SASRec's CE and BERT4Rec's cloze loss
    reach every parameter, and ``forward`` in training mode with a step
    runs with dropout.  BPR, once not ported, trains too: its loss is
    finite and reaches the item table (held to the JAX package in
    ``tests/test_torch_bpr.py``); an unknown loss type raises."""
    model = get_model(alias)(Config(model=name, config_dict=CFG), N_ITEMS, T, device="cpu")
    assert type(model).__name__ == name
    batch = _train_batch()
    model.train()
    loss = model.calculate_loss(batch, step=0)
    loss.backward()
    assert torch.isfinite(loss)
    for pname, prm in model.named_parameters():
        assert prm.grad is not None and torch.isfinite(prm.grad).all(), pname
    assert model.item_embedding.grad.abs().sum() > 0
    assert model.position_embedding.grad.abs().sum() > 0
    with torch.no_grad():
        out = model(batch["item_seq"], batch["item_seq_len"], step=3)
        assert out.shape == (6, 16)
        assert (out - model(batch["item_seq"], batch["item_seq_len"])).abs().max() > 1e-3
    bpr = get_model(alias)(Config(model=name, config_dict=dict(CFG, loss_type="BPR")), N_ITEMS,
                           T, device="cpu")
    bpr.train()
    bpr_batch = dict(batch, neg_item=torch.full((6,), 2, dtype=torch.long))
    bpr_loss = bpr.calculate_loss(bpr_batch, step=0)
    bpr_loss.backward()
    assert torch.isfinite(bpr_loss) and bpr.item_embedding.grad.abs().sum() > 0
    other = get_model(alias)(Config(model=name, config_dict=dict(CFG, loss_type="X")), N_ITEMS,
                             T, device="cpu")
    with pytest.raises(ValueError, match="unknown loss_type"):
        other.calculate_loss(batch, step=0)
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


# ---------------------------------------------------------------------------
# BERT4Rec's cloze training.  Against the JAX package at dropout 0 the
# JAX model's on-device draw is replayed host-side and injected
# (``tests/test_trajectory_parity.py:373-393``); the port's own draw is a
# Philox draw of (config seed, step).  Tolerances as for SASRec
# (tests/test_torch_train.py): loss rtol 1e-5; gradients rtol 1e-4 and
# atol 1e-5 of each gradient's largest value, at least 1e-6 of the largest
# gradient of all; a 10-step trajectory rtol 2e-4 / atol 5e-5.
# ---------------------------------------------------------------------------

B4R_CFG = dict(CFG, mask_ratio=0.4, hidden_dropout_prob=0.0, attn_dropout_prob=0.0)


def _replay_cloze(jmodel, key, seq, lens):
    """The JAX model's cloze draw of ``calculate_loss(params, batch, key)``
    (split(key, 4) -> bernoulli(k_mask); with cloze_last_only each row's
    last real position), capped by rank and compacted: the port's
    ``(masked_seq, order, sel_tgt, sel_valid)``."""
    b, t = seq.shape
    mask_len = max(1, int(jmodel.mask_ratio * t))
    real = seq != 0
    if jmodel.config.get("cloze_last_only"):
        want = (np.arange(t)[None, :] == lens[:, None] - 1) & real
    else:
        _, k_mask, _, _ = jax.random.split(key, 4)
        want = np.asarray(jax.random.bernoulli(k_mask, jmodel.mask_ratio, seq.shape)) & real
    cloze = want & (np.cumsum(want, axis=1) <= mask_len)
    order = np.zeros((b, mask_len), np.int64)
    tgt = np.zeros((b, mask_len), np.int64)
    for i in range(b):
        pos = np.nonzero(cloze[i])[0]
        order[i, : len(pos)] = pos
        tgt[i, : len(pos)] = seq[i, pos]
    valid = np.arange(mask_len)[None, :] < cloze.sum(1)[:, None]
    masked = np.where(cloze, jmodel.mask_token, seq).astype(np.int64)
    return tuple(torch.from_numpy(a) for a in (masked, order, tgt, valid))


def _check_model_grads(model, jgrads, rel=1e-5):
    want = params_from_jax(jax.tree.map(np.asarray, jgrads))
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    top = max(float(v.abs().max()) for v in want.values())
    for name, p in got.items():
        w = want[name].numpy()
        atol = max(rel * float(np.abs(w).max()), 1e-6 * top)
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4, atol=atol, err_msg=name)


@pytest.mark.parametrize("last_only", [False, True], ids=["cloze", "cloze_last_only"])
def test_bert4rec_cloze_loss_and_grads_match_jax(last_only, dispatch):
    cfg = dict(B4R_CFG, cloze_last_only=last_only)
    jmodel, jparams = _jax_side("BERT4Rec", cfg, seed=8)
    model = _port("BERT4Rec", jparams, cfg)
    seq, lens = _batch(9)
    weight = np.array([1, 1, 1, 1, 1, 0], np.float32)  # a padded row
    jbatch = {"item_seq": jnp.asarray(seq), "item_seq_len": jnp.asarray(lens),
              "weight": jnp.asarray(weight)}
    key = jax.random.PRNGKey(5)
    want, jgrads = jax.value_and_grad(lambda p: jmodel.calculate_loss(p, jbatch, key))(jparams)
    cloze = _replay_cloze(jmodel, key, seq, lens)
    assert int(cloze[3].sum()) > 3  # masked positions on several rows
    if last_only:  # a deterministic draw: the port draws the same
        mine = model.cloze_draw(torch.from_numpy(seq).long(), torch.from_numpy(lens), 0)
        for a, b in zip(mine, cloze):
            assert torch.equal(a, b)
    model.train()
    loss = model.cloze_loss({"weight": torch.from_numpy(weight)}, cloze, step=0)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    _check_model_grads(model, jgrads)


def test_bert4rec_trajectory_matches_jax(dispatch):
    """Ten Adam steps of the cloze loss from the same parameters, each with
    the JAX model's draw injected; then the item table agrees too."""
    from datamining_recblr_tpu.train.optim import build_optimizer as j_build_optimizer
    from datamining_recblr_torch.train.optim import build_optimizer

    jmodel, jparams = _jax_side("BERT4Rec", B4R_CFG, seed=10)
    model = _port("BERT4Rec", jparams, B4R_CFG)
    jopt = j_build_optimizer(JConfig(model="BERT4Rec", config_dict=B4R_CFG))
    opt = build_optimizer(Config(model="BERT4Rec", config_dict=B4R_CFG), model.parameters())
    jstate = jopt.init(jparams)

    @jax.jit
    def step(params, state, seq, lens, key):
        batch = {"item_seq": seq, "item_seq_len": lens, "weight": jnp.ones(seq.shape[0])}
        loss, grads = jax.value_and_grad(lambda p: jmodel.calculate_loss(p, batch, key))(params)
        updates, state = jopt.update(grads, state, params)
        return jax.tree.map(lambda p, u: p + u, params, updates), state, loss

    seq, lens = _batch(12)
    theirs, ours = [], []
    model.train()
    for s in range(10):
        key = jax.random.PRNGKey(100 + s)
        jparams, jstate, jl = step(jparams, jstate, jnp.asarray(seq), jnp.asarray(lens), key)
        theirs.append(float(jl))
        opt.zero_grad(set_to_none=True)
        loss = model.cloze_loss({"weight": torch.ones(6)}, _replay_cloze(jmodel, key, seq, lens),
                                step=s)
        loss.backward()
        opt.step()
        ours.append(float(loss.detach()))
    np.testing.assert_allclose(ours, theirs, rtol=2e-4, atol=5e-5)
    np.testing.assert_allclose(model.item_embedding.detach().numpy(),
                               np.asarray(jparams["item_embedding"]), rtol=1e-3, atol=2e-4)


def test_bert4rec_cloze_draw():
    """Only real positions are masked, at most mask_len a row, listed in
    ascending order with their items as targets; the draw is a function of
    (seed, step)."""
    cfg = dict(CFG, mask_ratio=0.4)
    model = get_model("BERT4Rec")(Config(model="BERT4Rec", config_dict=cfg), N_ITEMS, T,
                                  device="cpu")
    rng = np.random.default_rng(14)
    lens = rng.integers(0, T + 1, 64).astype(np.int32)
    seq = np.where(np.arange(T)[None] < lens[:, None], rng.integers(1, N_ITEMS, (64, T)), 0)
    tseq, tlens = torch.from_numpy(seq), torch.from_numpy(lens)
    masked, order, tgt, valid = model.cloze_draw(tseq, tlens, 7)
    mask_len = model.mask_len(T)
    assert mask_len == 4 and order.shape == tgt.shape == valid.shape == (64, mask_len)
    drawn = masked == model.mask_token
    assert not (drawn & (tseq == 0)).any()
    assert torch.equal(drawn.sum(1), valid.sum(1)) and int(valid.sum(1).max()) == mask_len
    assert torch.equal(torch.where(drawn, tseq, masked), tseq)
    for i in range(64):
        n = int(valid[i].sum())
        pos = torch.nonzero(drawn[i])[:, 0]
        assert torch.equal(order[i, :n], pos) and bool((order[i, n:] == 0).all())
        assert torch.equal(tgt[i, :n], tseq[i, pos]) and bool((tgt[i, n:] == 0).all())
        assert bool(valid[i, :n].all()) and not valid[i, n:].any()
    again = model.cloze_draw(tseq, tlens, 7)
    other = model.cloze_draw(tseq, tlens, 8)
    assert all(torch.equal(a, b) for a, b in zip(again, (masked, order, tgt, valid)))
    assert not torch.equal(other[0], masked)
    # before the budget's cap, about mask_ratio of the real positions
    wide = get_model("BERT4Rec")(Config(model="BERT4Rec", config_dict=dict(cfg, mask_ratio=1.0)),
                                 N_ITEMS, T, device="cpu")
    wide.mask_ratio = 0.4
    share = float((wide.cloze_draw(tseq, tlens, 7)[0] == N_ITEMS).sum()) / float(lens.sum())
    assert abs(share - 0.4) < 0.06


def test_bert4rec_compositions_agree_at_dropout():
    """At dropout 0.2 / 0.2 the fused composition (the selected-positions
    top layer) and the unfused one (the full layer, then a gather) give
    the same cloze loss and gradients: the same masks at the same
    coordinates (loss atol 1e-5; gradients 1e-5 of each one's largest
    value, at least 1e-6 of the largest of all: b_k's is zero up to
    rounding)."""
    cfg = dict(CFG, mask_ratio=0.4, hidden_dropout_prob=0.2, attn_dropout_prob=0.2)
    _, jparams = _jax_side("BERT4Rec", cfg, seed=15)
    model = _port("BERT4Rec", jparams, cfg)
    batch = _train_batch()
    model.train()
    got = {}
    for fused in (True, False):
        L.FORCE_FUSED_ATTENTION = fused
        try:
            model.zero_grad(set_to_none=True)
            loss = model.calculate_loss(batch, step=21)
            loss.backward()
        finally:
            L.FORCE_FUSED_ATTENTION = None
        got[fused] = (float(loss.detach()), {k: v.grad.clone() for k, v in
                                             model.named_parameters()})
    assert abs(got[True][0] - got[False][0]) <= 1e-5
    top = max(float(w.abs().max()) for w in got[False][1].values())
    for name, g in got[True][1].items():
        w = got[False][1][name]
        atol = max(1e-5 * float(w.abs().max()), 1e-6 * top)
        assert float((g - w).abs().max()) <= atol, name
    model.eval()
    with torch.no_grad():
        off = model.calculate_loss(batch, step=21)
    assert abs(float(off) - got[True][0]) > 1e-3


def test_bert4rec_fit_on_the_cpu(tmp_path):
    """Trainer.fit of BERT4Rec: the epoch loss falls and the test metrics
    come from the best checkpoint."""
    from datamining_recblr_torch.data.dataset import build_from_dataframe
    from datamining_recblr_torch.data.synthetic import generate_synthetic_interactions
    from datamining_recblr_torch.train.trainer import Trainer

    data = build_from_dataframe(generate_synthetic_interactions(
        n_users=60, n_items=30, min_len=5, max_len=14, markov_weight=0.9, n_clusters=4, seed=5),
        max_seq_len=T)
    cfg = Config(model="BERT4Rec", config_dict=dict(
        CFG, epochs=3, train_batch_size=64, eval_batch_size=64, learning_rate=0.005,
        stopping_step=10, checkpoint_dir=str(tmp_path), dataset="syn"))
    model = get_model("BERT4Rec")(cfg, data.n_items, T, device="cpu")
    trainer = Trainer(cfg, model)
    best, _ = trainer.fit(data)
    losses = [r["train_loss"] for r in trainer.metrics.epoch_records()]
    assert len(losses) == 3 and losses[-1] < losses[0]
    assert trainer.ckpt_path is not None and trainer.best_epoch >= 0
    test = trainer.evaluate(data.test, load_best=True)
    assert set(test) >= {"ndcg@10", "hit@10"} and best >= 0.0


# ---------------------------------------------------------------------------
# Beyond the whole-layer kernels: shapes that ``fused_block.supports``
# rejects (D above 128, an FFN above 2,048, T above 1,024).  With the fused
# composition forced on in both packages, each layer runs the per-op
# composition with ``fused_attention`` for the masked softmax: the JAX
# kernel in interpret mode against the port's plain version.  Tolerances
# as above; the loss and gradients as in the cloze tests.
# ---------------------------------------------------------------------------

WIDE = {
    "hidden144": ({"hidden_size": 144, "n_heads": 2, "inner_size": 288}, 12),
    "ffn2080": ({"hidden_size": 16, "n_heads": 2, "inner_size": 2080}, 12),
    "t1030": ({"hidden_size": 16, "n_heads": 2, "inner_size": 32}, 1030),
    # heads of 264, wider than the port's attention kernels take: the port
    # runs the softmax composition, the JAX package its kernel
    "hidden528": ({"hidden_size": 528, "n_heads": 2, "inner_size": 2112}, 12),
}
# hidden 528's outputs and scores are held within 1e-4 of their largest
# value: with the JAX kernel or its XLA composition alike, the two
# packages differ there by up to 6.6e-5 of it (BERT4Rec's encode, the row
# with no history, whose keys all sit at -10,000 in fp32; elsewhere 3e-5),
# fp32 sums in another order over 528- and 2,112-wide products
WIDE_REL = {"hidden528": 1e-4}


@pytest.fixture
def fused_both(monkeypatch):
    monkeypatch.setattr(JL, "_use_fused_attention", lambda: True)
    monkeypatch.setattr(L, "FORCE_FUSED_ATTENTION", True)


def _wide_pair(name, case, seed, **extra):
    from datamining_recblr_torch.ops import fused_block as FB

    overrides, t = WIDE[case]
    cfg = dict(CFG, MAX_ITEM_LIST_LENGTH=t, **overrides, **extra)
    jmodel = j_get_model(name)(JConfig(model=name, config_dict=cfg), N_ITEMS, t)
    jparams = jmodel.init_params(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    jparams = jax.tree.map(
        lambda a: a + (0.15 * rng.standard_normal(a.shape)).astype(np.float32), jparams)
    model = get_model(name)(Config(model=name, config_dict=cfg), N_ITEMS, t, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))
    assert not FB.supports(cfg["hidden_size"], 2, cfg["inner_size"], t, "gelu")
    return jmodel, jparams, model, t


def _wide_batch(t, seed):
    """Six rows with lens 0, 1 and T among them (T 1,030: two rows, T and
    a draw)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, t + 1, 6 if t < 100 else 2).astype(np.int32)
    lens[: min(3, len(lens))] = [0, 1, t][: len(lens)] if t < 100 else [t, lens[1]]
    seq = rng.integers(1, N_ITEMS, (len(lens), t)).astype(np.int32)
    return np.where(np.arange(t)[None] < lens[:, None], seq, 0), lens


@pytest.mark.parametrize("case", list(WIDE))
@pytest.mark.parametrize("name", MODELS)
def test_rejected_shapes_serve_as_jax(name, case, fused_both):
    """encode (BERT4Rec, all positions), the last-position output, the
    full-sort scores and, below T 1,030, ``recommend``."""
    jmodel, jparams, model, t = _wide_pair(name, case, seed=21)
    seq, lens = _wide_batch(t, 22)
    tseq, tlens = torch.from_numpy(seq).long(), torch.from_numpy(lens)
    fwd = jax.jit(lambda p, s, n: (jmodel.forward(p, s, n), jmodel.full_sort_scores(p, s, n)))
    want, want_scores = fwd(jparams, jnp.asarray(seq), jnp.asarray(lens))
    rel = WIDE_REL.get(case)
    with torch.no_grad():
        out = model(tseq, tlens)
        scores = model.full_sort_scores(tseq, tlens)
        if name == "BERT4Rec":
            enc, selected = model.encode(tseq)
            jenc, _ = jax.jit(lambda p, s: jmodel.encode(p, s))(jparams, jnp.asarray(seq))
            assert not selected and enc.shape == jenc.shape == (len(lens), t, model.hidden_size)
            atol = 5e-5 if rel is None else rel * float(np.abs(np.asarray(jenc)).max())
            np.testing.assert_allclose(enc.numpy(), np.asarray(jenc), atol=atol, rtol=0)
    want_scores = np.asarray(want_scores)
    top = float(np.abs(want_scores[np.isfinite(want_scores)]).max())
    atol_out = 5e-5 if rel is None else rel * float(np.abs(np.asarray(want)).max())
    atol_scores = 1e-4 if rel is None else rel * top
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=atol_out, rtol=0)
    np.testing.assert_allclose(scores.numpy(), want_scores, atol=atol_scores, rtol=0)
    # the JAX Recommender cannot serve BERT4Rec at hidden 528: its history
    # mask spans the catalog padded to 2,048 rows (D > 512), BERT4Rec's
    # scores only the 50 items; the card test holds the port's recommend()
    if t > 100 or (name, case) == ("BERT4Rec", "hidden528"):
        return
    seqs = _sequences()
    jids, jvals = JRecommender(jmodel, jparams, top_k=TOP_K).recommend(seqs)
    ids, vals = Recommender(model, top_k=TOP_K).recommend(seqs)
    jids, jvals = np.asarray(jids), np.asarray(jvals)
    np.testing.assert_allclose(vals, jvals, atol=atol_scores, rtol=0)
    for i, j in zip(*np.nonzero(ids != jids)):
        row = dict(zip(jids[i].tolist(), jvals[i].tolist()))
        assert abs(row.get(int(ids[i, j]), jvals[i, -1]) - jvals[i, j]) <= atol_scores


@pytest.mark.parametrize("case", ["hidden144", "ffn2080", "hidden528"])
@pytest.mark.parametrize("name", MODELS)
def test_rejected_shapes_train_as_jax(name, case, fused_both):
    """The loss and every parameter gradient at dropout 0: SASRec's CE,
    BERT4Rec's cloze loss with the JAX model's draw injected.  At hidden
    144 and 528 the gradients are held at 1e-4 of each one's largest
    value: at 144 the two packages' softmax compositions (no kernel on
    either side) already differ by up to 3.5e-5 of it, fp32 sums in
    another order over 144-wide products."""
    extra = {"hidden_dropout_prob": 0.0, "attn_dropout_prob": 0.0, "mask_ratio": 0.4}
    jmodel, jparams, model, t = _wide_pair(name, case, seed=23, **extra)
    seq, lens = _wide_batch(t, 24)
    key = jax.random.PRNGKey(6)
    model.train()
    if name == "SASRec":
        pos = np.random.default_rng(25).integers(1, N_ITEMS, len(lens))
        batch = {"item_seq": seq, "item_seq_len": lens, "pos_item": pos}
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        loss = model.calculate_loss({k: torch.from_numpy(v) for k, v in batch.items()}, step=0)
    else:
        jbatch = {"item_seq": jnp.asarray(seq), "item_seq_len": jnp.asarray(lens),
                  "weight": jnp.ones(len(lens))}
        cloze = _replay_cloze(jmodel, key, seq, lens)
        assert int(cloze[3].sum()) > 3
        loss = model.cloze_loss({"weight": torch.ones(len(lens))}, cloze, step=0)
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.calculate_loss(p, jbatch, key)))(jparams)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    _check_model_grads(model, jgrads, rel=1e-5 if case == "ffn2080" else 1e-4)


@pytest.mark.parametrize("name", MODELS)
def test_rejected_shapes_compositions_agree_at_dropout(name, monkeypatch):
    """At hidden 144, dropout 0.2 / 0.3: the per-op composition with
    ``fused_attention`` and the softmax composition draw the same masks at
    the same coordinates, so the training loss and every gradient agree
    (loss atol 1e-5; gradients 1e-5 of each one's largest value, at least
    1e-6 of the largest of all)."""
    extra = {"hidden_dropout_prob": 0.2, "attn_dropout_prob": 0.3, "mask_ratio": 0.4}
    _, _, model, t = _wide_pair(name, "hidden144", seed=26, **extra)
    seq, lens = _wide_batch(t, 27)
    batch = {"item_seq": torch.from_numpy(seq).long(), "item_seq_len": torch.from_numpy(lens),
             "pos_item": torch.ones(len(lens), dtype=torch.long)}
    model.train()
    got = {}
    for fused in (True, False):
        monkeypatch.setattr(L, "FORCE_FUSED_ATTENTION", fused)
        model.zero_grad(set_to_none=True)
        loss = model.calculate_loss(batch, step=13)
        loss.backward()
        got[fused] = (float(loss.detach()), {k: v.grad.clone() for k, v in
                                             model.named_parameters()})
    assert abs(got[True][0] - got[False][0]) <= 1e-5
    top = max(float(w.abs().max()) for w in got[False][1].values())
    for pname, g in got[True][1].items():
        w = got[False][1][pname]
        assert float((g - w).abs().max()) <= max(1e-5 * float(w.abs().max()), 1e-6 * top), pname
    model.eval()
    with torch.no_grad():
        off = model.calculate_loss(batch, step=13)
    assert abs(float(off) - got[True][0]) > 1e-3


@pytest.mark.parametrize("dh,fused", [(256, True), (264, False)])
def test_head_width_gate(dh, fused, monkeypatch):
    """``attention.supports`` takes heads up to 256: a layer of 2 heads of
    256 runs ``fused_attention``, one of 264 the softmax composition under
    the additive mask (which ``transformer_encoder_apply`` then builds)."""
    from datamining_recblr_torch.ops import attention as A

    assert A.supports(dh) == fused and not A.supports(0)
    monkeypatch.setattr(L, "FORCE_FUSED_ATTENTION", True)
    calls = []
    monkeypatch.setattr(L, "fused_attention",
                        lambda *a, **k: calls.append(1) or A.fused_attention_plain(*a, **k))
    h, t = 2 * dh, 5
    layers = L.transformer_encoder_init(torch.Generator().manual_seed(0), 1, 2, h, 64)
    x = torch.randn((2, t, h), generator=torch.Generator().manual_seed(1))
    lens = torch.tensor([3, t])
    seq = torch.where(torch.arange(t)[None] < lens[:, None], 1, 0)
    built = []

    def mask():
        built.append(1)
        return L.attention_mask(seq)

    out = L.transformer_encoder_apply(layers, x, mask, n_heads=2, lens=lens, causal=True)
    assert (len(calls), len(built)) == ((1, 0) if fused else (0, 1))
    want = L.transformer_encoder_apply(layers, x, L.attention_mask(seq), n_heads=2)
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)
