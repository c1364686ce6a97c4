"""The port's training path against the JAX package on the CPU: the CE
loss and every parameter gradient of the whole model, the Adam step and
the other learners, and a 2-epoch ``Trainer.fit`` trajectory from the
same parameters.

Both sides at fp32 and dropout 0 (the packages' dropout masks come from
different generators).  Fused composition: JAX with
``use_pallas_scan="always"`` runs its Pallas layer kernels, forward and
backward, in interpret mode; the port differentiates the plain versions
of its layer kernels.  Unfused: both "never".  Tolerances: loss rtol
1e-5; gradients rtol 1e-4 and atol 1e-5 * max|g| (summation order);
trajectory rtol 2e-4 / atol 5e-5, as ``tests/test_trajectory_parity.py``;
valid metrics within 1e-3."""

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
from datamining_recblr_tpu.models import get_model as j_get_model
from datamining_recblr_tpu.train import Trainer as JTrainer
from datamining_recblr_tpu.train.optim import build_optimizer as j_build_optimizer
from datamining_recblr_torch.config import Config
from datamining_recblr_torch.data.dataset import build_from_dataframe
from datamining_recblr_torch.data.synthetic import generate_synthetic_interactions
from datamining_recblr_torch.interop import params_from_jax
from datamining_recblr_torch.models import get_model
from datamining_recblr_torch.train.optim import build_optimizer
from datamining_recblr_torch.train.trainer import Trainer

N_ITEMS, T = 50, 12


def _cfg(impl, **overrides):
    return {"hidden_size": 16, "num_layers": 2, "MAX_ITEM_LIST_LENGTH": T,
            "use_pallas_scan": impl, "dropout_prob": 0.0, **overrides}


def _pair(cfg, n_items=N_ITEMS, seed=0):
    jmodel = j_get_model("RecBLR")(JConfig(model="RecBLR", config_dict=cfg), n_items, T)
    jparams = jmodel.init_params(jax.random.PRNGKey(seed))
    model = get_model("RecBLR")(Config(model="RecBLR", config_dict=cfg), n_items, T,
                                device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))
    return jmodel, jparams, model


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    lens = np.array([1, T, 5, 9, 3, 12], np.int32)
    seq = np.zeros((len(lens), T), np.int32)
    for i, n in enumerate(lens):
        seq[i, :n] = rng.integers(1, N_ITEMS, n)
    pos = rng.integers(1, N_ITEMS, len(lens)).astype(np.int32)
    weight = np.array([1, 1, 1, 1, 1, 0], np.float32)  # a padded row
    return {"item_seq": seq, "item_seq_len": lens, "pos_item": pos, "weight": weight}


@pytest.mark.parametrize("impl", ["always", "never"])
@pytest.mark.parametrize("overrides", [{}, {"num_layers": 1}, {"disable_ffn": True}],
                         ids=["default", "one_layer", "no_ffn"])
def test_loss_and_grads_match_jax(impl, overrides):
    jmodel, jparams, model = _pair(_cfg(impl, **overrides))
    assert model.use_fused_layer() == (impl == "always")
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want, jgrads = jax.value_and_grad(
        lambda p: jmodel.calculate_loss(p, jbatch, jax.random.PRNGKey(1)))(jparams)
    model.train()
    loss = model.calculate_loss({k: torch.from_numpy(v) for k, v in batch.items()}, step=0)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    want_grads = params_from_jax(jax.tree.map(np.asarray, jgrads))
    got = dict(model.named_parameters())
    assert set(got) == set(want_grads)
    for name, p in got.items():
        w = want_grads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w).max()), err_msg=name)


def test_padded_vocab_loss_and_item_scores_match_jax():
    """With the vocab padded (50 -> 64 rows) the padded columns enter CE
    at -1e30, as in the JAX package; item_scores is the row-wise dot."""
    jmodel, jparams, model = _pair(_cfg("never", vocab_multiple=16))
    assert model.n_items_padded == jmodel.n_items_padded == 64
    batch = _batch(1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want, jgrads = jax.value_and_grad(
        lambda p: jmodel.calculate_loss(p, jbatch, None))(jparams)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = model.calculate_loss(tbatch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    w = np.asarray(jgrads["item_embedding"])
    np.testing.assert_allclose(model.item_embedding.grad.numpy(), w, rtol=1e-4,
                               atol=1e-5 * float(np.abs(w).max()))
    seq_out = np.random.default_rng(2).standard_normal((6, 16)).astype(np.float32)
    ids = batch["pos_item"]
    np.testing.assert_allclose(
        model.item_scores(torch.from_numpy(seq_out), torch.from_numpy(ids)).detach().numpy(),
        np.asarray(jmodel.item_scores(jparams, jnp.asarray(seq_out), jnp.asarray(ids))),
        rtol=1e-5, atol=1e-7)


def test_fused_step_reaches_every_parameter():
    """The fused composition passes the parameters themselves to the
    layer kernels: after one step with dropout on, every gradient is
    there and nonzero."""
    _, _, model = _pair(_cfg("always", dropout_prob=0.2))
    model.train()
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    model.calculate_loss(batch, step=3).backward()
    for name, p in model.named_parameters():
        assert p.grad is not None and bool(p.grad.abs().sum() > 0), name


def test_dropout_is_seeded_by_the_step():
    _, _, model = _pair(_cfg("always", dropout_prob=0.2))
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    model.train()
    with torch.no_grad():
        a = model.calculate_loss(batch, step=5)
        b = model.calculate_loss(batch, step=5)
        c = model.calculate_loss(batch, step=6)
        off = model.calculate_loss(batch)  # no step: no dropout
        model.eval()
        ev = model.calculate_loss(batch, step=5)
    assert float(a) == float(b) and float(a) != float(c)
    assert float(off) == float(ev) != float(a)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adam_matches_build_optimizer(weight_decay):
    cfg = {"learning_rate": 1e-3, "weight_decay": weight_decay, "learner": "adam"}
    rng = np.random.default_rng(4)
    p0 = {"a": rng.standard_normal((5, 3)).astype(np.float32),
          "b": rng.standard_normal((7,)).astype(np.float32)}
    jopt = j_build_optimizer(JConfig(model="RecBLR", config_dict=cfg))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = jopt.init(jp)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in p0.items()}
    topt = build_optimizer(Config(model="RecBLR", config_dict=cfg), list(tp.values()))
    for _ in range(5):
        g = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
        updates, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = jax.tree.map(lambda a, u: a + u, jp, updates)
        for k, v in tp.items():
            v.grad = torch.from_numpy(g[k])
        topt.step()
        for k in p0:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("learner", ["adamw", "sgd", "adagrad", "rmsprop"])
def test_unported_learner_raises(learner):
    """Once not ported, now held to optax: five steps of each learner the
    JAX package builds besides Adam, with its defaults (adagrad's 0.1
    accumulator and eps inside the root, rmsprop's decay 0.9), stay
    within 1e-6 of the largest parameter of optax's, with and without
    weight decay (decoupled for adamw, none for the others, as
    ``build_optimizer`` of the JAX package); an unknown learner still
    raises."""
    for weight_decay in (0.0, 0.01):
        cfg = {"learning_rate": 1e-2, "weight_decay": weight_decay, "learner": learner}
        rng = np.random.default_rng(4)
        p0 = {"a": rng.standard_normal((5, 3)).astype(np.float32),
              "b": rng.standard_normal((7,)).astype(np.float32)}
        jopt = j_build_optimizer(JConfig(model="RecBLR", config_dict=cfg))
        jp = {k: jnp.asarray(v) for k, v in p0.items()}
        jstate = jopt.init(jp)
        tp = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in p0.items()}
        topt = build_optimizer(Config(model="RecBLR", config_dict=cfg), list(tp.values()))
        for _ in range(5):
            g = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
            g["b"][0] = 0.0  # a zero gradient: adagrad's sum stays above 0 from its start
            updates, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
            jp = jax.tree.map(lambda a, u: a + u, jp, updates)
            for k, v in tp.items():
                v.grad = torch.from_numpy(g[k])
            topt.step()
            for k in p0:
                want = np.asarray(jp[k])
                err = np.abs(tp[k].detach().numpy() - want).max() / np.abs(want).max()
                assert err <= 1e-6, (learner, weight_decay, k, err)
    with pytest.raises(ValueError, match="unknown learner"):
        build_optimizer(Config(model="RecBLR", config_dict={"learner": "lamb"}),
                        [torch.zeros(2, requires_grad=True)])


@pytest.mark.parametrize("impl", ["never", "always"])
def test_fit_trajectory_matches_jax(impl, tmp_path):
    gen = dict(n_users=60, n_items=30, min_len=5, max_len=14, markov_weight=0.9,
               n_clusters=4, seed=5)
    jdata = j_build(j_generate(**gen), max_seq_len=T)
    data = build_from_dataframe(generate_synthetic_interactions(**gen), max_seq_len=T)
    cfg = _cfg(impl, epochs=2, train_batch_size=64, eval_batch_size=64,
               stopping_step=10, checkpoint_dir=str(tmp_path / "saved"), dataset="syn")
    jmodel = j_get_model("RecBLR")(JConfig(model="RecBLR", config_dict=cfg),
                                   jdata.n_items, T)
    jparams = jmodel.init_params(jax.random.PRNGKey(3))
    start = params_from_jax(jax.tree.map(np.asarray, jparams))  # the JAX step donates
    jtrainer = JTrainer(JConfig(model="RecBLR", config_dict=cfg), jmodel, params=jparams)
    jbest, jresult = jtrainer.fit(jdata)

    model = get_model("RecBLR")(Config(model="RecBLR", config_dict=cfg), data.n_items, T,
                                device="cpu")
    trainer = Trainer(Config(model="RecBLR", config_dict=cfg), model, params=start)
    best, result = trainer.fit(data)

    want = [r["train_loss"] for r in jtrainer.metrics.epoch_records()]
    got = [r["train_loss"] for r in trainer.metrics.epoch_records()]
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=5e-5)
    assert trainer.best_epoch == jtrainer.best_epoch
    assert set(result) == set(jresult)
    for k in jresult:
        assert abs(result[k] - jresult[k]) <= 1e-3, k
    assert abs(best - jbest) <= 1e-3
    # the best checkpoint reloads: test metrics agree too
    jtest = jtrainer.evaluate(jdata.test, load_best=True)
    test = trainer.evaluate(data.test, load_best=True)
    for k in jtest:
        assert abs(test[k] - jtest[k]) <= 1e-3, k


def test_one_layer_fit_trajectory_matches_jax_and_falls(tmp_path):
    """A one-layer RecBLR (the paper's ``1layer`` ablation, H&M's depth):
    ``fused_dropout_ln`` and then the top layer.  Three epochs of
    ``Trainer.fit`` at dropout 0 follow the JAX package's ("always": its
    ``fused_dropout_ln`` and top-layer kernels in interpret mode), and the
    epoch loss falls, at dropout 0 and at H&M's 0.4."""
    gen = dict(n_users=60, n_items=30, min_len=5, max_len=14, markov_weight=0.9,
               n_clusters=4, seed=5)
    jdata = j_build(j_generate(**gen), max_seq_len=T)
    data = build_from_dataframe(generate_synthetic_interactions(**gen), max_seq_len=T)
    losses = {}
    for p_drop in (0.0, 0.4):
        cfg = _cfg("always", num_layers=1, dropout_prob=p_drop, epochs=3, train_batch_size=32,
                   eval_batch_size=64, stopping_step=10,
                   checkpoint_dir=str(tmp_path / f"saved{p_drop}"), dataset="syn")
        jmodel = j_get_model("RecBLR")(JConfig(model="RecBLR", config_dict=cfg),
                                       jdata.n_items, T)
        jparams = jmodel.init_params(jax.random.PRNGKey(3))
        start = params_from_jax(jax.tree.map(np.asarray, jparams))
        model = get_model("RecBLR")(Config(model="RecBLR", config_dict=cfg), data.n_items, T,
                                    device="cpu")
        assert model.use_fused_layer() and len(model.layers) == 1
        trainer = Trainer(Config(model="RecBLR", config_dict=cfg), model, params=start)
        trainer.fit(data)
        losses[p_drop] = [r["train_loss"] for r in trainer.metrics.epoch_records()]
        if p_drop == 0.0:
            jtrainer = JTrainer(JConfig(model="RecBLR", config_dict=cfg), jmodel, params=jparams)
            jtrainer.fit(jdata)
            want = [r["train_loss"] for r in jtrainer.metrics.epoch_records()]
            np.testing.assert_allclose(losses[p_drop], want, rtol=2e-4, atol=5e-5)
    for p_drop, got in losses.items():
        assert len(got) == 3 and got[-1] < got[0], (p_drop, got)


def _fit_setup(tmp_path, epochs, compact=False, monkeypatch=None):
    from datamining_recblr_torch.data import dataset as DS

    if compact:
        monkeypatch.setattr(DS, "_COMPACT_TRAIN_ELEMS", 0)
    frame = generate_synthetic_interactions(n_users=40, n_items=25, min_len=4, max_len=12,
                                            seed=9)
    data = build_from_dataframe(frame, max_seq_len=T)
    assert data.train.compact == compact
    cfg = Config(model="RecBLR", config_dict=_cfg(
        "always", dropout_prob=0.2, epochs=epochs, train_batch_size=32,
        checkpoint_dir=str(tmp_path), dataset="syn"))
    model = get_model("RecBLR")(cfg, data.n_items, T, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    return cfg, data, model


def test_resumed_fit_replays_the_trajectory(tmp_path):
    """Dropout seeds come from (seed, step, layer) and permutations from
    (seed, epoch): epoch 1 after resuming from epoch 0's checkpoint is
    the uninterrupted run's epoch 1."""
    cfg, data, model = _fit_setup(tmp_path / "a", epochs=2)
    whole = Trainer(cfg, model)
    whole.fit(data)
    cfg1, _, model1 = _fit_setup(tmp_path / "b", epochs=1)
    first = Trainer(cfg1, model1)
    first.fit(data)
    cfg2, _, model2 = _fit_setup(tmp_path / "b", epochs=2)
    resumed = Trainer(cfg2, model2)
    resumed.resume_from(first.ckpt_path)
    assert resumed.start_epoch == 1
    resumed.fit(data)
    want = whole.metrics.epoch_records()[1]
    got = resumed.metrics.epoch_records()[0]
    assert got["epoch"] == 1
    np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=1e-6)
    assert got["valid_ndcg@10"] == pytest.approx(want["valid_ndcg@10"], abs=1e-6)


def test_compact_split_trains_as_the_dense_one(tmp_path, monkeypatch):
    """The trainer assembles a compact split's windows on the device:
    the same losses as the dense split of the same data."""
    cfg, data, model = _fit_setup(tmp_path / "d", epochs=2)
    dense = Trainer(cfg, model)
    dense.fit(data)
    cfg, cdata, cmodel = _fit_setup(tmp_path / "c", epochs=2, compact=True,
                                    monkeypatch=monkeypatch)
    compact = Trainer(cfg, cmodel)
    compact.fit(cdata)
    np.testing.assert_allclose([r["train_loss"] for r in compact.metrics.epoch_records()],
                               [r["train_loss"] for r in dense.metrics.epoch_records()],
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# SASRec: both compositions against the JAX SASRec at dropout 0.  Fused:
# the JAX package's prologue and transformer-layer kernels, forward and
# backward, in interpret mode, against the plain versions' autograd.
# Tolerances: loss rtol 1e-5; gradients rtol 1e-4 and atol 1e-5 of each
# gradient's largest value, at least 1e-6 of the largest gradient of all
# (the key biases' is zero up to rounding); trajectory as above.
# ---------------------------------------------------------------------------

SAS_CFG = {"MAX_ITEM_LIST_LENGTH": T, "hidden_size": 16, "inner_size": 32, "n_layers": 2,
           "n_heads": 2, "hidden_dropout_prob": 0.0, "attn_dropout_prob": 0.0}


@pytest.fixture(params=[True, False], ids=["fused", "unfused"])
def sas_dispatch(request, monkeypatch):
    from datamining_recblr_tpu.models import layers as JL
    from datamining_recblr_torch.models import layers as L

    monkeypatch.setattr(JL, "_use_fused_attention", lambda: request.param)
    monkeypatch.setattr(L, "FORCE_FUSED_ATTENTION", request.param)
    return request.param


def test_sasrec_loss_and_grads_match_jax(sas_dispatch):
    jmodel = j_get_model("SASRec")(JConfig(model="SASRec", config_dict=SAS_CFG), N_ITEMS, T)
    jparams = jmodel.init_params(jax.random.PRNGKey(2))
    rng = np.random.default_rng(2)
    # weights well away from the N(0, 0.02) init, so that attention and
    # the FFN shape the gradients
    jparams = jax.tree.map(
        lambda a: a + (0.15 * rng.standard_normal(a.shape)).astype(np.float32), jparams)
    model = get_model("SASRec")(Config(model="SASRec", config_dict=SAS_CFG), N_ITEMS, T,
                                device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))
    batch = _batch(3)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want, jgrads = jax.value_and_grad(
        lambda p: jmodel.calculate_loss(p, jbatch, jax.random.PRNGKey(1)))(jparams)
    model.train()
    loss = model.calculate_loss({k: torch.from_numpy(v) for k, v in batch.items()}, step=0)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    want_grads = params_from_jax(jax.tree.map(np.asarray, jgrads))
    got = dict(model.named_parameters())
    assert set(got) == set(want_grads)
    top = max(float(v.abs().max()) for v in want_grads.values())
    for name, p in got.items():
        w = want_grads[name].numpy()
        atol = max(1e-5 * float(np.abs(w).max()), 1e-6 * top)
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4, atol=atol, err_msg=name)


def test_sasrec_fit_trajectory_matches_jax(sas_dispatch, tmp_path):
    gen = dict(n_users=60, n_items=30, min_len=5, max_len=14, markov_weight=0.9,
               n_clusters=4, seed=5)
    jdata = j_build(j_generate(**gen), max_seq_len=T)
    data = build_from_dataframe(generate_synthetic_interactions(**gen), max_seq_len=T)
    cfg = dict(SAS_CFG, epochs=2, train_batch_size=64, eval_batch_size=64, stopping_step=10,
               checkpoint_dir=str(tmp_path / "saved"), dataset="syn")
    jmodel = j_get_model("SASRec")(JConfig(model="SASRec", config_dict=cfg), jdata.n_items, T)
    jparams = jmodel.init_params(jax.random.PRNGKey(3))
    start = params_from_jax(jax.tree.map(np.asarray, jparams))  # the JAX step donates
    jtrainer = JTrainer(JConfig(model="SASRec", config_dict=cfg), jmodel, params=jparams)
    jbest, jresult = jtrainer.fit(jdata)

    model = get_model("SASRec")(Config(model="SASRec", config_dict=cfg), data.n_items, T,
                                device="cpu")
    trainer = Trainer(Config(model="SASRec", config_dict=cfg), model, params=start)
    best, result = trainer.fit(data)

    want = [r["train_loss"] for r in jtrainer.metrics.epoch_records()]
    got = [r["train_loss"] for r in trainer.metrics.epoch_records()]
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=5e-5)
    assert trainer.best_epoch == jtrainer.best_epoch
    for k in jresult:
        assert abs(result[k] - jresult[k]) <= 1e-3, k
    assert abs(best - jbest) <= 1e-3
