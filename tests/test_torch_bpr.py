"""The BPR loss in the port against the JAX package on the CPU: RecBLR's
and SASRec's ``calculate_loss`` with one sampled negative a row
(-log(1e-10 + sigmoid(pos - neg))), BERT4Rec's over the cloze slots
(-log(1e-14 + sigmoid(pos - neg)) with the output bias, summed over the
valid slots), their gradients, a 10-step RecBLR trajectory with the same
negatives, and two epochs of ``Trainer.fit``, whose host-drawn negatives
are the JAX trainer's.  fp32 at dropout 0; both compositions.  BERT4Rec's
cloze draw and negatives come from ``jax.random`` in the JAX model, so they
are replayed here and injected.  Tolerances: loss rtol 1e-5; gradients
rtol 1e-4 and atol 1e-5 of each gradient's largest value (at least 1e-6
of the largest of all); trajectories rtol 2e-4 / atol 5e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datamining_recblr_tpu.config import Config as JConfig
from datamining_recblr_tpu.data.dataset import build_from_dataframe as j_build
from datamining_recblr_tpu.data.synthetic import generate_synthetic_interactions as j_generate
from datamining_recblr_tpu.models import base as JB
from datamining_recblr_tpu.models import get_model as j_get_model
from datamining_recblr_tpu.models import layers as JL
from datamining_recblr_tpu.train import Trainer as JTrainer
from datamining_recblr_tpu.train.optim import build_optimizer as j_build_optimizer
from datamining_recblr_torch.config import Config
from datamining_recblr_torch.data.dataset import build_from_dataframe
from datamining_recblr_torch.data.synthetic import generate_synthetic_interactions
from datamining_recblr_torch.interop import params_from_jax
from datamining_recblr_torch.models import base as B
from datamining_recblr_torch.models import get_model
from datamining_recblr_torch.models import layers as L
from datamining_recblr_torch.train.optim import build_optimizer
from datamining_recblr_torch.train.trainer import Trainer

N_ITEMS, T = 50, 12
RECBLR = {"hidden_size": 16, "num_layers": 2, "MAX_ITEM_LIST_LENGTH": T, "dropout_prob": 0.0,
          "loss_type": "BPR"}
BASELINE = {"hidden_size": 16, "inner_size": 32, "n_layers": 2, "n_heads": 2,
            "MAX_ITEM_LIST_LENGTH": T, "hidden_dropout_prob": 0.0, "attn_dropout_prob": 0.0,
            "loss_type": "BPR"}


@pytest.fixture(params=[True, False], ids=["fused", "unfused"])
def dispatch(request, monkeypatch):
    """Both packages on the same composition (RecBLR: "always" or
    "never"; the baselines: the fused attention forced on or off)."""
    monkeypatch.setattr(JL, "_use_fused_attention", lambda: request.param)
    monkeypatch.setattr(L, "FORCE_FUSED_ATTENTION", request.param)
    return request.param


def _pair(name, cfg, seed=0, perturb=False):
    jmodel = j_get_model(name)(JConfig(model=name, config_dict=cfg), N_ITEMS, T)
    jparams = jmodel.init_params(jax.random.PRNGKey(seed))
    if perturb:  # weights away from the N(0, 0.02) init (tests/test_torch_baselines.py)
        rng = np.random.default_rng(seed)
        jparams = jax.tree.map(
            lambda a: a + (0.15 * rng.standard_normal(a.shape)).astype(np.float32), jparams)
    model = get_model(name)(Config(model=name, config_dict=cfg), N_ITEMS, T, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))
    return jmodel, jparams, model


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    lens = np.array([1, T, 5, 9, 3, 12], np.int32)
    seq = np.zeros((len(lens), T), np.int32)
    for i, n in enumerate(lens):
        seq[i, :n] = rng.integers(1, N_ITEMS, n)
    return {"item_seq": seq, "item_seq_len": lens,
            "pos_item": rng.integers(1, N_ITEMS, len(lens)).astype(np.int32),
            "neg_item": rng.integers(1, N_ITEMS, len(lens)).astype(np.int32),
            "weight": np.array([1, 1, 1, 1, 1, 0], np.float32)}  # a padded row


def _check_grads(model, jgrads):
    want = params_from_jax(jax.tree.map(np.asarray, jgrads))
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    top = max(float(v.abs().max()) for v in want.values())
    for name, p in got.items():
        w = want[name].numpy()
        atol = max(1e-5 * float(np.abs(w).max()), 1e-6 * top)
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4, atol=atol, err_msg=name)


def test_bpr_loss_matches_jax():
    rng = np.random.default_rng(1)
    pos, neg = (rng.standard_normal(64).astype(np.float32) * 12 for _ in range(2))
    w = (rng.random(64) > 0.2).astype(np.float32)
    for weights in (None, w):
        want = JB.bpr_loss(jnp.asarray(pos), jnp.asarray(neg),
                           None if weights is None else jnp.asarray(weights))
        got = B.bpr_loss(torch.from_numpy(pos), torch.from_numpy(neg),
                         None if weights is None else torch.from_numpy(weights))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # the gamma bounds a hopeless pair's loss at -log(1e-10)
    far = B.bpr_loss(torch.tensor([-200.0]), torch.tensor([200.0]))
    np.testing.assert_allclose(float(far), -np.log(1e-10), rtol=1e-5)


@pytest.mark.parametrize("impl", ["always", "never"])
def test_recblr_bpr_loss_and_grads_match_jax(impl):
    cfg = dict(RECBLR, use_pallas_scan=impl)
    jmodel, jparams, model = _pair("RecBLR", cfg)
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want, jgrads = jax.value_and_grad(
        lambda p: jmodel.calculate_loss(p, jbatch, jax.random.PRNGKey(1)))(jparams)
    model.train()
    loss = model.calculate_loss({k: torch.from_numpy(v) for k, v in batch.items()}, step=0)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    _check_grads(model, jgrads)


def test_sasrec_bpr_loss_and_grads_match_jax(dispatch):
    jmodel, jparams, model = _pair("SASRec", BASELINE, seed=3, perturb=True)
    batch = _batch(2)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want, jgrads = jax.value_and_grad(
        lambda p: jmodel.calculate_loss(p, jbatch, jax.random.PRNGKey(1)))(jparams)
    model.train()
    loss = model.calculate_loss({k: torch.from_numpy(v) for k, v in batch.items()}, step=0)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    _check_grads(model, jgrads)


def _replay_b4r(jmodel, key, seq):
    """The JAX BERT4Rec's draws in ``calculate_loss(params, batch, key)``:
    split(key, 4) -> the cloze positions from k_mask, the negatives
    randint(k_neg, [B, mask_len], 1, n_items); as the port's
    ``(masked_seq, order, sel_tgt, sel_valid)`` and ``neg``."""
    b, t = seq.shape
    mask_len = max(1, int(jmodel.mask_ratio * t))
    _, k_mask, _, k_neg = jax.random.split(key, 4)
    want = np.asarray(jax.random.bernoulli(k_mask, jmodel.mask_ratio, seq.shape)) & (seq != 0)
    cloze = want & (np.cumsum(want, axis=1) <= mask_len)
    order = np.zeros((b, mask_len), np.int64)
    tgt = np.zeros((b, mask_len), np.int64)
    for i in range(b):
        pos = np.nonzero(cloze[i])[0]
        order[i, : len(pos)] = pos
        tgt[i, : len(pos)] = seq[i, pos]
    valid = np.arange(mask_len)[None, :] < cloze.sum(1)[:, None]
    masked = np.where(cloze, jmodel.mask_token, seq).astype(np.int64)
    neg = np.asarray(jax.random.randint(k_neg, (b, mask_len), 1, jmodel.n_items))
    return (tuple(torch.from_numpy(a) for a in (masked, order, tgt, valid)),
            torch.from_numpy(neg.astype(np.int64)))


B4R = dict(BASELINE, mask_ratio=0.4)


def test_bert4rec_bpr_loss_and_grads_match_jax(dispatch):
    jmodel, jparams, model = _pair("BERT4Rec", B4R, seed=8, perturb=True)
    batch = _batch(9)
    jbatch = {k: jnp.asarray(batch[k]) for k in ("item_seq", "item_seq_len", "weight")}
    key = jax.random.PRNGKey(5)
    want, jgrads = jax.value_and_grad(lambda p: jmodel.calculate_loss(p, jbatch, key))(jparams)
    cloze, neg = _replay_b4r(jmodel, key, batch["item_seq"])
    assert int(cloze[3].sum()) > 3
    model.train()
    loss = model.cloze_loss({"weight": torch.from_numpy(batch["weight"])}, cloze, step=0,
                            neg=neg)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    _check_grads(model, jgrads)


def test_bert4rec_neg_draw():
    """The port's own negatives: uniform in [1, n_items), a function of
    (config seed, step) alone, apart from the cloze draw."""
    model = get_model("BERT4Rec")(Config(model="BERT4Rec", config_dict=B4R), N_ITEMS, T,
                                  device="cpu")
    a = model.neg_draw(400, 4, 7)
    assert a.shape == (400, 4) and a.dtype == torch.int64
    assert int(a.min()) >= 1 and int(a.max()) < N_ITEMS
    assert torch.equal(a, model.neg_draw(400, 4, 7)) and not torch.equal(a, model.neg_draw(400, 4, 8))
    counts = torch.bincount(a.reshape(-1), minlength=N_ITEMS)[1:].float()
    assert float(counts.std() / counts.mean()) < 0.25  # 1,600 draws over 49 ids
    assert model.neg_seed(7) != model.cloze_seed(7)
    batch = {k: torch.from_numpy(v) for k, v in _batch(4).items()}
    model.train()
    loss = model.calculate_loss(batch, step=3)
    loss.backward()
    assert torch.isfinite(loss) and model.output_bias.grad.abs().sum() > 0


def test_recblr_bpr_trajectory_matches_jax():
    """Ten Adam steps with the same negatives from the same parameters."""
    cfg = dict(RECBLR, use_pallas_scan="always")
    jmodel, jparams, model = _pair("RecBLR", cfg, seed=4)
    jopt = j_build_optimizer(JConfig(model="RecBLR", config_dict=cfg))
    opt = build_optimizer(Config(model="RecBLR", config_dict=cfg), model.parameters())
    jstate = jopt.init(jparams)

    @jax.jit
    def step(params, state, batch):
        loss, grads = jax.value_and_grad(
            lambda p: jmodel.calculate_loss(p, batch, jax.random.PRNGKey(0)))(params)
        updates, state = jopt.update(grads, state, params)
        return jax.tree.map(lambda p, u: p + u, params, updates), state, loss

    theirs, ours = [], []
    model.train()
    for s in range(10):
        batch = _batch(20 + s)
        jparams, jstate, jl = step(jparams, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        theirs.append(float(jl))
        opt.zero_grad(set_to_none=True)
        loss = model.calculate_loss({k: torch.from_numpy(v) for k, v in batch.items()}, step=s)
        loss.backward()
        opt.step()
        ours.append(float(loss.detach()))
    np.testing.assert_allclose(ours, theirs, rtol=2e-4, atol=5e-5)
    np.testing.assert_allclose(model.item_embedding.detach().numpy(),
                               np.asarray(jparams["item_embedding"]), rtol=1e-3, atol=2e-4)


def test_bpr_fit_matches_jax(tmp_path):
    """Two epochs of ``Trainer.fit`` under BPR: the port draws the JAX
    trainer's negatives from the same (seed, epoch) generator, so the
    epoch losses and the validation agree."""
    gen = dict(n_users=60, n_items=30, min_len=5, max_len=14, markov_weight=0.9,
               n_clusters=4, seed=5)
    jdata = j_build(j_generate(**gen), max_seq_len=T)
    data = build_from_dataframe(generate_synthetic_interactions(**gen), max_seq_len=T)
    cfg = dict(RECBLR, use_pallas_scan="never", epochs=2, train_batch_size=64,
               eval_batch_size=64, stopping_step=10, checkpoint_dir=str(tmp_path / "saved"),
               dataset="syn")
    jmodel = j_get_model("RecBLR")(JConfig(model="RecBLR", config_dict=cfg), jdata.n_items, T)
    jparams = jmodel.init_params(jax.random.PRNGKey(3))
    start = params_from_jax(jax.tree.map(np.asarray, jparams))
    jtrainer = JTrainer(JConfig(model="RecBLR", config_dict=cfg), jmodel, params=jparams)
    _, jresult = jtrainer.fit(jdata)
    model = get_model("RecBLR")(Config(model="RecBLR", config_dict=cfg), data.n_items, T,
                                device="cpu")
    trainer = Trainer(Config(model="RecBLR", config_dict=cfg), model, params=start)
    _, result = trainer.fit(data)
    want = [r["train_loss"] for r in jtrainer.metrics.epoch_records()]
    got = [r["train_loss"] for r in trainer.metrics.epoch_records()]
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=5e-5)
    for k in jresult:
        assert abs(result[k] - jresult[k]) <= 1e-3, k


def test_trainer_negatives_avoid_the_positive():
    model = get_model("RecBLR")(Config(model="RecBLR", config_dict=RECBLR), 4, T, device="cpu")
    trainer = Trainer(Config(model="RecBLR", config_dict=RECBLR), model)
    pos = np.full(2000, 2, np.int32)
    neg = trainer.negatives(np.random.default_rng(0), pos)
    # 1/3 of first draws collide; four rounds leave (1/3)^5 of them
    assert neg.min() >= 1 and neg.max() < 4 and int((neg == pos).sum()) <= 20


def test_unknown_loss_raises():
    model = get_model("RecBLR")(Config(model="RecBLR", config_dict=dict(RECBLR, loss_type="X")),
                                N_ITEMS, T, device="cpu")
    with pytest.raises(ValueError, match="unknown loss_type"):
        model.calculate_loss({k: torch.from_numpy(v) for k, v in _batch().items()})
