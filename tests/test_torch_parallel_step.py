"""The port's sharded train step (``Trainer.train_step`` on a meshed
``Trainer``) against the JAX package's ``make_sharded_train_step`` on a
``{data: 2, model: 2}`` mesh, on the
CPU: RecBLR, SASRec and BERT4Rec under CE and RecBLR under BPR, each
with the item table row-sharded (``vocab_row_shard: always``), from the
same parameters (``interop.params_from_jax``) on the same global batch of
8 rows, 3 of them padded at weight 0 (1 of one data rank's 4, 3 of the
other's).  The port runs on four gloo ranks (``tests/torch_mesh_worker.py``),
JAX on four of its eight virtual CPU devices.  Beside each step, the
full-sort metric sums of the batch from the same parameters through the
port's ``Evaluator`` (each rank's rows, summed over ``data``) and JAX's
``make_sharded_eval_step``.

Both sides at fp32 and dropout 0, on the same composition as the
unmeshed comparisons' "never" / unfused cases (``tests/test_torch_train.py``,
``tests/test_torch_baselines.py``); BERT4Rec's cloze draw is JAX's,
replayed on the host and injected.  Vocabularies: 41 items (RecBLR,
SASRec: 42 rows, a padded column on the second shard) and 40 (BERT4Rec:
a 42-row table holding the mask token, and a 40-row bias whose shards
are not the table's).  Tolerances: the loss rtol 1e-5; the gradients,
the sharded ones put back together, rtol 1e-4 and atol 1e-5 of each
one's largest value, at least 1e-6 of the largest of all (as the
unmeshed tests)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datamining_recblr_tpu.config import Config as JConfig
from datamining_recblr_tpu.models import get_model as j_get_model
from datamining_recblr_tpu.parallel import (
    make_mesh,
    make_sharded_eval_step,
    make_sharded_train_step,
    shard_batch,
)
from datamining_recblr_tpu.parallel.sharding import shard_params
from datamining_recblr_tpu.train.optim import build_optimizer
from datamining_recblr_torch.interop import params_from_jax
from torch_mesh_worker import launch

T, B = 10, 8
MESH = {"data": 2, "model": 2}
BASE = {"hidden_size": 16, "MAX_ITEM_LIST_LENGTH": T, "vocab_row_shard": "always",
        "learning_rate": 0.01}
CASES = {
    "RecBLR": ("RecBLR", 41, dict(BASE, num_layers=2, dropout_prob=0.0,
                                  use_pallas_scan="never")),
    "SASRec": ("SASRec", 41, dict(BASE, inner_size=32, n_layers=2, n_heads=2,
                                  hidden_dropout_prob=0.0, attn_dropout_prob=0.0)),
    "BERT4Rec": ("BERT4Rec", 40, dict(BASE, inner_size=32, n_layers=2, n_heads=2,
                                      mask_ratio=0.4, hidden_dropout_prob=0.0,
                                      attn_dropout_prob=0.0)),
    "BPR": ("RecBLR", 41, dict(BASE, num_layers=2, dropout_prob=0.0,
                               use_pallas_scan="never", loss_type="BPR")),
}


def _batch(n_items, seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, T + 1, B).astype(np.int32)
    lens[:2] = [1, T]
    seq = np.where(np.arange(T)[None] < lens[:, None], rng.integers(1, n_items, (B, T)), 0)
    return {"item_seq": seq.astype(np.int32), "item_seq_len": lens,
            "pos_item": rng.integers(1, n_items, B).astype(np.int32),
            "neg_item": rng.integers(1, n_items, B).astype(np.int32),
            "weight": np.array([1, 1, 1, 1, 1, 0, 0, 0], np.float32)}


def _replay_cloze(jmodel, key, seq, lens):
    """The JAX model's cloze draw of ``calculate_loss(params, batch, key)``
    as the port's ``(masked_seq, order, sel_tgt, sel_valid)``
    (``tests/test_torch_baselines.py``)."""
    b, t = seq.shape
    mask_len = max(1, int(jmodel.mask_ratio * t))
    _, k_mask, _, _ = jax.random.split(key, 4)
    want = np.asarray(jax.random.bernoulli(k_mask, jmodel.mask_ratio, seq.shape)) & (seq != 0)
    cloze = want & (np.cumsum(want, axis=1) <= mask_len)
    order = np.zeros((b, mask_len), np.int64)
    tgt = np.zeros((b, mask_len), np.int64)
    for i in range(b):
        pos = np.nonzero(cloze[i])[0]
        order[i, : len(pos)] = pos
        tgt[i, : len(pos)] = seq[i, pos]
    valid = np.arange(mask_len)[None, :] < cloze.sum(1)[:, None]
    return np.where(cloze, jmodel.mask_token, seq).astype(np.int64), order, tgt, valid


def _jax_step(name, n_items, cfg, seed):
    """JAX's sharded step from perturbed parameters: (parameters, batch,
    loss of make_sharded_train_step, gradients of its loss, cloze draw,
    make_sharded_eval_step's metric sums of the batch)."""
    jcfg = JConfig(model=name, config_dict=dict(cfg, mesh_shape=MESH))
    model = j_get_model(name)(jcfg, n_items, T)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: np.asarray(a) + (0.15 * rng.standard_normal(a.shape)).astype(np.float32),
        model.init_params(jax.random.PRNGKey(seed)))
    batch = _batch(n_items, seed + 1)
    if cfg.get("loss_type") != "BPR":
        batch.pop("neg_item")
    mesh = make_mesh(MESH, devices=jax.devices()[:4])
    sparams = shard_params(jax.tree.map(jnp.asarray, params), mesh, "always")
    sbatch = shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh)
    base = jax.random.PRNGKey(seed + 2)
    key = jax.random.fold_in(base, 0)
    grads = jax.jit(jax.grad(lambda p: model.calculate_loss(p, sbatch, key)))(sparams)
    grads = jax.tree.map(np.asarray, grads)
    sums = make_sharded_eval_step(model, mesh, ["hit", "ndcg"], [5])(
        sparams, sbatch["item_seq"], sbatch["item_seq_len"], sbatch["pos_item"],
        sbatch["weight"])
    sums = {k: (float(a), float(b)) for k, (a, b) in sums.items()}
    opt = build_optimizer(jcfg)
    step = make_sharded_train_step(model, opt, base)
    _, _, loss = step(sparams, opt.init(sparams), sbatch, 0)
    assert sparams["item_embedding"].sharding.spec[0] == "model"
    cloze = _replay_cloze(model, key, batch["item_seq"], batch["item_seq_len"]) \
        if name == "BERT4Rec" else None
    return params, batch, float(loss), grads, cloze, sums


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    jax_side, cases = {}, []
    for i, (case, (name, n_items, cfg)) in enumerate(CASES.items()):
        params, batch, loss, grads, cloze, sums = _jax_step(name, n_items, cfg, 20 + 3 * i)
        jax_side[case] = (loss, params_from_jax(grads), sums)
        cases.append((case, "step", dict(
            name=name, cfg=cfg, n_items=n_items, t=T, params=params_from_jax(params),
            batch=batch, mesh_shape=MESH, cloze=cloze, unfused=name != "RecBLR")))
    ranks = launch({"cases": cases}, 4, tmp_path_factory.mktemp("steps"))
    return jax_side, ranks


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_loss_matches_jax(steps, case):
    jax_side, ranks = steps
    for res in ranks:
        np.testing.assert_allclose(res[case]["losses"][0], jax_side[case][0], rtol=1e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_gradients_match_jax(steps, case):
    jax_side, ranks = steps
    want = jax_side[case][1]
    top = max(float(v.abs().max()) for v in want.values())
    for res in ranks:
        got = res[case]["grads"]
        assert set(got) == set(want)
        for name, w in want.items():
            w = w.numpy()
            atol = max(1e-5 * float(np.abs(w).max()), 1e-6 * top)
            np.testing.assert_allclose(got[name].numpy(), w, rtol=1e-4, atol=atol,
                                       err_msg=f"{case} {name} rank {res[case]['coords']}")


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_eval_step_matches_jax(steps, case):
    """The meshed ``Evaluator``'s full-sort hit@5 / ndcg@5 sums of the
    batch from the initial parameters, the same on every rank as JAX's
    ``make_sharded_eval_step``'s
    (ranks exact: the sums agree to rtol 1e-6; BERT4Rec's scores add its
    output bias)."""
    jax_side, ranks = steps
    want = jax_side[case][2]
    assert set(want) == {"hit@5", "ndcg@5"}
    for res in ranks:
        got = res[case]["eval_sums"]
        assert set(got) == set(want)
        for k, (sv, wv) in want.items():
            np.testing.assert_allclose(got[k], (sv, wv), rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_the_table_is_row_sharded_and_the_towers_replicated(steps, case):
    """Each model rank holds half the table's rows (BERT4Rec's bias its own
    half of 40); the gradients of every rank agree bit for bit, as the
    replicated parameters must stay equal across ranks."""
    _, ranks = steps
    n_rows = CASES[case][1] + (2 if case == "BERT4Rec" else 1)  # 42 table rows
    for res in ranks:
        m = res[case]["coords"][1]
        shards = res[case]["shards"]
        assert shards["item_embedding"] == (m * n_rows // 2, (m + 1) * n_rows // 2)
        if case == "BERT4Rec":
            assert shards["output_bias"] == (20 * m, 20 * (m + 1))
        assert set(shards) == ({"item_embedding", "output_bias"} if case == "BERT4Rec"
                               else {"item_embedding"})
        for name, g in res[case]["grads"].items():
            assert torch.equal(g, ranks[0][case]["grads"][name]), name
