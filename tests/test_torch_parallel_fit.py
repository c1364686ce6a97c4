"""``Trainer.fit``, the evaluator, checkpoints and ``Recommender`` on a
``{data: 2, model: 2}`` mesh of four gloo ranks (``tests/torch_mesh_worker.py``)
against the same calls unmeshed, in this process, on the CPU.

RecBLR (hidden 16, one layer, T 16) on the synthetic data of the JAX
package's mesh-trainer tests (120 users, 62 items), batch 128 (64 a data
rank), 3 epochs, the table row-sharded (``vocab_row_shard: always``),
the port's default composition.  At dropout 0:
* the meshed trajectory (train loss and valid NDCG@10 each epoch)
  against the unmeshed one, at the trajectory tolerance (rtol 2e-4 /
  atol 5e-5, ``tests/test_trajectory_parity.py``), and the best
  checkpoint's test metrics within 1e-3;
* ``mesh_input: stream`` equal to ``resident`` bit for bit (the same
  rows reach each rank);
* uni20 sampled evaluation from the initial parameters equal to the
  unmeshed one (the candidates drawn for the global batch), rtol 1e-6;
* the meshed best checkpoint is the file an unmeshed run reads: an
  unmeshed ``Recommender.from_checkpoint`` recommends the ids the meshed
  ``Recommender`` does, and the meshed one from the same file too; and a
  meshed run resumed from it replays the uninterrupted run bit for bit.
At dropout 0.2: two runs from one seed equal bit for bit, and the
training forward's masks differ between data ranks and agree within a
model group."""

import numpy as np
import pytest
import torch

from datamining_recblr_torch.config import Config
from datamining_recblr_torch.data.dataset import build_from_dataframe
from datamining_recblr_torch.data.synthetic import generate_synthetic_interactions
from datamining_recblr_torch.eval.evaluator import Evaluator
from datamining_recblr_torch.models import get_model
from datamining_recblr_torch.serve import Recommender
from datamining_recblr_torch.train.trainer import Trainer
from torch_mesh_worker import launch

T = 16
MESH = {"data": 2, "model": 2}
DATA = dict(n_users=120, n_items=62, min_len=8, max_len=20, markov_weight=0.9, seed=31)
CFG = {"hidden_size": 16, "num_layers": 1, "epochs": 3, "train_batch_size": 128,
       "eval_batch_size": 256, "MAX_ITEM_LIST_LENGTH": T, "dataset": "synthetic",
       "dropout_prob": 0.0, "vocab_row_shard": "always"}
USERS = [[1, 2, 3], [], list(range(1, 40)), [5, 5, 7, 9, 11, 13]]


@pytest.fixture(scope="module")
def data():
    return build_from_dataframe(generate_synthetic_interactions(**DATA), max_seq_len=T)


@pytest.fixture(scope="module")
def meshed(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fit")
    mcfg = dict(CFG, mesh_shape=MESH, checkpoint_dir=str(tmp / "saved"))
    job = {"cases": [
        ("resident", "fit", dict(cfg=mcfg, data_args=DATA, t=T, ckpt=str(tmp / "res"),
                                 sampled="uni20", recommend=USERS)),
        ("stream", "fit", dict(cfg=dict(mcfg, mesh_input="stream"), data_args=DATA, t=T,
                               ckpt=str(tmp / "stream"))),
        ("dropout", "fit", dict(cfg=dict(mcfg, dropout_prob=0.2, epochs=2), data_args=DATA,
                                t=T, ckpt=str(tmp / "drop"), repeat=2)),
        ("resume", "fit", dict(cfg=dict(mcfg, epochs=2), data_args=DATA, t=T,
                               ckpt=str(tmp / "resume"), resume_epochs=3)),
    ]}
    return launch(job, 4, tmp / "ranks")


@pytest.fixture(scope="module")
def unmeshed(data, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fit1")
    cfg = Config(model="RecBLR", config_dict=dict(CFG, checkpoint_dir=str(tmp)))
    model = get_model("RecBLR")(cfg, data.n_items, T, device="cpu")
    scfg = Config(model="RecBLR", config_dict=dict(CFG, eval_args={"mode": "uni20"}))
    sampled = Evaluator(model, scfg).evaluate(data.test)
    trainer = Trainer(cfg, model)
    trainer.fit(data, checkpoint_path=str(tmp / "single"))
    runs = [{k: r[k] for k in ("train_loss", "valid_score")}
            for r in trainer.metrics.epoch_records()]
    return {"runs": runs, "test": trainer.evaluate(data.test, load_best=True),
            "sampled": sampled, "cfg": cfg}


def _trajectory(runs):
    return np.array([[r["train_loss"], r["valid_score"]] for r in runs])


def test_meshed_fit_matches_the_unmeshed_one(meshed, unmeshed):
    want = _trajectory(unmeshed["runs"])
    for res in meshed:
        np.testing.assert_allclose(_trajectory(res["resident"]["runs"][0]), want,
                                   rtol=2e-4, atol=5e-5)
        for k, v in unmeshed["test"].items():
            assert abs(res["resident"]["test"][k] - v) <= 1e-3, k
    assert want[-1, 0] < want[0, 0]  # it trains


def test_stream_equals_resident(meshed):
    for res in meshed:
        assert res["stream"]["runs"] == res["resident"]["runs"]
        assert res["stream"]["test"] == res["resident"]["test"]


def test_every_rank_reports_the_global_numbers(meshed):
    for res in meshed[1:]:
        for case in ("resident", "dropout"):
            assert res[case]["runs"] == meshed[0][case]["runs"]
            assert res[case]["test"] == meshed[0][case]["test"]


def test_meshed_sampled_evaluation_matches_the_unmeshed_one(meshed, unmeshed):
    for res in meshed:
        got = res["resident"]["sampled"]
        assert set(got) == set(unmeshed["sampled"])
        for k, v in unmeshed["sampled"].items():
            np.testing.assert_allclose(got[k], v, rtol=1e-6, err_msg=k)


def test_a_meshed_checkpoint_serves_unmeshed(meshed, unmeshed, data):
    state = torch.load(meshed[0]["resident"]["ckpt"], weights_only=True)
    assert state["params"]["item_embedding"].shape == (data.n_items, 16)  # unmeshed rows
    assert state["opt_state"]["state"][0]["exp_avg"].shape == (data.n_items, 16)
    rec = Recommender.from_checkpoint(meshed[0]["resident"]["ckpt"], unmeshed["cfg"],
                                      data.n_items, T, top_k=5, device="cpu")
    ids, vals = rec.recommend(USERS)
    for res in meshed:
        for key in ("recommend", "recommend_ckpt"):
            got_ids, got_vals = res["resident"][key]
            np.testing.assert_array_equal(got_ids, ids)
            np.testing.assert_allclose(got_vals, vals, rtol=1e-5, atol=1e-6)


def test_a_meshed_run_resumes_from_its_checkpoint(meshed):
    """A 2-epoch run's best checkpoint (parameters and Adam's moments
    gathered, then sharded again) resumed to 3 epochs replays the 3-epoch
    run's later epochs bit for bit."""
    for res in meshed:
        best = res["resume"]["best_epoch"]
        resumed = res["resume"]["resumed"]
        assert [r["epoch"] for r in resumed] == list(range(best + 1, 3))
        full = res["resident"]["runs"][0]
        for r in resumed:
            assert {k: r[k] for k in ("train_loss", "valid_score")} == full[r["epoch"]]


def test_two_runs_from_one_seed_are_equal(meshed):
    for res in meshed:
        first, second = res["dropout"]["runs"]
        assert first == second
        assert first != res["resident"]["runs"][0][:2]  # dropout was on


@pytest.fixture(scope="module")
def masks(tmp_path_factory):
    rng = np.random.default_rng(4)
    lens = rng.integers(1, 9, 4).astype(np.int32)
    seq = np.where(np.arange(8)[None] < lens[:, None], rng.integers(1, 30, (4, 8)), 0)
    # both data ranks get the same four rows
    batch = {"item_seq": np.concatenate([seq, seq]).astype(np.int32),
             "item_seq_len": np.concatenate([lens, lens])}
    cases = [(name, "masks", dict(name=name, cfg=cfg, n_items=30, t=8, batch=batch,
                                  mesh_shape=MESH, step_idx=3))
             for name, cfg in (("RecBLR", {"hidden_size": 16, "MAX_ITEM_LIST_LENGTH": 8,
                                           "dropout_prob": 0.3, "vocab_row_shard": "always"}),
                               ("SASRec", {"hidden_size": 16, "inner_size": 32,
                                           "MAX_ITEM_LIST_LENGTH": 8, "n_layers": 2,
                                           "n_heads": 2, "hidden_dropout_prob": 0.3,
                                           "attn_dropout_prob": 0.3}))]
    return launch({"cases": cases}, 4, tmp_path_factory.mktemp("masks"))


@pytest.mark.parametrize("name", ["RecBLR", "SASRec"])
def test_data_ranks_draw_their_own_masks(masks, name):
    by = {r[name]["coords"]: r[name]["out"] for r in masks}
    for (d, m), (a, b) in by.items():
        assert torch.equal(a, b)  # one rank, two calls
        assert torch.equal(a, by[(d, 1 - m)][0])  # model ranks of one data index
    assert not torch.equal(by[(0, 0)][0], by[(1, 0)][0])  # the same rows, other masks
