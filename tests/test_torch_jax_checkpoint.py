"""The port reads the JAX package's checkpoints (``train/jax_checkpoint.py``,
``train.optim.opt_state_from_jax``, ``convert_checkpoint``), on the CPU.

The JAX package writes each checkpoint in both of its formats, an orbax
directory and its pickle fallback (orbax made unimportable, as
``tests/test_trainer_extras.py`` forces it), into ``tmp_path``:
* RecBLR (hidden 16, 2 layers, T 12, dropout 0) fitted one epoch by the
  JAX ``Trainer`` with each learner (adam, adam with a weight decay,
  adamw, sgd, adagrad, rmsprop): the converted parameters and optimizer
  state equal the JAX package's restored ones bit for bit, and the
  port's ``Trainer.resume_from`` plus one epoch gives the loss of JAX's
  ``resume_from`` plus one epoch (trajectory tolerance, rtol 2e-4 /
  atol 5e-5, as ``tests/test_torch_train.py``);
* RecBLR, SASRec and BERT4Rec parameters, a bf16 RecBLR, and RecBLR at
  the bench width (hidden 64, 2 layers, V 3,417, T 50): the parameters
  bit for bit, and ``Recommender.from_checkpoint`` on the CPU gives JAX's
  ids exactly and its scores within 1e-5 (fp32);
* an orbax save under a ``{data: 2, model: 4}`` mesh on the 8 virtual CPU
  devices (the table row-sharded, its rows padded to 4): read whole, bit
  for bit, served by an unmeshed port model with its own padding, and
  resumed by a meshed port Trainer (two gloo ranks, ``{data: 1, model:
  2}``), whose moments equal the checkpoint's;
* the fixture ``tests/fixtures/jax_checkpoint/`` (written by
  ``tests/make_jax_checkpoint_fixture.py``): its ``expected.npz`` still
  holds for the JAX package, and the port serves and resumes it alike.
Reading a ``.pkl`` imports neither jax, optax nor ml_dtypes; a pickle
naming any other global is refused."""

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import make_jax_checkpoint_fixture as FX
from datamining_recblr_tpu.config import Config as JConfig
from datamining_recblr_tpu.data.dataset import build_from_dataframe as j_build
from datamining_recblr_tpu.data.synthetic import (
    generate_synthetic_interactions as j_generate,
)
from datamining_recblr_tpu.models import get_model as j_get_model
from datamining_recblr_tpu.models import layers as JL
from datamining_recblr_tpu.serve import Recommender as JRecommender
from datamining_recblr_tpu.train import Trainer as JTrainer
from datamining_recblr_tpu.train.checkpoint import restore_checkpoint as j_restore
from datamining_recblr_tpu.train.checkpoint import save_checkpoint as j_save
from datamining_recblr_torch import convert_checkpoint
from datamining_recblr_torch.config import Config
from datamining_recblr_torch.data.dataset import build_from_dataframe
from datamining_recblr_torch.data.synthetic import generate_synthetic_interactions
from datamining_recblr_torch.interop import params_from_jax
from datamining_recblr_torch.models import get_model
from datamining_recblr_torch.models import layers as L
from datamining_recblr_torch.serve import Recommender
from datamining_recblr_torch.train.checkpoint import restore_checkpoint
from datamining_recblr_torch.train.jax_checkpoint import load_pickle, read_jax_checkpoint
from datamining_recblr_torch.train.optim import opt_state_from_jax
from datamining_recblr_torch.train.trainer import Trainer
from torch_mesh_worker import launch

ROOT = Path(__file__).resolve().parents[1]
T = 12
GEN = dict(n_users=60, n_items=30, min_len=5, max_len=14, markov_weight=0.9, n_clusters=4,
           seed=5)
RECBLR = {"hidden_size": 16, "num_layers": 2, "MAX_ITEM_LIST_LENGTH": T, "dropout_prob": 0.0,
          "train_batch_size": 64, "eval_batch_size": 64, "stopping_step": 10,
          "dataset": "syn", "use_pallas_scan": "never"}
LEARNERS = {"adam": {"learner": "adam"}, "adam-wd": {"learner": "adam", "weight_decay": 0.01},
            "adamw": {"learner": "adamw", "weight_decay": 0.01}, "sgd": {"learner": "sgd"},
            "adagrad": {"learner": "adagrad"}, "rmsprop": {"learner": "rmsprop"}}
FORMATS = ("pkl", "orbax")
USERS = [[], [3], [1, 2, 3, 4, 5], list(range(1, 29)), [7, 7, 9, 11], [2] * 3]


def _save_both(path, state) -> dict:
    """The JAX package's orbax save of ``state`` and its pickle fallback:
    {format: path written}."""
    out = {"orbax": j_save(str(path), state)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "orbax.checkpoint", None)
        out["pkl"] = j_save(str(path), state)
    assert out["orbax"].endswith(".orbax") and out["pkl"].endswith(".pkl")
    return out


def _jax_params(path):
    return params_from_jax(jax.tree.map(np.asarray, j_restore(path)["params"]))


def _assert_bits(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert torch.equal(got[k].view(torch.int16) if w.dtype == torch.bfloat16 else got[k],
                           w.view(torch.int16) if w.dtype == torch.bfloat16 else w), k


@pytest.fixture(scope="module")
def jdata():
    return j_build(j_generate(**GEN), max_seq_len=T)


@pytest.fixture(scope="module")
def data():
    return build_from_dataframe(generate_synthetic_interactions(**GEN), max_seq_len=T)


@pytest.fixture(scope="module")
def learner_runs(jdata, tmp_path_factory):
    """Per learner: the JAX fit's checkpoint in both formats, JAX's
    restored state, and the epoch-1 loss of JAX's resumed run."""
    runs = {}
    for name, over in LEARNERS.items():
        tmp = tmp_path_factory.mktemp(name)
        cfg = JConfig(model="RecBLR", config_dict=dict(RECBLR, **over, epochs=1,
                                                       checkpoint_dir=str(tmp)))
        trainer = JTrainer(cfg, j_get_model("RecBLR")(cfg, jdata.n_items, T))
        trainer.fit(jdata, checkpoint_path=str(tmp / "fit"))
        paths = _save_both(tmp / "ck", trainer._checkpoint_state(trainer.best_epoch))
        restored = jax.tree.map(np.asarray, j_restore(paths["pkl"]))
        # JAX's resume on the same trainer (its steps already compiled)
        trainer.metrics.records.clear()
        trainer.resume_from(paths["orbax"])
        trainer.epochs = 2
        trainer.fit(jdata, checkpoint_path=str(tmp / "resumed"))
        runs[name] = {"paths": paths, "restored": restored,
                      "losses": [r["train_loss"] for r in trainer.metrics.epoch_records()]}
    return runs


def _port_trainer(name, n_items, tmp, **extra):
    cfg = Config(model="RecBLR", config_dict=dict(RECBLR, **LEARNERS[name], epochs=2,
                                                  checkpoint_dir=str(tmp), **extra))
    return Trainer(cfg, get_model("RecBLR")(cfg, n_items, T, device="cpu"))


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", list(LEARNERS))
def test_learner_state_converts_bit_for_bit(name, fmt, learner_runs, data, tmp_path):
    run = learner_runs[name]
    state = read_jax_checkpoint(run["paths"][fmt])
    want = run["restored"]
    _assert_bits(state["params"], params_from_jax(want["params"]))
    assert (state["epoch"], state["best_epoch"]) == (int(want["epoch"]), int(want["best_epoch"]))
    assert state["best_score"] == float(want["best_score"])
    trainer = _port_trainer(name, data.n_items, tmp_path)
    mapped = opt_state_from_jax(trainer.model, trainer.optimizer, state["opt_state"])
    names = [n for n, _ in trainer.model.named_parameters()]
    jstates = [s for s in want["opt_state"] if hasattr(s, "_fields") and s._fields]
    if name == "sgd":
        assert mapped["state"] == {} and not jstates
        return
    (jstate,) = jstates
    fields = {"exp_avg": "mu", "exp_avg_sq": "nu"} if "mu" in jstate._fields else {
        "acc": jstate._fields[0]}
    for key, field in fields.items():
        tree = params_from_jax(getattr(jstate, field))
        _assert_bits({n: mapped["state"][i][key] for i, n in enumerate(names)}, tree)
    if "count" in jstate._fields:
        assert all(float(s["step"]) == float(jstate.count) > 0 for s in mapped["state"].values())


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", list(LEARNERS))
def test_resume_matches_the_jax_resumed_run(name, fmt, learner_runs, data, tmp_path):
    run = learner_runs[name]
    trainer = _port_trainer(name, data.n_items, tmp_path)
    trainer.resume_from(run["paths"][fmt])
    assert trainer.start_epoch == int(run["restored"]["epoch"]) + 1 == 1
    trainer.fit(data, checkpoint_path=str(tmp_path / "resumed"))
    got = [r["train_loss"] for r in trainer.metrics.epoch_records()]
    assert len(got) == len(run["losses"]) == 1
    np.testing.assert_allclose(got, run["losses"], rtol=2e-4, atol=5e-5)


BASE = {"MAX_ITEM_LIST_LENGTH": T, "hidden_size": 16, "inner_size": 32, "n_layers": 2,
        "n_heads": 2, "num_layers": 2}
SERVED = {
    "RecBLR": ("RecBLR", dict(BASE, use_pallas_scan="never"), 40, T),
    "SASRec": ("SASRec", BASE, 40, T),
    "BERT4Rec": ("BERT4Rec", BASE, 40, T),
    "RecBLR-bf16": ("RecBLR", dict(BASE, param_dtype="bfloat16", compute_dtype="bfloat16",
                                   use_pallas_scan="never"), 40, T),
    "RecBLR-bench": ("RecBLR", {"hidden_size": 64, "num_layers": 2, "MAX_ITEM_LIST_LENGTH": 50,
                                "use_pallas_scan": "never"}, 3417, 50),
}


def _served_case(case, tmp):
    """A JAX model's perturbed parameters (away from the init, so that
    every layer moves the scores) saved by the JAX trainer in both formats;
    (model name, config, n_items, T, paths, JAX model, JAX params)."""
    name, cfg, n_items, t = SERVED[case]
    jcfg = JConfig(model=name, config_dict=cfg)
    jmodel = j_get_model(name)(jcfg, n_items, t)
    params = jmodel.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: (np.asarray(a, np.float32) + 0.1 * rng.standard_normal(a.shape)).astype(
            a.dtype), params)
    trainer = JTrainer(jcfg, jmodel, params=jax.tree.map(jax.numpy.asarray, params))
    paths = _save_both(tmp / "ck", trainer._checkpoint_state(0))
    return name, cfg, n_items, t, paths, jmodel, params


@pytest.mark.parametrize("case", list(SERVED))
def test_models_convert_and_serve_like_jax(case, tmp_path, monkeypatch):
    monkeypatch.setattr(JL, "_use_fused_attention", lambda: False)
    monkeypatch.setattr(L, "FORCE_FUSED_ATTENTION", False)
    name, cfg, n_items, t, paths, jmodel, params = _served_case(case, tmp_path)
    want = _jax_params(paths["pkl"])
    for fmt in FORMATS:
        _assert_bits(read_jax_checkpoint(paths[fmt])["params"], want)
    if cfg.get("param_dtype") == "bfloat16":
        assert want["item_embedding"].dtype == torch.bfloat16
        return
    users = [[i % (n_items - 1) + 1 for i in u] for u in USERS] + [
        list(range(1, min(n_items, t + 9)))]
    jids, jvals = JRecommender.from_checkpoint(paths["pkl"], JConfig(model=name, config_dict=cfg),
                                               n_items, t, top_k=7).recommend(users)
    for fmt in FORMATS:
        rec = Recommender.from_checkpoint(paths[fmt], Config(model=name, config_dict=cfg),
                                          n_items, t, top_k=7, device="cpu")
        ids, vals = rec.recommend(users)
        np.testing.assert_array_equal(ids, np.asarray(jids))
        np.testing.assert_allclose(vals, np.asarray(jvals), rtol=0, atol=1e-5)


MESH = {"data": 2, "model": 4}


@pytest.fixture(scope="module")
def mesh_ckpt(tmp_path_factory, data):
    """RecBLR's state initialized sharded on {data: 2, model: 4} (the table
    row-sharded), moments and count set to distinct values, saved by orbax
    from the 8 devices."""
    tmp = tmp_path_factory.mktemp("mesh")
    cfg = JConfig(model="RecBLR", config_dict=dict(RECBLR, mesh_shape=MESH,
                                                   vocab_row_shard="always"))
    trainer = JTrainer(cfg, j_get_model("RecBLR")(cfg, data.n_items, T))
    assert len(trainer.params["item_embedding"].sharding.device_set) == 8
    adam = trainer.opt_state[0]
    trainer.opt_state = (adam._replace(
        count=adam.count + 3, mu=jax.tree.map(lambda p: 0.5 * p + 0.25, trainer.params),
        nu=jax.tree.map(lambda p: p * p + 1.0, trainer.params)),) + trainer.opt_state[1:]
    path = j_save(str(tmp / "ck"), trainer._checkpoint_state(0))
    rows = trainer.params["item_embedding"].shape[0]
    return {"path": path, "rows": rows, "restored": jax.tree.map(np.asarray, j_restore(path)),
            "tmp": tmp}


def test_a_mesh_sharded_orbax_save_reads_whole(mesh_ckpt, data):
    assert mesh_ckpt["rows"] % 4 == 0 and mesh_ckpt["rows"] > data.n_items
    state = read_jax_checkpoint(mesh_ckpt["path"])
    want = mesh_ckpt["restored"]
    _assert_bits(state["params"], params_from_jax(want["params"]))
    mu = state["opt_state"][0]["mu"]
    _assert_bits(params_from_jax(mu), params_from_jax(want["opt_state"][0]["mu"]))
    # served unmeshed at the port model's own rows, as JAX serves the cut table
    cfg = dict(RECBLR)
    jmodel = j_get_model("RecBLR")(JConfig(model="RecBLR", config_dict=cfg), data.n_items, T)
    jparams = dict(want["params"])
    jparams["item_embedding"] = jparams["item_embedding"][: jmodel.n_items_padded]
    jids, jvals = JRecommender(jmodel, jax.tree.map(jax.numpy.asarray, jparams),
                               top_k=7).recommend(USERS)
    rec = Recommender.from_checkpoint(mesh_ckpt["path"], Config(model="RecBLR", config_dict=cfg),
                                      data.n_items, T, top_k=7, device="cpu")
    assert rec.model.item_embedding.shape[0] == rec.model.n_items_padded < mesh_ckpt["rows"]
    ids, vals = rec.recommend(USERS)
    np.testing.assert_array_equal(ids, np.asarray(jids))
    np.testing.assert_allclose(vals, np.asarray(jvals), rtol=0, atol=1e-5)


def test_a_meshed_trainer_resumes_from_a_mesh_sharded_save(mesh_ckpt, data):
    """Two gloo ranks on {data: 1, model: 2}: each holds half the table's
    rows at its own padding, and its Adam moments are the checkpoint's
    rows of them."""
    cfg = dict(RECBLR, epochs=1, mesh_shape={"data": 1, "model": 2}, vocab_row_shard="always",
               checkpoint_dir=str(mesh_ckpt["tmp"] / "saved"))
    job = {"cases": [("resume", "resume_opt_state", dict(
        cfg=cfg, n_items=data.n_items, t=T, path=mesh_ckpt["path"]))]}
    ranks = launch(job, 2, mesh_ckpt["tmp"] / "ranks")
    want = mesh_ckpt["restored"]["opt_state"][0]
    mu = params_from_jax(want["mu"])["item_embedding"]
    rows = (data.n_items + 1) // 2 * 2
    for r, res in enumerate(ranks):
        got = res["resume"]
        assert got["start_epoch"] == 1 and got["step"] == float(want["count"]) == 3.0
        lo, hi = got["shards"]["item_embedding"]
        assert (lo, hi) == (r * rows // 2, (r + 1) * rows // 2)
        assert torch.equal(got["exp_avg"][: min(hi, len(mu)) - lo], mu[lo:min(hi, len(mu))])


def test_reading_a_pickle_imports_no_jax(learner_runs, tmp_path):
    """In a fresh interpreter, the bf16 and the fp32 pickles read (and a
    model serves one) without jax, optax or ml_dtypes."""
    bf16 = _served_case("RecBLR-bf16", tmp_path)[4]["pkl"]
    code = (
        "import sys\n"
        "from datamining_recblr_torch.train.checkpoint import restore_checkpoint\n"
        f"s = restore_checkpoint({bf16!r})\n"
        "assert str(s['params']['item_embedding'].dtype) == 'torch.bfloat16'\n"
        f"s = restore_checkpoint({learner_runs['adam']['paths']['pkl']!r})\n"
        "assert s['opt_state'][0]['count'] > 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'optax', 'ml_dtypes', "
        "'datamining_recblr_tpu')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120,
                   env=dict(os.environ, PYTHONPATH=str(ROOT)))


class _Evil:
    def __reduce__(self):
        return (os.system, ("echo pwned",))


@pytest.mark.parametrize("payload", [_Evil(), {"params": {"w": __import__("datetime").date(
    2020, 1, 1)}}, {"params": np.array([1, None], object)}], ids=["os.system", "date", "object"])
def test_a_pickle_naming_another_global_is_refused(payload, tmp_path):
    path = tmp_path / "ck.pkl"
    path.write_bytes(pickle.dumps(payload))
    with pytest.raises(pickle.UnpicklingError):
        load_pickle(str(path))


def test_convert_checkpoint_writes_a_pt_that_loads_equal(learner_runs, tmp_path, capsys):
    src = learner_runs["adam-wd"]["paths"]["orbax"]
    assert convert_checkpoint.main([src, str(tmp_path / "out")]) == 0
    dst = capsys.readouterr().out.strip()
    assert dst == str(tmp_path / "out.pt")
    want, got = read_jax_checkpoint(src), restore_checkpoint(dst)
    _assert_bits(got["params"], want["params"])
    assert [x is None for x in got["opt_state"]] == [True, False, True]
    for k in ("mu", "nu"):
        _assert_bits(params_from_jax(got["opt_state"][1][k]),
                     params_from_jax(want["opt_state"][1][k]))
    assert {k: got[k] for k in ("epoch", "best_score", "best_epoch")} == {
        k: want[k] for k in ("epoch", "best_score", "best_epoch")}


def test_an_orbax_read_without_tensorstore_names_the_converter(learner_runs, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(ImportError, match="convert_checkpoint"):
        read_jax_checkpoint(learner_runs["sgd"]["paths"]["orbax"])


@pytest.fixture(scope="module")
def fixture_expected():
    return dict(np.load(FX.FIXTURE / "expected.npz"))


def test_the_fixture_still_holds_for_the_jax_package(fixture_expected):
    e = fixture_expected
    got = FX.expected(FX.FIXTURE, {k: e[k] for k in ("item_seq", "item_seq_len", "pos_item",
                                                     "weight", "steps")})
    np.testing.assert_array_equal(got["ids"], e["ids"])
    np.testing.assert_allclose(got["scores"], e["scores"], rtol=1e-5, atol=0)
    np.testing.assert_allclose(got["losses"], e["losses"], rtol=1e-5, atol=0)
    assert (FX.FIXTURE / "recblr.pkl").stat().st_size < 3 * 2**20


def test_the_port_serves_and_resumes_the_fixture(fixture_expected):
    e = fixture_expected
    meta = json.loads((FX.FIXTURE / "config.json").read_text())
    # the port's own dispatch, the fused composition the card runs (the
    # fixture's "never" chose JAX's CPU path)
    cfg = Config(model="RecBLR", config_dict=dict(meta["config"], epochs=2,
                                                  use_pallas_scan="auto"))
    n_items, t = meta["n_items"], meta["config"]["MAX_ITEM_LIST_LENGTH"]
    ckpt = str(FX.FIXTURE / "recblr.pkl")
    rec = Recommender.from_checkpoint(ckpt, cfg, n_items, t, top_k=FX.TOP_K, device="cpu")
    assert rec.model.use_fused_layer()
    ids, vals = rec.recommend(FX.unpad(e["requests"], e["request_lens"]))
    np.testing.assert_array_equal(ids, e["ids"])
    np.testing.assert_allclose(vals, e["scores"], rtol=0, atol=1e-5)
    trainer = Trainer(cfg, get_model("RecBLR")(cfg, n_items, t, device="cpu"))
    trainer.resume_from(ckpt)
    losses = [float(trainer.train_step({k: torch.from_numpy(e[k][i]) for k in (
        "item_seq", "item_seq_len", "pos_item", "weight")}, int(s)))
        for i, s in enumerate(e["steps"])]
    np.testing.assert_allclose(losses, e["losses"], rtol=2e-4, atol=5e-5)
