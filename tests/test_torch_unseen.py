"""The port's cold-start pipeline (``datamining_recblr_torch/unseen``)
against the JAX package's on the CPU, on the same seeded data:

* ``prepare_data_split``: the same user sets and split files with the
  same bytes; the held-out users are the first ``round(n * test_size)``
  of the users in order of first appearance shuffled by
  ``RandomState(seed)``; a second call reuses the files;
* ``synthesize_item_features`` and ``load_item_text_features``: equal
  frames (ties in counts and ranks, values on every bin edge; text, empty
  and ``nan`` fields), and ``prepare_item_features`` writes the same CSV
  bytes;
* ``ItemSimilarity`` against the JAX one (sklearn): the TF-IDF matrix
  within 1e-12 of ``TfidfVectorizer``'s, the similarity matrix within
  1e-9, and ``nearest_valid`` equal for every token, except a token whose
  two best similarities differ by more than 0 and at most 1e-9 (counted;
  exact ties are broken alike, by the first valid item);
* ``build_unseen_split``: arrays and user counts equal, in both modes;
* ``run_unseen_experiment`` in both modes (dropout 0, fp32, the JAX
  initial parameters carried over): seen and unseen results within 1e-3
  (the fit tolerance of ``test_torch_experiment.py``), equal user counts,
  the same plot and CSV names; the held-out users are scored with the
  parameters of the last epoch, not the best checkpoint's; under popN
  both raise.

The JAX package's ``load_item_text_features`` picks text columns by
``dtype == object``, which pandas 3's string dtype is not (the function
then returns None); it runs here under ``future.infer_string = False``,
the object strings it was written for.
"""

import os
import shutil

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from datamining_recblr_tpu.config import Config as JConfig
from datamining_recblr_tpu.data.dataset import build_from_dataframe as j_build
from datamining_recblr_tpu.models import get_model as j_get_model
from datamining_recblr_tpu.unseen import features as JF
from datamining_recblr_tpu.unseen import pipeline as JP
from datamining_recblr_tpu.unseen import similarity as JS
from datamining_recblr_torch.config import Config
from datamining_recblr_torch.data.atomic import read_atomic_file
from datamining_recblr_torch.data.dataset import build_from_dataframe
from datamining_recblr_torch.data.synthetic import write_stat_matched_dataset
from datamining_recblr_torch.eval.evaluator import Evaluator
from datamining_recblr_torch.interop import params_from_jax
from datamining_recblr_torch.train.checkpoint import restore_checkpoint
from datamining_recblr_torch.unseen import features as F
from datamining_recblr_torch.unseen import pipeline as P
from datamining_recblr_torch.unseen import similarity as S

T = 12
FIELDS = ("user_id", "item_id", "timestamp")
# users 200, items 160: 40 held-out users at test_size 0.2, 26 of them
# with no unseen item in their history, 7 unseen items
COLD = dict(n_users=200, n_items=160, n_inters=2_200, n_clusters=8, min_len=5)


def _cfg(data_path, **extra):
    return {"dataset": "cold", "data_path": str(data_path), "hidden_size": 16,
            "num_layers": 2, "MAX_ITEM_LIST_LENGTH": T, "dropout_prob": 0.0,
            "use_pallas_scan": "always", "epochs": 2, "train_batch_size": 64,
            "eval_batch_size": 128, "user_inter_num_interval": "[5,inf)",
            "item_inter_num_interval": "[5,inf)", **extra}


@pytest.fixture(scope="module")
def cold(tmp_path_factory):
    """The written dataset, in a directory of its own for each package."""
    tmp = tmp_path_factory.mktemp("cold")
    write_stat_matched_dataset(str(tmp / "src"), "beauty-synth", out_name="cold", **COLD)
    return tmp


def _copy(cold, dest):
    shutil.copytree(cold / "src", dest)
    return dest


# ---------------------------------------------------------------------------
# the user split
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("test_size,seed", [(0.1, 42), (0.2, 42), (0.25, 7)])
def test_prepare_data_split_writes_the_jax_files(cold, tmp_path, test_size, seed):
    jdir, pdir = _copy(cold, tmp_path / "j"), _copy(cold, tmp_path / "p")
    jtrain, jtest = JP.prepare_data_split(JConfig(model="RecBLR", config_dict=_cfg(jdir)),
                                          test_size=test_size, seed=seed)
    cfg = Config(model="RecBLR", config_dict=_cfg(pdir))
    train, test = P.prepare_data_split(cfg, test_size=test_size, seed=seed)
    for name in ("cold_train.inter", "cold_test.inter"):
        assert (pdir / "cold" / name).read_bytes() == (jdir / "cold" / name).read_bytes()
    for got, want in ((train, jtrain), (test, jtest)):
        assert list(got) == list(want.columns)
        for c in FIELDS:
            np.testing.assert_array_equal(got[c], np.asarray(want[c]))
    assert set(test["user_id"].tolist()) == set(jtest["user_id"])
    assert not set(test["user_id"].tolist()) & set(train["user_id"].tolist())

    # the held-out users: the shuffle of the users in order of appearance
    inter = pd.DataFrame(read_atomic_file(str(pdir / "cold" / "cold.inter")))
    users = np.asarray(inter["user_id"].unique(), dtype=object)
    np.random.RandomState(seed).shuffle(users)
    n_test = max(1, int(round(len(users) * test_size)))
    assert set(test["user_id"].tolist()) == set(users[:n_test])

    # a second call reads the files back
    stamp = os.stat(pdir / "cold" / "cold_test.inter").st_mtime_ns
    train2, test2 = P.prepare_data_split(cfg, test_size=0.5, seed=seed + 1)
    assert os.stat(pdir / "cold" / "cold_test.inter").st_mtime_ns == stamp
    for got, want in ((train2, train), (test2, test)):
        for c in FIELDS:
            np.testing.assert_array_equal(got[c], want[c])


# ---------------------------------------------------------------------------
# item features
# ---------------------------------------------------------------------------

def _edges_frame():
    """Items whose counts sit on and beside every count edge (5, 20, 100),
    with distinct users on and beside 3, 10, 50, and tied counts (so tied
    and edge percentiles: 12 items, ranks 0.25 / 0.5 / 0.75 exactly)."""
    counts = [1, 5, 5, 6, 20, 21, 100, 101, 3, 3, 3, 4]
    spread = [1, 3, 4, 3, 10, 11, 50, 51, 2, 3, 3, 4]
    users, items = [], []
    for i, (c, s) in enumerate(zip(counts, spread)):
        users += [f"u{k % s}" for k in range(c)]
        items += [f"i{i:02d}"] * c
    return {"user_id": np.array(users), "item_id": np.array(items),
            "timestamp": np.arange(len(items), dtype=np.float64)}


@pytest.mark.parametrize("case", ["edges", "stat-matched"])
def test_synthesized_features_equal_jax(case, cold):
    if case == "edges":
        frame = _edges_frame()
    else:
        frame = read_atomic_file(str(cold / "src" / "cold" / "cold.inter"))
    want = JF.synthesize_item_features(pd.DataFrame(frame))
    got = F.synthesize_item_features(frame)
    np.testing.assert_array_equal(got["item_id"], np.asarray(want["item_id"], dtype=str))
    np.testing.assert_array_equal(got["description"],
                                  np.asarray(want["description"], dtype=str))
    if case == "edges":
        assert len(set(got["description"].tolist())) >= 8


ITEM_FILE = ("item_id:token\ttitle:token\tprice:float\tcategories:token_seq\tbrand:token\n"
             "i1\tRed leather shoe\t12.5\tshoes boots\tacme\n"
             "i2\t\t3\tnan\t\n"
             "i3\tnan\t4\tshirts\t  \n"
             "i4\tBlue, cotton \"shirt\"\t5\t\tacme\n")


@pytest.mark.parametrize("flat", [False, True], ids=["in_dir", "flat"])
def test_item_text_features_equal_jax(tmp_path, flat):
    path = tmp_path / ("d.item" if flat else "d/d.item")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(ITEM_FILE)
    got = F.load_item_text_features("d", str(tmp_path))
    with pd.option_context("future.infer_string", False):
        want = JF.load_item_text_features("d", str(tmp_path))
    assert got["description"].tolist() == list(want["description"])
    assert got["item_id"].tolist() == list(want["item_id"])
    assert got["description"].tolist()[1:3] == ["", "shirts"]
    assert F.load_item_text_features("missing", str(tmp_path)) is None


@pytest.mark.parametrize("source", ["inter", "item"])
def test_prepare_item_features_csv_bytes(cold, tmp_path, source):
    jdir, pdir = _copy(cold, tmp_path / "j"), _copy(cold, tmp_path / "p")
    if source == "item":
        for d in (jdir, pdir):
            (d / "cold" / "cold.item").write_text(ITEM_FILE)
    with pd.option_context("future.infer_string", False):
        JF.prepare_item_features("cold", str(jdir))
    feats = F.prepare_item_features("cold", str(pdir))
    name = "cold/cold_item_features.csv"
    assert (pdir / name).read_bytes() == (jdir / name).read_bytes()
    assert len(feats["item_id"]) == (4 if source == "item" else 160)
    out = tmp_path / "o" / "f.csv"
    F.prepare_item_features("cold", str(pdir), str(out))
    assert out.read_bytes() == (pdir / name).read_bytes()


# ---------------------------------------------------------------------------
# the similarity
# ---------------------------------------------------------------------------

FOUR = {"item_id": np.array(["a", "b", "c", "x"]),
        "description": np.array(["red shoe leather", "blue shirt cotton", "red boot leather",
                                 "red sneaker leather"])}


def _random_text(n_items, n_words, seed):
    rng = np.random.default_rng(seed)
    words = [f"w{j}" for j in range(n_words)]
    desc = [" ".join(rng.choice(words, size=rng.integers(1, 8))) for _ in range(n_items)]
    return {"item_id": np.array([f"t{i:04d}" for i in rng.permutation(n_items)]),
            "description": np.array(desc)}


def _features(case, cold):
    """(features, valid tokens): the 4-item case; random text with fewer
    items than words (the SVD of the transpose) and with more; the
    synthesized features of the stat-matched data (8 distinct
    descriptions, so ties decide) with a shuffled training vocabulary."""
    if case == "four":
        return FOUR, ["a", "b", "c"]
    if case == "wide-text":
        feats = _random_text(30, 60, 1)
    elif case == "long-text":
        feats = _random_text(400, 50, 2)
    else:
        frame = read_atomic_file(str(cold / "src" / "cold" / "cold.inter"))
        feats = F.synthesize_item_features(frame)
    tokens = feats["item_id"].tolist()
    rng = np.random.default_rng(3)
    valid = [tokens[i] for i in rng.permutation(len(tokens))[: int(0.8 * len(tokens))]]
    return feats, valid + ["not-an-item"]


@pytest.mark.parametrize("case", ["four", "wide-text", "long-text", "stat-matched"])
def test_similarity_matches_sklearn(case, cold):
    from scipy.sparse import csr_matrix
    from sklearn.feature_extraction.text import TfidfVectorizer

    feats, valid = _features(case, cold)
    jdf = pd.DataFrame(feats)
    want = JS.ItemSimilarity(jdf, valid, n_components=16, seed=2020)
    got = S.ItemSimilarity(feats, valid, n_components=16, seed=2020)

    docs = jdf.sort_values("item_id")["description"]
    tf_want = csr_matrix(TfidfVectorizer().fit_transform(docs)).toarray()
    tf_got, names = S.tfidf_matrix(docs.tolist())
    assert np.abs(tf_got.toarray() - tf_want).max() <= 1e-12
    assert len(names) == tf_want.shape[1]

    assert got.item_index == want.item_index and got.valid_tokens == want.valid_tokens
    assert got.sim.shape == want.sim.shape
    assert np.abs(got.sim - want.sim).max() <= 1e-9
    near, differ = 0, []
    for token in sorted(want.item_index):
        top = np.sort(want.sim[want.item_index[token]])[::-1]
        if len(top) > 1 and 0 < top[0] - top[1] <= 1e-9:
            near += 1
        elif got.nearest_valid(token) != want.nearest_valid(token):
            differ.append(token)
    assert not differ, f"{len(differ)} tokens map elsewhere ({near} near-ties allowed)"
    assert got.nearest_valid("no-such-item") is None
    tokens = list(want.item_index)[:6] + ["no-such-item"]
    assert got.map_sequence(tokens, set(valid)) == want.map_sequence(tokens, set(valid))
    if case == "four":
        assert got.nearest_valid("x") in {"a", "c"}
        assert got.map_sequence(["zz"], {"a"}) == []


def test_similarity_raises_without_a_vocabulary():
    with pytest.raises(ValueError, match="empty vocabulary"):
        S.ItemSimilarity({"item_id": np.array(["a", "b"]), "description": np.array(["", "x"])},
                         ["a"])


# ---------------------------------------------------------------------------
# the held-out split and the whole experiment
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def splits(cold, tmp_path_factory):
    """Each package's (train, test) split of the dataset at test_size 0.2."""
    tmp = tmp_path_factory.mktemp("splits")
    jdir, pdir = _copy(cold, tmp / "j"), _copy(cold, tmp / "p")
    jtrain, jtest = JP.prepare_data_split(JConfig(model="RecBLR", config_dict=_cfg(jdir)),
                                          test_size=0.2)
    train, test = P.prepare_data_split(Config(model="RecBLR", config_dict=_cfg(pdir)),
                                       test_size=0.2)
    return (jtrain, jtest), (train, test)


@pytest.mark.parametrize("mode", ["none", "pre"])
def test_unseen_split_equals_jax(splits, mode):
    (jtrain, jtest), (train, test) = splits
    kw = dict(user_interval="[5,inf)", item_interval="[5,inf)")
    jdata, data = j_build(jtrain, max_seq_len=T, **kw), build_from_dataframe(train, T, **kw)
    jsim = sim = None
    if mode == "pre":
        both = pd.concat([jtrain, jtest], ignore_index=True)
        jsim = JS.ItemSimilarity(JF.synthesize_item_features(both), list(jdata.item_token2id),
                                 seed=2020)
        sim = S.ItemSimilarity(F.synthesize_item_features(
            {k: np.concatenate([train[k], test[k]]) for k in FIELDS}),
            list(data.item_token2id), seed=2020)
    want, jn_total, jn_eval = JP.build_unseen_split(jtest, jdata, mode, jsim, *FIELDS)
    got, n_total, n_eval = P.build_unseen_split(test, data, mode, sim, *FIELDS)
    assert (n_total, n_eval) == (jn_total, jn_eval) == (40, 26 if mode == "none" else 40)
    for name in ("item_seq", "item_seq_len", "pos_item", "user_id"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


def _jax_run(jdir, mode, extra):
    jcfg = JConfig(model="RecBLR", config_dict=_cfg(
        jdir, checkpoint_dir=str(jdir / "saved"), log_dir=str(jdir / "log"), **extra))
    return JP.run_unseen_experiment(mode=mode, config=jcfg, test_size=0.2,
                                    plot_dir=str(jdir / "plot"))


def _jax_initial_params(jcfg_dict, n_items):
    """The JAX driver's initial parameters: Trainer(rng=PRNGKey(seed))
    splits the key and initialises from the second half."""
    jmodel = j_get_model("RecBLR")(JConfig(model="RecBLR", config_dict=jcfg_dict), n_items, T)
    _, init_rng = jax.random.split(jax.random.PRNGKey(2020))
    return params_from_jax(jax.tree.map(np.asarray, jmodel.init_params(init_rng)))


@pytest.mark.parametrize("mode", ["none", "pre"])
def test_run_unseen_experiment_matches_jax(cold, tmp_path, mode):
    # the best checkpoint is the first epoch's (the smaller NDCG@10 wins),
    # so the held-out users' last-epoch parameters are not the best ones
    extra = {"valid_metric_bigger": False}
    jdir, pdir = _copy(cold, tmp_path / "j"), _copy(cold, tmp_path / "p")
    want = _jax_run(jdir, mode, extra)
    start = _jax_initial_params(_cfg(jdir, **extra), want["experiment"]["data"].n_items)
    cfg = Config(model="RecBLR", config_dict=_cfg(
        pdir, checkpoint_dir=str(pdir / "saved"), log_dir=str(pdir / "log"), **extra))
    got = P.run_unseen_experiment(mode=mode, config=cfg, test_size=0.2,
                                  plot_dir=str(pdir / "plot"), device="cpu", params=start)

    assert set(got) == set(want) and got["mode"] == mode
    assert (got["n_unseen_users"], got["n_evaluated"]) == (
        want["n_unseen_users"], want["n_evaluated"]) == (40, 26 if mode == "none" else 40)
    for key in ("seen_result", "unseen_result"):
        assert set(got[key]) == set(want[key])
        for k, v in want[key].items():
            assert abs(got[key][k] - v) <= 1e-3, (key, k)
    assert sorted(os.listdir(pdir / "plot")) == sorted(os.listdir(jdir / "plot"))
    assert f"RecBLR_config_{mode}_training_metrics.csv" in os.listdir(pdir / "plot")
    trainer = got["experiment"]["trainer"]
    assert trainer.best_epoch == want["experiment"]["trainer"].best_epoch == 0
    rec = [r for r in got["experiment"]["metrics"].records if r["event"] == "unseen_test"]
    assert len(rec) == 1 and rec[0]["mode"] == mode and rec[0]["similarity_s"] >= 0

    # scored with the last epoch's parameters, which the best checkpoint's differ from
    model = got["experiment"]["model"]
    data = got["experiment"]["data"]
    train, test = P.prepare_data_split(cfg)
    sim = None
    if mode == "pre":
        sim = S.ItemSimilarity(F.synthesize_item_features(
            {k: np.concatenate([train[k], test[k]]) for k in FIELDS}),
            list(data.item_token2id), seed=2020)
    split, _, _ = P.build_unseen_split(test, data, mode, sim, *FIELDS)
    ev = Evaluator(model, P._EvalCfg(cfg, metrics=["hit", "ndcg"], topk=[10]))
    assert ev.evaluate(split) == got["unseen_result"]
    best = restore_checkpoint(trainer.ckpt_path)["params"]
    assert any(not torch.equal(v, model.state_dict()[k]) for k, v in best.items())


def test_pop_sampled_mode_raises_in_both(cold, tmp_path):
    """The unseen evaluator is never given item popularity, so a popN
    mode asserts in both packages."""
    extra = {"eval_args": {"mode": "pop10"}, "epochs": 1}
    jdir, pdir = _copy(cold, tmp_path / "j"), _copy(cold, tmp_path / "p")
    with pytest.raises(AssertionError, match="set_item_popularity"):
        _jax_run(jdir, "none", extra)
    cfg = Config(model="RecBLR", config_dict=_cfg(
        pdir, checkpoint_dir=str(pdir / "saved"), log_dir=str(pdir / "log"), **extra))
    with pytest.raises(AssertionError, match="set_item_popularity"):
        P.run_unseen_experiment(mode="none", config=cfg, test_size=0.2,
                                plot_dir=str(pdir / "plot"), device="cpu")
