"""The port's data package (NumPy and ``csv`` only, no pandas) against
the JAX package's pandas builder: the same arrays, exactly."""

import numpy as np
import pandas as pd
import pytest

from datamining_recblr_tpu.data import batching as jbatching
from datamining_recblr_tpu.data import dataset as JDS
from datamining_recblr_tpu.data.atomic import read_atomic_file as j_read
from datamining_recblr_tpu.data.atomic import write_atomic_inter
from datamining_recblr_tpu.data.synthetic import (
    generate_synthetic_interactions as j_generate,
    synthetic_splits as j_synthetic_splits,
)
from datamining_recblr_torch.data import batching
from datamining_recblr_torch.data import dataset as DS
from datamining_recblr_torch.data.atomic import read_atomic_file
from datamining_recblr_torch.data.synthetic import (
    generate_synthetic_interactions,
    synthetic_splits,
)

SPLIT_FIELDS = ("item_seq", "item_seq_len", "pos_item", "user_id", "flat_items",
                "flat_start", "max_seq_len")


def _log(seed=1):
    """A synthetic log with rows shuffled (first-appearance order is not
    user order) and timestamps that tie across users (stable sort)."""
    frame = generate_synthetic_interactions(n_users=70, n_items=40, min_len=2,
                                            max_len=15, seed=seed)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(frame["user_id"]))
    frame = {k: v[order] for k, v in frame.items()}
    frame["timestamp"] = np.floor(frame["timestamp"] / 3.0)
    return frame


def _assert_split_equal(got, want):
    for f in SPLIT_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if a is None or b is None:
            assert a is None and b is None, f
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype, f


def _assert_data_equal(got, want):
    for f in ("n_users", "n_items", "n_interactions", "max_seq_len", "user_token2id",
              "item_token2id", "user_id2token", "item_id2token"):
        assert getattr(got, f) == getattr(want, f), f
    for s in ("train", "valid", "test"):
        _assert_split_equal(getattr(got, s), getattr(want, s))
    assert len(got.user_train_items) == len(want.user_train_items)
    for a, b in zip(got.user_train_items, want.user_train_items):
        np.testing.assert_array_equal(a, b)


def test_generator_matches_jax():
    frame = generate_synthetic_interactions(n_users=30, n_items=20, seed=4)
    df = j_generate(n_users=30, n_items=20, seed=4)
    for col in df.columns:
        np.testing.assert_array_equal(frame[col], df[col].to_numpy())


@pytest.mark.parametrize("intervals", [(None, None), ("[5,inf)", "[3,inf)"),
                                       ("(4,12]", "[2,inf)")])
@pytest.mark.parametrize("max_seq_len", [6, 20])
def test_builder_matches_jax(intervals, max_seq_len):
    frame = _log()
    kw = dict(max_seq_len=max_seq_len, user_interval=intervals[0],
              item_interval=intervals[1])
    _assert_data_equal(DS.build_from_dataframe(frame, **kw),
                       JDS.build_from_dataframe(pd.DataFrame(frame), **kw))


def test_builder_without_augmentation_matches_jax():
    frame = _log(2)
    kw = dict(max_seq_len=8, augment_train=False)
    _assert_data_equal(DS.build_from_dataframe(frame, **kw),
                       JDS.build_from_dataframe(pd.DataFrame(frame), **kw))


def test_compact_train_split_matches_jax(monkeypatch):
    monkeypatch.setattr(DS, "_COMPACT_TRAIN_ELEMS", 0)
    monkeypatch.setattr(JDS, "_COMPACT_TRAIN_ELEMS", 0)
    frame = _log(3)
    got = DS.build_from_dataframe(frame, max_seq_len=7)
    want = JDS.build_from_dataframe(pd.DataFrame(frame), max_seq_len=7)
    assert got.train.compact
    _assert_data_equal(got, want)
    idx = np.arange(len(got.train))[::-1]
    np.testing.assert_array_equal(got.train.windows(idx), want.train.windows(idx))
    _assert_split_equal(got.train.take(idx[:9]), want.train.take(idx[:9]))


def test_atomic_reader_matches_jax(tmp_path):
    path = str(tmp_path / "toy" / "toy.inter")
    write_atomic_inter(pd.DataFrame(_log(4)), path)
    frame = read_atomic_file(path)
    df = j_read(path)
    assert list(frame) == list(df.columns)
    for col in df.columns:
        np.testing.assert_array_equal(frame[col], df[col].to_numpy())
    assert frame["timestamp"].dtype == np.float64
    only = read_atomic_file(path, columns=["item_id", "user_id"])
    assert list(only) == ["item_id", "user_id"]
    with pytest.raises(KeyError, match="missing"):
        read_atomic_file(path, columns=["rating"])


def test_synthetic_splits_and_batches_match_jax():
    got = synthetic_splits(50, 30, 9, 37, seed=6)
    want = j_synthetic_splits(50, 30, 9, 37, seed=6)
    for g, w in zip(got, want):
        _assert_split_equal(g, w)
    train = got[0]
    assert batching.batch_count(37, 8) == jbatching.batch_count(37, 8) == 5
    pairs = list(zip(batching.iter_batches(train, 8), jbatching.iter_batches(want[0], 8)))
    assert len(pairs) == 5
    for b, jb in pairs:
        assert set(b) == set(jb)
        for k in b:
            np.testing.assert_array_equal(b[k], jb[k], err_msg=k)
    assert pairs[-1][0]["weight"].tolist() == [1.0] * 5 + [0.0] * 3
