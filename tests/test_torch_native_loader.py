"""The port's native loader (``data/native.py`` over its copy of
``native/rec_data.cc``) against its Python builder and the JAX package's
native loader, on the CPU: the same arrays and tokens, on the interval
cases of ``tests/test_native_loader.py`` and in the COMPACT train form;
``build_dataset`` takes it when ``use_native_loader`` is on; a failed
compile and a null handle raise."""

import ctypes
from pathlib import Path

import numpy as np
import pytest

import datamining_recblr_torch.data.dataset as DS
from datamining_recblr_tpu.data import native as jnative
from datamining_recblr_torch.config import Config
from datamining_recblr_torch.data import native
from datamining_recblr_torch.data.atomic import read_atomic_file
from datamining_recblr_torch.data.synthetic import write_synthetic_inter

ROOT = Path(__file__).resolve().parents[1]
ARRAYS = ("item_seq_len", "pos_item", "user_id")


def _same(a, b):
    """Two SeqData equal array for array and token for token."""
    assert (a.n_users, a.n_items, a.n_interactions, a.max_seq_len) == (
        b.n_users, b.n_items, b.n_interactions, b.max_seq_len)
    assert a.item_token2id == b.item_token2id and a.user_token2id == b.user_token2id
    assert list(a.item_id2token) == list(b.item_id2token)
    assert list(a.user_id2token) == list(b.user_id2token)
    for split in ("train", "valid", "test"):
        x, y = getattr(a, split), getattr(b, split)
        assert x.compact == y.compact, split
        for k in ARRAYS + (("flat_items", "flat_start") if x.compact else ("item_seq",)):
            np.testing.assert_array_equal(getattr(x, k), getattr(y, k), err_msg=f"{split}.{k}")
    assert len(a.user_train_items) == len(b.user_train_items)
    for x, y in zip(a.user_train_items, b.user_train_items):
        np.testing.assert_array_equal(x, y)


def test_the_source_is_the_jax_package_s_copy():
    assert (ROOT / "native" / "rec_data.cc").read_bytes() == native.SOURCE.read_bytes()


@pytest.mark.parametrize(
    "user_interval,item_interval",
    [(None, None), ("[5,inf)", "[5,inf)"), ("[3,inf)", "[2,inf)")],
)
def test_native_matches_python_and_jax(tmp_path, user_interval, item_interval):
    path = str(tmp_path / "toy" / "toy.inter")
    write_synthetic_inter(path, n_users=120, n_items=60, min_len=4, max_len=25, seed=13)
    kw = dict(max_seq_len=12, user_interval=user_interval, item_interval=item_interval)
    nat = native.build_dataset_from_file(path, **kw)
    _same(nat, DS.build_from_dataframe(read_atomic_file(path), **kw))
    _same(nat, jnative.build_dataset_from_file(path, **kw))


def test_native_compact_train_matches(tmp_path, monkeypatch):
    """Above ``_COMPACT_TRAIN_ELEMS`` the train split comes back COMPACT,
    equal to the Python builder's and the JAX loader's, and its windows
    are the dense build's rows."""
    import datamining_recblr_tpu.data.dataset as JDS

    path = str(tmp_path / "toyc" / "toyc.inter")
    write_synthetic_inter(path, n_users=80, n_items=50, min_len=4, max_len=20, seed=5)
    dense = native.build_dataset_from_file(path, max_seq_len=12)
    assert not dense.train.compact
    monkeypatch.setattr(DS, "_COMPACT_TRAIN_ELEMS", 0)
    monkeypatch.setattr(JDS, "_COMPACT_TRAIN_ELEMS", 0)
    compact = native.build_dataset_from_file(path, max_seq_len=12)
    assert compact.train.compact and not compact.valid.compact
    _same(compact, DS.build_from_dataframe(read_atomic_file(path), max_seq_len=12))
    _same(compact, jnative.build_dataset_from_file(path, max_seq_len=12))
    np.testing.assert_array_equal(compact.train.windows(np.arange(len(dense.train))),
                                  dense.train.item_seq)


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
def test_build_dataset_takes_the_loader_the_config_names(tmp_path, monkeypatch, use_native):
    write_synthetic_inter(str(tmp_path / "toy2" / "toy2.inter"), n_users=50, n_items=30,
                          min_len=4, max_len=15, seed=2)
    calls = []
    real = native.build_dataset_from_file
    monkeypatch.setattr(native, "build_dataset_from_file",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = Config(model="RecBLR", config_dict={
        "dataset": "toy2", "data_path": str(tmp_path), "MAX_ITEM_LIST_LENGTH": 10,
        "use_native_loader": use_native})
    data = DS.build_dataset(cfg)
    assert calls == ([1] if use_native else [])
    _same(data, DS.build_from_dataframe(read_atomic_file(str(tmp_path / "toy2" / "toy2.inter")),
                                        max_seq_len=10))


def test_a_failed_compile_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "rec_data.cc"
    bad.write_text("extern \"C\" int rb_build( { return 0; }\n")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="native loader.*failed") as err:
        native.library(bad)
    assert "error" in str(err.value)
    assert not list((tmp_path / "build").glob("*.so"))


def test_a_null_handle_raises(tmp_path, monkeypatch):
    path = str(tmp_path / "toy3" / "toy3.inter")
    write_synthetic_inter(path, n_users=20, n_items=10, min_len=4, max_len=8, seed=1)

    class NullBuild:
        def __init__(self, lib):
            self.lib = lib

        def __getattr__(self, name):
            return getattr(self.lib, name)

        def rb_build(self, *args):
            return None

    lib = native.library()
    monkeypatch.setattr(native, "library", lambda: NullBuild(lib))
    with pytest.raises(RuntimeError, match="null handle"):
        native.build_dataset_from_file(path, max_seq_len=8)
    assert isinstance(lib, ctypes.CDLL)
