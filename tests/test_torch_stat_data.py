"""The port's experiment data path against the JAX package on the CPU:
the stat-matched generator (rows), the ``.inter`` writer (bytes) and
``build_dataset`` (arrays, with the native loaders, the port's and the
JAX package's, on and off), beauty-synth and ml1m-synth at full size and seed 2020, xlong-synth
at a reduced size that keeps its ``max_len`` and ``within_cluster``, and
each generator option at a small size; and the config presets against
the yaml files they mirror.  Every comparison is exact."""

import filecmp
import os

import numpy as np
import pytest
import yaml

from datamining_recblr_tpu.config import Config as JConfig
from datamining_recblr_tpu.data import dataset as JDS
from datamining_recblr_tpu.data import native as jnative
from datamining_recblr_tpu.data import synthetic as JS
from datamining_recblr_torch.config import Config
from datamining_recblr_torch.config import presets as P
from datamining_recblr_torch.data import dataset as DS
from datamining_recblr_torch.data import synthetic as S
from datamining_recblr_torch.data.atomic import read_atomic_file, write_atomic_inter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FULL = ["beauty-synth", "ml1m-synth"]
# small cases, one per generator option: xlong-synth cut to 60 users
# and 3,000 items (its max_len 1,000 and within_cluster "pop" kept, so
# the length cap and the exact-sum loop both act), the preference walk,
# and each within-cluster mode
SMALL = {
    "xlong-reduced": ("xlong-synth", dict(n_users=60, n_items=3_000, n_inters=47_000,
                                          n_clusters=40)),
    "pref": ("beauty-synth", dict(n_users=400, n_items=300, n_inters=5_000, pref_weight=0.3,
                                  pref_k=2)),
    "uniform": ("beauty-synth", dict(n_users=400, n_items=300, n_inters=5_000,
                                     within_cluster="uniform")),
    "sqrt": ("beauty-synth", dict(n_users=400, n_items=300, n_inters=5_000,
                                  within_cluster="sqrt")),
    "pop": ("beauty-synth", dict(n_users=400, n_items=300, n_inters=5_000,
                                 within_cluster="pop")),
}


def _generate(module, preset, seed=2020, **overrides):
    p = dict(module.STAT_PRESETS[preset], **overrides)
    return module.generate_stat_matched_interactions(p.pop("n_users"), p.pop("n_items"),
                                                     p.pop("n_inters"), seed=seed, **p)


def _same_rows(jdf, frame):
    assert list(frame) == list(jdf.columns)
    for k in jdf.columns:
        np.testing.assert_array_equal(frame[k], jdf[k].to_numpy(), err_msg=k)


@pytest.mark.parametrize("preset", FULL)
def test_full_size_rows_match_jax(preset):
    jdf = _generate(JS, preset)
    frame = _generate(S, preset)
    _same_rows(jdf, frame)
    stats = S.STAT_PRESETS[preset]
    assert len(frame["user_id"]) == stats["n_inters"]
    assert len(np.unique(frame["user_id"])) == stats["n_users"]
    assert len(np.unique(frame["item_id"])) == stats["n_items"]


@pytest.mark.parametrize("case", list(SMALL))
def test_generator_options_match_jax(case):
    preset, overrides = SMALL[case]
    jdf = _generate(JS, preset, seed=7, **overrides)
    frame = _generate(S, preset, seed=7, **overrides)
    _same_rows(jdf, frame)
    if case == "xlong-reduced":
        lens = np.unique(frame["user_id"], return_counts=True)[1]
        assert lens.max() == S.STAT_PRESETS["xlong-synth"]["max_len"]


def test_presets_match_jax_and_unsatisfiable_stats_raise():
    assert S.STAT_PRESETS == JS.STAT_PRESETS
    with pytest.raises(ValueError, match="min_len"):
        S.generate_stat_matched_interactions(10, 5, 40, min_len=5)
    with pytest.raises(ValueError, match="max_len"):
        S.generate_stat_matched_interactions(10, 5, 400, max_len=20)


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Both packages' ``write_stat_matched_dataset`` of each full-size
    preset: {preset: (JAX data_path, port data_path)}."""
    root = tmp_path_factory.mktemp("stat")
    out = {}
    for preset in FULL:
        jdir, pdir = str(root / "jax"), str(root / "port")
        JS.write_stat_matched_dataset(jdir, preset)
        S.write_stat_matched_dataset(pdir, preset)
        out[preset] = (jdir, pdir)
    return out


@pytest.mark.parametrize("preset", FULL)
def test_inter_file_bytes_match_jax(preset, written):
    jdir, pdir = written[preset]
    jpath = os.path.join(jdir, preset, f"{preset}.inter")
    ppath = os.path.join(pdir, preset, f"{preset}.inter")
    assert filecmp.cmp(jpath, ppath, shallow=False)
    frame = read_atomic_file(ppath)
    assert len(frame["user_id"]) == S.STAT_PRESETS[preset]["n_inters"]


def test_writer_matches_to_csv_on_any_floats(tmp_path):
    """Fractional, large and negative timestamps keep the writer's bytes
    equal to ``df.to_csv``'s."""
    import pandas as pd

    from datamining_recblr_tpu.data.atomic import write_atomic_inter as j_write

    frame = {"user_id": np.array(["u1", "u2", "u10", "u3"]),
             "item_id": np.array(["i5", "i6", "i7", "i8"]),
             "timestamp": np.array([1.5, 1e16, -3.25, 978300760.0])}
    j_write(pd.DataFrame(frame), str(tmp_path / "j.inter"))
    write_atomic_inter(frame, str(tmp_path / "p.inter"))
    assert (tmp_path / "j.inter").read_bytes() == (tmp_path / "p.inter").read_bytes()


def _same_split(a, b):
    assert a.compact == b.compact
    for k in ("item_seq_len", "pos_item", "user_id"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
    if a.compact:
        np.testing.assert_array_equal(a.flat_items, b.flat_items)
        np.testing.assert_array_equal(a.flat_start, b.flat_start)
    else:
        np.testing.assert_array_equal(a.item_seq, b.item_seq)


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("preset", FULL)
def test_build_dataset_matches_jax(preset, native, written):
    """The port builds with its native loader (``data/native.py``) when
    ``use_native_loader`` is on and with Python when it is off; its arrays
    equal the JAX package's from the same loader."""
    if native:
        assert jnative.available()
    jdir, pdir = written[preset]
    cfg = dict(P.preset("reference"), use_native_loader=native)
    jdata = JDS.build_dataset(JConfig(model="RecBLR", dataset=preset,
                                      config_dict=dict(cfg, data_path=jdir)))
    data = DS.build_dataset(Config(model="RecBLR", dataset=preset,
                                   config_dict=dict(cfg, data_path=pdir)))
    assert data.summary() == jdata.summary()
    for split in ("train", "valid", "test"):
        _same_split(getattr(data, split), getattr(jdata, split))
    assert data.item_id2token == list(jdata.item_id2token)
    assert data.user_id2token == list(jdata.user_id2token)
    np.testing.assert_array_equal(data.item_popularity(), jdata.item_popularity())
    if preset == "ml1m-synth":
        assert (data.n_users - 1, data.n_items - 1, data.n_interactions, len(data.train)) == (
            6040, 3416, 999_611, 981_491)
        assert not data.train.compact


PRESET_YAML = {"reference": "config.yaml",
               "ml1m-paper": "configs/paper/config_ml1m_paper.yaml",
               "beauty-paper": "configs/paper/config_beauty_paper.yaml",
               "xlong-paper": "configs/paper/config_xlong_paper.yaml",
               **{name: f"configs/config_{name.replace('-', '_')}.yaml"
                  for name in ("amazon-apps", "amazon-beauty", "amazon-sports", "hm", "ml-1m",
                               "yelp")}}


@pytest.mark.parametrize("name", list(PRESET_YAML))
def test_presets_equal_the_yaml_files(name):
    path = os.path.join(ROOT, PRESET_YAML[name])
    with open(path) as f:
        assert P.preset(name) == yaml.safe_load(f)
    assert P.PRESET_FILES[os.path.normpath(PRESET_YAML[name])] == name
    # the preset's path resolves to the preset itself, no yaml read
    assert P.config_layers(path) == ([], P.preset(name))
    assert Config(model="RecBLR", config_dict=P.preset(name)).as_dict() == Config(
        model="RecBLR", config_file_list=[path]).as_dict()


def test_config_layers_reads_other_yaml_files(tmp_path):
    other = tmp_path / "config.yaml"
    other.write_text("hidden_size: 8\n")
    assert P.config_layers(str(other)) == ([str(other)], {})
    assert P.config_layers("xlong-paper")[1]["MAX_ITEM_LIST_LENGTH"] == 1024
    with pytest.raises(FileNotFoundError, match="neither a preset"):
        P.config_layers(str(tmp_path / "missing.yaml"))


def test_write_atomic_inter_round_trips(tmp_path):
    frame = S.generate_synthetic_interactions(n_users=12, n_items=9, seed=3)
    path = str(tmp_path / "d" / "x.inter")
    write_atomic_inter(frame, path)
    back = read_atomic_file(path)
    for k in frame:
        np.testing.assert_array_equal(back[k], frame[k])
    frame2 = S.write_synthetic_inter(str(tmp_path / "e" / "y.inter"), n_users=12, n_items=9,
                                     seed=3)
    assert (tmp_path / "e" / "y.inter").read_bytes() == open(path, "rb").read()
    for k in frame:
        np.testing.assert_array_equal(frame2[k], frame[k])
