"""The port's entry points beside the root scripts they stand for, on a
toy dataset on the CPU: ``run_with_unseen``, ``prepare_item_features``,
``full_exp``, ``run_bert4rec``, ``compare_plots`` and ``trim`` (``python
-m datamining_recblr_torch.<name>``).  Where the root script runs here in
seconds, both run from the same yaml file and write the same file names
(plots, CSV headers, split files; ``trim`` and ``prepare_item_features``
the same bytes); ``--exp model``, ``--exp unseen`` and ``run_bert4rec``
are held to the names the root scripts give.  Also
``generate_comparison_plots`` with and without matplotlib."""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest

from datamining_recblr_torch import (
    compare_plots,
    full_exp,
    prepare_item_features,
    run_bert4rec,
    run_with_unseen,
    trim,
)
from datamining_recblr_torch.data.atomic import read_atomic_file
from datamining_recblr_torch.data.synthetic import write_synthetic_inter
from datamining_recblr_torch.utils import plotting

ROOT = Path(__file__).resolve().parents[1]
CFG = """
dataset: toy
data_path: {data}
MAX_ITEM_LIST_LENGTH: 10
hidden_size: 16
num_layers: 1
epochs: 1
train_batch_size: 64
eval_batch_size: 128
user_inter_num_interval: "[3,inf)"
item_inter_num_interval: "[1,inf)"
use_pallas_scan: never
checkpoint_dir: {saved}
n_layers: 1
n_heads: 2
inner_size: 32
"""


def _toy(tmp_path):
    """A working directory with the toy dataset and its yaml config."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    write_synthetic_inter(str(tmp_path / "dataset" / "toy" / "toy.inter"), n_users=60,
                          n_items=40, min_len=5, max_len=12, seed=9)
    (tmp_path / "cfg.yaml").write_text(CFG.format(data=tmp_path / "dataset",
                                                  saved=tmp_path / "saved"))
    return tmp_path


def _root_script(name, argv, cwd, monkeypatch):
    """Run the root script ``name`` in-process from ``cwd`` with ``argv``."""
    monkeypatch.chdir(cwd)
    monkeypatch.syspath_prepend(str(ROOT))
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    __import__(name).main()


def _csv_header(path):
    return Path(path).read_text().splitlines()[0]


@pytest.mark.parametrize("case", ["run_with_unseen", "full_exp_comp"])
def test_entry_point_writes_the_root_scripts_files(case, tmp_path, monkeypatch):
    jdir, pdir = _toy(tmp_path / "root"), _toy(tmp_path / "port")
    argv = {"run_with_unseen": ["--mode", "pre", "--config", "cfg.yaml"],
            "full_exp_comp": ["--exp", "comp", "--model", "r", "--mode", "noff",
                              "--config", "cfg.yaml"]}[case]
    script, module = {"run_with_unseen": ("run_with_unseen", run_with_unseen),
                      "full_exp_comp": ("full_exp", full_exp)}[case]
    _root_script(script, argv, jdir, monkeypatch)
    monkeypatch.chdir(pdir)
    module.main([*argv, "--device", "cpu"])
    names = sorted(os.listdir(jdir / "plot"))
    assert sorted(os.listdir(pdir / "plot")) == names
    for name in names:
        if name.endswith(".csv"):
            assert _csv_header(pdir / "plot" / name) == _csv_header(jdir / "plot" / name)
    if case == "run_with_unseen":
        assert "RecBLR_config_pre_training_metrics.csv" in names
        for split in ("toy_train.inter", "toy_test.inter"):
            assert ((pdir / "dataset" / "toy" / split).read_bytes()
                    == (jdir / "dataset" / "toy" / split).read_bytes())
    else:
        assert {"RecBLR_noff_training_metrics.csv", "ablation_train_time.png"} <= set(names)


def test_full_exp_model_and_unseen(tmp_path, monkeypatch):
    """``--exp model``: the three models on one dataset, their CSVs and
    the comparison bars; ``--exp unseen``: both modes by default."""
    monkeypatch.chdir(_toy(tmp_path))
    out = full_exp.main(["--exp", "model", "--config", "cfg.yaml", "--device", "cpu"])
    assert list(out) == ["RecBLR", "BERT4Rec", "SASRec"]
    assert out["RecBLR"]["data"] is out["SASRec"]["data"]
    names = set(os.listdir(tmp_path / "plot"))
    assert {f"{m}_training_metrics.csv" for m in out} <= names
    assert {"comparison_train_time.png", "comparison_eval_time.png"} <= names
    assert out["SASRec"]["config"]["bd_lru_only"] is False
    unseen = full_exp.main(["--exp", "unseen", "--config", "cfg.yaml", "--device", "cpu"])
    assert list(unseen) == ["none", "pre"]
    assert unseen["pre"]["n_evaluated"] >= unseen["none"]["n_evaluated"]
    assert {"RecBLR_config_none_training_metrics.csv",
            "RecBLR_config_pre_training_metrics.csv"} <= set(os.listdir(tmp_path / "plot"))


def test_full_exp_comp_requires_mode(tmp_path, monkeypatch):
    monkeypatch.chdir(_toy(tmp_path))
    with pytest.raises(SystemExit):
        full_exp.main(["--exp", "comp", "--config", "cfg.yaml", "--device", "cpu"])


def test_full_exp_comp_of_a_baseline_drops_the_flags(tmp_path, monkeypatch):
    """The ablation flags act on RecBLR alone, as in the root script."""
    monkeypatch.chdir(_toy(tmp_path))
    out = full_exp.main(["--exp", "comp", "--model", "s", "--mode", "bdlru",
                         "--config", "cfg.yaml", "--device", "cpu"])
    assert out["bdlru"]["config"]["model"] == "SASRec"
    assert out["bdlru"]["config"]["bd_lru_only"] is False
    assert os.path.exists(tmp_path / "plot" / "SASRec_bdlru_training_metrics.csv")


def test_run_bert4rec_from_its_default_presets(tmp_path, monkeypatch):
    """No ``--config``: the presets of the three per-dataset configs the
    root script reads (cut here to T 10, hidden 16 and batch 64 on the
    CPU), each dataset under ``dataset/``."""
    from datamining_recblr_torch.config import presets

    monkeypatch.chdir(tmp_path)
    for i, name in enumerate(run_bert4rec.DEFAULT_CONFIGS):
        write_synthetic_inter(str(tmp_path / "dataset" / name / f"{name}.inter"), n_users=40,
                              n_items=20, min_len=6, max_len=10, seed=i)
        monkeypatch.setitem(presets.PRESETS, name, dict(
            presets.PRESETS[name], MAX_ITEM_LIST_LENGTH=10, hidden_size=16, inner_size=32,
            train_batch_size=64, eval_batch_size=128))
    out = run_bert4rec.main(["--epochs", "1", "--device", "cpu"])
    assert list(out) == ["amazon-beauty", "amazon-apps", "yelp"]
    for name, result in out.items():
        cfg = result["config"]
        assert (cfg["model"], cfg["dataset"], cfg["epochs"]) == ("BERT4Rec", name, 1)
        assert cfg["user_inter_num_interval"] == ("[0,inf)" if name == "amazon-apps"
                                                  else "[5,inf)")
        assert result["model"].device.type == "cpu"
    names = set(os.listdir(tmp_path / "plot"))
    assert {f"BERT4Rec_{n}_training_metrics.csv" for n in out} <= names
    assert "bert4rec_train_time.png" in names


def test_prepare_item_features_and_trim_write_the_root_bytes(tmp_path, monkeypatch):
    jdir, pdir = _toy(tmp_path / "root"), _toy(tmp_path / "port")
    _root_script("prepare_item_features", ["--dataset", "toy", "--data_path", "dataset"],
                 jdir, monkeypatch)
    _root_script("trim", ["dataset/toy/toy.inter", "trimmed.inter", "--keep_fraction", "0.3"],
                 jdir, monkeypatch)
    monkeypatch.chdir(pdir)
    feats = prepare_item_features.main(["--dataset", "toy", "--data_path", "dataset"])
    out = trim.main(["dataset/toy/toy.inter", "trimmed.inter", "--keep_fraction", "0.3"])
    name = "dataset/toy/toy_item_features.csv"
    assert (pdir / name).read_bytes() == (jdir / name).read_bytes()
    assert len(feats["item_id"]) == len((pdir / name).read_text().splitlines()) - 1
    assert (pdir / "trimmed.inter").read_bytes() == (jdir / "trimmed.inter").read_bytes()
    orig = read_atomic_file(str(pdir / "dataset" / "toy" / "toy.inter"))
    assert len(out["timestamp"]) == int(0.3 * len(orig["timestamp"]))
    assert out["timestamp"].min() >= np.quantile(orig["timestamp"], 0.65)


def _metrics_files(where):
    for name in ("a", "b"):
        with open(where / f"{name}.jsonl", "w") as f:
            for e in range(3):
                f.write(json.dumps({"event": "epoch", "epoch": e, "train_loss": 5 - e,
                                    "train_time": 1.0 + e, "eval_time": 0.5,
                                    "valid_score": 0.1 * e}) + "\n")
            f.write(json.dumps({"event": "test", "hit@10": 0.3}) + "\n")


def test_compare_plots_draws_the_root_scripts_bars(tmp_path, monkeypatch):
    jdir, pdir = tmp_path / "root", tmp_path / "port"
    for d in (jdir, pdir):
        d.mkdir()
        _metrics_files(d)
    _root_script("compare_plots", ["a=a.jsonl", "b.jsonl", "--out", "out"], jdir, monkeypatch)
    monkeypatch.chdir(pdir)
    rows = compare_plots.main(["a=a.jsonl", "b.jsonl", "--out", "out"])
    assert sorted(os.listdir(pdir / "out")) == sorted(os.listdir(jdir / "out")) == [
        "comparison_eval_time.png", "comparison_train_time.png"]
    assert list(rows) == ["a", "b"] and [r["train_time"] for r in rows["a"]] == [1.0, 2.0, 3.0]


def test_comparison_plots_without_matplotlib(tmp_path, monkeypatch, caplog):
    import logging

    runs = {"x": [{"event": "epoch", "epoch": 0, "train_time": 2.0, "device_mem_gb": 1.5}],
            "y": [{"event": "epoch", "epoch": 0, "train_time": 4.0, "eval_time": 0.1}]}
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setattr(logging.getLogger("recblr_torch"), "propagate", True)
    with caplog.at_level(logging.INFO, logger="recblr_torch"):
        rows = plotting.generate_comparison_plots(runs, out_dir=str(tmp_path / "p"))
    assert not (tmp_path / "p").exists()
    assert "comparison plots were skipped" in caplog.text
    assert rows["x"][0]["device_mem_gb"] == 1.5 and rows["y"][0]["eval_time"] == 0.1
    assert rows["x"][0]["eval_time"] is None
