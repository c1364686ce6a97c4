"""The port's experiment path on the CPU: ``run_experiment`` against the
JAX package's on the same written ``.inter`` file (small width, dropout 0,
fp32, the JAX initial parameters carried over by
``interop.params_from_jax``; per-epoch loss rtol 2e-4 / atol 5e-5 and test
metrics within 1e-3, the fit tolerances of ``test_torch_train.py``), its
files, the ``run`` and ``parity`` entry points, the FLOPs count against a
hand-written sum of each model's products, the plots with and without
matplotlib, the environment report and the trainer's ``profile_dir``."""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from datamining_recblr_tpu.config import Config as JConfig
from datamining_recblr_tpu.drivers import run_experiment as j_run_experiment
from datamining_recblr_tpu.models import get_model as j_get_model
from datamining_recblr_torch import parity, run
from datamining_recblr_torch.config import Config
from datamining_recblr_torch.data.synthetic import write_stat_matched_dataset
from datamining_recblr_torch.drivers import run_experiment
from datamining_recblr_torch.interop import params_from_jax
from datamining_recblr_torch.models import get_model
from datamining_recblr_torch.train.trainer import Trainer
from datamining_recblr_torch.utils import plotting
from datamining_recblr_torch.utils.env import environment_report, format_environment
from datamining_recblr_torch.utils.flops import forward_flops

T = 12
SMALL = dict(n_users=80, n_items=40, n_inters=1_600, n_clusters=6)


def _cfg(tmp, **extra):
    return {"hidden_size": 16, "num_layers": 2, "MAX_ITEM_LIST_LENGTH": T,
            "dropout_prob": 0.0, "use_pallas_scan": "always", "epochs": 2,
            "train_batch_size": 64, "eval_batch_size": 128, "stopping_step": 10,
            "data_path": str(tmp / "dataset"), "user_inter_num_interval": "[5,inf)",
            "item_inter_num_interval": "[5,inf)", **extra}


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("exp")
    write_stat_matched_dataset(str(tmp / "dataset"), "ml1m-synth", out_name="small",
                               **SMALL, min_len=10)
    return tmp


def plotting_columns(records):
    from datamining_recblr_tpu.utils.plotting import records_to_dataframe

    return records_to_dataframe(records).columns


def test_run_experiment_matches_jax(small, tmp_path):
    cfg = _cfg(small)
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jcfg = JConfig(model="RecBLR", dataset="small", config_dict=dict(
        cfg, checkpoint_dir=str(jdir / "saved"), log_dir=str(jdir / "log"),
        metrics_file=str(jdir / "m.jsonl")))
    want = j_run_experiment(jcfg, plot_dir=str(jdir / "plot"))
    # the JAX driver's initial parameters: Trainer(rng=PRNGKey(seed))
    # splits the key and initialises from the second half
    jmodel = j_get_model("RecBLR")(jcfg, want["data"].n_items, T)
    _, init_rng = jax.random.split(jax.random.PRNGKey(int(cfg.get("seed", 2020))))
    start = params_from_jax(jax.tree.map(np.asarray, jmodel.init_params(init_rng)))

    pcfg = Config(model="RecBLR", dataset="small", config_dict=dict(
        cfg, checkpoint_dir=str(pdir / "saved"), log_dir=str(pdir / "log"),
        metrics_file=str(pdir / "m.jsonl")))
    got = run_experiment(pcfg, plot_dir=str(pdir / "plot"), device="cpu", params=start)

    assert set(got) == set(want)
    assert got["data"].summary() == want["data"].summary()
    w = [r["train_loss"] for r in want["metrics"].epoch_records()]
    g = [r["train_loss"] for r in got["metrics"].epoch_records()]
    assert len(g) == len(w) == 2
    np.testing.assert_allclose(g, w, rtol=2e-4, atol=5e-5)
    assert got["trainer"].best_epoch == want["trainer"].best_epoch
    assert set(got["test_result"]) == set(want["test_result"])
    for k, v in want["test_result"].items():
        assert abs(got["test_result"][k] - v) <= 1e-3, k
    assert abs(got["best_valid_score"] - want["best_valid_score"]) <= 1e-3

    # its files: the metrics JSONL, the per-run log, the CSV and the plots
    events = [json.loads(line)["event"] for line in open(pdir / "m.jsonl")]
    assert events.count("epoch") == 2 and "flops" in events and events[-1] == "test"
    logs = os.listdir(pdir / "log" / "RecBLR")
    assert len(logs) == 1 and logs[0].startswith("RecBLR-small-")
    assert "forward FLOPs" in open(pdir / "log" / "RecBLR" / logs[0]).read()
    names = sorted(os.listdir(pdir / "plot"))
    assert names == sorted(os.listdir(jdir / "plot"))
    header = open(pdir / "plot" / "RecBLR_small_training_metrics.csv").readline().strip()
    assert header.split(",") == list(
        plotting_columns(want["metrics"].epoch_records()))
    assert got["environment"]["backend"] == "cpu"


def test_multihost_is_not_ported(small, monkeypatch):
    """Multi-host runs are ported now: without a launcher's environment
    the process group cannot form, and the run raises rather than going
    on as one process."""
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="RANK"):
        run_experiment(Config(model="RecBLR", config_dict={"multihost": True}), device="cpu")


def test_run_entry_point(small, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    result = run.main(["--model", "S", "--config", "reference", "--dataset", "small",
                       "--epochs", "1", "--device", "cpu", "--plot_prefix", "s1",
                       "--set", f"data_path={small / 'dataset'}", "--set", "hidden_size=16",
                       "--set", f"MAX_ITEM_LIST_LENGTH={T}", "--set", "train_batch_size=128",
                       "--set", "n_heads=2", "--set", "inner_size=32",
                       "--set", "eval_args={'mode': 'uni20'}"])
    cfg = result["config"]
    assert cfg["model"] == "SASRec" and cfg["dataset"] == "small" and cfg["epochs"] == 1
    assert cfg["eval_args"]["mode"] == "uni20" and cfg["eval_args"]["order"] == "TO"
    assert (cfg["bd_lru_only"], cfg["disable_ffn"]) == (False, False)
    assert result["model"].device.type == "cpu" and len(result["metrics"].epoch_records()) == 1
    assert os.path.exists(tmp_path / "plot" / "s1_training_metrics.csv")
    assert os.listdir(tmp_path / "log" / "SASRec")
    assert run.parse_value("none") is None and run.parse_value("1e-3") == 1e-3
    assert run.parse_value("True") is True and run.parse_value("abc") == "abc"
    with pytest.raises(SystemExit):
        run.parse_sets(["epochs"])


@pytest.mark.parametrize("kw", [{}, {"markov": 0.4}, {"seed": 7}, {"markov": 0.4, "seed": 7},
                                {"within": "pop", "clusters": 30, "tag": "t1"},
                                {"pref": 0.2, "pref_k": 2}],
                         ids=["canonical", "markov", "seed", "markov_seed", "tag", "pref"])
def test_parity_dataset_names_match_the_root_script(kw, tmp_path):
    """``ensure_dataset`` names (and writes) the datasets as the root
    ``parity_exp.py`` does."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import parity_exp

    want = parity_exp.ensure_dataset(str(tmp_path / "j"), "beauty-synth", **kw)
    got = parity.ensure_dataset(str(tmp_path / "p"), "beauty-synth", **kw)
    assert got == want
    assert (open(tmp_path / "j" / want / f"{want}.inter", "rb").read()
            == open(tmp_path / "p" / got / f"{got}.inter", "rb").read())


def test_parity_entry_point(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = parity.main(["--dataset", "beauty-synth", "--model", "R", "--epochs", "1",
                       "--device", "cpu", "--markov", "0.5", "--out", "res",
                       "--set", "hidden_size=8", "--set", "MAX_ITEM_LIST_LENGTH=6",
                       "--set", "train_batch_size=8192", "--set", "eval_batch_size=8192",
                       "--set", "topk=[10]"])
    tag = "RecBLR_beauty-synth_m0p5"
    assert list(out) == [tag]
    summary = json.load(open(tmp_path / "res" / f"{tag}.summary.json"))
    assert summary["dataset"] == "beauty-synth_m0p5" and summary["epochs"] == 1
    assert summary["generator_params"]["markov_weight"] == 0.5
    assert set(summary["test"]) == {"hit@10", "ndcg@10", "mrr@10"}
    assert summary["backend"] == "cpu" and summary["train_s_per_epoch"] > 0
    assert os.path.exists(tmp_path / "res" / f"{tag}.jsonl")
    assert os.path.exists(tmp_path / "res" / f"{tag}_training_metrics.csv")
    assert not os.path.exists(tmp_path / "artifacts" / "parity")


# ---------------------------------------------------------------------------
# FLOPs: the products of one evaluation forward, summed by hand
# ---------------------------------------------------------------------------

B, D = 6, 16


def _recblr_products(b, t, d, c, f):
    full = 2 * b * t * (d * 2 * c + c * 2 * c + c * d + 2 * d * f)
    # the top layer: the in-projection's first half and the gates over
    # every position, the rest at the last position only
    top = 2 * b * t * (d * c + c * 2 * c) + 2 * b * (d * c + c * d + 2 * d * f)
    return full + top


def _encoder_products(b, t, d, f):
    full = 2 * b * t * (4 * d * d + 2 * d * f) + 2 * 2 * b * t * t * d
    # the top layer at the last position: keys and values over every
    # position, the query, scores, context, W_o and the FFN at one
    top = 2 * b * t * 2 * d * d + 2 * b * (2 * d * d + 2 * d * f) + 2 * 2 * b * t * d
    return full + top


@pytest.mark.parametrize("name", ["RecBLR", "SASRec", "BERT4Rec"])
def test_forward_flops_are_the_products(name):
    cfg = Config(model=name, config_dict={"hidden_size": D, "MAX_ITEM_LIST_LENGTH": T,
                                          "inner_size": 4 * D, "n_heads": 2})
    model = get_model(name)(cfg, 50, T, device="cpu")
    want = {"RecBLR": _recblr_products(B, T, D, 2 * D, 4 * D),
            "SASRec": _encoder_products(B, T, D, 4 * D),
            "BERT4Rec": _encoder_products(B, T, D, 4 * D) + 2 * B * D * D}[name]
    seq = torch.ones((B, T), dtype=torch.long)
    got = forward_flops(model, seq, torch.full((B,), T))
    assert got == want
    assert forward_flops(model, torch.ones((2 * B, T), dtype=torch.long),
                         torch.full((2 * B,), T)) == 2 * want


# ---------------------------------------------------------------------------
# plots, environment, profiler
# ---------------------------------------------------------------------------

RECORDS = [{"event": "epoch", "epoch": 0, "train_loss": 3.5, "train_time": 1.0,
            "valid_score": 0.1, "eval_time": 0.2, "valid_hit@10": 0.2, "valid_ndcg@10": 0.1},
           {"event": "epoch", "epoch": 1, "train_loss": 3.1, "train_time": 1.1}]


def test_plots_and_csv(tmp_path):
    plotting.generate_plots(RECORDS, "run", str(tmp_path))
    names = sorted(os.listdir(tmp_path))
    assert names == sorted(["run_training_metrics.csv", "runtrain_loss_plot.png",
                            "runvalid_score_plot.png", "runhit_rate_plot.png",
                            "runndcg_plot.png", "runmrr_plot.png"])
    lines = open(tmp_path / "run_training_metrics.csv").read().splitlines()
    assert lines[0] == ("epoch,train_loss,valid_score,train_time,eval_time,device_mem_gb,"
                        "hit@10,ndcg@10")
    assert lines[2] == "1,3.1,,1.1,,,,"
    assert plotting.generate_plots([], "none", str(tmp_path)) == []


def test_plots_are_skipped_without_matplotlib(tmp_path, monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    import logging

    logger = logging.getLogger("recblr_torch")
    monkeypatch.setattr(logger, "propagate", True)
    with caplog.at_level(logging.INFO, logger="recblr_torch"):
        rows = plotting.generate_plots(RECORDS, "run", str(tmp_path))
    assert len(rows) == 2
    assert os.listdir(tmp_path) == ["run_training_metrics.csv"]
    assert "plots were skipped" in caplog.text


def test_environment_report_on_the_cpu():
    env = environment_report()
    assert env["backend"] == ("cuda" if torch.cuda.is_available() else "cpu")
    assert env["torch"] == torch.__version__ and env["device_count"] >= 1
    text = format_environment(env)
    assert text.startswith(f"backend={env['backend']} ")


def test_profile_dir_writes_a_trace(small, tmp_path):
    from datamining_recblr_torch.data.dataset import build_dataset

    cfg = Config(model="RecBLR", dataset="small", config_dict=_cfg(
        small, use_pallas_scan="never", checkpoint_dir=str(tmp_path / "saved"),
        profile_dir=str(tmp_path / "prof")))
    data = build_dataset(cfg)
    trainer = Trainer(cfg, get_model("RecBLR")(cfg, data.n_items, T, device="cpu"))
    trainer.fit(data)
    # the second epoch (start_epoch + 1) is traced
    assert os.listdir(tmp_path / "prof") == ["trace_epoch1.json"]
    trace = json.load(open(tmp_path / "prof" / "trace_epoch1.json"))
    assert trace["traceEvents"]
