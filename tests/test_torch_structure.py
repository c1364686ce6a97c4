"""Structure of the port: it imports no JAX and nothing of the JAX
package, nor pandas, PyYAML or sklearn (the card's machine has none of
them), nor optax, ml_dtypes or tensorstore (the orbax reader imports
tensorstore where it reads), its entry points default to the card, and a
CPU run launches no kernel."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from datamining_recblr_torch.config import Config
from datamining_recblr_torch.models import get_model
from datamining_recblr_torch.ops import fused_layer as FL
from datamining_recblr_torch.serve import Recommender

ROOT = Path(__file__).resolve().parents[1]
MODULES = [
    "datamining_recblr_torch",
    "datamining_recblr_torch.config",
    "datamining_recblr_torch.interop",
    "datamining_recblr_torch.serve",
    "datamining_recblr_torch.models.recblr",
    "datamining_recblr_torch.models.sasrec",
    "datamining_recblr_torch.models.bert4rec",
    "datamining_recblr_torch.models.layers",
    "datamining_recblr_torch.ops._cuda",
    "datamining_recblr_torch.ops.fused_layer",
    "datamining_recblr_torch.ops.fused_block",
    "datamining_recblr_torch.ops.fused_ce",
    "datamining_recblr_torch.ops.fused_layer_chunked",
    "datamining_recblr_torch.ops.embedding",
    "datamining_recblr_torch.ops.scan",
    "datamining_recblr_torch.ops.seq_parallel_scan",
    "datamining_recblr_torch.ops.fused_bdlru",
    "datamining_recblr_torch.ops.philox",
    "datamining_recblr_torch.ops.topk",
    "datamining_recblr_torch.models.base",
    "datamining_recblr_torch.data.atomic",
    "datamining_recblr_torch.data.batching",
    "datamining_recblr_torch.data.dataset",
    "datamining_recblr_torch.data.synthetic",
    "datamining_recblr_torch.eval.metrics",
    "datamining_recblr_torch.eval.evaluator",
    "datamining_recblr_torch.train.checkpoint",
    "datamining_recblr_torch.train.jax_checkpoint",
    "datamining_recblr_torch.convert_checkpoint",
    "datamining_recblr_torch.data.native",
    "datamining_recblr_torch.train.optim",
    "datamining_recblr_torch.train.trainer",
    "datamining_recblr_torch.utils.logging",
    "datamining_recblr_torch.utils.env",
    "datamining_recblr_torch.utils.flops",
    "datamining_recblr_torch.utils.plotting",
    "datamining_recblr_torch.config.presets",
    "datamining_recblr_torch.drivers",
    "datamining_recblr_torch.drivers.experiment",
    "datamining_recblr_torch.run",
    "datamining_recblr_torch.parity",
    "datamining_recblr_torch.unseen",
    "datamining_recblr_torch.unseen.features",
    "datamining_recblr_torch.unseen.similarity",
    "datamining_recblr_torch.unseen.pipeline",
    "datamining_recblr_torch.run_with_unseen",
    "datamining_recblr_torch.prepare_item_features",
    "datamining_recblr_torch.full_exp",
    "datamining_recblr_torch.run_bert4rec",
    "datamining_recblr_torch.compare_plots",
    "datamining_recblr_torch.trim",
    "datamining_recblr_torch.parallel",
    "datamining_recblr_torch.parallel.mesh",
    "datamining_recblr_torch.parallel.sharding",
    "datamining_recblr_torch.parallel.input",
    "datamining_recblr_torch.parallel.collectives",
    "datamining_recblr_torch.parallel.steps",
]
FORBIDDEN = ("jax", "jaxlib", "datamining_recblr_tpu", "pandas", "yaml", "sklearn", "optax",
             "ml_dtypes", "tensorstore")


def _run_clean(code):
    """Run ``code`` in a fresh interpreter, then fail if it imported any
    FORBIDDEN package."""
    code += (
        "\nimport sys\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True,
                   timeout=120)


@pytest.mark.parametrize("module", MODULES + ["chip_smoke"])
def test_imports_no_jax(module):
    _run_clean(f"import importlib\nimportlib.import_module({module!r})")


def test_training_on_the_cpu_imports_no_pandas_or_yaml(tmp_path):
    """Data build, one epoch of Trainer.fit and evaluation, end to end."""
    _run_clean(
        "from datamining_recblr_torch.config import Config\n"
        "from datamining_recblr_torch.data.dataset import build_from_dataframe\n"
        "from datamining_recblr_torch.data.synthetic import generate_synthetic_interactions\n"
        "from datamining_recblr_torch.models import get_model\n"
        "from datamining_recblr_torch.train.trainer import Trainer\n"
        "data = build_from_dataframe(generate_synthetic_interactions(n_users=20, "
        "n_items=15), max_seq_len=8)\n"
        "cfg = Config(model='RecBLR', config_dict={'hidden_size': 8, 'epochs': 1, "
        f"'MAX_ITEM_LIST_LENGTH': 8, 'checkpoint_dir': {str(tmp_path)!r}}})\n"
        "t = Trainer(cfg, get_model('RecBLR')(cfg, data.n_items, 8, device='cpu'))\n"
        "t.fit(data)\n"
        "t.evaluate(data.test)\n"
    )


def test_an_experiment_on_the_cpu_imports_no_pandas_or_yaml(tmp_path):
    """The written stat-matched log, ``build_dataset`` and one epoch of
    ``run_experiment`` through ``python -m datamining_recblr_torch.run``
    with the reference preset: no yaml reader, no pandas."""
    _run_clean(
        "import os\n"
        "from datamining_recblr_torch.data.synthetic import write_stat_matched_dataset\n"
        "from datamining_recblr_torch import run\n"
        f"os.chdir({str(tmp_path)!r})\n"
        "write_stat_matched_dataset('dataset', 'ml1m-synth', out_name='t', n_users=40, "
        "n_items=30, n_inters=900, n_clusters=5)\n"
        "run.main(['--config', 'reference', '-d', 't', '--epochs', '1', '--device', 'cpu', "
        "'--set', 'hidden_size=8', '--set', 'MAX_ITEM_LIST_LENGTH=8'])\n"
    )


def test_a_cold_start_run_on_the_cpu_imports_no_pandas_yaml_or_sklearn(tmp_path):
    """The written log, the user split, one epoch, the similarity and the
    held-out users through ``python -m datamining_recblr_torch.full_exp
    --exp unseen`` (both modes) with the reference preset's keys cut to a
    small width."""
    _run_clean(
        "import os\n"
        "from datamining_recblr_torch.config import presets\n"
        "from datamining_recblr_torch.data.synthetic import write_stat_matched_dataset\n"
        "from datamining_recblr_torch import full_exp\n"
        f"os.chdir({str(tmp_path)!r})\n"
        "write_stat_matched_dataset('dataset', 'beauty-synth', out_name='t', n_users=60, "
        "n_items=50, n_inters=700, n_clusters=5)\n"
        "presets.PRESETS['reference'].update(dataset='t', hidden_size=8, "
        "MAX_ITEM_LIST_LENGTH=8)\n"
        "out = full_exp.main(['--exp', 'unseen', '--config', 'reference', '--epochs', '1', "
        "'--device', 'cpu'])\n"
        "assert out['pre']['n_evaluated'] >= out['none']['n_evaluated'] > 0, out\n"
    )


def _cfg():
    return Config(model="RecBLR", config_dict={"hidden_size": 16, "num_layers": 2,
                                               "MAX_ITEM_LIST_LENGTH": 8})


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        assert get_model("RecBLR")(_cfg(), 20, 8).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model("RecBLR")(_cfg(), 20, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model("RecBLR")(_cfg(), 20, 8, device="cuda")


def test_cpu_serving_launches_no_kernel():
    before = (FL.fused_recurrent_layer.launches, FL.fused_recurrent_layer_last.launches)
    model = get_model("RecBLR")(_cfg(), 20, 8, device="cpu")
    assert model.use_fused_layer()
    ids, vals = Recommender(model, top_k=3).recommend([[1, 2], [], list(range(1, 15))])
    assert ids.shape == (3, 3) and torch.isfinite(torch.from_numpy(vals)).all()
    after = (FL.fused_recurrent_layer.launches, FL.fused_recurrent_layer_last.launches)
    assert before == after


@pytest.mark.parametrize("name", ["SASRec", "BERT4Rec"])
def test_cpu_baseline_serving_launches_no_kernel(name):
    from datamining_recblr_torch.ops import fused_block as FB

    counted = (FL.fused_ln_dropout, FB.fused_transformer_layer,
               FB.fused_transformer_layer_last)
    before = [f.launches for f in counted]
    cfg = Config(model=name, config_dict={"hidden_size": 16, "inner_size": 32,
                                          "MAX_ITEM_LIST_LENGTH": 8})
    model = get_model(name)(cfg, 20, 8, device="cpu")
    ids, vals = Recommender(model, top_k=3).recommend([[1, 2], [], list(range(1, 15))])
    assert ids.shape == (3, 3) and torch.isfinite(torch.from_numpy(vals)).all()
    assert [f.launches for f in counted] == before


def test_unknown_model_is_not_ported():
    with pytest.raises(KeyError, match="not ported"):
        get_model("GRU4Rec")


def test_kernel_sources_ship_with_the_package():
    from datamining_recblr_torch.ops import _cuda

    for name in (*_cuda.SOURCES, *_cuda.HEADERS):
        assert (_cuda.SRC_DIR / name).is_file()
    assert set(_cuda._SIGNATURES) == set(_cuda.SOURCES)


def test_an_edit_of_the_forward_phases_rebuilds_every_source():
    """Phase A and the tail of the RecBLR layer forwards live in a header
    (csrc/layer_fwd.cuh) that the build hashes into every library."""
    from datamining_recblr_torch.ops import _cuda

    assert "layer_fwd.cuh" in _cuda.HEADERS
    for src in ("fused_layer.cu", "fused_layer_last.cu", "fused_layer_chunked.cu",
                "fused_bdlru.cu"):
        assert '#include "layer_fwd.cuh"' in (_cuda.SRC_DIR / src).read_text()


def test_the_long_context_kernels_are_built():
    """The kernels of the long-context path and of the table gradient are
    among the sources the build compiles."""
    from datamining_recblr_torch.ops import _cuda

    assert {"fused_layer_chunked.cu", "fused_layer_chunked_bwd.cu", "fused_ce_chunked.cu",
            "emb_grad.cu"} <= set(_cuda.SOURCES)
    assert "ce_common.cuh" in _cuda.HEADERS
    assert len(_cuda.SOURCES) == 21


def test_the_kernels_outside_the_whole_layer_kernels_are_built():
    """The one-layer input LN (in ln_dropout.cu), the linear scan and the
    standalone BD-LRU, forward and backward, are among the build's
    sources and entry points."""
    from datamining_recblr_torch.ops import _cuda

    assert {"linear_scan.cu", "fused_bdlru.cu", "fused_bdlru_bwd.cu"} <= set(_cuda.SOURCES)
    assert {"recblr_dropout_ln_fwd", "recblr_dropout_ln_bwd"} <= set(
        _cuda._SIGNATURES["ln_dropout.cu"])


def test_the_attention_kernels_are_built():
    """Queue B row 15, the masked-softmax attention, forward and backward,
    is among the build's sources and entry points (with the queries of
    blocks an SM that chip_smoke.py reports for its tensor-core kernels)."""
    from datamining_recblr_torch.ops import _cuda

    assert {"attention.cu", "attention_bwd.cu"} <= set(_cuda.SOURCES)
    assert "attention.cuh" in _cuda.HEADERS
    assert set(_cuda._SIGNATURES["attention.cu"]) == {"recblr_attn_fwd",
                                                      "recblr_attn_fwd_blocks_per_sm"}
    assert set(_cuda._SIGNATURES["attention_bwd.cu"]) == {"recblr_attn_bwd",
                                                          "recblr_attn_bwd_blocks_per_sm"}
