"""Structure of the port: it imports no JAX and nothing of the JAX
package, its entry points default to the card, and a CPU run launches
no kernel."""

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
    "datamining_recblr_torch.ops._cuda",
    "datamining_recblr_torch.ops.fused_layer",
    "datamining_recblr_torch.ops.topk",
    "datamining_recblr_torch.eval.metrics",
    "datamining_recblr_torch.train.checkpoint",
]


@pytest.mark.parametrize("module", MODULES + ["chip_smoke"])
def test_imports_no_jax(module):
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
        "'datamining_recblr_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True,
                   timeout=120)


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


def test_unknown_model_is_not_ported():
    with pytest.raises(KeyError, match="not ported"):
        get_model("SASRec")


def test_kernel_sources_ship_with_the_package():
    from datamining_recblr_torch.ops import _cuda

    for name in (*_cuda.SOURCES, *_cuda.HEADERS):
        assert (_cuda.SRC_DIR / name).is_file()
    assert set(_cuda._SIGNATURES) == set(_cuda.SOURCES)
