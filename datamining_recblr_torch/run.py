"""Single-model experiment entry point (counterpart of the root
``run.py``): train with per-epoch validation and early stopping, test
with the best checkpoint, write the metrics CSV and plots.

    python -m datamining_recblr_torch.run --model R --dataset ml1m-synth \\
        --config config.yaml --set epochs=1 [--device cpu]

``--config`` names a preset (``config/presets.py``: reference,
ml1m-paper, beauty-paper, xlong-paper), the yaml file a preset mirrors
(read as the preset, no yaml reader needed), or another yaml file;
``--set KEY=VALUE`` overrides a key (numbers, true/false and none
parsed).  The run is on the card unless ``--device`` names another.

A meshed run starts one process per rank with ``torch.distributed.run``:

    python -m torch.distributed.run --nproc-per-node 4 \
        -m datamining_recblr_torch.run --model R --dataset ml1m-synth \
        --set "mesh_shape={'data': 2, 'model': 2}" --set multihost=True

each rank on ``cuda:LOCAL_RANK``; ``--device`` names the card where the
ranks share one (then ``--set "multihost_args={'backend': 'gloo'}"``, as
NCCL takes one rank a card), or ``cpu`` (gloo).  Every model also shards
its time axis over a ``seq`` axis, beside ``data`` and ``model``: ``--set
"mesh_shape={'data': 2, 'seq': 2}"`` or ``"{'model': 2, 'seq': 2}"``
(MAX_ITEM_LIST_LENGTH must divide by it).
"""

from __future__ import annotations

import argparse
import ast
import os

from datamining_recblr_torch.config import Config
from datamining_recblr_torch.config.presets import config_layers
from datamining_recblr_torch.drivers import run_experiment
from datamining_recblr_torch.eval.evaluator import format_result

MODEL_NAMES = {"B": "BERT4Rec", "R": "RecBLR", "S": "SASRec"}


def parse_value(text: str):
    """A ``--set`` value: a Python literal (numbers, lists, dicts),
    true/false/none in any case, else the string itself."""
    low = text.strip().lower()
    if low in ("true", "false", "none", "null", "~"):
        return {"true": True, "false": False}.get(low)
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def parse_sets(pairs) -> dict:
    out = {}
    for kv in pairs or []:
        key, sep, value = kv.partition("=")
        if not sep:
            raise SystemExit(f"--set expects KEY=VALUE, got {kv!r}")
        out[key.strip()] = parse_value(value)
    return out


def build_config(model_name: str, dataset, specs, overrides: dict) -> Config:
    """The layered config of a run: builtin and model defaults, each
    ``--config`` (preset dict or yaml file), then ``overrides``; models
    other than RecBLR drop RecBLR's ablation flags, as the root scripts
    do."""
    files, preset = [], {}
    for spec in specs:
        f, d = config_layers(spec)
        files += f
        preset.update(d)
    config = Config(model=model_name, dataset=dataset, config_file_list=files,
                    config_dict=preset)
    if model_name != "RecBLR":
        config.update(dict(bd_lru_only=False, disable_conv1d=False, disable_ffn=False))
    config.update(overrides)
    if dataset is not None:
        config["dataset"] = dataset
    return config


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", "-m", default="R",
                    help="B (BERT4Rec), R (RecBLR), S (SASRec), or a full model name")
    ap.add_argument("--config", "-c", action="append", default=None,
                    help="preset name or yaml file (repeatable); default config.yaml "
                    "when it exists")
    ap.add_argument("--dataset", "-d", default=None)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--plot_prefix", default=None)
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="override a config key (repeatable)")
    ap.add_argument("--device", default=None,
                    help="cuda (default; cuda:LOCAL_RANK on a mesh) or cpu")
    args = ap.parse_args(argv)

    model_name = MODEL_NAMES.get(args.model, args.model)
    specs = args.config
    if specs is None:
        specs = ["config.yaml"] if os.path.exists("config.yaml") else []
    overrides = parse_sets(args.set)
    if args.epochs is not None:
        overrides["epochs"] = args.epochs
    config = build_config(model_name, args.dataset, specs, overrides)
    result = run_experiment(config, plot_prefix=args.plot_prefix, device=args.device)
    print("best valid:", format_result(result["best_valid_result"]))
    print("test:", format_result(result["test_result"]))
    return result


if __name__ == "__main__":
    main()
