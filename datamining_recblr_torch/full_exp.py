"""Experiment sweeps (counterpart of the root ``full_exp.py``), each
variant a config in this process, the dataset built once and shared:

    python -m datamining_recblr_torch.full_exp --exp comp --model r --mode all
    python -m datamining_recblr_torch.full_exp --exp model --config reference
    python -m datamining_recblr_torch.full_exp --exp unseen [--mode none|pre] [--device cpu]

``--exp comp``: ablations of one ``--model`` (default, 1layer, bdlru,
noconv, noff, or all; the flags act on RecBLR only), with comparison
bars ``ablation_*.png``; ``--exp model``: RecBLR, BERT4Rec and SASRec,
bars ``comparison_*.png``; ``--exp unseen``: the cold-start pipeline,
modes none and pre unless ``--mode`` names one.  ``--config`` takes a
preset, a preset's yaml file or another yaml file (default: config.yaml
when it exists); runs are on the card unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import os

from datamining_recblr_torch.drivers import run_experiment
from datamining_recblr_torch.eval.evaluator import format_result
from datamining_recblr_torch.run import build_config
from datamining_recblr_torch.unseen.pipeline import run_unseen_experiment
from datamining_recblr_torch.utils.plotting import generate_comparison_plots

ABLATIONS = {
    "default": {},
    "1layer": {"num_layers": 1},
    "bdlru": {"bd_lru_only": True},
    "noconv": {"disable_conv1d": True},
    "noff": {"disable_ffn": True},
}
MODELS = {"r": "RecBLR", "b": "BERT4Rec", "s": "SASRec"}


def _sweep(variants, files, dataset, device, prefix):
    """Run each (label, plot prefix, model, overrides) on one shared
    dataset, then the comparison bars under ``prefix``.  Returns {label:
    result}."""
    results, runs, data = {}, {}, None
    for label, plot_prefix, model_name, overrides in variants:
        cfg = build_config(model_name, dataset, files, overrides)
        result = run_experiment(cfg, data=data, plot_prefix=plot_prefix, device=device)
        data = result["data"]
        runs[label] = result["metrics"].epoch_records()
        results[label] = result
        print(f"[{label}] test:", format_result(result["test_result"]))
    generate_comparison_plots(runs, prefix=prefix)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=["r", "b", "s", "R", "B", "S"], default="r",
                    help="model for --exp comp ablations (r=RecBLR, b=BERT4Rec, s=SASRec)")
    ap.add_argument("--exp", choices=["comp", "model", "unseen"], required=True)
    ap.add_argument("--mode", default=None, help="ablation/unseen mode or 'all'")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--dataset", default=None)
    ap.add_argument("--config", action="append", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    files = args.config
    if files is None:
        files = ["config.yaml"] if os.path.exists("config.yaml") else []
    base = {} if args.epochs is None else {"epochs": args.epochs}

    if args.exp == "unseen":
        modes = ["none", "pre"] if args.mode in (None, "all") else [args.mode]
        return {mode: run_unseen_experiment(mode=mode, dataset=args.dataset, config_files=files,
                                            epochs=args.epochs, device=args.device)
                for mode in modes}
    if args.exp == "comp":
        if args.mode is None:
            ap.error("--exp comp needs --mode: default, 1layer, bdlru, noconv, noff, all")
        model_name = MODELS[args.model.lower()]
        names = list(ABLATIONS) if args.mode == "all" else [args.mode]
        # the ablation flags act on RecBLR alone
        flags = ABLATIONS if model_name == "RecBLR" else dict.fromkeys(ABLATIONS, {})
        variants = [(name, f"{model_name}_{name}", model_name, {**base, **flags[name]})
                    for name in names]
        return _sweep(variants, files, args.dataset, args.device, "ablation")
    variants = [(m, m, m, base) for m in ("RecBLR", "BERT4Rec", "SASRec")]
    return _sweep(variants, files, args.dataset, args.device, "comparison")


if __name__ == "__main__":
    main()
