"""BERT4Rec over several per-dataset configs (counterpart of the root
``run_bert4rec.py``): one run each, its plots, then comparison bars
``bert4rec_*.png``.

    python -m datamining_recblr_torch.run_bert4rec [--config amazon-beauty ...] \\
        [--epochs 1] [--device cpu]

By default the presets ``amazon-beauty``, ``amazon-apps`` and ``yelp``
(the keys of ``configs/config_{amazon_beauty,amazon_apps,yelp}.yaml``,
which the root script reads); ``--config`` takes a preset, a preset's
yaml file or another yaml file.  Runs are on the card unless
``--device`` names another.
"""

from __future__ import annotations

import argparse
import os

from datamining_recblr_torch.drivers import run_experiment
from datamining_recblr_torch.eval.evaluator import format_result
from datamining_recblr_torch.run import build_config
from datamining_recblr_torch.utils.plotting import generate_comparison_plots

DEFAULT_CONFIGS = ["amazon-beauty", "amazon-apps", "yelp"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", action="append", default=None)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    overrides = {} if args.epochs is None else {"epochs": args.epochs}
    runs, results = {}, {}
    for spec in args.config or DEFAULT_CONFIGS:
        cfg = build_config("BERT4Rec", None, [spec], overrides)
        name = cfg.get("dataset") or os.path.basename(spec)
        result = run_experiment(cfg, plot_prefix=f"BERT4Rec_{name}", device=args.device)
        runs[name] = result["metrics"].epoch_records()
        results[name] = result
        print(f"[{name}] test:", format_result(result["test_result"]))
    generate_comparison_plots(runs, prefix="bert4rec")
    return results


if __name__ == "__main__":
    main()
