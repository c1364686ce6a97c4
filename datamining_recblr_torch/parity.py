"""Quality-parity experiment on stat-matched synthetic data (counterpart
of the root ``parity_exp.py``): generate (or reuse) a dataset whose
post-filter statistics match a reference dataset's
(``data/synthetic.py:STAT_PRESETS``), then run the whole training
protocol of a config (by default the root ``config.yaml``'s keys, the
``reference`` preset: Adam
1e-3, batch 2,048, CE over the catalog, T 200, early stop 10 on valid
NDCG@10, eval batch 4,096, top-k 10 and 20) and record the metrics.

    python -m datamining_recblr_torch.parity --dataset ml1m-synth --model R
    python -m datamining_recblr_torch.parity --dataset beauty-synth --model all --device cpu

Results land in ``artifacts/parity_torch/`` (``--out``): per run
``<Model>_<dataset>[_<tag>].summary.json``, the metrics JSONL, the
training-curve CSV and, with matplotlib, the plots.  A dataset generated
with any override of the preset, or another seed, goes to a suffixed
directory, so the canonical dataset is never replaced.
"""

from __future__ import annotations

import argparse
import json
import os
from statistics import mean

from datamining_recblr_torch.data.synthetic import STAT_PRESETS, write_stat_matched_dataset
from datamining_recblr_torch.drivers import run_experiment
from datamining_recblr_torch.eval.evaluator import format_result
from datamining_recblr_torch.run import build_config, parse_sets

MODELS = {"R": "RecBLR", "S": "SASRec", "B": "BERT4Rec"}


def generator_overrides(markov=None, clusters=None, within=None, pref=None,
                        pref_k=None) -> dict:
    named = {"markov_weight": markov, "n_clusters": clusters, "within_cluster": within,
             "pref_weight": pref, "pref_k": pref_k}
    return {k: v for k, v in named.items() if v is not None}


def ensure_dataset(data_path, name, markov=None, clusters=None, within=None, seed=2020,
                   tag="", pref=None, pref_k=None) -> str:
    """Generate (or reuse) the stat-matched dataset; returns its name.
    Generator overrides, or a seed other than 2020, write to a suffixed
    directory (the ``tag``, or the overrides spelled out, and ``_s<seed>``),
    and a dataset with overrides is written anew each time."""
    overrides = generator_overrides(markov, clusters, within, pref, pref_k)
    ds_name = name
    if overrides:
        suffix = tag or "_".join(
            f"{k[0]}{v}" for k, v in sorted(overrides.items())).replace(".", "p")
        ds_name = f"{name}_{suffix}"
    if seed != 2020 and not tag:
        ds_name = f"{ds_name}_s{seed}"
    path = os.path.join(data_path, ds_name, f"{ds_name}.inter")
    if overrides or not os.path.exists(path):
        write_stat_matched_dataset(data_path, name, seed=seed, out_name=ds_name, **overrides)
    return ds_name


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default="beauty-synth", choices=sorted(STAT_PRESETS))
    ap.add_argument("--model", default="R", help="R, S, B, or 'all'")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--markov", type=float, default=None,
                    help="override the preset's markov_weight (regenerates)")
    ap.add_argument("--clusters", type=int, default=None,
                    help="override the preset's n_clusters (regenerates)")
    ap.add_argument("--within", default=None, choices=["pop", "uniform", "sqrt"],
                    help="override the preset's within_cluster mode")
    ap.add_argument("--pref", type=float, default=None,
                    help="override the preset's pref_weight (regenerates)")
    ap.add_argument("--pref_k", type=int, default=None,
                    help="override the preset's pref_k (regenerates)")
    ap.add_argument("--tag", default="", help="suffix for artifact names")
    ap.add_argument("--gen_seed", type=int, default=2020, help="generator seed")
    ap.add_argument("--out", default=os.path.join("artifacts", "parity_torch"))
    ap.add_argument("--data_path", default="dataset")
    ap.add_argument("--config", default="reference",
                    help="preset name or yaml file (config/presets.py); the default, "
                    "reference, holds the root config.yaml's keys")
    ap.add_argument("--override", "--set", dest="override", action="append", default=[],
                    metavar="KEY=VALUE", help="extra config override(s)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    ds_name = ensure_dataset(args.data_path, args.dataset, args.markov, args.clusters,
                             args.within, seed=args.gen_seed, tag=args.tag, pref=args.pref,
                             pref_k=args.pref_k)
    os.makedirs(args.out, exist_ok=True)
    resolved = dict(STAT_PRESETS[args.dataset],
                    **generator_overrides(args.markov, args.clusters, args.within, args.pref,
                                          args.pref_k))
    results = {}
    for key in (list(MODELS) if args.model == "all" else [args.model]):
        name = MODELS.get(key, key)
        tag = f"{name}_{ds_name}"
        if args.tag and args.tag not in ds_name:
            tag = f"{tag}_{args.tag}"
        overrides = {"data_path": args.data_path, "metrics_file": f"{args.out}/{tag}.jsonl",
                     "checkpoint_dir": "saved", "log_dir": "log"}
        if args.epochs is not None:
            overrides["epochs"] = args.epochs
        overrides.update(parse_sets(args.override))
        config = build_config(name, ds_name, [args.config], overrides)
        result = run_experiment(config, plot_prefix=tag, plot_dir=args.out, device=args.device)
        epochs = result["metrics"].epoch_records()
        env = result["environment"]
        summary = {
            "model": name,
            "dataset": ds_name,
            "preset": args.dataset,
            "gen_seed": args.gen_seed,
            "generator_params": resolved,
            "config_overrides": dict(kv.partition("=")[::2] for kv in args.override),
            "best_valid": result["best_valid_result"],
            "test": result["test_result"],
            "wall_time_s": round(result["wall_time"], 1),
            "epochs": len(epochs),
            "best_epoch": result["trainer"].best_epoch,
            "train_s_per_epoch": mean(r["train_time"] for r in epochs) if epochs else None,
            "eval_s_per_epoch": (mean(r["eval_time"] for r in epochs if "eval_time" in r)
                                 if any("eval_time" in r for r in epochs) else None),
            "backend": env["backend"],
            "devices": env["devices"],
            "nvidia_smi": env["nvidia_smi"],
        }
        with open(f"{args.out}/{tag}.summary.json", "w") as f:
            json.dump(summary, f, indent=1)
        print(f"[{tag}] best valid: {format_result(result['best_valid_result'])}")
        print(f"[{tag}] test:       {format_result(result['test_result'])}")
        results[tag] = summary
    return results


if __name__ == "__main__":
    main()
