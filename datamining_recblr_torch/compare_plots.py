"""Cross-run comparison entry point (counterpart of the root
``compare_plots.py``): the bars of ``utils/plotting.py``'s
``generate_comparison_plots`` from metrics JSONL files.

    python -m datamining_recblr_torch.compare_plots a=runs/a.jsonl b=runs/b.jsonl --out plot

A file is named ``label=path``, or by its path alone (labelled by its
base name).  Without matplotlib nothing is drawn.
"""

from __future__ import annotations

import argparse
import os

from datamining_recblr_torch.utils.logging import load_metrics
from datamining_recblr_torch.utils.plotting import generate_comparison_plots


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("metrics_files", nargs="+",
                    help="metrics JSONL files (label=path or just path)")
    ap.add_argument("--out", default="plot")
    args = ap.parse_args(argv)

    runs = {}
    for spec in args.metrics_files:
        if "=" in spec:
            label, path = spec.split("=", 1)
        else:
            label, path = os.path.splitext(os.path.basename(spec))[0], spec
        runs[label] = [r for r in load_metrics(path) if r.get("event") == "epoch"]
    rows = generate_comparison_plots(runs, out_dir=args.out)
    print(f"comparison plots written to {args.out}/")
    return rows


if __name__ == "__main__":
    main()
