"""Training-curve CSV and plots (counterpart of
``datamining_recblr_tpu/utils/plotting.py``), with ``csv`` in place of
pandas: ``<prefix>_training_metrics.csv`` always, the five per-run plots
and the cross-run comparison bars under the JAX package's names where
matplotlib is importable."""

from __future__ import annotations

import csv
import logging
import math
import os

_BASE = ("epoch", "train_loss", "valid_score", "train_time", "eval_time", "device_mem_gb")


def records_to_rows(epoch_records: list[dict]) -> tuple[list[str], list[dict]]:
    """(columns, rows) of the per-epoch table: the JAX package's
    ``records_to_dataframe`` columns, each ``valid_<metric>`` as
    ``<metric>`` after the fixed ones, in first-seen order."""
    columns, rows = list(_BASE), []
    for r in epoch_records:
        row = {k: r.get(k) for k in _BASE}
        for k, v in r.items():
            if k.startswith("valid_") and k != "valid_score":
                name = k.removeprefix("valid_")
                row[name] = v
                if name not in columns:
                    columns.append(name)
        rows.append(row)
    return columns, rows


def _cell(v):
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return ""
    return v


def _plot_series(rows, columns, title, ylabel, path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 5))
    for col in columns:
        pts = [(r["epoch"], r.get(col)) for r in rows if r.get(col) is not None]
        if pts:
            ax.plot([p[0] for p in pts], [p[1] for p in pts], marker="o", markersize=3,
                    label=col)
    ax.set_xlabel("epoch")
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    ax.grid(True, alpha=0.3)
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def _have_matplotlib() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def generate_plots(epoch_records: list[dict], prefix: str, out_dir: str = "plot"):
    """Write ``<prefix>_training_metrics.csv`` and, with matplotlib, the
    five per-run plots (``<prefix>train_loss_plot.png``, ...); without
    matplotlib log one line and write the CSV alone.  Returns the rows."""
    os.makedirs(out_dir, exist_ok=True)
    columns, rows = records_to_rows(epoch_records)
    if not rows:
        return rows
    with open(os.path.join(out_dir, f"{prefix}_training_metrics.csv"), "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(columns)
        w.writerows([_cell(r.get(c)) for c in columns] for r in rows)
    if not _have_matplotlib():
        logging.getLogger("recblr_torch").info(
            "matplotlib is not installed: the plots were skipped, the CSV was written")
        return rows
    join = lambda name: os.path.join(out_dir, f"{prefix}{name}")  # noqa: E731
    _plot_series(rows, ["train_loss"], "Training loss", "loss", join("train_loss_plot.png"))
    _plot_series(rows, ["valid_score"], "Validation score", "score",
                 join("valid_score_plot.png"))
    for stem, title, file in (("hit@", "Hit rate", "hit_rate_plot.png"),
                              ("ndcg@", "NDCG", "ndcg_plot.png"),
                              ("mrr@", "MRR", "mrr_plot.png")):
        _plot_series(rows, [c for c in columns if c.startswith(stem)], title,
                     stem[:-1], join(file))
    return rows


# (column, file suffix, aggregate over a run's epochs): the bars of
# ``generate_comparison_plots``
_COMPARED = (("train_time", "train_time", "mean"), ("eval_time", "eval_time", "mean"),
             ("device_mem_gb", "device_mem", "max"))


def generate_comparison_plots(runs: dict[str, list[dict]], out_dir: str = "plot",
                              prefix: str = "comparison") -> dict[str, list[dict]]:
    """Bars across runs ({label: epoch records}) of the mean train and eval
    time an epoch and the peak device memory, as
    ``<prefix>_{train_time,eval_time,device_mem}.png``, each over the runs
    that recorded the column; without matplotlib log one line and draw
    nothing.  Returns {label: per-epoch rows}."""
    rows = {name: records_to_rows(recs)[1] for name, recs in runs.items()}
    if not _have_matplotlib():
        logging.getLogger("recblr_torch").info(
            "matplotlib is not installed: the comparison plots were skipped")
        return rows
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    for metric, suffix, agg in _COMPARED:
        names, vals = [], []
        for name, table in rows.items():
            seen = [r[metric] for r in table if _cell(r.get(metric)) != ""]
            if seen:
                names.append(name)
                vals.append(float(max(seen) if agg == "max" else sum(seen) / len(seen)))
        if not names:
            continue
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.bar(names, vals)
        ax.set_ylabel(f"{agg} {metric} ({'GB' if metric.endswith('_gb') else 's'})")
        ax.set_title(metric)
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, f"{prefix}_{suffix}.png"), dpi=110)
        plt.close(fig)
    return rows
