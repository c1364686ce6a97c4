"""Item features for the cold-start similarity (counterpart of
``datamining_recblr_tpu/unseen/features.py``), with numpy and ``csv`` in
place of pandas: the text columns of the ``.item`` atomic file when
there is one, otherwise a description of each item synthesized from its
interaction statistics (interaction-count bins, distinct users,
popularity percentile).  Frames are dicts of numpy columns, as in
``data/dataset.py``."""

from __future__ import annotations

import csv
import os

import numpy as np

from datamining_recblr_torch.data.atomic import read_atomic_file


def load_item_text_features(dataset_name: str, data_path: str) -> dict | None:
    """{"item_id", "description"}: the text (non-float) columns of
    ``<ds>.item`` joined by spaces per item, empty and ``"nan"`` values
    skipped; None without a ``.item`` file, an item-id column or a text
    column."""
    item_file = os.path.join(data_path, dataset_name, f"{dataset_name}.item")
    if not os.path.exists(item_file):
        # the reference also keeps .item files flat in data_path
        item_file = os.path.join(data_path, f"{dataset_name}.item")
        if not os.path.exists(item_file):
            return None
    frame = read_atomic_file(item_file)
    item_col = next((c for c in frame if "item" in c.lower() and "id" in c.lower()), None)
    if item_col is None:
        return None
    text_cols = [c for c in frame if c != item_col and frame[c].dtype.kind == "U"]
    if not text_cols:
        return None
    desc = [" ".join(v for v in row if v.strip() and v != "nan")
            for row in zip(*(frame[c].tolist() for c in text_cols))]
    return {"item_id": frame[item_col].astype(str), "description": np.array(desc, dtype=str)}


_BINS = (
    ("count", (0, 5, 20, 100, np.inf), ("rare", "uncommon", "common", "frequent")),
    ("n_users", (0, 3, 10, 50, np.inf), ("niche", "focused", "broad", "universal")),
    ("pct", (0, 0.25, 0.5, 0.75, 1.0), ("coldtail", "midtail", "warmtail", "head")),
)


def _cut(values: np.ndarray, edges, labels) -> np.ndarray:
    """``pd.cut(values, edges, labels=labels, include_lowest=True)
    .astype(str)``: right-closed bins, the lowest edge in the first one,
    "nan" outside them."""
    edges = np.asarray(edges, np.float64)
    ids = np.searchsorted(edges, values, side="left")
    ids[values == edges[0]] = 1
    ids[ids == len(edges)] = 0
    return np.array(("nan",) + tuple(labels))[ids]


def _pct_rank(values: np.ndarray) -> np.ndarray:
    """``Series.rank(pct=True)``: the average 1-based rank over ties,
    divided by n."""
    n = len(values)
    order = np.argsort(values, kind="stable")
    sv = values[order]
    starts = np.flatnonzero(np.r_[True, sv[1:] != sv[:-1]])
    ends = np.r_[starts[1:], n]
    dups = ends - starts
    avg = ((starts + 1 + ends) * dups // 2).astype(np.float64) / dups
    ranks = np.empty(n, np.float64)
    ranks[order] = np.repeat(avg, dups)
    return ranks / n


def synthesize_item_features(inter_df: dict, item_field: str = "item_id",
                             user_field: str = "user_id") -> dict:
    """{"item_id", "description"}, items in sorted order: "item activity
    <count bin> audience <distinct-user bin> popularity <percentile
    bin>"."""
    keys, inv = np.unique(np.asarray(inter_df[item_field]), return_inverse=True)
    inv = inv.reshape(-1)
    _, uinv = np.unique(np.asarray(inter_df[user_field]), return_inverse=True)
    pairs = np.unique(np.stack([inv, uinv.reshape(-1)]), axis=1)
    count = np.bincount(inv, minlength=len(keys))
    stats = {"count": count, "n_users": np.bincount(pairs[0], minlength=len(keys)),
             "pct": _pct_rank(count)}
    count_b, user_b, pop_b = (_cut(stats[name], edges, labels) for name, edges, labels in _BINS)
    desc = [f"item activity {c} audience {u} popularity {p}"
            for c, u, p in zip(count_b, user_b, pop_b)]
    return {"item_id": keys.astype(str), "description": np.array(desc, dtype=str)}


def prepare_item_features(dataset_name: str, data_path: str = "dataset",
                          out_path: str | None = None) -> dict:
    """Write ``<ds>_item_features.csv`` (columns item_id, description; the
    bytes of the JAX package's ``to_csv(index=False)``) from the
    ``.item`` text, or synthesized from ``<ds>.inter``; returns the
    frame."""
    feats = load_item_text_features(dataset_name, data_path)
    if feats is None:
        inter = os.path.join(data_path, dataset_name, f"{dataset_name}.inter")
        feats = synthesize_item_features(read_atomic_file(inter))
    out_path = out_path or os.path.join(data_path, dataset_name,
                                        f"{dataset_name}_item_features.csv")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["item_id", "description"])
        w.writerows(zip(feats["item_id"].tolist(), feats["description"].tolist()))
    return feats
