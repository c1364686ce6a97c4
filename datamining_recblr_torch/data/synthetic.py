"""Synthetic interaction generators (counterpart of the generators of
``datamining_recblr_tpu/data/synthetic.py`` that tests and the bench
use), with NumPy alone: the same random draws in the same order, so a
seed gives the JAX package's log and splits."""

from __future__ import annotations

import numpy as np

from datamining_recblr_torch.data.dataset import SplitArrays


def generate_synthetic_interactions(
    n_users: int = 200,
    n_items: int = 100,
    min_len: int = 5,
    max_len: int = 30,
    markov_weight: float = 0.8,
    n_clusters: int = 8,
    seed: int = 0,
) -> dict:
    """Markov-cluster interaction log as a frame (``data/dataset.py``):
    items belong to clusters; the next item stays within the current
    item's cluster with prob ``markov_weight``, else jumps uniformly.
    Timestamps increase per user."""
    rng = np.random.default_rng(seed)
    clusters = rng.integers(0, n_clusters, size=n_items)
    members = [np.flatnonzero(clusters == c) for c in range(n_clusters)]
    members = [m if len(m) else np.arange(n_items) for m in members]

    rows_u, rows_i, rows_t = [], [], []
    for u in range(n_users):
        length = int(rng.integers(min_len, max_len + 1))
        item = int(rng.integers(0, n_items))
        t0 = float(rng.integers(1_000_000, 2_000_000))
        for s in range(length):
            rows_u.append(f"u{u}")
            rows_i.append(f"i{item}")
            rows_t.append(t0 + s)
            if rng.random() < markov_weight:
                item = int(rng.choice(members[clusters[item]]))
            else:
                item = int(rng.integers(0, n_items))
    return {
        "user_id": np.array(rows_u, dtype=str),
        "item_id": np.array(rows_i, dtype=str),
        "timestamp": np.array(rows_t, np.float64),
    }


def synthetic_splits(n_users: int, n_items: int, max_seq_len: int, n_train: int,
                     seed: int = 0):
    """Random fixed-shape (train, valid) SplitArrays at a target scale,
    ids in [1, n_items) (throughput benchmarking: no file IO, no
    augmentation)."""
    rng = np.random.default_rng(seed)

    def make(n):
        lens = rng.integers(2, max_seq_len + 1, size=n).astype(np.int32)
        seq = rng.integers(1, n_items, size=(n, max_seq_len), dtype=np.int32)
        mask = np.arange(max_seq_len)[None, :] < lens[:, None]
        seq = np.where(mask, seq, 0).astype(np.int32)
        tgt = rng.integers(1, n_items, size=n, dtype=np.int32)
        usr = rng.integers(1, n_users, size=n, dtype=np.int32)
        return SplitArrays(seq, lens, tgt, usr)

    return make(n_train), make(max(n_train // 8, 1))
