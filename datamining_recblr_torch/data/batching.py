"""Fixed-shape batching (counterpart of
``datamining_recblr_tpu/data/batching.py``): every batch has exactly
``batch_size`` rows, the trailing partial batch padded with row 0 at
``weight`` 0, so losses and metrics are weighted means over real rows.
"""

from __future__ import annotations

import numpy as np


def batch_count(n: int, batch_size: int) -> int:
    return (n + batch_size - 1) // batch_size


def iter_batches(split, batch_size: int):
    """Yield dict batches (item_seq, item_seq_len, pos_item, user_id,
    weight) of a SplitArrays in row order."""
    n = len(split)
    idx = np.arange(n)
    for start in range(0, n, batch_size):
        chunk = idx[start : start + batch_size]
        pad = batch_size - len(chunk)
        weight = np.ones(batch_size, np.float32)
        if pad:
            chunk = np.concatenate([chunk, np.zeros(pad, np.int64)])
            weight[len(weight) - pad :] = 0.0
        yield {
            "item_seq": split.windows(chunk),
            "item_seq_len": split.item_seq_len[chunk],
            "pos_item": split.pos_item[chunk],
            "user_id": split.user_id[chunk],
            "weight": weight,
        }
