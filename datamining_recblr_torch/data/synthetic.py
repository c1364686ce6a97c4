"""Synthetic interaction generators (counterpart of
``datamining_recblr_tpu/data/synthetic.py``), with NumPy alone: the same
random draws in the same order, so a seed gives the JAX package's log
and splits.  A log is a frame (``data/dataset.py``), a dict of columns.

* ``generate_synthetic_interactions``: a small Markov-cluster log for
  tests;
* ``generate_stat_matched_interactions``: a log whose post-filter
  statistics match a target dataset exactly (``STAT_PRESETS``:
  beauty-synth, ml1m-synth, xlong-synth), written as an atomic ``.inter``
  file by ``write_stat_matched_dataset``;
* ``synthetic_splits``: fixed-shape random splits for throughput runs.
"""

from __future__ import annotations

import os

import numpy as np

from datamining_recblr_torch.data.atomic import write_atomic_inter
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


def write_synthetic_inter(path: str, **kwargs) -> dict:
    frame = generate_synthetic_interactions(**kwargs)
    write_atomic_inter(frame, path)
    return frame


def _exact_lengths(rng, n_users, n_inters, min_len, max_len):
    """Per-user lengths: ``min_len`` plus a gamma tail with the right
    mean, capped at ``max_len``, then moved one step at a time to the
    exact sum (random users gain, users above ``min_len`` lose)."""
    if max_len is not None and n_inters > n_users * max_len:
        raise ValueError("n_inters > n_users*max_len: stats unsatisfiable")
    mean_extra = n_inters / n_users - min_len
    lens = min_len + np.floor(
        rng.gamma(shape=1.0, scale=max(mean_extra, 1e-9), size=n_users)
    ).astype(np.int64)
    if max_len is not None:
        lens = np.minimum(lens, max_len)
    diff = int(n_inters - lens.sum())
    while diff != 0:
        if diff > 0:
            cap = max_len if max_len is not None else np.iinfo(np.int64).max
            cand = np.flatnonzero(lens < cap)
            idx = rng.choice(cand, size=min(len(cand), diff), replace=True)
            np.add.at(lens, idx, 1)
            lens = np.minimum(lens, cap)
        else:
            cand = np.flatnonzero(lens > min_len)
            take = rng.choice(cand, size=min(len(cand), -diff), replace=False)
            lens[take] -= 1
        diff = int(n_inters - lens.sum())
    return lens


def _lift_rare_items(rng, items_flat, n_items, min_item_count):
    """Give every item ``min_item_count`` occurrences, in place: the
    missing ones replace occurrences of items above the floor, taken in
    proportion to their surplus and topped up from the largest surplus
    first; only the tail of the distribution changes."""
    item_counts = np.bincount(items_flat, minlength=n_items)
    deficit = np.maximum(min_item_count - item_counts, 0)
    need = int(deficit.sum())
    if not need:
        return
    surplus = np.maximum(item_counts - min_item_count, 0)
    take_per_item = np.minimum(surplus, np.maximum(
        (surplus * (need / max(surplus.sum(), 1))).astype(np.int64), 0))
    short = need - int(take_per_item.sum())
    if short > 0:
        room = surplus - take_per_item
        for i in np.argsort(-room, kind="stable"):
            if short <= 0:
                break
            grab = int(min(room[i], short))
            take_per_item[i] += grab
            short -= grab
    repl_targets = np.repeat(np.arange(n_items), deficit)
    rng.shuffle(repl_targets)
    order_pos = np.argsort(items_flat, kind="stable")
    item_starts = np.concatenate([[0], np.cumsum(item_counts)])
    sel = np.concatenate([order_pos[item_starts[i] : item_starts[i] + take_per_item[i]]
                          for i in np.flatnonzero(take_per_item)])
    assert sel.shape[0] == need, "fix-up failed to place all deficits"
    items_flat[sel] = repl_targets


def generate_stat_matched_interactions(
    n_users: int,
    n_items: int,
    n_inters: int,
    *,
    n_clusters: int = 1000,
    markov_weight: float = 0.15,
    pref_weight: float = 0.0,
    pref_k: int = 3,
    zipf_a: float = 1.0,
    pop_offset: float = 20.0,
    within_cluster: str = "pop",
    min_len: int = 5,
    max_len: int | None = None,
    min_item_count: int = 5,
    seed: int = 0,
) -> dict:
    """Interaction log whose post-filter statistics match a target
    dataset exactly: ``n_users`` users with at least ``min_len`` (and at
    most ``max_len``) interactions, ``n_items`` items with at least
    ``min_item_count`` each, ``n_inters`` rows, so a [5,inf) k-core
    filter keeps every row.

    Items have shifted-Zipf popularity ``1 / (rank + pop_offset)^zipf_a``
    and belong to ``n_clusters`` clusters.  All users walk in lockstep,
    one step a round: the next item stays in the current item's cluster
    with probability ``markov_weight`` (picked within it by popularity
    for ``within_cluster`` "pop", by its square root for "sqrt", uniformly
    for "uniform"), with probability ``pref_weight`` returns to one of
    the user's ``pref_k`` preferred clusters (drawn by cluster mass;
    ``pref_weight`` 0 draws nothing for them), and otherwise jumps by
    popularity over the whole catalog.  Timestamps are a per-user start
    plus the step.  The random draws are the JAX package's, in its
    order, so a seed gives its rows."""
    rng = np.random.default_rng(seed)
    if n_inters < n_users * min_len:
        raise ValueError("n_inters < n_users*min_len: stats unsatisfiable")
    if n_inters < n_items * min_item_count:
        raise ValueError("n_inters < n_items*min_item_count: stats unsatisfiable")
    lens = _exact_lengths(rng, n_users, n_inters, min_len, max_len)

    # item popularity, clusters, and cumulative tables over the items
    # grouped by cluster (a cluster's slice of the global cumsum)
    pop = 1.0 / (np.arange(1, n_items + 1, dtype=np.float64) + pop_offset) ** zipf_a
    clusters = rng.integers(0, n_clusters, size=n_items)
    order = np.argsort(clusters, kind="stable")
    grouped_pop = pop[order]
    counts = np.bincount(clusters, minlength=n_clusters)
    starts = np.concatenate([[0], np.cumsum(counts)])
    cum = np.cumsum(grouped_pop)
    global_cum = cum / cum[-1]
    cum_sqrt = np.cumsum(np.sqrt(grouped_pop))

    def sample_global(k):
        return order[np.searchsorted(global_cum, rng.random(k), side="right")]

    def sample_in_clusters(c):
        lo, hi = starts[c], starts[c + 1]
        if within_cluster == "uniform":
            return order[lo + (rng.random(c.shape[0]) * (hi - lo)).astype(np.int64)]
        table = cum_sqrt if within_cluster == "sqrt" else cum
        base = np.where(lo > 0, table[np.maximum(lo - 1, 0)], 0.0)
        top = table[hi - 1]
        u = base + rng.random(c.shape[0]) * (top - base)
        return order[np.minimum(np.searchsorted(table, u, side="right"), hi - 1)]

    use_pref = pref_weight > 0.0
    if use_pref:
        cluster_mass = np.bincount(clusters, weights=pop, minlength=n_clusters)
        pref_clusters = rng.choice(n_clusters, size=(n_users, pref_k),
                                   p=cluster_mass / cluster_mass.sum())

        def sample_pref(users):
            pc = pref_clusters[users, rng.integers(0, pref_k, users.shape[0])]
            return sample_in_clusters(pc)

    # the walk, column-major: step t serves the users with lens > t, a
    # prefix of the users sorted longest first
    steps = int(lens.max())
    cur = sample_pref(np.arange(n_users)) if use_pref else sample_global(n_users)
    users_sorted = np.argsort(-lens, kind="stable")
    lens_sorted = lens[users_sorted]
    items_flat = np.empty(n_inters, dtype=np.int64)
    col_offsets = np.concatenate([[0], np.cumsum(
        np.searchsorted(-lens_sorted, -(np.arange(steps) + 1), side="right"))])
    cur = cur[users_sorted]
    for t in range(steps):
        n_active = int(np.searchsorted(-lens_sorted, -(t + 1), side="right"))
        if n_active == 0:
            break
        act = cur[:n_active]
        items_flat[col_offsets[t] : col_offsets[t] + n_active] = act
        r = rng.random(n_active)
        stay = r < markov_weight
        nxt = np.where(stay, sample_in_clusters(clusters[act]), sample_global(n_active))
        if use_pref:
            prefm = (~stay) & (r < markov_weight + pref_weight)
            nxt = np.where(prefm, sample_pref(users_sorted[:n_active]), nxt)
        cur[:n_active] = nxt

    _lift_rare_items(rng, items_flat, n_items, min_item_count)

    user_ids = np.empty(n_inters, dtype=np.int64)
    step_no = np.empty(n_inters, dtype=np.int64)
    for t in range(steps):
        n_active = col_offsets[t + 1] - col_offsets[t]
        if n_active <= 0:
            break
        user_ids[col_offsets[t] : col_offsets[t + 1]] = users_sorted[:n_active]
        step_no[col_offsets[t] : col_offsets[t + 1]] = t
    t0 = rng.integers(1_000_000, 2_000_000, size=n_users).astype(np.float64)
    return {
        "user_id": np.char.add("u", user_ids.astype(str)),
        "item_id": np.char.add("i", items_flat.astype(str)),
        "timestamp": t0[user_ids] + step_no,
    }


# Post-5-core-filter statistics of the reference's benchmark datasets
# (the JAX package's STAT_PRESETS): amazon-beauty 18,897 users / 10,544
# items / 167,588 interactions; ML-1M after the [5,inf) item filter,
# 6,040 / 3,416 / 999,611; XLong (paper Table 2) 5,000 users / 329,722
# items, histories truncated to their last 1,000 events.  markov_weight
# and within_cluster set how learnable each is.
STAT_PRESETS = {
    "beauty-synth": dict(
        n_users=18_897, n_items=10_544, n_inters=167_588,
        n_clusters=250, markov_weight=0.45, within_cluster="uniform",
        min_len=5,
    ),
    "ml1m-synth": dict(
        n_users=6_040, n_items=3_416, n_inters=999_611,
        n_clusters=340, markov_weight=0.33, within_cluster="sqrt",
        min_len=20,
    ),
    "xlong-synth": dict(
        n_users=5_000, n_items=329_722, n_inters=3_929_500,
        n_clusters=3_000, markov_weight=0.55, within_cluster="pop",
        min_len=20, max_len=1_000,
    ),
}


def write_stat_matched_dataset(data_path: str, name: str, seed: int = 2020,
                               out_name: str | None = None, **overrides) -> str:
    """Generate ``STAT_PRESETS[name]`` (with ``overrides``) and write it to
    ``<data_path>/<out_name>/<out_name>.inter`` (``out_name`` defaults to
    ``name``; a run with overrides should name another directory, so the
    canonical dataset is never replaced); returns the file's path."""
    out_name = out_name or name
    preset = dict(STAT_PRESETS[name], **overrides)
    frame = generate_stat_matched_interactions(
        preset.pop("n_users"), preset.pop("n_items"), preset.pop("n_inters"),
        seed=seed, **preset)
    path = os.path.join(data_path, out_name, f"{out_name}.inter")
    write_atomic_inter(frame, path)
    return path


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
