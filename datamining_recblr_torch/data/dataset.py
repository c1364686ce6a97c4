"""Sequential dataset construction: filtering, ID remap, leave-one-out
split, prefix augmentation (counterpart of
``datamining_recblr_tpu/data/dataset.py``), with NumPy alone.

An interaction log is a *frame*: a dict of equal-length 1-D NumPy
columns (``read_atomic_file`` and ``generate_synthetic_interactions``
return one), where the JAX package holds a pandas DataFrame.  The
builder reproduces the JAX builder's arrays exactly:

* iterative k-core interval filtering until a fixpoint, users then
  items in each round, row order kept;
* a stable sort by time, then token -> contiguous id remap with
  ``[PAD]`` = 0 in first-appearance order;
* leave-one-out split (last item test, second-to-last valid) and one
  train sample per prefix, windows truncated to the most recent
  ``max_seq_len`` items; large train splits in the COMPACT form.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field

import numpy as np

_INTERVAL_RE = re.compile(r"^\s*([\[(])\s*([^,]+)\s*,\s*([^)\]]+)\s*([)\]])\s*$")

# Above this many [N, L] elements (1 GB of int32) the augmented train
# split is built in COMPACT form and never materialized dense.
_COMPACT_TRAIN_ELEMS = 256 * 1024 * 1024


def parse_interval(spec: str | None):
    """Parse a RecBole interval string like ``"[5,inf)"`` into a
    predicate over counts."""
    if not spec:
        return lambda c: np.ones_like(c, dtype=bool)
    m = _INTERVAL_RE.match(spec)
    if not m:
        raise ValueError(f"bad interval spec {spec!r}")
    lbr, lo_s, hi_s, rbr = m.groups()
    lo = float(lo_s)
    hi = float(hi_s)

    def pred(c):
        c = np.asarray(c, dtype=np.float64)
        ok_lo = c >= lo if lbr == "[" else c > lo
        ok_hi = c <= hi if rbr == "]" else c < hi
        return ok_lo & ok_hi

    return pred


def _rows(frame: dict, keep: np.ndarray) -> dict:
    return {k: v[keep] for k, v in frame.items()}


def _count_keep(col: np.ndarray, pred) -> np.ndarray:
    _, inv, counts = np.unique(col, return_inverse=True, return_counts=True)
    return pred(counts)[inv.reshape(-1)]


def kcore_filter(frame: dict, user_field: str, item_field: str,
                 user_interval: str | None, item_interval: str | None) -> dict:
    """Iteratively drop users/items whose interaction count falls outside
    the configured intervals, until stable (RecBole
    ``_filter_by_inter_num`` semantics)."""
    upred = parse_interval(user_interval)
    ipred = parse_interval(item_interval)
    while True:
        n = len(frame[user_field])
        frame = _rows(frame, _count_keep(frame[user_field], upred))
        frame = _rows(frame, _count_keep(frame[item_field], ipred))
        if len(frame[user_field]) == n:
            return frame


@dataclass
class SplitArrays:
    """Fixed-shape sample arrays for one split.

    DENSE: ``item_seq [N, L]`` holds every sample's window.  COMPACT
    (large train splits): ``item_seq is None``; sample j is the window
    ``flat_items[flat_start[j] : flat_start[j] + item_seq_len[j]]`` of
    the concatenated per-user item streams.  ``windows()`` materializes
    dense rows for either form.
    """

    item_seq: np.ndarray | None  # [N, L] int32, right-padded with 0 (dense)
    item_seq_len: np.ndarray  # [N]    int32
    pos_item: np.ndarray      # [N]    int32 target item
    user_id: np.ndarray       # [N]    int32
    flat_items: np.ndarray | None = None  # [total] int32 (compact)
    flat_start: np.ndarray | None = None  # [N]     int32 (compact)
    max_seq_len: int = 0      # L (compact; dense reads item_seq.shape[1])

    def __len__(self):
        return len(self.pos_item)

    @property
    def compact(self) -> bool:
        return self.item_seq is None

    @property
    def seq_len(self) -> int:
        return self.max_seq_len if self.compact else self.item_seq.shape[1]

    def take(self, idx):
        if self.compact:
            return SplitArrays(None, self.item_seq_len[idx], self.pos_item[idx],
                               self.user_id[idx], flat_items=self.flat_items,
                               flat_start=self.flat_start[idx],
                               max_seq_len=self.max_seq_len)
        return SplitArrays(self.item_seq[idx], self.item_seq_len[idx],
                           self.pos_item[idx], self.user_id[idx])

    def windows(self, idx) -> np.ndarray:
        """[len(idx), L] int32 dense windows for the given sample rows."""
        if not self.compact:
            return self.item_seq[idx]
        t = self.max_seq_len
        start = self.flat_start[idx].astype(np.int64)
        lens = self.item_seq_len[idx]
        cols = start[:, None] + np.arange(t, dtype=np.int64)[None, :]
        valid = np.arange(t, dtype=np.int32)[None, :] < lens[:, None]
        flat = self.flat_items
        return np.where(valid, flat[np.minimum(cols, len(flat) - 1)], 0).astype(np.int32)


@dataclass
class SeqData:
    n_users: int              # includes PAD=0
    n_items: int              # includes PAD=0
    n_interactions: int
    max_seq_len: int
    train: SplitArrays
    valid: SplitArrays
    test: SplitArrays
    user_token2id: dict = field(default_factory=dict)
    item_token2id: dict = field(default_factory=dict)
    user_id2token: list = field(default_factory=list)
    item_id2token: list = field(default_factory=list)
    # full per-user train sequences (list of np arrays), for history masks
    user_train_items: list = field(default_factory=list)

    def summary(self) -> str:
        return (
            f"users={self.n_users - 1} items={self.n_items - 1} "
            f"inters={self.n_interactions} | train={len(self.train)} "
            f"valid={len(self.valid)} test={len(self.test)} L={self.max_seq_len}"
        )

    def item_popularity(self) -> np.ndarray:
        """Per-item interaction counts over the training portion, indexed
        by item id (PAD = 0 at index 0): the popN sampling distribution."""
        counts = np.zeros(self.n_items, np.int64)
        for items in self.user_train_items:
            if len(items):
                counts += np.bincount(items, minlength=self.n_items)
        return counts


def compact_from_streams(flat: np.ndarray, lens_u: np.ndarray,
                         max_seq_len: int) -> SplitArrays:
    """COMPACT augmented train split from the concatenated per-user train
    streams (user u's stream is the ``lens_u[u]``-long block of ``flat``
    in user order): users in id order, prefix length k = 1..L_u-1
    ascending within each user, as the dense build."""
    lens_u = lens_u.astype(np.int64)
    off = np.concatenate([[0], np.cumsum(lens_u)])[:-1]
    n_per = np.maximum(lens_u - 1, 0)
    usr = np.repeat(np.arange(len(lens_u)), n_per).astype(np.int32)
    k = (np.arange(int(n_per.sum()), dtype=np.int64)
         - np.repeat(np.cumsum(n_per) - n_per, n_per) + 1)
    tgt = flat[off[usr] + k].astype(np.int32)
    lens_s = np.minimum(k, max_seq_len).astype(np.int32)
    start = (off[usr] + k - lens_s).astype(np.int32)
    return SplitArrays(None, lens_s, tgt, usr, flat_items=flat.astype(np.int32, copy=False),
                       flat_start=start, max_seq_len=max_seq_len)


def _remap(tokens: np.ndarray):
    """First-appearance-order remap to contiguous ids starting at 1
    (id 0 = '[PAD]')."""
    uniq, first, inv = np.unique(tokens, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(uniq), np.int64)
    rank[order] = np.arange(len(uniq))
    cat = uniq[order].tolist()
    token2id = {t: i + 1 for i, t in enumerate(cat)}
    return (rank[inv.reshape(-1)] + 1).astype(np.int32), token2id, ["[PAD]"] + cat


def _samples_to_arrays(samples, max_seq_len) -> SplitArrays:
    n = len(samples)
    seq = np.zeros((n, max_seq_len), np.int32)
    lens = np.zeros((n,), np.int32)
    tgt = np.zeros((n,), np.int32)
    usr = np.zeros((n,), np.int32)
    for j, (u, prefix, target) in enumerate(samples):
        window = prefix[-max_seq_len:]
        seq[j, : len(window)] = window
        lens[j] = len(window)
        tgt[j] = target
        usr[j] = u
    return SplitArrays(seq, lens, tgt, usr)


def build_from_dataframe(frame: dict, max_seq_len: int, user_field: str = "user_id",
                         item_field: str = "item_id", time_field: str = "timestamp",
                         user_interval: str | None = None,
                         item_interval: str | None = None,
                         augment_train: bool = True) -> SeqData:
    """SeqData from an interaction frame (dict of NumPy columns)."""
    frame = {k: np.asarray(v) for k, v in frame.items()}
    frame = kcore_filter(frame, user_field, item_field, user_interval, item_interval)
    frame = _rows(frame, np.argsort(frame[time_field], kind="stable"))
    uids, u_t2i, u_i2t = _remap(frame[user_field])
    iids, i_t2i, i_i2t = _remap(frame[item_field])
    n_users = len(u_i2t)
    n_items = len(i_i2t)

    order = np.argsort(uids, kind="stable")
    sorted_u = uids[order]
    sorted_i = iids[order]
    boundaries = np.flatnonzero(np.diff(sorted_u)) + 1
    groups = np.split(sorted_i, boundaries)
    group_users = sorted_u[np.concatenate([[0], boundaries])] if len(sorted_u) else []

    user_train_items: list[np.ndarray] = [np.empty(0, np.int32)] * n_users
    train_samples, valid_samples, test_samples = [], [], []
    for u, items in zip(group_users, groups):
        items = items.astype(np.int32)
        if len(items) < 3:
            # too short for the LS split: everything goes to train prefixes
            user_train_items[u] = items
            if augment_train:
                for k in range(1, len(items)):
                    train_samples.append((u, items[:k], items[k]))
            continue
        train_part = items[:-2]
        user_train_items[u] = train_part
        if augment_train:
            for k in range(1, len(train_part)):
                train_samples.append((u, train_part[:k], train_part[k]))
        else:
            train_samples.append((u, train_part[:-1], train_part[-1]))
        valid_samples.append((u, train_part, items[-2]))
        test_samples.append((u, items[:-1], items[-1]))

    use_compact = augment_train and len(train_samples) * max_seq_len > _COMPACT_TRAIN_ELEMS
    if use_compact:
        lens_u = np.array([len(x) for x in user_train_items], np.int64)
        flat = (np.concatenate([x for x in user_train_items if len(x)])
                if lens_u.sum() else np.empty(0, np.int32)).astype(np.int32)
        train = compact_from_streams(flat, lens_u, max_seq_len)
    else:
        train = _samples_to_arrays(train_samples, max_seq_len)
    return SeqData(
        n_users=n_users, n_items=n_items, n_interactions=len(frame[user_field]),
        max_seq_len=max_seq_len, train=train,
        valid=_samples_to_arrays(valid_samples, max_seq_len),
        test=_samples_to_arrays(test_samples, max_seq_len),
        user_token2id=u_t2i, item_token2id=i_t2i, user_id2token=u_i2t,
        item_id2token=i_i2t, user_train_items=user_train_items,
    )


def build_dataset(config) -> SeqData:
    """The dataset a config names, from ``<data_path>/<name>/<name>.inter``
    (RecBole's directory layout), split and augmented.

    With ``use_native_loader`` on (the default, as in the JAX package)
    the native loader (``data/native.py``) reads and builds it; off,
    ``read_atomic_file`` and ``build_from_dataframe``.  The two give the
    same arrays.  A native build that fails raises: there is no quiet
    fallback to Python."""
    name = config["dataset"]
    path = os.path.join(config["data_path"], name, f"{name}.inter")
    kwargs = dict(
        max_seq_len=config["MAX_ITEM_LIST_LENGTH"],
        user_field=config["USER_ID_FIELD"],
        item_field=config["ITEM_ID_FIELD"],
        time_field=config["TIME_FIELD"],
        user_interval=config["user_inter_num_interval"],
        item_interval=config["item_inter_num_interval"],
    )
    if config.get("use_native_loader", True):
        from datamining_recblr_torch.data import native

        return native.build_dataset_from_file(path, **kwargs)
    from datamining_recblr_torch.data.atomic import read_atomic_file

    load_col = config["load_col"] or {}
    return build_from_dataframe(read_atomic_file(path, columns=load_col.get("inter")), **kwargs)
