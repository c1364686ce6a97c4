"""RecBole *atomic file* reader and ``.inter`` writer (counterpart of
``datamining_recblr_tpu/data/atomic.py``), with the standard library's
``csv`` in place of pandas.

Atomic files are TSV with a typed header row ``field:type`` per column,
e.g. ``user_id:token\\titem_id:token\\ttimestamp:float``.  Types:
``token`` (string id), ``float``, ``token_seq``, ``float_seq``.
"""

from __future__ import annotations

import csv
import os

import numpy as np


def read_atomic_file(path: str, columns: list[str] | None = None) -> dict:
    """Read an atomic ``.inter``/``.item``/``.user`` file into a frame:
    {column name without its ``:type``: 1-D NumPy array}, ``float``
    columns as float64 and the others as strings.  With ``columns``,
    only those are kept (RecBole's ``load_col``)."""
    with open(path, newline="") as f:
        reader = csv.reader(f, delimiter="\t")
        header = next(reader)
        rows = list(reader)
    names, types = [], []
    for col in header:
        name, ftype = col.rsplit(":", 1) if ":" in col else (col, "token")
        names.append(name)
        types.append(ftype)
    cols = list(zip(*rows)) if rows else [()] * len(names)
    frame = {}
    for name, ftype, values in zip(names, types, cols):
        if ftype == "float":
            frame[name] = np.array([float(v) for v in values], np.float64)
        else:
            frame[name] = np.array(values, dtype=str)
    if columns is not None:
        missing = [c for c in columns if c not in frame]
        if missing:
            raise KeyError(f"{path}: missing columns {missing}; has {names}")
        frame = {c: frame[c] for c in columns}
    return frame


def write_atomic_inter(frame: dict, path: str, user_field: str = "user_id",
                       item_field: str = "item_id", time_field: str = "timestamp"):
    """Write a ``.inter`` atomic file with typed headers from a frame: the
    same bytes as the JAX package's ``df.to_csv`` of the same rows (tab
    separated, ``\\n`` line ends, floats in their shortest round-trip
    form)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    cols = [np.asarray(frame[k]).tolist() for k in (user_field, item_field, time_field)]
    with open(path, "w", newline="") as f:
        f.write(f"{user_field}:token\t{item_field}:token\t{time_field}:float\n")
        csv.writer(f, delimiter="\t", lineterminator="\n").writerows(zip(*cols))
