"""The native (C++) data loader: the port's copy of the JAX package's
``native/rec_data.cc`` (``csrc/host/rec_data.cc``, unchanged), built at
first use and bound with ctypes (counterpart of
``datamining_recblr_tpu/data/native.py``).

It parses the atomic ``.inter`` file, filters, remaps, splits and
augments as ``dataset.build_from_dataframe`` does, with the same arrays,
token maps and storage form (a COMPACT train split above
``dataset._COMPACT_TRAIN_ELEMS``).

The library is compiled by the host C++ compiler (``$CXX``, else
``c++``) with ``native/Makefile``'s flags into ``build/torch_host/``
beside the package (listed in ``.gitignore``), named by a hash of the
source and flags, and renamed into place once written, so processes
building at once do not collide and an unchanged source is reused.  A
failed compile or a null handle raises, with the compiler's output or
the file's name: the arrays are the same either way, and the JAX
package's quiet fallback to Python would hide a broken build.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from datamining_recblr_torch.data import dataset as DS

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "host" / "rec_data.cc"
BUILD_DIR = _PKG.parent / "build" / "torch_host"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")

_I32P = ctypes.POINTER(ctypes.c_int32)
_SIGNATURES = {
    "rb_build": (ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_int32]
                 + [ctypes.c_int] * 3
                 + [ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_int] * 2),
    "rb_stat": (ctypes.c_int64, [ctypes.c_void_p, ctypes.c_int]),
    "rb_fill_split": (None, [ctypes.c_void_p, ctypes.c_int] + [_I32P] * 4),
    "rb_tokens_size": (ctypes.c_int64, [ctypes.c_void_p, ctypes.c_int]),
    "rb_tokens": (None, [ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p]),
    "rb_train_items_total": (ctypes.c_int64, [ctypes.c_void_p]),
    "rb_train_lists": (None, [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), _I32P]),
    "rb_free": (None, [ctypes.c_void_p]),
}

_loaded: dict[Path, ctypes.CDLL] = {}


def _compiler() -> str:
    cxx = os.environ.get("CXX") or "c++"
    found = shutil.which(cxx)
    if found is None:
        raise RuntimeError(f"no host C++ compiler ({cxx}): the native loader cannot be built")
    return found


def lib_path(source: Path = SOURCE) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(source.read_bytes())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def build(source: Path = SOURCE) -> Path:
    """The shared library of ``source``, compiled first if missing;
    raises with the compiler's output where the compile fails."""
    out = lib_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_compiler(), *CXX_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native loader from {source} failed "
                           f"(exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def library(source: Path = SOURCE) -> ctypes.CDLL:
    """The loaded native loader, built first if needed."""
    path = build(source)
    lib = _loaded.get(path)
    if lib is None:
        lib = ctypes.CDLL(str(path))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _loaded[path] = lib
    return lib


def _interval_params(spec: str | None):
    """(lo, hi, lo inclusive, hi inclusive) of a RecBole interval string."""
    if not spec:
        return (-math.inf, math.inf, 1, 1)
    m = DS._INTERVAL_RE.match(spec)
    if not m:
        raise ValueError(f"bad interval spec {spec!r}")
    lbr, lo_s, hi_s, rbr = m.groups()
    return (float(lo_s), float(hi_s), 1 if lbr == "[" else 0, 1 if rbr == "]" else 0)


def build_dataset_from_file(path: str, max_seq_len: int, user_field: str = "user_id",
                            item_field: str = "item_id", time_field: str = "timestamp",
                            user_interval: str | None = None,
                            item_interval: str | None = None) -> DS.SeqData:
    """``dataset.build_from_dataframe`` of the ``.inter`` file at
    ``path``, read and built by the native loader."""
    lib = library()
    with open(path) as f:
        header = f.readline().rstrip("\n").split("\t")
    names = [c.rsplit(":", 1)[0] for c in header]
    cols = []
    for want in (user_field, item_field, time_field):
        if want not in names:
            raise KeyError(f"{path}: column {want} not in header {names}")
        cols.append(names.index(want))

    handle = lib.rb_build(path.encode(), max_seq_len, *cols,
                          *_interval_params(user_interval), *_interval_params(item_interval))
    if not handle:
        raise RuntimeError(f"the native loader could not build {path} (null handle)")
    try:
        n_users, n_items, n_inter = (int(lib.rb_stat(handle, s)) for s in range(3))
        sizes = [int(lib.rb_stat(handle, 3 + s)) for s in range(3)]

        def fetch_split(s, n):
            seq = np.zeros((n, max_seq_len), np.int32)
            lens, tgt, usr = (np.zeros((n,), np.int32) for _ in range(3))
            if n:
                lib.rb_fill_split(handle, s, *(a.ctypes.data_as(_I32P)
                                               for a in (seq, lens, tgt, usr)))
            return DS.SplitArrays(seq, lens, tgt, usr)

        total = int(lib.rb_train_items_total(handle))
        offsets = np.zeros((n_users,), np.int64)
        items = np.zeros((max(total, 1),), np.int32)
        lib.rb_train_lists(handle, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                           items.ctypes.data_as(_I32P))
        user_train_items = [np.empty(0, np.int32)] * n_users
        prev = 0
        for uid in range(1, n_users):
            end = int(offsets[uid])
            user_train_items[uid] = items[prev:end].copy()
            prev = end

        # large augmented train splits COMPACT, from the per-user streams
        # just fetched: the Python builder's trigger and construction
        if sizes[0] * max_seq_len > DS._COMPACT_TRAIN_ELEMS:
            train = DS.compact_from_streams(items[:total], np.diff(offsets, prepend=0),
                                            max_seq_len)
            if len(train) != sizes[0]:
                raise RuntimeError(f"native compact train split of {len(train)} samples, "
                                   f"{sizes[0]} augmented")
        else:
            train = fetch_split(0, sizes[0])

        def fetch_tokens(which):
            buf = ctypes.create_string_buffer(int(lib.rb_tokens_size(handle, which)))
            lib.rb_tokens(handle, which, buf)
            return buf.raw.decode().split("\n")[:-1]

        user_toks, item_toks = fetch_tokens(0), fetch_tokens(1)
        return DS.SeqData(
            n_users=n_users, n_items=n_items, n_interactions=n_inter,
            max_seq_len=max_seq_len, train=train, valid=fetch_split(1, sizes[1]),
            test=fetch_split(2, sizes[2]),
            user_token2id={t: i + 1 for i, t in enumerate(user_toks)},
            item_token2id={t: i + 1 for i, t in enumerate(item_toks)},
            user_id2token=["[PAD]"] + user_toks, item_id2token=["[PAD]"] + item_toks,
            user_train_items=user_train_items,
        )
    finally:
        lib.rb_free(handle)
