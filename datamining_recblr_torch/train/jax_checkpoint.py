"""Reading the JAX package's checkpoints without JAX.

The JAX trainer saves ``{"params", "opt_state", "epoch", "best_score",
"best_epoch"}`` (``datamining_recblr_tpu/train/checkpoint.py``) as an
orbax ``StandardCheckpointer`` directory, ``<path>.orbax``, or, where
orbax fails, as a pickle of host NumPy arrays, ``<path>.pkl``.
``read_jax_checkpoint`` returns either in the port's form:

* ``params``: a state dict (``interop.params_from_jax``), bit for bit,
  its vocab-leading rows as the JAX run padded them (``vocab_multiple``
  or its ``model`` axis); a model loading it cuts or pads them to its
  own (``parallel.sharding.full_rows``);
* ``opt_state``: optax's state in plain containers: a list for a chain,
  each state a dict of its fields (``ScaleByAdamState`` ->
  ``{"count", "mu", "nu"}``), None for an empty state, CPU tensors at
  the leaves; ``train.optim.opt_state_from_jax`` maps it onto a torch
  optimizer;
* ``epoch``, ``best_score`` and ``best_epoch`` as Python numbers.

The pickle is read by an unpickler that resolves a fixed list of
globals: NumPy's array and dtype reconstructors, the builtins that
containers need, ``ml_dtypes.bfloat16`` (a bfloat16 array arrives as a
bfloat16 tensor, from its bits) and optax's state classes, each as a
stand-in namedtuple with the same fields.  Any other global raises
``pickle.UnpicklingError``, so reading imports neither JAX, optax nor
ml_dtypes, and a file cannot run code.

The orbax directory is read with ``tensorstore`` (imported here, on
use): the tree from ``_METADATA``'s key paths, each leaf a zarr (v2)
array over the directory's OCDBT store, as ``StandardCheckpointer``
writes them (another layout raises); the root manifest covers every
process's part, so a multi-process or mesh-sharded save reads whole.
Where ``tensorstore`` is missing, ``python -m
datamining_recblr_torch.convert_checkpoint`` writes the port's ``.pt``
on a machine that has it.
"""

from __future__ import annotations

import collections
import io
import json
import os
import pickle

import numpy as np
import torch

from datamining_recblr_torch.interop import params_from_jax, to_tensor

CONVERTER = "python -m datamining_recblr_torch.convert_checkpoint SRC DST.pt"

# optax's state classes in the JAX package's learners (train/optim.py):
# scale_by_adam (adam, adamw), scale_by_rss (adagrad), scale_by_rms
# (rmsprop); add_decayed_weights, scale and sgd's identity keep EmptyState
OPTAX_STATES = {
    name: collections.namedtuple(name, fields)
    for name, fields in (("EmptyState", ()),
                         ("ScaleByAdamState", ("count", "mu", "nu")),
                         ("ScaleByRssState", ("sum_of_squares",)),
                         ("ScaleByRmsState", ("nu",)))
}
# numpy 2 pickles name numpy._core, numpy 1 numpy.core
_NUMPY_MODULES = ("numpy", "numpy.core.multiarray", "numpy._core.multiarray")
_BUILTINS = ("dict", "list", "tuple", "set", "frozenset")


class _BFloat16:
    """``ml_dtypes.bfloat16`` and the dtype made from it: NumPy's dtype
    state is set on it and ignored."""

    def __setstate__(self, state):
        pass


_BF16 = _BFloat16()


def _dtype(obj, align=False, copy=False):
    if obj is _BF16:
        return _BF16
    return np.dtype(obj, align, copy)


def _from_bytes(raw, dtype, shape, fortran=False):
    """The tensor of a pickled array's raw bytes."""
    if dtype is _BF16:
        a = np.frombuffer(raw, np.int16).reshape(shape, order="F" if fortran else "C")
        return torch.from_numpy(a.copy(order="C")).view(torch.bfloat16)
    if not isinstance(raw, (bytes, bytearray)) or dtype.hasobject:
        raise pickle.UnpicklingError("an array of Python objects is not a checkpoint leaf")
    a = np.frombuffer(raw, dtype).reshape(shape, order="F" if fortran else "C")
    return to_tensor(a)


class _Array:
    """Stand-in for the array that ``numpy...._reconstruct`` makes: its
    pickled state becomes ``value``, a tensor."""

    def __setstate__(self, state):
        _, shape, dtype, fortran, raw = state
        self.value = _from_bytes(raw, dtype, tuple(shape), fortran)


def _reconstruct(cls, shape, typecode):
    if cls is not np.ndarray:
        raise pickle.UnpicklingError(f"an array of type {cls!r} is not a checkpoint leaf")
    return _Array()


_NUMPY = {"ndarray": np.ndarray, "dtype": _dtype, "_reconstruct": _reconstruct}


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module in _NUMPY_MODULES and name in _NUMPY:
            return _NUMPY[name]
        if module == "builtins" and name in _BUILTINS:
            return getattr(__import__("builtins"), name)
        if module == "ml_dtypes" and name == "bfloat16":
            return _BF16
        if module.split(".")[0] == "optax" and name in OPTAX_STATES:
            return OPTAX_STATES[name]
        raise pickle.UnpicklingError(
            f"global {module}.{name} is not allowed in a checkpoint")


def _plain(node):
    """``node`` with arrays as tensors, namedtuples as dicts of their
    fields (None for an empty one) and sequences as lists."""
    if isinstance(node, _Array):
        return node.value
    if isinstance(node, np.ndarray):
        return to_tensor(node)
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return {f: _plain(v) for f, v in zip(node._fields, node)} if node._fields else None
    if isinstance(node, dict):
        return {k: _plain(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_plain(v) for v in node]
    return node


def load_pickle(path: str):
    """The tree a JAX ``.pkl`` holds, through the restricted unpickler
    (arrays as tensors, optax states as stand-in namedtuples)."""
    with open(path, "rb") as f:
        return _Unpickler(io.BytesIO(f.read())).load()


def load_orbax(path: str):
    """The tree of an orbax ``StandardCheckpointer`` directory: dicts
    (dicts and namedtuples), lists (sequences), None (empty states) and
    NumPy leaves."""
    try:
        import tensorstore as ts
    except ImportError as e:
        raise ImportError(
            f"reading the orbax checkpoint {path} needs tensorstore; convert it where "
            f"tensorstore imports: {CONVERTER}") from e
    root = os.path.abspath(path)
    with open(os.path.join(root, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt") or meta.get("use_zarr3"):
        raise ValueError(f"{path}: not an OCDBT store of zarr v2 arrays (use_ocdbt "
                         f"{meta.get('use_ocdbt')}, use_zarr3 {meta.get('use_zarr3')})")
    tree: dict = {}
    for name, entry in meta["tree_metadata"].items():
        keys = entry["key_metadata"]
        value = entry["value_metadata"]
        if value.get("skip_deserialize") or value.get("value_type") == "None":
            leaf = None
        elif value.get("value_type") in ("jax.Array", "np.ndarray", "scalar"):
            key = ".".join(str(k["key"]) for k in keys)
            leaf = ts.open({"driver": "zarr", "kvstore": {
                "driver": "ocdbt", "base": f"file://{root}", "path": key}}).result().read().result()
        else:
            raise ValueError(f"{path}: leaf {name} of type {value.get('value_type')!r} is not "
                             "a checkpoint array")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault((k["key_type"], str(k["key"])), {})
        node[(keys[-1]["key_type"], str(keys[-1]["key"]))] = leaf
    return _containers(tree)


def _containers(node):
    """The nested {(key_type, key): child} of ``load_orbax`` as dicts and
    lists (key type 1: a sequence index)."""
    if not isinstance(node, dict):
        return node
    if node and all(t == 1 for t, _ in node):
        items = {int(k): _containers(v) for (_, k), v in node.items()}
        return [items.get(i) for i in range(max(items) + 1)]
    return {k: _containers(v) for (_, k), v in node.items()}


def jax_checkpoint_file(path: str) -> str | None:
    """The JAX checkpoint ``path`` names, tried in the JAX package's
    order (a ``.pkl``, or ``path`` + ``.pkl`` where ``path`` is no
    directory, then a ``.orbax`` directory, or ``path`` + ``.orbax``),
    or None when neither exists."""
    if path.endswith(".pkl") or (not os.path.isdir(path) and os.path.exists(path + ".pkl")):
        p = path if path.endswith(".pkl") else path + ".pkl"
        return p if os.path.isfile(p) else None
    p = path if path.endswith(".orbax") else path + ".orbax"
    return p if os.path.isdir(p) else None


def read_jax_checkpoint(path: str) -> dict:
    """The port's state of the JAX checkpoint at ``path`` (see the module
    docstring), on the CPU."""
    found = jax_checkpoint_file(path)
    if found is None:
        raise FileNotFoundError(f"no JAX checkpoint at {path} (.pkl or .orbax)")
    raw = load_pickle(found) if found.endswith(".pkl") else load_orbax(found)
    state = _plain(raw)
    return {
        "params": params_from_jax(state["params"]),
        "opt_state": state.get("opt_state"),
        "epoch": int(state["epoch"]),
        "best_score": float(state["best_score"]),
        "best_epoch": int(state["best_epoch"]),
    }
