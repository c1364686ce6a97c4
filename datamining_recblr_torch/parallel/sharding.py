"""Which parameters row-shard over ``model``, and moving a model's state
between its full and its sharded form (counterpart of
``datamining_recblr_tpu/parallel/sharding.py``).

The policy is the JAX package's, copied: ``item_embedding`` and
BERT4Rec's ``output_bias`` (at the table's width) row-shard over the
``model`` axis when the table has at least ``ROW_SHARD_MIN_ELEMS``
elements (``vocab_row_shard: auto``), always or never with the config's
"always" / "never"; every other parameter is replicated (on a mesh with
no ``model`` axis, e.g. ``{data, seq}``, all of them), and batches split
over ``data``, their [B, T] sequences also over ``seq`` (beside
``model`` too).  Models pad
their vocab-leading rows to the model-axis multiple, so divisibility
never decides.

Model rank m of M holds rows [m V/M, (m+1) V/M) of a sharded tensor of V
rows.  ``shard_model`` slices a model's full state (from its seed, a
state dict or a checkpoint) to this rank's rows; ``gather_state`` puts
the full state back together, cut to the rows an unmeshed model pads
to, so a meshed run writes the checkpoint an unmeshed run writes."""

from __future__ import annotations

import torch
from torch import nn

from datamining_recblr_torch.parallel.collectives import all_gather
from datamining_recblr_torch.parallel.input import process_local_rows, seq_chunk
from datamining_recblr_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, SEQ_AXIS

_ROW_SHARDED = {"item_embedding"}
_VOCAB_SHARDED = {"output_bias"}

# Replication keeps the fused CE kernels (they need the whole [V, D]
# table on each rank); row-sharding buys per-card room for the table and
# its two Adam moments and splits the [B, V] logits over the model axis.
# The crossover is in table elements: beauty's 10.5k x 64 = 0.7M
# replicates, a Yelp-scale 65k x 64 = 4.2M row-shards.
ROW_SHARD_MIN_ELEMS = 4 * 1024 * 1024


def _model_size(mesh) -> int:
    return int(mesh.shape.get(MODEL_AXIS, 1)) if mesh is not None else 1


def want_row_shard(nrows: int, ncols: int, mesh, mode: str = "auto") -> bool:
    """The policy: row-shard a [nrows, ncols] vocab-leading tensor?
    ``mode`` is the config's ``vocab_row_shard``."""
    if mesh is None or _model_size(mesh) <= 1:
        return False
    if mode == "always":
        return True
    if mode == "never":
        return False
    return nrows * max(ncols, 1) >= ROW_SHARD_MIN_ELEMS


def rows_sharded(nrows: int, mesh, ncols: int, mode: str = "auto") -> bool:
    """True when a vocab-leading tensor of ``nrows`` rows is row-sharded:
    the policy says so and the rows divide the model axis."""
    if mesh is None:
        return False
    return want_row_shard(nrows, ncols, mesh, mode) and nrows % _model_size(mesh) == 0


def param_pspecs(state, mesh=None, mode: str = "auto") -> dict[str, tuple]:
    """{state-dict name: partition spec} as tuples: ("model", None) for a
    row-sharded table, ("model",) for a sharded 1-D vocab vector, ()
    replicated.  1-D vocab vectors take the table's hidden width for the
    element count, so the bias and the table decide alike."""
    hidden = 64
    for name, t in state.items():
        if name in _ROW_SHARDED and t.dim() == 2:
            hidden = t.shape[1]
            break
    specs = {}
    for name, t in state.items():
        spec = ()
        if _model_size(mesh) > 1 and t.dim() >= 1:
            ncols = t.shape[1] if t.dim() > 1 else hidden
            if rows_sharded(t.shape[0], mesh, ncols, mode):
                if name in _ROW_SHARDED:
                    spec = (MODEL_AXIS, None)
                elif name in _VOCAB_SHARDED:
                    spec = (MODEL_AXIS,)
        specs[name] = spec
    return specs


def _fit_rows(t, rows: int):
    """``t`` with its leading axis cut or zero-padded to ``rows``."""
    if t.shape[0] >= rows:
        return t[:rows]
    return torch.cat([t, t.new_zeros((rows - t.shape[0],) + tuple(t.shape[1:]))])


def _shard_rows(mesh, t):
    n, m = mesh.size(MODEL_AXIS), mesh.index(MODEL_AXIS)
    per = t.shape[0] // n
    return m * per, (m + 1) * per


def check_seq_axis(model, shape: dict):
    """Raise ValueError for a ``seq`` axis that does not divide the model's
    time axis (every model shards it, beside ``data`` and ``model`` too)."""
    seq = int(shape.get(SEQ_AXIS, 1))
    if model.max_seq_len % seq:
        raise ValueError(f"MAX_ITEM_LIST_LENGTH {model.max_seq_len} must divide by the seq "
                         f"mesh axis ({seq})")


def shard_model(model, mesh, state=None):
    """Put ``model`` on ``mesh``: its full state (``state``, a state dict
    whose vocab-leading tensors may have any padding, else the model's
    own parameters) with the sharded tensors cut to this rank's rows.
    The model's ``mesh``, ``shards`` (name -> (lo, hi) of the global rows
    held) and ``seed_offset`` (data index x 1000003, as the JAX package
    offsets its kernels' dropout seeds per data shard; the seq ranks of a
    data index share it and draw at their chunk's positions) are set."""
    check_seq_axis(model, mesh.shape)
    if state is None:
        if model.mesh is mesh:
            return model
        state = model.state_dict()
    state = full_rows(model, state)
    mode = model.config.get("vocab_row_shard", "auto") or "auto"
    specs = param_pspecs(state, mesh, mode)
    shards = {}
    local = {}
    for name, t in state.items():
        if specs[name]:
            lo, hi = _shard_rows(mesh, t)
            shards[name] = (lo, hi)
            t = t[lo:hi]
        local[name] = t
    for name in model.vocab_rows():
        old = getattr(model, name)
        if old.shape != local[name].shape:  # a new Parameter only where the rows change
            setattr(model, name, nn.Parameter(torch.empty(
                local[name].shape, dtype=old.dtype, device=old.device)))
    model.load_state_dict(local)
    model.mesh, model.shards = mesh, shards
    model.seed_offset = mesh.index(DATA_AXIS) * 1000003
    return model


def full_rows(model, state):
    """``state`` with each vocab-leading tensor cut or zero-padded to the
    model's rows (the padding rows are zeros a model never reads)."""
    out = dict(state)
    for name, n in model.vocab_rows().items():
        if name in out:
            out[name] = _fit_rows(out[name], model.pad_vocab_rows(n))
    return out


def gather_state(model, optimizer=None):
    """(full state dict, full optimizer state dict) of a meshed model on
    the CPU, the vocab-leading rows cut to an unmeshed model's padding.
    A collective: every rank calls it.  The optimizer's tensors of a
    vocab-leading parameter (Adam's moments) are gathered and cut with
    it."""
    mesh = model.mesh
    cut = {name: model.pad_vocab_rows(n, meshed=False) for name, n in model.vocab_rows().items()}

    def full(name, t):
        if name in model.shards:
            t = all_gather(t, mesh, MODEL_AXIS)
        return (t[: cut[name]] if name in cut else t).cpu()

    params = {k: full(k, v) for k, v in model.state_dict().items()}
    if optimizer is None:
        return params, None
    return params, _map_opt_state(model, optimizer.state_dict(), full)


def shard_optimizer_state(model, opt_state):
    """A full optimizer state dict (``gather_state``'s, or a JAX
    checkpoint's mapped one at its run's padding) with its vocab-leading
    tensors at the model's padding and cut to this rank's rows (all of
    them off a mesh), for ``optimizer.load_state_dict``."""
    rows = model.vocab_rows()

    def local(name, t):
        lo, hi = model.shards.get(name, (0, None))
        return _fit_rows(t, model.pad_vocab_rows(rows[name]))[lo:hi]

    return _map_opt_state(model, opt_state, local)


def _map_opt_state(model, opt_state, fn):
    """``opt_state`` with ``fn(name, t)`` applied to each tensor entry of
    a vocab-leading parameter (the optimizer's parameter order is the
    model's)."""
    vocab = model.vocab_rows()
    names = [n for n, _ in model.named_parameters()]
    state = {}
    for i, entry in opt_state["state"].items():
        name = names[int(i)] if names[int(i)] in vocab else None
        state[i] = {k: fn(name, v) if name and isinstance(v, torch.Tensor) and v.dim() else v
                    for k, v in entry.items()}
    return {"state": state, "param_groups": opt_state["param_groups"]}


SEQ_KEYS = ("item_seq",)  # the batch's [B, T] sequences


def shard_batch(batch: dict, mesh) -> dict:
    """This rank's part of a global batch (the counterpart of JAX's
    ``_batch_spec``): rows [d B/D, (d+1) B/D) of every leading-axis array
    for data index d (the rows every model and seq rank of that index
    shares), and of the [B, T] sequences (``SEQ_KEYS``) the columns of
    this rank's time chunk on a ``seq`` axis; [B] arrays are the same on
    every seq rank."""
    out = {}
    for k, v in batch.items():
        lo, hi = process_local_rows(v.shape[0], mesh)
        v = v[lo:hi]
        if k in SEQ_KEYS and mesh is not None and mesh.size(SEQ_AXIS) > 1:
            t0, t1 = seq_chunk(v.shape[1], mesh)
            v = v[:, t0:t1]
        out[k] = v
    return out
