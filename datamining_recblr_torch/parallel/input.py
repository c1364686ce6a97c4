"""The input of a meshed run (counterpart of
``datamining_recblr_tpu/parallel/input.py``).

Every rank computes the same global batch (the permutation, the BPR
negatives and the sampled candidates come from generators seeded by the
config alone) and keeps the rows of its data index,
``process_local_rows``, which the model and seq ranks of that index
share; so the global batch is the unmeshed batch whatever the mesh.  A
seq rank takes the rows' whole windows and the model cuts its time chunk,
``seq_chunk``.

Two placements (the Trainer's ``mesh_input``):

* ``resident`` (default): the whole training split on each rank's device
  once (``Trainer.device_split``, as unmeshed); a step sends only the
  index vector of its rows and gathers its batch there;
* ``stream``: each step builds this rank's rows on the host and
  ``shard_host_batch`` moves them to the device.
"""

from __future__ import annotations

import numpy as np
import torch

from datamining_recblr_torch.parallel.mesh import DATA_AXIS, SEQ_AXIS


def process_local_rows(global_rows: int, mesh):
    """(start, stop) of the rows of a global batch that this rank's data
    index feeds: an even split, the last index taking the remainder."""
    n = mesh.size(DATA_AXIS) if mesh is not None else 1
    if n == 1:
        return 0, global_rows
    idx = mesh.index(DATA_AXIS)
    per = global_rows // n
    return idx * per, (idx + 1) * per if idx + 1 < n else global_rows


def seq_chunk(t: int, mesh, seq_axis: str = SEQ_AXIS) -> tuple[int, int]:
    """(t0, t1): this rank's positions of a time axis of length ``t``
    sharded evenly over ``seq_axis``; raises ValueError when ``t`` does
    not divide by the axis (as JAX's ``seq_parallel_scan``)."""
    n = mesh.size(seq_axis)
    if t % n:
        raise ValueError(f"T={t} must divide seq axis size {n}")
    per = t // n
    i = mesh.index(seq_axis)
    return i * per, (i + 1) * per


def shard_host_batch(batch: dict, mesh) -> dict:
    """This rank's slice of a host batch (``process_local_rows`` of each
    array already taken) as tensors on the rank's device."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(mesh.device)
            for k, v in batch.items()}

