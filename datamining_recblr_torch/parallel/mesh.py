"""The device mesh of the port (counterpart of
``datamining_recblr_tpu/parallel/mesh.py``) on ``torch.distributed``.

One process runs per mesh position; a ``{data: D, model: M}`` mesh has
D x M ranks, rank r at data index r // M and model index r % M, a
``{data: D, seq: S}`` mesh rank r at data index r // S and seq index
r % S, and a ``{data: D, model: M, seq: S}`` one rank r at (r // (M S),
r // S % M, r % S) (the row-major order of JAX's
``np.array(devices).reshape(sizes)``).  The towers run data-parallel
over ``data``; the item table and the full-catalog logits are row /
vocab sharded over ``model``; every model's time axis is sharded over
``seq`` (each seq rank runs its chunk of the data index's rows,
``models/recblr.py``, ``models/sasrec.py``).  Each
rank's ``Mesh`` holds a ``DeviceMesh`` with one process group per axis,
its coordinates and its device.  Where JAX has GSPMD insert the
collectives, the port calls them itself (``parallel/collectives.py``).
"""

from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"  # sequence (time) parallelism


class Mesh:
    """This rank's view of a mesh: axis sizes (``shape``), its index on
    each axis, the process group of each axis and its device."""

    def __init__(self, device_mesh, shape: dict[str, int], device):
        self.device_mesh = device_mesh
        self.shape = dict(shape)
        self.device = torch.device(device)
        self._index = {a: device_mesh.get_local_rank(a) for a in self.shape}

    def size(self, axis: str) -> int:
        return int(self.shape.get(axis, 1))

    def index(self, axis: str) -> int:
        return self._index.get(axis, 0)

    def group(self, axis: str):
        """The process group of the ranks that differ only on ``axis``
        (None for an axis the mesh lacks)."""
        return self.device_mesh.get_group(axis) if axis in self.shape else None

    def __repr__(self):
        where = ", ".join(f"{a}={self.index(a)}" for a in self.shape)
        return f"Mesh({self.shape}, {where}, device={self.device})"


def make_mesh(shape: dict[str, int] | None = None, device=None) -> Mesh:
    """The mesh of ``shape`` (axis name -> size) over the ranks of the
    initialized process group; ``shape=None`` puts every rank on ``data``.

    It needs ``torch.distributed`` initialized (``multihost_initialize``,
    or a launcher's environment) with exactly as many ranks as the
    shape; it never runs a mesh on fewer processes.  ``device``: this
    rank's device, by default ``cuda:LOCAL_RANK``."""
    have = dist.get_world_size() if dist.is_initialized() else 1
    if shape is None:
        shape = {DATA_AXIS: have, MODEL_AXIS: 1}
    shape = {str(k): int(v) for k, v in dict(shape).items()}
    total = math.prod(shape.values())
    if total != have or not dist.is_initialized():
        how = "" if dist.is_initialized() else (
            " (torch.distributed is not initialized: launch with torch.distributed.run"
            " and set multihost, or call multihost_initialize)")
        raise ValueError(f"mesh shape {shape} needs {total} devices, have {have}{how}")
    device = torch.device(device if device is not None else local_device())
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(device.type, tuple(shape.values()), mesh_dim_names=tuple(shape))
    return Mesh(dm, shape, device)


def default_mesh_shape(n_devices: int) -> dict[str, int]:
    """Reasonable 2-D default: model axis 2 when even, else 1."""
    if n_devices % 2 == 0 and n_devices > 1:
        return {DATA_AXIS: n_devices // 2, MODEL_AXIS: 2}
    return {DATA_AXIS: n_devices, MODEL_AXIS: 1}


def local_device() -> torch.device:
    """``cuda:LOCAL_RANK`` (the launcher's variable, 0 without it)."""
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def multihost_initialize(**kwargs):
    """``torch.distributed.init_process_group`` from the launcher's
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``), a no-op if already initialized.  ``kwargs`` (the
    config's ``multihost_args``) go to ``init_process_group``: e.g.
    ``backend`` (default nccl, gloo for CPU ranks or ranks sharing one
    card), ``init_method``, ``rank``, ``world_size``."""
    if dist.is_initialized():
        return
    kwargs = dict(kwargs)
    kwargs.setdefault("backend", "nccl")
    dist.init_process_group(**kwargs)
