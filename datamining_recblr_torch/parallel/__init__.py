"""Multi-device execution over a ``{data, model}``, ``{data, seq}`` or
``{data, model, seq}`` mesh on ``torch.distributed`` (counterpart of
``datamining_recblr_tpu/parallel``)."""

from datamining_recblr_torch.parallel.mesh import make_mesh  # noqa: F401
from datamining_recblr_torch.parallel.sharding import (  # noqa: F401
    param_pspecs,
    shard_batch,
    shard_model,
)
from datamining_recblr_torch.parallel.steps import train_step  # noqa: F401
