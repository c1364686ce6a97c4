"""The meshed train step (counterpart of
``datamining_recblr_tpu/parallel/steps.py``), which ``Trainer.train_step``
runs on and off a mesh.

JAX jits one function over the mesh and lets GSPMD insert the
collectives; here each rank runs the step on its rows and calls them:
the model's vocab-parallel lookup and CE reduce over ``model``
(``models/base.py``), a ``seq`` axis's exchanges run inside the forward
(RecBLR's halo, carry and selection, ``models/recblr.py``; the attention
models' K and V gathers and selection, ``models/sasrec.py``), the gradients
are summed over ``data`` and ``seq`` before the optimizer's step, and the
loss comes back as the global value, the same on every rank.  The eval
step is ``Evaluator``'s: each rank scores its rows and ``sum_over_data``
returns the global metric sums.  A meshed run starts from the unmeshed
run's parameters, sliced by ``sharding.shard_model`` (the Trainer's
``__init__``)."""

from __future__ import annotations

from datamining_recblr_torch.parallel.collectives import all_reduce, all_reduce_grads
from datamining_recblr_torch.parallel.mesh import DATA_AXIS, SEQ_AXIS


def train_step(model, optimizer, batch, step, mesh=None):
    """One forward, backward and optimizer update on this rank's rows of a
    batch; returns the (global) loss as a device scalar."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    loss = model.calculate_loss(batch, step=step)
    loss.backward()
    if mesh is not None:
        all_reduce_grads(model.parameters(), mesh, (DATA_AXIS, SEQ_AXIS))
        loss = all_reduce(all_reduce(loss, mesh, DATA_AXIS), mesh, SEQ_AXIS)
    optimizer.step()
    return loss.detach()

