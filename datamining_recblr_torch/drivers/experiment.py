"""Single-experiment driver (counterpart of
``datamining_recblr_tpu/drivers/experiment.py``): config -> dataset ->
model -> ``Trainer.fit`` with per-epoch validation -> test from the best
checkpoint, with a per-run log file, the forward's FLOPs, the environment
report and the training-curve CSV and plots.

With ``multihost`` the process is one rank of a mesh: it joins the
process group first (``parallel.mesh.multihost_initialize`` with the
config's ``multihost_args``; backend gloo on the CPU, else nccl by
default) and runs on ``cuda:LOCAL_RANK`` unless ``device`` names
another; ``mesh_shape`` lays the ranks out, and rank 0 writes the plots
and the CSV."""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from datamining_recblr_torch.data.dataset import SeqData, build_dataset
from datamining_recblr_torch.eval.evaluator import format_result
from datamining_recblr_torch.models import get_model
from datamining_recblr_torch.parallel.mesh import local_device, multihost_initialize
from datamining_recblr_torch.train.trainer import Trainer
from datamining_recblr_torch.utils.env import environment_report, format_environment
from datamining_recblr_torch.utils.flops import forward_flops
from datamining_recblr_torch.utils.logging import MetricsLogger, init_logger
from datamining_recblr_torch.utils.plotting import generate_plots


def run_experiment(config, data: SeqData | None = None, plot_prefix: str | None = None,
                   plot_dir: str = "plot", make_plots: bool = True, device=None,
                   params=None) -> dict:
    """Run one experiment on ``device`` (the card unless the caller names
    another).  The model's parameters come from a generator seeded by
    ``config["seed"]``, or from ``params``, a state dict (e.g.
    ``interop.params_from_jax``'s).  Returns {config, data, model, trainer,
    best_valid_score, best_valid_result, test_result, metrics,
    environment, wall_time}, the JAX package's keys."""
    rank0 = True
    if config.get("multihost"):
        # before the first collective: the mesh needs every rank's process
        device = torch.device(device) if device is not None else local_device()
        args = dict(config.get("multihost_args") or {})
        args.setdefault("backend", "gloo" if device.type == "cpu" else "nccl")
        multihost_initialize(**args)
        rank0 = dist.get_rank() == 0
    log_file = None
    if config.get("log_dir"):
        stamp = time.strftime("%b-%d-%Y_%H-%M-%S")
        log_file = (f"{config['log_dir']}/{config['model']}/"
                    f"{config['model']}-{config.get('dataset') or 'data'}-{stamp}.log")
    logger = init_logger(log_file=log_file)
    t_start = time.time()

    if data is None:
        data = build_dataset(config)
    logger.info(f"dataset [{config['dataset']}]: {data.summary()}")

    model = get_model(config["model"])(
        config, data.n_items, data.max_seq_len, device=device,
        generator=torch.Generator().manual_seed(int(config["seed"])))
    metrics = MetricsLogger(config.get("metrics_file"))
    trainer = Trainer(config, model, params=params, metrics_logger=metrics)

    if len(data.train):
        bs = min(int(config["train_batch_size"]), len(data.train))
        flops = forward_flops(model, torch.from_numpy(data.train.windows(np.arange(bs))),
                              torch.from_numpy(data.train.item_seq_len[:bs]))
        logger.info(f"forward FLOPs (products, FlopCounterMode): {flops:,}")
        metrics.log("flops", flops=flops)

    best_score, best_result = trainer.fit(data)
    logger.info(f"best valid: {format_result(best_result)}" if best_result else "no validation")
    test_result = trainer.evaluate(data.test, load_best=True)

    env = environment_report()
    logger.info(format_environment(env))

    if make_plots and rank0:
        prefix = plot_prefix or f"{config['model']}_{config.get('dataset') or 'data'}"
        generate_plots(metrics.epoch_records(), prefix, plot_dir)

    return {
        "config": config,
        "data": data,
        "model": model,
        "trainer": trainer,
        "best_valid_score": best_score,
        "best_valid_result": best_result,
        "test_result": test_result,
        "metrics": metrics,
        "environment": env,
        "wall_time": time.time() - t_start,
    }
