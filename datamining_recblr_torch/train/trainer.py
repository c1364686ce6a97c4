"""Training loop of the port (counterpart of
``datamining_recblr_tpu/train/trainer.py`` on one device): per-epoch
validation, early stopping, best-checkpoint retention and reload, CE or
BPR, and a ``torch.profiler`` trace of one epoch (``profile_dir``).

* The whole training split lives on the device; each step gathers its
  batch there from an index vector (a COMPACT split assembles its
  windows on the device), runs forward, backward and Adam, and keeps
  the loss on the device.
* The epoch's permutation comes from ``np.random.default_rng((seed,
  epoch))``; under BPR each step's negatives follow from the same
  generator, uniform in [1, n_items) with up to 4 rounds of resampling
  where one hits the positive, so the port draws the JAX package's
  negatives; the last batch is padded with row 0 at weight 0; the epoch
  loss is the sum of per-batch mean losses; dropout masks are seeded by
  (seed, global step, layer).  A resumed run replays the same
  trajectory.
* The JAX trainer's epoch-scan super-steps and host-batch streaming
  exist only for a remote TPU's dispatch latency and are left out; the
  semantics above are theirs.
* With ``mesh_shape`` (``{data: D, model: M}``, ``{data: D, seq: S}`` or
  ``{data: D, model: M, seq: S}``, any model; one process per rank,
  ``torch.distributed`` initialized)
  the model goes on the mesh from its full parameters
  (``parallel/sharding.py``); each step every rank draws the global
  batch and its negatives and keeps its data index's rows, from the
  split on its device (``mesh_input: resident``) or from the host
  (``stream``), and a seq rank runs its chunk of their time axis; the
  gradients are summed over ``data`` and ``seq`` and the loss is the
  global one.  Rank 0 writes the gathered checkpoint, the file an
  unmeshed run writes.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed as dist

from datamining_recblr_torch.data.batching import batch_count
from datamining_recblr_torch.eval.evaluator import (
    Evaluator,
    format_result,
    history_fn_from_data,
)
from datamining_recblr_torch.parallel.input import process_local_rows, shard_host_batch
from datamining_recblr_torch.parallel.mesh import DATA_AXIS, make_mesh
from datamining_recblr_torch.parallel.sharding import (
    check_seq_axis,
    full_rows,
    gather_state,
    shard_model,
    shard_optimizer_state,
)
from datamining_recblr_torch.parallel.steps import train_step
from datamining_recblr_torch.train.checkpoint import (
    checkpoint_file,
    restore_checkpoint,
    save_checkpoint,
)
from datamining_recblr_torch.train.optim import (
    build_optimizer,
    is_torch_state,
    opt_state_from_jax,
)
from datamining_recblr_torch.utils.logging import MetricsLogger, init_logger


class Trainer:
    def __init__(self, config, model, params=None, metrics_logger=None):
        """``params``: a state_dict to start from (e.g.
        ``interop.params_from_jax``, or a full one on a mesh); None keeps
        the model's own."""
        self.config = config
        self.model = model
        self.device = model.device
        self.mesh = None
        mesh_shape = config.get("mesh_shape")
        if mesh_shape:
            mesh_shape = {str(k): int(v) for k, v in dict(mesh_shape).items()}
            check_seq_axis(model, mesh_shape)
            data = mesh_shape.get(DATA_AXIS, 1)
            if int(config["train_batch_size"]) % data:
                raise ValueError(f"train_batch_size {config['train_batch_size']} must divide "
                                 f"by the data mesh axis ({data})")
            # a model on such a mesh already (another Trainer's) keeps it
            self.mesh = (model.mesh if model.mesh is not None
                         and model.mesh.shape == mesh_shape else make_mesh(mesh_shape, model.device))
            shard_model(model, self.mesh, params)
        elif params is not None:
            model.load_state_dict(params)
        self.logger = init_logger()
        self.metrics = metrics_logger or MetricsLogger(config.get("metrics_file"))
        self.optimizer = build_optimizer(config, model.parameters())
        self.evaluator = Evaluator(model, config, mesh=self.mesh)

        self.batch_size = int(config["train_batch_size"])
        self.valid_metric = str(config["valid_metric"]).lower()
        self.bigger = bool(config.get("valid_metric_bigger", True))
        self.stopping_step = int(config["stopping_step"])
        self.eval_step = int(config.get("eval_step", 1))
        self.epochs = int(config["epochs"])
        self.profile_dir = config.get("profile_dir")
        self.ckpt_path = None
        self.start_epoch = 0
        self.best_score = -np.inf if self.bigger else np.inf
        self.best_epoch = -1
        self.best_result: dict = {}

    # ------------------------------------------------------------------
    def _is_better(self, score):
        return score > self.best_score if self.bigger else score < self.best_score

    def _checkpoint_state(self, epoch):
        """The checkpoint's content; on a mesh the gathered state (a
        collective)."""
        if self.mesh is None:
            params, opt_state = self.model.state_dict(), self.optimizer.state_dict()
        else:
            params, opt_state = gather_state(self.model, self.optimizer)
        return {
            "params": params,
            "opt_state": opt_state,
            "epoch": epoch,
            "best_score": float(self.best_score),
            "best_epoch": self.best_epoch,
        }

    def _save(self, path, epoch) -> str:
        """Write the checkpoint of ``epoch`` (on a mesh rank 0 writes, the
        others wait for it); returns its file."""
        state = self._checkpoint_state(epoch)
        if self.mesh is None:
            return save_checkpoint(path, state)
        if dist.get_rank() == 0:
            save_checkpoint(path, state)
        dist.barrier()
        return checkpoint_file(path)

    def _load_params(self, params):
        """Load a full state dict (a checkpoint's, its vocab-leading rows
        padded as its run padded them) into the model."""
        if self.mesh is None:
            self.model.load_state_dict(full_rows(self.model, params))
        else:
            shard_model(self.model, self.mesh, params)

    def resume_from(self, path):
        """Restore params, optimizer and progress from a checkpoint (the
        port's, or one the JAX package wrote: its optax state mapped onto
        this trainer's optimizer, which must be the same learner) and
        continue training at the following epoch."""
        state = restore_checkpoint(path)
        self._load_params(state["params"])
        opt_state = state["opt_state"]
        if not is_torch_state(opt_state):
            opt_state = opt_state_from_jax(self.model, self.optimizer, opt_state)
        # this rank's rows (all of them off a mesh) at the model's padding
        self.optimizer.load_state_dict(shard_optimizer_state(self.model, opt_state))
        self.start_epoch = int(state["epoch"]) + 1
        self.best_score = float(state["best_score"])
        self.best_epoch = int(state["best_epoch"])
        self.ckpt_path = path
        self.logger.info(f"resumed from {path} at epoch {self.start_epoch}")

    def device_split(self, train):
        """The training split as device tensors (dense or compact)."""
        names = (("flat_items", "flat_start", "item_seq_len", "pos_item") if train.compact
                 else ("item_seq", "item_seq_len", "pos_item"))
        return {k: torch.from_numpy(np.ascontiguousarray(getattr(train, k))).to(self.device)
                for k in names}

    def negatives(self, host_rng, pos):
        """BPR negatives for the positives ``pos`` [B] (host): uniform in
        [1, n_items), with up to 4 rounds of resampling where one equals
        its positive (the JAX trainer's draws, in its order)."""
        n_items = self.model.n_items
        neg = host_rng.integers(1, n_items, size=len(pos)).astype(np.int32)
        for _ in range(4):
            coll = neg == pos
            if not coll.any():
                break
            neg[coll] = host_rng.integers(1, n_items, int(coll.sum()))
        return neg

    def gather_batch(self, data, idx, weight):
        """The batch of rows ``idx`` (a device index vector) of a
        ``device_split``, assembled on the device."""
        if "flat_items" in data:
            t = int(self.model.max_seq_len)
            start = data["flat_start"][idx].long()
            lens = data["item_seq_len"][idx]
            valid = torch.arange(t, device=idx.device)[None, :] < lens[:, None]
            flat = data["flat_items"]
            cols = (start[:, None] + torch.arange(t, device=idx.device)[None, :]).clamp_max(
                flat.shape[0] - 1)
            seq = torch.where(valid, flat[cols], torch.zeros((), dtype=flat.dtype,
                                                             device=flat.device))
        else:
            seq = data["item_seq"][idx]
            lens = data["item_seq_len"][idx]
        return {"item_seq": seq, "item_seq_len": lens, "pos_item": data["pos_item"][idx],
                "weight": weight}

    def train_step(self, batch, step):
        """One forward, backward and Adam update (``batch`` this rank's
        rows on a mesh); returns the global loss as a device scalar."""
        return train_step(self.model, self.optimizer, batch, step, self.mesh)

    def fit(self, data, valid_split=None, checkpoint_path=None):
        """data: SeqData (train on data.train, validate on data.valid
        unless valid_split is given).  Returns (best_score, best_result)."""
        train = data.train
        valid = valid_split if valid_split is not None else data.valid
        history_fn = history_fn_from_data(data) if self.config.get("mask_history") else None
        if self.evaluator.pop_sampling and self.evaluator.pop_probs is None:
            self.evaluator.set_item_popularity(data.item_popularity())
        use_bpr = self.model.loss_type == "BPR"
        n = len(train)
        steps_per_epoch = batch_count(n, self.batch_size)
        seed = int(self.config["seed"])
        mesh_input = str(self.config.get("mesh_input", "resident"))
        if self.mesh is not None and mesh_input not in ("resident", "stream"):
            raise ValueError(f"mesh_input must be resident|stream, got {mesh_input!r}")
        stream = self.mesh is not None and mesh_input == "stream"
        # this rank's rows of every global batch (all of them off a mesh)
        lo, hi = process_local_rows(self.batch_size, self.mesh)
        dev_data = None if stream else self.device_split(train)
        if checkpoint_path is None:
            checkpoint_path = (f"{self.config['checkpoint_dir']}/"
                               f"{self.config['model']}-{self.config.get('dataset') or 'data'}")

        global_step = self.start_epoch * steps_per_epoch
        cur_step = 0
        for epoch in range(self.start_epoch, self.epochs):
            t0 = time.time()
            host_rng = np.random.default_rng((seed, epoch))
            perm = host_rng.permutation(n)
            prof = self._start_profile() if epoch == self.start_epoch + 1 else None
            losses = []
            for s in range(steps_per_epoch):
                chunk = perm[s * self.batch_size : (s + 1) * self.batch_size]
                pad = self.batch_size - len(chunk)
                weight = np.ones(self.batch_size, np.float32)
                if pad:
                    chunk = np.concatenate([chunk, np.zeros(pad, np.int64)])
                    weight[self.batch_size - pad :] = 0.0
                rows = chunk[lo:hi]
                if stream:
                    batch = shard_host_batch(
                        {"item_seq": train.windows(rows), "item_seq_len": train.item_seq_len[rows],
                         "pos_item": train.pos_item[rows], "weight": weight[lo:hi]}, self.mesh)
                else:
                    idx = torch.from_numpy(rows.astype(np.int64)).to(self.device)
                    batch = self.gather_batch(dev_data, idx,
                                              torch.from_numpy(weight[lo:hi]).to(self.device))
                if use_bpr:  # drawn for the global batch
                    neg = self.negatives(host_rng, train.pos_item[chunk])[lo:hi]
                    batch["neg_item"] = torch.from_numpy(neg).to(self.device)
                losses.append(self.train_step(batch, global_step))
                global_step += 1
            # epoch loss = sum of per-batch mean losses (one device sync)
            epoch_loss = float(torch.stack(losses).sum())
            if prof is not None:
                self._stop_profile(prof, epoch)
            train_time = time.time() - t0
            record = {"epoch": epoch, "train_loss": epoch_loss, "train_time": train_time}
            if self.device.type == "cuda":
                record["device_mem_gb"] = round(
                    torch.cuda.max_memory_allocated(self.device) / 2**30, 3)
            line = (f"epoch {epoch} training [time: {train_time:.2f}s, "
                    f"train loss: {epoch_loss:.4f}]")

            if valid is not None and len(valid) and (epoch + 1) % self.eval_step == 0:
                t1 = time.time()
                result = self.evaluator.evaluate(valid, history_fn)
                eval_time = time.time() - t1
                score = result.get(self.valid_metric, 0.0)
                record.update(valid_score=score, eval_time=eval_time,
                              **{f"valid_{k}": v for k, v in result.items()})
                line += f" | valid [time: {eval_time:.2f}s, {self.valid_metric}: {score:.4f}]"
                if self._is_better(score):
                    self.best_score = score
                    self.best_epoch = epoch
                    self.best_result = result
                    cur_step = 0
                    self.ckpt_path = self._save(checkpoint_path, epoch)
                    line += " *best*"
                else:
                    cur_step += 1
            self.logger.info(line)
            self.metrics.log("epoch", **record)
            if valid is not None and len(valid) and cur_step > self.stopping_step:
                self.logger.info(
                    f"early stop at epoch {epoch} (best {self.valid_metric}="
                    f"{self.best_score:.4f} @ epoch {self.best_epoch})")
                break

        if valid is None or not len(valid):
            # no validation: keep the final params as "best"
            self.ckpt_path = self._save(checkpoint_path, self.epochs - 1)
        self.metrics.log(
            "fit_done", best_epoch=self.best_epoch,
            best_score=float(self.best_score) if np.isfinite(self.best_score) else None,
            **{f"best_{k}": v for k, v in self.best_result.items()},
        )
        return self.best_score, self.best_result

    def _start_profile(self):
        """A started ``torch.profiler`` capture (CPU, and the card's
        kernels on a card) when ``profile_dir`` is set, else None."""
        if not self.profile_dir:
            return None
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        return prof

    def _stop_profile(self, prof, epoch):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.__exit__(None, None, None)
        os.makedirs(self.profile_dir, exist_ok=True)
        path = os.path.join(self.profile_dir, f"trace_epoch{epoch}.json")
        prof.export_chrome_trace(path)
        self.logger.info(f"profiler trace written to {path}")

    # ------------------------------------------------------------------
    def evaluate(self, split, load_best=True, history_fn=None):
        """Evaluation in the config's mode; with ``load_best`` on the best
        checkpoint's parameters (the trainer's own are put back after)."""
        current = None
        if load_best and self.ckpt_path:
            current = {k: v.clone() for k, v in self.model.state_dict().items()}
            self._load_params(restore_checkpoint(self.ckpt_path)["params"])
        try:
            result = self.evaluator.evaluate(split, history_fn)
        finally:
            if current is not None:
                self.model.load_state_dict(current)
        self.logger.info("test result: " + format_result(result))
        self.metrics.log("test", **result)
        return result
