"""Rank processes of the port's mesh tests (``tests/test_torch_parallel*.py``,
``tests/test_torch_seq_parallel.py``, ``tests/test_torch_seq_attention.py``;
not collected by pytest).  It
imports torch and the port only, never JAX.

``launch(job, world, tmp)`` starts ``world`` processes of this file, one
per rank, joined in a gloo process group over localhost; each runs the
job's cases in order and saves its results, which ``launch`` returns as
a list indexed by rank (``start`` and ``wait`` split it, so the caller
works while the ranks run).  A job is ``{"cases": [(name, fn, kwargs),
...]}`` with ``fn`` a function of this module, called as ``fn(**kwargs)``.

    python torch_mesh_worker.py <job.pt> <world> <port> <rank> <out.pt>
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from datamining_recblr_torch.config import Config  # noqa: E402
from datamining_recblr_torch.models import get_model  # noqa: E402
from datamining_recblr_torch.models import layers as L  # noqa: E402
from datamining_recblr_torch.parallel.collectives import all_gather  # noqa: E402
from datamining_recblr_torch.parallel.input import process_local_rows  # noqa: E402
from datamining_recblr_torch.parallel.mesh import MODEL_AXIS, make_mesh  # noqa: E402


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(job: dict, world: int, tmp):
    """Start ``job`` on ``world`` gloo ranks; ``wait`` takes their results."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    job_path = tmp / "job.pt"
    torch.save(job, job_path)
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    outs = [tmp / f"rank{r}.pt" for r in range(world)]
    procs = [subprocess.Popen([sys.executable, __file__, str(job_path), str(world), str(port),
                               str(r), str(outs[r])], env=env, cwd=tmp,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(world)]
    return procs, outs


def wait(started, timeout: float = 300) -> list:
    """The results by rank of a ``start``ed job (every rank ended)."""
    procs, outs = started
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return [torch.load(o, weights_only=False) for o in outs]


def launch(job: dict, world: int, tmp, timeout: float = 300) -> list:
    """Run ``job`` on ``world`` gloo ranks; their results by rank."""
    return wait(start(job, world, tmp), timeout)


def _model(name, cfg, n_items, t, mesh_shape=None):
    cfg = dict(cfg, **({"mesh_shape": mesh_shape} if mesh_shape else {}))
    config = Config(model=name, config_dict=cfg)
    return config, get_model(name)(config, n_items, t, device="cpu")


def _full_grads(model, mesh):
    """Every parameter's gradient, a sharded one gathered over ``model``."""
    out = {}
    for name, p in model.named_parameters():
        g = p.grad
        out[name] = all_gather(g, mesh, MODEL_AXIS) if name in model.shards else g.clone()
    return out


def step(name, cfg, n_items, t, params, batch, mesh_shape, cloze=None, steps=1,
         unfused=False):
    """``steps`` meshed ``Trainer.train_step``s from the full ``params`` on
    the global ``batch`` (this rank takes its part, ``shard_batch``: its
    data rows and on a seq axis its time chunk; ``cloze`` a global
    BERT4Rec draw to use in place of the model's, or a list of them, one
    a step): the full-sort metric
    sums of the batch from ``params`` (the trainer's
    ``Evaluator.batch_sums`` summed over ``data``), the eval forward of
    the rank's rows, the losses, the first step's gradients put
    together, the rows held and the gathered parameters."""
    from datamining_recblr_torch.eval.evaluator import sum_over_data
    from datamining_recblr_torch.parallel.sharding import gather_state, shard_batch
    from datamining_recblr_torch.train.trainer import Trainer

    if unfused:
        L.FORCE_FUSED_ATTENTION = False
    b = len(batch["item_seq"])
    config, model = _model(name, dict(cfg, train_batch_size=b, eval_batch_size=b,
                                      metrics=["hit", "ndcg"], topk=[5]),
                           n_items, t, mesh_shape)
    trainer = Trainer(config, model, params=params)
    mesh = trainer.mesh
    lo, hi = process_local_rows(b, mesh)
    local = {k: torch.from_numpy(v) for k, v in shard_batch(batch, mesh).items()}
    model.eval()
    with torch.no_grad():
        sums = sum_over_data(trainer.evaluator.batch_sums(local), mesh)
        out = model(local["item_seq"], local["item_seq_len"])
    sums = {k: (float(a), float(b)) for k, (a, b) in sums.items()}
    draws = cloze if isinstance(cloze, list) else [cloze] * steps
    losses, grads = [], None
    for s in range(steps):
        if draws[s] is not None:
            mine = tuple(torch.as_tensor(a[lo:hi]) for a in draws[s])
            model.cloze_draw = lambda *a, mine=mine, **k: mine
        losses.append(float(trainer.train_step(local, s)))
        if s == 0:
            grads = _full_grads(model, mesh)
    return {"losses": losses, "eval_sums": sums, "grads": grads, "forward": out,
            "shards": dict(model.shards), "params": gather_state(model)[0],
            "coords": (mesh.index("data"), mesh.index("model"), mesh.index("seq"))}


def fit(cfg, data_args, t, ckpt, repeat=1, sampled=None, recommend=None, resume_epochs=None):
    """``Trainer.fit`` on the synthetic data of ``data_args`` (``repeat``
    times from scratch), then the best checkpoint's test evaluation; with
    ``sampled`` the evaluation of the test split in that mode from the
    initial parameters; with ``recommend`` (user histories) the top-k of
    the trained model and of ``Recommender.from_checkpoint``; with
    ``resume_epochs`` a new trainer resumed from the best checkpoint and
    fit to that many epochs (its records under "resumed")."""
    from datamining_recblr_torch.data.dataset import build_from_dataframe
    from datamining_recblr_torch.data.synthetic import generate_synthetic_interactions
    from datamining_recblr_torch.serve import Recommender
    from datamining_recblr_torch.train.trainer import Trainer

    data = build_from_dataframe(generate_synthetic_interactions(**data_args), max_seq_len=t)
    out = {"runs": []}
    for _ in range(repeat):
        config = Config(model="RecBLR", config_dict=dict(cfg))
        model = get_model("RecBLR")(config, data.n_items, t, device="cpu")
        trainer = Trainer(config, model)
        if sampled:
            sconfig = Config(model="RecBLR", config_dict=dict(cfg, eval_args={"mode": sampled}))
            from datamining_recblr_torch.eval.evaluator import Evaluator

            out["sampled"] = Evaluator(model, sconfig, mesh=trainer.mesh).evaluate(data.test)
        trainer.fit(data, checkpoint_path=ckpt)
        out["runs"].append([{k: r[k] for k in ("train_loss", "valid_score")}
                            for r in trainer.metrics.epoch_records()])
        out["test"] = trainer.evaluate(data.test, load_best=True)
        out["ckpt"] = trainer.ckpt_path
        out["best_epoch"] = trainer.best_epoch
    if resume_epochs is not None:
        config = Config(model="RecBLR", config_dict=dict(cfg, epochs=resume_epochs))
        resumed = Trainer(config, get_model("RecBLR")(config, data.n_items, t, device="cpu"))
        resumed.resume_from(out["ckpt"])
        resumed.fit(data, checkpoint_path=ckpt + "-resumed")
        out["resumed"] = [{k: r[k] for k in ("epoch", "train_loss", "valid_score")}
                          for r in resumed.metrics.epoch_records()]
    if recommend is not None:
        mesh = trainer.mesh
        out["recommend"] = Recommender(model, top_k=5, mesh=mesh).recommend(recommend)
        rec = Recommender.from_checkpoint(out["ckpt"], config, data.n_items, t, top_k=5,
                                          device="cpu", mesh=mesh)
        out["recommend_ckpt"] = rec.recommend(recommend)
    return out


def recommend(name, cfg, n_items, t, params, users, mesh_shape, top_k=5):
    """``Recommender.recommend(users)`` of a model of ``params`` put on the
    mesh ``mesh_shape``: (ids, scores)."""
    from datamining_recblr_torch.serve import Recommender

    _, model = _model(name, cfg, n_items, t, mesh_shape)
    mesh = make_mesh(mesh_shape, "cpu")
    return Recommender(model, params, top_k=top_k, mesh=mesh).recommend(users)


def resume_opt_state(cfg, n_items, t, path):
    """A meshed RecBLR ``Trainer.resume_from(path)`` (a JAX checkpoint): the
    start epoch, the rows this rank holds and its Adam state of the
    table."""
    from datamining_recblr_torch.train.trainer import Trainer

    config, model = _model("RecBLR", cfg, n_items, t)
    trainer = Trainer(config, model)
    trainer.resume_from(path)
    names = [n for n, _ in model.named_parameters()]
    state = trainer.optimizer.state_dict()["state"][names.index("item_embedding")]
    return {"start_epoch": trainer.start_epoch, "shards": dict(model.shards),
            "step": float(state["step"]), "exp_avg": state["exp_avg"].clone()}


def seq_scan(gates, tokens, cot, mesh_shape, impl="auto", device="cpu"):
    """``seq_parallel_scan`` of this rank's time chunk of the global
    [B, T, C] ``gates`` and ``tokens`` (its data rows on a data axis):
    the chunk of h, of its gradients against the cotangent ``cot``, the
    chunk's (t0, t1), the scan's kernel launches on a card, and the
    error a length that does not divide the axis raises."""
    from datamining_recblr_torch.ops import scan as SC
    from datamining_recblr_torch.ops.seq_parallel_scan import seq_parallel_scan
    from datamining_recblr_torch.parallel.input import seq_chunk

    mesh = make_mesh(mesh_shape, device)
    t0, t1 = seq_chunk(tokens.shape[1], mesh)
    lo, hi = process_local_rows(tokens.shape[0], mesh)

    def mine(a):
        return torch.as_tensor(a[lo:hi, t0:t1]).to(mesh.device).contiguous()

    g, x = mine(gates).requires_grad_(), mine(tokens).requires_grad_()
    before = (SC.linear_scan.launches, SC.linear_scan_reverse.launches)
    h = seq_parallel_scan(g, x, mesh, impl=impl)
    (h * mine(cot)).sum().backward()
    try:
        seq_chunk(tokens.shape[1] + 2, mesh)
        error = None
    except ValueError as e:
        error = str(e)
    return {"h": h.detach().cpu(), "dg": g.grad.cpu(), "dx": x.grad.cpu(), "chunk": (t0, t1),
            "rows": (lo, hi), "divide_error": error,
            "launches": (SC.linear_scan.launches - before[0],
                         SC.linear_scan_reverse.launches - before[1])}


def masks(name, cfg, n_items, t, batch, mesh_shape, step_idx):
    """The training forward of ``batch``'s rows of this rank, twice."""
    config, model = _model(name, cfg, n_items, t, mesh_shape)
    mesh = make_mesh(mesh_shape, "cpu")
    from datamining_recblr_torch.parallel.sharding import shard_batch, shard_model

    shard_model(model, mesh)
    local = shard_batch(batch, mesh)
    seq, lens = torch.from_numpy(local["item_seq"]), torch.from_numpy(local["item_seq_len"])
    model.train()
    with torch.no_grad():
        outs = [model(seq, lens, step=step_idx) for _ in range(2)]
    return {"out": outs, "coords": (mesh.index("data"), mesh.index("model"))}


def vocab(table, ids, targets, weight, n_items, mesh_shape, bf16=False):
    """The vocab-parallel lookup and CE of a tied table: h = the mean of
    the rows ``ids`` [N, S]; loss = the weighted CE of h against the
    table, columns past ``n_items`` at -1e30.  The loss and the gradients
    of the table (gathered) and of the lookup's output."""
    from datamining_recblr_torch.models.base import sharded_rows, vocab_parallel_nll, weighted_mean
    from datamining_recblr_torch.ops.embedding import embedding_lookup
    from datamining_recblr_torch.parallel.collectives import all_reduce_grads, copy_to_model

    mesh = make_mesh(mesh_shape, "cpu")
    m, n = mesh.index(MODEL_AXIS), mesh.size(MODEL_AXIS)
    per = table.shape[0] // n
    shard = torch.nn.Parameter(torch.from_numpy(table[m * per:(m + 1) * per]).clone())
    lo, hi = process_local_rows(len(ids), mesh)
    lookup = embedding_lookup if bf16 else (lambda tab, i: torch.nn.functional.embedding(i, tab))
    rows = sharded_rows(shard, torch.from_numpy(ids[lo:hi]), m * per, mesh, lookup)
    rows.retain_grad()
    h = rows.float().mean(1)
    logits = copy_to_model(h, mesh) @ shard.T
    col = m * per + torch.arange(per)[None, :]
    logits = torch.where(col < n_items, logits, torch.full((), -1e30))
    nll = vocab_parallel_nll(logits, torch.from_numpy(targets[lo:hi]), m * per, mesh)
    loss = weighted_mean(nll, torch.from_numpy(weight[lo:hi]), mesh)
    loss.backward()
    all_reduce_grads([shard], mesh)
    from datamining_recblr_torch.parallel.collectives import all_reduce

    return {"loss": float(all_reduce(loss.detach(), mesh, "data")),
            "table_grad": all_gather(shard.grad, mesh, MODEL_AXIS),
            "rows": rows.detach(), "rows_grad": rows.grad}


def ranks_topk(scores, targets, k, widths, mesh_shape):
    """``target_ranks`` and ``sharded_topk`` of this rank's columns of
    ``scores`` (model rank m holds ``widths[m]`` columns, in order), on
    this rank's data rows."""
    from datamining_recblr_torch.eval.metrics import target_ranks
    from datamining_recblr_torch.ops.topk import sharded_topk

    mesh = make_mesh(mesh_shape, "cpu")
    m = mesh.index(MODEL_AXIS)
    col0 = int(sum(widths[:m]))
    lo, hi = process_local_rows(len(scores), mesh)
    local = torch.from_numpy(scores[lo:hi, col0:col0 + widths[m]])
    ranks = target_ranks(local, torch.from_numpy(targets[lo:hi]), col0=col0, mesh=mesh)
    vals, ids = sharded_topk(local, k, mesh, col0)
    return {"rows": (lo, hi), "ranks": ranks, "vals": vals, "ids": ids}


def main():
    job_path, world, port, rank, out = sys.argv[1:6]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=int(rank),
                            world_size=int(world))
    try:
        job = torch.load(job_path, weights_only=False)
        results = {name: globals()[fn](**kwargs) for name, fn, kwargs in job["cases"]}
        torch.save(results, out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
