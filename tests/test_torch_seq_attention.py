"""The port's ``seq`` mesh axis for SASRec and BERT4Rec, and ``seq`` beside
``model``, against the JAX package's GSPMD steps on the same meshes, on
the CPU: the port on four gloo ranks (``tests/torch_mesh_worker.py``, one
launch for every case), JAX on four of its eight virtual CPU devices.

* Cases, each from JAX's parameters (``params_from_jax``) on one global
  batch of 16 rows (lengths 0, T/S, T/S + 1 and T among them; two rows at
  weight 0): SASRec and BERT4Rec (hidden 16, 2 heads, 2 layers, inner 32,
  T 32, 128 items, dropout 0) on ``{data: 2, seq: 2}``; RecBLR
  (``test_torch_seq_parallel.py``'s shape) and BERT4Rec on ``{data: 1,
  model: 2, seq: 2}`` with the item table row-sharded (``vocab_row_shard:
  always``).  BERT4Rec's cloze draws are JAX's, one a step, replayed on
  the host and injected.
* Checks: the forward of each rank's rows against JAX's (rtol 2e-5, atol
  2e-6); the first step's loss (rtol 2e-5) and gradients (rtol 1e-4, atol
  1e-5 of each one's largest value) against ``jax.grad`` of the sharded
  loss; three steps' losses against ``make_sharded_train_step``'s (rtol
  2e-5); the full-sort metric sums against ``make_sharded_eval_step``'s,
  each row counted once (rtol 1e-6).
* ``Recommender`` on the mesh (SASRec on ``{data: 2, seq: 2}``, BERT4Rec
  on ``{data: 1, model: 2, seq: 2}``) returns the unmeshed port's ids.
* Dropout 0.2 (hidden and attention) on ``{seq: 4}``, SASRec and
  BERT4Rec through row 15 at the chunk and SASRec through the softmax
  composition (``FORCE_FUSED_ATTENTION = False`` on the ranks too, the
  chunk's rows of the mask): two steps' losses (rtol 2e-5) and the first
  step's gradients (as above) equal the unmeshed port's, every mask
  drawn at its global position.  The
  unmeshed reference runs the per-op composition
  (``FORCE_FUSED_ATTENTION = False``), which reads an empty row's
  position 0 as JAX's ``gather_last`` and the seq path do (the fused top
  layer reads another position there).
* The plain versions at a chunk: row 15 with ``q0`` gives the whole
  call's rows, and the chunks' dk and dv summed give its gradients; row 6
  with ``t0`` gives the whole call's rows.
* The entry point: ``python -m torch.distributed.run --nproc-per-node 4
  -m datamining_recblr_torch.run --model B`` on ``{model: 2, seq: 2}``
  (four CPU ranks over gloo) trains, reloads its best checkpoint and
  prints the same test metrics on every rank.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datamining_recblr_tpu.config import Config as JConfig
from datamining_recblr_tpu.models import get_model as j_get_model
from datamining_recblr_tpu.parallel import (
    make_mesh as j_make_mesh,
    make_sharded_eval_step,
    make_sharded_train_step,
    shard_batch as j_shard_batch,
)
from datamining_recblr_tpu.parallel.sharding import shard_params
from datamining_recblr_tpu.train.optim import build_optimizer
from datamining_recblr_torch.config import Config
from datamining_recblr_torch.data.synthetic import write_stat_matched_dataset
from datamining_recblr_torch.interop import params_from_jax
from datamining_recblr_torch.models import get_model
from datamining_recblr_torch.models import layers as L
from datamining_recblr_torch.ops import attention as A
from datamining_recblr_torch.ops import fused_layer as FL
from datamining_recblr_torch.parallel.sharding import full_rows
from datamining_recblr_torch.serve import Recommender
from datamining_recblr_torch.train.trainer import Trainer
from test_torch_parallel_step import _replay_cloze
from torch_mesh_worker import _free_port, start, wait

N_ITEMS, T, B, STEPS = 128, 32, 16, 3
LENS = [0, 16, 17, 32, 5, 1, 31, 9, 16, 2, 24, 32, 11, 3, 30, 20]
ATTN = {"hidden_size": 16, "n_layers": 2, "n_heads": 2, "inner_size": 32,
        "MAX_ITEM_LIST_LENGTH": T, "hidden_dropout_prob": 0.0, "attn_dropout_prob": 0.0,
        "hidden_act": "gelu", "learning_rate": 0.01}
B4R = dict(ATTN, mask_ratio=0.2)
RECBLR = {"hidden_size": 16, "num_layers": 2, "use_pallas_scan": "never",
          "MAX_ITEM_LIST_LENGTH": T, "dropout_prob": 0.0, "learning_rate": 0.01}
DATA_SEQ = {"data": 2, "seq": 2}
MODEL_SEQ = {"data": 1, "model": 2, "seq": 2}
CASES = {
    "sasrec": ("SASRec", ATTN, DATA_SEQ),
    "bert4rec": ("BERT4Rec", B4R, DATA_SEQ),
    "model-recblr": ("RecBLR", dict(RECBLR, vocab_row_shard="always"), MODEL_SEQ),
    "model-bert4rec": ("BERT4Rec", dict(B4R, vocab_row_shard="always"), MODEL_SEQ),
}
SERVED = {"SASRec": ("sasrec", DATA_SEQ), "BERT4Rec": ("model-bert4rec", MODEL_SEQ)}
DROP = {name: dict(cfg, hidden_dropout_prob=0.2, attn_dropout_prob=0.2)
        for name, cfg in (("SASRec", ATTN), ("BERT4Rec", B4R))}
# the dropout cases: (model, its main case, the softmax composition); the
# softmax one runs last in the launch (the worker's ``unfused`` stays set)
DROP_CASES = {"SASRec": ("SASRec", "sasrec", False), "BERT4Rec": ("BERT4Rec", "bert4rec", False),
              "SASRec-softmax": ("SASRec", "sasrec", True)}
USERS = [[1, 2, 3], [], list(range(1, 40)), [5, 5, 7, 9, 11, 13], [127, 126]]


def _batch(seed):
    rng = np.random.default_rng(seed)
    lens = np.asarray(LENS, np.int32)
    seq = np.where(np.arange(T)[None] < lens[:, None], rng.integers(1, N_ITEMS, (B, T)), 0)
    weight = np.ones(B, np.float32)
    weight[[6, 13]] = 0.0  # a padded row on each data rank
    return {"item_seq": seq.astype(np.int32), "item_seq_len": lens,
            "pos_item": rng.integers(1, N_ITEMS, B).astype(np.int32), "weight": weight}


def _jax_params(model, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + (0.15 * rng.standard_normal(a.shape)).astype(np.float32),
        model.init_params(jax.random.PRNGKey(seed)))


def _jax_inputs(name, cfg, mesh_shape, seed):
    """One case's JAX model on its mesh, parameters, batch, base key and
    (BERT4Rec) the cloze draws of its steps."""
    jcfg = JConfig(model=name, config_dict=dict(cfg, mesh_shape=mesh_shape))
    model = j_get_model(name)(jcfg, N_ITEMS, T)
    model.mesh = j_make_mesh(mesh_shape, devices=jax.devices()[:4])
    params, batch = _jax_params(model, seed), _batch(seed + 1)
    base = jax.random.PRNGKey(seed + 2)
    cloze = ([_replay_cloze(model, jax.random.fold_in(base, s), batch["item_seq"],
                            batch["item_seq_len"]) for s in range(STEPS)]
             if name == "BERT4Rec" else None)
    return {"model": model, "cfg": jcfg, "params": params, "batch": batch, "base": base,
            "cloze": cloze}


def _jax_run(inp, mode):
    """JAX's GSPMD run of one case: the forward, the first step's
    gradients, ``make_sharded_train_step``'s losses and
    ``make_sharded_eval_step``'s sums."""
    model, mesh, base = inp["model"], inp["model"].mesh, inp["base"]
    p = shard_params(jax.tree.map(jnp.asarray, inp["params"]), mesh, mode)
    sb = j_shard_batch({k: jnp.asarray(v) for k, v in inp["batch"].items()}, mesh)
    assert sb["item_seq"].sharding.spec == jax.sharding.PartitionSpec("data", "seq")
    fwd = jax.jit(lambda p, s, n: model.forward(p, s, n, deterministic=True))(
        p, sb["item_seq"], sb["item_seq_len"])
    key = jax.random.fold_in(base, 0)
    grads = jax.jit(jax.grad(lambda p: model.calculate_loss(p, sb, key)))(p)
    sums = make_sharded_eval_step(model, mesh, ["hit", "ndcg"], [5])(
        p, sb["item_seq"], sb["item_seq_len"], sb["pos_item"], sb["weight"])
    opt = build_optimizer(inp["cfg"])
    step = make_sharded_train_step(model, opt, base)
    state, losses = opt.init(p), []
    for s in range(STEPS):
        p, state, loss = step(p, state, sb, s)
        losses.append(float(loss))
    return {"forward": np.asarray(fwd),
            "grads": params_from_jax(jax.tree.map(np.asarray, grads)),
            "losses": losses, "sums": {k: (float(a), float(b)) for k, (a, b) in sums.items()}}


def _unmeshed(name, cfg, params):
    """The unmeshed port of ``params`` in the per-op composition (call with
    ``FORCE_FUSED_ATTENTION`` False)."""
    config = Config(model=name, config_dict=dict(cfg, train_batch_size=B))
    model = get_model(name)(config, N_ITEMS, T, device="cpu")
    return Trainer(config, model, params=full_rows(model, params)), model


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every port case in one launch of four ranks, started before the JAX
    side runs."""
    inputs, sides, cases = {}, {}, []
    for i, (case, (name, cfg, mesh_shape)) in enumerate(CASES.items()):
        inp = inputs[case] = _jax_inputs(name, cfg, mesh_shape, 50 + 3 * i)
        sides[case] = {"params": params_from_jax(inp["params"]), "batch": inp["batch"]}
        cases.append((case, "step", dict(name=name, cfg=cfg, n_items=N_ITEMS, t=T,
                                         params=sides[case]["params"], batch=inp["batch"],
                                         mesh_shape=mesh_shape, cloze=inp["cloze"],
                                         steps=STEPS)))
    for name, (case, mesh_shape) in SERVED.items():
        cases.append((f"serve-{name}", "recommend", dict(
            name=name, cfg=CASES[case][1], n_items=N_ITEMS, t=T, params=sides[case]["params"],
            users=USERS, mesh_shape=mesh_shape)))
    for tag, (name, case, softmax) in DROP_CASES.items():
        cases.append((f"drop-{tag}", "step", dict(
            name=name, cfg=DROP[name], n_items=N_ITEMS, t=T, params=sides[case]["params"],
            batch=sides[case]["batch"], mesh_shape={"seq": 4}, steps=2, unfused=softmax)))
    started = start({"cases": cases}, 4, tmp_path_factory.mktemp("seq-attn"))
    for case, (_, cfg, _) in CASES.items():
        sides[case]["jax"] = _jax_run(inputs[case], cfg.get("vocab_row_shard", "auto"))
    ranks = wait(started)
    return {"ranks": ranks, "sides": sides}


def _close_grads(got, want, msg=""):
    assert set(got) == set(want)
    for name, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(got[name].numpy(), w, rtol=1e-4,
                                   atol=max(1e-5 * float(np.abs(w).max()), 1e-8),
                                   err_msg=f"{msg} {name}")


def _rows(res, case):
    """This rank's rows of the global batch (its data index's)."""
    d, per = res[case]["coords"][0], B // CASES[case][2].get("data", 1)
    return slice(d * per, (d + 1) * per)


@pytest.mark.parametrize("case", list(CASES))
def test_seq_forward_matches_jax(runs, case):
    want = runs["sides"][case]["jax"]["forward"]
    for res in runs["ranks"]:
        np.testing.assert_allclose(res[case]["forward"].numpy(), want[_rows(res, case)],
                                   rtol=2e-5, atol=2e-6, err_msg=str(res[case]["coords"]))


@pytest.mark.parametrize("case", list(CASES))
def test_seq_first_step_matches_jax(runs, case):
    """The first step's loss and gradients (the row-sharded ones put back
    together), the same bits on every rank."""
    want = runs["sides"][case]["jax"]
    first = runs["ranks"][0][case]
    for res in runs["ranks"]:
        got = res[case]
        np.testing.assert_allclose(got["losses"][0], want["losses"][0], rtol=2e-5)
        _close_grads(got["grads"], want["grads"], msg=f"{case} rank {got['coords']}")
        for name, g in got["grads"].items():
            assert torch.equal(g, first["grads"][name]), name


@pytest.mark.parametrize("case", list(CASES))
def test_seq_steps_match_jax(runs, case):
    want = runs["sides"][case]["jax"]["losses"]
    for res in runs["ranks"]:
        assert len(res[case]["losses"]) == STEPS
        np.testing.assert_allclose(res[case]["losses"], want, rtol=2e-5)
        assert res[case]["losses"] == runs["ranks"][0][case]["losses"]


@pytest.mark.parametrize("case", list(CASES))
def test_seq_eval_sums_count_each_row_once(runs, case):
    """The full-sort hit@5 / ndcg@5 sums over ``data`` equal JAX's; the
    weight sum is the batch's 14 real rows, not S times them."""
    want = runs["sides"][case]["jax"]["sums"]
    for res in runs["ranks"]:
        got = res[case]["eval_sums"]
        assert set(got) == set(want) == {"hit@5", "ndcg@5"}
        for k, (sv, wv) in want.items():
            np.testing.assert_allclose(got[k], (sv, wv), rtol=1e-6, err_msg=k)
        assert got["hit@5"][1] == 14.0


@pytest.mark.parametrize("name", list(SERVED))
def test_seq_recommender_serves_the_unmeshed_ids(runs, name, monkeypatch):
    monkeypatch.setattr(L, "FORCE_FUSED_ATTENTION", False)
    case, _ = SERVED[name]
    _, model = _unmeshed(name, CASES[case][1], runs["sides"][case]["params"])
    ids, vals = Recommender(model, top_k=5).recommend(USERS)
    for res in runs["ranks"]:
        got_ids, got_vals = res[f"serve-{name}"]
        np.testing.assert_array_equal(got_ids, ids)
        np.testing.assert_allclose(got_vals, vals, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("tag", list(DROP_CASES))
def test_seq_dropout_trains_as_the_unmeshed_port(runs, tag, monkeypatch):
    """{seq: 4} at p 0.2: each chunk draws the whole sequence's masks at its
    positions (prologue, probabilities, after W_o and the FFN, and
    BERT4Rec's cloze draw on the full window); through row 15 at the
    chunk, and (``-softmax``) through the softmax composition at the
    chunk's rows of the mask."""
    monkeypatch.setattr(L, "FORCE_FUSED_ATTENTION", False)
    name, case, _ = DROP_CASES[tag]
    trainer, model = _unmeshed(name, DROP[name], runs["sides"][case]["params"])
    batch = {k: torch.from_numpy(v) for k, v in runs["sides"][case]["batch"].items()}
    losses, grads = [], None
    for s in range(2):
        losses.append(float(trainer.train_step(batch, s)))
        if s == 0:
            grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    for res in runs["ranks"]:
        got = res[f"drop-{tag}"]
        np.testing.assert_allclose(got["losses"], losses, rtol=2e-5)
        _close_grads(got["grads"], grads, msg=f"dropout rank {got['coords']}")
    assert not np.allclose(losses[0], runs["ranks"][0][case]["losses"][0], rtol=1e-3)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_attention_at_a_query_chunk(causal):
    """Row 15's plain version at chunks of 8 queries (q0 0, 8, 16, 24 of T
    32, dropout 0.3, lens 0, 1, 9 and 32): each chunk's output and dq are
    the whole call's rows, and the chunks' dk and dv summed are its."""
    gen = torch.Generator().manual_seed(5)
    b, h, t, dh, tq = 4, 2, 32, 8, 8
    q, k, v = (torch.randn((b, h, t, dh), generator=gen).requires_grad_() for _ in range(3))
    lens = torch.tensor([0, 1, 9, 32])
    out = A.fused_attention(q, k, v, lens, 11, causal, 0.3)
    dout = torch.randn(out.shape, generator=gen)
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), dout)
    dk_sum, dv_sum = torch.zeros_like(dk), torch.zeros_like(dv)
    for q0 in range(0, t, tq):
        rows = slice(q0, q0 + tq)
        qc = q[:, :, rows].detach().clone().requires_grad_()
        oc = A.fused_attention(qc, k, v, lens, 11, causal, 0.3, q0=q0)
        torch.testing.assert_close(oc, out[:, :, rows], rtol=0, atol=0)
        gq, gk, gv = torch.autograd.grad(oc, (qc, k, v), dout[:, :, rows])
        torch.testing.assert_close(gq, dq[:, :, rows], rtol=1e-5, atol=1e-6)
        dk_sum += gk
        dv_sum += gv
    torch.testing.assert_close(dk_sum, dk, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dv_sum, dv, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="must divide"):
        A._check(q[:, :, :7].contiguous(), k.detach(), v.detach(), 0)


def test_plain_ln_dropout_at_a_chunk():
    """Row 6's plain version with ``t0`` draws the whole call's mask at the
    chunk's positions: the chunk's rows, bit for bit."""
    gen = torch.Generator().manual_seed(6)
    x, pos = torch.randn((3, 20, 12), generator=gen), torch.randn((20, 12), generator=gen)
    scale, bias = torch.randn(12, generator=gen), torch.randn(12, generator=gen)
    whole = FL.fused_ln_dropout(x, pos, scale, bias, 0.3, 21)
    for t0 in (0, 5, 10, 15):
        rows = slice(t0, t0 + 5)
        assert torch.equal(FL.fused_ln_dropout(x[:, rows], pos[rows], scale, bias, 0.3, 21, t0),
                           whole[:, rows])


def test_run_trains_bert4rec_on_model_and_seq(tmp_path):
    write_stat_matched_dataset(str(tmp_path / "dataset"), "ml1m-synth", out_name="t",
                               n_users=40, n_items=30, n_inters=900, n_clusters=5)
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(root))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "4",
           "--master-addr", "127.0.0.1", "--master-port", str(_free_port()),
           "-m", "datamining_recblr_torch.run", "--model", "B", "--config", "reference",
           "-d", "t", "--epochs", "1", "--device", "cpu", "--set", "hidden_size=8",
           "--set", "MAX_ITEM_LIST_LENGTH=8", "--set", "train_batch_size=64",
           "--set", "mesh_shape={'model': 2, 'seq': 2}", "--set", "vocab_row_shard=always",
           "--set", "multihost=True"]
    run = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=240)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    tests = [line for line in run.stdout.splitlines() if line.startswith("test:")]
    assert len(tests) == 4 and len(set(tests)) == 1, run.stdout[-2000:]
    assert "ndcg@10" in tests[0]
