"""The port's ``seq`` mesh axis (RecBLR's time axis sharded over
``torch.distributed``) against the JAX package's sequence-parallel code
on the CPU, on four gloo ranks (``tests/torch_mesh_worker.py``), with JAX
on four of its eight virtual CPU devices.

* ``seq_parallel_scan`` on ``{seq: 4}`` against JAX's
  ``seq_parallel_scan(..., impl="xla")`` and its serial oracle at T 8, 32
  and 64 (forward rtol / atol 1e-5), its gradients against JAX's
  ``jax.vjp`` (rtol 1e-4, atol 1e-5); a T that does not divide raises.
* RecBLR on ``{data: 2, seq: 2}`` at JAX's test shape (128 items, T 32,
  B 16, hidden 16, 2 layers, ``use_pallas_scan: never``, dropout 0) from
  JAX's parameters: the forward against JAX's on the same mesh (rtol
  2e-5, atol 2e-6), the first step's loss and gradients against JAX's
  seq-sharded step (loss rtol 2e-5, gradients rtol 1e-4 and atol 1e-5 of
  each one's largest value), three steps' losses against
  ``make_sharded_train_step``'s, and the full-sort metric sums against
  ``make_sharded_eval_step``'s (not S times them).  The batch holds
  lengths 0 (position T-1, on the last chunk), T/S, T/S + 1 and T.
* The halo across shards: d_conv 4 at T 8 on ``{seq: 4}`` (T/S = 2 <
  K-1 = 3), lengths 0, 1, 2, 3 and 8, forward and gradients against
  JAX's single-device model.
* Dropout 0.2: ``{seq: 4}`` trains as the port's unmeshed model (the
  masks drawn at global positions; losses rtol 1e-6, gradients 1e-4),
  and each ``{data: 2, seq: 2}`` rank's training forward equals the
  ``{data: 2}`` rank's (an unmeshed model with that data index's seed
  offset on its rows).
* ``Trainer.fit`` on ``{data: 2, seq: 2}`` against the unmeshed fit (rtol
  2e-4, atol 5e-5), its checkpoint, resume, uni20 evaluation and
  ``Recommender`` ids.
* What the seq axis does not take: a T that does not divide ``seq``
  (SASRec, BERT4Rec and ``seq`` beside ``model`` are
  ``tests/test_torch_seq_attention.py``'s)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datamining_recblr_tpu.config import Config as JConfig
from datamining_recblr_tpu.models import get_model as j_get_model
from datamining_recblr_tpu.ops.scan import linear_scan_serial as j_scan_serial
from datamining_recblr_tpu.ops.scan import linear_scan_xla
from datamining_recblr_tpu.ops.seq_parallel_scan import seq_parallel_scan as j_seq_scan
from datamining_recblr_tpu.parallel import (
    make_mesh as j_make_mesh,
    make_sharded_eval_step,
    make_sharded_train_step,
    shard_batch as j_shard_batch,
)
from datamining_recblr_tpu.train.optim import build_optimizer
from datamining_recblr_torch.config import Config
from datamining_recblr_torch.data.dataset import build_from_dataframe
from datamining_recblr_torch.data.synthetic import generate_synthetic_interactions
from datamining_recblr_torch.eval.evaluator import Evaluator
from datamining_recblr_torch.interop import params_from_jax
from datamining_recblr_torch.models import get_model
from datamining_recblr_torch.models import layers as L
from datamining_recblr_torch.ops import philox
from datamining_recblr_torch.serve import Recommender
from datamining_recblr_torch.train.trainer import Trainer
from torch_mesh_worker import start, wait

SCAN_TS = (8, 32, 64)
MESH = {"data": 2, "seq": 2}
N_ITEMS, T, B = 128, 32, 16
CFG = {"hidden_size": 16, "num_layers": 2, "use_pallas_scan": "never",
       "MAX_ITEM_LIST_LENGTH": T, "dropout_prob": 0.0, "learning_rate": 0.01}
HALO_T, HALO_ITEMS = 8, 40
HALO_CFG = {"hidden_size": 16, "num_layers": 2, "d_conv": 4, "MAX_ITEM_LIST_LENGTH": HALO_T,
            "dropout_prob": 0.0, "learning_rate": 0.01}
DROP_CFG = dict(HALO_CFG, dropout_prob=0.2)
FIT_T = 16
FIT_DATA = dict(n_users=120, n_items=62, min_len=8, max_len=20, markov_weight=0.9, seed=31)
FIT_CFG = {"hidden_size": 16, "num_layers": 2, "epochs": 2, "train_batch_size": 128,
           "eval_batch_size": 256, "MAX_ITEM_LIST_LENGTH": FIT_T, "dataset": "synthetic",
           "dropout_prob": 0.0}
USERS = [[1, 2, 3], [], list(range(1, 40)), [5, 5, 7, 9, 11, 13]]


def _scan_case(t):
    rng = np.random.default_rng(t)
    gates = rng.uniform(0.4, 0.999, size=(3, t, 5)).astype(np.float32)
    tokens = rng.standard_normal((3, t, 5)).astype(np.float32)
    cot = rng.standard_normal((3, t, 5)).astype(np.float32)
    return gates, tokens, cot


def _batch(n_items, t, lens, seed):
    rng = np.random.default_rng(seed)
    lens = np.asarray(lens, np.int32)
    seq = np.where(np.arange(t)[None] < lens[:, None], rng.integers(1, n_items, (len(lens), t)), 0)
    return {"item_seq": seq.astype(np.int32), "item_seq_len": lens,
            "pos_item": rng.integers(1, n_items, len(lens)).astype(np.int32),
            "weight": np.ones(len(lens), np.float32)}


def _jax_params(model, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + (0.15 * rng.standard_normal(a.shape)).astype(np.float32),
        model.init_params(jax.random.PRNGKey(seed)))


def _jax_model(n_items, t, cfg, mesh=None):
    model = j_get_model("RecBLR")(JConfig(model="RecBLR", config_dict=dict(cfg)), n_items, t)
    model.mesh = mesh
    return model


def _jax_seq_step(params, batch):
    """JAX's RecBLR on {data: 2, seq: 2}: forward, first-step gradients,
    three losses of ``make_sharded_train_step``, eval sums."""
    mesh = j_make_mesh(MESH, devices=jax.devices()[:4])
    model = _jax_model(N_ITEMS, T, CFG, mesh)
    assert model._seq_shards() == 2
    sb = j_shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh)
    assert sb["item_seq"].sharding.spec == jax.sharding.PartitionSpec("data", "seq")
    p = jax.tree.map(jnp.asarray, params)
    fwd = jax.jit(lambda p, s, n: model.forward(p, s, n, deterministic=True))(
        p, sb["item_seq"], sb["item_seq_len"])
    key = jax.random.PRNGKey(5)
    grads = jax.jit(jax.grad(lambda p: model.calculate_loss(p, sb, key)))(p)
    sums = make_sharded_eval_step(model, mesh, ["hit", "ndcg"], [5])(
        p, sb["item_seq"], sb["item_seq_len"], sb["pos_item"], sb["weight"])
    opt = build_optimizer(JConfig(model="RecBLR", config_dict=dict(CFG)))
    step = make_sharded_train_step(model, opt, key)
    state, losses = opt.init(p), []
    for s in range(3):
        p, state, loss = step(p, state, sb, s)
        losses.append(float(loss))
    return {"forward": np.asarray(fwd), "grads": params_from_jax(jax.tree.map(np.asarray, grads)),
            "losses": losses, "sums": {k: (float(a), float(b)) for k, (a, b) in sums.items()}}


def _jax_single(params, batch, n_items, t, cfg):
    model = _jax_model(n_items, t, cfg)
    p = jax.tree.map(jnp.asarray, params)
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    fwd = jax.jit(lambda p, s, n: model.forward(p, s, n, deterministic=True))(
        p, b["item_seq"], b["item_seq_len"])
    grads = jax.jit(jax.grad(lambda p: model.calculate_loss(p, b, jax.random.PRNGKey(0))))(p)
    return {"forward": np.asarray(fwd), "grads": params_from_jax(jax.tree.map(np.asarray, grads))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every port case in one launch of four ranks, and each JAX side."""
    tmp = tmp_path_factory.mktemp("seq")
    main = _batch(N_ITEMS, T, [0, 16, 17, 32, 5, 1, 31, 9, 16, 2, 24, 32, 11, 3, 30, 20], 41)
    main["weight"][[6, 13]] = 0.0  # padded rows on each data rank
    main_params = _jax_params(_jax_model(N_ITEMS, T, CFG), 3)
    halo = _batch(HALO_ITEMS, HALO_T, [0, 1, 2, 3, 8, 4, 6, 7], 42)
    halo_params = _jax_params(_jax_model(HALO_ITEMS, HALO_T, HALO_CFG), 4)
    drop = halo
    mcfg = dict(FIT_CFG, mesh_shape=MESH, checkpoint_dir=str(tmp / "saved"))
    cases = [(f"scan{t}", "seq_scan", dict(zip(("gates", "tokens", "cot"), _scan_case(t)),
                                            mesh_shape={"seq": 4}, impl=impl))
             for t, impl in zip(SCAN_TS, ("xla", "auto", "xla"))]
    cases += [
        ("main", "step", dict(name="RecBLR", cfg=CFG, n_items=N_ITEMS, t=T,
                              params=params_from_jax(main_params), batch=main, mesh_shape=MESH,
                              steps=3)),
        ("halo", "step", dict(name="RecBLR", cfg=HALO_CFG, n_items=HALO_ITEMS, t=HALO_T,
                              params=params_from_jax(halo_params), batch=halo,
                              mesh_shape={"seq": 4})),
        ("drop", "step", dict(name="RecBLR", cfg=DROP_CFG, n_items=HALO_ITEMS, t=HALO_T,
                              params=params_from_jax(halo_params), batch=drop,
                              mesh_shape={"seq": 4}, steps=2)),
        ("masks", "masks", dict(name="RecBLR", cfg=DROP_CFG, n_items=HALO_ITEMS, t=HALO_T,
                                batch=drop, mesh_shape=MESH, step_idx=3)),
        ("fit", "fit", dict(cfg=mcfg, data_args=FIT_DATA, t=FIT_T, ckpt=str(tmp / "fit"),
                            sampled="uni20", recommend=USERS, resume_epochs=3)),
    ]
    started = start({"cases": cases}, 4, tmp / "ranks")
    jax_side = {"main": _jax_seq_step(main_params, main),
                "halo": _jax_single(halo_params, halo, HALO_ITEMS, HALO_T, HALO_CFG)}
    mesh = j_make_mesh({"seq": 4}, devices=jax.devices()[:4])

    @jax.jit
    def scan_and_vjps(g, x, cot):
        h, vjp = jax.vjp(lambda g, x: j_seq_scan(g, x, mesh, "seq", impl="xla"), g, x)
        return h, vjp(cot), jax.vjp(linear_scan_xla, g, x)[1](cot)

    for t in SCAN_TS:
        g, x, cot = _scan_case(t)
        h, grads, grads1 = jax.tree.map(np.asarray, scan_and_vjps(g, x, cot))
        jax_side[f"scan{t}"] = {"h": h, "oracle": j_scan_serial(g, x), "grads": grads,
                                "grads1": grads1}
    return {"ranks": wait(started), "jax": jax_side, "batches": {"main": main, "drop": drop},
            "halo_params": params_from_jax(halo_params)}


def _close_grads(got, want, rtol=1e-4, atol_share=1e-5, msg=""):
    assert set(got) == set(want)
    for name, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(got[name].numpy(), w, rtol=rtol,
                                   atol=max(atol_share * float(np.abs(w).max()), 1e-8),
                                   err_msg=f"{msg} {name}")


@pytest.mark.parametrize("t", SCAN_TS)
def test_seq_parallel_scan_matches_jax(runs, t):
    """Each rank's chunk of h against JAX's seq-parallel scan and the
    serial oracle, its gradients against JAX's VJP (the seq-parallel one
    and the single-device one); T + 2 does not divide the axis."""
    want = runs["jax"][f"scan{t}"]
    for r, res in enumerate(runs["ranks"]):
        got = res[f"scan{t}"]
        t0, t1 = got["chunk"]
        assert (t0, t1) == (r * t // 4, (r + 1) * t // 4)
        np.testing.assert_allclose(got["h"].numpy(), want["h"][:, t0:t1], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["h"].numpy(), want["oracle"][:, t0:t1], rtol=1e-5,
                                   atol=1e-5)
        for mine, theirs, one in zip((got["dg"], got["dx"]), want["grads"], want["grads1"]):
            np.testing.assert_allclose(mine.numpy(), theirs[:, t0:t1], rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(mine.numpy(), one[:, t0:t1], rtol=1e-4, atol=1e-5)
        assert "must divide" in got["divide_error"]
        assert got["launches"] == (0, 0)  # the CPU runs the plain scan


def test_seq_forward_matches_jax_on_the_same_mesh(runs):
    want = runs["jax"]["main"]["forward"]
    for res in runs["ranks"]:
        d = res["main"]["coords"][0]
        np.testing.assert_allclose(res["main"]["forward"].numpy(), want[8 * d:8 * (d + 1)],
                                   rtol=2e-5, atol=2e-6)


def test_seq_train_step_matches_jax(runs):
    """The first step's gradients and the three losses, the same on every
    rank, against JAX's seq-sharded step."""
    want = runs["jax"]["main"]
    for res in runs["ranks"]:
        got = res["main"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-5)
        _close_grads(got["grads"], want["grads"], msg=f"rank {got['coords']}")
        assert got["losses"] == runs["ranks"][0]["main"]["losses"]
        for name, g in got["grads"].items():
            assert torch.equal(g, runs["ranks"][0]["main"]["grads"][name]), name


def test_seq_eval_sums_count_each_row_once(runs):
    """The full-sort metric sums over ``data`` equal JAX's, which no seq
    rank counts twice: the weight sum is the batch's 14 real rows."""
    want = runs["jax"]["main"]["sums"]
    for res in runs["ranks"]:
        got = res["main"]["eval_sums"]
        assert set(got) == set(want) == {"hit@5", "ndcg@5"}
        for k, (sv, wv) in want.items():
            np.testing.assert_allclose(got[k], (sv, wv), rtol=1e-6, err_msg=k)
        assert got["hit@5"][1] == 14.0


def test_the_halo_spans_shards(runs):
    """T/S = 2 < d_conv - 1 = 3: the conv reads positions of up to two
    earlier ranks; lengths 0 (position 7, the last rank), 1, 2 (the first
    chunk's last position), 3 (the second's first) and 8."""
    want = runs["jax"]["halo"]
    for res in runs["ranks"]:
        got = res["halo"]
        np.testing.assert_allclose(got["forward"].numpy(), want["forward"], rtol=2e-5, atol=2e-6)
        _close_grads(got["grads"], want["grads"], msg=f"halo rank {got['coords']}")


def _unmeshed_steps(cfg, n_items, t, params, batch, steps):
    config = Config(model="RecBLR", config_dict=dict(cfg, use_pallas_scan="never",
                                                     train_batch_size=len(batch["item_seq"])))
    model = get_model("RecBLR")(config, n_items, t, device="cpu")
    trainer = Trainer(config, model, params=params)
    local = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses, grads = [], None
    for s in range(steps):
        losses.append(float(trainer.train_step(local, s)))
        if s == 0:
            grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    return losses, grads, model


def test_seq_dropout_draws_the_unmeshed_masks(runs):
    """{seq: 4} at p 0.2 trains as the unmeshed model: two steps' losses
    and the first step's gradients."""
    losses, grads, _ = _unmeshed_steps(DROP_CFG, HALO_ITEMS, HALO_T, runs["halo_params"],
                                       runs["batches"]["drop"], 2)
    for res in runs["ranks"]:
        np.testing.assert_allclose(res["drop"]["losses"], losses, rtol=1e-6)
        _close_grads(res["drop"]["grads"], grads, msg="dropout")
    _, no_drop, _ = _unmeshed_steps(HALO_CFG, HALO_ITEMS, HALO_T, runs["halo_params"],
                                    runs["batches"]["drop"], 1)
    assert not torch.allclose(no_drop["layers.0.grl.w_in"], grads["layers.0.grl.w_in"])


def test_data_seq_masks_are_the_data_ranks(runs):
    """Each {data: 2, seq: 2} rank's training forward (step 3, twice)
    equals the {data: 2} rank's: the data index offsets the seeds, the
    seq index does not."""
    batch = runs["batches"]["drop"]
    config = Config(model="RecBLR", config_dict=dict(DROP_CFG, use_pallas_scan="never"))
    model = get_model("RecBLR")(config, HALO_ITEMS, HALO_T, device="cpu")
    model.train()
    for res in runs["ranks"]:
        d = res["masks"]["coords"][0]
        model.seed_offset = d * 1000003  # parallel.sharding.shard_model's
        rows = slice(4 * d, 4 * (d + 1))
        with torch.no_grad():
            want = model(torch.from_numpy(batch["item_seq"][rows]),
                         torch.from_numpy(batch["item_seq_len"][rows]), step=3)
        for out in res["masks"]["out"]:
            np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
    a, b = (runs["ranks"][r]["masks"]["out"][0] for r in (0, 2))
    assert not torch.allclose(a, b)


def test_dropout_masks_at_a_chunk_are_the_sequence_masks():
    """``L.dropout`` with ``t0`` draws the whole sequence's mask at the
    chunk's positions, bit for bit."""
    x = torch.ones((3, 12, 10))
    whole = L.dropout(x, 0.3, 77, philox.M2)
    for t0 in (0, 3, 6, 9):
        assert torch.equal(L.dropout(x[:, t0:t0 + 3], 0.3, 77, philox.M2, t0),
                           whole[:, t0:t0 + 3])


@pytest.fixture(scope="module")
def unmeshed_fit(tmp_path_factory):
    """The unmeshed fit in the per-op composition the seq axis runs
    (``use_pallas_scan: never``): there an empty request reads position
    T-1, as JAX's, where the fused kernels read position 0."""
    tmp = tmp_path_factory.mktemp("fit1")
    data = build_from_dataframe(generate_synthetic_interactions(**FIT_DATA), max_seq_len=FIT_T)
    cfg = Config(model="RecBLR", config_dict=dict(FIT_CFG, checkpoint_dir=str(tmp),
                                                  use_pallas_scan="never"))
    model = get_model("RecBLR")(cfg, data.n_items, FIT_T, device="cpu")
    scfg = Config(model="RecBLR", config_dict=dict(FIT_CFG, eval_args={"mode": "uni20"}))
    sampled = Evaluator(model, scfg).evaluate(data.test)
    trainer = Trainer(cfg, model)
    trainer.fit(data, checkpoint_path=str(tmp / "single"))
    runs = [{k: r[k] for k in ("train_loss", "valid_score")}
            for r in trainer.metrics.epoch_records()]
    return {"runs": runs, "test": trainer.evaluate(data.test, load_best=True),
            "sampled": sampled, "recommend": Recommender(model, top_k=5).recommend(USERS)}


def test_seq_fit_matches_the_unmeshed_fit(runs, unmeshed_fit):
    """Train loss and valid NDCG@10 each epoch, the best checkpoint's test
    metrics, uni20 from the initial parameters and the served ids."""
    for res in runs["ranks"]:
        got = res["fit"]
        assert len(got["runs"][0]) == FIT_CFG["epochs"]
        for mine, theirs in zip(got["runs"][0], unmeshed_fit["runs"]):
            for k in ("train_loss", "valid_score"):
                np.testing.assert_allclose(mine[k], theirs[k], rtol=2e-4, atol=5e-5, err_msg=k)
        for k, v in unmeshed_fit["test"].items():
            np.testing.assert_allclose(got["test"][k], v, rtol=2e-4, atol=5e-5, err_msg=k)
        for k, v in unmeshed_fit["sampled"].items():
            np.testing.assert_allclose(got["sampled"][k], v, rtol=1e-6, err_msg=k)
        ids = unmeshed_fit["recommend"][0]
        for key in ("recommend", "recommend_ckpt"):
            np.testing.assert_array_equal(got[key][0], ids)


def test_seq_run_resumes_from_its_checkpoint(runs):
    """Rank 0's checkpoint holds the unmeshed state; a trainer resumed from
    the best epoch's replays the uninterrupted run's next epoch."""
    for res in runs["ranks"]:
        got = res["fit"]
        resumed = got["resumed"]
        assert resumed and resumed[0]["epoch"] == got["best_epoch"] + 1
        assert resumed[-1]["epoch"] == 2


def _cfg(**over):
    return Config(model="RecBLR", config_dict={"hidden_size": 8, "MAX_ITEM_LIST_LENGTH": 8,
                                               "train_batch_size": 128, **over})


def test_what_the_seq_axis_does_not_take():
    """A T that does not divide seq raises; SASRec and BERT4Rec under seq,
    and seq beside model > 1, pass the checks and ask for their ranks, as
    RecBLR's {data: 1, seq: 2} does."""
    cfg = _cfg(mesh_shape={"data": 1, "seq": 3})
    with pytest.raises(ValueError, match="MAX_ITEM_LIST_LENGTH 8 must divide"):
        Trainer(cfg, get_model("RecBLR")(cfg, 20, 8, device="cpu"))
    for name in ("SASRec", "BERT4Rec"):
        cfg = Config(model=name, config_dict={"hidden_size": 8, "MAX_ITEM_LIST_LENGTH": 8,
                                              "train_batch_size": 128,
                                              "mesh_shape": {"data": 2, "seq": 2}})
        with pytest.raises(ValueError, match="needs 4 devices"):
            Trainer(cfg, get_model(name)(cfg, 20, 8, device="cpu"))
    cfg = _cfg(mesh_shape={"model": 2, "seq": 2})
    with pytest.raises(ValueError, match="needs 4 devices"):
        Trainer(cfg, get_model("RecBLR")(cfg, 20, 8, device="cpu"))
    cfg = _cfg(mesh_shape={"data": 1, "seq": 2})
    with pytest.raises(ValueError, match="needs 2 devices"):
        Trainer(cfg, get_model("RecBLR")(cfg, 20, 8, device="cpu"))


@pytest.mark.parametrize("num_layers", [1, 2])
def test_compositions_draw_the_same_masks(num_layers):
    """At p 0.2 the per-op composition a seq axis runs and the fused one
    (their plain versions here) draw the same masks: the same loss and
    gradients in fp32 (the input dropout takes layer 0's seed where the
    fused layer 0 takes the prologue)."""
    batch = {k: torch.from_numpy(v) for k, v in _batch(HALO_ITEMS, 16, np.arange(16) + 1,
                                                       43).items()}
    got = {}
    for scan in ("auto", "never"):
        cfg = Config(model="RecBLR", config_dict=dict(DROP_CFG, MAX_ITEM_LIST_LENGTH=16,
                                                      num_layers=num_layers,
                                                      use_pallas_scan=scan))
        model = get_model("RecBLR")(cfg, HALO_ITEMS, 16, device="cpu")
        assert model.use_fused_layer() == (scan == "auto")
        model.train()
        loss = model.calculate_loss(batch, step=5)
        loss.backward()
        got[scan] = (float(loss.detach()), {k: p.grad for k, p in model.named_parameters()})
    np.testing.assert_allclose(got["never"][0], got["auto"][0], rtol=1e-6)
    _close_grads(got["never"][1], got["auto"][1], msg="per-op vs fused")
