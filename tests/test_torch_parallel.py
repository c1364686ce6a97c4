"""The port's mesh layer against the JAX package's ``parallel/`` on the
CPU: the row-shard policy and the parameter layout over a grid of vocab
sizes, widths, mesh shapes and modes; each data index's rows; the
errors; and, on four gloo ranks ({data: 2, model: 2},
``tests/torch_mesh_worker.py``), the vocab-parallel lookup and CE of a
tied table against the plain ``ce_loss`` on the whole table, and
``target_ranks`` / ``sharded_topk`` on sharded scores against the
unsharded results and JAX's ``sharded_topk`` on its 8-device mesh.

Tolerances: the CE loss rtol 1e-5 and its gradients rtol 1e-4 / atol
1e-5 of the largest (summation order); ranks and top-k ids exactly,
values bit for bit."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from datamining_recblr_tpu.config import Config as JConfig
from datamining_recblr_tpu.models import get_model as j_get_model
from datamining_recblr_tpu.ops.topk import sharded_topk as j_sharded_topk
from datamining_recblr_tpu.parallel import input as j_input
from datamining_recblr_tpu.parallel import make_mesh as j_make_mesh
from datamining_recblr_tpu.parallel import sharding as j_sharding
from datamining_recblr_torch.config import Config
from datamining_recblr_torch.eval.evaluator import Evaluator
from datamining_recblr_torch.eval.metrics import target_ranks
from datamining_recblr_torch.models import get_model
from datamining_recblr_torch.models.base import ce_loss
from datamining_recblr_torch.ops.topk import topk_scores
from datamining_recblr_torch.parallel import input as p_input
from datamining_recblr_torch.parallel import make_mesh
from datamining_recblr_torch.parallel import sharding as p_sharding
from datamining_recblr_torch.train.trainer import Trainer
from torch_mesh_worker import launch

SHAPES = [{"data": 4, "model": 2}, {"data": 8}, {"data": 2, "model": 4},
          {"data": 1, "model": 8}, {"data": 8, "model": 1}]
MIN = j_sharding.ROW_SHARD_MIN_ELEMS


def _meshes(shape):
    return j_make_mesh(shape), SimpleNamespace(shape=dict(shape))


@pytest.mark.parametrize("mode", ["auto", "always", "never"])
def test_row_shard_policy_matches_jax(mode):
    assert p_sharding.ROW_SHARD_MIN_ELEMS == MIN
    assert not p_sharding.want_row_shard(10**7, 64, None, mode)
    for shape in SHAPES:
        jmesh, pmesh = _meshes(shape)
        for v in (2, 41, 3417, MIN // 64 - 1, MIN // 64, MIN // 64 + 1, 329_728):
            for d in (16, 64, 100):
                assert (p_sharding.want_row_shard(v, d, pmesh, mode)
                        == j_sharding.want_row_shard(v, d, jmesh, mode)), (shape, v, d)
                assert (p_sharding.rows_sharded(v, pmesh, d, mode)
                        == j_sharding.rows_sharded(v, jmesh, d, mode)), (shape, v, d)


def _by_name(tree, leaf):
    """JAX tree -> {state-dict name: leaf(node)}."""
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            items = node.items()
        elif isinstance(node, list):
            items = ((str(i), v) for i, v in enumerate(node))
        else:
            out[prefix] = leaf(node)
            return
        for k, v in items:
            walk(v, f"{prefix}.{k}" if prefix else str(k))

    walk(tree, "")
    return out


@pytest.mark.parametrize("name", ["RecBLR", "BERT4Rec"])
@pytest.mark.parametrize("mode", ["auto", "always", "never"])
def test_param_layout_matches_jax(name, mode):
    """Which tensors row-shard, model by model, over the mesh shapes and
    vocabularies on both sides of the crossover (BERT4Rec's bias decides
    at the table's width)."""
    for shape in SHAPES:
        jmesh, pmesh = _meshes(shape)
        for n_items in (40, 41, MIN // 64 - 2, MIN // 64 + 7):
            cfg = {"hidden_size": 64, "MAX_ITEM_LIST_LENGTH": 10, "mesh_shape": shape,
                   "vocab_row_shard": mode}
            jmodel = j_get_model(name)(JConfig(model=name, config_dict=cfg), n_items, 10)
            tmpl = jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0))
            want = _by_name(j_sharding.param_pspecs(tmpl, jmesh, mode), tuple)
            state = _by_name(tmpl, lambda a: torch.empty(a.shape, device="meta"))
            assert p_sharding.param_pspecs(state, pmesh, mode) == want, (shape, n_items)


def test_default_mesh_shape_matches_jax():
    from datamining_recblr_tpu.parallel.mesh import default_mesh_shape as j_default
    from datamining_recblr_torch.parallel.mesh import default_mesh_shape

    for n in range(1, 17):
        assert default_mesh_shape(n) == j_default(n)


@pytest.mark.parametrize("rows", [8, 13, 2048])
def test_process_local_rows_matches_jax(rows, monkeypatch):
    for n in (1, 2, 3, 4):
        pieces = []
        for idx in range(n):
            monkeypatch.setattr(j_input.jax, "process_count", lambda n=n: n)
            monkeypatch.setattr(j_input.jax, "process_index", lambda idx=idx: idx)
            mesh = SimpleNamespace(size=lambda a, n=n: n if a == "data" else 1,
                                   index=lambda a, idx=idx: idx if a == "data" else 0)
            got = p_input.process_local_rows(rows, mesh)
            assert got == j_input.process_local_rows(rows, None)
            pieces.append(got)
        assert pieces[0][0] == 0 and pieces[-1][1] == rows
        assert all(a[1] == b[0] for a, b in zip(pieces, pieces[1:]))


def _cfg(**over):
    return Config(model="RecBLR", config_dict={"hidden_size": 8, "MAX_ITEM_LIST_LENGTH": 8,
                                               "train_batch_size": 128, **over})


def test_mesh_errors():
    """A seq axis, RecBLR's or SASRec's, asks for its ranks; sizes that do
    not divide the data axis and a mesh without its ranks raise."""
    cfg = _cfg(mesh_shape={"data": 1, "seq": 2})
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        Trainer(cfg, get_model("RecBLR")(cfg, 20, 8, device="cpu"))
    cfg = Config(model="SASRec", config_dict={"hidden_size": 8, "MAX_ITEM_LIST_LENGTH": 8,
                                              "mesh_shape": {"data": 1, "seq": 2}})
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        Trainer(cfg, get_model("SASRec")(cfg, 20, 8, device="cpu"))
    cfg = _cfg(mesh_shape={"data": 3})
    with pytest.raises(ValueError, match="train_batch_size 128 must divide"):
        Trainer(cfg, get_model("RecBLR")(cfg, 20, 8, device="cpu"))
    cfg = _cfg(mesh_shape={"data": 2}, eval_batch_size=255)
    mesh = SimpleNamespace(size=lambda a: 2 if a == "data" else 1)
    with pytest.raises(ValueError, match="eval_batch_size 255 must divide"):
        Evaluator(get_model("RecBLR")(cfg, 20, 8, device="cpu"), cfg, mesh=mesh)
    with pytest.raises(ValueError, match="needs 4 devices, have 1"):
        make_mesh({"data": 2, "model": 2}, "cpu")
    cfg = _cfg(mesh_shape={"data": 2, "model": 2})
    with pytest.raises(ValueError, match="needs 4 devices"):
        Trainer(cfg, get_model("RecBLR")(cfg, 20, 8, device="cpu"))


def test_a_meshed_model_starts_from_the_unmeshed_parameters():
    """The model axis pads BERT4Rec's table (42 -> 44 rows) and bias (41 ->
    44) with zero rows after the rows an unmeshed model draws; every other
    parameter is the same."""
    plain = get_model("BERT4Rec")(Config(model="BERT4Rec", config_dict={
        "hidden_size": 16, "MAX_ITEM_LIST_LENGTH": 8}), 41, 8, device="cpu")
    meshed = get_model("BERT4Rec")(Config(model="BERT4Rec", config_dict={
        "hidden_size": 16, "MAX_ITEM_LIST_LENGTH": 8, "mesh_shape": {"data": 1, "model": 4}}),
        41, 8, device="cpu")
    a, b = plain.state_dict(), meshed.state_dict()
    assert a["item_embedding"].shape == (42, 16) and b["item_embedding"].shape == (44, 16)
    assert torch.equal(b["item_embedding"][:42], a["item_embedding"])
    assert not b["item_embedding"][42:].any()
    assert b["output_bias"].shape == (44,) and a["output_bias"].shape == (41,)
    for k in a:
        if k not in ("item_embedding", "output_bias"):
            assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# four gloo ranks: the vocab-parallel lookup and CE, ranks and top-k
# ---------------------------------------------------------------------------

V, D, N_ITEMS = 12, 6, 10  # two padded rows; shards [0, 6) and [6, 12)
MESH = {"data": 2, "model": 2}


def _scores():
    """[8, 16] scores with ties inside and across the shard boundary at
    column 8, -0.0 against +0.0, and a run of -inf."""
    rng = np.random.default_rng(3)
    s = rng.integers(-3, 4, (8, 16)).astype(np.float32) / 2
    s[0, 6:10] = 1.5  # a tie across the boundary
    s[1] = 0.0
    s[1, 3] = s[1, 9] = -0.0
    s[2, :] = -np.inf
    s[2, [1, 12]] = 7.0
    s[3, 7], s[3, 8] = 2.0, 2.0
    return s


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    rng = np.random.default_rng(11)
    table = rng.standard_normal((V, D)).astype(np.float32)
    table[N_ITEMS:] = 0.0
    ids = rng.integers(1, N_ITEMS, (8, 3))
    targets = rng.integers(1, N_ITEMS, 8)
    targets[0], targets[5] = 5, 6  # the last row of shard 0, the first of shard 1
    weight = np.array([1, 1, 1, 1, 1, 0, 0, 1], np.float32)
    scores = _scores()
    rank_tgt = np.array([7, 3, 12, 8, 0, 15, 6, 9])
    job = {"cases": [
        ("vocab", "vocab", dict(table=table, ids=ids, targets=targets, weight=weight,
                                n_items=N_ITEMS, mesh_shape=MESH)),
        ("even", "ranks_topk", dict(scores=scores, targets=rank_tgt, k=5, widths=[8, 8],
                                    mesh_shape=MESH)),
        ("uneven", "ranks_topk", dict(scores=scores, targets=rank_tgt, k=6, widths=[11, 5],
                                      mesh_shape=MESH)),
    ]}
    out = launch(job, 4, tmp_path_factory.mktemp("four_ranks"))
    return dict(table=table, ids=ids, targets=targets, weight=weight, scores=scores,
                rank_tgt=rank_tgt, out=out)


def test_vocab_parallel_lookup_and_ce_match_the_whole_table(four_ranks):
    r = four_ranks
    table = torch.from_numpy(r["table"]).requires_grad_()
    rows = F.embedding(torch.from_numpy(r["ids"]), table)
    rows.retain_grad()
    logits = rows.mean(1) @ table.T
    logits = torch.where(torch.arange(V)[None] < N_ITEMS, logits, torch.full((), -1e30))
    loss = ce_loss(logits, torch.from_numpy(r["targets"]), torch.from_numpy(r["weight"]))
    loss.backward()
    g = table.grad.numpy()
    for rank, res in enumerate(r["out"]):
        got = res["vocab"]
        np.testing.assert_allclose(got["loss"], float(loss.detach()), rtol=1e-5)
        np.testing.assert_allclose(got["table_grad"].numpy(), g, rtol=1e-4,
                                   atol=1e-5 * np.abs(g).max(), err_msg=f"rank {rank}")
        lo = 4 * (rank // 2)  # the rank's data rows
        assert torch.equal(got["rows"], rows.detach()[lo:lo + 4])
        np.testing.assert_allclose(got["rows_grad"].numpy(), rows.grad[lo:lo + 4].numpy(),
                                   rtol=1e-4, atol=1e-7)
    assert np.abs(g[N_ITEMS:]).max() == 0.0  # padded rows get no gradient


@pytest.mark.parametrize("case", ["even", "uneven"])
def test_sharded_ranks_and_topk_equal_the_unsharded(four_ranks, case):
    r = four_ranks
    scores = torch.from_numpy(r["scores"])
    k = 5 if case == "even" else 6
    want_ranks = target_ranks(scores, torch.from_numpy(r["rank_tgt"]))
    want_vals, want_ids = topk_scores(scores, k)
    for res in r["out"]:
        got = res[case]
        lo, hi = got["rows"]
        assert torch.equal(got["ranks"], want_ranks[lo:hi])
        assert torch.equal(got["ids"], want_ids[lo:hi])
        assert torch.equal(got["vals"].view(torch.int32), want_vals[lo:hi].view(torch.int32))


def test_sharded_topk_matches_jax(four_ranks):
    """JAX's sharded_topk over the 8 virtual devices ({data: 4, model:
    2}) returns the ids the port's four ranks return."""
    r = four_ranks
    mesh = j_make_mesh({"data": 4, "model": 2})
    vals, ids = j_sharded_topk(jnp.asarray(r["scores"]), 5, mesh)
    for res in r["out"]:
        lo, hi = res["even"]["rows"]
        np.testing.assert_array_equal(res["even"]["ids"].numpy(), np.asarray(ids)[lo:hi])
        np.testing.assert_array_equal(res["even"]["vals"].numpy(), np.asarray(vals)[lo:hi])
