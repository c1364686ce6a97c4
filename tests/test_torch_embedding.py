"""The port's embedding lookup and its table gradient
(``ops/embedding.py``) against the JAX package's: ``embedding_grad_plain``
against the Pallas kernel ``_bwd_pallas`` (interpret mode) and against
``embedding_lookup``'s VJP on both sides of its 9,000-row switch from
one-hot matmuls to a scatter, and the bf16 model ``embed``'s table
gradient against the JAX model's, summed in fp32.

Tolerance: 1e-6 of the largest value (fp32 sums of bf16-representable
cotangents in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datamining_recblr_tpu.config import Config as JConfig
from datamining_recblr_tpu.models import get_model as j_get_model
from datamining_recblr_tpu.ops import embedding as JE
from datamining_recblr_torch.config import Config
from datamining_recblr_torch.interop import params_from_jax
from datamining_recblr_torch.models import get_model
from datamining_recblr_torch.ops import embedding as E

REL = 1e-6


def _ids_and_g(seed, v, d, n, pad_share=0.5):
    """Ids with id 0 at about ``pad_share`` of the slots (PAD in a training
    batch) and bf16-representable cotangents."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, v, n).astype(np.int32)
    ids[rng.random(n) < pad_share] = 0
    g = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    return ids, g.to(torch.bfloat16).float().numpy()


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=REL * float(np.abs(want).max()))


@pytest.mark.parametrize("v,d,n", [(300, 64, 1000), (131, 8, 77), (4500, 16, 513)])
def test_grad_plain_matches_pallas_bwd(v, d, n):
    ids, g = _ids_and_g(v + n, v, d, n)
    want = JE._bwd_pallas(jnp.asarray(ids), jnp.asarray(g), v, d)
    got = E.embedding_grad_plain(torch.from_numpy(ids), torch.from_numpy(g), v)
    assert got.dtype == torch.float32 and got.shape == (v, d)
    _close(got, want)


@pytest.mark.parametrize("v,n", [(300, 2000), (9216, 2000)], ids=["one_hot", "scatter"])
def test_lookup_and_its_vjp_match_jax(v, n):
    """Forward: the bf16 rows; backward: the fp32 sum cast to the table's
    dtype, below and above the JAX package's 9,000-row switch."""
    d = 16
    ids, g = _ids_and_g(v, v, d, n)
    ids = ids.reshape(40, -1)
    g = g.reshape(40, -1, d)
    table = np.random.default_rng(1).standard_normal((v, d)).astype(np.float32)
    out, vjp = jax.vjp(lambda t: JE.embedding_lookup(t, jnp.asarray(ids)), jnp.asarray(table))
    (want,) = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    tt = torch.from_numpy(table).requires_grad_()
    got = E.embedding_lookup(tt, torch.from_numpy(ids).long())
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().detach().numpy(),
                                  np.asarray(out.astype(jnp.float32)))
    got.backward(torch.from_numpy(g).to(torch.bfloat16))
    assert tt.grad.dtype == torch.float32
    _close(tt.grad, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32_g", "bf16_g"])
def test_grad_plain_beyond_512_columns_matches_jax_vjp(dtype):
    """At D 520, above the 512 columns the kernel sums at a time (it walks
    D in slices there): ``embedding_grad_plain`` of fp32 or bf16 cotangent
    rows against the JAX ``embedding_lookup`` VJP, which has no bound on
    D, given the same bf16-representable values."""
    v, d = 300, 520
    ids, g = _ids_and_g(11, v, d, 1200)
    table = jnp.zeros((v, d), jnp.float32)
    _, vjp = jax.vjp(lambda t: JE.embedding_lookup(t, jnp.asarray(ids)), table)
    (want,) = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    got = E.embedding_grad_plain(torch.from_numpy(ids), torch.from_numpy(g).to(dtype), v)
    assert got.dtype == torch.float32 and got.shape == (v, d)
    _close(got, want)


def test_bf16_embed_sums_the_table_gradient_in_fp32():
    """The model's bf16 ``embed``, given the cotangent the JAX model's
    ``embed(...).astype(bf16)`` gets, returns the fp32 table gradient
    within 1e-6 of its largest value: the sum is not rounded to bf16 on
    the way (PAD takes half of the ids, so a bf16 sum of its rows would
    be off by about 1e-2)."""
    cfg = {"hidden_size": 16, "num_layers": 1, "MAX_ITEM_LIST_LENGTH": 64,
           "compute_dtype": "bfloat16"}
    n_items = 200
    jmodel = j_get_model("RecBLR")(JConfig(model="RecBLR", config_dict=cfg), n_items, 64)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    model = get_model("RecBLR")(Config(model="RecBLR", config_dict=cfg), n_items, 64,
                                device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))
    ids, g = _ids_and_g(5, n_items, 16, 64 * 64)
    ids, g = ids.reshape(64, 64), g.reshape(64, 64, 16)
    _, vjp = jax.vjp(lambda p: jmodel.embed(p, jnp.asarray(ids)).astype(jnp.bfloat16), jparams)
    (want,) = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    out = model.embed(torch.from_numpy(ids).long())
    assert out.dtype == torch.bfloat16
    out.backward(torch.from_numpy(g).to(torch.bfloat16))
    _close(model.item_embedding.grad, want["item_embedding"])


def test_cpu_calls_do_not_count_launches_and_other_devices_raise():
    ids, g = _ids_and_g(7, 50, 8, 100)
    before = E.embedding_grad.launches
    E.embedding_grad(torch.from_numpy(ids), torch.from_numpy(g), 50)
    assert E.embedding_grad.launches == before == 0
    with pytest.raises(ValueError, match="no kernel"):
        E.embedding_grad(torch.zeros(4, dtype=torch.long, device="meta"),
                         torch.zeros((4, 8), device="meta"), 50)
