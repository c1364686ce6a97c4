"""The port's RecBLR against the JAX package's on the same parameters,
on the CPU.

Fused composition: JAX with ``use_pallas_scan="always"`` runs its Pallas
layer kernels in interpret mode; the port runs the plain versions of its
layer kernels.  Unfused composition: both with "never".  fp32,
tolerance atol 2e-5 / rtol 1e-4 (scan order and matmul summation
order)."""

import jax
import numpy as np
import pytest
import torch

from datamining_recblr_tpu.config import Config as JConfig
from datamining_recblr_tpu.models import get_model as j_get_model
from datamining_recblr_torch.config import Config
from datamining_recblr_torch.interop import params_from_jax
from datamining_recblr_torch.models import get_model

ATOL, RTOL = 2e-5, 1e-4
N_ITEMS, T = 50, 12


def _pair(overrides, impl, seed=0):
    cfg = {"hidden_size": 32, "num_layers": 2, "MAX_ITEM_LIST_LENGTH": T,
           "use_pallas_scan": impl, **overrides}
    jmodel = j_get_model("RecBLR")(JConfig(model="RecBLR", config_dict=cfg), N_ITEMS, T)
    jparams = jmodel.init_params(jax.random.PRNGKey(seed))
    model = get_model("RecBLR")(Config(model="RecBLR", config_dict=cfg), N_ITEMS, T,
                                device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))
    return jmodel, jparams, model


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    lens = np.array([0, 1, T, 5, 9], np.int32)
    seq = np.zeros((len(lens), T), np.int32)
    for i, n in enumerate(lens):
        seq[i, :n] = rng.integers(1, N_ITEMS, n)
    return seq, lens


VARIANTS = [
    {},
    {"num_layers": 1},
    {"num_layers": 3, "hidden_size": 16},
    {"bd_lru_only": True},
    {"disable_conv1d": True},
    {"disable_ffn": True},
]


@pytest.mark.parametrize("impl", ["always", "never"])
@pytest.mark.parametrize("overrides", VARIANTS, ids=lambda o: ",".join(o) or "default")
def test_forward_and_scores_match_jax(overrides, impl):
    jmodel, jparams, model = _pair(overrides, impl)
    assert model.use_fused_layer() == (impl == "always")
    seq, lens = _batch()
    want = jmodel.forward(jparams, seq, lens, deterministic=True)
    want_scores = jmodel.full_sort_scores(jparams, seq, lens)
    with torch.no_grad():
        tseq, tlens = torch.from_numpy(seq).long(), torch.from_numpy(lens)
        got = model(tseq, tlens)
        got_scores = model.full_sort_scores(tseq, tlens)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    assert got_scores.dtype == torch.float32
    assert got_scores.shape == (len(lens), jmodel.n_items_padded)
    np.testing.assert_allclose(got_scores.numpy(), np.asarray(want_scores),
                               atol=ATOL, rtol=RTOL)


def test_vocab_padding_rule_matches_jax():
    for n_items, cfg in [(3417, {}), (300_000, {"hidden_size": 64}),
                         (50, {"vocab_multiple": 8})]:
        jm = j_get_model("RecBLR")(JConfig(model="RecBLR", config_dict=cfg), n_items, T)
        m = get_model("RecBLR")(Config(model="RecBLR", config_dict=cfg), n_items, T,
                                device="cpu")
        assert m.n_items_padded == jm.n_items_padded
        assert m.item_embedding.shape == (jm.n_items_padded, m.hidden_size)


def test_padded_vocab_columns_are_masked():
    jmodel, jparams, model = _pair({"vocab_multiple": 16}, "always")
    assert model.n_items_padded == 64 > N_ITEMS
    seq, lens = _batch(1)
    with torch.no_grad():
        s = model.full_sort_scores(torch.from_numpy(seq).long(), torch.from_numpy(lens))
    assert torch.isneginf(s[:, N_ITEMS:]).all()
    np.testing.assert_allclose(
        s.numpy(), np.asarray(jmodel.full_sort_scores(jparams, seq, lens)),
        atol=ATOL, rtol=RTOL,
    )


def test_parameters_keep_the_jax_names_and_layouts():
    jmodel, jparams, model = _pair({}, "always")
    flat = params_from_jax(jax.tree.map(np.asarray, jparams))
    sd = model.state_dict()
    assert set(sd) == set(flat)
    for k, v in flat.items():
        assert sd[k].shape == v.shape, k
    assert sd["layers.0.grl.w_in"].shape == (32, 128)  # [in, out]


# ---------------------------------------------------------------------------
# long context: the sequence-chunked composition beyond T = 512
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [200, 512, 520, 1000, 1024, 1032, 997])
@pytest.mark.parametrize("d_conv", [4, 9])
def test_long_context_dispatch_matches_jax(t, d_conv):
    """The composition and the top layer's kernel the port chooses are the
    JAX package's: ``_use_fused_layer``, ``_use_chunked_layer`` and its
    ``last_ok`` (T <= 1,024)."""
    cfg = {"hidden_size": 8, "num_layers": 2, "MAX_ITEM_LIST_LENGTH": t, "d_conv": d_conv,
           "use_pallas_scan": "always"}
    jm = j_get_model("RecBLR")(JConfig(model="RecBLR", config_dict=cfg), 60, t)
    m = get_model("RecBLR")(Config(model="RecBLR", config_dict=cfg), 60, t, device="cpu")
    assert m.use_fused_layer() == jm._use_fused_layer()
    assert m.use_chunked_layer() == (not jm._use_fused_layer() and jm._use_chunked_layer())
    assert m.use_last_layer_kernel() == (t <= 1024)


def _long_batch(rng, b, t, n_items):
    lens = rng.integers(1, t + 1, b).astype(np.int32)
    lens[:3] = [1, t, t // 2]
    seq = rng.integers(1, n_items, (b, t)).astype(np.int32)
    seq = np.where(np.arange(t)[None] < lens[:, None], seq, 0).astype(np.int32)
    return seq, lens, rng.integers(1, n_items, b).astype(np.int32)


def test_long_context_loss_and_gradients_match_jax():
    """RecBLR at T 520 (chunks of 104, 5 of them), D 8, 2 layers, V 600,
    dropout 0: the port's chunked composition (plain versions on the CPU)
    against the JAX package's ``use_pallas_scan: always`` (its chunked and
    last-position Pallas kernels in interpret mode): the CE loss and every
    parameter gradient, fp32 (atol 2e-5 / rtol 1e-4, and each gradient
    within 1e-4 of its largest value)."""
    t, n_items = 520, 600
    cfg = {"hidden_size": 8, "num_layers": 2, "MAX_ITEM_LIST_LENGTH": t, "dropout_prob": 0.0,
           "use_pallas_scan": "always"}
    jmodel = j_get_model("RecBLR")(JConfig(model="RecBLR", config_dict=cfg), n_items, t)
    jparams = jmodel.init_params(jax.random.PRNGKey(3))
    model = get_model("RecBLR")(Config(model="RecBLR", config_dict=cfg), n_items, t,
                                device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))
    assert model.use_chunked_layer() and not jmodel._use_fused_layer()
    assert jmodel._use_chunked_layer()
    seq, lens, pos = _long_batch(np.random.default_rng(4), 6, t, n_items)
    jbatch = {"item_seq": seq, "item_seq_len": lens, "pos_item": pos}
    want, wgrads = jax.value_and_grad(jmodel.calculate_loss)(jparams, jbatch,
                                                             jax.random.PRNGKey(5))
    model.train()
    loss = model.calculate_loss({k: torch.from_numpy(v).long() for k, v in jbatch.items()},
                                step=0)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), atol=ATOL, rtol=RTOL)
    flat = params_from_jax(jax.tree.map(np.asarray, wgrads))
    for name, p in model.named_parameters():
        w = np.asarray(flat[name])
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-4 * float(np.abs(w).max()) + 1e-9, err_msg=name)


def test_top_layer_beyond_1024_is_the_chunked_layer_and_a_gather():
    """At T 1,032 the top layer runs the chunked layer and a gather at
    each row's last position: the same output as the unfused composition
    (rows of length 1 .. T)."""
    t = 1032
    cfg = {"hidden_size": 8, "num_layers": 2, "MAX_ITEM_LIST_LENGTH": t}
    model = get_model("RecBLR")(Config(model="RecBLR", config_dict=cfg), 60, t, device="cpu")
    assert model.use_chunked_layer() and not model.use_last_layer_kernel()
    seq, lens, _ = _long_batch(np.random.default_rng(6), 4, t, 60)
    tseq, tlens = torch.from_numpy(seq).long(), torch.from_numpy(lens)
    with torch.no_grad():
        got = model(tseq, tlens)
        model.scan_impl = "xla"
        want = model(tseq, tlens)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=RTOL)
