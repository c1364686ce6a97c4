"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA card and skips without one; this
file imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: fp32 atol 1e-4 / rtol 1e-4 (fp32 FMA matmuls summed in
another order than cuBLAS); bf16 atol 1e-4 / rtol 2^-7, one bf16 ulp of
the output, since both sides compute in fp32 and round once."""

import numpy as np
import pytest
import torch

from datamining_recblr_torch.config import Config
from datamining_recblr_torch.models import get_model
from datamining_recblr_torch.ops import fused_layer as FL
from datamining_recblr_torch.serve import Recommender

pytestmark = pytest.mark.cuda

K = 4
TOL = {
    "float32": dict(atol=1e-4, rtol=1e-4),
    "bfloat16": dict(atol=1e-4, rtol=2.0 ** -7),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _params(rng, d, c, dev, use_ffn=True, prologue=False):
    def r(*s):
        return torch.from_numpy((0.1 * rng.standard_normal(s)).astype(np.float32)).to(dev)

    p = {
        "w_in": r(d, 2 * c), "wc": r(K, c), "bc": r(c), "wg": r(c, 2 * c), "bg": r(2 * c),
        "lam": torch.linspace(-6.9, 12.0, c, device=dev),
        "w_out": r(c, d), "ln1_s": 1.0 + r(d), "ln1_b": r(d),
    }
    if use_ffn:
        p.update(w1=r(d, 4 * d), b1=r(4 * d), w2=r(4 * d, d), b2=r(d),
                 ln2_s=1.0 + r(d), ln2_b=r(d))
    if prologue:
        p.update(pl_s=1.0 + r(d), pl_b=r(d))
    return p


# (D, C, use_conv, use_ffn, prologue): the serving widths with every
# stage on, then narrower widths that are no multiple of 32 with stages off
FLAGS = [(64, 128, True, True, True), (64, 128, True, True, False),
         (48, 96, False, True, False), (48, 96, True, False, True)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,c,use_conv,use_ffn,prologue", FLAGS)
def test_layer_kernel_matches_plain(dev, dtype, d, c, use_conv, use_ffn, prologue):
    rng = np.random.default_rng(1)
    p = _params(rng, d, c, dev, use_ffn, prologue)
    x = torch.from_numpy(rng.standard_normal((5, 45, d)).astype(np.float32))
    x = x.to(dev, getattr(torch, dtype))
    before = FL.fused_recurrent_layer.launches
    got = FL.fused_recurrent_layer(x, p, use_conv, use_ffn, prologue)
    assert FL.fused_recurrent_layer.launches == before + 1
    want = FL.fused_recurrent_layer_plain(x, p, use_conv, use_ffn, prologue)
    assert got.dtype == x.dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,c,use_conv,use_ffn", [f[:4] for f in FLAGS[1:]])
def test_layer_last_kernel_matches_plain(dev, dtype, d, c, use_conv, use_ffn):
    rng = np.random.default_rng(2)
    p = _params(rng, d, c, dev, use_ffn)
    t = 45
    x = torch.from_numpy(rng.standard_normal((6, t, d)).astype(np.float32))
    x = x.to(dev, getattr(torch, dtype))
    lens = torch.tensor([0, 1, t, 17, 32, t + 3], device=dev)  # t + 3 selects nothing
    before = FL.fused_recurrent_layer_last.launches
    got = FL.fused_recurrent_layer_last(x, lens, p, use_conv, use_ffn)
    assert FL.fused_recurrent_layer_last.launches == before + 1
    want = FL.fused_recurrent_layer_last_plain(x, lens, p, use_conv, use_ffn)
    assert got.dtype == x.dtype and got.shape == (6, d)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_kernels_reject_what_they_do_not_take(dev):
    rng = np.random.default_rng(3)
    p = _params(rng, 64, 128, dev)
    x = torch.zeros((2, 16, 64), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        FL.fused_recurrent_layer(x.transpose(0, 1), p)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        FL.fused_recurrent_layer(x.half(), p)
    with pytest.raises(ValueError, match="param w_in"):
        FL.fused_recurrent_layer(x, dict(p, w_in=p["w_in"].cpu()))
    with pytest.raises(ValueError, match="unsupported shape"):
        FL.fused_recurrent_layer(x[:, :2].contiguous(), p)  # fewer steps than taps
    with pytest.raises(ValueError, match="lens"):
        FL.fused_recurrent_layer_last(x, torch.tensor([1, 2]), p)  # lens on the CPU


def test_serving_on_card_matches_cpu(dev):
    cfg = Config(model="RecBLR", config_dict={"hidden_size": 64, "num_layers": 2,
                                               "MAX_ITEM_LIST_LENGTH": 40})
    cpu = get_model("RecBLR")(cfg, 300, 40, device="cpu")
    card = get_model("RecBLR")(cfg, 300, 40, device=dev)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(4)
    seqs = [[], [7], list(rng.integers(1, 300, 55)), list(rng.integers(1, 300, 12))]
    before = (FL.fused_recurrent_layer.launches, FL.fused_recurrent_layer_last.launches)
    ids, vals = Recommender(card, top_k=10).recommend(seqs)
    after = (FL.fused_recurrent_layer.launches, FL.fused_recurrent_layer_last.launches)
    assert (after[0] - before[0], after[1] - before[1]) == (1, 1)
    want_ids, want_vals = Recommender(cpu, top_k=10).recommend(seqs)
    np.testing.assert_allclose(vals, want_vals, atol=1e-4, rtol=1e-4)
    # ids may differ only where the CPU's scores tie within tolerance
    for i, j in zip(*np.nonzero(ids != want_ids)):
        row = dict(zip(want_ids[i].tolist(), want_vals[i].tolist()))
        assert abs(row.get(int(ids[i, j]), want_vals[i, -1]) - want_vals[i, j]) <= 1e-4
