"""The RecBLR layer forward's products as the tensor-core kernels take them
(``csrc/layer_fwd.cuh``: phase A and the tail), emulated in numpy on the
CPU: both operands split into TF32 terms (hi = tf32(v), lo = tf32(v -
hi)), per 8-deep k-tile (a ragged depth padded with zeros) a fresh
accumulator of lo hi + hi lo + hi hi (exact products, summed and rounded
to fp32 once), added to the running sum in fp32 in depth order.

Each product is held within 1e-6 of its largest value from the fp64 sum,
as an fp32 sum is, where one TF32 product is not; the whole layer built
on those products (the port's plain steps between them) against the JAX
package's ``fused_recurrent_layer`` (its Pallas kernel, ``_layer_fwd_core``
inside, in interpret mode, fp32) at atol 2e-5 / rtol 1e-4, the forward
tests' tolerance (scan and summation order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from datamining_recblr_tpu.ops.fused_layer import fused_recurrent_layer as j_layer
from datamining_recblr_torch.ops import fastmath
from datamining_recblr_torch.ops import fused_layer as FL
from datamining_recblr_torch.ops.conv import causal_depthwise_conv
from datamining_recblr_torch.ops.fused_bdlru import EPS, softplus
from datamining_recblr_torch.ops.scan import linear_scan_serial

from test_torch_fused_layer_bwd import SEED, _params, _tf32

ATOL, RTOL = 2e-5, 1e-4
# (B, T, D, C): the bench widths, and widths no multiple of 8 or 16
SHAPES = [(2, 45, 64, 128), (2, 33, 50, 70)]
PRODUCTS = ("xb", "gates", "z", "w_out", "w1", "w2")


def _mm_scheme(a, w):
    """a [M, K] w [K, N] as the kernels' mm_planes / frag_mma take it."""
    a = np.asarray(a, np.float32)
    w = np.asarray(w, np.float32)
    pad = -a.shape[1] % 8
    a = np.pad(a, ((0, 0), (0, pad)))
    w = np.pad(w, ((0, pad), (0, 0)))
    ah, wh = _tf32(a), _tf32(w)
    al, wl = _tf32(a - ah), _tf32(w - wh)
    acc = np.zeros((a.shape[0], w.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 8):
        sl = slice(k0, k0 + 8)
        tile = sum(u[:, sl].astype(np.float64) @ v[sl].astype(np.float64)
                   for u, v in ((al, wh), (ah, wl), (ah, wh)))
        acc = (acc + tile.astype(np.float32)).astype(np.float32)
    return acc


def _layer_scheme(x, p):
    """The layer (conv and FFN on, no prologue, p = 0) with every product
    through ``_mm_scheme``; returns its output and {product: (A, W)}."""
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    operands = {}

    def mm(name, a, w):
        a2 = a.reshape(-1, a.shape[-1]).numpy()
        operands[name] = (a2, w.numpy())
        return torch.from_numpy(_mm_scheme(a2, w.numpy())).reshape(*a.shape[:-1], w.shape[1])

    xt = torch.from_numpy(x)
    c = p["w_in"].shape[1] // 2
    xb = mm("xb", xt, pt["w_in"][:, :c].contiguous())
    z = mm("z", xt, pt["w_in"][:, c:].contiguous())
    xc = fastmath.silu(causal_depthwise_conv(xb, pt["wc"], pt["bc"]))
    g = mm("gates", xc, pt["wg"]) + pt["bg"]
    sr, si = fastmath.sigmoid(g[..., :c]), fastmath.sigmoid(g[..., c:])
    alpha = fastmath.exp(-softplus(pt["lam"]) * sr)
    beta = torch.sqrt(1.0 - alpha * alpha + EPS) * si
    h = linear_scan_serial(alpha, beta * xc)
    y = mm("w_out", fastmath.silu(z) * h, pt["w_out"])
    r1 = FL._ln(y + xt, pt["ln1_s"], pt["ln1_b"])
    a1 = fastmath.silu(mm("w1", r1, pt["w1"]) + pt["b1"])
    f2 = mm("w2", a1, pt["w2"]) + pt["b2"]
    return FL._ln(f2 + r1, pt["ln2_s"], pt["ln2_b"]).numpy(), operands


@pytest.mark.parametrize("product", PRODUCTS)
@pytest.mark.parametrize("b,t,d,c", SHAPES)
def test_forward_products_keep_fp32(b, t, d, c, product):
    rng = np.random.default_rng(60 + t + d)
    p = _params(rng, d, c)
    x = (2.0 * rng.standard_normal((b, t, d))).astype(np.float32)
    _, operands = _layer_scheme(x, p)
    a, w = operands[product]
    exact = a.astype(np.float64) @ w.astype(np.float64)
    scale = float(np.abs(exact).max())
    assert float(np.abs(_mm_scheme(a, w) - exact).max()) <= 1e-6 * scale
    one = _tf32(a).astype(np.float64) @ _tf32(w).astype(np.float64)
    assert float(np.abs(one - exact).max()) > 1e-6 * scale


@pytest.mark.parametrize("b,t,d,c", SHAPES)
def test_forward_on_the_scheme_matches_jax(b, t, d, c):
    rng = np.random.default_rng(70 + t + d)
    p = _params(rng, d, c)
    x = (2.0 * rng.standard_normal((b, t, d))).astype(np.float32)
    got, _ = _layer_scheme(x, p)
    want = j_layer(jnp.asarray(x), SEED, {k: jnp.asarray(v) for k, v in p.items()}, True, True,
                   0.0, False)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL)
    plain = FL.fused_recurrent_layer_plain(torch.from_numpy(x),
                                           {k: torch.from_numpy(v) for k, v in p.items()})
    np.testing.assert_allclose(got, plain.numpy(), atol=ATOL, rtol=RTOL)
