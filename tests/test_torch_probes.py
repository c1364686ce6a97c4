"""The probes of queue B row 17 (``datamining_recblr_torch/probes/``) on
the CPU: each plain version against its JAX probe under ``benchmarks/``,
imported by path, on inputs from a numpy seed at small sizes.

* ``unit_overlap``: the five modes of ``_run`` (its ``pallas_call`` in
  interpret mode for the test) at grid 1-2, nm 4, nv 12;
* ``vpu_ops``: the fourteen ops of ``make_fn`` (interpret mode) at a
  small ``SHAPE`` and ``REPEAT``;
* ``scan_chunked``: ``run`` flat and chunk at B 16, and the full outputs
  against ``_scan_body``, ``_scan_chunked`` and the serial oracle;
* ``ce_mxu``: ``pallas_mm`` at N 512, V 384, and ``fused_ce_at_bn``'s
  sums against the port's row-13 plain version.

Tolerances, each with its reason:
* ``MM_TOL`` 2e-5: fp32 products summed in another order than XLA's over
  a chain of four (|y| ~ 0.1, orthogonal w), and ulps of tanh between XLA
  and PyTorch, which the contracting chain does not grow;
* ``OP_TOL`` 2e-6: 8 steps of an op and a multiply-add, x in [0, 1);
  XLA's exp, logistic and softplus against the port's forms (exp2(x log2
  e), 0.5 tanh(x / 2) + 0.5, max(x, 0) + log1p(exp(-|x|))), a few ulps a
  step, contracted by 0.9; ``SQUARE_RTOL`` 1e-4 for recip_mul, x (x +
  1.7), which squares its value each step (to inf, as on the TPU), so
  that an ulp's relative error doubles a step: 2^8 ulps after 8;
* ``SCAN_TOL`` 1e-4 relative to the largest |h| (about 30): the same
  200-step recurrence summed in Hillis-Steele, serial and two-level
  orders;
* ``MXU_TOL`` 1e-6: bf16 products are exact in fp32, sums of 64 in
  another order;
* ``CE_RTOL`` 1e-5: row 13's sums over 512 x 384 logits, its exp as
  exp2(x log2 e) against XLA's exp inside the JAX kernels.
The wrappers take the plain versions on a CPU tensor and load no CUDA
library there.
"""

import functools
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from datamining_recblr_torch.ops import _cuda
from datamining_recblr_torch.probes import ce_mxu, scan_chunked, unit_overlap, vpu_ops

ROOT = Path(__file__).resolve().parents[1]
MM_TOL = 2e-5
OP_TOL = 2e-6
SQUARE_RTOL = 1e-4
SCAN_TOL = 1e-4
MXU_TOL = 1e-6
CE_RTOL = 1e-5


def _jax_probe(name):
    """benchmarks/<name>.py, imported by path (the folder is no package)."""
    key = f"_jax_probe_{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, ROOT / "benchmarks" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


@pytest.fixture
def interpret(monkeypatch):
    """The JAX probes' pallas_call in interpret mode for one test."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# 17a unit_overlap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,grid", [("mm_only", 2), ("vpu_only", 1), ("serial", 1),
                                       ("indep_il", 2), ("indep_seq", 1)])
def test_unit_overlap_matches_jax(mode, grid, interpret):
    jp = _jax_probe("unit_overlap")
    args = unit_overlap.inputs(grid, "cpu")
    want = np.asarray(jp._run(*[jnp.asarray(a.numpy()) for a in args], mode, 4, 12, grid))
    got = unit_overlap.run(*args, mode, 4, 12, grid)
    assert got.shape == (grid * unit_overlap.ROWS, unit_overlap.C)
    np.testing.assert_allclose(got.numpy(), want, rtol=MM_TOL, atol=MM_TOL)


def test_unit_overlap_checks_its_inputs():
    x, x2, w, a, b = unit_overlap.inputs(1, "cpu")
    with pytest.raises(ValueError, match="unknown mode"):
        unit_overlap.run(x, x2, w, a, b, "both", 4, 12, 1)
    with pytest.raises(ValueError, match="x must be"):
        unit_overlap.run(x, x2, w, a, b, "mm_only", 4, 12, 2)
    with pytest.raises(ValueError, match="nm and nv"):
        unit_overlap.run(x, x2, w, a, b, "serial", 0, 12, 1)


# ---------------------------------------------------------------------------
# 17b vpu_ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(vpu_ops.OPS))
def test_vpu_op_chain_matches_jax(name, interpret, monkeypatch):
    jp = _jax_probe("vpu_ops")
    assert list(jp.OPS) == list(vpu_ops.OPS)
    for mod in (jp, vpu_ops):
        monkeypatch.setattr(mod, "SHAPE", (2, 8, 128))
        monkeypatch.setattr(mod, "REPEAT", 8)
    x = vpu_ops.inputs("cpu")
    want = np.asarray(jp.make_fn(jp.OPS[name])(jnp.asarray(x.numpy())))
    got = vpu_ops.make_fn(name)(x)
    assert got.shape == (2, 8, 128)
    rtol = SQUARE_RTOL if name == "recip_mul" else OP_TOL
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=OP_TOL)


def test_vpu_ops_checks_its_inputs():
    x = vpu_ops.inputs("cpu")
    with pytest.raises(ValueError, match="unknown op"):
        vpu_ops.vpu_chain(x, "cos", 4)
    with pytest.raises(ValueError, match="must be"):
        vpu_ops.make_fn("mul")(x[:1])
    with pytest.raises(ValueError, match="float32"):
        vpu_ops.vpu_chain(x.double(), "mul", 4)


# ---------------------------------------------------------------------------
# 17c scan_chunked
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scan_case():
    g, x = scan_chunked.inputs("cpu", b=16)
    return g, x, scan_chunked.serial_oracle(g.numpy(), x.numpy())


@pytest.mark.parametrize("which", ["flat", "chunk"])
def test_scan_run_matches_jax(which, scan_case):
    g, x, _ = scan_case
    jp = _jax_probe("scan_chunked")
    want = float(jp.run(jnp.asarray(g.numpy()), jnp.asarray(x.numpy()), which))
    got = float(scan_chunked.run(g, x, which))
    assert abs(got - want) <= SCAN_TOL * abs(want)


def test_scan_outputs_match_jax_and_the_serial_oracle(scan_case):
    g, x, oracle = scan_case
    jp = _jax_probe("scan_chunked")
    gj, xj = jnp.asarray(g.numpy()), jnp.asarray(x.numpy())
    flat_j = np.asarray(jax.jit(jp._scan_body)(xj, gj))
    chunk_j = np.asarray(jax.jit(lambda g_, x_: jp._scan_chunked(x_, g_))(gj, xj))
    flat = scan_chunked.scan_flat(g, x).numpy()
    chunk = scan_chunked.scan_chunk(g, x).numpy()
    serial = scan_chunked.scan(g, x, "serial").numpy()
    # the same Hillis-Steele rounds as JAX's _scan_body, in the same order
    assert _rel(flat, flat_j) <= 1e-6
    for got in (flat, chunk, serial):
        assert _rel(got, oracle) <= SCAN_TOL
    assert _rel(chunk, chunk_j) <= SCAN_TOL
    np.testing.assert_allclose(serial, oracle, rtol=0, atol=0)


def test_scan_checks_its_inputs():
    g, x = scan_chunked.inputs("cpu", b=2)
    with pytest.raises(ValueError, match="unknown scan"):
        scan_chunked.scan(g, x, "blelloch")
    with pytest.raises(ValueError, match="no multiple of the chunk"):
        scan_chunked.scan_chunk(g[:, :196].contiguous(), x[:, :196].contiguous())
    with pytest.raises(ValueError, match=r"\[B, T, C\]"):
        scan_chunked.scan_flat(g[:, :10].contiguous(), x)


# ---------------------------------------------------------------------------
# 17d ce_mxu
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ce_case():
    return ce_mxu.inputs(512, 384, "cpu")


def test_mm_matches_pallas_mm(ce_case):
    x, table, _, _ = ce_case
    jp = _jax_probe("ce_mxu")
    want = np.asarray(jp.pallas_mm(jnp.asarray(x.numpy()), jnp.asarray(table.numpy()), 256))
    got = ce_mxu.mm(x, table, 256)
    assert got.shape == (512, 384) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=MXU_TOL, atol=MXU_TOL)


def test_fused_ce_sums_match_fused_ce_at_bn(ce_case):
    x, table, bias, targets = ce_case
    jp = _jax_probe("ce_mxu")
    fwd_j, fwdbwd_j, args_j = jp.fused_ce_at_bn(
        jnp.asarray(x.numpy()), jnp.asarray(table.numpy()), jnp.asarray(bias.numpy()),
        jnp.asarray(targets.numpy().astype(np.int32)), 256, 370)
    fwd, fwdbwd, args = ce_mxu.fused_ce(x, table, bias, targets, 370)
    for got, want in ((fwd(*args), fwd_j(*args_j)), (fwdbwd(*args), fwdbwd_j(*args_j))):
        assert abs(float(got) - float(want)) <= CE_RTOL * abs(float(want))


def test_mm_takes_the_heights_shared_memory_allows(ce_case):
    x, table, _, _ = ce_case
    with pytest.raises(ValueError, match="block height 2048"):
        ce_mxu.mm(x, table, 2048)
    with pytest.raises(ValueError, match="V even"):
        ce_mxu.mm(x, table[:383].contiguous(), 256)
    with pytest.raises(ValueError, match=r"\[N, 64\]"):
        ce_mxu.mm(x[:, :32].contiguous(), table, 256)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def test_entry_points_run_the_plain_versions_on_the_cpu(monkeypatch, capsys):
    before = {s for s in _cuda._loaded if s in _cuda.PROBE_SOURCES}
    counters = (unit_overlap.run, vpu_ops.vpu_chain, scan_chunked.scan_flat,
                scan_chunked.scan_chunk, ce_mxu.mm)
    launches = [f.launches for f in counters]
    out = unit_overlap.main(["--nm", "2", "--nv", "4", "--grid", "1", "--device", "cpu"])
    assert set(out["ms"]) == set(unit_overlap.MODES)
    monkeypatch.setattr(vpu_ops, "SHAPE", (2, 8, 128))
    monkeypatch.setattr(vpu_ops, "REPEAT", 2)
    assert set(vpu_ops.main(["--device", "cpu"])["ms"]) == set(vpu_ops.OPS)
    monkeypatch.setattr(scan_chunked, "B", 4)
    assert set(scan_chunked.main(["--device", "cpu"])["ms"]) == set(scan_chunked.WHICH)
    res = ce_mxu.main(["256", "128", "128", "--device", "cpu"])
    assert set(res) == {"torch-mm", "cuda-mm bn=128", "fused-ce"}
    text = capsys.readouterr().out
    assert "overlap fraction" in text and "chunked correct vs serial oracle" in text
    assert text.count("cpu: plain versions, host times") == 4
    assert [f.launches for f in counters] == launches
    assert {s for s in _cuda._loaded if s in _cuda.PROBE_SOURCES} == before


@pytest.mark.parametrize("module", [unit_overlap, vpu_ops, scan_chunked, ce_mxu])
def test_entry_points_raise_without_a_card(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        module.main([])


def test_probe_sources_are_built_apart_from_the_model_paths():
    assert not set(_cuda.PROBE_SOURCES) & set(_cuda.SOURCES)
    for src in _cuda.PROBE_SOURCES:
        assert (_cuda.SRC_DIR / src).is_file()
        assert len(_cuda._SIGNATURES[src]) == 1
