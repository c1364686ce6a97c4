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
  sums against the port's row-13 plain version;
* ``emb_gather``: ``pallas_gather`` at N 1,024, V 300, bn 256, bf16 and
  fp32 tables;
* ``mask_replay_check``: ``call`` with both kernels (interpret mode, whose
  PRNG bits are zeros) against ``philox.mask_of_bits`` of zeros, and with
  ``pltpu.prng_random_bits`` replaced by set bits (threshold - 1, the
  threshold, 0, 2^32 - 1) at keep 0.8, 0.5 and 0.9 against the port's
  threshold and scale; the port's plain masks, drawn chunk by chunk, in
  both entry points against each other and ``philox.dropout_mask`` over
  the whole sequence (the bits are the port's own Philox draws: the TPU's
  cannot be had off the TPU);
* ``sass_mix.py`` (the mask kernels' instructions by pipe): its parse,
  loops and prices on a small disassembly in ``cuobjdump``'s form; and its
  count of HGMMA and TMA instructions in the ``wgmma`` / TMA kernels;
* the 3xTF32 chain of ``csrc/probe_unit_overlap.cu`` emulated in numpy:
  the accumulator's columns as the next product's depth (w's rows
  permuted), 16 k-tiles x 3 TF32 products into one accumulator whose
  every product step truncates to fp32, nm 16 products, against an fp64
  chain.

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
* ``FP32_TOL`` 1e-4 (atol and rtol, ``chip_smoke.py``'s): the emulated
  3xTF32 chain in one truncating accumulator against fp64;
* ``CE_RTOL`` 1e-5: row 13's sums over 512 x 384 logits, its exp as
  exp2(x log2 e) against XLA's exp inside the JAX kernels;
* none for the gather and the masks: a gather copies bits, and a mask
  is 0 or fp32(1/keep) by a comparison of integers, so both are held
  bit for bit; ``DROP_TOL`` 0.01 on a mask's drop fraction against
  1 - keep (65,536 draws of m0: sigma 0.0016).
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
from jax.experimental.pallas import tpu as pltpu

from datamining_recblr_torch.ops import _cuda, philox
from datamining_recblr_torch.probes import (ce_mxu, emb_gather, mask_replay_check,
                                            scan_chunked, unit_overlap, vpu_ops)

ROOT = Path(__file__).resolve().parents[1]
MM_TOL = 2e-5
OP_TOL = 2e-6
SQUARE_RTOL = 1e-4
SCAN_TOL = 1e-4
MXU_TOL = 1e-6
FP32_TOL = 1e-4
CE_RTOL = 1e-5
DROP_TOL = 0.01


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


@pytest.fixture
def interpret_prng(monkeypatch):
    """pallas_call in the interpret mode that takes ``pltpu.prng_*`` (its
    random bits are zeros) for one test."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=pltpu.InterpretParams()))


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
    for bn in (256, 2048):
        want = np.asarray(jp.pallas_mm(jnp.asarray(x.numpy()), jnp.asarray(table.numpy()), bn))
        got = ce_mxu.mm(x, table, bn)
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
    assert set(ce_mxu.DEFAULT_BNS) == {256, 512, 1024, 2048} <= set(ce_mxu.BNS)
    assert ce_mxu.mm(x, table, 2048).shape == (512, 384)
    for bn in (64, 3000, 4096):
        with pytest.raises(ValueError, match=f"block height {bn}"):
            ce_mxu.mm(x, table, bn)
    for v in (383, 382):
        with pytest.raises(ValueError, match="V a multiple of 4"):
            ce_mxu.mm(x, table[:v].contiguous(), 256)
    with pytest.raises(ValueError, match=r"\[N, 64\]"):
        ce_mxu.mm(x[:, :32].contiguous(), table, 256)


# ---------------------------------------------------------------------------
# 17e emb_gather
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_gather_matches_pallas_gather(dtype):
    jp = _jax_probe("emb_gather")
    ids, tab = emb_gather.inputs("cpu", 1024, 300, 64, emb_gather.DTYPES[dtype])
    want = np.asarray(jp.pallas_gather(jnp.asarray(ids.numpy()),
                                       jnp.asarray(tab.float().numpy(), getattr(jnp, dtype)),
                                       bn=256))
    got = emb_gather.gather(ids, tab, bn=256)
    assert got.shape == (1024, 64) and got.dtype == tab.dtype
    assert str(want.dtype) == dtype
    assert np.array_equal(got.float().numpy(), want.astype(np.float32))


def test_gather_checks_its_inputs():
    ids, tab = emb_gather.inputs("cpu", 16, 10, 8)
    with pytest.raises(ValueError, match="1-D int32 or int64"):
        emb_gather.gather(ids.float(), tab)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        emb_gather.gather(ids, tab.half())
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        emb_gather.gather(ids, tab.t())
    with pytest.raises(ValueError, match="positive number of rows"):
        emb_gather.gather(ids, tab, bn=0)
    assert torch.equal(emb_gather.gather(ids.long(), tab, bn=3), tab[ids.long()])


# ---------------------------------------------------------------------------
# 17f mask_replay_check
# ---------------------------------------------------------------------------

def _jax_masks(jp, kernel_name):
    flip = kernel_name == "bwd_kernel"
    return [np.asarray(a) for a in jp.call(getattr(jp, kernel_name), flip)]


@pytest.mark.parametrize("kernel_name", ["fwd_kernel", "bwd_kernel"])
def test_masks_match_call_on_zero_bits(kernel_name, interpret_prng):
    """Off the TPU the JAX kernels' PRNG bits are zeros: every element is
    kept at 1/0.8.  The port's mask function of zero bits gives the same
    shapes, dtype and values."""
    mr = mask_replay_check
    jp = _jax_probe("mask_replay_check")
    assert (jp.BT, jp.TC, jp.D, jp.NB, jp.NC, jp.KP) == (mr.BT, mr.TC, mr.D, mr.NB, mr.NC,
                                                          mr.KP)
    want = _jax_masks(jp, kernel_name)
    assert [a.shape[2] for a in want] == list(mr.widths())
    for a, w in zip(want, mr.widths()):
        got = philox.mask_of_bits(torch.zeros((mr.NB * mr.BT, mr.NC * mr.TC, w),
                                              dtype=torch.int64), mr.KP)
        assert got.dtype == torch.float32 and a.dtype == np.float32
        assert a.shape == tuple(got.shape)
        assert np.array_equal(got.numpy(), a)
        assert np.all(a == np.float32(1.25))


def _set_bits(keep):
    """A stand-in for ``pltpu.prng_random_bits``: channel c gets threshold
    - 1, the threshold, 0 or 2^32 - 1 by c mod 4 (built from iota: a
    Pallas kernel captures no array constant)."""
    t = philox.threshold_of_keep(keep)

    def bits(shape):
        c = jax.lax.broadcasted_iota(jnp.uint32, shape, len(shape) - 1) % 4
        u = jnp.uint32
        v = jnp.where(c == 0, u(t - 1), jnp.where(c == 1, u(t), jnp.where(c == 2, u(0),
                                                                          u(0xFFFFFFFF))))
        return jax.lax.bitcast_convert_type(v, jnp.int32)

    values = np.array([t - 1, t, 0, 0xFFFFFFFF], np.int64)
    return bits, values


@pytest.mark.parametrize("keep", [0.8, 0.5, 0.9])
def test_threshold_and_scale_match_dropout_mask(keep, interpret_prng, monkeypatch):
    """JAX's ``_dropout_mask`` (through ``call``'s forward kernel) on set
    bits against the port's ``philox.mask_of_bits`` on the same bits:
    bits at threshold - 1 kept at fp32(1/keep), at the threshold dropped."""
    mr = mask_replay_check
    jp = _jax_probe("mask_replay_check")
    bits_fn, values = _set_bits(keep)
    monkeypatch.setattr(pltpu, "prng_random_bits", bits_fn)
    monkeypatch.setattr(jp, "KP", keep)
    want = _jax_masks(jp, "fwd_kernel")
    assert philox.threshold_of_keep(keep) == min(int(keep * 4294967296.0), 4294967295)
    assert philox.scale_of_keep(keep) == float(np.float32(1.0 / keep))
    for a, w in zip(want, mr.widths()):
        bits = torch.from_numpy(np.resize(values, w)).expand(*a.shape[:2], w)
        got = philox.mask_of_bits(bits, keep)
        assert np.array_equal(got.numpy(), a)
        assert a[0, 0, 0] == np.float32(1.0 / keep) and a[0, 0, 1] == 0.0
        assert a[0, 0, 2] == np.float32(1.0 / keep) and a[0, 0, 3] == 0.0


def test_plain_masks_drawn_by_chunk_equal_dropout_mask():
    mr = mask_replay_check
    fwd = mr.masks_forward(device="cpu")
    rev = mr.masks_reversed(device="cpu")
    rows, t = mr.NB * mr.BT, mr.NC * mr.TC
    for k, (a, b, mid, w) in enumerate(zip(fwd, rev, mr.MASK_IDS, mr.widths())):
        assert a.shape == (rows, t, w) and a.dtype == torch.float32
        assert torch.equal(a, b), k
        assert torch.equal(a, philox.dropout_mask(mr.SEED, mid, rows, t, w, 1 - mr.KP)), k
        assert abs(mr.drop_fraction(a) - (1 - mr.KP)) <= DROP_TOL, k
    assert not torch.equal(fwd[0], fwd[1])  # the mask id keys the draw


def test_masks_check_their_arguments():
    mr = mask_replay_check
    with pytest.raises(ValueError, match="must be positive"):
        mr.masks_plain(nc=0)
    with pytest.raises(ValueError, match="multiples of 4"):
        mr.masks_forward(d=30, device="cpu")
    with pytest.raises(ValueError, match="keep must be"):
        mr.masks_reversed(keep=0.0, device="cpu")
    with pytest.raises(ValueError, match="no kernel for device"):
        mr.masks_forward(device="meta")


# a disassembly in cuobjdump's form: one kernel whose drawing loop (one
# Philox round's worth, a 16-byte store) branches back by offset, then one
# whose loops branch back by label, the inner one a scalar store
_SASS = """
		Function : _ZN12_GLOBAL__N_120masks_forward_kernelEN6recblr7DropoutENS_5MasksEiii
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   IMAD.WIDE.U32 R2, R0, -0x2daee0ad, RZ ;
        /*0020*/                   LOP3.LUT R4, R3, R5, UR6, 0x96, !PT ;
        /*0030*/                   ISETP.GE.U32.AND P0, PT, R4, c[0x0][0x220], PT ;
        /*0040*/                   FSEL R8, RZ, c[0x0][0x224], P0 ;
        /*0050*/                   ST.E.128 desc[UR4][R10.64], R8 ;
        /*0060*/                   VIADD R0, R0, 0x200 ;
        /*0070*/              @!P1 BRA 0x10 ;
        /*0080*/                   EXIT ;
        /*0090*/                   BRA 0x90;
		Function : _ZN12_GLOBAL__N_121masks_reversed_kernelEN6recblr7DropoutENS_5MasksEiii
        /*0000*/                   S2R R0, SR_TID.X ;
.L_x_1:
        /*0010*/                   UIADD3 UR4, UR4, 0x1, URZ ;
.L_x_0:
        /*0020*/                   IMAD.HI.U32 R2, R0, 0x5, RZ ;
        /*0030*/                   MUFU.RCP R3, R2 ;
        /*0040*/                   STG.E desc[UR4][R10.64], R8 ;
        /*0050*/              @P0 BRA `(.L_x_0) ;
        /*0060*/              @P1 BRA `(.L_x_1) ;
        /*0070*/                   EXIT ;
"""


def test_sass_mix_counts_the_innermost_loops_by_pipe():
    spec = importlib.util.spec_from_file_location("_sass_mix", ROOT / "sass_mix.py")
    sm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sm)
    funcs = sm.parse(_SASS)
    fwd, rev = (next(f for f in funcs if k in f) for k in sm.KERNELS)
    assert sm.innermost_loops(funcs[fwd]) == [(0x10, 0x70)]  # not the trap after EXIT
    mix = sm.loop_mix(funcs[fwd], (0x10, 0x70), sm.ELEMS)
    assert mix["elements_per_iteration"] == 4
    assert mix["per_element"] == {"alu": 1.0, "control": 0.25, "fmaheavy": 0.25, "mem": 0.25}
    ms = mix["ms_at_elems"]
    assert ms["alu"] == pytest.approx(sm.ELEMS / (132 * 64 * 67e12 / (132 * 256)) * 1e3)
    assert ms["bytes"] == pytest.approx(sm.ELEMS * 4 / 3.35e12 * 1e3)
    assert mix["bound_by"] == "bytes" and mix["other_opcodes"] == []
    assert mix["philox_per_element"] == {"IMAD.WIDE": 0.25, "LOP3": 0.25}
    assert sm.innermost_loops(funcs[rev]) == [(0x20, 0x50)]
    mix = sm.loop_mix(funcs[rev], (0x20, 0x50), sm.ELEMS)
    assert mix["elements_per_iteration"] == 1
    assert mix["philox_per_element"] == {"IMAD.WIDE": 0.0, "LOP3": 0.0}  # IMAD.HI is no wide one
    assert mix["opcodes"] == {"IMAD": 1, "MUFU": 1, "STG": 1, "BRA": 1}
    assert mix["per_element"] == {"control": 1.0, "fmaheavy": 1.0, "mem": 1.0, "xu": 1.0}
    assert mix["ms_at_elems"]["xu"] == pytest.approx(4 * mix["ms_at_elems"]["fmaheavy"])


# the wgmma / TMA kernels as cuobjdump prints them: ce_mm's products, a
# TMA load and a TMA store; unit_overlap's mm_only and vpu_only instances
_SASS_UNITS = """
		Function : _ZN48_GLOBAL__N__f4453b44_15_probe_ce_mxu_cu_8bb4081e12ce_mm_kernelE14CUtensorMap_stS0_S0_iii
        /*2af0*/                   WARPGROUP.ARRIVE ;
        /*2b30*/                   HGMMA.64x128x16.F32.BF16 R24, R88, gdesc[UR8], RZ, !UPT ;
        /*2be0*/                   HGMMA.64x128x16.F32.BF16 R24, R92, gdesc[UR8], R24, gsb0 ;
        /*2db0*/                   WARPGROUP.DEPBAR.LE gsb0, 0x0 ;
        /*31f0*/                   UTMASTG.2D [UR12], [UR10] ;
        /*3300*/              @!P0 UTMASTG.2D [UR12], [UR10] ;
        /*3550*/                   UTMACMDFLUSH ;
        /*3d40*/                   UTMALDG.2D [UR12], [UR10] ;
        /*3d50*/                   EXIT ;
		Function : _ZN48_GLOBAL__N__f4453b44_15_probe_ce_mxu_cu_8bb4081e18round_table_kernelEPK6float4P5uint2i
        /*0000*/                   LDG.E.128 R4, desc[UR4][R2.64] ;
        /*0010*/                   EXIT ;
		Function : _ZN54_GLOBAL__N__4b2e3eed_21_probe_unit_overlap_cu_a6ece30719unit_overlap_kernelILi1EEEvPKfS2_S2_S2_S2_Pfiii
        /*0000*/                   FFMA R4, R4, R5, R6 ;
        /*0010*/                   EXIT ;
		Function : _ZN54_GLOBAL__N__4b2e3eed_21_probe_unit_overlap_cu_a6ece30719unit_overlap_kernelILi0EEEvPKfS2_S2_S2_S2_Pfiii
        /*0000*/                   HGMMA.64x128x8.F32.TF32 R24, R120, gdesc[UR8], RZ, !UPT ;
        /*0010*/                   HGMMA.64x128x8.F32.TF32 R24, R124, gdesc[UR12], R24 ;
        /*0020*/                   HGMMA.64x128x8.F32.TF32 R24, R124, gdesc[UR8], R24, gsb0 ;
        /*0030*/                   EXIT ;
"""


def test_sass_mix_counts_hgmma_and_tma_by_kernel():
    spec = importlib.util.spec_from_file_location("_sass_mix", ROOT / "sass_mix.py")
    sm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sm)
    funcs = sm.parse(_SASS_UNITS)
    ce = sm.unit_counts(funcs, sm.UNIT_KERNELS["probe_ce_mxu.cu"])
    assert list(ce.values()) == [{"HGMMA": 2, "UTMALDG": 1, "UTMASTG": 2, "UBLKCP": 0}]
    uo = sm.unit_counts(funcs, sm.UNIT_KERNELS["probe_unit_overlap.cu"])
    assert [c["HGMMA"] for c in uo.values()] == [0, 3]
    assert all(c["UTMASTG"] == 0 for c in uo.values())


def test_sass_mix_finds_each_mask_kernels_loops():
    """``mask_mix`` lists every function of each mask kernel with its
    loops, and refuses a disassembly that lacks one of them."""
    spec = importlib.util.spec_from_file_location("_sass_mix", ROOT / "sass_mix.py")
    sm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sm)
    res = sm.mask_mix(_SASS)
    assert [r["kernel"] for r in res] == list(sm.KERNELS)
    assert [len(r["loops"]) for r in res] == [1, 1]
    assert res[0]["loops"][0]["philox_per_element"]["IMAD.WIDE"] == 0.25
    with pytest.raises(LookupError, match="masks_reversed_kernel"):
        sm.mask_mix(_SASS.split("\t\tFunction : _ZN12_GLOBAL__N_121masks_reversed")[0])


# row 13's bf16 forward on wgmma as cuobjdump prints an instance: the
# products and the table's TMA loads, and the table-rounding kernel beside
_SASS_CE = """
		Function : _ZN12_GLOBAL__N_119ce_fwd_wgmma_kernelI13__nv_bfloat16EEv14CUtensorMap_stPKT_PKfPKiPfSA_iiii
        /*0100*/                   UTMALDG.2D [UR8], [UR4] ;
        /*0110*/                   UTMALDG.2D [UR16], [UR4] ;
        /*0200*/                   HGMMA.64x128x16.F32.BF16 R24, R152, gdesc[UR8], RZ, !UPT ;
        /*0210*/                   HGMMA.64x128x16.F32.BF16 R88, R184, gdesc[UR12], RZ, gsb0 ;
        /*0300*/                   EXIT ;
		Function : _ZN12_GLOBAL__N_121ce_round_table_kernelEPKfPjii
        /*0000*/                   LDG.E R4, desc[UR4][R2.64] ;
        /*0010*/                   EXIT ;
"""


def test_sass_mix_counts_the_ce_forward_units():
    spec = importlib.util.spec_from_file_location("_sass_mix", ROOT / "sass_mix.py")
    sm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sm)
    ce = sm.unit_counts(sm.parse(_SASS_CE), sm.UNIT_KERNELS["fused_ce.cu"])
    assert list(ce.values()) == [{"HGMMA": 2, "UTMALDG": 2, "UTMASTG": 0, "UBLKCP": 0}]


# ---------------------------------------------------------------------------
# 17a: the kernel's 3xTF32 chain in one accumulator, emulated
# ---------------------------------------------------------------------------

def _tf32(v):
    """fp32 to TF32 bits, nearest, ties away from zero (``split_i``)."""
    b = np.asarray(v, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(v):
    hi = _tf32(v)
    return hi, _tf32(np.float32(v) - hi)


def _truncate(v64):
    """fp64 to fp32 toward zero: the tensor cores' fp32 sum."""
    f = v64.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v64)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _depth_row(k):
    """``depth_row``: physical depth p of a k-tile holds w's row 2p (p < 4)
    or 2(p - 4) + 1, the accumulator's column order."""
    p = k % 8
    return k - p + np.where(p < 4, 2 * p, 2 * (p - 4) + 1)


def test_3xtf32_chain_in_one_accumulator_meets_fp32_tol():
    """``probe_unit_overlap.cu`` ``mm_step`` on 64 rows, nm 16, as the card
    sums it: y's columns enter as the next product's depth in the
    permuted order, each 8-deep k-tile three TF32 products (al bh, ah bl,
    ah bh) added one by one into the same fp32 accumulator, every addition
    truncated; 16 products against an fp64 chain."""
    x, _, w, _, _ = (t.numpy() for t in unit_overlap.inputs(1, "cpu"))
    y, want = x[:64].copy(), x[:64].astype(np.float64)
    perm = _depth_row(np.arange(unit_overlap.C))
    wh, wl = _split(w[perm])
    for _ in range(16):
        ah, al = _split(y[:, perm])
        acc = np.zeros_like(y, dtype=np.float32)
        for kt in range(unit_overlap.C // 8):
            k = slice(8 * kt, 8 * kt + 8)
            for a, b in ((al, wh), (ah, wl), (ah, wh)):
                acc = _truncate(acc.astype(np.float64) + a[:, k].astype(np.float64)
                                @ b[k].astype(np.float64))
        y = acc
        want = want @ w.astype(np.float64)
    np.testing.assert_allclose(y, want, rtol=FP32_TOL, atol=FP32_TOL)
    assert np.abs(y - want).max() < 1e-5

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


def test_gather_and_mask_entry_points_run_the_plain_versions_on_the_cpu(monkeypatch, capsys):
    before = {s for s in _cuda._loaded if s in _cuda.PROBE_SOURCES}
    counters = (emb_gather.gather, mask_replay_check.masks_forward,
                mask_replay_check.masks_reversed)
    launches = [f.launches for f in counters]
    monkeypatch.setattr(emb_gather, "N", 4096)
    res = emb_gather.main(["--device", "cpu", "--bn", "1000", "--dtype", "float32"])
    assert res["ok"] and res["ms"] is not None and res["library_ms"] is not None
    res = mask_replay_check.main(["--device", "cpu", "--nb", "1", "--nc", "2", "--tc", "8"])
    assert res["ok"] and set(res["ms"]) == {"forward", "reversed"} and len(res["drop"]) == 4
    text = capsys.readouterr().out
    assert "plain gather correct: True" in text and "torch gather:" in text
    assert "drop fraction: " in text and "masks bitwise equal: True" in text
    assert text.count("cpu: plain versions, host times") == 2
    assert [f.launches for f in counters] == launches
    assert {s for s in _cuda._loaded if s in _cuda.PROBE_SOURCES} == before


@pytest.mark.parametrize("module", [unit_overlap, vpu_ops, scan_chunked, ce_mxu, emb_gather,
                                    mask_replay_check])
def test_entry_points_raise_without_a_card(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        module.main([])


def test_probe_sources_are_built_apart_from_the_model_paths():
    assert not set(_cuda.PROBE_SOURCES) & set(_cuda.SOURCES)
    for src in _cuda.PROBE_SOURCES:
        assert (_cuda.SRC_DIR / src).is_file()
        assert len(_cuda._SIGNATURES[src]) == 1
