"""Does CUDA-core work hide under a chain of dependent tensor-core
products on the card?  Counterpart of ``benchmarks/unit_overlap.py``
(queue B row 17a), whose kernel ``_kernel`` (``pallas_call`` in ``_run``)
asked it of the v5e's MXU and VPU.

Five chains over ``[grid x 1,600, 128]`` fp32 rows (the fused layer
kernels' block: 8 rows x T 200):

  mm_only    nm dependent products y <- y @ w, w [128, 128] fp32
  vpu_only   nv dependent steps v <- v * a + b, a tanh every 4th step
  serial     one chain: a product, then nv // nm steps, nm times
  indep_il   two independent chains (products on x, steps on x2),
             written stage-interleaved; out = y + v
  indep_seq  the same two chains written one after the other

If ``indep_*`` comes near max(mm_only, vpu_only) the units overlap; near
the sum, they take turns.  ``run`` is the kernel of
``csrc/probe_unit_overlap.cu`` on a CUDA tensor (the product as the port's
3xTF32 ``mma.sync``, a warp's 16 rows chained in registers) and
``run_plain``, the JAX kernel's arithmetic in PyTorch, on a CPU tensor.
``run.launches`` counts the kernel's launches.

    python -m datamining_recblr_torch.probes.unit_overlap [--nm 16] [--nv 48] [--grid 64]
        [--device cuda|cpu]

prints each mode's ms and us per 1,600-row program, and the overlap
fraction, as the JAX probe does, under the card's name and power limit.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from datamining_recblr_torch.ops import _cuda
from datamining_recblr_torch.probes import _bench

ROWS, C = 1600, 128
MODES = ("mm_only", "vpu_only", "serial", "indep_il", "indep_seq")


def _mm_step(y, w):
    return y @ w


def _vpu_step(v, a, b, i):
    v = v * a + b
    if i % 4 == 0:
        v = torch.tanh(v)
    return v


def run_plain(x, x2, w, a, b, mode, nm, nv):
    """The JAX probe's ``_kernel`` over all rows at once (each row is its
    own chain)."""
    if mode == "mm_only":
        y = x
        for _ in range(nm):
            y = _mm_step(y, w)
        return y
    if mode == "vpu_only":
        v = x
        for i in range(nv):
            v = _vpu_step(v, a, b, i)
        return v
    if mode == "serial":
        y = x
        per = max(1, nv // nm)
        for _ in range(nm):
            y = _mm_step(y, w)
            for i in range(per):
                y = _vpu_step(y, a, b, i)
        return y
    if mode == "indep_il":
        y, v = x, x2
        steps = max(nm, nv)
        for s in range(steps):
            if s < nm:
                y = _mm_step(y, w)
            for i in range((s * nv) // steps, ((s + 1) * nv) // steps):
                v = _vpu_step(v, a, b, i)
        return y + v
    if mode == "indep_seq":
        y = x
        for _ in range(nm):
            y = _mm_step(y, w)
        v = x2
        for i in range(nv):
            v = _vpu_step(v, a, b, i)
        return y + v
    raise ValueError(f"unknown mode {mode!r}; one of {MODES}")


def _checks(x, x2, w, a, b, mode, nm, nv, grid):
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    if nm < 1 or nv < 1:
        raise ValueError(f"nm and nv must be >= 1, got {nm}, {nv}")
    for name, t, shape in (("x", x, (grid * ROWS, C)), ("x2", x2, (grid * ROWS, C)),
                           ("w", w, (C, C)), ("a", a, (1, C)), ("b", b, (1, C))):
        if (tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != x.device):
            raise ValueError(f"{name} must be a contiguous float32 {shape} tensor on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def run(x, x2, w, a, b, mode, nm, nv, grid):
    """The chain ``mode`` over ``x, x2 [grid * 1,600, 128]``, ``w [128,
    128]``, ``a, b [1, 128]`` (fp32): the kernel on a CUDA tensor,
    ``run_plain`` on a CPU tensor.  Returns ``[grid * 1,600, 128]``."""
    _checks(x, x2, w, a, b, mode, nm, nv, grid)
    if x.device.type == "cpu":
        return run_plain(x, x2, w, a, b, mode, nm, nv)
    _cuda.require_cuda(x)
    lib = _cuda.library("probe_unit_overlap.cu")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.recblr_probe_unit_overlap(
            x.data_ptr(), x2.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
            out.data_ptr(), x.shape[0], MODES.index(mode), nm, nv, x.device.index,
            _cuda.stream(x))
    _cuda.check(lib, err, "unit_overlap")
    run.launches += 1
    return out


run.launches = 0


def inputs(grid, dev):
    """The JAX probe's inputs from ``np.random.default_rng(0)``: x, x2,
    w (orthogonal, times 0.99), a, b."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(grid * ROWS, C), scale=0.1)
    x2 = rng.normal(size=(grid * ROWS, C), scale=0.1)
    q, _ = np.linalg.qr(rng.normal(size=(C, C)))
    a = rng.normal(size=(1, C), scale=0.01) + 0.9
    b = rng.normal(size=(1, C), scale=0.01)
    return [torch.tensor(v, dtype=torch.float32, device=dev) for v in (x, x2, q * 0.99, a, b)]


def measure(nm, nv, grid, dev, iters=30, warmup=5):
    """Each mode's ms a call (``iters`` chained calls, x <- out, after
    ``warmup``), as the JAX probe's ``timeit``."""
    x, x2, w, a, b = inputs(grid, dev)
    return {mode: _bench.time_chain(
        lambda xv, m=mode: run(xv, x2, w, a, b, m, nm, nv, grid), x, dev, iters, warmup)
        for mode in MODES}


def report(ms, grid):
    """Print the JAX probe's lines; return us per program by mode and the
    interleaved overlap fraction."""
    us = {mode: t * 1e3 / grid for mode, t in ms.items()}
    for mode in MODES:
        print(f"{mode:10s} {ms[mode]:7.3f} ms  {us[mode]:7.2f} us/program")
    mm, vpu = us["mm_only"], us["vpu_only"]
    print(f"\nsum(mm,vpu)={mm + vpu:.2f} us  max={max(mm, vpu):.2f} us  "
          f"indep_il={us['indep_il']:.2f}  indep_seq={us['indep_seq']:.2f}")
    overlap = (mm + vpu - us["indep_il"]) / min(mm, vpu)
    print(f"overlap fraction (interleaved): {overlap:.2f} "
          f"(1.0 = full overlap, 0.0 = fully serialized)", flush=True)
    return us, overlap


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nm", type=int, default=16)
    ap.add_argument("--nv", type=int, default=48)
    ap.add_argument("--grid", type=int, default=64)
    _bench.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = _bench.resolve_device(args.device)
    print(f"unit_overlap nm={args.nm} nv={args.nv} grid={args.grid}  [{_bench.card(dev)}]")
    ms = measure(args.nm, args.nv, args.grid, dev)
    us, overlap = report(ms, args.grid)
    return {"ms": ms, "us_per_program": us, "overlap_il": overlap}


if __name__ == "__main__":
    main()
