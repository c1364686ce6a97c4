"""How far the whole-table CE kernels sit from a bare bf16 product of
their shape on the card.  Counterpart of ``benchmarks/ce_mxu.py`` (queue B
row 17d) at BERT4Rec's cloze loss: rows N 81,920, V 3,456, D 64.

  torch-mm   the library yardstick: a bf16 ``torch.mm`` with fp32 output
             (forward, 2 N D V FLOP), and the three products of the
             backward, x @ table^T, g @ table, g^T @ x (6 N D V); where
             this PyTorch has no fp32 output for bf16 products, bf16 output,
             and the line says so
  cuda-mm    ``mm``: the kernels of ``csrc/probe_ce_mxu.cu`` (the JAX
             probe's ``pallas_mm``, ``_mm_kernel``): out = bf16(x)
             bf16(table)^T in fp32, written to device memory; the table
             rounded to bf16 once a call, then persistent blocks on
             ``wgmma`` with the table's tiles brought in by TMA and the
             output written by TMA stores, a table tile serving ``bn``
             rows before the next; bn in ``BNS``
  fused-ce   ``fused_ce`` (the JAX probe's ``fused_ce_at_bn``): the port's
             row-13 forward and backward (``ops/fused_ce.py``, bf16
             products) at the probe's shape, valid_v 3,417; row 13 keeps
             its own tile, so there is no block height to vary

``mm`` launches its kernel on a CUDA tensor and computes the plain
product on a CPU tensor (``mm.launches`` counts the kernel's launches);
``fused_ce`` takes row 13's kernels or their plain versions the same way.

    python -m datamining_recblr_torch.probes.ce_mxu [rows] [V] [bn ...] [--device cuda|cpu]

prints each line's ms, TF/s and share of the card's bf16 peak (989
TFLOP/s, H100 SXM) as the JAX probe's ``report``, under the card's name
and power limit.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from datamining_recblr_torch.ops import _cuda
from datamining_recblr_torch.ops import fused_ce as FCE
from datamining_recblr_torch.probes import _bench

PEAK_TFLOPS = _bench.PEAK_BF16_FLOPS / 1e12
D = 64
# the block heights: the rows a block's walk covers under one table tile,
# in whole 128-row tiles; the JAX probe's heights by default
BNS = (128, 256, 512, 1024, 2048)
DEFAULT_BNS = (256, 512, 1024, 2048)
VALID_V = 3417
# the kernel's block of a fused-ce line: row 13's tiles at D 64 in bf16
ROW13_TILE = "fwd 64-row blocks x 64-row table tiles (FMA); bwd 128-row blocks, mma.sync"


def mm_plain(x, table):
    """bf16(x) @ bf16(table)^T with fp32 sums (the products of bf16 values
    are exact in fp32)."""
    return x.to(torch.bfloat16).float() @ table.to(torch.bfloat16).float().t()


def mm(x, table, bn):
    """[N, V] fp32 product of x [N, 64] and table [V, 64] (fp32, rounded
    to bf16 inside): the kernels with block height ``bn`` on a CUDA
    tensor, ``mm_plain`` on a CPU one."""
    if bn not in BNS:
        raise ValueError(f"block height {bn} not taken; one of {BNS} (whole 128-row tiles)")
    if (x.dim() != 2 or table.dim() != 2 or x.shape[1] != D or table.shape[1] != D
            or x.shape[0] < 1 or table.shape[0] < 4 or table.shape[0] % 4):
        raise ValueError(f"x must be [N, {D}] and table [V, {D}] with V a multiple of 4 (the "
                         f"TMA stores' 16-byte rows), got {tuple(x.shape)} and "
                         f"{tuple(table.shape)}")
    for name, t in (("x", x), ("table", table)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{name} must be contiguous float32 on {x.device}")
    if x.device.type == "cpu":
        return mm_plain(x, table)
    _cuda.require_cuda(x)
    n, v = x.shape[0], table.shape[0]
    if x.data_ptr() % 16 or table.data_ptr() % 16 or n * v >= 2**62:
        raise ValueError("x and table must start at 16-byte boundaries")
    lib = _cuda.library("probe_ce_mxu.cu")
    # the product, then the table rounded to bf16 (V x 64 x 2 bytes) as the
    # kernel's scratch in the same allocation
    buf = torch.empty(n * v + v * D // 2, device=x.device, dtype=torch.float32)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    with torch.cuda.device(x.device):
        err = lib.recblr_probe_ce_mm(x.data_ptr(), table.data_ptr(), buf.data_ptr(), n, v, bn,
                                     sms, x.device.index, _cuda.stream(x))
    _cuda.check(lib, err, "ce_mxu mm")
    mm.launches += 1
    return buf[: n * v].view(n, v)


mm.launches = 0


def library_out_dtype(dev):
    """The output type of the library's bf16 product: fp32 through
    ``torch.mm(..., out_dtype=)`` where this PyTorch has it on ``dev``,
    else bf16."""
    a = torch.zeros((16, 16), dtype=torch.bfloat16, device=dev)
    try:
        torch.mm(a, a, out_dtype=torch.float32)
        return torch.float32
    except (TypeError, RuntimeError, NotImplementedError):
        return torch.bfloat16


def torch_mm(x, table, out_dtype=torch.float32):
    """The library yardstick: (forward, three-product backward), the JAX
    probe's ``xla_fwd`` and ``xla_trio``; each product one bf16
    ``torch.mm`` with ``out_dtype`` output.  The forward returns its [N, V]
    product, as ``mm`` does (the JAX probe sums it); the backward the sum
    of dx and dtable[0, 0]."""
    xb, tb = x.to(torch.bfloat16), table.to(torch.bfloat16)

    def prod(a, b):
        if out_dtype == torch.float32:
            return torch.mm(a, b, out_dtype=torch.float32)
        return torch.mm(a, b)

    def fwd():
        return prod(xb, tb.t())

    def trio():
        gb = prod(xb, tb.t()).to(torch.bfloat16)
        return prod(gb, tb).sum() + prod(gb.t(), xb)[0, 0]

    return fwd, trio


def fused_ce(x, table, bias, targets, valid_v):
    """(fwd, fwdbwd, args) as the JAX probe's ``fused_ce_at_bn``: fwd
    returns sum(nll) of row 13's forward with bf16 products, fwdbwd
    sum(nll) + sum(dx) + dtable[0, 0] + dbias[0] with dnll = 1 through its
    backward; both on the card's kernels or, on the CPU, their plain
    versions."""

    def fwd(x, table, bias, targets):
        if x.device.type == "cpu":
            return FCE.fused_softmax_ce_plain(x, table, targets, bias, valid_v, True).sum()
        return FCE.fused_softmax_ce_train(x, table, targets, bias, valid_v, True)[0].sum()

    def fwdbwd(x, table, bias, targets):
        dnll = torch.ones(x.shape[0], device=x.device)
        if x.device.type == "cpu":
            nll = FCE.fused_softmax_ce_plain(x, table, targets, bias, valid_v, True)
            dx, dtab, dbias = FCE.fused_softmax_ce_bwd_plain(x, table, targets, dnll, bias,
                                                             valid_v, True)
        else:
            nll, lse = FCE.fused_softmax_ce_train(x, table, targets, bias, valid_v, True)
            dx, dtab, dbias = FCE.fused_softmax_ce_bwd(x, table, targets, dnll, bias, valid_v,
                                                       True, lse=lse)
        return nll.sum() + dx.sum() + dtab[0, 0] + dbias[0]

    return fwd, fwdbwd, (x, table, bias, targets)


def report(name, t_fwd, t_bwd, n, d, v):
    """The JAX probe's line: ms, TF/s and % of the bf16 peak, forward and,
    where given, forward and backward (times in ms)."""
    gf_fwd = 2 * n * d * v / 1e9
    gf_tot = 6 * n * d * v / 1e9
    line = (f"{name:>22}: fwd {t_fwd:6.3f} ms ({gf_fwd / t_fwd:6.1f} TF/s = "
            f"{100 * gf_fwd / t_fwd / PEAK_TFLOPS:4.1f}% peak)")
    if t_bwd is not None:
        line += (f"   fwd+bwd {t_bwd:6.3f} ms ({gf_tot / t_bwd:6.1f} TF/s = "
                 f"{100 * gf_tot / t_bwd / PEAK_TFLOPS:4.1f}% peak)")
    print(line, flush=True)


def inputs(n, v, dev):
    """x [n, 64], table [v, 64] (normal, times 0.1), bias [v] (times
    0.01), targets in [1, 3417), from ``np.random.default_rng(0)``."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, D)).astype(np.float32) * 0.1
    table = rng.standard_normal((v, D)).astype(np.float32) * 0.1
    bias = rng.standard_normal((v,)).astype(np.float32) * 0.01
    targets = rng.integers(1, VALID_V, size=n).astype(np.int64)
    return [torch.from_numpy(a).to(dev) for a in (x, table, bias, targets)]


def measure(n, v, bns, dev, k=30):
    """ms of each line: {"torch-mm": (fwd, trio), "cuda-mm bn=..": fwd,
    "fused-ce": (fwd, fwdbwd)}."""
    x, table, bias, targets = inputs(n, v, dev)
    res = {}
    lib_fwd, lib_trio = torch_mm(x, table, library_out_dtype(dev))
    res["torch-mm"] = (_bench.time_calls(lib_fwd, dev, k), _bench.time_calls(lib_trio, dev, k))
    for bn in bns:
        res[f"cuda-mm bn={bn}"] = _bench.time_calls(lambda bn=bn: mm(x, table, bn), dev, k)
    fwd, fwdbwd, args = fused_ce(x, table, bias, targets, min(VALID_V, v))
    res["fused-ce"] = (_bench.time_calls(lambda: fwd(*args), dev, k),
                       _bench.time_calls(lambda: fwdbwd(*args), dev, k))
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("rows", nargs="?", type=int, default=81_920)
    ap.add_argument("v", nargs="?", type=int, default=3_456)
    ap.add_argument("bns", nargs="*", type=int)
    _bench.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = _bench.resolve_device(args.device)
    bns = tuple(args.bns) or DEFAULT_BNS
    for bn in bns:
        if bn not in BNS:
            raise ValueError(f"block height {bn} not taken; one of {BNS}")
    n, v = args.rows, args.v
    print(f"rows={n} V={v} D={D}   peak={PEAK_TFLOPS:.0f} TF/s bf16 (H100 SXM)  "
          f"[{_bench.card(dev)}]")
    res = measure(n, v, bns, dev)
    out = "" if library_out_dtype(dev) == torch.float32 else " (bf16 out)"
    report("torch-mm" + out, *res["torch-mm"], n, D, v)
    for bn in bns:
        report(f"cuda-mm bn={bn}", res[f"cuda-mm bn={bn}"], None, n, D, v)
    report("fused-ce", *res["fused-ce"], n, D, v)
    print(f"{'fused-ce tile':>22}: {ROW13_TILE}", flush=True)
    return res


if __name__ == "__main__":
    main()
