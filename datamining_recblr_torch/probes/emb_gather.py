"""An embedding gather from a table that stays in the card's L2, beside
PyTorch's own.  Counterpart of ``benchmarks/emb_gather.py`` (queue B row
17e), whose ``pallas_gather`` (``_gather_kernel``, its ``pallas_call``)
gathered from a table resident in the TPU's VMEM.

  cuda gather   ``gather(ids, tab, bn)``: out[i] = tab[ids[i]], the kernel
                of ``csrc/probe_emb_gather.cu`` on CUDA tensors (a group of
                lanes a row, 16-byte loads and stores where the row allows,
                ``bn`` rows a block), ``gather_plain`` on CPU tensors;
                ``gather.launches`` counts the kernel's launches
  torch gather  ``gather_plain``: PyTorch's ``tab[ids]``, the plain version
                and the JAX probe's ``xla_gather``

at the bench step's shape: ids [N] int32, N = B 2,048 x T 200 = 409,600,
from a [V 3,417, D 64] bf16 table.  The table (437,376 bytes) exceeds the
227 KB of shared memory a block can take, so where the TPU kernel held it
in VMEM, the kernel reads it through L2 (50 MB).  Ids follow Python's
indexing: -V <= id < V, a negative id counting from the end; the kernel
writes a zero row for any other id and reads nothing outside the table,
where ``tab[ids]`` raises.

    python -m datamining_recblr_torch.probes.emb_gather [--bn 4096] [--dtype bfloat16|float32] [--device cuda|cpu]

prints the JAX probe's lines in its order, the gather's correctness (bit
for bit against ``tab[ids]``: a gather copies bits), the kernel's ms (50
calls after two) and the library's, under the card's name and power
limit.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from datamining_recblr_torch.ops import _cuda
from datamining_recblr_torch.probes import _bench

B, T, V, D = 2048, 200, 3417, 64
N = B * T
BN = 4096
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def gather_plain(ids, tab):
    return tab[ids]


def gather(ids, tab, bn=BN):
    """[N, D] rows of ``tab`` [V, D] (bf16 or fp32) at ``ids`` [N] (int32
    or int64): the kernel with ``bn`` rows a block on CUDA tensors,
    ``gather_plain`` on CPU ones."""
    if ids.dim() != 1 or ids.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"ids must be a 1-D int32 or int64 tensor, got {ids.dtype} "
                         f"{tuple(ids.shape)}")
    if tab.dim() != 2 or tab.dtype not in DTYPES.values() or not tab.is_contiguous():
        raise ValueError(f"tab must be a contiguous [V, D] bfloat16 or float32 tensor, got "
                         f"{tab.dtype} {tuple(tab.shape)}")
    if tab.device != ids.device:
        raise ValueError(f"ids on {ids.device} and tab on {tab.device}")
    if int(bn) < 1:
        raise ValueError(f"bn must be a positive number of rows, got {bn}")
    if ids.device.type == "cpu":
        return gather_plain(ids, tab)
    _cuda.require_cuda(ids)
    n, (v, d) = ids.shape[0], tab.shape
    if v < 1 or v >= 2**31 or d < 1 or -(-n // int(bn)) >= 2**31:
        raise ValueError(f"the kernel takes 1 <= V < 2^31, D >= 1 and N / bn blocks below "
                         f"2^31, got V={v} D={d} N={n} bn={bn}")
    ids = ids.contiguous()
    out = torch.empty((n, d), dtype=tab.dtype, device=tab.device)
    if n == 0:
        return out
    lib = _cuda.library("probe_emb_gather.cu")
    with torch.cuda.device(ids.device):
        err = lib.recblr_probe_emb_gather(ids.data_ptr(), int(ids.dtype == torch.int64),
                                          tab.data_ptr(), out.data_ptr(), n, v,
                                          d * tab.element_size(), int(bn), ids.device.index,
                                          _cuda.stream(ids))
    _cuda.check(lib, err, "emb_gather")
    gather.launches += 1
    return out


gather.launches = 0


def inputs(dev, n=N, v=V, d=D, dtype=torch.bfloat16):
    """ids [n] int32 in [0, v) and a normal table [v, d] in ``dtype``, from
    ``np.random.default_rng(0)`` as the JAX probe's ``main`` draws them."""
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, v, size=n).astype(np.int32))
    tab = torch.from_numpy(rng.normal(size=(v, d)).astype(np.float32)).to(dtype)
    return ids.to(dev), tab.to(dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bn", type=int, default=BN)
    ap.add_argument("--dtype", choices=tuple(DTYPES), default="bfloat16")
    _bench.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = _bench.resolve_device(args.device)
    print(f"emb_gather N={N} V={V} D={D} {args.dtype} bn={args.bn}  [{_bench.card(dev)}]")
    ids, tab = inputs(dev, N, V, D, DTYPES[args.dtype])
    label = "cuda gather" if dev.type == "cuda" else "plain gather"
    ref = gather_plain(ids, tab)
    ok = bool(torch.equal(gather(ids, tab, args.bn), ref))
    print(f"{label} correct:", ok, flush=True)
    res = {"ok": ok, "ms": None}
    if ok:
        res["ms"] = _bench.time_calls(lambda: gather(ids, tab, args.bn), dev, 50)
        print(f"{label}:  {res['ms']:.4f} ms", flush=True)
    res["library_ms"] = _bench.time_calls(lambda: gather_plain(ids, tab), dev, 50)
    print(f"torch gather: {res['library_ms']:.4f} ms", flush=True)
    return res


if __name__ == "__main__":
    main()
