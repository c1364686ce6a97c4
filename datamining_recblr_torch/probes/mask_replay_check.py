"""The sequence-chunked layer's dropout masks, drawn in data order and in
the reverse chunk order of its backward, compared bit for bit on the
card.  Counterpart of ``benchmarks/mask_replay_check.py`` (queue B row
17f), whose ``fwd_kernel`` and ``bwd_kernel`` (``call``'s ``pallas_call``)
drew them with the TPU's PRNG.

Grid (NB 2, NC 4) over blocks of BT 8 rows and TC 16 positions; four
scaled keep-masks at keep KP 0.8, m0, m1, m2, m3 of widths D 64, 64, 256
and 64 (the order of the JAX package's ``_draw_masks``), mask ids M0..M3
of ``ops/philox.py`` under the 64-bit seed ``SEED`` 777.  A mask element
is a pure function of (seed, mask id, row, position, channel), so the two
orders agree by construction; the probe holds the two device functions
that the chunked layer's kernels call (``csrc/common.cuh`` ``drop_mask4``
and ``drop_mask``) to the same bits:

  masks_forward   the kernel of ``csrc/probe_mask_replay_check.cu`` with one
                  block per (row block, data chunk), one Philox call per 4
                  channels
  masks_reversed  its kernel with one block per (row block, grid row y)
                  drawing the data chunk NC-1-y (the TPU grid's flipped
                  index map), each element drawn alone, four adjacent
                  channels a thread written as one 16-byte store

each on the card (``.launches`` counts the kernel's launches) and, given
the CPU, ``masks_plain``: ``philox.dropout_bits`` at each chunk's ``t0``
through ``philox.mask_of_bits`` (JAX's ``_dropout_mask`` past its
draw).  The order of a stateless draw cannot change its bits, so both
take ``masks_plain`` on the CPU.  Every size is an argument (the XLong
layer's: ``nb`` 64, ``nc`` 8, ``tc`` 128).  The threshold and scale come
from keep itself, as JAX's ``_dropout_mask`` computes them:
``philox.threshold_of_keep(keep)`` = min(int(keep 2^32), 2^32 - 1),
``philox.scale_of_keep(keep)`` = fp32(1 / keep).

    python -m datamining_recblr_torch.probes.mask_replay_check [--nb 2] [--nc 4] [--bt 8] [--tc 16] [--d 64] [--ff 256] [--device cuda|cpu]

prints the JAX probe's lines (m0's drop fraction against the configured
one, and whether the two orders agree bit for bit), each mask's drop
fraction and the two kernels' ms, under the card's name and power limit;
it exits non-zero if the orders differ, as the JAX probe's ``main``
asserts.
"""

from __future__ import annotations

import argparse

import torch

from datamining_recblr_torch.ops import _cuda, philox
from datamining_recblr_torch.probes import _bench

BT, TC, D, NB, NC = 8, 16, 64, 2, 4
KP = 0.8
SEED = 777
MASK_IDS = (philox.M0, philox.M1, philox.M2, philox.M3)


def widths(d=D, ff=4 * D):
    """The four masks' widths: m0, m1 and m3 of d, m2 (the FFN's inner
    activation) of ff."""
    return (d, d, ff, d)


def _sizes(nb, nc, bt, tc, d, ff):
    sizes = tuple(int(s) for s in (nb, nc, bt, tc, d, ff))
    nb, nc, bt, tc, d, ff = sizes
    if min(sizes) < 1 or d % 4 or ff % 4:
        raise ValueError(f"nb, nc, bt, tc must be positive and d, ff positive multiples of 4, "
                         f"got nb={nb} nc={nc} bt={bt} tc={tc} d={d} ff={ff}")
    if nb * bt * nc * tc >= 2**31 or bt * tc * ff >= 2**31 or nc >= 2**16:
        raise ValueError(f"{nb * bt} rows of {nc} chunks of {tc} exceed the kernels' int index")
    return sizes


def _check_keep(keep):
    if not 0.0 < float(keep) <= 1.0:
        raise ValueError(f"keep must be in (0, 1], got {keep}")


def masks_plain(seed=SEED, keep=KP, nb=NB, nc=NC, bt=BT, tc=TC, d=D, ff=4 * D, device="cpu"):
    """The four masks [nb bt, nc tc, width], each chunk drawn by
    ``philox.dropout_bits`` at its ``t0``."""
    _check_keep(keep)
    nb, nc, bt, tc, d, ff = _sizes(nb, nc, bt, tc, d, ff)
    return [torch.cat([philox.mask_of_bits(philox.dropout_bits(seed, mid, nb * bt, tc, w,
                                                                device, t0=j * tc), keep)
                       for j in range(nc)], dim=1)
            for mid, w in zip(MASK_IDS, widths(d, ff))]


def _launch(reversed_, seed, keep, nb, nc, bt, tc, d, ff, device):
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}; use cpu or cuda")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    outs = [torch.empty((nb * bt, nc * tc, w), dtype=torch.float32, device=device)
            for w in widths(d, ff)]
    lib = _cuda.library("probe_mask_replay_check.cu")
    with torch.cuda.device(device):
        err = lib.recblr_probe_masks(int(reversed_), *[o.data_ptr() for o in outs], nb, nc, bt,
                                     tc, d, ff, int(seed) & 0xFFFFFFFFFFFFFFFF,
                                     philox.threshold_of_keep(keep),
                                     philox.scale_of_keep(keep), device.index,
                                     _cuda.stream(outs[0]))
    _cuda.check(lib, err, "mask_reversed" if reversed_ else "mask_forward")
    return outs


def masks_forward(seed=SEED, keep=KP, nb=NB, nc=NC, bt=BT, tc=TC, d=D, ff=4 * D,
                  device="cuda"):
    """The four masks drawn by the forward-order kernel on a CUDA
    ``device``, by ``masks_plain`` on the CPU."""
    _check_keep(keep)
    nb, nc, bt, tc, d, ff = _sizes(nb, nc, bt, tc, d, ff)
    device = torch.device(device)
    if device.type == "cpu":
        return masks_plain(seed, keep, nb, nc, bt, tc, d, ff)
    outs = _launch(False, seed, keep, nb, nc, bt, tc, d, ff, device)
    masks_forward.launches += 1
    return outs


def masks_reversed(seed=SEED, keep=KP, nb=NB, nc=NC, bt=BT, tc=TC, d=D, ff=4 * D,
                   device="cuda"):
    """The four masks drawn by the reversed-order kernel on a CUDA
    ``device``, by ``masks_plain`` on the CPU."""
    _check_keep(keep)
    nb, nc, bt, tc, d, ff = _sizes(nb, nc, bt, tc, d, ff)
    device = torch.device(device)
    if device.type == "cpu":
        return masks_plain(seed, keep, nb, nc, bt, tc, d, ff)
    outs = _launch(True, seed, keep, nb, nc, bt, tc, d, ff, device)
    masks_reversed.launches += 1
    return outs


masks_forward.launches = 0
masks_reversed.launches = 0


def drop_fraction(mask):
    return float((mask == 0).float().mean())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    for name, default in (("nb", NB), ("nc", NC), ("bt", BT), ("tc", TC), ("d", D),
                          ("ff", 4 * D)):
        ap.add_argument(f"--{name}", type=int, default=default)
    _bench.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = _bench.resolve_device(args.device)
    sizes = dict(nb=args.nb, nc=args.nc, bt=args.bt, tc=args.tc, d=args.d, ff=args.ff)
    print(f"mask_replay_check rows={args.nb * args.bt} T={args.nc * args.tc} "
          f"chunk={args.tc} widths={widths(args.d, args.ff)} keep={KP}  [{_bench.card(dev)}]")
    a = masks_forward(SEED, KP, device=dev, **sizes)
    b = masks_reversed(SEED, KP, device=dev, **sizes)
    ok = all(bool(torch.equal(x, y)) for x, y in zip(a, b))
    drops = [drop_fraction(m) for m in a]
    print(f"drop fraction: {drops[0]:.3f} (configured {1 - KP:.1f})")
    print(f"fwd vs reversed-bwd masks bitwise equal: {ok}", flush=True)
    print("drop fraction by mask: " + " ".join(f"m{k} {f:.4f}" for k, f in enumerate(drops)))
    del a, b
    if not ok:
        raise SystemExit("mask_replay_check: the forward and reversed masks differ")
    ms = {order: _bench.time_calls(lambda fn=fn: fn(SEED, KP, device=dev, **sizes), dev, 20)
          for order, fn in (("forward", masks_forward), ("reversed", masks_reversed))}
    print(f"masks forward: {ms['forward']:.4f} ms   reversed: {ms['reversed']:.4f} ms",
          flush=True)
    return {"ok": ok, "drop": drops, "ms": ms}


if __name__ == "__main__":
    main()
