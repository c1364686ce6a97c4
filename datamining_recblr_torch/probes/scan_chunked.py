"""A flat and a two-level parallel scan of ``h_t = g_t h_{t-1} + x_t``
beside row 7's serial scan, on the card.  Counterpart of
``benchmarks/scan_chunked.py`` (queue B row 17c), whose kernels
``_kernel_flat`` (the JAX package's ``ops/pallas_scan.py`` ``_scan_body``)
and ``_kernel_chunk`` (``_scan_chunked``) ran through ``run``'s
``pallas_call``:

  flat   Hillis-Steele over T: ceil(log2 T) rounds of (x, f) <- (x_{t-d} f_t
         + x_t, f_{t-d} f_t), x_{t-d} = 0 and f_{t-d} = 1 below d
  chunk  a scan within each 8-wide chunk (local prefix and the gates'
         cumulative product), a Hillis-Steele scan over the T / 8 chunk
         carries, and out = local + carry_{k-1} * cumprod

at g, x [2,048, 200, 128] fp32.  ``scan_flat`` and ``scan_chunk`` are the
kernels of ``csrc/probe_scan_chunked.cu`` on CUDA tensors (a block a row
and 32 channels; flat: a warp per 32 positions held in registers, the 5
rounds of d < 32 there and the rest through shared memory, each round's
sums those of the flat scan above; chunk: a warp a chunk, its 8
positions scanned serially in registers, the carries' 5 rounds in shared
memory) and their plain versions on CPU tensors; each counts its
launches (``.launches``).  The chunk's plain
version scans within a chunk serially, as its kernel does; the JAX probe
does that in 3 Hillis-Steele rounds, the same sums in another order.
Row 7 (``ops/scan.py`` ``linear_scan``, one thread a (row, channel),
serial over T) is timed beside both: the port's own kernel.

    python -m datamining_recblr_torch.probes.scan_chunked [--device cuda|cpu]

checks the chunked scan against the serial oracle on 4 rows, then prints
the three times under the card's name and power limit.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from datamining_recblr_torch.ops import _cuda
from datamining_recblr_torch.ops import scan as SC
from datamining_recblr_torch.probes import _bench

B, T, C = 2048, 200, 128
CHUNK = 8
FLAT_MAX_T = 512   # 16 warps of 32 positions a thread
CHUNK_MAX_T = 256  # T / 8 warps of 32 lanes a block
WHICH = ("flat", "chunk", "serial")


def scan_flat_plain(g, x):
    """Hillis-Steele inclusive scan along axis 1 of [B, T, C]."""
    t = x.shape[1]
    f = g
    d = 1
    while d < t:
        xl = torch.cat([torch.zeros_like(x[:, :d]), x[:, :-d]], dim=1)
        fl = torch.cat([torch.ones_like(f[:, :d]), f[:, :-d]], dim=1)
        x = xl * f + x
        f = fl * f
        d *= 2
    return x


def scan_chunk_plain(g, x, chunk=CHUNK):
    """Two-level scan: serial within ``chunk``-wide chunks, Hillis-Steele
    over the chunk carries, then the combine."""
    b, t, c = x.shape
    if t % chunk:
        raise ValueError(f"T = {t} is no multiple of the chunk {chunk}")
    x4 = x.reshape(b, t // chunk, chunk, c)
    g4 = g.reshape(b, t // chunk, chunk, c)
    h = torch.zeros_like(x4[:, :, 0])
    p = torch.ones_like(h)
    loc, cum = [], []
    for i in range(chunk):
        h = g4[:, :, i] * h + x4[:, :, i]
        p = p * g4[:, :, i]
        loc.append(h)
        cum.append(p)
    loc = torch.stack(loc, dim=2)
    cum = torch.stack(cum, dim=2)
    carries = scan_flat_plain(cum[:, :, -1], loc[:, :, -1])
    prev = torch.cat([torch.zeros_like(carries[:, :1]), carries[:, :-1]], dim=1)
    return (prev[:, :, None] * cum + loc).reshape(b, t, c)


def _checks(g, x, limit, what):
    if x.dim() != 3 or tuple(g.shape) != tuple(x.shape):
        raise ValueError(f"g and x must both be [B, T, C], got {tuple(g.shape)} and "
                         f"{tuple(x.shape)}")
    for name, v in (("g", g), ("x", x)):
        if v.dtype != torch.float32 or not v.is_contiguous() or v.device != x.device:
            raise ValueError(f"{name} must be contiguous float32 on {x.device}, got {v.dtype} "
                             f"on {v.device}")
    b, t, c = x.shape
    if x.device.type != "cpu" and (b < 1 or t < 1 or t > limit or c < 32 or c % 32
                                   or b * c >= 2**31):
        raise ValueError(f"the {what} kernel takes T <= {limit} and C a multiple of 32, got "
                         f"B={b} T={t} C={c}")


def _launch(g, x, chunk):
    b, t, c = x.shape
    lib = _cuda.library("probe_scan_chunked.cu")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.recblr_probe_scan(g.data_ptr(), x.data_ptr(), out.data_ptr(), b, t, c,
                                    int(chunk), x.device.index, _cuda.stream(x))
    _cuda.check(lib, err, "scan_chunk" if chunk else "scan_flat")
    return out


def scan_flat(g, x):
    """The flat Hillis-Steele scan of [B, T, C] fp32: the kernel on a CUDA
    tensor (T <= 512, C a multiple of 32), the plain version on a CPU one."""
    _checks(g, x, FLAT_MAX_T, "flat")
    if x.device.type == "cpu":
        return scan_flat_plain(g, x)
    _cuda.require_cuda(x)
    out = _launch(g, x, False)
    scan_flat.launches += 1
    return out


def scan_chunk(g, x):
    """The two-level scan of [B, T, C] fp32: the kernel on a CUDA tensor
    (T a multiple of 8 up to 256, C a multiple of 32), the plain version
    on a CPU one."""
    _checks(g, x, CHUNK_MAX_T, "chunk")
    if x.shape[1] % CHUNK:
        raise ValueError(f"T = {x.shape[1]} is no multiple of the chunk {CHUNK}")
    if x.device.type == "cpu":
        return scan_chunk_plain(g, x)
    _cuda.require_cuda(x)
    out = _launch(g, x, True)
    scan_chunk.launches += 1
    return out


scan_flat.launches = 0
scan_chunk.launches = 0


def scan(g, x, which):
    """h [B, T, C] by ``which``: "flat", "chunk", or "serial" (row 7's
    ``linear_scan``)."""
    if which == "flat":
        return scan_flat(g, x)
    if which == "chunk":
        return scan_chunk(g, x)
    if which == "serial":
        return SC.linear_scan(g, x)
    raise ValueError(f"unknown scan {which!r}; one of {WHICH}")


def run(g, x, which):
    """The JAX probe's ``run``: the sum of h at the last position."""
    return torch.sum(scan(g, x, which)[:, -1])


def serial_oracle(g, x):
    """The JAX probe's numpy oracle, in fp32."""
    g, x = np.asarray(g, np.float32), np.asarray(x, np.float32)
    h = np.zeros_like(x)
    acc = np.zeros((x.shape[0], x.shape[2]), np.float32)
    for t in range(x.shape[1]):
        acc = g[:, t] * acc + x[:, t]
        h[:, t] = acc
    return h


def inputs(dev, b=None):
    """g uniform in [0.9, 0.999) and x normal, [b (default B), T, C], from
    ``np.random.default_rng(0)``."""
    b = B if b is None else b
    rng = np.random.default_rng(0)
    g = rng.uniform(0.9, 0.999, size=(b, T, C)).astype(np.float32)
    x = rng.normal(size=(b, T, C)).astype(np.float32)
    return torch.from_numpy(g).to(dev), torch.from_numpy(x).to(dev)


def measure(g, x, dev, steps=30):
    """ms a scan by ``which`` (``steps`` calls after two)."""
    return {w: _bench.time_calls(lambda w=w: scan(g, x, w), dev, steps) for w in WHICH}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    _bench.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = _bench.resolve_device(args.device)
    print(f"scan_chunked B={B} T={T} C={C}  [{_bench.card(dev)}]")
    g, x = inputs(dev)
    got = scan_chunk(g[:4].contiguous(), x[:4].contiguous())
    np.testing.assert_allclose(got.cpu().numpy(), serial_oracle(g[:4].cpu(), x[:4].cpu()),
                               rtol=2e-4, atol=2e-5)
    print("chunked correct vs serial oracle")
    ms = measure(g, x, dev)
    print(f"flat H-S  : {ms['flat']:.3f} ms")
    print(f"chunked   : {ms['chunk']:.3f} ms   ({ms['flat'] / ms['chunk']:.2f}x)")
    print(f"serial (row 7 linear_scan): {ms['serial']:.3f} ms   "
          f"({ms['flat'] / ms['serial']:.2f}x)", flush=True)
    return {"ms": ms}


if __name__ == "__main__":
    main()
