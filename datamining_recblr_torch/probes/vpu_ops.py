"""What each elementwise op costs on the card's CUDA cores, in a
dependent chain.  Counterpart of ``benchmarks/vpu_ops.py`` (queue B row
17b), whose kernel (``make_fn``, ``pallas_call``) priced the v5e's VPU.

One block of ``SHAPE`` = [8, 512, 128] fp32; each element runs ``REPEAT``
= 64 dependent steps ``x <- op(x) * 0.9 + 0.05`` of one of the fourteen
``OPS``.  The ops are JAX's formulas in the forms the port's kernels
compute them (``csrc/common.cuh``): exp as exp2(x log2 e), sigmoid through
tanh (``ops/fastmath.py``), silu as x sigmoid(x), softplus as max(x, 0) +
log1p(exp(-|x|)).  ``make_fn(name)`` returns the chain: the kernel of
``csrc/probe_vpu_ops.cu`` on a CUDA tensor (one thread an element, the
step's multiply-add one fmaf), the plain PyTorch chain on a CPU tensor;
``SHAPE`` and ``REPEAT`` are read when it is called.  ``vpu_chain.launches``
counts the kernel's launches.

    python -m datamining_recblr_torch.probes.vpu_ops [--device cuda|cpu]

prints each op's us a call, ps an element-step and its ratio to ``mul``,
timed over 200 chained calls as the JAX probe's ``time_fn``, under the
card's name and power limit.  A call's device work is microseconds, so
the wrapper's host time and a launch's latency bound each line from below
(about 19 us a call on an H100 machine); ``chip_smoke.py`` reads each
kernel's device time with torch.profiler.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from datamining_recblr_torch.ops import _cuda, fastmath
from datamining_recblr_torch.probes import _bench

REPEAT = 64
SHAPE = (8, 512, 128)


def _softplus(x):
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


OPS = {
    "mul": lambda x: x * 1.0000001,
    "add": lambda x: x + 1e-7,
    "exp": fastmath.exp,
    "exp2": torch.exp2,
    "sigmoid": fastmath.sigmoid,
    "tanh": torch.tanh,
    "log": lambda x: torch.log(x.abs() + 1.0),
    "sqrt": lambda x: torch.sqrt(x.abs() + 1e-6),
    "rsqrt": lambda x: torch.rsqrt(x.abs() + 1e-6),
    "div": lambda x: 1.0 / (x + 1.7),
    "recip_mul": lambda x: x * (x + 1.7),
    "softplus": _softplus,
    "silu": fastmath.silu,
    "where": lambda x: torch.where(x > 0.5, x, x * 0.5),
}


def vpu_chain_plain(x, name, repeat):
    op = OPS[name]
    for _ in range(repeat):
        x = op(x) * 0.9 + 0.05
    return x


def vpu_chain(x, name, repeat):
    """``repeat`` steps ``x <- OPS[name](x) * 0.9 + 0.05`` on fp32 ``x``
    of any shape: the kernel on a CUDA tensor, the plain chain on a CPU
    tensor."""
    if name not in OPS:
        raise ValueError(f"unknown op {name!r}; one of {tuple(OPS)}")
    if x.dtype != torch.float32 or not x.is_contiguous() or x.numel() < 1 or repeat < 0:
        raise ValueError(f"x must be a non-empty contiguous float32 tensor and repeat >= 0, "
                         f"got {x.dtype} {tuple(x.shape)}, repeat {repeat}")
    if x.device.type == "cpu":
        return vpu_chain_plain(x, name, repeat)
    _cuda.require_cuda(x)
    if x.numel() >= 2**31:
        raise ValueError(f"x has {x.numel()} elements, beyond the kernel's int index")
    lib = _cuda.library("probe_vpu_ops.cu")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.recblr_probe_vpu_op(x.data_ptr(), out.data_ptr(), x.numel(),
                                      list(OPS).index(name), repeat, x.device.index,
                                      _cuda.stream(x))
    _cuda.check(lib, err, f"vpu_ops {name}")
    vpu_chain.launches += 1
    return out


vpu_chain.launches = 0


def make_fn(name):
    """The JAX probe's ``make_fn``: x [SHAPE] -> the op's chain of
    ``REPEAT`` steps (both read at call time)."""
    def fn(x):
        if tuple(x.shape) != tuple(SHAPE):
            raise ValueError(f"x must be {tuple(SHAPE)}, got {tuple(x.shape)}")
        return vpu_chain(x, name, REPEAT)

    return fn


def inputs(dev):
    """Uniform [0, 1) of ``SHAPE`` from ``np.random.default_rng(0)``."""
    return torch.tensor(np.random.default_rng(0).uniform(size=SHAPE), dtype=torch.float32,
                        device=dev)


def time_fn(fn, x, dev, iters=200):
    """ms a call over ``iters`` chained calls, after one warm call."""
    return _bench.time_chain(fn, x, dev, iters, warmup=1)


def measure(dev, iters=200):
    """Each op's ms a call, in ``OPS``' order, after one discarded run of
    the first (which would otherwise take the card's clock ramp)."""
    x = inputs(dev)
    time_fn(make_fn(next(iter(OPS))), x, dev, iters)
    return {name: time_fn(make_fn(name), x, dev, iters) for name in OPS}


def report(ms):
    """Print the JAX probe's lines; return ps an element-step by op."""
    n = int(np.prod(SHAPE)) * REPEAT
    per = {name: t * 1e-3 / n * 1e12 for name, t in ms.items()}
    for name, t in ms.items():
        print(f"{name:>10}: {t * 1e3:8.1f} us/call  {per[name]:6.2f} ps/elem  "
              f"{per[name] / per['mul']:5.2f}x mul", flush=True)
    return per


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    _bench.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = _bench.resolve_device(args.device)
    print(f"vpu_ops shape={tuple(SHAPE)} repeat={REPEAT}  [{_bench.card(dev)}]")
    ms = measure(dev)
    return {"ms": ms, "ps_per_elem": report(ms)}


if __name__ == "__main__":
    main()
