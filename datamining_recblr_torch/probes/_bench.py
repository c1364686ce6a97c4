"""What the probes share: the device an entry point runs on, the card's
name and power limit, the card's peaks, and a timer."""

from __future__ import annotations

import subprocess
import time

import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): bf16 and TF32 on the
# tensor cores, fp32 outside them, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def add_device_arg(ap) -> None:
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, default) or cpu (the plain versions)")


def resolve_device(name: str) -> torch.device:
    """The device an entry point runs on: the card unless ``cpu`` is
    asked for; without a card anything else raises (no fallback)."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card: the probe's kernels run only on one; "
                               "pass --device cpu for the plain versions")
        return torch.device("cuda", torch.cuda.current_device() if dev.index is None
                            else dev.index)
    if dev.type != "cpu":
        raise ValueError(f"no probe runs on {dev}; use cuda or cpu")
    return dev


def card(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or a note
    that the times are the host's."""
    if dev.type != "cuda":
        return "cpu: plain versions, host times (no card measured)"
    return subprocess.run(
        ["nvidia-smi", f"--id={dev.index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_chain(fn, x0, dev, iters, warmup=0):
    """Milliseconds a call of ``x = fn(x)`` chained ``iters`` times from
    ``x0`` after ``warmup`` chained calls: CUDA events on the card, the
    host's clock on the CPU."""
    x = x0
    for _ in range(warmup):
        x = fn(x)
    x = x0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            x = fn(x)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        x = fn(x)
    return (time.perf_counter() - t0) * 1e3 / iters


def time_calls(fn, dev, iters, warmup=2):
    """Milliseconds a call of ``fn()`` over ``iters`` calls after
    ``warmup``."""
    return time_chain(lambda _: fn(), None, dev, iters, warmup)
