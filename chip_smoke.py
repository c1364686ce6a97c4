#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's ten CUDA kernels from ``datamining_recblr_torch/csrc``
(both fused recurrent layers of RecBLR, forward and backward; the
attention baselines' LN prologue and both transformer layers, forward
and backward) and, phase by phase:

* holds each kernel against its plain PyTorch version at B 256, T 200:
  the RecBLR forwards at dropout 0 (serving), then every RecBLR kernel's
  output and gradients against autograd of the plain versions, fp32 and
  bf16, at dropout 0 and 0.2, and the kernels' dropout mask bit for bit;
  then the three attention forwards, fp32 and bf16, causal and
  bidirectional, two activations, lengths 0, 1 and T; then their
  outputs, dx, dpos and every weight grad against autograd of the plain
  versions at dropout 0 and 0.5, and each of their masks bit for bit;
* serves RecBLR, SASRec and BERT4Rec at full width (hidden 64, 2 layers,
  T 200, V 3,417; 2 heads and an FFN of 256 for the baselines) through
  ``Recommender.recommend`` against the same model through the plain
  versions, with one launch of each of the model's kernels per call,
  and times it;
* trains RecBLR (dropout 0.2) and SASRec (dropout 0.5 / 0.5) at the
  bench.py shape (batch 2,048, CE, Adam, fp32 and bf16 compute): one
  launch of each of the model's kernels per step, one step against the
  same step through the plain versions, the step time and a profile;
* runs ``Trainer.fit`` and ``evaluate(load_best=True)`` for both on a
  small Markov dataset: the loss falls and valid NDCG@10 is above 0;
* times every kernel beside its bound, its plain version and, where one
  PyTorch call computes the same function, that call.

Each phase prints one line; any failure exits non-zero.  The line before
the last is the kernels' JSON record, the last line the device JSON.
Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from datamining_recblr_torch.config import Config
from datamining_recblr_torch.models import get_model
from datamining_recblr_torch.models import layers as L
from datamining_recblr_torch.ops import _cuda
from datamining_recblr_torch.ops import fused_block as FB
from datamining_recblr_torch.ops import fused_layer as FL
from datamining_recblr_torch.serve import Recommender

SEED = 0
B, T, D, C, K, FF = 256, 200, 64, 128, 4, 256  # serving shape
HEADS, INNER = 2, 256  # the attention baselines' serving shape (bench.py)
N_ITEMS, TOP_K = 3417, 10
# H100 SXM peaks (NVIDIA data sheet, 700 W): fp32 outside the tensor
# cores and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
FP32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_RTOL = 2.0 ** -7  # one bf16 ulp of the value, at most
# the transformer-layer kernels in bf16: one bf16 ulp of the value plus
# 2^-9 of the largest value (an operand rounded to the other bf16
# neighbour after an fp32 sum in another order, times a weight)
ATTN_BF16_ABS = 2.0 ** -9
# gradients: max |kernel - plain| over max |plain|; fp32 FMA sums in
# another order than cuBLAS and autograd, over up to B*T = 409,600 terms
GRAD_RTOL = 1e-4
DROPOUT = 0.2  # RecBLR's dropout_prob
TRAIN_B = 2048  # bench.py's training batch
TRAIN_STEPS = 20
FIT_EPOCHS = 3
# the kernels of the training step, whose launches it counts
LAUNCH_COUNTED = (FL.fused_recurrent_layer, FL.fused_recurrent_layer_last,
                  FL.fused_recurrent_layer_bwd, FL.fused_recurrent_layer_last_bwd)
# the kernels of the attention baselines' serving path, one launch each
# per recommend()
ATTN_COUNTED = (FL.fused_ln_dropout, FB.fused_transformer_layer,
                FB.fused_transformer_layer_last)
# SASRec's training step: those three and their backwards
SAS_COUNTED = ATTN_COUNTED + (FL.fused_ln_dropout_bwd, FB.fused_transformer_layer_bwd,
                              FB.fused_transformer_layer_last_bwd)
SAS_DROPOUT = 0.5  # SASRec's hidden_dropout_prob and attn_dropout_prob


class SmokeFailure(RuntimeError):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def phase(name, **fields):
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def layer_params(gen, dev, prologue):
    def r(*s, std=0.05):
        return (std * torch.randn(s, generator=gen)).to(dev)

    p = {
        "w_in": r(D, 2 * C), "wc": r(K, C, std=0.5), "bc": r(C, std=0.5),
        "wg": r(C, 2 * C), "bg": r(2 * C),
        "lam": torch.linspace(-2.2, -6.9, C).to(dev),
        "w_out": r(C, D), "ln1_s": 1 + r(D), "ln1_b": r(D),
        "w1": r(D, FF), "b1": r(FF), "w2": r(FF, D), "b2": r(D),
        "ln2_s": 1 + r(D), "ln2_b": r(D),
    }
    if prologue:
        p.update(pl_s=1 + r(D), pl_b=r(D))
    return p


def block_params(gen, dev):
    """One transformer layer's weights (fused_block PARAM_NAMES); Q and K
    wider than the rest so that attention is far from uniform."""
    def r(*s, std=0.05):
        return (std * torch.randn(s, generator=gen)).to(dev)

    p = {}
    for n in "qkvo":
        p[f"w_{n}"], p[f"b_{n}"] = r(D, D, std=0.2 if n in "qk" else 0.05), r(D)
    p.update(ln1_s=1 + r(D), ln1_b=r(D), w1=r(D, INNER), b1=r(INNER), w2=r(INNER, D),
             b2=r(D), ln2_s=1 + r(D), ln2_b=r(D))
    return p


def serving_lens(gen, b):
    lens = torch.randint(0, T + 1, (b,), generator=gen)
    lens[:3] = torch.tensor([0, 1, T])[: min(3, b)]
    return lens


# ---------------------------------------------------------------------------
# bounds: fp32 matmul, conv and scan operations (2 per multiply-add) over
# the fp32 peak, and bytes read once / written once over HBM bandwidth
# ---------------------------------------------------------------------------

def _params_bytes(p):
    return sum(v.numel() * v.element_size() for v in p.values())


def _bound(flops, nbytes):
    """(bound ms, FLOPs, what bounds it)."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, flops, "operations" if t_ops >= t_bytes else "bytes"


def k1_bound_ms(b, t, p, act_bytes):
    per_pos = 2 * D * 2 * C + 2 * K * C + 2 * C * 2 * C + 2 * C + 2 * C * D + 4 * D * FF
    flops = b * t * per_pos
    nbytes = 2 * b * t * D * act_bytes + _params_bytes(p)
    return _bound(flops, nbytes)


def k2_bound_ms(lens, p, act_bytes):
    # the output reads the scan at position len-1 only, so positions at
    # or beyond a row's length are work this data does not need
    n = lens.clamp(0, T).where((lens >= 1) & (lens <= T), torch.zeros_like(lens))
    positions = int(n.sum())
    b = lens.numel()
    per_pos = 2 * D * C + 2 * K * C + 2 * C * 2 * C + 2 * C
    per_row = 2 * D * C + 2 * C * D + 4 * D * FF
    flops = positions * per_pos + b * per_row
    nbytes = positions * D * act_bytes + b * 4 + b * D * act_bytes + _params_bytes(p)
    return _bound(flops, nbytes)


def ln_bound_ms(b, act_bytes):
    # x read and out written once, pos [T, D] and scale, bias [D]; about 8
    # operations per element (add, mean, centre, square-sum, scale, shift)
    nbytes = 2 * b * T * D * act_bytes + T * D * 4 + 2 * D * 4
    return _bound(8 * b * T * D, nbytes)


def _kept_keys(lens, t):
    """Per row, the keys a query can weigh: those below the length (all T
    where the length is 0, since an all-masked row averages every key)."""
    n = lens.clamp(0, t)
    return torch.where(n == 0, torch.full_like(n, t), n)


def block_bound_ms(lens, t, causal, p, act_bytes, stash=False):
    # QKV, W_o and the FFN at every position; QK^T and P.V (4D per pair
    # over all heads) only for the query-key pairs whose probability this
    # data can make non-zero: keys below the length, and not after the
    # query when causal.  A training forward also writes q/k/v and the
    # context (4D fp32 per position).
    n = _kept_keys(lens, t).double()
    if causal:
        pairs = torch.where(lens.clamp(0, t) == 0, n * t, n * (n + 1) / 2 + (t - n) * n)
    else:
        pairs = n * t
    b = lens.numel()
    flops = b * t * (8 * D * D + 4 * D * INNER) + 4 * D * float(pairs.sum())
    nbytes = b * t * D * (2 * act_bytes + (16 if stash else 0)) + b * 4 + _params_bytes(p)
    return _bound(flops, nbytes)


def block_bwd_bound_ms(lens, t, causal, p, act_bytes):
    # about twice the forward's products (two gradient products per
    # forward product); x, dout and dx, the kept q/k/v and context read
    # once, the params read and their grads written
    flops = 2 * block_bound_ms(lens, t, causal, p, act_bytes)[1]
    b = lens.numel()
    nbytes = b * t * D * (3 * act_bytes + 16) + b * 4 + 2 * _params_bytes(p)
    return _bound(flops, nbytes)


def _last_positions(lens, t):
    # the positions a last-query row weighs (lengths 0 or above T select no
    # query and weigh every key)
    return torch.where((lens >= 1) & (lens <= t), lens, torch.full_like(lens, t)).double()


def block_last_bound_ms(lens, t, p, act_bytes, stash=False):
    # per row: the query, W_o and the FFN once; K and V projections and
    # QK^T, P.V at the positions its one query weighs.  A training forward
    # also writes k/v there (2D fp32) and the [B, D] context.
    n = float(_last_positions(lens, t).sum())
    b = lens.numel()
    flops = b * (4 * D * D + 4 * D * INNER) + n * (4 * D * D + 4 * D)
    nbytes = n * D * act_bytes + b * D * act_bytes + b * 4 + _params_bytes(p)
    if stash:
        nbytes += n * 2 * D * 4 + b * D * 4
    return _bound(flops, nbytes)


def block_last_bwd_bound_ms(lens, t, p, act_bytes):
    # twice the forward's products; x and the kept k/v at the weighed
    # positions, dout and the context per row read, dx [B, T, D] written
    # in full, the params read and their grads written
    flops = 2 * block_last_bound_ms(lens, t, p, act_bytes)[1]
    n = float(_last_positions(lens, t).sum())
    b = lens.numel()
    nbytes = (n * D * (act_bytes + 8) + b * t * D * act_bytes + b * D * (act_bytes + 4)
              + b * 4 + 2 * _params_bytes(p))
    return _bound(flops, nbytes)


def ln_bwd_bound_ms(b, act_bytes):
    # x, dout read and dx written once; pos read and dpos written; about
    # 16 operations per element (the LN recomputed and its backward)
    nbytes = 3 * b * T * D * act_bytes + 2 * T * D * 4 + 4 * D * 4
    return _bound(16 * b * T * D, nbytes)


def time_ms(fn, reps=20, warmup=3):
    """Median of ``reps`` single-call CUDA-event timings."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def environment():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    phase("env", python=sys.version.split()[0], torch=torch.__version__,
          cuda=torch.version.cuda, device=repr(torch.cuda.get_device_name(0)),
          count=torch.cuda.device_count())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase("tf32", matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
          cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    t0 = time.perf_counter()
    per_source = _cuda.build()
    phase("build", seconds=f"{time.perf_counter() - t0:.1f}",
          **{k: f"{v:.1f}s" for k, v in per_source.items()})
    for src, log in _cuda.BUILD_LOGS.items():
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", log)]
        spills = [int(w) for w in re.findall(r"(\d+) bytes spill stores", log)]
        phase("ptxas", source=src, kernels=len(regs), max_registers=max(regs, default=0),
              spill_store_bytes=sum(spills))
    return smi


def _bf16_ok(got, want):
    g, w = got.float(), want.float()
    return bool(((g - w).abs() <= BF16_RTOL * w.abs() + 1e-4).all())


def kernels_vs_plain(dev):
    gen = torch.Generator().manual_seed(SEED)
    p1 = layer_params(gen, dev, prologue=True)
    p2 = layer_params(gen, dev, prologue=False)
    x = torch.randn((B, T, D), generator=gen).to(dev)
    lens = serving_lens(gen, B).to(dev)
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        xd = x.to(dt)
        cases = {
            "fused_recurrent_layer": (
                FL.fused_recurrent_layer(xd, p1, prologue=True),
                FL.fused_recurrent_layer_plain(xd, p1, prologue=True)),
            "fused_recurrent_layer_last": (
                FL.fused_recurrent_layer_last(xd, lens, p2),
                FL.fused_recurrent_layer_last_plain(xd, lens, p2)),
        }
        torch.cuda.synchronize()
        for name, (got, want) in cases.items():
            check(got.dtype == dt and got.shape == want.shape, f"{name} {dt}: shape/dtype")
            check(bool(torch.isfinite(got).all()), f"{name} {dt}: non-finite output")
            err = (got.float() - want.float()).abs().max().item()
            if dt == torch.float32:
                ok = torch.allclose(got, want, **FP32_TOL)
                tol = f"atol {FP32_TOL['atol']} rtol {FP32_TOL['rtol']}"
                errs[name] = err
            else:
                ok = _bf16_ok(got, want)
                tol = f"|err| <= 2^-7*|plain| + 1e-4"
            phase("kernel-vs-plain", kernel=name, dtype=str(dt).split(".")[-1],
                  shape=f"B{B}xT{T}xD{D}", max_abs_err=f"{err:.3e}", tol=repr(tol),
                  ok=ok)
            check(ok, f"{name} {dt}: kernel disagrees with its plain version")
    return p1, p2, lens, errs


def _grad_err_ok(got, want, dtype, is_dx):
    """(max |kernel - plain| / max |plain|, ok).  fp32 and every weight
    grad (fp32 on both sides): within GRAD_RTOL of the largest value;
    a bf16 dx: one bf16 ulp of the value on top of that."""
    g, w = got.float(), want.float()
    scale = float(w.abs().max()) or 1.0
    err = float((g - w).abs().max()) / scale
    if dtype == torch.bfloat16 and is_dx:
        ok = bool(((g - w).abs() <= BF16_RTOL * w.abs() + GRAD_RTOL * scale).all())
    else:
        ok = err <= GRAD_RTOL
    return err, ok


def _plain_vjp(fn, x, params, dout):
    """Output, dx and {name: grad} of a plain version by autograd."""
    xl = x.detach().clone().requires_grad_()
    pl = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    out = fn(xl, pl)
    names = list(pl)
    gs = torch.autograd.grad(out, [xl] + [pl[n] for n in names], dout)
    return out.detach(), gs[0], dict(zip(names, gs[1:]))


def train_lens(gen, b):
    lens = torch.randint(1, T + 1, (b,), generator=gen)
    lens[:4] = torch.tensor([0, 1, T, T + 5])  # 0 and T + 5 select nothing
    return lens


def training_kernels_vs_plain(dev):
    """Each kernel's output and every gradient against its plain version
    by autograd, fp32 and bf16, p = 0 and p = 0.2, at B = 256, T = 200.
    Returns the largest fp32 |kernel - plain| of each forward (output)
    and backward (dx and every grad)."""
    gen = torch.Generator().manual_seed(SEED + 2)
    p1 = layer_params(gen, dev, prologue=True)
    p2 = layer_params(gen, dev, prologue=False)
    x = torch.randn((B, T, D), generator=gen).to(dev)
    lens = train_lens(gen, B).to(dev)
    d1 = torch.randn((B, T, D), generator=gen).to(dev)
    d2 = torch.randn((B, D), generator=gen).to(dev)
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        for p in (0.0, DROPOUT):
            xd, dout1, dout2 = x.to(dt), d1.to(dt), d2.to(dt)
            seed = 1234567 + int(p * 10)
            out1, saved1 = FL.fused_recurrent_layer_train(xd, p1, True, True, True, p, seed)
            dx1, g1 = FL.fused_recurrent_layer_bwd(xd, dout1, p1, True, True, True, p, seed,
                                                   saved=saved1)
            out2, saved2 = FL.fused_recurrent_layer_last_train(xd, lens, p2, True, True, p,
                                                               seed)
            dx2, g2 = FL.fused_recurrent_layer_last_bwd(xd, lens, dout2, p2, True, True, p,
                                                        seed, saved=saved2)
            want1 = _plain_vjp(lambda a, q: FL.fused_recurrent_layer_plain(
                a, q, True, True, True, p, seed), xd, p1, dout1)
            want2 = _plain_vjp(lambda a, q: FL.fused_recurrent_layer_last_plain(
                a, lens, q, True, True, p, seed), xd, p2, dout2)
            torch.cuda.synchronize()
            tag = dict(dtype=str(dt).split(".")[-1], p=p)
            for name, out, dx, grads, (wout, wdx, wgrads) in (
                ("fused_recurrent_layer", out1, dx1, g1, want1),
                ("fused_recurrent_layer_last", out2, dx2, g2, want2),
            ):
                ok_out = (torch.allclose(out, wout, **FP32_TOL) if dt == torch.float32
                          else _bf16_ok(out, wout))
                check(bool(torch.isfinite(dx).all()), f"{name} bwd {tag}: non-finite dx")
                rows = {"dx": _grad_err_ok(dx, wdx, dt, True)}
                rows.update({k: _grad_err_ok(v, wgrads[k], dt, False)
                             for k, v in grads.items()})
                ok = ok_out and all(o for _, o in rows.values())
                phase("train-kernel-vs-plain", kernel=name + "_bwd", **tag,
                      shape=f"B{B}xT{T}xD{D}",
                      out_max_abs_err=f"{(out.float() - wout.float()).abs().max().item():.3e}",
                      rel_err=repr({k: float(f"{e:.3e}") for k, (e, _) in rows.items()}),
                      tol=f"max|err|/max|plain| <= {GRAD_RTOL}"
                          + (" (bf16 dx: + 2^-7*|plain|)" if dt == torch.bfloat16 else ""),
                      ok=ok)
                check(ok, f"{name} bwd {tag}: kernel disagrees with its plain version")
                if dt == torch.float32:
                    # max |kernel - plain|: the output, then dx and every grad
                    fwd = float((out - wout).abs().max())
                    bwd = max(float((v - w).abs().max()) for v, w in
                              [(dx, wdx)] + [(g, wgrads[k]) for k, g in grads.items()])
                    errs[name] = max(errs.get(name, 0.0), fwd)
                    errs[name + "_bwd"] = max(errs.get(name + "_bwd", 0.0), bwd)
    return errs


def mask_bits(dev):
    """The kernels' dropout masks against the plain Philox masks, bit for
    bit.  With W_in = 0 and the FFN off, K1's dx is LN_pl'(dv1) * m0, so
    it is 0 exactly where the prologue mask drops.  The masks m1-m3 of
    both layers enter every value the train-kernel-vs-plain phase
    compares at p = 0.2, where one flipped bit moves a value by far more
    than its tolerance."""
    from datamining_recblr_torch.ops import philox

    gen = torch.Generator().manual_seed(SEED + 3)
    p1 = layer_params(gen, dev, prologue=True)
    p1 = {k: v for k, v in p1.items() if k not in ("w1", "b1", "w2", "b2", "ln2_s", "ln2_b")}
    p1["w_in"] = torch.zeros_like(p1["w_in"])
    x = torch.randn((B, T, D), generator=gen).to(dev)
    dout = torch.randn((B, T, D), generator=gen).to(dev)
    seed = 987654321
    _, saved = FL.fused_recurrent_layer_train(x, p1, True, False, True, DROPOUT, seed)
    dx, _ = FL.fused_recurrent_layer_bwd(x, dout, p1, True, False, True, DROPOUT, seed,
                                         saved=saved)
    want = philox.dropout_mask(seed, philox.M0, B, T, D, DROPOUT, dev) > 0
    got = dx != 0
    flips = int((got != want).sum())
    phase("mask-bits", mask="m0 (K1 prologue)", elements=want.numel(),
          keep_fraction=f"{float(want.float().mean()):.5f}", mismatches=flips)
    check(flips == 0, f"m0: {flips} mask bits differ from the plain Philox mask")
    return flips


def _attn_ok(got, want, dtype, floor=0.0):
    """(max |kernel - plain|, ok) of an attention kernel's output or
    gradient: fp32 within GRAD_RTOL (1e-4) of the largest plain value;
    bf16 within one bf16 ulp of the value plus ATTN_BF16_ABS of the
    largest (an operand rounded to the other bf16 neighbour).  The
    absolute tolerance is at least ``floor`` (b_k's gradient is zero up
    to rounding: the softmax ignores a shift that every key shares)."""
    g, w = got.float(), want.float()
    scale = float(w.abs().max())
    diff = (g - w).abs()
    err = float(diff.max())
    if dtype == torch.float32:
        return err, err <= max(GRAD_RTOL * scale, floor)
    return err, bool((diff <= BF16_RTOL * w.abs() + max(ATTN_BF16_ABS * scale, floor)).all())


def attn_kernels_vs_plain(dev):
    """The attention baselines' three kernels against their plain versions
    at B = 256, T = 200, fp32 and bf16, lengths with 0, 1 and T; the layer
    causal and bidirectional, two activations.  Returns the largest fp32
    |kernel - plain| of each."""
    gen = torch.Generator().manual_seed(SEED + 5)
    p = block_params(gen, dev)
    x = torch.randn((B, T, D), generator=gen).to(dev)
    pos = (0.5 * torch.randn((T, D), generator=gen)).to(dev)
    lens = serving_lens(gen, B).to(dev)
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        xd = x.to(dt)
        args = (xd, pos, p["ln1_s"], p["ln1_b"])
        cases = [("fused_ln_dropout", "", FL.fused_ln_dropout(*args),
                  FL.fused_ln_dropout_plain(*args))]
        for act in ("gelu", "relu"):
            for causal in (True, False):
                cases.append((
                    "fused_transformer_layer", f"causal={causal} act={act}",
                    FB.fused_transformer_layer(xd, lens, p, causal, HEADS, act),
                    FB.fused_transformer_layer_plain(xd, lens, p, causal, HEADS, act)))
            cases.append((
                "fused_transformer_layer_last", f"act={act}",
                FB.fused_transformer_layer_last(xd, lens, p, HEADS, act),
                FB.fused_transformer_layer_last_plain(xd, lens, p, HEADS, act)))
        torch.cuda.synchronize()
        for name, tag, got, want in cases:
            check(got.dtype == dt and got.shape == want.shape, f"{name} {dt}: shape/dtype")
            check(bool(torch.isfinite(got).all()), f"{name} {dt} {tag}: non-finite output")
            err, ok = _attn_ok(got, want, dt)
            if dt == torch.float32:
                errs[name] = max(errs.get(name, 0.0), err)
            tol = ("max|err| <= 1e-4*max|plain|" if dt == torch.float32 else
                   f"|err| <= 2^-7*|plain| + 2^-9*max|plain|")
            phase("attn-kernel-vs-plain", kernel=name, case=repr(tag),
                  dtype=str(dt).split(".")[-1], shape=f"B{B}xT{T}xD{D}", heads=HEADS,
                  max_abs_err=f"{err:.3e}", max_abs_plain=f"{float(want.float().abs().max()):.3f}",
                  tol=repr(tol), ok=ok)
            check(ok, f"{name} {dt} {tag}: kernel disagrees with its plain version")
    return errs


def attn_train_kernels_vs_plain(dev):
    """The attention kernels' training forwards and backwards against
    autograd of their plain versions at B = 256, T = 200, fp32 and bf16,
    p = 0 and 0.5, lengths with 0, 1 and T: the prologue (dx, dpos,
    dscale, dbias), the layer causal and bidirectional, the last-query
    layer.  Returns the largest fp32 |kernel - plain| of each forward
    (output) and backward (dx and every grad)."""
    gen = torch.Generator().manual_seed(SEED + 8)
    p = block_params(gen, dev)
    x = torch.randn((B, T, D), generator=gen).to(dev)
    pos = (0.5 * torch.randn((T, D), generator=gen)).to(dev)
    lens = serving_lens(gen, B).to(dev)
    d3 = torch.randn((B, T, D), generator=gen).to(dev)
    d2 = torch.randn((B, D), generator=gen).to(dev)
    lp = {"pos": pos, "scale": p["ln1_s"], "bias": p["ln1_b"]}
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        for pd in (0.0, SAS_DROPOUT):
            xd, dout3, dout2 = x.to(dt), d3.to(dt), d2.to(dt)
            seed = 7654321 + int(pd * 10)
            drop = (pd, pd, seed)
            cases = []
            xl = xd.clone().requires_grad_()
            ql = {k: v.clone().requires_grad_() for k, v in lp.items()}
            out = FL.fused_ln_dropout(xl, ql["pos"], ql["scale"], ql["bias"], pd, seed)
            out.backward(dout3)
            cases.append(("fused_ln_dropout", "", out.detach(), xl.grad,
                          {k: v.grad for k, v in ql.items()},
                          _plain_vjp(lambda a, q: FL.fused_ln_dropout_plain(
                              a, q["pos"], q["scale"], q["bias"], pd, seed), xd, lp, dout3)))
            for causal in (True, False):
                out, saved = FB.fused_transformer_layer_train(xd, lens, p, causal, HEADS,
                                                               "gelu", *drop)
                dx, g = FB.fused_transformer_layer_bwd(xd, lens, dout3, p, causal, HEADS,
                                                       "gelu", *drop, saved=saved)
                cases.append(("fused_transformer_layer", f"causal={causal}", out, dx, g,
                              _plain_vjp(lambda a, q: FB.fused_transformer_layer_plain(
                                  a, lens, q, causal, HEADS, "gelu", *drop), xd, p, dout3)))
            out, saved = FB.fused_transformer_layer_last_train(xd, lens, p, HEADS, "gelu", *drop)
            dx, g = FB.fused_transformer_layer_last_bwd(xd, lens, dout2, p, HEADS, "gelu", *drop,
                                                        saved=saved)
            cases.append(("fused_transformer_layer_last", "", out, dx, g,
                          _plain_vjp(lambda a, q: FB.fused_transformer_layer_last_plain(
                              a, lens, q, HEADS, "gelu", *drop), xd, p, dout2)))
            torch.cuda.synchronize()
            tag = dict(dtype=str(dt).split(".")[-1], p=pd)
            for name, case, out, dx, grads, (wout, wdx, wgrads) in cases:
                check(bool(torch.isfinite(dx).all()), f"{name} bwd {tag}: non-finite dx")
                pairs = {"out": (out, wout), "dx": (dx, wdx)}
                pairs.update({k: (v, wgrads[k]) for k, v in grads.items()})
                top = max(float(w.float().abs().max()) for _, w in pairs.values())
                rows = {}
                for k, (v, w) in pairs.items():
                    err, ok_k = _attn_ok(v, w, dt, 1e-6 * top)
                    rows[k] = (err / (float(w.float().abs().max()) or 1.0), ok_k)
                ok = all(o for _, o in rows.values())
                worst = max(rows, key=lambda k: rows[k][0] if k != "b_k" else 0.0)
                phase("attn-train-kernel-vs-plain", kernel=name + "_bwd", case=repr(case), **tag,
                      shape=f"B{B}xT{T}xD{D}", worst=worst, worst_rel_err=f"{rows[worst][0]:.3e}",
                      rel_err=repr({k: float(f"{e:.2e}") for k, (e, _) in rows.items()}),
                      tol=("max|err| <= 1e-4*max|plain|" if dt == torch.float32 else
                           "|err| <= 2^-7*|plain| + 2^-9*max|plain|")
                      + ", at least 1e-6*max over all grads", ok=ok)
                check(ok, f"{name} bwd {tag} {case}: kernel disagrees with its plain version")
                if dt == torch.float32:
                    fwd = float((out.float() - wout.float()).abs().max())
                    bwd = max(float((v.float() - w.float()).abs().max())
                              for k, (v, w) in pairs.items() if k != "out")
                    errs[name] = max(errs.get(name, 0.0), fwd)
                    errs[name + "_bwd"] = max(errs.get(name + "_bwd", 0.0), bwd)
    return errs


def attn_mask_bits(dev):
    """Each attention mask as a kernel draws it, bit for bit against the
    plain Philox mask (``philox.dropout_mask``): the prologue's M0 from
    its output with scale 0 and bias 1 (the output is the mask); M1
    (after W_o) and M3 (after the FFN) from the sign of a layer output
    whose only signal is that mask (x = 0, every weight 0, b_o or b2 one);
    each head's probability mask from the context a training forward
    keeps, with x[j] = e_j and v_h the identity on T = dh = 32 keys; the
    last-query layer's at each row's position lens - 1."""
    from datamining_recblr_torch.ops import philox

    zeros = lambda *s: torch.zeros(s, device=dev)  # noqa: E731
    seed, pd = 135792468, SAS_DROPOUT
    gen = torch.Generator().manual_seed(SEED + 9)
    results = []
    out = FL.fused_ln_dropout(torch.randn((B, T, D), generator=gen).to(dev), zeros(T, D),
                              zeros(D), torch.ones(D, device=dev), pd, seed)
    results.append(("m0 (prologue)", out != 0,
                    philox.dropout_mask(seed, philox.M0, B, T, D, pd, dev) > 0))
    base = {n: zeros(D, D) for n in ("w_q", "w_k", "w_v", "w_o")}
    base.update({n: zeros(D) for n in ("b_q", "b_k", "b_v", "b_o", "ln1_b", "b2", "ln2_b")},
                ln1_s=torch.ones(D, device=dev), ln2_s=torch.ones(D, device=dev),
                w1=zeros(D, INNER), b1=zeros(INNER), w2=zeros(INNER, D))
    lens = torch.full((B,), T, device=dev)
    lens_last = serving_lens(gen, B).to(dev)
    qpos = FB.last_positions(lens_last, T)
    for mask_id, label, name in ((philox.M1, "m1 (after W_o)", "b_o"),
                                 (philox.M3, "m3 (after the FFN)", "b2")):
        pm = dict(base, **{name: torch.ones(D, device=dev)})
        out = FB.fused_transformer_layer(zeros(B, T, D), lens, pm, True, HEADS, "gelu", pd, 0.0,
                                         seed)
        results.append((label, out > 0,
                        philox.dropout_mask(seed, mask_id, B, T, D, pd, dev) > 0))
        out = FB.fused_transformer_layer_last(zeros(B, T, D), lens_last, pm, HEADS, "gelu", pd,
                                              0.0, seed)
        results.append((label + " last", out > 0,
                        philox.dropout_mask_at(seed, mask_id, qpos, D, pd) > 0))
    dh = D // HEADS
    tp = dh  # keys = the head width, so v_h can be the identity
    x = torch.eye(tp, D, device=dev).expand(B, tp, D).contiguous()
    w_v = zeros(D, D)
    for h in range(HEADS):
        w_v[:dh, h * dh:(h + 1) * dh] = torch.eye(dh, device=dev)
    pm = dict(base, w_v=w_v, w_q=(0.3 * torch.randn((D, D), generator=gen)).to(dev),
              w_k=(0.3 * torch.randn((D, D), generator=gen)).to(dev))
    lens_p = torch.full((B,), tp, device=dev)
    lens_pl = torch.randint(1, tp + 1, (B,), generator=gen).to(dev)
    _, (_, ctx) = FB.fused_transformer_layer_train(x, lens_p, pm, False, HEADS, "gelu", 0.0, pd,
                                                   seed)
    _, (_, ctx_last) = FB.fused_transformer_layer_last_train(x, lens_pl, pm, HEADS, "gelu", 0.0,
                                                             pd, seed)
    valid = torch.arange(tp, device=dev)[None, :] < lens_pl[:, None]
    qpos_p = FB.last_positions(lens_pl, tp)
    for h in range(HEADS):
        mid = philox.prob_mask_id(h)
        results.append((f"probabilities head {h}", ctx[..., h * dh:(h + 1) * dh] != 0,
                        philox.dropout_mask(seed, mid, B, tp, tp, pd, dev) > 0))
        results.append((f"probabilities head {h} last", ctx_last[:, h * dh:(h + 1) * dh] != 0,
                        (philox.dropout_mask_at(seed, mid, qpos_p, tp, pd) > 0) & valid))
    torch.cuda.synchronize()
    for label, got, want in results:
        flips = int((got != want).sum())
        phase("attn-mask-bits", mask=repr(label), elements=want.numel(),
              keep_fraction=f"{float(want.float().mean()):.5f}", mismatches=flips)
        check(flips == 0, f"{label}: {flips} mask bits differ from the plain Philox mask")


def plain_seq_output(model, seq, lens, step=None):
    """The model's fused composition through the plain layer versions,
    with the dropout rate and seeds the model draws for ``step``."""
    p_drop, seeds = model.dropout_seeds(step)
    x = model.embed(seq).to(model.compute_dtype)
    n = len(model.layers)
    for li, layer in enumerate(model.layers):
        flat = model.flat_layer_params(layer, True)
        if li == n - 1:
            return FL.fused_recurrent_layer_last_plain(x, lens, flat, True, True, p_drop,
                                                       seeds[li])
        if li == 0:
            flat.update(model.prologue_params())
        x = FL.fused_recurrent_layer_plain(x, flat, True, True, li == 0, p_drop, seeds[li])


def plain_baseline_output(model, seq, seq_len, step=None):
    """SASRec's or BERT4Rec's fused composition through the plain versions
    of its three kernels (BERT4Rec: mask token appended, output head),
    with the dropout rates and seeds the model draws for ``step``."""
    bert = hasattr(model, "output_head")
    if bert:
        seq = model.reconstruct_test_seq(seq, seq_len)
    t = seq.shape[1]
    p_hidden, p_attn, seeds = model.dropout_seeds(step)
    x = FL.fused_ln_dropout_plain(model.embed(seq).to(model.compute_dtype),
                                  model.position_embedding[:t].float(),
                                  model.input_ln["scale"].float(),
                                  model.input_ln["bias"].float(), p_hidden, seeds[-1])
    lens = (seq != 0).sum(1, dtype=torch.int32)
    n = len(model.encoder)
    for li, layer in enumerate(model.encoder):
        flat = L.flat_block_params(layer)
        drop = (p_hidden, p_attn, seeds[li])
        if li == n - 1:
            x = FB.fused_transformer_layer_last_plain(x, lens, flat, model.n_heads,
                                                      model.hidden_act, *drop)
        else:
            x = FB.fused_transformer_layer_plain(x, lens, flat, model.causal, model.n_heads,
                                                 model.hidden_act, *drop)
    return model.output_head(x) if bert else x


# ---------------------------------------------------------------------------
# training: the bench.py shape (batch 2,048, CE, Adam)
# ---------------------------------------------------------------------------

# per trained model: its phases' prefix, the kernels one step launches,
# its dropout, the step's reference through the plain versions, and the
# floor of each gradient's tolerance as a share of the largest gradient
# (SASRec's b_k gradient is zero up to rounding)
TRAINED = {
    "RecBLR": ("train", LAUNCH_COUNTED, {"dropout_prob": DROPOUT}, plain_seq_output, 0.0),
    "SASRec": ("sasrec-train", SAS_COUNTED,
               {"hidden_dropout_prob": SAS_DROPOUT, "attn_dropout_prob": SAS_DROPOUT},
               plain_baseline_output, 1e-6),
}


def _train_config(name, dtype_name, **extra):
    return Config(model=name, config_dict={
        "MAX_ITEM_LIST_LENGTH": T, "compute_dtype": dtype_name, "train_batch_size": TRAIN_B,
        "seed": SEED, **TRAINED[name][2], **extra})


def train_step_phase(dev, dtype_name, name="RecBLR", steps=TRAIN_STEPS):
    """A model at full width on the bench data: launches per step, one
    step against the same step through the plain versions, and the step
    time."""
    from datamining_recblr_torch.data.synthetic import synthetic_splits
    from datamining_recblr_torch.models.base import ce_loss
    from datamining_recblr_torch.train.trainer import Trainer

    prefix, counted, _, plain_output, floor = TRAINED[name]
    cfg = _train_config(name, dtype_name)
    model = get_model(name)(cfg, N_ITEMS, T, generator=torch.Generator().manual_seed(SEED))
    check(_at_full_width(model), f"{name}: not the fused path at full width")
    rates = ((model.dropout_prob,) if name == "RecBLR"
             else (model.hidden_dropout_prob, model.attn_dropout_prob))
    check(rates == tuple(TRAINED[name][2].values()), f"{name}: dropout {rates}")
    trainer = Trainer(cfg, model)
    train, _ = synthetic_splits(6040, N_ITEMS, T, 8192, seed=SEED)
    data = trainer.device_split(train)
    perm = np.random.default_rng((SEED, 0)).permutation(len(train))
    weight = torch.ones(TRAIN_B, device=dev)

    def batch_of(s):
        idx = perm[(s * TRAIN_B) % len(train):][:TRAIN_B]
        return trainer.gather_batch(data, torch.from_numpy(idx).to(dev), weight)

    # one step through the kernels and the same step through the plain
    # versions (same seeds, so the same masks), gradients before Adam
    batch = batch_of(0)
    model.train()
    model.zero_grad(set_to_none=True)
    for fn in counted:
        fn.launches = 0
    loss = model.calculate_loss(batch, step=7)
    loss.backward()
    torch.cuda.synchronize()
    launches = tuple(fn.launches for fn in counted)
    got = {k: v.grad.detach().clone() for k, v in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    out = plain_output(model, batch["item_seq"], batch["item_seq_len"], step=7)
    want_loss = ce_loss(model._mask_padded_vocab(model._logits(out), value=-1e30),
                        batch["pos_item"], batch["weight"])
    want_loss.backward()
    want = {k: v.grad.detach() for k, v in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    tol = GRAD_RTOL if dtype_name == "float32" else BF16_RTOL
    # max |kernel - plain| over the larger of max |plain| and floor * (the
    # largest gradient) / tol, so that ok <=> within tol of max |plain| or
    # within floor of the largest gradient
    top = max(float(w.abs().max()) for w in want.values())
    errs = {k: float((got[k] - want[k]).abs().max()
                     / max(float(want[k].abs().max()), floor * top / tol, 1e-30))
            for k in got}
    loss, want_loss = float(loss.detach()), float(want_loss.detach())
    loss_err = abs(loss - want_loss) / abs(want_loss)
    worst = max(errs, key=errs.get)
    phase(f"{prefix}-step-vs-plain", dtype=dtype_name, batch=TRAIN_B, T=T,
          p=repr(rates),
          loss=f"{loss:.6f}", plain_loss=f"{want_loss:.6f}",
          loss_rel_err=f"{loss_err:.3e}", loss_tol="1e-4",
          grad_rel_err_max=f"{errs[worst]:.3e}", worst_param=worst,
          grad_tol=f"max|err|/max|plain| <= {tol}"
          + (f" (at least {floor}*max over all grads)" if floor else ""), params=len(errs))
    check(np.isfinite(loss), f"{name}: train loss is not finite")
    check(loss_err <= 1e-4, f"{name}: train loss disagrees with the plain step")
    check(all(e <= tol for e in errs.values()), f"{name}: gradients disagree with the plain step")
    phase(f"{prefix}-launches", dtype=dtype_name, steps=1,
          **{fn.__name__: n for fn, n in zip(counted, launches)})
    check(launches == (1,) * len(counted),
          f"{name}: expected one launch of each kernel, got {launches}")

    # step time: CUDA events around trainer.train_step (batch gather,
    # forward, backward, Adam), median over `steps` after a warm-up
    for s in range(3):
        trainer.train_step(batch_of(s), s)
    torch.cuda.reset_peak_memory_stats(dev)
    times, losses = [], []
    for s in range(steps):
        b = batch_of(s + 3)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(trainer.train_step(b, s + 3))
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    med = float(np.median(times))
    check(bool(torch.isfinite(torch.stack(losses)).all()), "non-finite loss in the timed steps")
    phase(f"{prefix}-time", dtype=dtype_name, batch=TRAIN_B, T=T, steps=steps,
          median_ms_per_step=f"{med:.3f}", examples_per_s=f"{TRAIN_B / med * 1e3:.1f}",
          min_ms=f"{min(times):.3f}", max_ms=f"{max(times):.3f}",
          peak_device_gb=f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f}")
    train_profile(trainer, batch_of, dtype_name, prefix)
    return {"launches": launches, "ms": med, "loss_err": loss_err, "grad_err": errs[worst]}


def train_profile(trainer, batch_of, dtype_name, prefix, steps=5):
    """Device time by kernel over a few train steps (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    batches = [batch_of(100 + s) for s in range(steps)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for s, b in enumerate(batches):
            trainer.train_step(b, 100 + s)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    phase(f"{prefix}-profile", dtype=dtype_name, steps=steps,
          wall_ms_per_step=f"{wall_us / steps / 1e3:.3f}",
          device_ms_per_step=f"{busy_us / steps / 1e3:.3f}" if kernels else "not measured",
          device_busy_share=f"{busy_us / wall_us:.3f}" if kernels else "not measured",
          top=repr([(e.key[:48], round(e.self_device_time_total / steps, 1)) for e in top]))


def fit_phase(dev, name="RecBLR"):
    """Trainer.fit and evaluate(load_best=True) at full model width on a
    small Markov dataset: the loss falls and valid NDCG@10 is above 0."""
    import tempfile

    from datamining_recblr_torch.data.dataset import build_from_dataframe
    from datamining_recblr_torch.data.synthetic import generate_synthetic_interactions
    from datamining_recblr_torch.train.trainer import Trainer

    prefix = "fit" if name == "RecBLR" else f"{name.lower()}-fit"
    t0 = time.perf_counter()
    frame = generate_synthetic_interactions(n_users=1500, n_items=400, min_len=10,
                                            max_len=60, markov_weight=0.9, n_clusters=20,
                                            seed=SEED)
    data = build_from_dataframe(frame, max_seq_len=T)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = _train_config(name, "float32", epochs=FIT_EPOCHS, train_batch_size=512,
                            checkpoint_dir=tmp, dataset="markov", stopping_step=10)
        model = get_model(name)(cfg, data.n_items, T,
                                generator=torch.Generator().manual_seed(SEED))
        trainer = Trainer(cfg, model)
        best, _ = trainer.fit(data)
        test = trainer.evaluate(data.test, load_best=True)
        reloaded = trainer.ckpt_path is not None and trainer.ckpt_path.startswith(tmp)
    epochs = trainer.metrics.epoch_records()
    losses = [r["train_loss"] for r in epochs]
    ndcg = [r.get("valid_ndcg@10") for r in epochs]
    phase(prefix, data=repr(data.summary()), epochs=len(epochs), batch=512,
          train_loss=repr([round(v, 4) for v in losses]), valid_ndcg10=repr(ndcg),
          best_epoch=trainer.best_epoch, test_ndcg10=f"{test['ndcg@10']:.4f}",
          checkpoint_reloaded=reloaded, seconds=f"{time.perf_counter() - t0:.1f}")
    check(len(epochs) == FIT_EPOCHS and all(v is not None for v in ndcg), f"{prefix}: epochs")
    check(losses[-1] < losses[0], f"{prefix}: the epoch loss did not fall")
    check(best > 0 and test["ndcg@10"] > 0, f"{prefix}: NDCG@10 is not above 0")
    check(reloaded, f"{prefix}: no best checkpoint was written")


def _bwd_flops_k1(b, t):
    # recompute of the forward matmuls plus the two gradient products of
    # each (3x), the conv recompute and its two gradients
    fwd_mm = 2 * D * 2 * C + 2 * C * 2 * C + 2 * C * D + 4 * D * FF
    return b * t * (3 * fwd_mm + 6 * K * C)


def k1_bwd_bound_ms(b, t, p, act_bytes):
    # x, dout and dx [B, T, D]; the stashed alpha and h [B, T, C] fp32
    nbytes = b * t * (3 * D * act_bytes + 2 * C * 4) + 2 * _params_bytes(p)
    return _bound(_bwd_flops_k1(b, t), nbytes)


def k2_bwd_bound_ms(lens, t, p, act_bytes):
    # per position below the length: in-projection (xb half) and gates
    # recomputed with their two gradients each, the conv and its
    # gradients; per row: the tail matmuls (z half, W_out, FFN) x3
    n = lens.where((lens >= 1) & (lens <= t), torch.zeros_like(lens))
    positions = int(n.sum())
    b = lens.numel()
    per_pos = 3 * (2 * D * C + 2 * C * 2 * C) + 6 * K * C
    per_row = 3 * (2 * D * C + 2 * C * D + 4 * D * FF)
    nbytes = (positions * (D * act_bytes + 2 * C * 4) + b * t * D * act_bytes
              + b * D * act_bytes + b * 4 + 2 * _params_bytes(p))
    return _bound(positions * per_pos + b * per_row, nbytes)


def training_kernel_times(dev):
    """The four kernels on the training path (p = 0.2, fp32): forwards at
    B = 2,048, backwards at B = 2,048 and 256, each beside its bound and
    its plain version (a backward's plain time is autograd's backward of
    the plain forward, its graph built once)."""
    gen = torch.Generator().manual_seed(SEED + 4)
    p1 = layer_params(gen, dev, prologue=True)
    p2 = layer_params(gen, dev, prologue=False)
    rows = {}
    seed = 4242
    for b in (TRAIN_B, B):
        x = torch.randn((b, T, D), generator=gen).to(dev)
        lens = torch.randint(2, T + 1, (b,), generator=gen).to(dev)
        d1 = torch.randn((b, T, D), generator=gen).to(dev)
        d2 = torch.randn((b, D), generator=gen).to(dev)
        _, s1 = FL.fused_recurrent_layer_train(x, p1, True, True, True, DROPOUT, seed)
        _, s2 = FL.fused_recurrent_layer_last_train(x, lens, p2, True, True, DROPOUT, seed)
        check(s1 is not None and s2 is not None, "the stash policy refused the bench shape")
        times = {
            "fused_recurrent_layer_bwd": time_ms(lambda: FL.fused_recurrent_layer_bwd(
                x, d1, p1, True, True, True, DROPOUT, seed, saved=s1)),
            "fused_recurrent_layer_last_bwd": time_ms(lambda: FL.fused_recurrent_layer_last_bwd(
                x, lens, d2, p2, True, True, DROPOUT, seed, saved=s2)),
        }
        if b == TRAIN_B:
            times["fused_recurrent_layer"] = time_ms(lambda: FL.fused_recurrent_layer_train(
                x, p1, True, True, True, DROPOUT, seed))
            times["fused_recurrent_layer_last"] = time_ms(
                lambda: FL.fused_recurrent_layer_last_train(x, lens, p2, True, True, DROPOUT,
                                                            seed))
        plain = {}
        for name, fn, pp, dout in (
            ("fused_recurrent_layer_bwd", lambda a, q: FL.fused_recurrent_layer_plain(
                a, q, True, True, True, DROPOUT, seed), p1, d1),
            ("fused_recurrent_layer_last_bwd", lambda a, q: FL.fused_recurrent_layer_last_plain(
                a, lens, q, True, True, DROPOUT, seed), p2, d2),
        ):
            xl = x.clone().requires_grad_()
            ql = {k: v.clone().requires_grad_() for k, v in pp.items()}
            if b == TRAIN_B:
                plain[name[:-4]] = time_ms(lambda: fn(x, pp), reps=5, warmup=1)
            out = fn(xl, ql)
            inputs = [xl, *ql.values()]
            plain[name] = time_ms(lambda: torch.autograd.grad(out, inputs, dout,
                                                              retain_graph=True),
                                  reps=5, warmup=1)
            del out
        bounds = {
            "fused_recurrent_layer_bwd": k1_bwd_bound_ms(b, T, p1, 4),
            "fused_recurrent_layer_last_bwd": k2_bwd_bound_ms(lens.cpu(), T, p2, 4),
            "fused_recurrent_layer": k1_bound_ms(b, T, p1, 4),
            "fused_recurrent_layer_last": k2_bound_ms(lens.cpu(), p2, 4),
        }
        for name, ms in times.items():
            bound, flops, by = bounds[name]
            phase("kernel-time", kernel=name, B=b, T=T, dtype="float32", p=DROPOUT,
                  ms=f"{ms:.4f}", plain_ms=f"{plain[name]:.4f}", bound_ms=f"{bound:.5f}",
                  gflop=f"{flops / 1e9:.3f}", bound_by=by, share_of_bound=f"{bound / ms:.4f}")
            rows[(name, b)] = (ms, plain[name], bound, by)
    return rows


def requests(rng, b):
    seqs = [list(rng.integers(1, N_ITEMS, size=rng.integers(2, T))) for _ in range(b)]
    if b >= 4:
        seqs[0] = []                                     # empty history
        seqs[1] = [int(rng.integers(1, N_ITEMS))]        # one item
        seqs[2] = list(rng.integers(1, N_ITEMS, T + 37))  # longer than T
    return seqs


# per served model: its phases' prefix, the kernels one recommend()
# launches, and its scores' reference through the plain versions
SERVED = {
    "RecBLR": ("serve", (FL.fused_recurrent_layer, FL.fused_recurrent_layer_last),
               plain_seq_output),
    "SASRec": ("serve-sasrec", ATTN_COUNTED, plain_baseline_output),
    "BERT4Rec": ("serve-bert4rec", ATTN_COUNTED, plain_baseline_output),
}


def _at_full_width(model):
    if hasattr(model, "encoder"):
        return L._use_fused_attention() and (
            model.hidden_size, model.n_heads, model.inner_size, len(model.encoder),
            model.hidden_act) == (D, HEADS, INNER, 2, "gelu")
    return model.use_fused_layer() and (
        model.hidden_size, model.inner_hidden, len(model.layers)) == (D, C, 2)


def serving(dev, name, dtype_name):
    from datamining_recblr_torch.eval.metrics import mask_scores
    from datamining_recblr_torch.ops.topk import topk_scores

    prefix, counted, plain_output = SERVED[name]
    cfg = Config(model=name, config_dict={"MAX_ITEM_LIST_LENGTH": T,
                                          "compute_dtype": dtype_name})
    model = get_model(name)(cfg, N_ITEMS, T, generator=torch.Generator().manual_seed(SEED))
    check(model.device.type == "cuda", f"{name}: model not on the card")
    check(_at_full_width(model), f"{name}: model is not at full width on the fused path")
    rec = Recommender(model, top_k=TOP_K)
    rng = np.random.default_rng(SEED)
    seqs = requests(rng, B)

    for fn in counted:
        fn.launches = 0
    ids, vals = rec.recommend(seqs)
    launches = tuple(fn.launches for fn in counted)
    phase(f"{prefix}-launches", dtype=dtype_name, calls=1,
          **{fn.__name__: n for fn, n in zip(counted, launches)})
    check(launches == (1,) * len(counted),
          f"{name}: expected one launch of each kernel, got {launches}")

    # reference: the same model through the plain versions on the card
    seq = np.zeros((B, T), np.int64)
    lens = np.zeros((B,), np.int32)
    hist = np.zeros((B, model.n_items_padded), bool)
    for i, items in enumerate(seqs):
        w = np.asarray(items, np.int64)[-T:]
        seq[i, : len(w)] = w
        lens[i] = len(w)
        if len(items):
            hist[i, np.asarray(items, np.int64)] = True
    with torch.inference_mode():
        out = plain_output(model, torch.from_numpy(seq).to(dev), torch.from_numpy(lens).to(dev))
        ref = model._mask_padded_vocab(model._logits(out))
        ref = mask_scores(ref, history=torch.from_numpy(hist[:, : ref.shape[-1]]).to(dev))
        ref_vals, ref_ids = topk_scores(ref, TOP_K)
    ref = ref.cpu().numpy()
    ref_vals = ref_vals.cpu().numpy()
    ref_ids = ref_ids.cpu().numpy()
    scale = float(np.abs(ref_vals).max())
    tol = 1e-4 if dtype_name == "float32" else scale / 32
    check(ids.shape == (B, TOP_K) and np.isfinite(vals).all(), f"{name}: bad serving output")
    err = float(np.abs(vals - ref_vals).max())
    ties = 0
    for i, j in zip(*np.nonzero(ids != ref_ids)):
        ties += 1
        check(abs(ref[i, ids[i, j]] - ref_vals[i, j]) <= tol,
              f"{name} row {i}: id {ids[i, j]} is not a near-tie of the reference")
    excluded = all(not set(ids[i].tolist()) & set(map(int, s)) for i, s in enumerate(seqs))
    phase(f"{prefix}-vs-plain", dtype=dtype_name, users=B, top_k=TOP_K,
          max_abs_score_err=f"{err:.3e}", tol=f"{tol:.3e}", id_mismatches_near_ties=ties,
          history_excluded=excluded)
    check(err <= tol, f"{name}: serving scores disagree with the plain model")
    check(excluded and (ids != 0).all() and (ids < N_ITEMS).all(),
          f"{name}: history, PAD or a padded id recommended")

    # timings as bench.py's serve_main takes them: host clock around
    # recommend(), median over repeats, after a first call
    out = {"launches": launches}
    for b, reps in ((1, 50), (B, 20)):
        batch = requests(rng, b)
        rec.recommend(batch)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            rec.recommend(batch)
            times.append(time.perf_counter() - t0)
        med = float(np.median(times))
        out[b] = med
        serve_profile(rec, batch, prefix, dtype_name)
    phase(f"{prefix}-time", dtype=dtype_name, p50_ms_1_user=f"{out[1] * 1e3:.3f}",
          users_per_s_batch256=f"{B / out[B]:.1f}", median_ms_batch256=f"{out[B] * 1e3:.3f}")
    return out


def serve_profile(rec, batch, prefix, dtype_name, calls=5):
    """Device time by kernel over a few recommend() calls (torch.profiler,
    CUPTI), and the device's busy share of the profiled wall time (the
    profiler's own host overhead is inside that wall time)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            rec.recommend(batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    phase(f"{prefix}-profile", dtype=dtype_name, users=len(batch), calls=calls,
          wall_ms_per_call=f"{wall_us / calls / 1e3:.3f}",
          device_ms_per_call=f"{busy_us / calls / 1e3:.3f}" if kernels else "not measured",
          device_busy_share=f"{busy_us / wall_us:.3f}" if kernels else "not measured",
          top=repr([(e.key[:48], round(e.self_device_time_total / calls, 1)) for e in top]))


def kernel_times(dev, p1, p2, lens):
    gen = torch.Generator().manual_seed(SEED + 1)
    rows = {}
    for b in (B, 1):
        x = torch.randn((b, T, D), generator=gen).to(dev)
        ln = lens[:b] if b > 1 else torch.tensor([T], device=dev)
        k1 = time_ms(lambda: FL.fused_recurrent_layer(x, p1, prologue=True))
        k1p = time_ms(lambda: FL.fused_recurrent_layer_plain(x, p1, prologue=True), reps=10)
        k2 = time_ms(lambda: FL.fused_recurrent_layer_last(x, ln, p2))
        k2p = time_ms(lambda: FL.fused_recurrent_layer_last_plain(x, ln, p2), reps=10)
        for name, ms, plain, (bound, flops, by) in (
            ("fused_recurrent_layer", k1, k1p, k1_bound_ms(b, T, p1, 4)),
            ("fused_recurrent_layer_last", k2, k2p, k2_bound_ms(ln.cpu(), p2, 4)),
        ):
            phase("kernel-time", kernel=name, B=b, T=T, dtype="float32", ms=f"{ms:.4f}",
                  plain_ms=f"{plain:.4f}", bound_ms=f"{bound:.5f}", gflop=f"{flops / 1e9:.3f}",
                  bound_by=by, share_of_bound=f"{bound / ms:.4f}")
            rows[(name, b)] = (ms, plain, bound, by)
    return rows


def _attn_mask(lens, t, causal):
    """[B * HEADS, T, T] additive float mask, -10000 where a key is dropped
    (the layout torch.nn.MultiheadAttention adds to its scores)."""
    col = torch.arange(t, device=lens.device)
    keep = (col[None, None, :] < lens[:, None, None]).expand(-1, t, t)
    if causal:
        keep = keep & (col[None, :] <= col[:, None])[None]
    return torch.where(keep, 0.0, FB.MASK_VALUE).repeat_interleave(HEADS, dim=0)


def library_layer(p, dev):
    """torch.nn.TransformerEncoderLayer with the kernel's weights: post-LN,
    tanh GELU, eps 1e-12, dropout 0.  A yardstick of time only: the port
    never calls it."""
    layer = torch.nn.TransformerEncoderLayer(
        D, HEADS, INNER, dropout=0.0, activation=lambda v: F.gelu(v, approximate="tanh"),
        layer_norm_eps=1e-12, batch_first=True, norm_first=False, device=dev)
    with torch.no_grad():
        attn = layer.self_attn
        attn.in_proj_weight.copy_(torch.cat([p["w_q"], p["w_k"], p["w_v"]], 1).T)
        attn.in_proj_bias.copy_(torch.cat([p["b_q"], p["b_k"], p["b_v"]]))
        attn.out_proj.weight.copy_(p["w_o"].T)
        attn.out_proj.bias.copy_(p["b_o"])
        for lin, w, b in ((layer.linear1, "w1", "b1"), (layer.linear2, "w2", "b2")):
            lin.weight.copy_(p[w].T)
            lin.bias.copy_(p[b])
        for norm, n in ((layer.norm1, "ln1"), (layer.norm2, "ln2")):
            norm.weight.copy_(p[f"{n}_s"])
            norm.bias.copy_(p[f"{n}_b"])
    return layer.eval()


def attn_kernel_times(dev):
    """The attention baselines' three kernels at B = 256 and 1, fp32,
    each beside its bound, its plain version and, where one exists, one
    PyTorch call of the same function (row 10: TransformerEncoderLayer,
    first checked against the plain version; row 6: add + layer_norm)."""
    gen = torch.Generator().manual_seed(SEED + 6)
    p = block_params(gen, dev)
    pos = (0.5 * torch.randn((T, D), generator=gen)).to(dev)
    s, bias = p["ln1_s"], p["ln1_b"]
    layer = library_layer(p, dev)
    rows = {}
    for b in (B, 1):
        x = torch.randn((b, T, D), generator=gen).to(dev)
        lens = serving_lens(gen, b).to(dev) if b > 1 else torch.tensor([T], device=dev)
        mask = _attn_mask(lens, T, causal=True)
        with torch.no_grad():
            lib_out = layer(x, src_mask=mask)
            want = FB.fused_transformer_layer_plain(x, lens, p, True, HEADS)
            lib_err = float((lib_out - want).abs().max())
            lib_ok = lib_err <= 1e-4 * float(want.abs().max())
            phase("library-vs-plain", call="torch.nn.TransformerEncoderLayer", B=b, T=T,
                  causal=True, max_abs_err=f"{lib_err:.3e}", tol="1e-4*max|plain|", ok=lib_ok)
            check(lib_ok, "TransformerEncoderLayer does not compute the plain layer's function")
            lib_ms = {
                "fused_ln_dropout": time_ms(
                    lambda: F.layer_norm(x + pos, (D,), s, bias, L.LN_EPS)),
                "fused_transformer_layer": time_ms(lambda: layer(x, src_mask=mask)),
                "fused_transformer_layer_last": None,
            }
        cases = (
            ("fused_ln_dropout", lambda: FL.fused_ln_dropout(x, pos, s, bias),
             lambda: FL.fused_ln_dropout_plain(x, pos, s, bias), ln_bound_ms(b, 4)),
            ("fused_transformer_layer",
             lambda: FB.fused_transformer_layer(x, lens, p, True, HEADS),
             lambda: FB.fused_transformer_layer_plain(x, lens, p, True, HEADS),
             block_bound_ms(lens.cpu(), T, True, p, 4)),
            ("fused_transformer_layer_last",
             lambda: FB.fused_transformer_layer_last(x, lens, p, HEADS),
             lambda: FB.fused_transformer_layer_last_plain(x, lens, p, HEADS),
             block_last_bound_ms(lens.cpu(), T, p, 4)),
        )
        for name, kernel, plain, (bound, flops, by) in cases:
            ms = time_ms(kernel)
            plain_ms = time_ms(plain, reps=10)
            lib = lib_ms[name]
            phase("kernel-time", kernel=name, B=b, T=T, dtype="float32", ms=f"{ms:.4f}",
                  plain_ms=f"{plain_ms:.4f}",
                  library_ms=f"{lib:.4f}" if lib is not None else "none",
                  bound_ms=f"{bound:.5f}", gflop=f"{flops / 1e9:.3f}", bound_by=by,
                  share_of_bound=f"{bound / ms:.4f}")
            rows[(name, b)] = (ms, plain_ms, bound, by, lib)
    return rows


def attn_training_kernel_times(dev):
    """The six kernels of SASRec's training step at B = 2,048, T = 200,
    fp32, p = 0.5 (the forwards keeping what the backwards read), each
    beside its bound, its plain version (a backward's: autograd's
    backward of the plain forward, its graph built once) and, where one
    exists, one PyTorch call of the same function: row 10
    torch.nn.TransformerEncoderLayer (its forward; for the backward
    ``autograd.grad`` through it, checked first to give the plain dx),
    row 6 add + layer_norm (the same), both at dropout 0."""
    gen = torch.Generator().manual_seed(SEED + 7)
    p = block_params(gen, dev)
    b = TRAIN_B
    x = torch.randn((b, T, D), generator=gen).to(dev)
    pos = (0.5 * torch.randn((T, D), generator=gen)).to(dev)
    s, bias = p["ln1_s"], p["ln1_b"]
    lens = torch.randint(2, T + 1, (b,), generator=gen).to(dev)
    d3 = torch.randn((b, T, D), generator=gen).to(dev)
    d2 = torch.randn((b, D), generator=gen).to(dev)
    seed = 4242
    drop = (SAS_DROPOUT, SAS_DROPOUT, seed)
    _, s10 = FB.fused_transformer_layer_train(x, lens, p, True, HEADS, "gelu", *drop)
    _, s11 = FB.fused_transformer_layer_last_train(x, lens, p, HEADS, "gelu", *drop)
    times = {
        "fused_ln_dropout": time_ms(lambda: FL.fused_ln_dropout(x, pos, s, bias, SAS_DROPOUT,
                                                                seed)),
        "fused_transformer_layer": time_ms(lambda: FB.fused_transformer_layer_train(
            x, lens, p, True, HEADS, "gelu", *drop)),
        "fused_transformer_layer_last": time_ms(lambda: FB.fused_transformer_layer_last_train(
            x, lens, p, HEADS, "gelu", *drop)),
        "fused_ln_dropout_bwd": time_ms(lambda: FL.fused_ln_dropout_bwd(
            x, pos, d3, s, bias, SAS_DROPOUT, seed)),
        "fused_transformer_layer_bwd": time_ms(lambda: FB.fused_transformer_layer_bwd(
            x, lens, d3, p, True, HEADS, "gelu", *drop, saved=s10)),
        "fused_transformer_layer_last_bwd": time_ms(lambda: FB.fused_transformer_layer_last_bwd(
            x, lens, d2, p, HEADS, "gelu", *drop, saved=s11)),
    }
    del s10, s11
    lp = {"pos": pos, "s": s, "b": bias}
    plain = {}
    for name, fn, pp, dout in (
        ("fused_ln_dropout", lambda a, q: FL.fused_ln_dropout_plain(
            a, q["pos"], q["s"], q["b"], SAS_DROPOUT, seed), lp, d3),
        ("fused_transformer_layer", lambda a, q: FB.fused_transformer_layer_plain(
            a, lens, q, True, HEADS, "gelu", *drop), p, d3),
        ("fused_transformer_layer_last", lambda a, q: FB.fused_transformer_layer_last_plain(
            a, lens, q, HEADS, "gelu", *drop), p, d2),
    ):
        with torch.no_grad():
            plain[name] = time_ms(lambda: fn(x, pp), reps=5, warmup=1)
        xl = x.clone().requires_grad_()
        ql = {k: v.clone().requires_grad_() for k, v in pp.items()}
        out = fn(xl, ql)
        inputs = [xl, *ql.values()]
        plain[name + "_bwd"] = time_ms(lambda: torch.autograd.grad(out, inputs, dout,
                                                                   retain_graph=True),
                                       reps=5, warmup=1)
        del out, inputs, xl, ql
    # the library yardsticks at dropout 0, each checked against the plain
    # version first
    layer = library_layer(p, dev).train()
    mask = _attn_mask(lens, T, causal=True)
    xl = x.clone().requires_grad_()
    lib_out = layer(xl, src_mask=mask)
    lib_dx, = torch.autograd.grad(lib_out, [xl], d3, retain_graph=True)
    _, want_dx, _ = _plain_vjp(lambda a, q: FB.fused_transformer_layer_plain(
        a, lens, q, True, HEADS), x, p, d3)
    lib_err = float((lib_dx - want_dx).abs().max())
    lib_ok = lib_err <= 1e-4 * float(want_dx.abs().max())
    phase("library-vs-plain", call="torch.nn.TransformerEncoderLayer backward", B=b, T=T,
          causal=True, max_abs_dx_err=f"{lib_err:.3e}", tol="1e-4*max|plain dx|", ok=lib_ok)
    check(lib_ok, "TransformerEncoderLayer's backward does not give the plain layer's dx")
    lib_params = [xl, *layer.parameters()]
    ql = {k: v.clone().requires_grad_() for k, v in lp.items()}
    xln = x.clone().requires_grad_()
    ln_out = F.layer_norm(xln + ql["pos"], (D,), ql["s"], ql["b"], L.LN_EPS)
    with torch.no_grad():
        lib = {
            "fused_ln_dropout": time_ms(lambda: F.layer_norm(x + pos, (D,), s, bias, L.LN_EPS)),
            "fused_transformer_layer": time_ms(lambda: layer(x, src_mask=mask)),
            "fused_transformer_layer_last": None,
            "fused_transformer_layer_last_bwd": None,
        }
    lib["fused_transformer_layer_bwd"] = time_ms(lambda: torch.autograd.grad(
        lib_out, lib_params, d3, retain_graph=True))
    lib["fused_ln_dropout_bwd"] = time_ms(lambda: torch.autograd.grad(
        ln_out, [xln, *ql.values()], d3, retain_graph=True))
    del lib_out, ln_out
    lc = lens.cpu()
    bounds = {
        "fused_ln_dropout": ln_bound_ms(b, 4),
        "fused_transformer_layer": block_bound_ms(lc, T, True, p, 4, stash=True),
        "fused_transformer_layer_last": block_last_bound_ms(lc, T, p, 4, stash=True),
        "fused_ln_dropout_bwd": ln_bwd_bound_ms(b, 4),
        "fused_transformer_layer_bwd": block_bwd_bound_ms(lc, T, True, p, 4),
        "fused_transformer_layer_last_bwd": block_last_bwd_bound_ms(lc, T, p, 4),
    }
    rows = {}
    for name, ms in times.items():
        bound, flops, by = bounds[name]
        lib_ms = lib[name]
        phase("kernel-time", kernel=name, B=b, T=T, dtype="float32", p=SAS_DROPOUT,
              ms=f"{ms:.4f}", plain_ms=f"{plain[name]:.4f}",
              library_ms=f"{lib_ms:.4f}" if lib_ms is not None else "none",
              bound_ms=f"{bound:.5f}", gflop=f"{flops / 1e9:.3f}", bound_by=by,
              share_of_bound=f"{bound / ms:.4f}")
        rows[name] = (ms, plain[name], bound, by, lib_ms)
    return rows


KERNELS = (
    ("fused_recurrent_layer", "datamining_recblr_torch/csrc/fused_layer.cu",
     "datamining_recblr_tpu/ops/fused_layer.py:245"),
    ("fused_recurrent_layer_last", "datamining_recblr_torch/csrc/fused_layer_last.cu",
     "datamining_recblr_tpu/ops/fused_layer.py:826"),
    ("fused_recurrent_layer_bwd", "datamining_recblr_torch/csrc/fused_layer_bwd.cu",
     "datamining_recblr_tpu/ops/fused_layer.py:419"),
    ("fused_recurrent_layer_last_bwd", "datamining_recblr_torch/csrc/fused_layer_last_bwd.cu",
     "datamining_recblr_tpu/ops/fused_layer.py:844"),
)
SHORT_DTYPE = {"float32": "fp32", "bfloat16": "bf16"}
ATTN_KERNELS = (
    ("fused_ln_dropout", "datamining_recblr_torch/csrc/ln_dropout.cu",
     "datamining_recblr_tpu/ops/fused_layer.py:1292"),
    ("fused_transformer_layer", "datamining_recblr_torch/csrc/fused_block.cu",
     "datamining_recblr_tpu/ops/fused_block.py:260"),
    ("fused_transformer_layer_last", "datamining_recblr_torch/csrc/fused_block_last.cu",
     "datamining_recblr_tpu/ops/fused_block.py:637"),
    ("fused_ln_dropout_bwd", "datamining_recblr_torch/csrc/ln_dropout.cu",
     "datamining_recblr_tpu/ops/fused_layer.py:1303"),
    ("fused_transformer_layer_bwd", "datamining_recblr_torch/csrc/fused_block_bwd.cu",
     "datamining_recblr_tpu/ops/fused_block.py:284"),
    ("fused_transformer_layer_last_bwd", "datamining_recblr_torch/csrc/fused_block_last_bwd.cu",
     "datamining_recblr_tpu/ops/fused_block.py:655"),
)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on a card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = environment()
    p1, p2, lens, errs = kernels_vs_plain(dev)
    mask_bits(dev)
    train_errs = training_kernels_vs_plain(dev)
    attn_errs = attn_kernels_vs_plain(dev)
    attn_train_errs = attn_train_kernels_vs_plain(dev)
    attn_mask_bits(dev)
    serve = {(name, dt): serving(dev, name, dt)
             for name in SERVED for dt in ("float32", "bfloat16")}
    train = {(name, dt): train_step_phase(dev, dt, name)
             for name in TRAINED for dt in ("float32", "bfloat16")}
    for name in TRAINED:
        fit_phase(dev, name)
    kernel_times(dev, p1, p2, lens)
    rows = training_kernel_times(dev)
    attn_kernel_times(dev)
    sas_rows = attn_training_kernel_times(dev)
    # launches: each model's kernels in one training step of its main path
    # (fp32), the forwards' launches per recommend() beside them (RecBLR's;
    # the attention kernels' in SASRec's and BERT4Rec's)
    launches = dict(zip((k[0] for k in KERNELS), train["RecBLR", "float32"]["launches"]))
    kernels = []
    for name, src, tpu in KERNELS:
        ms, plain, bound, by = rows[(name, TRAIN_B)]
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": launches[name],
            "max_abs_err": max(errs.get(name, 0.0), train_errs[name]),
            "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "library_ms": None,
        }
        if name in errs:
            entry["launches_per_recommend"] = serve["RecBLR", "float32"]["launches"][len(kernels)]
        kernels.append(entry)
    sas_launches = dict(zip((fn.__name__ for fn in SAS_COUNTED),
                            train["SASRec", "float32"]["launches"]))
    for i, (name, src, tpu) in enumerate(ATTN_KERNELS):
        ms, plain, bound, by, lib = sas_rows[name]
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": sas_launches[name],
            "max_abs_err": max(attn_errs.get(name, 0.0), attn_train_errs[name]),
            "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "library_ms": lib,
        }
        if i < len(ATTN_COUNTED):
            entry["launches_per_recommend"] = {m: serve[m, "float32"]["launches"][i]
                                               for m in ("SASRec", "BERT4Rec")}
        kernels.append(entry)
    serve_summary = {}
    for (name, dt), out in serve.items():
        tag = ("" if name == "RecBLR" else name.lower() + "_") + SHORT_DTYPE[dt]
        serve_summary[f"serve_p50_ms_{tag}"] = f"{out[1] * 1e3:.3f}"
        serve_summary[f"serve_users_per_s_{tag}"] = f"{B / out[B]:.1f}"
    train_summary = {}
    for (name, dt), out in train.items():
        tag = ("" if name == "RecBLR" else name.lower() + "_") + "train"
        train_summary[f"{tag}_ms_per_step_{SHORT_DTYPE[dt]}"] = f"{out['ms']:.3f}"
        train_summary[f"{tag}_examples_per_s_{SHORT_DTYPE[dt]}"] = (
            f"{TRAIN_B / out['ms'] * 1e3:.1f}")
    phase("summary", card=repr(smi), **serve_summary, **train_summary)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
