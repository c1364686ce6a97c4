#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's four CUDA kernels from ``datamining_recblr_torch/csrc``
(both fused recurrent layers, forward and backward) and, phase by phase:

* holds each kernel against its plain PyTorch version at B 256, T 200:
  the forwards at dropout 0 (serving), then every kernel's output and
  gradients against autograd of the plain versions, fp32 and bf16, at
  dropout 0 and 0.2, and the kernels' dropout mask bit for bit;
* serves RecBLR at full width (hidden 64, 2 layers, T 200, V 3,417)
  through ``Recommender.recommend`` against the plain model, with one
  launch of each forward per call, and times it;
* trains it at the bench.py shape (batch 2,048, dropout 0.2, CE, Adam,
  fp32 and bf16 compute): one launch of each of the four kernels per
  step, one step against the same step through the plain versions, the
  step time and a profile;
* runs ``Trainer.fit`` and ``evaluate(load_best=True)`` on a small
  Markov dataset: the loss falls and valid NDCG@10 is above 0;
* times every kernel beside its bound and its plain version.

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

from datamining_recblr_torch.config import Config
from datamining_recblr_torch.models import get_model
from datamining_recblr_torch.ops import _cuda
from datamining_recblr_torch.ops import fused_layer as FL
from datamining_recblr_torch.serve import Recommender

SEED = 0
B, T, D, C, K, FF = 256, 200, 64, 128, 4, 256  # serving shape
N_ITEMS, TOP_K = 3417, 10
# H100 SXM peaks (NVIDIA data sheet, 700 W): fp32 outside the tensor
# cores and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
FP32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_RTOL = 2.0 ** -7  # one bf16 ulp of the value, at most
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


def plain_full_sort_scores(model, seq, lens):
    return model._mask_padded_vocab(model._logits(plain_seq_output(model, seq, lens)))


# ---------------------------------------------------------------------------
# training: the bench.py shape (batch 2,048, dropout 0.2, CE, Adam)
# ---------------------------------------------------------------------------

def _train_config(dtype_name, **extra):
    return Config(model="RecBLR", config_dict={
        "MAX_ITEM_LIST_LENGTH": T, "compute_dtype": dtype_name, "dropout_prob": DROPOUT,
        "train_batch_size": TRAIN_B, "seed": SEED, **extra})


def _reset_launches():
    for fn in LAUNCH_COUNTED:
        fn.launches = 0


def _launches():
    return tuple(fn.launches for fn in LAUNCH_COUNTED)


def train_step_phase(dev, dtype_name, steps=TRAIN_STEPS):
    """RecBLR at full width on the bench data: launches per step, one
    step against the same step through the plain versions, and the step
    time."""
    from datamining_recblr_torch.data.synthetic import synthetic_splits
    from datamining_recblr_torch.models.base import ce_loss
    from datamining_recblr_torch.train.trainer import Trainer

    cfg = _train_config(dtype_name)
    model = get_model("RecBLR")(cfg, N_ITEMS, T, generator=torch.Generator().manual_seed(SEED))
    check(model.use_fused_layer() and model.dropout_prob == DROPOUT, "not the fused path")
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
    _reset_launches()
    loss = model.calculate_loss(batch, step=7)
    loss.backward()
    torch.cuda.synchronize()
    launches = _launches()
    got = {k: v.grad.detach().clone() for k, v in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    out = plain_seq_output(model, batch["item_seq"], batch["item_seq_len"], step=7)
    want_loss = ce_loss(model._mask_padded_vocab(model._logits(out), value=-1e30),
                        batch["pos_item"], batch["weight"])
    want_loss.backward()
    want = {k: v.grad.detach() for k, v in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    tol = GRAD_RTOL if dtype_name == "float32" else BF16_RTOL
    errs = {k: float((got[k] - want[k]).abs().max() / want[k].abs().max().clamp_min(1e-30))
            for k in got}
    loss, want_loss = float(loss.detach()), float(want_loss.detach())
    loss_err = abs(loss - want_loss) / abs(want_loss)
    worst = max(errs, key=errs.get)
    phase("train-step-vs-plain", dtype=dtype_name, batch=TRAIN_B, T=T, p=DROPOUT,
          loss=f"{loss:.6f}", plain_loss=f"{want_loss:.6f}",
          loss_rel_err=f"{loss_err:.3e}", loss_tol="1e-4",
          grad_rel_err_max=f"{errs[worst]:.3e}", worst_param=worst,
          grad_tol=f"max|err|/max|plain| <= {tol}", params=len(errs))
    check(np.isfinite(loss), "train loss is not finite")
    check(loss_err <= 1e-4, "train loss disagrees with the plain step")
    check(all(e <= tol for e in errs.values()), "gradients disagree with the plain step")
    phase("train-launches", dtype=dtype_name, steps=1,
          **{fn.__name__: n for fn, n in zip(LAUNCH_COUNTED, launches)})
    check(launches == (1, 1, 1, 1), f"expected one launch of each kernel, got {launches}")

    # step time: CUDA events around trainer.train_step (batch gather,
    # forward, backward, Adam), median over `steps` after a warm-up
    for s in range(3):
        trainer.train_step(batch_of(s), s)
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
    phase("train-time", dtype=dtype_name, batch=TRAIN_B, T=T, steps=steps,
          median_ms_per_step=f"{med:.3f}", examples_per_s=f"{TRAIN_B / med * 1e3:.1f}",
          min_ms=f"{min(times):.3f}", max_ms=f"{max(times):.3f}")
    train_profile(trainer, batch_of, dtype_name)
    return {"launches": launches, "ms": med, "loss_err": loss_err, "grad_err": errs[worst]}


def train_profile(trainer, batch_of, dtype_name, steps=5):
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
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    phase("train-profile", dtype=dtype_name, steps=steps,
          wall_ms_per_step=f"{wall_us / steps / 1e3:.3f}",
          device_ms_per_step=f"{busy_us / steps / 1e3:.3f}" if kernels else "not measured",
          device_busy_share=f"{busy_us / wall_us:.3f}" if kernels else "not measured",
          top=repr([(e.key[:48], round(e.self_device_time_total / steps, 1)) for e in top]))


def fit_phase(dev):
    """Trainer.fit and evaluate(load_best=True) at full model width on a
    small Markov dataset: the loss falls and valid NDCG@10 is above 0."""
    import tempfile

    from datamining_recblr_torch.data.dataset import build_from_dataframe
    from datamining_recblr_torch.data.synthetic import generate_synthetic_interactions
    from datamining_recblr_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    frame = generate_synthetic_interactions(n_users=1500, n_items=400, min_len=10,
                                            max_len=60, markov_weight=0.9, n_clusters=20,
                                            seed=SEED)
    data = build_from_dataframe(frame, max_seq_len=T)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = _train_config("float32", epochs=FIT_EPOCHS, train_batch_size=512,
                            checkpoint_dir=tmp, dataset="markov", stopping_step=10)
        model = get_model("RecBLR")(cfg, data.n_items, T,
                                    generator=torch.Generator().manual_seed(SEED))
        trainer = Trainer(cfg, model)
        best, _ = trainer.fit(data)
        test = trainer.evaluate(data.test, load_best=True)
        reloaded = trainer.ckpt_path is not None and trainer.ckpt_path.startswith(tmp)
    epochs = trainer.metrics.epoch_records()
    losses = [r["train_loss"] for r in epochs]
    ndcg = [r.get("valid_ndcg@10") for r in epochs]
    phase("fit", data=repr(data.summary()), epochs=len(epochs), batch=512,
          train_loss=repr([round(v, 4) for v in losses]), valid_ndcg10=repr(ndcg),
          best_epoch=trainer.best_epoch, test_ndcg10=f"{test['ndcg@10']:.4f}",
          checkpoint_reloaded=reloaded, seconds=f"{time.perf_counter() - t0:.1f}")
    check(len(epochs) == FIT_EPOCHS and all(v is not None for v in ndcg), "fit: epochs")
    check(losses[-1] < losses[0], "fit: the epoch loss did not fall")
    check(best > 0 and test["ndcg@10"] > 0, "fit: NDCG@10 is not above 0")
    check(reloaded, "fit: no best checkpoint was written")


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


def serving(dev, dtype_name):
    from datamining_recblr_torch.eval.metrics import mask_scores
    from datamining_recblr_torch.ops.topk import topk_scores

    cfg = Config(model="RecBLR", config_dict={"MAX_ITEM_LIST_LENGTH": T,
                                               "compute_dtype": dtype_name})
    model = get_model("RecBLR")(cfg, N_ITEMS, T,
                                generator=torch.Generator().manual_seed(SEED))
    check(model.device.type == "cuda" and model.use_fused_layer(), "model not on the fused path")
    check((model.hidden_size, model.inner_hidden, len(model.layers)) == (D, C, 2),
          "model is not at full width")
    rec = Recommender(model, top_k=TOP_K)
    rng = np.random.default_rng(SEED)
    seqs = requests(rng, B)

    FL.fused_recurrent_layer.launches = 0
    FL.fused_recurrent_layer_last.launches = 0
    ids, vals = rec.recommend(seqs)
    launches = (FL.fused_recurrent_layer.launches, FL.fused_recurrent_layer_last.launches)
    phase("serve-launches", dtype=dtype_name, calls=1,
          fused_recurrent_layer=launches[0], fused_recurrent_layer_last=launches[1])
    check(launches == (1, 1), f"expected one launch of each kernel, got {launches}")

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
        ref = plain_full_sort_scores(model, torch.from_numpy(seq).to(dev),
                                     torch.from_numpy(lens).to(dev))
        ref = mask_scores(ref, history=torch.from_numpy(hist).to(dev))
        ref_vals, ref_ids = topk_scores(ref, TOP_K)
    ref = ref.cpu().numpy()
    ref_vals = ref_vals.cpu().numpy()
    ref_ids = ref_ids.cpu().numpy()
    scale = float(np.abs(ref_vals).max())
    tol = 1e-4 if dtype_name == "float32" else scale / 32
    check(ids.shape == (B, TOP_K) and np.isfinite(vals).all(), "bad serving output")
    err = float(np.abs(vals - ref_vals).max())
    ties = 0
    for i, j in zip(*np.nonzero(ids != ref_ids)):
        ties += 1
        check(abs(ref[i, ids[i, j]] - ref_vals[i, j]) <= tol,
              f"row {i}: id {ids[i, j]} is not a near-tie of the reference")
    excluded = all(not set(ids[i].tolist()) & set(map(int, s)) for i, s in enumerate(seqs))
    phase("serve-vs-plain", dtype=dtype_name, users=B, top_k=TOP_K,
          max_abs_score_err=f"{err:.3e}", tol=f"{tol:.3e}", id_mismatches_near_ties=ties,
          history_excluded=excluded)
    check(err <= tol, "serving scores disagree with the plain model")
    check(excluded and (ids != 0).all(), "history or PAD recommended")

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
        serve_profile(rec, batch, dtype_name)
    phase("serve-time", dtype=dtype_name, p50_ms_1_user=f"{out[1] * 1e3:.3f}",
          users_per_s_batch256=f"{B / out[B]:.1f}", median_ms_batch256=f"{out[B] * 1e3:.3f}")
    return out


def serve_profile(rec, batch, dtype_name, calls=5):
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
    phase("serve-profile", dtype=dtype_name, users=len(batch), calls=calls,
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on a card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = environment()
    p1, p2, lens, errs = kernels_vs_plain(dev)
    mask_bits(dev)
    train_errs = training_kernels_vs_plain(dev)
    serve = {dt: serving(dev, dt) for dt in ("float32", "bfloat16")}
    train = {dt: train_step_phase(dev, dt) for dt in ("float32", "bfloat16")}
    fit_phase(dev)
    kernel_times(dev, p1, p2, lens)
    rows = training_kernel_times(dev)
    # launches: one training step of the main path (fp32); the forwards'
    # launches per recommend() beside them
    launches = dict(zip((k[0] for k in KERNELS), train["float32"]["launches"]))
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
            entry["launches_per_recommend"] = serve["float32"]["launches"][len(kernels)]
        kernels.append(entry)
    phase("summary", card=repr(smi), serve_p50_ms_fp32=f"{serve['float32'][1] * 1e3:.3f}",
          serve_users_per_s_fp32=f"{B / serve['float32'][B]:.1f}",
          serve_p50_ms_bf16=f"{serve['bfloat16'][1] * 1e3:.3f}",
          serve_users_per_s_bf16=f"{B / serve['bfloat16'][B]:.1f}",
          train_ms_per_step_fp32=f"{train['float32']['ms']:.3f}",
          train_examples_per_s_fp32=f"{TRAIN_B / train['float32']['ms'] * 1e3:.1f}",
          train_ms_per_step_bf16=f"{train['bfloat16']['ms']:.3f}",
          train_examples_per_s_bf16=f"{TRAIN_B / train['bfloat16']['ms'] * 1e3:.1f}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
