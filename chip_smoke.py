#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``datamining_recblr_torch/csrc``,
holds each against its plain PyTorch version at the serving shape (fp32
and bf16), serves RecBLR at full width (hidden 64, 2 layers, T 200,
V 3,417) through ``Recommender.recommend`` and checks it against the
same model run through the plain versions, counts the kernel launches
of that run, and times the kernels, their plain versions and the
serving path with CUDA events and the host clock.  Each phase prints
one line; any failure exits non-zero.  The line before the last is the
kernels' JSON record, the last line the device JSON.  Exits non-zero
without a CUDA card.
"""

from __future__ import annotations

import json
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
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {src}: {line.strip()}", flush=True)
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


def plain_full_sort_scores(model, seq, lens):
    """The model's fused composition through the plain layer versions."""
    x = model.embed(seq).to(model.compute_dtype)
    n = len(model.layers)
    for li, layer in enumerate(model.layers):
        flat = model.flat_layer_params(layer, True)
        if li == n - 1:
            x = FL.fused_recurrent_layer_last_plain(x, lens, flat)
        else:
            if li == 0:
                flat.update(model.prologue_params())
            x = FL.fused_recurrent_layer_plain(x, flat, True, True, li == 0)
    table = model.item_embedding.to(x.dtype)
    return model._mask_padded_vocab(x.float() @ table.float().T)


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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on a card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = environment()
    p1, p2, lens, errs = kernels_vs_plain(dev)
    serve = {dt: serving(dev, dt) for dt in ("float32", "bfloat16")}
    rows = kernel_times(dev, p1, p2, lens)
    launches = serve["float32"]["launches"]
    kernels = []
    for i, (name, src, tpu) in enumerate((
        ("fused_recurrent_layer", "datamining_recblr_torch/csrc/fused_layer.cu",
         "datamining_recblr_tpu/ops/fused_layer.py:245"),
        ("fused_recurrent_layer_last", "datamining_recblr_torch/csrc/fused_layer_last.cu",
         "datamining_recblr_tpu/ops/fused_layer.py:826"),
    )):
        ms, plain, bound, by = rows[(name, B)]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": launches[i], "max_abs_err": errs[name], "ms": ms,
            "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "library_ms": None,
        })
    phase("summary", card=repr(smi), serve_p50_ms_fp32=f"{serve['float32'][1] * 1e3:.3f}",
          serve_users_per_s_fp32=f"{B / serve['float32'][B]:.1f}",
          serve_p50_ms_bf16=f"{serve['bfloat16'][1] * 1e3:.3f}",
          serve_users_per_s_bf16=f"{B / serve['bfloat16'][B]:.1f}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
