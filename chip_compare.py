#!/usr/bin/env python3
"""Times two checkouts of this repository on one CUDA card, in turns.

    python3 chip_compare.py PARENT_DIR            # parent, this tree, this tree, parent
    python3 chip_compare.py --bits PARENT_DIR     # the same turns, rows 15 and 6 only
    python3 chip_compare.py --probes PARENT_DIR   # the same turns, rows 17d and 17a only
    python3 chip_compare.py --ce PARENT_DIR       # the same turns, row 13's forwards, 17f
                                                  # and BERT4Rec's steps only
    python3 chip_compare.py --ce-seeds PARENT_DIR # parent, this tree: row 13's bf16 check
                                                  # at the cloze loss on 8 seeds
    python3 chip_compare.py --one TREE LABEL      # one run (what each turn executes)

PARENT_DIR is an unpacked ``git archive`` of the commit to compare with,
inside a directory ``.gitignore`` lists (e.g. ``build/parent``).  Each turn
runs in its own process from its tree's root: it builds that tree's
kernels and prints ``chip_smoke.py``'s kernel-time lines (every kernel
beside its bound, its plain version and its library call; the
transformer-layer forward and backward and both CE backwards by phase,
row 10's forward in bf16, row 13's backward in bf16 and at D 256 and row
15 by launch, rows 2, 4 and 9's backwards and rows 1, 3, 8 and 9's
forwards by phase, where the tree has those functions; row 13's forward in
bf16 and at D 256, row 14's at the longodd loss in fp32 and by kernel, and
rows 5, 7, 8 and 9's forwards at B 256, rows 6 and 5's forwards at B 2,048 and 256 in fp32
and bf16, and row 16 at the bench step and by sub-kernel at XLong and
there, in a tree without those functions through this checkout's
``chip_smoke.py`` on the tree's kernels), RecBLR's
``recommend`` at XLong (V 329,722, bf16: its median at 256 users and its
p50 for one) and the top-k designs at its catalog (``topk_times``,
where the tree has it), the RecBLR, SASRec and BERT4Rec training steps at the bench
shape, fp32 and bf16, RecBLR's XLong training step in bf16 and its longodd
step in fp32, and SASRec's and BERT4Rec's d256 steps in fp32 (each step
against the plain step, launches, time, profile).  Comparing the turns of one call keeps both versions on
one card at one power limit.  At the end, one ``[compare]`` line a timed
function (kernel-time rows, row 16's kernel-time-phase fields, train-time
medians and the serve-xlong-time medians): its parent and change turns and the ratio of their means,
change over parent.

Every turn ends with rows 17d and 17a (``probe_kernel_times``: the bf16
product at each JAX height the tree's probe takes beside ``torch.mm``, and
unit_overlap's five modes), through this checkout's function where the
tree lacks it; with ``--probes`` a turn builds only the probes' kernels
and runs only those lines.

With ``--ce`` each turn builds the kernels and runs only row 13's
forwards (``ce_fwd_kernel_times``: bf16 at D 64, fp32 and bf16 at D 256,
and row 14's beside them), row 17f's two mask kernels at the default and
XLong sizes (``mask_kernel_times``), and BERT4Rec's training steps at the
bench shape and on the d256 path, fp32 and bf16 (each against the plain
step, launches, time, profile); a tree without those functions takes
this checkout's.

With ``--probes`` a turn also prints row 17c's two scans at the probe's
shape (``scan_probe_times``: ``kernel-time`` lines and a ``[digest]`` of
each output), and the exit code is 1 unless every turn gave the same
bits.

With ``--ce-seeds`` one turn a tree (the parent's, then this one's) runs
row 13 in bf16 at BERT4Rec's cloze loss (N 81,920, V 3,417, D 64, with a
bias; bf16 x and products) through the public wrappers on each of
``CE_SEEDS``: the smoke's own inputs (``b4r_kernels_vs_plain``'s
generator at SEED + 10, after the draws before its CE) and seven other
generators of ``ce_inputs``.  For each it prints (``[ce-seeds]``) whether
the forward ran on the tensor cores, nll's largest error and whether it
is within 1e-4 + 1e-5 |plain|, and of dx the values beyond the plain
bound of ``ce_kernel_vs_plain`` (one bf16 ulp of the value plus
GRAD_RTOL of the largest), the vocab entries whose g lies in a rounding
tie (``bf16_tie_allowance`` at ``TIE_WINDOW``) and the values beyond the
bound plus that allowance; all from this checkout's ``chip_smoke.py`` on
the tree's kernels.  At the end one ``[compare-ce-seeds]`` line a tree.

With ``--bits`` each turn runs only ``row15_row6_digests`` (rows 15 and 6
as every caller before the seq axis calls them, hashed) and the times of
rows 15 (``row15_kernel_times``) and 6 (``ln_fwd_kernel_times``, and its
backward beside row 15's in ``attn_training_kernel_times``), this
checkout's functions on each tree's kernels; at the end one
``[compare-bits]`` line a digest, ``equal=True`` where every turn gave
the same bits, and the exit code is 1 unless all are.
"""

import os
import re
import subprocess
import sys
import time


def _this_smoke():
    """This checkout's chip_smoke.py as a module of its own, bound to the
    package already imported (the tree's)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_this", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the generators of the --ce-seeds check: the smoke's (b4r_kernels_vs_plain,
# SEED + 10) and seven of ce_inputs alone
CE_SEEDS = (("smoke", 10), ("ce", 101), ("ce", 102), ("ce", 103), ("ce", 104), ("ce", 105),
            ("ce", 106), ("ce", 107))


def ce_seed_checks(dev, label):
    """Row 13 in bf16 at the cloze loss on each of CE_SEEDS (see the module
    docstring): one ``[ce-seeds]`` line a seed."""
    import torch

    cs = _this_smoke()
    fce = cs.FCE
    n = cs.TRAIN_B * cs.MASK_LEN
    for stream, seed in CE_SEEDS:
        gen = torch.Generator().manual_seed(cs.SEED + seed if stream == "smoke" else seed)
        if stream == "smoke":  # b4r_kernels_vs_plain's draws before its CE inputs
            cs.block_params(gen, dev)
            torch.randn((cs.B, cs.T, cs.D), generator=gen)
            cs.serving_lens(gen, cs.B)
            cs.b4r_sel_idx(gen, cs.B, cs.T, cs.MASK_LEN)
            torch.randn((cs.B, cs.MASK_LEN, cs.D), generator=gen)
        xc, table, bias, tgt, dnll = cs.ce_inputs(gen, dev, n, cs.D)
        x = xc.bfloat16()
        before = fce.fused_softmax_ce_train.mma_launches
        nll, lse = fce.fused_softmax_ce_train(x, table, tgt, bias, None, True)
        fwd_mma = fce.fused_softmax_ce_train.mma_launches - before
        dx, _, _ = fce.fused_softmax_ce_bwd(x, table, tgt, dnll, bias, None, True, lse=lse)
        xl = x.detach().clone().requires_grad_()
        want = fce.fused_softmax_ce_plain(xl, table, tgt, bias, None, True)
        (gx,) = torch.autograd.grad(want, [xl], dnll)
        want = want.detach()
        nll_err = float((nll - want).abs().max())
        nll_ok = bool(((nll - want).abs() <= 1e-4 + 1e-5 * want.abs()).all())
        err = (dx.float() - gx.float()).abs()
        bound = cs.BF16_RTOL * gx.float().abs() + cs.GRAD_RTOL * float(gx.float().abs().max())
        allow, n_amb = cs.bf16_tie_allowance(x, table, bias, tgt, dnll)
        row = dict(tree=label, stream=stream, seed=seed, fwd_mma_launches=fwd_mma,
                   nll_max_abs_err=f"{nll_err:.3e}", nll_ok=nll_ok,
                   dx_beyond_plain_bound=int((err > bound).sum()), tie_entries=n_amb,
                   dx_beyond_allowance=int((err > bound + allow).sum()),
                   tie_window="2^-17*D/64*p*dnll")
        print("[ce-seeds] " + " ".join(f"{k}={v}" for k, v in row.items()), flush=True)
        del xc, table, bias, tgt, dnll, x, nll, lse, dx, xl, gx, err, bound, allow


def one(tree, label, bits=False, probes=False, ce=False, ce_seeds=False):
    tree = os.path.abspath(tree)
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    print(f"=== {label} {tree}", flush=True)
    probe_times = getattr(cs, "probe_kernel_times", None) or _this_smoke().probe_kernel_times
    if probes:
        from datamining_recblr_torch.ops import _cuda

        print(cs.PB.card(dev), flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        _cuda.build(_cuda.PROBE_SOURCES)
        probe_times(dev)
        _this_smoke().scan_probe_times(dev)
        return
    if ce_seeds:
        from datamining_recblr_torch.ops import _cuda

        print(cs.PB.card(dev), flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        _cuda.build(("fused_ce.cu",))
        ce_seed_checks(dev, label)
        return
    cs.environment()
    if ce:
        for name in ("ce_fwd_kernel_times", "mask_kernel_times"):
            (getattr(cs, name, None) or getattr(_this_smoke(), name))(dev)
        for dt in ("float32", "bfloat16"):
            cs.train_step_phase(dev, dt, "BERT4Rec")
            cs.path_train_phase(dev, "BERT4Rec", "d256", dt)
        return
    if bits:
        this = _this_smoke()
        this.row15_row6_digests(dev)
        this.row15_kernel_times(dev)
        this.ln_fwd_kernel_times(dev)
        this.attn_training_kernel_times(dev)
        return
    p1, p2, lens, _ = cs.kernels_vs_plain(dev)
    cs.kernel_times(dev, p1, p2, lens)
    cs.training_kernel_times(dev)
    cs.attn_kernel_times(dev)
    cs.attn_training_kernel_times(dev)
    if hasattr(cs, "row10_fwd_phase_times"):
        cs.row10_fwd_kernel_times(dev)
        cs.row10_fwd_phase_times(dev)
    if hasattr(cs, "row10_bwd_phase_times"):
        cs.row10_bwd_phase_times(dev)
    cs.b4r_training_kernel_times(dev)
    if hasattr(cs, "row13_bwd_phase_times"):
        cs.row13_kernel_times(dev)
        cs.row13_bwd_phase_times(dev)
    # the CE forwards in bf16, at D 256 and at longodd's fp32 loss, and the
    # served forwards at B 256: the tree's own functions, or in a tree that
    # predates them (a parent) this checkout's, run on that tree's kernels
    for name in ("ce_fwd_kernel_times", "served_kernel_times", "ln_fwd_kernel_times"):
        (getattr(cs, name, None) or getattr(_this_smoke(), name))(dev)
    cs.xlong_kernel_times(dev)
    (getattr(cs, "row16_times", None) or _this_smoke().row16_times)(dev)
    if hasattr(cs, "row14_bwd_phase_times"):
        cs.row14_bwd_phase_times(dev)
    cs.slice_kernel_times(dev)
    cs.row15_kernel_times(dev)
    if hasattr(cs, "row15_phase_times"):
        cs.row15_phase_times(dev)
    if hasattr(cs, "recblr_bwd_phase_times"):
        cs.recblr_bwd_phase_times(dev)
    if hasattr(cs, "recblr_fwd_phase_times"):
        cs.recblr_fwd_phase_times(dev)
    cs.serving(dev, "RecBLR", "bfloat16", xlong=True)
    if hasattr(cs, "topk_times"):
        cs.topk_times(dev)
    for name in ("RecBLR", "SASRec", "BERT4Rec"):
        for dt in ("float32", "bfloat16"):
            cs.train_step_phase(dev, dt, name)
    cs.xlong_train_phase(dev, "bfloat16")
    cs.slice_train_phase(dev, "longodd", "float32")
    cs.path_train_phase(dev, "SASRec", "d256", "float32")
    cs.path_train_phase(dev, "BERT4Rec", "d256", "float32")
    probe_times(dev)


def timed(line):
    """[(key, ms)] of a kernel-time, train-time, serve-xlong-time or topk-time
    line, or of row 16's kernel-time-phase line (each of its ms fields)."""
    fields = dict(re.findall(r"(\w+)=(\S+)", line))
    if line.startswith("[kernel-time] "):
        keys = ("kernel", "shape", "B", "dtype", "causal", "p", "bn", "mode", "nv")
        return [(" ".join(f"{k}={fields[k]}" for k in keys if k in fields), float(fields["ms"]))]
    m = re.match(r"\[([\w-]*train-time)\] ", line)
    if m:
        return [(f"{m.group(1)} dtype={fields['dtype']}", float(fields["median_ms_per_step"]))]
    if line.startswith("[topk-time] "):
        return [(f"topk-time {k} scores={fields['scores']}", float(fields[k]))
                for k in fields if k.endswith("_ms")]
    if line.startswith("[kernel-time-phase] kernel=embedding_grad "):
        return [(f"kernel-time-phase embedding_grad shape={fields['shape']} {k}", float(fields[k]))
                for k in fields if k.endswith("_ms") and re.fullmatch(r"[\d.]+", fields[k])]
    if line.startswith("[serve-xlong-time] "):
        return [(f"serve-xlong-time {k} dtype={fields['dtype']}", float(fields[k]))
                for k in ("median_ms_batch256", "p50_ms_1_user")]
    return []


def main():
    if sys.argv[1:2] == ["--one"]:
        flag = sys.argv[4:5]
        one(sys.argv[2], sys.argv[3], bits=flag == ["--bits"], probes=flag == ["--probes"],
            ce=flag == ["--ce"], ce_seeds=flag == ["--ce-seeds"])
        return 0
    modes = (["--bits"], ["--probes"], ["--ce"], ["--ce-seeds"])
    mode = sys.argv[1] if sys.argv[1:2] in modes else None
    bits = mode == "--bits"
    parent = sys.argv[2] if mode else sys.argv[1]
    here = os.path.dirname(os.path.abspath(__file__))
    rc = 0
    ms, digests, seeds = {}, {}, {}
    turns = ((parent, "parent"), (here, "change"))
    if mode != "--ce-seeds":
        turns += ((here, "change"), (parent, "parent"))
    for i, (tree, label) in enumerate(turns, 1):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree, label]
                           + ([mode] if mode else []),
                           stdout=subprocess.PIPE, text=True, timeout=1200)
        print(r.stdout, end="")
        print(f"=== turn {i} {label} rc={r.returncode} {time.perf_counter() - t0:.0f}s",
              flush=True)
        rc = rc or r.returncode
        for line in r.stdout.splitlines():
            for key, v in timed(line):
                ms.setdefault(key, {"parent": [], "change": []})[label].append(v)
            if line.startswith("[digest] "):
                key, _, sha = line[len("[digest] "):].rpartition(" sha256=")
                digests.setdefault(key, []).append(f"{label}:{sha.split()[0]}")
            if line.startswith("[ce-seeds] "):
                f = dict(re.findall(r"(\w+)=(\S+)", line))
                seeds.setdefault(label, []).append(
                    f"{f['stream']}{f['seed']}:{f['dx_beyond_plain_bound']}/"
                    f"{f['dx_beyond_allowance']}{'' if f['nll_ok'] == 'True' else '!nll'}")
    for key, sides in ms.items():
        if sides["parent"] and sides["change"]:
            parent = sum(sides["parent"]) / len(sides["parent"])
            ratio = (f"{sum(sides['change']) / len(sides['change']) / parent:.4f}" if parent
                     else "none")
            print(f"[compare] {key} parent_ms={sides['parent']} change_ms={sides['change']} "
                  f"ratio={ratio}", flush=True)
    for label, counts in seeds.items():
        print(f"[compare-ce-seeds] {label} seed:beyond_plain_bound/beyond_allowance={counts}",
              flush=True)
    for key, shas in digests.items():
        equal = len(shas) == len(turns) and len({x.split(":")[1] for x in shas}) == 1
        print(f"[compare-bits] {key} turns={shas} equal={equal}", flush=True)
        rc = rc or int(not equal)
    if bits and not digests:
        rc = rc or 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
