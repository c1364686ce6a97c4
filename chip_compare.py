#!/usr/bin/env python3
"""Times two checkouts of this repository on one CUDA card, in turns.

    python3 chip_compare.py PARENT_DIR            # parent, this tree, this tree, parent
    python3 chip_compare.py --one TREE LABEL      # one run (what each turn executes)

PARENT_DIR is an unpacked ``git archive`` of the commit to compare with,
inside a directory ``.gitignore`` lists (e.g. ``build/parent``).  Each turn
runs in its own process from its tree's root: it builds that tree's
kernels and prints ``chip_smoke.py``'s kernel-time lines (every kernel
beside its bound, its plain version and its library call; the
transformer-layer forward and backward and both CE backwards by phase,
row 10's forward in bf16, row 13's backward in bf16 and at D 256 and row
15 by launch, where the tree has those functions), the SASRec and BERT4Rec
training steps at the bench shape, fp32 and bf16, RecBLR's XLong training
step in bf16 and SASRec's and BERT4Rec's d256 steps in fp32 (each step
against the plain step, launches, time, profile).  Comparing the turns of one call keeps both versions on
one card at one power limit.  At the end, one ``[compare]`` line a timed
function (kernel-time rows and train-time medians): its parent and change
turns and the ratio of their means, change over parent.
"""

import os
import re
import subprocess
import sys
import time


def one(tree, label):
    tree = os.path.abspath(tree)
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    print(f"=== {label} {tree}", flush=True)
    cs.environment()
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
    cs.xlong_kernel_times(dev)
    if hasattr(cs, "row14_bwd_phase_times"):
        cs.row14_bwd_phase_times(dev)
    cs.slice_kernel_times(dev)
    cs.row15_kernel_times(dev)
    if hasattr(cs, "row15_phase_times"):
        cs.row15_phase_times(dev)
    for name in ("SASRec", "BERT4Rec"):
        for dt in ("float32", "bfloat16"):
            cs.train_step_phase(dev, dt, name)
    cs.xlong_train_phase(dev, "bfloat16")
    cs.path_train_phase(dev, "SASRec", "d256", "float32")
    cs.path_train_phase(dev, "BERT4Rec", "d256", "float32")


def timed(line):
    """(key, ms) of a kernel-time or train-time line, else None."""
    fields = dict(re.findall(r"(\w+)=(\S+)", line))
    if line.startswith("[kernel-time] "):
        keys = ("kernel", "shape", "B", "dtype", "causal", "p")
        return " ".join(f"{k}={fields[k]}" for k in keys if k in fields), float(fields["ms"])
    m = re.match(r"\[([\w-]*train-time)\] ", line)
    if m:
        return f"{m.group(1)} dtype={fields['dtype']}", float(fields["median_ms_per_step"])
    return None


def main():
    if sys.argv[1:2] == ["--one"]:
        one(sys.argv[2], sys.argv[3])
        return 0
    parent = sys.argv[1]
    here = os.path.dirname(os.path.abspath(__file__))
    rc = 0
    ms = {}
    for i, (tree, label) in enumerate(((parent, "parent"), (here, "change"),
                                       (here, "change"), (parent, "parent")), 1):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree, label],
                           stdout=subprocess.PIPE, text=True, timeout=1200)
        print(r.stdout, end="")
        print(f"=== turn {i} {label} rc={r.returncode} {time.perf_counter() - t0:.0f}s",
              flush=True)
        rc = rc or r.returncode
        for line in r.stdout.splitlines():
            kv = timed(line)
            if kv:
                ms.setdefault(kv[0], {"parent": [], "change": []})[label].append(kv[1])
    for key, sides in ms.items():
        if sides["parent"] and sides["change"]:
            ratio = (sum(sides["change"]) / len(sides["change"])) / (
                sum(sides["parent"]) / len(sides["parent"]))
            print(f"[compare] {key} parent_ms={sides['parent']} change_ms={sides['change']} "
                  f"ratio={ratio:.4f}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
