#!/usr/bin/env python3
"""Times two checkouts of this repository on one CUDA card, in turns.

    python3 chip_compare.py PARENT_DIR            # parent, this tree, this tree, parent
    python3 chip_compare.py --one TREE LABEL      # one run (what each turn executes)

PARENT_DIR is an unpacked ``git archive`` of the commit to compare with,
inside a directory ``.gitignore`` lists (e.g. ``build/parent``).  Each turn
runs in its own process from its tree's root: it builds that tree's
kernels and prints ``chip_smoke.py``'s kernel-time lines (every kernel
beside its bound, its plain version and its library call; the
transformer-layer backward by phase where the tree has that phase) and
the SASRec and BERT4Rec training steps at the bench shape, fp32 and bf16
(step against the plain step, launches, time, profile).  Comparing the
turns of one call keeps both versions on one card at one power limit.
"""

import os
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
    if hasattr(cs, "row10_bwd_phase_times"):
        cs.row10_bwd_phase_times(dev)
    cs.b4r_training_kernel_times(dev)
    cs.xlong_kernel_times(dev)
    cs.slice_kernel_times(dev)
    cs.row15_kernel_times(dev)
    for name in ("SASRec", "BERT4Rec"):
        for dt in ("float32", "bfloat16"):
            cs.train_step_phase(dev, dt, name)


def main():
    if sys.argv[1:2] == ["--one"]:
        one(sys.argv[2], sys.argv[3])
        return 0
    parent = sys.argv[1]
    here = os.path.dirname(os.path.abspath(__file__))
    rc = 0
    for i, (tree, label) in enumerate(((parent, "parent"), (here, "change"),
                                       (here, "change"), (parent, "parent")), 1):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree, label],
                           timeout=1200)
        print(f"=== turn {i} {label} rc={r.returncode} {time.perf_counter() - t0:.0f}s",
              flush=True)
        rc = rc or r.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
