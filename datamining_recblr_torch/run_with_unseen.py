"""Cold-start experiment entry point (counterpart of the root
``run_with_unseen.py``): a user-level split, RecBLR trained on the train
users and tested on them, then the held-out users evaluated with
``--mode none`` (raw tokens; users with an unseen item skipped) or
``--mode pre`` (unseen items mapped to their most similar seen item by
TF-IDF / SVD similarity).

    python -m datamining_recblr_torch.run_with_unseen --mode pre --config reference \\
        --dataset beauty-synth [--device cpu]

``--config`` takes a preset, a preset's yaml file or another yaml file,
as ``python -m datamining_recblr_torch.run`` does (default: config.yaml
when it exists).  The run is on the card unless ``--device`` names
another.
"""

from __future__ import annotations

import argparse
import os

from datamining_recblr_torch.unseen.pipeline import run_unseen_experiment


def main(argv=None):
    ap = argparse.ArgumentParser(description="RecBLR with unseen-item handling")
    ap.add_argument("--mode", choices=["none", "pre"], default="none")
    ap.add_argument("--n_components", type=int, default=16,
                    help="SVD components for similarity (default: 16)")
    ap.add_argument("--dataset", default=None)
    ap.add_argument("--config", action="append", default=None)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    files = args.config
    if files is None:
        files = ["config.yaml"] if os.path.exists("config.yaml") else []
    out = run_unseen_experiment(mode=args.mode, dataset=args.dataset, config_files=files,
                                epochs=args.epochs, n_components=args.n_components,
                                device=args.device)
    print("seen-user test:", out["seen_result"])
    print(f"unseen-user test (mode={out['mode']}):", out["unseen_result"])
    return out


if __name__ == "__main__":
    main()
