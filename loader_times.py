#!/usr/bin/env python3
"""Time the dataset build of a stat-matched preset with the port's
native loader and with its Python builder.

    python3 loader_times.py [--preset xlong-synth] [--config xlong-paper]
                            [--seed 2020] [--out FILE.json]

Writes the preset's log (``data.synthetic.write_stat_matched_dataset``)
as an ``.inter`` file in a temporary directory, compiles the native
loader (``data/native.py``), then builds the dataset with
``data.dataset.build_dataset`` under the config preset, once with
``use_native_loader`` on and once off, each in a process of its own (so
that each reports its own peak resident memory).  Prints the card's name
and power limit where ``nvidia-smi`` answers, one line a stage, and a
JSON line with the seconds of each stage, each build's peak RSS and
whether the two builds' arrays are equal (a SHA-256 over every array and
token).  Needs no card: the builds run on the host.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import resource
import subprocess
import sys
import tempfile
import time

import numpy as np


def digest(data) -> str:
    """SHA-256 over a SeqData's sizes, tokens, split arrays and per-user
    train items."""
    h = hashlib.sha256(repr((data.n_users, data.n_items, data.n_interactions,
                             data.item_id2token, data.user_id2token)).encode())
    for split in ("train", "valid", "test"):
        s = getattr(data, split)
        keys = ("item_seq_len", "pos_item", "user_id") + (
            ("flat_items", "flat_start") if s.compact else ("item_seq",))
        for k in keys:
            h.update(np.ascontiguousarray(getattr(s, k)).tobytes())
    for items in data.user_train_items:
        h.update(np.asarray(items, np.int32).tobytes())
    return h.hexdigest()


def build_once(data_path: str, preset: str, config: str, native: bool) -> dict:
    from datamining_recblr_torch.data.dataset import build_dataset
    from datamining_recblr_torch.run import build_config

    cfg = build_config("RecBLR", preset, [config], dict(data_path=data_path,
                                                        use_native_loader=native))
    t0 = time.perf_counter()
    data = build_dataset(cfg)
    seconds = time.perf_counter() - t0
    return {"seconds": seconds, "summary": data.summary(), "compact": data.train.compact,
            "digest": digest(data),
            "peak_rss_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20}


def card() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--preset", default="xlong-synth")
    parser.add_argument("--config", default="xlong-paper")
    parser.add_argument("--seed", type=int, default=2020)
    parser.add_argument("--out", default=None, help="also write the JSON line here")
    parser.add_argument("--build", choices=("native", "python"), help=argparse.SUPPRESS)
    parser.add_argument("--data-path", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.build:  # one build, in a process of its own
        print(json.dumps(build_once(args.data_path, args.preset, args.config,
                                    args.build == "native")))
        return 0

    from datamining_recblr_torch.data import native
    from datamining_recblr_torch.data.synthetic import write_stat_matched_dataset

    smi = card()
    print(smi if smi else "no nvidia-smi", flush=True)
    result = {"preset": args.preset, "config": args.config, "seed": args.seed, "card": smi}
    with tempfile.TemporaryDirectory() as tmp:
        data_path = os.path.join(tmp, "dataset")
        t0 = time.perf_counter()
        write_stat_matched_dataset(data_path, args.preset, seed=args.seed)
        result["write_s"] = time.perf_counter() - t0
        print(f"[write] seconds={result['write_s']:.2f}", flush=True)
        t0 = time.perf_counter()
        native.build()
        result["native_compile_s"] = time.perf_counter() - t0
        print(f"[compile] seconds={result['native_compile_s']:.2f}", flush=True)
        for how in ("native", "python"):
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--build", how, "--data-path",
                 data_path, "--preset", args.preset, "--config", args.config],
                capture_output=True, text=True, check=True,
                cwd=os.path.dirname(os.path.abspath(__file__)))
            result[how] = json.loads(out.stdout.strip().splitlines()[-1])
            print(f"[{how}] " + " ".join(f"{k}={v}" for k, v in result[how].items()),
                  flush=True)
    result["arrays_equal"] = result["native"]["digest"] == result["python"]["digest"]
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0 if result["arrays_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
