"""Dataset trimming entry point (counterpart of the root ``trim.py``):
sort a ``.inter`` file by time (stable) and keep the most recent
fraction of its rows.

    python -m datamining_recblr_torch.trim in.inter out.inter --keep_fraction 0.125
"""

from __future__ import annotations

import argparse

import numpy as np

from datamining_recblr_torch.data.atomic import read_atomic_file, write_atomic_inter


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("input", help="input .inter path")
    ap.add_argument("output", help="output .inter path")
    ap.add_argument("--keep_fraction", type=float, default=1 / 8,
                    help="most-recent fraction to keep (reference: 1/8 of yelp)")
    ap.add_argument("--time_field", default="timestamp")
    args = ap.parse_args(argv)

    frame = read_atomic_file(args.input)
    n = len(frame[args.time_field])
    order = np.argsort(frame[args.time_field], kind="stable")
    keep = int(n * args.keep_fraction)
    out = {k: v[order][n - keep:] for k, v in frame.items()}
    write_atomic_inter(out, args.output)
    print(f"kept {len(out[args.time_field])}/{n} most recent interactions -> {args.output}")
    return out


if __name__ == "__main__":
    main()
