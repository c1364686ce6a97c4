"""Item-feature entry point (counterpart of the root
``prepare_item_features.py``): write ``<ds>_item_features.csv`` from the
``.item`` file's text columns when there is one, otherwise from
descriptions synthesized from the interaction statistics.

    python -m datamining_recblr_torch.prepare_item_features --dataset beauty-synth
"""

from __future__ import annotations

import argparse

from datamining_recblr_torch.unseen.features import prepare_item_features


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--data_path", default="dataset")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    feats = prepare_item_features(args.dataset, args.data_path, args.out)
    print(f"wrote {len(feats['item_id'])} item feature rows")
    return feats


if __name__ == "__main__":
    main()
