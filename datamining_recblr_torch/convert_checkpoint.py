"""Convert a checkpoint of the JAX package into the port's ``.pt``.

    python -m datamining_recblr_torch.convert_checkpoint SRC DST.pt

SRC is what the JAX trainer wrote: a ``.pkl``, a ``.orbax`` directory,
or the path both are named after.  DST holds the port's state
(``train/jax_checkpoint.py``): the parameters as a state dict, the
optimizer state as optax's tree, the epoch and the best score; it is
read by ``Trainer.resume_from`` and ``Recommender.from_checkpoint`` like
any checkpoint of the port.  Reading an orbax directory needs
``tensorstore``; run this where it imports (no card is needed), and
load the ``.pt`` where it does not.
"""

from __future__ import annotations

import argparse

from datamining_recblr_torch.train.checkpoint import save_checkpoint
from datamining_recblr_torch.train.jax_checkpoint import read_jax_checkpoint


def convert(src: str, dst: str) -> str:
    """Write the port's checkpoint of the JAX checkpoint ``src`` to
    ``dst`` (``.pt`` appended where missing); returns the file written."""
    return save_checkpoint(dst, read_jax_checkpoint(src))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("src", help="the JAX checkpoint (.pkl, .orbax, or their stem)")
    parser.add_argument("dst", help="the port's checkpoint to write (.pt)")
    args = parser.parse_args(argv)
    print(convert(args.src, args.dst))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
