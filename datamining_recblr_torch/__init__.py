"""PyTorch and CUDA port of the RecBLR sequential recommender.

The JAX package ``datamining_recblr_tpu`` is the reference; this package
keeps its module names so that each piece has a counterpart there.  It
imports neither JAX nor the JAX package.  The two fused recurrent-layer
forwards run as hand-written CUDA kernels for Hopper (``csrc/``) on a
CUDA tensor, and as their plain PyTorch versions on a CPU tensor.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from datamining_recblr_torch.config import Config  # noqa: F401
