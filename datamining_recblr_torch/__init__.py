"""PyTorch and CUDA port of the RecBLR sequential recommender and its
SASRec and BERT4Rec baselines.

The JAX package ``datamining_recblr_tpu`` is the reference; this package
keeps its module names so that each piece has a counterpart there.  It
imports neither JAX nor the JAX package.  Its kernels, the RecBLR fused
recurrent layers and the attention baselines' LN prologue and
transformer layers, forwards with dropout and backwards, run as
hand-written CUDA kernels for Hopper (``csrc/``) on a CUDA tensor, and as
their plain PyTorch versions on a CPU tensor.  RecBLR and SASRec train
and serve; BERT4Rec serves.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from datamining_recblr_torch.config import Config  # noqa: F401
