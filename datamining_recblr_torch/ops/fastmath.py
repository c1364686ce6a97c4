"""The transcendental forms the fused kernels use, as plain PyTorch.

Counterpart of ``datamining_recblr_tpu/ops/fastmath.py``: the TPU
kernels compute exp as exp2 and the logistic through tanh, and the CUDA
kernels in ``csrc/`` do the same (``exp2f``, ``tanhf``), so the plain
versions of the kernels use these forms too.

    exp(x)     = exp2(x * log2(e))
    sigmoid(x) = 0.5 * tanh(x/2) + 0.5
"""

from __future__ import annotations

import torch

LOG2E = 1.4426950408889634  # log2(e)


def exp(x):
    return torch.exp2(x * LOG2E)


def sigmoid(x):
    return 0.5 * torch.tanh(0.5 * x) + 0.5


def silu(x):
    return x * sigmoid(x)
