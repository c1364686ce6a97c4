"""First-order linear recurrence ``h_t = g_t * h_{t-1} + x_t`` (h_{-1} = 0).

Counterpart of ``datamining_recblr_tpu/ops/scan.py`` and
``ops/pallas_scan.py``:

* ``linear_scan_serial`` (the JAX package's serial oracle) is the plain
  version: a Python loop over T, differentiated by autograd.  It is also
  the spec of the scan inside the CUDA layer kernels, which run it in the
  same order: one thread per (row, channel), serial over T.
* ``linear_scan`` replaces ``linear_scan_pallas`` (``_scan_fwd_pallas``,
  ``pallas_scan.py:97``): on a CUDA tensor its forward is the kernel of
  ``csrc/linear_scan.cu`` and its backward is the JAX VJP
  (``pallas_scan.py:132-142``): the kernel's reverse mode,
  ``linear_scan_reverse``, on ``shift_left(gates)`` (the last position
  1) gives d_states = d_tokens, and d_gates = shift_right(h) * d_states
  is plain PyTorch, as it is XLA in JAX.  On a CPU tensor ``linear_scan``
  is ``linear_scan_serial``.

The TPU kernel sums in Hillis-Steele order, so the two packages agree to
rounding, not bit for bit.  ``launches`` on ``linear_scan`` and
``linear_scan_reverse`` counts their kernel launches.
"""

from __future__ import annotations

import torch

from datamining_recblr_torch.ops import _cuda


def linear_scan_serial(gates, tokens):
    """gates, tokens: [B, T, C] -> h [B, T, C] in the tokens' dtype
    (out of place, so autograd differentiates it)."""
    h = torch.zeros_like(tokens[:, 0])
    out = []
    for t in range(tokens.shape[1]):
        h = gates[:, t] * h + tokens[:, t]
        out.append(h)
    return torch.stack(out, dim=1)


def linear_scan_reverse_serial(gates, tokens):
    """The reverse recurrence h_t = g_t * h_{t+1} + x_t (h_T = 0), the
    plain version of ``linear_scan_reverse``."""
    return linear_scan_serial(gates.flip(1), tokens.flip(1)).flip(1)


def _checks(gates, tokens):
    if tokens.dim() != 3 or tuple(gates.shape) != tuple(tokens.shape):
        raise ValueError(f"gates and tokens must both be [B, T, C], got {tuple(gates.shape)} "
                         f"and {tuple(tokens.shape)}")
    for name, v in (("gates", gates), ("tokens", tokens)):
        if v.dtype != torch.float32 or not v.is_contiguous() or v.device != tokens.device:
            raise ValueError(f"{name} must be contiguous float32 on {tokens.device}, got "
                             f"{v.dtype} on {v.device}")
    b, t, c = tokens.shape
    if b < 1 or t < 1 or c < 1 or b * c >= 2**31:
        raise ValueError(f"unsupported shape B={b} T={t} C={c}")


def _launch(gates, tokens, reverse):
    _checks(gates, tokens)
    b, t, c = tokens.shape
    lib = _cuda.library("linear_scan.cu")
    out = torch.empty_like(tokens)
    with torch.cuda.device(tokens.device):
        err = lib.recblr_linear_scan(gates.data_ptr(), tokens.data_ptr(), out.data_ptr(), b, t,
                                     c, int(reverse), tokens.device.index, _cuda.stream(tokens))
    _cuda.check(lib, err, "linear_scan_reverse" if reverse else "linear_scan")
    (linear_scan_reverse if reverse else linear_scan).launches += 1
    return out


def linear_scan_reverse(gates, tokens):
    """h_t = gates_t * h_{t+1} + tokens_t from t = T-1 down (h_T = 0):
    the kernel's reverse mode on a CUDA tensor (gates and tokens [B, T, C]
    fp32; the gates as given, not shifted), ``linear_scan_reverse_serial``
    on the CPU."""
    if tokens.device.type == "cpu":
        return linear_scan_reverse_serial(gates, tokens)
    _cuda.require_cuda(tokens)
    return _launch(gates, tokens, True)


def _scan(gates, tokens):
    """The forward scan on either device, without autograd."""
    if tokens.device.type == "cpu":
        return linear_scan_serial(gates, tokens)
    return _launch(gates, tokens, False)


class LinearScan(torch.autograd.Function):
    """The scan with the JAX package's VJP (``pallas_scan.py:127-142``):
    the forward keeps h and the gates; the backward is the reverse scan
    of the cotangent on shift_left(gates), and d_gates = shift_right(h) *
    d_states.  ``linear_scan`` runs it on the card; on the CPU the tests
    hold its backward against the JAX VJP."""

    @staticmethod
    def forward(ctx, gates, tokens):
        h = _scan(gates, tokens)
        ctx.save_for_backward(h, gates)
        return h

    @staticmethod
    def backward(ctx, dh):
        h, gates = ctx.saved_tensors
        shifted = torch.cat([gates[:, 1:], torch.ones_like(gates[:, :1])], dim=1)
        d_states = linear_scan_reverse(shifted, dh.contiguous())
        d_gates = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1) * d_states
        return d_gates, d_states


def linear_scan(gates, tokens):
    """h[:, t] = gates[:, t] * h[:, t-1] + tokens[:, t], differentiable in
    both.  gates, tokens: [B, T, C] (on the card contiguous fp32, any C).
    Returns [B, T, C]."""
    if tokens.device.type == "cpu":
        return linear_scan_serial(gates, tokens)
    _cuda.require_cuda(tokens)
    if _cuda.needs_grad(tokens, [gates]):
        return LinearScan.apply(gates, tokens)
    return _launch(gates, tokens, False)


linear_scan.launches = 0
linear_scan_reverse.launches = 0
