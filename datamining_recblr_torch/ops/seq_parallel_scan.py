"""The linear recurrence ``h_t = g_t * h_{t-1} + x_t`` with its time axis
sharded over the mesh's ``seq`` axis (counterpart of
``datamining_recblr_tpu/ops/seq_parallel_scan.py``).

Each seq rank holds a chunk [B, T/S, C] and scans it locally from a zero
state.  The chunk's pair (last state, product of its gates) is the
element of the first-order combine ``(x_l, f_l) o (x_r, f_r) = (x_l f_r +
x_r, f_l f_r)``; the pairs of all ranks are all-gathered
(``parallel/collectives.py:gather_over_seq``), each rank folds the
exclusive prefix of the ranks before it into the state entering its
chunk, ``carry_in``, and a second local scan absorbs it into the first
token:

    h_1 = g_1 * carry_in + x_1   <=>   x'_1 = x_1 + g_1 * carry_in

Both local scans are ``ops/scan.py:linear_scan``: on the card row 7's
kernel (``csrc/linear_scan.cu``), its backward the kernel's reverse mode;
with ``impl="xla"`` (``use_pallas_scan: never``) the serial plain scan.
The gathered pairs' backward sums their cotangents over ``seq``, so the
whole is differentiable.  The product of the gates is taken directly, as
JAX takes it (256 gates of 0.9 give ~2e-12, well inside fp32).
"""

from __future__ import annotations

import torch

from datamining_recblr_torch.ops.scan import linear_scan, linear_scan_serial
from datamining_recblr_torch.parallel.collectives import gather_over_seq
from datamining_recblr_torch.parallel.mesh import SEQ_AXIS


def seq_parallel_scan(gates, tokens, mesh, seq_axis: str = SEQ_AXIS, impl: str = "auto"):
    """h[:, t] = gates[:, t] * h[:, t-1] + tokens[:, t] over the whole
    time axis, of which ``gates`` and ``tokens`` [B, T/S, C] (fp32) are
    this rank's chunk (``parallel/input.py:seq_chunk``, which raises
    where T does not divide the axis); returns this rank's chunk of h.
    Every rank of the seq group calls it, in the same order."""
    scan = linear_scan_serial if impl == "xla" else linear_scan
    b, _, c = tokens.shape
    h_local = scan(gates, tokens)
    pairs = gather_over_seq(torch.stack([h_local[:, -1], torch.prod(gates, dim=1)]), mesh,
                            seq_axis)
    n, my = mesh.size(seq_axis), mesh.index(seq_axis)
    pairs = pairs.view(n, 2, b, c)
    # the fold as JAX writes it, every pair in the graph on every rank:
    # the gather's backward is a collective, so each rank must run it
    carry = carry_in = torch.zeros_like(tokens[:, 0])
    for j in range(n):
        carry_in = torch.where(torch.tensor(j == my, device=carry.device), carry, carry_in)
        carry = carry * pairs[j, 1] + pairs[j, 0]
    # x'_1 = x_1 + g_1 carry_in as one multiply-add, the kernel's own step
    first = torch.addcmul(tokens[:, :1], gates[:, :1], carry_in[:, None])
    return scan(gates, torch.cat([first, tokens[:, 1:]], dim=1).contiguous())
