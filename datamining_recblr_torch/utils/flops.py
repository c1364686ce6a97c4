"""FLOPs of a model's forward, counted without running it (counterpart
of ``datamining_recblr_tpu/utils/flops.py``, which asks XLA's cost
analysis).  The count runs the model's own composition on fake CPU
tensors (``FakeTensorMode``: shapes and dtypes, no data), so each kernel
wrapper takes its plain version, under
``torch.utils.flop_counter.FlopCounterMode``: it counts the products
(2 M N K for each matrix product, the attention's included) and nothing
elementwise, and it launches no kernel."""

from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode


def forward_flops(model, item_seq, item_seq_len) -> int:
    """FLOPs of the products of one ``model(item_seq, item_seq_len)`` in
    evaluation mode at these shapes (the values do not matter)."""
    cpu = type(model)(model.config, model.n_items, model.max_seq_len, device="cpu")
    cpu.eval()
    counter = FlopCounterMode(display=False)
    with FakeTensorMode(allow_non_fake_inputs=True) as fake, counter, torch.no_grad():
        seq = fake.from_tensor(torch.zeros((), dtype=torch.long).expand(*item_seq.shape))
        lens = fake.from_tensor(torch.zeros((), dtype=torch.long).expand(*item_seq_len.shape))
        cpu(seq, lens)
    return int(counter.get_total_flops())
