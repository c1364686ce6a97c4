"""Probes: small kernels that each answer one question about the card,
the counterparts of the JAX package's Pallas probes under ``benchmarks/``
(queue B row 17 of ``PERF.md``'s kernel table).

* ``unit_overlap`` (row 17a): does CUDA-core work hide under a chain of
  dependent tensor-core products?
* ``vpu_ops`` (row 17b): what each elementwise op costs in a dependent
  chain.
* ``scan_chunked`` (row 17c): a flat and a two-level parallel scan beside
  row 7's serial ``linear_scan``.
* ``ce_mxu`` (row 17d): a bare bf16 product of the cloze CE's shape beside
  row 13 and ``torch.mm``.
* ``emb_gather`` (row 17e): the bench step's embedding gather from a table
  kept in L2, beside ``tab[ids]``.
* ``mask_replay_check`` (row 17f): the chunked layer's four dropout masks
  drawn in data order and in the backward's reverse chunk order, bit for
  bit.

Each runs as ``python -m datamining_recblr_torch.probes.<name>`` with the
JAX probe's arguments, on the card by default (``--device cpu`` runs the
plain versions, and prints host times); each kernel's CUDA source
(``csrc/probe_<name>.cu``) is built at the probe's first use, apart from
the model paths' kernels.
"""
