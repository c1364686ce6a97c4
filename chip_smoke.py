#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's thirty-five CUDA kernels from the twenty-seven sources
of ``datamining_recblr_torch/csrc`` (both fused recurrent layers of
RecBLR, forward and backward; the attention baselines' LN prologue and
both transformer layers, forward and backward; BERT4Rec's
selected-positions top layer and the whole-table softmax CE, forward and
backward; the sequence-chunked recurrent layer and the vocab-chunked CE,
forward and backward, and the embedding-table gradient; a one-layer
RecBLR's input dropout and LN, the linear scan and the standalone BD-LRU,
forward and backward; the masked-softmax attention of the baselines'
per-op composition, forward and backward; the six probes' eight kernels
of queue B row 17) and, phase by phase:

* holds each kernel against its plain PyTorch version at B 256, T 200:
  the RecBLR forwards at dropout 0 (serving), then every RecBLR kernel's
  output and gradients against autograd of the plain versions, fp32 and
  bf16, at dropout 0 and 0.2, and the kernels' dropout mask bit for bit;
  then the three attention forwards, fp32 and bf16, causal and
  bidirectional, two activations, lengths 0, 1 and T; then their
  outputs, dx, dpos and every weight grad against autograd of the plain
  versions at dropout 0 and 0.5, and each of their masks bit for bit;
  then BERT4Rec's two new kernels, forward and backward, fp32 and bf16
  (the selected-positions layer at B 256, S 40, dropout 0 and 0.2, with
  repeated positions; the CE at N 81,920, V 3,417), and the selected
  layer's masks bit for bit; then the XLong configuration's kernels
  (``xlong-kernel-vs-plain``: the chunked layer, and K1 and K2 on their
  recompute branch, at B 512, T 1,024; the chunked CE at N 512, V 329,728;
  the table gradient at N 524,288; a bf16 table and bias through both CE
  paths) and the chunked layer's mask across chunk edges
  (``xlong-mask-bits``); then the kernels of RecBLR's paths outside the
  whole-layer kernels at those paths' shapes, forward and backward
  (``dropout-ln-*`` at B 2,048, T 200, D 64; ``scan-*`` at B 2,048,
  T 200, C 256; ``bdlru-*`` at B 512, T 1,020, C 128); then the
  attention kernel (queue B row 15) forward and backward at the d256
  shape (B 2,048, 2 heads of 128, T 200) and at T 2,048, fp32 and bf16,
  causal and bidirectional, p = 0 and 0.2 (``attention-kernel-vs-plain``),
  and its probability masks bit for bit (``attention-mask-bits``);
* serves RecBLR, SASRec and BERT4Rec at full width (hidden 64, 2 layers,
  T 200, V 3,417; 2 heads and an FFN of 256 for the baselines) through
  ``Recommender.recommend`` against the same model through the plain
  versions, with one launch of each of the model's kernels per call,
  and times it; then RecBLR at XLong (T 1,024, V 329,722, bf16:
  ``serve-xlong-*``), and RecBLR on its three paths outside the
  whole-layer kernels (``serve-onelayer-*``, ``serve-wide-*``,
  ``serve-longodd-*``);
* trains RecBLR (dropout 0.2), SASRec (dropout 0.5 / 0.5) and BERT4Rec
  (cloze, mask_ratio 0.2, dropout 0.2 / 0.2) at the bench.py shape (batch
  2,048, CE, Adam, fp32 and bf16 compute): one launch of each of the
  model's kernels per step (and of the table gradient under bf16), one
  step against the same step through the plain versions, the step time
  and a profile; then RecBLR at XLong (``xlong-train-*``: batch 512, T
  1,024, V 329,722, fp32 and bf16; the step against the plain step at
  that batch); then RecBLR on the paths outside the whole-layer kernels,
  fp32 and bf16: one layer (``onelayer-train-*``: bench.py's shape with
  num_layers 1, and H&M's T 50 and dropout 0.4 as a further step check),
  C 256 (``wide-train-*``: expand 4) and T 1,020, which no chunk divides
  (``longodd-train-*``: the XLong widths, batch 512);
* steps RecBLR at the bench shape with d_conv 9 through the whole-layer
  kernels against its plain step (``dconv9-train-step-vs-plain``);
* serves and trains SASRec and BERT4Rec at hidden 256 (``d256``: 2
  heads, FFN 1,024, T 200, batch 2,048, fp32 and bf16), a width the
  whole-layer kernels do not take, on the per-op composition through the
  attention kernel, the LN prologue, the whole-table CE (BERT4Rec) and,
  in bf16, the table gradient: ``serve-sasrec-d256-*``,
  ``serve-bert4rec-d256-*``, ``sasrec-d256-train-*`` and
  ``bert4rec-d256-train-*`` (launches, each request and step against the
  same model with every kernel swapped for its plain version, time,
  profile, peak memory); then SASRec at T 2,048 (``long``: hidden 64, one
  request of 8 users and one step at batch 32 against the plain
  versions, untimed); then both at hidden 528 (``h528``: 2 heads of 264,
  FFN 2,112, T 200, bf16, untimed: one request of 8 users and one step at
  batch 32 against the plain versions, with no launch of the per-op
  kernels, whose widths it exceeds, and one of the table gradient, in
  two column slices);
* runs ``Trainer.fit`` and ``evaluate(load_best=True)`` for the three on
  a small Markov dataset: the loss falls and valid NDCG@10 is above 0;
* serves and resumes a checkpoint the JAX package wrote
  (``tests/fixtures/jax_checkpoint/``: RecBLR at the bench serving width,
  pickled) through the port's reader, ``Recommender.from_checkpoint`` and
  ``Trainer.resume_from`` (``jax-checkpoint``): the requests' ids equal
  the JAX package's, the scores within 1e-4 of the largest, rows 1 and 3
  launched, then the three recorded steps through rows 1-4, each loss
  within 1e-4 relative of JAX's;
* runs the experiment path at ml1m-synth's full size (the stat-matched
  log of seed 2020 written as an ``.inter`` file, ``build_dataset`` from
  the reference config through the native loader, held array for array
  against the Python builder with both build times (``native-loader``),
  ``run_experiment`` for one epoch): RecBLR CE fp32
  with full-sort evaluation (``experiment-ml1m-R``: valid NDCG@10 at least
  0.15), RecBLR BPR bf16 with uni100 (``experiment-ml1m-R-bpr-uni100``:
  valid hit@10 above 0.198, twice chance) and BERT4Rec BPR fp32 with pop100
  (``experiment-ml1m-B-bpr-pop100``: uni100 hit@10 above 0.198, the pop100
  metrics against a plain recomputation), each with the dataset's summary,
  the test from the best checkpoint and every kernel launch of its path
  counted (one a train step or eval batch);
* runs the cold-start pipeline at amazon-beauty's size (beauty-synth of
  seed 2020, the user split with 1,890 held-out users, RecBLR at the
  reference config for one epoch): ``run_unseen_experiment`` in mode none,
  then mode pre on the same split files (``cold-start-none``,
  ``cold-start-pre``: held-out, evaluable users and items mapped, the
  seconds of the similarity, the epoch and the held-out evaluation, the
  seen- and unseen-user tests; rows 1-4 counted with the held-out batches,
  mode none's unseen metrics against a plain recomputation, pre evaluating
  at least as many users, the split reused unchanged, every HR@10 above
  five times chance);
* runs the meshed path (``parallel/``): RecBLR at the bench shape (fp32,
  p 0) through the meshed ``Trainer`` at {data: 1, model: 1} on an NCCL
  group of one rank against the unmeshed trainer (``mesh-nccl-world1``:
  3 losses, launches, both step times); then a {data: 2, model: 2} mesh
  of four processes sharing the card over gloo (``mesh-gloo-*``): the
  collectives the port calls on CUDA tensors, then RecBLR with the table
  row-sharded (3 steps, one full-sort eval batch whose ranks, and 256
  users' ``recommend`` ids through ``sharded_topk``, equal the
  single-process ones), SASRec and BERT4Rec under ``auto`` (replicated
  tables, 2 steps; BERT4Rec's CE through row 13), BPR with uni100
  evaluation, and XLong (bf16, one step, the table row-sharded, the
  vocab-parallel CE in row 14's place), each against the same case in
  one process from the same seed on the same batches, with each rank's
  launches and wall seconds (time-shared on one card: no scaling figure);
* runs the ``seq`` axis as four gloo ranks sharing the card
  (``seq_phases``): rows 7, 15 and 6 at a seq rank's chunk against their
  plain versions (row 15 at Tq 100 of T 200, q0 0 and 100, the chunks' dk
  and dv summed against the whole call's; row 6 at t0 100), then
  ``seq_parallel_scan``, RecBLR on {data: 2, seq: 2}, XLong on {seq: 4},
  SASRec and BERT4Rec on {data: 2, seq: 2} and RecBLR and BERT4Rec on
  {model: 2, seq: 2} (table row-sharded), each against one process in
  the seq axis's composition and on the model's own kernels;
* times every kernel beside its bound, its plain version and, where one
  PyTorch call computes the same function, that call (row 15 beside
  ``F.scaled_dot_product_attention`` with the same additive mask; the
  transformer-layer forward also in bf16 at B 2,048 and 256, beside a bf16
  ``TransformerEncoderLayer``; the forwards whose products run on the
  tensor cores beside their FMA-priced bound too), and the
  transformer-layer forward and backward by phase (``kernel-time-phase``:
  the projection, the attention and the tail; T', A', P' and the
  reduction; at the bench shape, causal and bidirectional, fp32 and bf16)
  and the chunked CE's backward by pass (pass a, the reduction, pass b at
  the XLong loss, on the tensor cores), and rows 1, 3, 8 and 9's forwards
  by phase (``recblr_fwd_phase_times``: phase A, the scan and the tail,
  from torch.profiler beside the call's CUDA-event time); then the CE
  forwards in bf16, at D 256 and at the longodd loss, row 14's by kernel
  (``ce_fwd_kernel_times``), the forwards that serving launches
  outside the whole-layer kernels at B 256 (``served_kernel_times``),
  the table gradient at the bench step, checked as at XLong, and by
  sub-kernel at both (``row16_times``: the sort, the piece, group and row
  sums, the wrapper's share), and rows 6 and 5's forwards at B 2,048 and
  256, fp32 and bf16 (``ln_fwd_kernel_times``), and rows 15 and 6 at the
  seq cases' chunk beside the library call with the chunk's mask
  (``chunk_kernel_times``, ``shape=chunk``);
* runs the probes (``probes/``, queue B row 17): their eight kernels
  against their plain versions at the JAX probes' defaults
  (``probe-vs-plain``: unit_overlap's five modes, vpu_ops' fourteen
  chains, the flat and two-level scans, the bf16 product at every block
  height, the embedding gather in bf16 and fp32 and both mask kernels,
  bit for bit), then the six entry points as a user runs them
  (``probe-time``, each kernel's launches counted from 0), unit_overlap
  again at an nv that brings vpu_only within 2x of mm_only and
  mask_replay_check again at the XLong layer's sizes, and each kernel
  beside its bound, its plain version and, for the bf16 product and the
  gather, ``torch.mm`` and ``tab[ids]`` (``probe-kernel-time``).

A rerun of each RecBLR layer kernel, forward and backward, gives the same
bits, and each RecBLR training and serving profile fails unless phase A
(and, off the longodd path, the tail) ran its tensor-core kernel, each
XLong and longodd training profile unless row 14's forward did, and each
fp32 BERT4Rec training profile unless row 13's forward did
(``fwd_mma_required``).  Each phase prints one line; any failure exits
non-zero.  The line before the last is the kernels' JSON record, the last
line the device JSON.  Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import contextlib
import functools
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from datamining_recblr_torch.config import Config
from datamining_recblr_torch.models import get_model
from datamining_recblr_torch.models import layers as L
from datamining_recblr_torch.models import recblr as RB
from datamining_recblr_torch.ops import _cuda, philox
from datamining_recblr_torch.ops import attention as A
from datamining_recblr_torch.ops import embedding as E
from datamining_recblr_torch.ops import fused_block as FB
from datamining_recblr_torch.ops import fused_ce as FCE
from datamining_recblr_torch.ops import fused_layer as FL
from datamining_recblr_torch.ops import fused_bdlru as FBD
from datamining_recblr_torch.ops import fused_layer_chunked as FLC
from datamining_recblr_torch.ops import scan as SC
from datamining_recblr_torch.probes import _bench as PB
from datamining_recblr_torch.probes import ce_mxu as PCE
from datamining_recblr_torch.probes import emb_gather as PEG
from datamining_recblr_torch.probes import mask_replay_check as PMR
from datamining_recblr_torch.probes import scan_chunked as PSC
from datamining_recblr_torch.probes import unit_overlap as PUO
from datamining_recblr_torch.probes import vpu_ops as PVO
from datamining_recblr_torch.serve import Recommender

SEED = 0
B, T, D, C, K, FF = 256, 200, 64, 128, 4, 256  # serving shape
HEADS, INNER = 2, 256  # the attention baselines' serving shape (bench.py)
N_ITEMS, TOP_K = 3417, 10
# H100 SXM peaks (NVIDIA data sheet, 700 W): fp32 outside the tensor
# cores, bf16 on the tensor cores (dense) and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12
FP32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_RTOL = 2.0 ** -7  # one bf16 ulp of the value, at most
# the transformer-layer kernels in bf16: one bf16 ulp of the value plus
# 2^-9 of the largest value (an operand rounded to the other bf16
# neighbour after an fp32 sum in another order, times a weight)
ATTN_BF16_ABS = 2.0 ** -9
# gradients: max |kernel - plain| over max |plain|; fp32 FMA sums in
# another order than cuBLAS and autograd, over up to B*T = 409,600 terms
GRAD_RTOL = 1e-4
# a bf16 step's item-embedding gradient against the plain bf16 step's: its
# largest rows are items seen once in the batch, each row one bf16
# cotangent of the layers' backward, so a bf16 ulp (2^-8 of the value)
# that the two compositions round differently shows there undivided
ITEM_BF16_RTOL = 2.0 ** -6
DROPOUT = 0.2  # RecBLR's dropout_prob
TRAIN_B = 2048  # bench.py's training batch
TRAIN_STEPS = 20
FIT_EPOCHS = 3
# the kernels of the training step, whose launches it counts
LAUNCH_COUNTED = (FL.fused_recurrent_layer, FL.fused_recurrent_layer_last,
                  FL.fused_recurrent_layer_bwd, FL.fused_recurrent_layer_last_bwd)
# the kernels of the attention baselines' serving path, one launch each
# per recommend()
ATTN_COUNTED = (FL.fused_ln_dropout, FB.fused_transformer_layer,
                FB.fused_transformer_layer_last)
# SASRec's training step: those three and their backwards
SAS_COUNTED = ATTN_COUNTED + (FL.fused_ln_dropout_bwd, FB.fused_transformer_layer_bwd,
                              FB.fused_transformer_layer_last_bwd)
SAS_DROPOUT = 0.5  # SASRec's hidden_dropout_prob and attn_dropout_prob
# BERT4Rec's training step: the prologue and the layer with their
# backwards, the selected-positions top layer and the whole-table CE
B4R_COUNTED = (FL.fused_ln_dropout, FB.fused_transformer_layer, FB.fused_transformer_layer_sel,
               FCE.fused_softmax_ce, FL.fused_ln_dropout_bwd, FB.fused_transformer_layer_bwd,
               FB.fused_transformer_layer_sel_bwd, FCE.fused_softmax_ce_bwd)
B4R_DROPOUT = 0.2  # BERT4Rec's hidden_dropout_prob and attn_dropout_prob
MASK_LEN = 40      # BERT4Rec's cloze budget at T 200: int(mask_ratio 0.2 * 200)
# the XLong configuration (configs/paper/config_xlong_paper.yaml): T 1,024,
# 329,722 items (xlong-synth), train batch 512, histories of 2 .. 1,000
XT, XV, XB, XMAX_LEN = 1024, 329_722, 512, 1000
XTRAIN_STEPS = 10
# RecBLR's long-context training step: row 9 and K2 forward, row 14 forward
# and backward, K2 and row 9 backward (and, under bf16, row 16)
XLONG_COUNTED = (FLC.fused_recurrent_layer_chunked, FL.fused_recurrent_layer_last,
                 FCE.fused_softmax_ce_chunked, FCE.fused_softmax_ce_chunked_bwd,
                 FL.fused_recurrent_layer_last_bwd, FLC.fused_recurrent_layer_chunked_bwd)
# RecBLR outside the whole-layer kernels, each path at full width (hidden
# 64, d_conv 4, FFN 256, dropout 0.2, CE, Adam):
#   onelayer  bench.py's shape with num_layers 1 (full_exp.py's 1layer
#             ablation): row 5, then K2 (C 128)
#   wide      bench.py's shape with expand 4 (C 256): the unfused
#             composition, row 7 forward and reverse in each layer
#   longodd   the XLong widths at T 1,020, which no chunk divides: the
#             unfused composition, row 8 in each layer, rows 14 and 16
# each with the kernels a training step launches and how often, those a
# recommend() launches and the dtypes it serves in (longodd in the XLong
# configuration's bf16); "hm" is H&M's one layer (configs/config_hm.yaml:
# T 50, dropout 0.4), a further step check of the onelayer path
WIDE_C, LT = 256, 1020
HM_T, HM_DROPOUT = 50, 0.4
SLICE_PATHS = {
    "onelayer": dict(
        cfg={"num_layers": 1}, t=T, v=N_ITEMS, batch=TRAIN_B,
        counted=(FL.fused_dropout_ln, FL.fused_recurrent_layer_last, FL.fused_dropout_ln_bwd,
                 FL.fused_recurrent_layer_last_bwd), per_step=(1, 1, 1, 1),
        served=(FL.fused_dropout_ln, FL.fused_recurrent_layer_last), per_call=1,
        serve_dtypes=("float32", "bfloat16")),
    "hm": dict(
        cfg={"num_layers": 1, "dropout_prob": HM_DROPOUT}, t=HM_T, v=N_ITEMS, batch=TRAIN_B,
        counted=(FL.fused_dropout_ln, FL.fused_recurrent_layer_last, FL.fused_dropout_ln_bwd,
                 FL.fused_recurrent_layer_last_bwd), per_step=(1, 1, 1, 1)),
    "wide": dict(
        cfg={"expand": WIDE_C // D}, t=T, v=N_ITEMS, batch=TRAIN_B,
        counted=(SC.linear_scan, SC.linear_scan_reverse), per_step=(2, 2),
        served=(SC.linear_scan,), per_call=2, serve_dtypes=("float32", "bfloat16")),
    "longodd": dict(
        cfg={}, t=LT, v=XV, batch=XB,
        counted=(FBD.fused_bdlru, FBD.fused_bdlru_bwd, FCE.fused_softmax_ce_chunked,
                 FCE.fused_softmax_ce_chunked_bwd), per_step=(2, 2, 1, 1),
        served=(FBD.fused_bdlru,), per_call=2, serve_dtypes=("bfloat16",)),
}


# phase A and the tail of the RecBLR layer forwards on the tensor cores
# (csrc/layer_fwd.cuh), and the RecBLR profiles that must show them: every
# path through the whole-layer kernels runs both; longodd's unfused layers
# run phase A alone (row 8), and the wide path (C 256) neither.  The CE
# forwards on the tensor cores (csrc/ce_mma.cuh): row 14's in the XLong and
# longodd steps (D 64, both dtypes), row 13's in BERT4Rec's fp32 steps (D 64
# and, on the d256 path, 256; its bf16 forward keeps the FMA kernel,
# ``FCE.fwd_uses_mma``)
RECBLR_FWD_MMA = ("phase_a_mma_kernel", "tail_mma_kernel")
CE_FWD_MMA, CCE_FWD_MMA = "ce_fwd_mma_kernel", "cce_fwd_mma_kernel"
FWD_MMA_REQUIRED = dict(
    {prefix: RECBLR_FWD_MMA for prefix in ("train", "onelayer-train", "serve", "serve-xlong",
                                           "serve-onelayer")},
    **{"xlong-train": RECBLR_FWD_MMA + (CCE_FWD_MMA,),
       "longodd-train": (RECBLR_FWD_MMA[0], CCE_FWD_MMA), "serve-longodd": RECBLR_FWD_MMA[:1]})
FP32_FWD_MMA_REQUIRED = {"bert4rec-train": (CE_FWD_MMA,), "bert4rec-d256-train": (CE_FWD_MMA,)}


def fwd_mma_required(prefix, dtype_name):
    """The tensor-core forward kernels a profile of ``prefix`` must show."""
    extra = FP32_FWD_MMA_REQUIRED.get(prefix, ()) if dtype_name == "float32" else ()
    return FWD_MMA_REQUIRED.get(prefix, ()) + extra


class SmokeFailure(RuntimeError):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


_START = time.perf_counter()


def phase(name, **fields):
    """One log line; ``at_s``: seconds since the script started, so a
    phase's share of the run is the difference between its lines'."""
    fields["at_s"] = f"{time.perf_counter() - _START:.1f}"
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def layer_params(gen, dev, prologue):
    def r(*s, std=0.05):
        return (std * torch.randn(s, generator=gen)).to(dev)

    p = {
        "w_in": r(D, 2 * C), "wc": r(K, C, std=0.5), "bc": r(C, std=0.5),
        "wg": r(C, 2 * C), "bg": r(2 * C),
        "lam": torch.linspace(-2.2, -6.9, C).to(dev),
        "w_out": r(C, D), "ln1_s": 1 + r(D), "ln1_b": r(D),
        "w1": r(D, FF), "b1": r(FF), "w2": r(FF, D), "b2": r(D),
        "ln2_s": 1 + r(D), "ln2_b": r(D),
    }
    if prologue:
        p.update(pl_s=1 + r(D), pl_b=r(D))
    return p


def block_params(gen, dev):
    """One transformer layer's weights (fused_block PARAM_NAMES); Q and K
    wider than the rest so that attention is far from uniform."""
    def r(*s, std=0.05):
        return (std * torch.randn(s, generator=gen)).to(dev)

    p = {}
    for n in "qkvo":
        p[f"w_{n}"], p[f"b_{n}"] = r(D, D, std=0.2 if n in "qk" else 0.05), r(D)
    p.update(ln1_s=1 + r(D), ln1_b=r(D), w1=r(D, INNER), b1=r(INNER), w2=r(INNER, D),
             b2=r(D), ln2_s=1 + r(D), ln2_b=r(D))
    return p


def serving_lens(gen, b):
    lens = torch.randint(0, T + 1, (b,), generator=gen)
    lens[:3] = torch.tensor([0, 1, T])[: min(3, b)]
    return lens


# ---------------------------------------------------------------------------
# bounds: matmul, conv and scan operations (2 per multiply-add) over the
# fp32 peak, those of products with both operands in bf16 over the bf16
# tensor-core peak, and bytes read once / written once over HBM bandwidth
# ---------------------------------------------------------------------------

def _params_bytes(p):
    return sum(v.numel() * v.element_size() for v in p.values())


def _bound(flops, nbytes, bf16_flops=0, tf32_flops=0):
    """(bound ms, FLOPs, what bounds it); ``flops`` at the fp32 peak,
    ``bf16_flops`` (products of bf16 operands) at the bf16 peak,
    ``tf32_flops`` (products of TF32 operands) at the TF32 peak."""
    t_ops = (flops / PEAK_FP32_FLOPS + bf16_flops / PEAK_BF16_FLOPS
             + tf32_flops / PEAK_TF32_FLOPS)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3, flops + bf16_flops + tf32_flops,
            "operations" if t_ops >= t_bytes else "bytes")


def _recblr_bound(mm, fma, nbytes, priced_fma=False):
    """_bound of a RecBLR layer kernel: its products ``mm`` on the tensor
    cores as 3xTF32 (three TF32 products each, fp32 math whatever x's
    dtype), the rest ``fma`` on the fp32 pipe; ``priced_fma``: every
    product at the fp32 FMA peak (the FMA-priced bound, kept beside it)."""
    if priced_fma:
        return _bound(mm + fma, nbytes)
    return _bound(fma, nbytes, 0, 3 * mm)


# a position's products in K1's forward (the in-projection, the gates,
# W_out, the FFN) and the rest (the conv and the scan)
K1_MM = 2 * D * 2 * C + 2 * C * 2 * C + 2 * C * D + 4 * D * FF
K1_REST = 2 * K * C + 2 * C


def k1_bound_ms(b, t, p, act_bytes, priced_fma=False):
    nbytes = 2 * b * t * D * act_bytes + _params_bytes(p)
    return _recblr_bound(b * t * K1_MM, b * t * K1_REST, nbytes, priced_fma)


def k2_bound_ms(lens, p, act_bytes, t=T, priced_fma=False):
    # the output reads the scan at position len-1 only, so positions at
    # or beyond a row's length are work this data does not need
    n = lens.clamp(0, t).where((lens >= 1) & (lens <= t), torch.zeros_like(lens))
    positions = int(n.sum())
    b = lens.numel()
    mm = positions * (2 * D * C + 2 * C * 2 * C) + b * (2 * D * C + 2 * C * D + 4 * D * FF)
    nbytes = positions * D * act_bytes + b * 4 + b * D * act_bytes + _params_bytes(p)
    return _recblr_bound(mm, positions * K1_REST, nbytes, priced_fma)


def ln_bound_ms(b, act_bytes, t=T):
    # x read and out written once, pos [t, D] and scale, bias [D]; about 8
    # operations per element (add, mean, centre, square-sum, scale, shift)
    nbytes = 2 * b * t * D * act_bytes + t * D * 4 + 2 * D * 4
    return _bound(8 * b * t * D, nbytes)


def _kept_keys(lens, t):
    """Per row, the keys a query can weigh: those below the length (all T
    where the length is 0, since an all-masked row averages every key)."""
    n = lens.clamp(0, t)
    return torch.where(n == 0, torch.full_like(n, t), n)


def _mma_bound(mma, fma, nbytes, act_bytes, priced_fma=False):
    """_bound of a forward whose products ``mma`` run on the tensor cores
    (bf16 operands for a bf16 input, else 3xTF32: three TF32 products
    each) and ``fma`` on the fp32 pipe; ``priced_fma``: every product at
    the fp32 FMA peak (the FMA-priced bound, kept beside the new one)."""
    if priced_fma:
        return _bound(mma + fma, nbytes)
    if act_bytes == 2:
        return _bound(fma, nbytes, mma)
    return _bound(fma, nbytes, 0, 3 * mma)


def block_bound_ms(lens, t, causal, p, act_bytes, stash=False, priced_fma=False):
    # QKV, W_o and the FFN at every position; QK^T and P.V (4D per pair
    # over all heads) only for the query-key pairs whose probability this
    # data can make non-zero: keys below the length, and not after the
    # query when causal; all on the tensor cores.  A training forward also
    # writes q/k/v and the context (4D fp32 per position).
    n = _kept_keys(lens, t).double()
    if causal:
        pairs = torch.where(lens.clamp(0, t) == 0, n * t, n * (n + 1) / 2 + (t - n) * n)
    else:
        pairs = n * t
    b = lens.numel()
    flops = b * t * (8 * D * D + 4 * D * INNER) + 4 * D * float(pairs.sum())
    nbytes = b * t * D * (2 * act_bytes + (16 if stash else 0)) + b * 4 + _params_bytes(p)
    return _mma_bound(flops, 0, nbytes, act_bytes, priced_fma)


def _fma_field(fma, name):
    """The FMA-priced bound of a kernel whose products moved to the tensor
    cores, as a kernel-time field (none for the other kernels)."""
    return {"fma_bound_ms": f"{fma[name][0]:.5f}"} if name in fma else {}


def block_bwd_bound_ms(lens, t, causal, p, act_bytes):
    # about twice the forward's products (two gradient products per
    # forward product); x, dout and dx, the kept q/k/v and context read
    # once, the params read and their grads written
    flops = 2 * block_bound_ms(lens, t, causal, p, act_bytes, priced_fma=True)[1]
    b = lens.numel()
    nbytes = b * t * D * (3 * act_bytes + 16) + b * 4 + 2 * _params_bytes(p)
    return _bound(flops, nbytes)


def _last_positions(lens, t):
    # the positions a last-query row weighs (lengths 0 or above T select no
    # query and weigh every key)
    return torch.where((lens >= 1) & (lens <= t), lens, torch.full_like(lens, t)).double()


def block_last_bound_ms(lens, t, p, act_bytes, stash=False, priced_fma=False):
    # per row: the query, W_o and the FFN once; K and V projections and
    # QK^T, P.V at the positions its one query weighs; the projections,
    # W_o and the FFN on the tensor cores, QK^T and P.V on the fp32 pipe.
    # A training forward also writes k/v there (2D fp32) and the [B, D]
    # context.
    n = float(_last_positions(lens, t).sum())
    b = lens.numel()
    mma = b * (4 * D * D + 4 * D * INNER) + n * 4 * D * D
    nbytes = n * D * act_bytes + b * D * act_bytes + b * 4 + _params_bytes(p)
    if stash:
        nbytes += n * 2 * D * 4 + b * D * 4
    return _mma_bound(mma, n * 4 * D, nbytes, act_bytes, priced_fma)


def block_last_bwd_bound_ms(lens, t, p, act_bytes):
    # twice the forward's products; x and the kept k/v at the weighed
    # positions, dout and the context per row read, dx [B, T, D] written
    # in full, the params read and their grads written
    flops = 2 * block_last_bound_ms(lens, t, p, act_bytes, priced_fma=True)[1]
    n = float(_last_positions(lens, t).sum())
    b = lens.numel()
    nbytes = (n * D * (act_bytes + 8) + b * t * D * act_bytes + b * D * (act_bytes + 4)
              + b * 4 + 2 * _params_bytes(p))
    return _bound(flops, nbytes)


def ln_bwd_bound_ms(b, act_bytes, t=T):
    # x, dout read and dx written once; pos read and dpos written; about
    # 16 operations per element (the LN recomputed and its backward)
    nbytes = 3 * b * t * D * act_bytes + 2 * t * D * 4 + 4 * D * 4
    return _bound(16 * b * t * D, nbytes)


def sel_bound_ms(lens, s, p, act_bytes, stash=False, priced_fma=False):
    # per row: K and V at the keys its queries can weigh (below the length;
    # all T at length 0); per selected query its projection, QK^T and P.V
    # over those keys (4D per key over all heads), W_o and the FFN; QK^T
    # and P.V on the fp32 pipe, the rest on the tensor cores.  x read at
    # the weighed keys, the [B, S, D] output written; a training forward
    # also writes k/v there and the [B, S, D] fp32 queries and context.
    n = _kept_keys(lens, T).double()
    keys = float(n.sum())
    b = lens.numel()
    mma = keys * 4 * D * D + b * s * (4 * D * D + 4 * D * INNER)
    nbytes = keys * D * act_bytes + b * s * (D * act_bytes + 4) + b * 4 + _params_bytes(p)
    if stash:
        nbytes += keys * 2 * D * 4 + 2 * b * s * D * 4
    return _mma_bound(mma, s * 4 * D * keys, nbytes, act_bytes, priced_fma)


def sel_bwd_bound_ms(lens, s, p, act_bytes):
    # twice the forward's products; x and the kept k/v at the weighed keys,
    # dout and the kept queries and context read, dx [B, T, D] written in
    # full, the params read and their grads written
    flops = 2 * sel_bound_ms(lens, s, p, act_bytes, priced_fma=True)[1]
    keys = float(_kept_keys(lens, T).double().sum())
    b = lens.numel()
    nbytes = (keys * D * (act_bytes + 8) + b * T * D * act_bytes
              + b * s * (D * (act_bytes + 8) + 4) + b * 4 + 2 * _params_bytes(p))
    return _bound(flops, nbytes)


def ce_bound_ms(n, v, act_bytes, train=False, mm_bf16=False, d=D, priced_fma=False):
    # the [N, V] logits (2NVD); x, the table, the bias and the targets read
    # once, nll (and in training lse) written.  Priced as the least the
    # tensor cores need at the plain version's accuracy, as the backward's:
    # bf16 operands with mm_bf16, otherwise three TF32 products of the split
    # operands; ``priced_fma``: every product at the fp32 FMA peak (the
    # FMA-priced bound, kept beside it)
    nbytes = n * d * act_bytes + v * (d + 1) * 4 + n * 4 * (3 if train else 2)
    mm = 2 * n * v * d
    if priced_fma:
        return _bound(mm, nbytes)
    return _bound(0, nbytes, mm) if mm_bf16 else _bound(0, nbytes, 0, 3 * mm)


def ce_bwd_bound_ms(n, v, act_bytes, mm_bf16=False, d=D):
    # the logits, dx = g table and dtable = g^T x (3 x 2NVD); x, targets,
    # dnll, lse, the table and the bias read, dx, dtable and dbias written.
    # Priced as the least the tensor cores need at the plain version's
    # accuracy: with mm_bf16 the logits and dx on bf16 operands and dtable
    # with g and x unrounded (g split in two TF32 terms against a bf16 x,
    # exact in TF32, three products for an fp32 x); otherwise every product
    # at fp32 accuracy as three TF32 products of the split operands
    nbytes = 2 * n * d * act_bytes + 3 * n * 4 + 2 * v * (d + 1) * 4
    mm = 2 * n * v * d
    if mm_bf16:
        return _bound(0, nbytes, 2 * mm, (2 if act_bytes == 2 else 3) * mm)
    return _bound(0, nbytes, 0, 9 * mm)


def time_ms(fn, reps=20, warmup=3):
    """Median of ``reps`` single-call CUDA-event timings."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def environment():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    phase("env", python=sys.version.split()[0], torch=torch.__version__,
          cuda=torch.version.cuda, device=repr(torch.cuda.get_device_name(0)),
          count=torch.cuda.device_count())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase("tf32", matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
          cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    t0 = time.perf_counter()
    per_source = _cuda.build(_cuda.SOURCES + _cuda.PROBE_SOURCES)
    phase("build", seconds=f"{time.perf_counter() - t0:.1f}",
          **{k: f"{v:.1f}s" for k, v in per_source.items()})
    for src, log in _cuda.BUILD_LOGS.items():
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", log)]
        spills = [int(w) for w in re.findall(r"(\d+) bytes spill stores", log)]
        phase("ptxas", source=src, kernels=len(regs), max_registers=max(regs, default=0),
              spill_store_bytes=sum(spills))
        if src in PTXAS_KERNEL_SOURCES:
            ptxas_kernels(src, log)
    return smi


# the kernels of row 15, the RecBLR layers' and the CEs' tensor-core
# phases, and the sources whose ptxas output is read kernel by kernel
PTXAS_KERNEL_NAMES = ("attn_fwd_mma_kernel", "dkdv_mma_kernel", "dq_mma_kernel",
                      "attn_fwd_kernel", "dkdv_kernel", "dq_kernel", "delta_kernel",
                      "tail_bwd_mma_kernel", "gate_bwd_mma_kernel", "inproj_bwd_mma_kernel",
                      "phase_a_mma_kernel", "tail_mma_kernel", "cce_fwd_mma_kernel",
                      "ce_fwd_mma_kernel", "cce_dx_mma_kernel", "ce_dx_mma_kernel",
                      "cce_dtab_mma_kernel", "ce_dtab_mma_kernel", "radix_hist_kernel",
                      "radix_scatter_kernel", "piece_sum_kernel", "group_sum_kernel",
                      "row_sum_kernel", "ln_pos_kernel", "ln_pos_bwd_kernel",
                      "unit_overlap_kernel")
PTXAS_KERNEL_SOURCES = ("attention.cu", "attention_bwd.cu", "fused_layer.cu",
                        "fused_layer_last.cu", "fused_layer_chunked.cu", "fused_bdlru.cu",
                        "fused_layer_bwd.cu", "fused_layer_last_bwd.cu",
                        "fused_layer_chunked_bwd.cu", "fused_bdlru_bwd.cu", "fused_ce.cu",
                        "fused_ce_chunked.cu", "emb_grad.cu", "ln_dropout.cu",
                        "probe_unit_overlap.cu")


def ptxas_kernels(src, log):
    """One ptxas-kernel line per kernel of a source: its registers and
    spill bytes as ptxas reports them (template arguments after the input
    type, where the kernel takes one: row 15's tiles, the RecBLR kernels'
    LAST / XB flags, the CE kernels' mm_bf16 and padded width)."""
    for part in log.split("Compiling entry function '")[1:]:
        name = part.split("'")[0]
        m = re.search(r"(" + "|".join(PTXAS_KERNEL_NAMES) + r")I(f|13__nv_bfloat16)?(\w*?)EE",
                      name)
        regs = re.search(r"Used (\d+) registers", part)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", part)
        if m and regs:
            args = re.sub(r"Li(\d+)E?", r"\1,", m.group(3))
            args = re.sub(r"Lb([01])E?", lambda b: ("true" if b.group(1) == "1" else "false")
                          + ",", args)
            phase("ptxas-kernel", source=src, kernel=m.group(1),
                  dtype={"f": "float32", None: "-"}.get(m.group(2), "bfloat16"),
                  template_args=args.rstrip(",") or "-",
                  registers=int(regs.group(1)),
                  spill_store_bytes=int(spills.group(1)) if spills else "not reported",
                  spill_load_bytes=int(spills.group(2)) if spills else "not reported")


def _bf16_ok(got, want):
    g, w = got.float(), want.float()
    return bool(((g - w).abs() <= BF16_RTOL * w.abs() + 1e-4).all())


def kernels_vs_plain(dev):
    gen = torch.Generator().manual_seed(SEED)
    p1 = layer_params(gen, dev, prologue=True)
    p2 = layer_params(gen, dev, prologue=False)
    x = torch.randn((B, T, D), generator=gen).to(dev)
    lens = serving_lens(gen, B).to(dev)
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        xd = x.to(dt)
        cases = {
            "fused_recurrent_layer": (
                FL.fused_recurrent_layer(xd, p1, prologue=True),
                FL.fused_recurrent_layer_plain(xd, p1, prologue=True)),
            "fused_recurrent_layer_last": (
                FL.fused_recurrent_layer_last(xd, lens, p2),
                FL.fused_recurrent_layer_last_plain(xd, lens, p2)),
        }
        torch.cuda.synchronize()
        for name, (got, want) in cases.items():
            check(got.dtype == dt and got.shape == want.shape, f"{name} {dt}: shape/dtype")
            check(bool(torch.isfinite(got).all()), f"{name} {dt}: non-finite output")
            err = (got.float() - want.float()).abs().max().item()
            if dt == torch.float32:
                ok = torch.allclose(got, want, **FP32_TOL)
                tol = f"atol {FP32_TOL['atol']} rtol {FP32_TOL['rtol']}"
                errs[name] = err
            else:
                ok = _bf16_ok(got, want)
                tol = f"|err| <= 2^-7*|plain| + 1e-4"
            phase("kernel-vs-plain", kernel=name, dtype=str(dt).split(".")[-1],
                  shape=f"B{B}xT{T}xD{D}", max_abs_err=f"{err:.3e}", tol=repr(tol),
                  ok=ok)
            check(ok, f"{name} {dt}: kernel disagrees with its plain version")
    return p1, p2, lens, errs


def _grad_err_ok(got, want, dtype, is_dx):
    """(max |kernel - plain| / max |plain|, ok).  fp32 and every weight
    grad (fp32 on both sides): within GRAD_RTOL of the largest value;
    a bf16 dx: one bf16 ulp of the value on top of that."""
    g, w = got.float(), want.float()
    scale = float(w.abs().max()) or 1.0
    err = float((g - w).abs().max()) / scale
    if dtype == torch.bfloat16 and is_dx:
        ok = bool(((g - w).abs() <= BF16_RTOL * w.abs() + GRAD_RTOL * scale).all())
    else:
        ok = err <= GRAD_RTOL
    return err, ok


def _plain_vjp(fn, x, params, dout):
    """Output, dx and {name: grad} of a plain version by autograd."""
    xl = x.detach().clone().requires_grad_()
    pl = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    out = fn(xl, pl)
    names = list(pl)
    gs = torch.autograd.grad(out, [xl] + [pl[n] for n in names], dout)
    return out.detach(), gs[0], dict(zip(names, gs[1:]))


def train_lens(gen, b):
    lens = torch.randint(1, T + 1, (b,), generator=gen)
    lens[:4] = torch.tensor([0, 1, T, T + 5])  # 0 and T + 5 select nothing
    return lens


def training_kernels_vs_plain(dev):
    """Each kernel's output and every gradient against its plain version
    by autograd, fp32 and bf16, p = 0 and p = 0.2, at B = 256, T = 200; a
    rerun of each backward gives the same bits.  Returns the largest fp32 |kernel - plain| of each forward (output)
    and backward (dx and every grad)."""
    gen = torch.Generator().manual_seed(SEED + 2)
    p1 = layer_params(gen, dev, prologue=True)
    p2 = layer_params(gen, dev, prologue=False)
    x = torch.randn((B, T, D), generator=gen).to(dev)
    lens = train_lens(gen, B).to(dev)
    d1 = torch.randn((B, T, D), generator=gen).to(dev)
    d2 = torch.randn((B, D), generator=gen).to(dev)
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        for p in (0.0, DROPOUT):
            xd, dout1, dout2 = x.to(dt), d1.to(dt), d2.to(dt)
            seed = 1234567 + int(p * 10)
            out1, saved1 = FL.fused_recurrent_layer_train(xd, p1, True, True, True, p, seed)
            fwd_rerun1 = FL.fused_recurrent_layer_train(xd, p1, True, True, True, p, seed)
            dx1, g1 = FL.fused_recurrent_layer_bwd(xd, dout1, p1, True, True, True, p, seed,
                                                   saved=saved1)
            out2, saved2 = FL.fused_recurrent_layer_last_train(xd, lens, p2, True, True, p,
                                                               seed)
            fwd_rerun2 = FL.fused_recurrent_layer_last_train(xd, lens, p2, True, True, p, seed)
            dx2, g2 = FL.fused_recurrent_layer_last_bwd(xd, lens, dout2, p2, True, True, p,
                                                        seed, saved=saved2)
            rerun1 = FL.fused_recurrent_layer_bwd(xd, dout1, p1, True, True, True, p, seed,
                                                  saved=saved1)
            rerun2 = FL.fused_recurrent_layer_last_bwd(xd, lens, dout2, p2, True, True, p, seed,
                                                       saved=saved2)
            want1 = _plain_vjp(lambda a, q: FL.fused_recurrent_layer_plain(
                a, q, True, True, True, p, seed), xd, p1, dout1)
            want2 = _plain_vjp(lambda a, q: FL.fused_recurrent_layer_last_plain(
                a, lens, q, True, True, p, seed), xd, p2, dout2)
            torch.cuda.synchronize()
            tag = dict(dtype=str(dt).split(".")[-1], p=p)
            # a forward rerun: the output and, for K1, the whole stash (K2's
            # holds only the positions below each length)
            fwd_same = {
                "fused_recurrent_layer": torch.equal(fwd_rerun1[0], out1) and all(
                    torch.equal(a, b) for a, b in zip(fwd_rerun1[1], saved1)),
                "fused_recurrent_layer_last": torch.equal(fwd_rerun2[0], out2),
            }
            for name, out, dx, grads, (wout, wdx, wgrads), rerun in (
                ("fused_recurrent_layer", out1, dx1, g1, want1, rerun1),
                ("fused_recurrent_layer_last", out2, dx2, g2, want2, rerun2),
            ):
                check(fwd_same[name], f"{name} fwd {tag}: a rerun changed a bit")
                same = torch.equal(rerun[0], dx) and all(
                    torch.equal(rerun[1][k], v) for k, v in grads.items())
                check(same, f"{name} bwd {tag}: a rerun changed a bit")
                ok_out = (torch.allclose(out, wout, **FP32_TOL) if dt == torch.float32
                          else _bf16_ok(out, wout))
                check(bool(torch.isfinite(dx).all()), f"{name} bwd {tag}: non-finite dx")
                rows = {"dx": _grad_err_ok(dx, wdx, dt, True)}
                rows.update({k: _grad_err_ok(v, wgrads[k], dt, False)
                             for k, v in grads.items()})
                ok = ok_out and all(o for _, o in rows.values())
                phase("train-kernel-vs-plain", kernel=name + "_bwd", **tag,
                      shape=f"B{B}xT{T}xD{D}",
                      out_max_abs_err=f"{(out.float() - wout.float()).abs().max().item():.3e}",
                      rel_err=repr({k: float(f"{e:.3e}") for k, (e, _) in rows.items()}),
                      tol=f"max|err|/max|plain| <= {GRAD_RTOL}"
                          + (" (bf16 dx: + 2^-7*|plain|)" if dt == torch.bfloat16 else ""),
                      rerun_bits_equal=same, fwd_rerun_bits_equal=fwd_same[name], ok=ok)
                check(ok, f"{name} bwd {tag}: kernel disagrees with its plain version")
                if dt == torch.float32:
                    # max |kernel - plain|: the output, then dx and every grad
                    fwd = float((out - wout).abs().max())
                    bwd = max(float((v - w).abs().max()) for v, w in
                              [(dx, wdx)] + [(g, wgrads[k]) for k, g in grads.items()])
                    errs[name] = max(errs.get(name, 0.0), fwd)
                    errs[name + "_bwd"] = max(errs.get(name + "_bwd", 0.0), bwd)
    return errs


def mask_bits(dev):
    """The kernels' dropout masks against the plain Philox masks, bit for
    bit.  With W_in = 0 and the FFN off, K1's dx is LN_pl'(dv1) * m0, so
    it is 0 exactly where the prologue mask drops.  The masks m1-m3 of
    both layers enter every value the train-kernel-vs-plain phase
    compares at p = 0.2, where one flipped bit moves a value by far more
    than its tolerance."""
    gen = torch.Generator().manual_seed(SEED + 3)
    p1 = layer_params(gen, dev, prologue=True)
    p1 = {k: v for k, v in p1.items() if k not in ("w1", "b1", "w2", "b2", "ln2_s", "ln2_b")}
    p1["w_in"] = torch.zeros_like(p1["w_in"])
    x = torch.randn((B, T, D), generator=gen).to(dev)
    dout = torch.randn((B, T, D), generator=gen).to(dev)
    seed = 987654321
    _, saved = FL.fused_recurrent_layer_train(x, p1, True, False, True, DROPOUT, seed)
    dx, _ = FL.fused_recurrent_layer_bwd(x, dout, p1, True, False, True, DROPOUT, seed,
                                         saved=saved)
    want = philox.dropout_mask(seed, philox.M0, B, T, D, DROPOUT, dev) > 0
    got = dx != 0
    flips = int((got != want).sum())
    phase("mask-bits", mask="m0 (K1 prologue)", elements=want.numel(),
          keep_fraction=f"{float(want.float().mean()):.5f}", mismatches=flips)
    check(flips == 0, f"m0: {flips} mask bits differ from the plain Philox mask")
    return flips


def _attn_ok(got, want, dtype, floor=0.0):
    """(max |kernel - plain|, ok) of an attention kernel's output or
    gradient: fp32 within GRAD_RTOL (1e-4) of the largest plain value;
    bf16 within one bf16 ulp of the value plus ATTN_BF16_ABS of the
    largest (an operand rounded to the other bf16 neighbour).  The
    absolute tolerance is at least ``floor`` (b_k's gradient is zero up
    to rounding: the softmax ignores a shift that every key shares)."""
    g, w = got.float(), want.float()
    scale = float(w.abs().max())
    diff = (g - w).abs()
    err = float(diff.max())
    if dtype == torch.float32:
        return err, err <= max(GRAD_RTOL * scale, floor)
    return err, bool((diff <= BF16_RTOL * w.abs() + max(ATTN_BF16_ABS * scale, floor)).all())


def attn_kernels_vs_plain(dev):
    """The attention baselines' three kernels against their plain versions
    at B = 256, T = 200, fp32 and bf16, lengths with 0, 1 and T; the layer
    causal and bidirectional, two activations.  Returns the largest fp32
    |kernel - plain| of each."""
    gen = torch.Generator().manual_seed(SEED + 5)
    p = block_params(gen, dev)
    x = torch.randn((B, T, D), generator=gen).to(dev)
    pos = (0.5 * torch.randn((T, D), generator=gen)).to(dev)
    lens = serving_lens(gen, B).to(dev)
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        xd = x.to(dt)
        args = (xd, pos, p["ln1_s"], p["ln1_b"])
        cases = [("fused_ln_dropout", "", FL.fused_ln_dropout(*args),
                  FL.fused_ln_dropout_plain(*args))]
        for act in ("gelu", "relu"):
            for causal in (True, False):
                cases.append((
                    "fused_transformer_layer", f"causal={causal} act={act}",
                    FB.fused_transformer_layer(xd, lens, p, causal, HEADS, act),
                    FB.fused_transformer_layer_plain(xd, lens, p, causal, HEADS, act)))
            cases.append((
                "fused_transformer_layer_last", f"act={act}",
                FB.fused_transformer_layer_last(xd, lens, p, HEADS, act),
                FB.fused_transformer_layer_last_plain(xd, lens, p, HEADS, act)))
        torch.cuda.synchronize()
        for name, tag, got, want in cases:
            check(got.dtype == dt and got.shape == want.shape, f"{name} {dt}: shape/dtype")
            check(bool(torch.isfinite(got).all()), f"{name} {dt} {tag}: non-finite output")
            err, ok = _attn_ok(got, want, dt)
            if dt == torch.float32:
                errs[name] = max(errs.get(name, 0.0), err)
            tol = ("max|err| <= 1e-4*max|plain|" if dt == torch.float32 else
                   f"|err| <= 2^-7*|plain| + 2^-9*max|plain|")
            phase("attn-kernel-vs-plain", kernel=name, case=repr(tag),
                  dtype=str(dt).split(".")[-1], shape=f"B{B}xT{T}xD{D}", heads=HEADS,
                  max_abs_err=f"{err:.3e}", max_abs_plain=f"{float(want.float().abs().max()):.3f}",
                  tol=repr(tol), ok=ok)
            check(ok, f"{name} {dt} {tag}: kernel disagrees with its plain version")
    return errs


def attn_train_kernels_vs_plain(dev):
    """The attention kernels' training forwards and backwards against
    autograd of their plain versions at B = 256, T = 200, fp32 and bf16,
    p = 0 and 0.5, lengths with 0, 1 and T: the prologue (dx, dpos,
    dscale, dbias), the layer causal and bidirectional, the last-query
    layer.  Returns the largest fp32 |kernel - plain| of each forward
    (output) and backward (dx and every grad)."""
    gen = torch.Generator().manual_seed(SEED + 8)
    p = block_params(gen, dev)
    x = torch.randn((B, T, D), generator=gen).to(dev)
    pos = (0.5 * torch.randn((T, D), generator=gen)).to(dev)
    lens = serving_lens(gen, B).to(dev)
    d3 = torch.randn((B, T, D), generator=gen).to(dev)
    d2 = torch.randn((B, D), generator=gen).to(dev)
    lp = {"pos": pos, "scale": p["ln1_s"], "bias": p["ln1_b"]}
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        for pd in (0.0, SAS_DROPOUT):
            xd, dout3, dout2 = x.to(dt), d3.to(dt), d2.to(dt)
            seed = 7654321 + int(pd * 10)
            drop = (pd, pd, seed)
            cases = []
            xl = xd.clone().requires_grad_()
            ql = {k: v.clone().requires_grad_() for k, v in lp.items()}
            out = FL.fused_ln_dropout(xl, ql["pos"], ql["scale"], ql["bias"], pd, seed)
            out.backward(dout3)
            cases.append(("fused_ln_dropout", "", out.detach(), xl.grad,
                          {k: v.grad for k, v in ql.items()},
                          _plain_vjp(lambda a, q: FL.fused_ln_dropout_plain(
                              a, q["pos"], q["scale"], q["bias"], pd, seed), xd, lp, dout3)))
            for causal in (True, False):
                out, saved = FB.fused_transformer_layer_train(xd, lens, p, causal, HEADS,
                                                               "gelu", *drop)
                dx, g = FB.fused_transformer_layer_bwd(xd, lens, dout3, p, causal, HEADS,
                                                       "gelu", *drop, saved=saved)
                cases.append(("fused_transformer_layer", f"causal={causal}", out, dx, g,
                              _plain_vjp(lambda a, q: FB.fused_transformer_layer_plain(
                                  a, lens, q, causal, HEADS, "gelu", *drop), xd, p, dout3)))
            out, saved = FB.fused_transformer_layer_last_train(xd, lens, p, HEADS, "gelu", *drop)
            dx, g = FB.fused_transformer_layer_last_bwd(xd, lens, dout2, p, HEADS, "gelu", *drop,
                                                        saved=saved)
            cases.append(("fused_transformer_layer_last", "", out, dx, g,
                          _plain_vjp(lambda a, q: FB.fused_transformer_layer_last_plain(
                              a, lens, q, HEADS, "gelu", *drop), xd, p, dout2)))
            torch.cuda.synchronize()
            tag = dict(dtype=str(dt).split(".")[-1], p=pd)
            for name, case, out, dx, grads, (wout, wdx, wgrads) in cases:
                check(bool(torch.isfinite(dx).all()), f"{name} bwd {tag}: non-finite dx")
                pairs = {"out": (out, wout), "dx": (dx, wdx)}
                pairs.update({k: (v, wgrads[k]) for k, v in grads.items()})
                top = max(float(w.float().abs().max()) for _, w in pairs.values())
                rows = {}
                for k, (v, w) in pairs.items():
                    err, ok_k = _attn_ok(v, w, dt, 1e-6 * top)
                    rows[k] = (err / (float(w.float().abs().max()) or 1.0), ok_k)
                ok = all(o for _, o in rows.values())
                worst = max(rows, key=lambda k: rows[k][0] if k != "b_k" else 0.0)
                phase("attn-train-kernel-vs-plain", kernel=name + "_bwd", case=repr(case), **tag,
                      shape=f"B{B}xT{T}xD{D}", worst=worst, worst_rel_err=f"{rows[worst][0]:.3e}",
                      rel_err=repr({k: float(f"{e:.2e}") for k, (e, _) in rows.items()}),
                      tol=("max|err| <= 1e-4*max|plain|" if dt == torch.float32 else
                           "|err| <= 2^-7*|plain| + 2^-9*max|plain|")
                      + ", at least 1e-6*max over all grads", ok=ok)
                check(ok, f"{name} bwd {tag} {case}: kernel disagrees with its plain version")
                if dt == torch.float32:
                    fwd = float((out.float() - wout.float()).abs().max())
                    bwd = max(float((v.float() - w.float()).abs().max())
                              for k, (v, w) in pairs.items() if k != "out")
                    errs[name] = max(errs.get(name, 0.0), fwd)
                    errs[name + "_bwd"] = max(errs.get(name + "_bwd", 0.0), bwd)
    return errs


def attn_mask_bits(dev):
    """Each attention mask as a kernel draws it, bit for bit against the
    plain Philox mask (``philox.dropout_mask``): the prologue's M0 from
    its output with scale 0 and bias 1 (the output is the mask); M1
    (after W_o) and M3 (after the FFN) from the sign of a layer output
    whose only signal is that mask (x = 0, every weight 0, b_o or b2 one);
    each head's probability mask from the context a training forward
    keeps, with x[j] = e_j and v_h the identity on T = dh = 32 keys; the
    last-query layer's at each row's position lens - 1."""
    zeros = lambda *s: torch.zeros(s, device=dev)  # noqa: E731
    seed, pd = 135792468, SAS_DROPOUT
    gen = torch.Generator().manual_seed(SEED + 9)
    results = []
    out = FL.fused_ln_dropout(torch.randn((B, T, D), generator=gen).to(dev), zeros(T, D),
                              zeros(D), torch.ones(D, device=dev), pd, seed)
    results.append(("m0 (prologue)", out != 0,
                    philox.dropout_mask(seed, philox.M0, B, T, D, pd, dev) > 0))
    base = {n: zeros(D, D) for n in ("w_q", "w_k", "w_v", "w_o")}
    base.update({n: zeros(D) for n in ("b_q", "b_k", "b_v", "b_o", "ln1_b", "b2", "ln2_b")},
                ln1_s=torch.ones(D, device=dev), ln2_s=torch.ones(D, device=dev),
                w1=zeros(D, INNER), b1=zeros(INNER), w2=zeros(INNER, D))
    lens = torch.full((B,), T, device=dev)
    lens_last = serving_lens(gen, B).to(dev)
    qpos = FB.last_positions(lens_last, T)
    for mask_id, label, name in ((philox.M1, "m1 (after W_o)", "b_o"),
                                 (philox.M3, "m3 (after the FFN)", "b2")):
        pm = dict(base, **{name: torch.ones(D, device=dev)})
        out = FB.fused_transformer_layer(zeros(B, T, D), lens, pm, True, HEADS, "gelu", pd, 0.0,
                                         seed)
        results.append((label, out > 0,
                        philox.dropout_mask(seed, mask_id, B, T, D, pd, dev) > 0))
        out = FB.fused_transformer_layer_last(zeros(B, T, D), lens_last, pm, HEADS, "gelu", pd,
                                              0.0, seed)
        results.append((label + " last", out > 0,
                        philox.dropout_mask_at(seed, mask_id, qpos, D, pd) > 0))
    dh = D // HEADS
    tp = dh  # keys = the head width, so v_h can be the identity
    x = torch.eye(tp, D, device=dev).expand(B, tp, D).contiguous()
    w_v = zeros(D, D)
    for h in range(HEADS):
        w_v[:dh, h * dh:(h + 1) * dh] = torch.eye(dh, device=dev)
    pm = dict(base, w_v=w_v, w_q=(0.3 * torch.randn((D, D), generator=gen)).to(dev),
              w_k=(0.3 * torch.randn((D, D), generator=gen)).to(dev))
    lens_p = torch.full((B,), tp, device=dev)
    lens_pl = torch.randint(1, tp + 1, (B,), generator=gen).to(dev)
    _, (_, ctx) = FB.fused_transformer_layer_train(x, lens_p, pm, False, HEADS, "gelu", 0.0, pd,
                                                   seed)
    _, (_, ctx_last) = FB.fused_transformer_layer_last_train(x, lens_pl, pm, HEADS, "gelu", 0.0,
                                                             pd, seed)
    valid = torch.arange(tp, device=dev)[None, :] < lens_pl[:, None]
    qpos_p = FB.last_positions(lens_pl, tp)
    for h in range(HEADS):
        mid = philox.prob_mask_id(h)
        results.append((f"probabilities head {h}", ctx[..., h * dh:(h + 1) * dh] != 0,
                        philox.dropout_mask(seed, mid, B, tp, tp, pd, dev) > 0))
        results.append((f"probabilities head {h} last", ctx_last[:, h * dh:(h + 1) * dh] != 0,
                        (philox.dropout_mask_at(seed, mid, qpos_p, tp, pd) > 0) & valid))
    torch.cuda.synchronize()
    for label, got, want in results:
        flips = int((got != want).sum())
        phase("attn-mask-bits", mask=repr(label), elements=want.numel(),
              keep_fraction=f"{float(want.float().mean()):.5f}", mismatches=flips)
        check(flips == 0, f"{label}: {flips} mask bits differ from the plain Philox mask")


def b4r_sel_idx(gen, b, t, s):
    """[B, S] cloze-like positions: ascending in a row, the last slots at
    position 0 (BERT4Rec's padded cloze slots), one repeat."""
    idx = torch.sort(torch.randint(0, t, (b, s), generator=gen), dim=1).values
    idx[:, -8:] = 0
    idx[:, 1] = idx[:, 2]
    return idx


def b4r_kernels_vs_plain(dev):
    """Rows 12 and 13 against autograd of their plain versions, fp32 and
    bf16: the selected-positions layer at B 256, T 200, S 40 (lengths 0, 1
    and T, repeated positions), p = 0 and 0.2 (output, dx, every weight
    grad); the CE at BERT4Rec's shape (N 81,920, V 3,417, D 64, with a
    bias; bf16 x with bf16 products): nll, dx, dtable and dbias, and so at
    the d256 path's D 256 and, on the backward's FMA kernels, at D 300
    (N 4,096, fp32).  Returns the largest fp32 |kernel - plain| of each
    forward and backward at the bench shape."""
    gen = torch.Generator().manual_seed(SEED + 10)
    p = block_params(gen, dev)
    x = torch.randn((B, T, D), generator=gen).to(dev)
    lens = serving_lens(gen, B).to(dev)
    sel = b4r_sel_idx(gen, B, T, MASK_LEN).to(dev)
    d3 = torch.randn((B, MASK_LEN, D), generator=gen).to(dev)
    n = TRAIN_B * MASK_LEN
    xc, table, bias, tgt, dnll = ce_inputs(gen, dev, n, D)
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[-1]
        for pd in (0.0, B4R_DROPOUT):
            drop = (pd, pd, 2468 + int(pd * 10))
            xd, dd = x.to(dt), d3.to(dt)
            out, saved = FB.fused_transformer_layer_sel_train(xd, lens, sel, p, HEADS, "gelu",
                                                              *drop)
            dx, g = FB.fused_transformer_layer_sel_bwd(xd, lens, sel, dd, p, HEADS, "gelu",
                                                       *drop, saved=saved)
            wout, wdx, wg = _plain_vjp(lambda a, q: FB.fused_transformer_layer_sel_plain(
                a, lens, sel, q, HEADS, "gelu", *drop), xd, p, dd)
            torch.cuda.synchronize()
            pairs = {"out": (out, wout), "dx": (dx, wdx)}
            pairs.update({k: (v, wg[k]) for k, v in g.items()})
            top = max(float(w.float().abs().max()) for _, w in pairs.values())
            rows = {}
            for k, (v, w) in pairs.items():
                err, ok_k = _attn_ok(v, w, dt, 1e-6 * top)
                rows[k] = (err / (float(w.float().abs().max()) or 1.0), ok_k)
            ok = all(o for _, o in rows.values())
            worst = max(rows, key=lambda k: rows[k][0] if k != "b_k" else 0.0)
            phase("b4r-kernel-vs-plain", kernel="fused_transformer_layer_sel_bwd", dtype=dname,
                  p=pd, shape=f"B{B}xT{T}xS{MASK_LEN}xD{D}", worst=worst,
                  worst_rel_err=f"{rows[worst][0]:.3e}",
                  rel_err=repr({k: float(f"{e:.2e}") for k, (e, _) in rows.items()}),
                  tol=("max|err| <= 1e-4*max|plain|" if dt == torch.float32 else
                       "|err| <= 2^-7*|plain| + 2^-9*max|plain|")
                  + ", at least 1e-6*max over all grads", ok=ok)
            check(ok, f"fused_transformer_layer_sel {dname} p={pd}: kernel disagrees with its "
                      "plain version")
            if dt == torch.float32:
                bwd = max(float((v.float() - w.float()).abs().max())
                          for k, (v, w) in pairs.items() if k != "out")
                errs["fused_transformer_layer_sel"] = max(
                    errs.get("fused_transformer_layer_sel", 0.0),
                    float((out - wout).abs().max()))
                errs["fused_transformer_layer_sel_bwd"] = max(
                    errs.get("fused_transformer_layer_sel_bwd", 0.0), bwd)
        nll_err, bwd_err = ce_kernel_vs_plain(xc.to(dt), table, bias, tgt, dnll)
        if dt == torch.float32:
            errs["fused_softmax_ce"] = nll_err
            errs["fused_softmax_ce_bwd"] = bwd_err
    # row 13 at the d256 path's width (tensor cores) and at D 300 (FMA)
    for d, nd in ((256, n), (300, 4096)):
        gen = torch.Generator().manual_seed(SEED + 13)
        xc, table, bias, tgt, dnll = ce_inputs(gen, dev, nd, d)
        for dt in ((torch.float32, torch.bfloat16) if d == 256 else (torch.float32,)):
            ce_kernel_vs_plain(xc.to(dt), table, bias, tgt, dnll, ties=d > 128)
        del xc, table, bias, tgt, dnll
    return errs


def ce_inputs(gen, dev, n, d):
    """Row 13's inputs at a loss of n rows over BERT4Rec's V 3,417 items:
    x [n, d], table [V, d], bias [V], targets and a cotangent."""
    x = torch.randn((n, d), generator=gen).to(dev)
    table = (0.3 * torch.randn((N_ITEMS, d), generator=gen)).to(dev)
    bias = (0.1 * torch.randn((N_ITEMS,), generator=gen)).to(dev)
    tgt = torch.randint(1, N_ITEMS, (n,), generator=gen).to(dev)
    dnll = torch.rand((n,), generator=gen).to(dev)
    return x, table, bias, tgt, dnll


# round(g) of a bf16 dx may go either way where g lies within this much
# of p dnll (per 64 columns) of a bf16 rounding boundary: the window in
# which row 13's kernel itself recomputes a logit as an fp32 FMA sum
# (csrc/fused_ce.cu near_bf16_tie).  cuBLAS's fp32 sum of D products and an
# FMA sum in order differ enough at D 256 that the FMA kernel row 13 had
# before the tensor cores put the same 120 values of the cloze loss's dx
# out of the plain bound there as the tensor-core kernel; none stays out
# with this allowance, nor with a quarter of the window (NVIDIA H100 80GB
# HBM3, 700 W).
TIE_WINDOW = 2.0 ** -17


def bf16_tie_allowance(x, table, bias, tgt, dnll):
    """[N, D]: what the rounding of g to bf16 may move a bf16-product dx by
    between two fp32 sums of the logits: over the vocab entries whose g lies
    within TIE_WINDOW * D / 64 p dnll of a bf16 rounding boundary, one bf16
    ulp of g (at most 2^-7 |g|) times |round(table)|."""
    v, d = table.shape
    logits = FCE._logits(x, table, bias, v, True)
    e = FCE.fastmath.exp(logits - logits.amax(-1, keepdim=True))
    pd = e / e.sum(-1, keepdim=True) * dnll[:, None]
    del e, logits
    g = pd - FCE._onehot(tgt, v).float() * dnll[:, None]
    dist = ((g.view(torch.int32) & 0xFFFF) - 0x8000).abs().float() * g.abs() * 2.0 ** -24
    amb = dist < pd * TIE_WINDOW * d / 64
    del dist, pd
    return (torch.where(amb, g.abs() * 2.0 ** -7, 0.0)
            @ FCE._round(table.float(), True).abs()), int(amb.sum())


def ce_kernel_vs_plain(x, table, bias, tgt, dnll, ties=False):
    """Row 13 forward and backward on x (bf16 x with bf16 products)
    against autograd of the plain version: nll within 1e-4 + 1e-5 |plain|,
    dx, dtable and dbias within GRAD_RTOL of the largest value (a bf16 dx
    one bf16 ulp on top, and with ``ties`` the rounding ties of g on top of
    that: ``bf16_tie_allowance``, its count of values beyond the plain
    bound printed); the forward and the backward take the tensor cores
    exactly where ``fwd_uses_mma`` and ``bwd_uses_mma`` say and give the
    same bits (nll and lse; dx, dtable and dbias) on a rerun.  Returns the largest |kernel -
    plain| of nll and of the gradients."""
    dt = x.dtype
    mm = dt == torch.bfloat16
    n, d = x.shape
    fwd, bwd = FCE.fused_softmax_ce_train, FCE.fused_softmax_ce_bwd
    before = (fwd.mma_launches, bwd.mma_launches)
    nll, lse = fwd(x, table, tgt, bias, None, mm)
    fwd_mma = fwd.mma_launches - before[0]
    dx, dtab, dbias = bwd(x, table, tgt, dnll, bias, None, mm, lse=lse)
    mma = bwd.mma_launches - before[1]
    fwd_same = all(torch.equal(a, b) for a, b in zip(fwd(x, table, tgt, bias, None, mm),
                                                    (nll, lse)))
    again = bwd(x, table, tgt, dnll, bias, None, mm, lse=lse)
    same = fwd_same and all(torch.equal(a, b) for a, b in zip(again, (dx, dtab, dbias)))
    del again
    xl, tl, bl = (a.detach().clone().requires_grad_() for a in (x, table, bias))
    want = FCE.fused_softmax_ce_plain(xl, tl, tgt, bl, None, mm)
    gx, gt, gb = torch.autograd.grad(want, [xl, tl, bl], dnll)
    torch.cuda.synchronize()
    nll_err = float((nll - want.detach()).abs().max())
    ok_nll = bool(((nll - want.detach()).abs() <= 1e-4 + 1e-5 * want.detach().abs()).all())
    rows = {"dx": _grad_err_ok(dx, gx, dt, True), "dtable": _grad_err_ok(dtab, gt, dt, False),
            "dbias": _grad_err_ok(dbias, gb, dt, False)}
    ties_out = {}
    if ties and mm:
        err = (dx.float() - gx.float()).abs()
        bound = BF16_RTOL * gx.float().abs() + GRAD_RTOL * float(gx.float().abs().max())
        allow, n_amb = bf16_tie_allowance(x, table, bias, tgt, dnll)
        rows["dx"] = (rows["dx"][0], bool((err <= bound + allow).all()))
        ties_out = dict(beyond_plain_bound=int((err > bound).sum()), tie_entries=n_amb,
                        tie_window="2^-17*D/64*p*dnll")
        del err, bound, allow
    ok = ok_nll and same and all(o for _, o in rows.values())
    ok = (ok and mma == int(FCE.bwd_uses_mma(d, mm))
          and fwd_mma == int(FCE.fwd_uses_mma(d, mm)))
    dname = str(dt).split(".")[-1]
    phase("b4r-kernel-vs-plain", kernel="fused_softmax_ce_bwd", dtype=dname, mm_bf16=mm,
          shape=f"N{n}xV{table.shape[0]}xD{d}", fwd_mma_launches=fwd_mma, mma_launches=mma,
          rerun_bit_equal=same,
          nll_max_abs_err=f"{nll_err:.3e}", nll_tol="1e-4 + 1e-5*|plain|",
          rel_err=repr({k: float(f"{e:.3e}") for k, (e, _) in rows.items()}),
          tol=f"max|err|/max|plain| <= {GRAD_RTOL}"
              + (" (bf16 dx: + 2^-7*|plain|" + (" + rounding ties of g)" if ties_out else ")")
                 if mm else ""), **ties_out, ok=ok)
    check(ok, f"fused_softmax_ce {dname} D {d}: kernel disagrees with its plain version, "
              "takes another path than its gate or changes on a rerun")
    bwd_err = max(float((a.float() - w.float()).abs().max())
                  for a, w in ((dx, gx), (dtab, gt), (dbias, gb)))
    return nll_err, bwd_err


def b4r_mask_bits(dev):
    """The selected-positions layer's masks as its kernel draws them, bit
    for bit against ``philox.dropout_mask_at`` at the [B, S] positions:
    M1 and M3 from the sign of an output whose only signal is that mask
    (x = 0, every weight 0, b_o or b2 one), each head's probability mask
    from the context a training forward keeps (x[j] = e_j, v_h the
    identity on T = dh = 32 keys)."""
    zeros = lambda *s: torch.zeros(s, device=dev)  # noqa: E731
    seed, pd = 97531, B4R_DROPOUT
    gen = torch.Generator().manual_seed(SEED + 11)
    base = {n: zeros(D, D) for n in ("w_q", "w_k", "w_v", "w_o")}
    base.update({n: zeros(D) for n in ("b_q", "b_k", "b_v", "b_o", "ln1_b", "b2", "ln2_b")},
                ln1_s=torch.ones(D, device=dev), ln2_s=torch.ones(D, device=dev),
                w1=zeros(D, INNER), b1=zeros(INNER), w2=zeros(INNER, D))
    lens = serving_lens(gen, B).to(dev)
    sel = b4r_sel_idx(gen, B, T, MASK_LEN).to(dev)
    results = []
    for mask_id, label, name in ((philox.M1, "m1 (after W_o) sel", "b_o"),
                                 (philox.M3, "m3 (after the FFN) sel", "b2")):
        pm = dict(base, **{name: torch.ones(D, device=dev)})
        out = FB.fused_transformer_layer_sel(zeros(B, T, D), lens, sel, pm, HEADS, "gelu", pd,
                                             0.0, seed)
        results.append((label, out > 0, philox.dropout_mask_at(seed, mask_id, sel, D, pd) > 0))
    dh = D // HEADS
    tp = dh
    x = torch.eye(tp, D, device=dev).expand(B, tp, D).contiguous()
    w_v = zeros(D, D)
    for h in range(HEADS):
        w_v[:dh, h * dh:(h + 1) * dh] = torch.eye(dh, device=dev)
    pm = dict(base, w_v=w_v, w_q=(0.3 * torch.randn((D, D), generator=gen)).to(dev),
              w_k=(0.3 * torch.randn((D, D), generator=gen)).to(dev))
    sel_p = b4r_sel_idx(gen, B, tp, MASK_LEN).to(dev)
    _, (_, _, ctx) = FB.fused_transformer_layer_sel_train(
        x, torch.full((B,), tp, device=dev), sel_p, pm, HEADS, "gelu", 0.0, pd, seed)
    for h in range(HEADS):
        results.append((f"probabilities head {h} sel", ctx[..., h * dh:(h + 1) * dh] != 0,
                        philox.dropout_mask_at(seed, philox.prob_mask_id(h), sel_p, tp, pd) > 0))
    torch.cuda.synchronize()
    for label, got, want in results:
        flips = int((got != want).sum())
        phase("b4r-mask-bits", mask=repr(label), elements=want.numel(),
              keep_fraction=f"{float(want.float().mean()):.5f}", mismatches=flips)
        check(flips == 0, f"{label}: {flips} mask bits differ from the plain Philox mask")


def plain_embed(model, seq):
    """The item embedding as a plain gather, cast to the compute dtype
    after it (the same values as ``embed``; its table gradient is autograd's
    fp32 sum, where ``embed``'s bf16 one is the ``embedding_grad`` kernel)."""
    return F.embedding(seq, model.item_embedding).to(model.compute_dtype)


def plain_seq_output(model, seq, lens, step=None):
    """RecBLR's fused composition (the chunked one beyond T = 512) through
    the plain layer versions, with the dropout rate and seeds the model
    draws for ``step``."""
    p_drop, seeds = model.dropout_seeds(step)
    x = plain_embed(model, seq)
    n = len(model.layers)
    for li, layer in enumerate(model.layers):
        flat = model.flat_layer_params(layer, True)
        if li == n - 1:
            return FL.fused_recurrent_layer_last_plain(x, lens, flat, True, True, p_drop,
                                                       seeds[li])
        if li == 0:
            flat.update(model.prologue_params())
        if model.use_chunked_layer():
            x = FLC.fused_recurrent_layer_chunked_plain(x, flat, True, True, li == 0, p_drop,
                                                        seeds[li])[0]
        else:
            x = FL.fused_recurrent_layer_plain(x, flat, True, True, li == 0, p_drop, seeds[li])


def plain_baseline_output(model, seq, seq_len, step=None):
    """SASRec's or BERT4Rec's fused composition through the plain versions
    of its three kernels (BERT4Rec: mask token appended, output head),
    with the dropout rates and seeds the model draws for ``step``."""
    bert = hasattr(model, "output_head")
    if bert:
        seq = model.reconstruct_test_seq(seq, seq_len)
    t = seq.shape[1]
    p_hidden, p_attn, seeds = model.dropout_seeds(step)
    x = FL.fused_ln_dropout_plain(plain_embed(model, seq),
                                  model.position_embedding[:t].float(),
                                  model.input_ln["scale"].float(),
                                  model.input_ln["bias"].float(), p_hidden, seeds[-1])
    lens = (seq != 0).sum(1, dtype=torch.int32)
    n = len(model.encoder)
    for li, layer in enumerate(model.encoder):
        flat = L.flat_block_params(layer)
        drop = (p_hidden, p_attn, seeds[li])
        if li == n - 1:
            x = FB.fused_transformer_layer_last_plain(x, lens, flat, model.n_heads,
                                                      model.hidden_act, *drop)
        else:
            x = FB.fused_transformer_layer_plain(x, lens, flat, model.causal, model.n_heads,
                                                 model.hidden_act, *drop)
    return model.output_head(x) if bert else x


def plain_ce_loss(plain_output):
    """The CE loss of a model whose output comes from ``plain_output``."""
    from datamining_recblr_torch.models.base import ce_loss

    def loss(model, batch, step):
        out = plain_output(model, batch["item_seq"], batch["item_seq_len"], step=step)
        return ce_loss(model._mask_padded_vocab(model._logits(out), value=-1e30),
                       batch["pos_item"], batch["weight"])
    return loss


def plain_cloze_loss(model, batch, step):
    """BERT4Rec's cloze loss of ``step``'s draw through the plain versions
    of its kernels (the prologue, the layer, the selected-positions top
    layer, the whole-table CE), with the seeds the model draws."""
    seq, order, tgt, valid = model.cloze_draw(batch["item_seq"], batch["item_seq_len"], step)
    t = seq.shape[1]
    p_hidden, p_attn, seeds = model.dropout_seeds(step)
    x = FL.fused_ln_dropout_plain(plain_embed(model, seq),
                                  model.position_embedding[:t].float(),
                                  model.input_ln["scale"].float(),
                                  model.input_ln["bias"].float(), p_hidden, seeds[-1])
    lens = (seq != 0).sum(1, dtype=torch.int32)
    n = len(model.encoder)
    for li, layer in enumerate(model.encoder):
        flat = L.flat_block_params(layer)
        drop = (model.hidden_act, p_hidden, p_attn, seeds[li])
        if li == n - 1:
            x = FB.fused_transformer_layer_sel_plain(x, lens, order, flat, model.n_heads, *drop)
        else:
            x = FB.fused_transformer_layer_plain(x, lens, flat, False, model.n_heads, *drop)
    out = model.output_head(x)
    nll = FCE.fused_softmax_ce_plain(out.reshape(-1, out.shape[-1]),
                                     model.item_embedding[: model.n_items], tgt.reshape(-1),
                                     model.output_bias[: model.n_items],
                                     mm_bf16=model.compute_dtype == torch.bfloat16)
    w = valid.float() * batch["weight"].float()[:, None]
    return (nll.reshape(valid.shape) * w).sum() / w.sum().clamp_min(1.0)


# ---------------------------------------------------------------------------
# training: the bench.py shape (batch 2,048, CE, Adam)
# ---------------------------------------------------------------------------

# per trained model: its phases' prefix, the kernels one step launches,
# its dropout, the step's loss through the plain versions, and the floor
# of each gradient's tolerance as a share of the largest gradient (the
# attention baselines' b_k gradient is zero up to rounding)
TRAINED = {
    "RecBLR": ("train", LAUNCH_COUNTED, {"dropout_prob": DROPOUT},
               plain_ce_loss(plain_seq_output), 0.0),
    "SASRec": ("sasrec-train", SAS_COUNTED,
               {"hidden_dropout_prob": SAS_DROPOUT, "attn_dropout_prob": SAS_DROPOUT},
               plain_ce_loss(plain_baseline_output), 1e-6),
    "BERT4Rec": ("bert4rec-train", B4R_COUNTED,
                 {"hidden_dropout_prob": B4R_DROPOUT, "attn_dropout_prob": B4R_DROPOUT},
                 plain_cloze_loss, 1e-6),
}


def _train_config(name, dtype_name, **extra):
    return Config(model=name, config_dict={
        "MAX_ITEM_LIST_LENGTH": T, "compute_dtype": dtype_name, "train_batch_size": TRAIN_B,
        "seed": SEED, **TRAINED[name][2], **extra})


def step_vs_plain(model, batch, counted, plain_loss, floor, tol, step=7):
    """One step through the kernels and the same step through the plain
    versions (same seeds, so the same masks), gradients before Adam:
    (launches, loss, plain loss, loss rel err, {param: rel err})."""
    model.train()
    model.zero_grad(set_to_none=True)
    for fn in counted:
        fn.launches = 0
    loss = model.calculate_loss(batch, step=step)
    loss.backward()
    torch.cuda.synchronize()
    launches = tuple(fn.launches for fn in counted)
    got = {k: v.grad.detach().clone() for k, v in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    want_loss = plain_loss(model, batch, step)
    want_loss.backward()
    want = {k: v.grad.detach() for k, v in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    # max |kernel - plain| over the larger of max |plain| and floor * (the
    # largest gradient) / tol, so that ok <=> within tol of max |plain| or
    # within floor of the largest gradient
    top = max(float(w.abs().max()) for w in want.values())
    errs = {k: float((got[k] - want[k]).abs().max()
                     / max(float(want[k].abs().max()), floor * top / tol, 1e-30))
            for k in got}
    loss, want_loss = float(loss.detach()), float(want_loss.detach())
    return launches, loss, want_loss, abs(loss - want_loss) / abs(want_loss), errs


def time_steps(trainer, batch_of, steps, warmup=3):
    """CUDA events around trainer.train_step (batch gather, forward,
    backward, Adam) after a warm-up: (median ms, min, max, peak GB)."""
    dev = trainer.model.device
    for s in range(warmup):
        trainer.train_step(batch_of(s), s)
    torch.cuda.reset_peak_memory_stats(dev)
    times, losses = [], []
    for s in range(steps):
        b = batch_of(s + warmup)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(trainer.train_step(b, s + warmup))
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    check(bool(torch.isfinite(torch.stack(losses)).all()), "non-finite loss in the timed steps")
    return (float(np.median(times)), min(times), max(times),
            torch.cuda.max_memory_allocated(dev) / 1e9)


def train_step_phase(dev, dtype_name, name="RecBLR", steps=TRAIN_STEPS):
    """A model at full width on the bench data: launches per step, one
    step against the same step through the plain versions, and the step
    time."""
    from datamining_recblr_torch.data.synthetic import synthetic_splits
    from datamining_recblr_torch.train.trainer import Trainer

    prefix, counted, _, plain_loss, floor = TRAINED[name]
    cfg = _train_config(name, dtype_name)
    model = get_model(name)(cfg, N_ITEMS, T, generator=torch.Generator().manual_seed(SEED))
    check(_at_full_width(model), f"{name}: not the fused path at full width")
    rates = ((model.dropout_prob,) if name == "RecBLR"
             else (model.hidden_dropout_prob, model.attn_dropout_prob))
    check(rates == tuple(TRAINED[name][2].values()), f"{name}: dropout {rates}")
    if dtype_name == "bfloat16":
        counted = counted + (E.embedding_grad,)
    trainer = Trainer(cfg, model)
    train, _ = synthetic_splits(6040, N_ITEMS, T, 8192, seed=SEED)
    data = trainer.device_split(train)
    perm = np.random.default_rng((SEED, 0)).permutation(len(train))
    weight = torch.ones(TRAIN_B, device=dev)

    def batch_of(s):
        idx = perm[(s * TRAIN_B) % len(train):][:TRAIN_B]
        return trainer.gather_batch(data, torch.from_numpy(idx).to(dev), weight)

    tol = GRAD_RTOL if dtype_name == "float32" else BF16_RTOL
    launches, loss, want_loss, loss_err, errs = step_vs_plain(model, batch_of(0), counted,
                                                              plain_loss, floor, tol)
    worst = max(errs, key=errs.get)
    phase(f"{prefix}-step-vs-plain", dtype=dtype_name, batch=TRAIN_B, T=T,
          p=repr(rates),
          loss=f"{loss:.6f}", plain_loss=f"{want_loss:.6f}",
          loss_rel_err=f"{loss_err:.3e}", loss_tol="1e-4",
          grad_rel_err_max=f"{errs[worst]:.3e}", worst_param=worst,
          grad_tol=f"max|err|/max|plain| <= {tol}"
          + (f" (at least {floor}*max over all grads)" if floor else ""), params=len(errs))
    check(np.isfinite(loss), f"{name}: train loss is not finite")
    check(loss_err <= 1e-4, f"{name}: train loss disagrees with the plain step")
    check(all(e <= tol for e in errs.values()), f"{name}: gradients disagree with the plain step")
    phase(f"{prefix}-launches", dtype=dtype_name, steps=1,
          **{fn.__name__: n for fn, n in zip(counted, launches)})
    check(launches == (1,) * len(counted),
          f"{name}: expected one launch of each kernel, got {launches}")

    med, lo, hi, peak = time_steps(trainer, batch_of, steps)
    phase(f"{prefix}-time", dtype=dtype_name, batch=TRAIN_B, T=T, steps=steps,
          median_ms_per_step=f"{med:.3f}", examples_per_s=f"{TRAIN_B / med * 1e3:.1f}",
          min_ms=f"{lo:.3f}", max_ms=f"{hi:.3f}", peak_device_gb=f"{peak:.3f}")
    train_profile(trainer, batch_of, dtype_name, prefix)
    return {"launches": launches[:len(TRAINED[name][1])], "ms": med, "loss_err": loss_err,
            "grad_err": errs[worst]}


def profiled(run, need=()):
    """(the device events of ``run()`` from torch.profiler, ``run()``'s
    value; ``run`` ends in a synchronize).  A capture on the card has come
    back without some or all of its device events, so one that holds none,
    or no kernel whose name holds each of ``need``, is taken again, up to
    three captures; the last is returned either way and the caller's check
    of ``need`` stands."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            value = run()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events and all(any(n in e.key for e in events) for n in need):
            break
    return events, value


def _timed_loop(step, count):
    """A ``run`` for ``profiled``: ``count`` calls of ``step(i)``, then the
    wall microseconds they took to finish on the card."""
    def run():
        t0 = time.perf_counter()
        for i in range(count):
            step(i)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e6
    return run


def train_profile(trainer, batch_of, dtype_name, prefix, steps=5):
    """Device time by kernel over a few train steps (torch.profiler)."""
    batches = [batch_of(100 + s) for s in range(steps)]
    kernels, wall_us = profiled(
        _timed_loop(lambda s: trainer.train_step(batches[s], 100 + s), steps),
        fwd_mma_required(prefix, dtype_name))
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    phase(f"{prefix}-profile", dtype=dtype_name, steps=steps,
          wall_ms_per_step=f"{wall_us / steps / 1e3:.3f}",
          device_ms_per_step=f"{busy_us / steps / 1e3:.3f}" if kernels else "not measured",
          device_busy_share=f"{busy_us / wall_us:.3f}" if kernels else "not measured",
          top=repr([(e.key[:48], round(e.self_device_time_total / steps, 1)) for e in top]))
    for name in fwd_mma_required(prefix, dtype_name):
        check(any(name in e.key for e in kernels), f"{prefix}: no {name} in the profile")


def fit_phase(dev, name="RecBLR"):
    """Trainer.fit and evaluate(load_best=True) at full model width on a
    small Markov dataset: the loss falls and valid NDCG@10 is above 0."""
    import tempfile

    from datamining_recblr_torch.data.dataset import build_from_dataframe
    from datamining_recblr_torch.data.synthetic import generate_synthetic_interactions
    from datamining_recblr_torch.train.trainer import Trainer

    prefix = "fit" if name == "RecBLR" else f"{name.lower()}-fit"
    t0 = time.perf_counter()
    frame = generate_synthetic_interactions(n_users=1500, n_items=400, min_len=10,
                                            max_len=60, markov_weight=0.9, n_clusters=20,
                                            seed=SEED)
    data = build_from_dataframe(frame, max_seq_len=T)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = _train_config(name, "float32", epochs=FIT_EPOCHS, train_batch_size=512,
                            checkpoint_dir=tmp, dataset="markov", stopping_step=10)
        model = get_model(name)(cfg, data.n_items, T,
                                generator=torch.Generator().manual_seed(SEED))
        trainer = Trainer(cfg, model)
        best, _ = trainer.fit(data)
        test = trainer.evaluate(data.test, load_best=True)
        reloaded = trainer.ckpt_path is not None and trainer.ckpt_path.startswith(tmp)
    epochs = trainer.metrics.epoch_records()
    losses = [r["train_loss"] for r in epochs]
    ndcg = [r.get("valid_ndcg@10") for r in epochs]
    phase(prefix, data=repr(data.summary()), epochs=len(epochs), batch=512,
          train_loss=repr([round(v, 4) for v in losses]), valid_ndcg10=repr(ndcg),
          best_epoch=trainer.best_epoch, test_ndcg10=f"{test['ndcg@10']:.4f}",
          checkpoint_reloaded=reloaded, seconds=f"{time.perf_counter() - t0:.1f}")
    check(len(epochs) == FIT_EPOCHS and all(v is not None for v in ndcg), f"{prefix}: epochs")
    check(losses[-1] < losses[0], f"{prefix}: the epoch loss did not fall")
    check(best > 0 and test["ndcg@10"] > 0, f"{prefix}: NDCG@10 is not above 0")
    check(reloaded, f"{prefix}: no best checkpoint was written")


# the experiment path (``python -m datamining_recblr_torch.run`` /
# ``.parity``) at ml1m-synth's full size: the stat-matched log of
# generator seed 2020 written as an .inter file, ``build_dataset`` from the
# reference config (the root config.yaml's keys), then ``run_experiment``
# for one epoch.  Each run names its model, its overrides, the metric and
# floor its first valid evaluation must pass (">=" or ">"), and the
# kernels it counts with their launches per train step and per eval batch
# (under BPR ``embedding_grad`` also sums the scores' gathers: the table's,
# and BERT4Rec's output bias's)
EXP_PRESET, EXP_GEN_SEED = "ml1m-synth", 2020
EXP_SUMMARY = {"users": 6040, "items": 3416, "inters": 999_611, "train": 981_491}
EXPERIMENTS = {
    "experiment-ml1m-R": dict(
        model="RecBLR", cfg={"compute_dtype": "float32"}, metric="ndcg@10", floor=0.15,
        strict=False, counted=LAUNCH_COUNTED, per_step=(1, 1, 1, 1), per_eval=(1, 1, 0, 0)),
    # twice the chance of hit@10 among 101 candidates (10/101)
    "experiment-ml1m-R-bpr-uni100": dict(
        model="RecBLR", cfg={"compute_dtype": "bfloat16", "loss_type": "BPR",
                             "eval_args": {"mode": "uni100"}},
        metric="hit@10", floor=0.198, strict=True, counted=LAUNCH_COUNTED + (E.embedding_grad,),
        per_step=(1, 1, 1, 1, 2), per_eval=(1, 1, 0, 0, 0)),
    # one epoch of BERT4Rec (BPR or CE alike) ranks the target among
    # popularity-drawn negatives at chance (PERF.md, PR 19): its floor is
    # held on uni100 ("learned"), and the run's own pop100 metrics against
    # a plain recomputation from the full-sort scores
    "experiment-ml1m-B-bpr-pop100": dict(
        model="BERT4Rec", cfg={"compute_dtype": "float32", "loss_type": "BPR",
                               "eval_args": {"mode": "pop100"}},
        metric="hit@10", floor=0.198, strict=True, floor_mode="uni100",
        counted=(FL.fused_ln_dropout, FB.fused_transformer_layer, FB.fused_transformer_layer_sel,
                 FL.fused_ln_dropout_bwd, FB.fused_transformer_layer_bwd,
                 FB.fused_transformer_layer_sel_bwd, FB.fused_transformer_layer_last,
                 E.embedding_grad),
        per_step=(1, 1, 1, 1, 1, 1, 0, 2), per_eval=(1, 1, 0, 0, 0, 0, 1, 0)),
}


def plain_sampled_metrics(evaluator, split):
    """hit@10 and ndcg@10 of ``evaluator``'s sampled mode, recomputed
    plainly: the same candidates (its generator, batch by batch), their
    scores read from the model's full-sort scores, the target's rank one
    plus the negatives scoring strictly above it."""
    from datamining_recblr_torch.data.batching import iter_batches

    model, dev = evaluator.model, evaluator.model.device
    rng = np.random.default_rng(evaluator.seed)
    hits = ndcg = weight = 0.0
    model.eval()
    with torch.no_grad():
        for batch in iter_batches(split, evaluator.batch_size):
            cands = torch.from_numpy(evaluator.candidates(rng, batch["pos_item"])).to(dev)
            scores = model.full_sort_scores(torch.from_numpy(batch["item_seq"]).to(dev),
                                            torch.from_numpy(batch["item_seq_len"]).to(dev))
            s = scores.gather(1, cands.long())
            rank = 1 + (s[:, 1:] > s[:, :1]).sum(1).double().cpu().numpy()
            w = batch["weight"]
            hits += float((w * (rank <= 10)).sum())
            ndcg += float((w * np.where(rank <= 10, 1.0 / np.log2(rank + 1.0), 0.0)).sum())
            weight += float(w.sum())
    return {"hit@10": hits / weight, "ndcg@10": ndcg / weight}


def experiment_phases(dev):
    """The three ``EXPERIMENTS`` runs on one written ml1m-synth: the
    dataset's summary, one epoch's loss, time and examples/s, the valid
    and test metrics (test from the best checkpoint), the launches of
    each counted kernel against one per train step and eval batch as
    its path runs it, and the card in the environment report.  Returns
    {name: {"launches": {kernel: n}, "train_s", "examples_per_s",
    "eval_s", metric: value}}."""
    import os
    import tempfile

    from datamining_recblr_torch.data import native
    from datamining_recblr_torch.data.dataset import build_dataset
    from datamining_recblr_torch.data.synthetic import write_stat_matched_dataset
    from datamining_recblr_torch.drivers import run_experiment
    from datamining_recblr_torch.eval.evaluator import Evaluator
    from datamining_recblr_torch.run import build_config

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_stat_matched_dataset(os.path.join(tmp, "dataset"), EXP_PRESET, seed=EXP_GEN_SEED)
        t_write = time.perf_counter() - t0
        data = None
        for name, spec in EXPERIMENTS.items():
            cfg = build_config(spec["model"], EXP_PRESET, ["reference"], dict(
                spec["cfg"], epochs=1, data_path=os.path.join(tmp, "dataset"),
                checkpoint_dir=os.path.join(tmp, "saved", name), log_dir=os.path.join(tmp, "log"),
                metrics_file=os.path.join(tmp, f"{name}.jsonl")))
            if data is None:
                t0 = time.perf_counter()
                native.build()
                t_compile = time.perf_counter() - t0
                t0 = time.perf_counter()
                data = build_dataset(cfg)
                t_build = time.perf_counter() - t0
                got = {"users": data.n_users - 1, "items": data.n_items - 1,
                       "inters": data.n_interactions, "train": len(data.train)}
                phase("experiment-data", preset=EXP_PRESET, gen_seed=EXP_GEN_SEED,
                      summary=repr(data.summary()), write_s=f"{t_write:.1f}",
                      build_s=f"{t_build:.1f}", loader="native", compact=data.train.compact)
                check(got == EXP_SUMMARY, f"{EXP_PRESET}: {got}, not {EXP_SUMMARY}")
                native_loader_phase(data, t_compile, t_build, build_config(
                    "RecBLR", EXP_PRESET, ["reference"], dict(
                        data_path=os.path.join(tmp, "dataset"), use_native_loader=False)))
            for fn in spec["counted"]:
                fn.launches = 0
            t0 = time.perf_counter()
            result = run_experiment(cfg, data=data, plot_dir=os.path.join(tmp, "plot"))
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            launches = {fn.__name__: fn.launches for fn in spec["counted"]}
            trainer = result["trainer"]
            steps = -(-len(data.train) // int(cfg["train_batch_size"]))
            batches = sum(-(-len(split) // int(cfg["eval_batch_size"]))
                          for split in (data.valid, data.test))
            want = {fn.__name__: steps * a + batches * b
                    for fn, a, b in zip(spec["counted"], spec["per_step"], spec["per_eval"])}
            rec = result["metrics"].epoch_records()[0]
            flops = [r["flops"] for r in result["metrics"].records if r["event"] == "flops"]
            valid, test = rec.get(f"valid_{spec['metric']}"), result["test_result"]
            extra = {}
            if "floor_mode" in spec:
                # the trained model (after its one epoch, the best) in the floor's
                # mode, and the run's mode recomputed plainly
                ev = trainer.evaluator
                plain = plain_sampled_metrics(ev, data.valid)
                own = ev.evaluate(data.valid)
                floor_cfg = build_config(spec["model"], EXP_PRESET, ["reference"],
                                         {"eval_args": {"mode": spec["floor_mode"]}})
                valid = Evaluator(trainer.model, floor_cfg).evaluate(data.valid)[spec["metric"]]
                extra = {f"valid_{spec['floor_mode']}_{spec['metric']}": f"{valid:.4f}",
                         "plain_valid": repr({k: round(v, 4) for k, v in plain.items()}),
                         "chance_hit10": f"{10 / (1 + ev.n_negatives):.4f}"}
                check(all(abs(own[k] - v) <= 1e-3 for k, v in plain.items()),
                      f"{name}: {cfg['eval_args']['mode']} metrics {own} disagree with the "
                      f"plain recomputation {plain}")
            env = result["environment"]
            reloaded = bool(trainer.ckpt_path) and trainer.ckpt_path.startswith(tmp)
            phase(name, model=spec["model"], dtype=cfg["compute_dtype"], loss=cfg["loss_type"],
                  eval_mode=cfg["eval_args"]["mode"], epochs=len(result["metrics"].epoch_records()),
                  train_loss=f"{rec['train_loss']:.4f}", train_s=f"{rec['train_time']:.2f}",
                  steps=steps, examples_per_s=f"{len(data.train) / rec['train_time']:.1f}",
                  eval_s=f"{rec['eval_time']:.2f}", wall_s=f"{wall:.1f}",
                  forward_flops=flops[0] if flops else None,
                  valid=repr({k: round(v, 4) for k, v in sorted(result["best_valid_result"].items())}),
                  test=repr({k: round(v, 4) for k, v in sorted(test.items())}),
                  best_epoch=trainer.best_epoch, checkpoint_reloaded=reloaded,
                  launches=repr(launches), card=repr(env["nvidia_smi"]),
                  peak_device_gb=rec.get("device_mem_gb"), **extra)
            check(np.isfinite(rec["train_loss"]), f"{name}: the epoch loss is not finite")
            check(valid is not None and (valid > spec["floor"] if spec["strict"]
                                         else valid >= spec["floor"]),
                  f"{name}: valid {spec.get('floor_mode', cfg['eval_args']['mode'])} "
                  f"{spec['metric']} {valid} is not "
                  f"{'above' if spec['strict'] else 'at least'} {spec['floor']}")
            check(reloaded and trainer.best_epoch == 0, f"{name}: the test did not run from "
                  "the best checkpoint")
            check(launches == want, f"{name}: launches {launches}, expected {want}")
            check(env["backend"] == "cuda" and env["nvidia_smi"], f"{name}: environment {env}")
            out[name] = {"launches": launches, "train_s": rec["train_time"],
                         "examples_per_s": len(data.train) / rec["train_time"],
                         "eval_s": rec["eval_time"], spec["metric"]: valid}
    return out


def same_data(a, b) -> int:
    """Check two SeqData equal array for array and token for token;
    returns the number of arrays compared."""
    n = 0
    check((a.n_users, a.n_items, a.n_interactions) == (b.n_users, b.n_items, b.n_interactions)
          and a.item_id2token == b.item_id2token and a.user_id2token == b.user_id2token,
          f"native-loader: sizes or tokens differ: {a.summary()} / {b.summary()}")
    for split in ("train", "valid", "test"):
        x, y = getattr(a, split), getattr(b, split)
        check(x.compact == y.compact, f"native-loader: {split} compact {x.compact}, {y.compact}")
        keys = ("item_seq_len", "pos_item", "user_id") + (
            ("flat_items", "flat_start") if x.compact else ("item_seq",))
        for k in keys:
            check(np.array_equal(getattr(x, k), getattr(y, k)),
                  f"native-loader: {split}.{k} differs between the builders")
            n += 1
    check(len(a.user_train_items) == len(b.user_train_items)
          and all(np.array_equal(u, v) for u, v in zip(a.user_train_items, b.user_train_items)),
          "native-loader: the per-user train items differ")
    return n + 1


def native_loader_phase(data, compile_s, native_s, python_cfg):
    """The experiment's dataset (``build_dataset``, the native loader by
    default, compiled first in ``compile_s``) against the Python builder's
    from the same file on the card's host: every array equal, both build
    times."""
    from datamining_recblr_torch.data import native
    from datamining_recblr_torch.data.dataset import build_dataset

    t0 = time.perf_counter()
    py = build_dataset(python_cfg)
    python_s = time.perf_counter() - t0
    arrays = same_data(data, py)
    phase("native-loader", preset=EXP_PRESET, summary=repr(data.summary()),
          compile_s=f"{compile_s:.2f}", native_build_s=f"{native_s:.2f}",
          python_build_s=f"{python_s:.2f}", arrays_equal=arrays,
          library=native.lib_path().name)


# a checkpoint the JAX package wrote (tests/fixtures/jax_checkpoint/, made by
# tests/make_jax_checkpoint_fixture.py): RecBLR at the bench serving width
# over about 500 items, one epoch of adam, pickled; its expected.npz holds
# the JAX package's top-10 of its requests and the losses of three steps
# after its resume_from.  Counted: rows 1-4, and the LN prologue and the
# table gradient, which this fp32 RecBLR does not run
JAX_FIXTURE = ("tests", "fixtures", "jax_checkpoint")
JAXCK_COUNTED = LAUNCH_COUNTED + (FL.fused_ln_dropout, E.embedding_grad)
JAXCK_SCORE_TOL, JAXCK_LOSS_RTOL = 1e-4, 1e-4


def jax_checkpoint_phase(dev):
    """The fixture's checkpoint read by the port's reader on the card's
    machine (no JAX there), served through ``Recommender.from_checkpoint``
    and resumed through ``Trainer.resume_from`` plus the three recorded
    steps, through the kernels: ids equal JAX's, scores within
    ``JAXCK_SCORE_TOL`` of the largest, rows 1 and 3 launched by the
    request, each of rows 1-4 once a step, the losses within
    ``JAXCK_LOSS_RTOL`` relative.  Returns {"recommend": launches,
    "resume_steps": launches}."""
    import os

    from datamining_recblr_torch.train.checkpoint import restore_checkpoint
    from datamining_recblr_torch.train.trainer import Trainer

    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), *JAX_FIXTURE)
    with open(os.path.join(here, "config.json")) as f:
        meta = json.load(f)
    e = dict(np.load(os.path.join(here, "expected.npz")))
    ckpt = os.path.join(here, "recblr.pkl")
    t0 = time.perf_counter()
    state = restore_checkpoint(ckpt)
    read_s = time.perf_counter() - t0
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "optax", "ml_dtypes"))
    # the port's own dispatch (the fixture's "never" chose JAX's CPU path)
    cfg = Config(model="RecBLR", config_dict=dict(meta["config"], epochs=2,
                                                  use_pallas_scan="auto"))
    n_items, t = meta["n_items"], meta["config"]["MAX_ITEM_LIST_LENGTH"]
    users = [e["requests"][i, :n].tolist() for i, n in enumerate(e["request_lens"])]

    for fn in JAXCK_COUNTED:
        fn.launches = 0
    rec = Recommender.from_checkpoint(ckpt, cfg, n_items, t, top_k=e["ids"].shape[1])
    ids, vals = rec.recommend(users)
    torch.cuda.synchronize()
    served = {fn.__name__: fn.launches for fn in JAXCK_COUNTED}
    diff_ids = int((ids != e["ids"]).sum())
    score_err = float(np.abs(vals - e["scores"]).max() / np.abs(e["scores"]).max())

    for fn in JAXCK_COUNTED:
        fn.launches = 0
    trainer = Trainer(cfg, get_model("RecBLR")(cfg, n_items, t))
    trainer.resume_from(ckpt)
    losses = []
    for i, step in enumerate(e["steps"]):
        batch = {k: torch.from_numpy(e[k][i]).to(dev)
                 for k in ("item_seq", "item_seq_len", "pos_item", "weight")}
        losses.append(float(trainer.train_step(batch, int(step))))
    torch.cuda.synchronize()
    stepped = {fn.__name__: fn.launches for fn in JAXCK_COUNTED}
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, e["losses"].tolist()))
    steps = len(e["steps"])
    phase("jax-checkpoint", checkpoint="/".join(JAX_FIXTURE + ("recblr.pkl",)),
          read_s=f"{read_s:.3f}", epoch=state["epoch"], params=len(state["params"]),
          users=len(users), top_k=ids.shape[1], ids_differing=diff_ids,
          score_rel_err=f"{score_err:.3e}", start_epoch=trainer.start_epoch,
          losses=repr([f"{x:.7f}" for x in losses]),
          jax_losses=repr([f"{x:.7f}" for x in e["losses"].tolist()]),
          loss_rel_err=f"{loss_err:.3e}", launches_recommend=repr(served),
          launches_steps=repr(stepped), foreign_modules=repr(foreign))
    check(not foreign, f"jax-checkpoint: reading the pickle imported {foreign}")
    check(diff_ids == 0, f"jax-checkpoint: {diff_ids} recommended ids differ from JAX's")
    check(score_err <= JAXCK_SCORE_TOL, f"jax-checkpoint: scores {score_err:.3e} of the "
          f"largest off JAX's (tolerance {JAXCK_SCORE_TOL})")
    check(served["fused_recurrent_layer"] > 0 and served["fused_recurrent_layer_last"] > 0,
          f"jax-checkpoint: recommend launched {served}")
    check(trainer.start_epoch == state["epoch"] + 1, "jax-checkpoint: the resumed epoch")
    check(all(stepped[fn.__name__] == steps for fn in LAUNCH_COUNTED),
          f"jax-checkpoint: launches {stepped} in {steps} steps, one each a step expected")
    check(loss_err <= JAXCK_LOSS_RTOL, f"jax-checkpoint: losses {losses} against JAX's "
          f"{e['losses'].tolist()} ({loss_err:.3e} relative)")
    return {"recommend": served, "resume_steps": stepped}


# the cold-start pipeline (``python -m datamining_recblr_torch.run_with_unseen``)
# at amazon-beauty's size, the dataset of the reference's cold-start runs:
# beauty-synth of generator seed 2020 written as an .inter file, the user
# split (10% held out, reused by the second run), RecBLR at the reference
# config (fp32) for COLD_EPOCHS epochs, then the held-out users in mode
# none and in mode pre.  The split's dataset and its held-out users
# (``cold`` below) are what the JAX pipeline gives on the same file
COLD_PRESET, COLD_EPOCHS = "beauty-synth", 1
COLD_SUMMARY = {"users": 16_755, "items": 9_702, "train": 96_674, "held_out": 1_890,
                "evaluable": {"none": 1_139, "pre": 1_773}}


def plain_unseen_metrics(model, split, batch_size):
    """hit@10 and ndcg@10 of ``split`` recomputed plainly: each batch's
    sequence output through the plain layer versions
    (``plain_seq_output``), its scores against the item table, PAD
    masked, the target's rank one plus the items scoring above it plus
    the items of a smaller id scoring the same."""
    dev = model.device
    model.eval()
    hits = ndcg = 0.0
    table = model.item_embedding.float()[: model.n_items]
    with torch.no_grad():
        for start in range(0, len(split), batch_size):
            rows = slice(start, start + batch_size)
            seq = torch.from_numpy(split.item_seq[rows]).to(dev)
            lens = torch.from_numpy(split.item_seq_len[rows]).to(dev)
            tgt = torch.from_numpy(split.pos_item[rows]).to(dev).long()
            scores = plain_seq_output(model, seq, lens).float() @ table.T
            scores[:, 0] = float("-inf")
            s_t = scores.gather(1, tgt[:, None])
            ids = torch.arange(scores.shape[1], device=dev)[None, :]
            rank = 1 + ((scores > s_t) | ((scores == s_t) & (ids < tgt[:, None]))).sum(1)
            rank = rank.double().cpu().numpy()
            hits += float((rank <= 10).sum())
            ndcg += float(np.where(rank <= 10, 1.0 / np.log2(rank + 1.0), 0.0).sum())
    return {"hit@10": hits / len(split), "ndcg@10": ndcg / len(split)}


def cold_start_phases(dev):
    """``run_unseen_experiment`` in mode none, then mode pre, on one
    written beauty-synth: the held-out and evaluable users, the unseen
    items pre mapped, the seconds of the similarity, the epoch and the
    held-out evaluation, the seen- and unseen-user tests, each kernel's
    launches and the card.  Checks: rows 1-4 launch once a train step and
    rows 1 and 3 once an eval batch, the held-out batches counted; mode
    none's unseen metrics equal ``plain_unseen_metrics`` within 1e-3;
    pre evaluates at least as many users as none and maps at least one
    item; the second run reuses the split files unchanged; the seen and
    both unseen HR@10 are finite and above five times a full sort's
    chance, 10 / items.  Returns {mode: {"launches": {kernel: n},
    "train_s", "unseen_eval_s", "similarity_s"}}."""
    import os
    import tempfile

    from datamining_recblr_torch.data.synthetic import write_stat_matched_dataset
    from datamining_recblr_torch.run import build_config
    from datamining_recblr_torch.unseen import pipeline as UP

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_stat_matched_dataset(os.path.join(tmp, "dataset"), COLD_PRESET, seed=EXP_GEN_SEED)
        t_write = time.perf_counter() - t0
        ddir = os.path.join(tmp, "dataset", COLD_PRESET)
        split_files = [os.path.join(ddir, f"{COLD_PRESET}_{s}.inter") for s in ("train", "test")]
        split_bytes = None
        for mode in ("none", "pre"):
            cfg = build_config("RecBLR", COLD_PRESET, ["reference"], dict(
                epochs=COLD_EPOCHS, data_path=os.path.join(tmp, "dataset"),
                checkpoint_dir=os.path.join(tmp, "saved", mode), log_dir=os.path.join(tmp, "log"),
                metrics_file=os.path.join(tmp, f"cold-{mode}.jsonl")))
            for fn in LAUNCH_COUNTED:
                fn.launches = 0
            t0 = time.perf_counter()
            res = UP.run_unseen_experiment(mode=mode, config=cfg,
                                           plot_dir=os.path.join(tmp, "plot"))
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            launches = {fn.__name__: fn.launches for fn in LAUNCH_COUNTED}
            exp = res["experiment"]
            data, model, trainer = exp["data"], exp["model"], exp["trainer"]
            stamps = [os.stat(f).st_mtime_ns for f in split_files]
            now = [open(f, "rb").read() for f in split_files]
            reused = split_bytes is not None and now == split_bytes[0] and (
                stamps == split_bytes[1])
            split_bytes = split_bytes or (now, stamps)

            steps = COLD_EPOCHS * -(-len(data.train) // int(cfg["train_batch_size"]))
            ebs = int(cfg["eval_batch_size"])
            held = -(-res["n_evaluated"] // ebs)
            batches = COLD_EPOCHS * -(-len(data.valid) // ebs) + -(-len(data.test) // ebs) + held
            want = {fn.__name__: steps * a + batches * b
                    for fn, a, b in zip(LAUNCH_COUNTED, (1, 1, 1, 1), (1, 1, 0, 0))}
            epochs = exp["metrics"].epoch_records()
            rec = [r for r in exp["metrics"].records if r["event"] == "unseen_test"][-1]
            seen, unseen = res["seen_result"], res["unseen_result"]
            floor = 5 * 10 / (data.n_items - 1)
            got = {"users": data.n_users - 1, "items": data.n_items - 1, "train": len(data.train),
                   "held_out": res["n_unseen_users"]}
            extra = {}
            if mode == "none":
                _, test_df = UP.prepare_data_split(cfg)
                split, _, _ = UP.build_unseen_split(test_df, data, "none", None,
                                                    *(cfg[k] for k in ("USER_ID_FIELD",
                                                                       "ITEM_ID_FIELD",
                                                                       "TIME_FIELD")))
                plain = plain_unseen_metrics(model, split, ebs)
                extra["plain_unseen"] = repr({k: round(v, 5) for k, v in plain.items()})
            env = exp["environment"]
            phase(f"cold-start-{mode}", preset=COLD_PRESET, gen_seed=EXP_GEN_SEED,
                  write_s=f"{t_write:.1f}", summary=repr(data.summary()),
                  held_out_users=res["n_unseen_users"], evaluable_users=res["n_evaluated"],
                  mapped_items=rec["n_mapped"], epochs=len(epochs), steps=steps,
                  held_out_batches=held, similarity_s=f"{rec['similarity_s']:.2f}",
                  train_s=f"{sum(r['train_time'] for r in epochs):.2f}",
                  eval_s=f"{sum(r['eval_time'] for r in epochs):.2f}",
                  unseen_eval_s=f"{rec['eval_s']:.3f}", wall_s=f"{wall:.1f}",
                  train_loss=f"{epochs[-1]['train_loss']:.4f}",
                  seen_test=repr({k: round(v, 4) for k, v in sorted(seen.items())}),
                  unseen_test=repr({k: round(v, 5) for k, v in sorted(unseen.items())}),
                  hit10_floor=f"{floor:.5f}", split_reused=reused, launches=repr(launches),
                  card=repr(env["nvidia_smi"]), **extra)
            check(got == {k: COLD_SUMMARY[k] for k in got}
                  and res["n_evaluated"] == COLD_SUMMARY["evaluable"][mode],
                  f"cold-start-{mode}: {got}, {res['n_evaluated']} evaluable, not {COLD_SUMMARY}")
            check(launches == want, f"cold-start-{mode}: launches {launches}, expected {want}")
            if mode == "none":
                check(all(abs(unseen[k] - v) <= 1e-3 for k, v in plain.items()),
                      f"cold-start-none: unseen {unseen} disagrees with the plain "
                      f"recomputation {plain}")
            else:
                check(res["n_evaluated"] >= out["none"]["n_evaluated"] and rec["n_mapped"] > 0,
                      f"cold-start-pre: {res['n_evaluated']} evaluable users (none: "
                      f"{out['none']['n_evaluated']}), {rec['n_mapped']} items mapped")
                check(reused, "cold-start-pre: the split files were not reused unchanged")
            for name, result in (("seen", seen), ("unseen", unseen)):
                check(np.isfinite(result["hit@10"]) and result["hit@10"] > floor,
                      f"cold-start-{mode}: {name} HR@10 {result['hit@10']} is not above "
                      f"{floor:.5f}")
            check(env["backend"] == "cuda" and env["nvidia_smi"], f"cold-start-{mode}: {env}")
            out[mode] = {"launches": launches, "n_evaluated": res["n_evaluated"],
                         "train_s": sum(r["train_time"] for r in epochs),
                         "unseen_eval_s": rec["eval_s"], "similarity_s": rec["similarity_s"]}
    return out


def _bwd_flops_k1(b, t):
    """(products, the rest): the forward's products recomputed plus the
    two gradient products of each (3x); the conv recomputed and its two
    gradients."""
    fwd_mm = 2 * D * 2 * C + 2 * C * 2 * C + 2 * C * D + 4 * D * FF
    return b * t * 3 * fwd_mm, b * t * 6 * K * C


def k1_bwd_bound_ms(b, t, p, act_bytes, priced_fma=False):
    # x, dout and dx [B, T, D]; the stashed alpha and h [B, T, C] fp32
    nbytes = b * t * (3 * D * act_bytes + 2 * C * 4) + 2 * _params_bytes(p)
    return _recblr_bound(*_bwd_flops_k1(b, t), nbytes, priced_fma)


def k2_bwd_bound_ms(lens, t, p, act_bytes, priced_fma=False):
    # per position below the length: in-projection (xb half) and gates
    # recomputed with their two gradients each, the conv and its
    # gradients; per row: the tail matmuls (z half, W_out, FFN) x3
    n = lens.where((lens >= 1) & (lens <= t), torch.zeros_like(lens))
    positions = int(n.sum())
    b = lens.numel()
    mm = (positions * 3 * (2 * D * C + 2 * C * 2 * C)
          + b * 3 * (2 * D * C + 2 * C * D + 4 * D * FF))
    nbytes = (positions * (D * act_bytes + 2 * C * 4) + b * t * D * act_bytes
              + b * D * act_bytes + b * 4 + 2 * _params_bytes(p))
    return _recblr_bound(mm, positions * 6 * K * C, nbytes, priced_fma)


def training_kernel_times(dev):
    """The four kernels on the training path (p = 0.2, fp32): forwards at
    B = 2,048, backwards at B = 2,048 and 256, each beside its bound and
    its plain version (a backward's plain time is autograd's backward of
    the plain forward, its graph built once)."""
    gen = torch.Generator().manual_seed(SEED + 4)
    p1 = layer_params(gen, dev, prologue=True)
    p2 = layer_params(gen, dev, prologue=False)
    rows = {}
    seed = 4242
    for b in (TRAIN_B, B):
        x = torch.randn((b, T, D), generator=gen).to(dev)
        lens = torch.randint(2, T + 1, (b,), generator=gen).to(dev)
        d1 = torch.randn((b, T, D), generator=gen).to(dev)
        d2 = torch.randn((b, D), generator=gen).to(dev)
        _, s1 = FL.fused_recurrent_layer_train(x, p1, True, True, True, DROPOUT, seed)
        _, s2 = FL.fused_recurrent_layer_last_train(x, lens, p2, True, True, DROPOUT, seed)
        check(s1 is not None and s2 is not None, "the stash policy refused the bench shape")
        times = {
            "fused_recurrent_layer_bwd": time_ms(lambda: FL.fused_recurrent_layer_bwd(
                x, d1, p1, True, True, True, DROPOUT, seed, saved=s1)),
            "fused_recurrent_layer_last_bwd": time_ms(lambda: FL.fused_recurrent_layer_last_bwd(
                x, lens, d2, p2, True, True, DROPOUT, seed, saved=s2)),
        }
        if b == TRAIN_B:
            times["fused_recurrent_layer"] = time_ms(lambda: FL.fused_recurrent_layer_train(
                x, p1, True, True, True, DROPOUT, seed))
            times["fused_recurrent_layer_last"] = time_ms(
                lambda: FL.fused_recurrent_layer_last_train(x, lens, p2, True, True, DROPOUT,
                                                            seed))
        plain = {}
        for name, fn, pp, dout in (
            ("fused_recurrent_layer_bwd", lambda a, q: FL.fused_recurrent_layer_plain(
                a, q, True, True, True, DROPOUT, seed), p1, d1),
            ("fused_recurrent_layer_last_bwd", lambda a, q: FL.fused_recurrent_layer_last_plain(
                a, lens, q, True, True, DROPOUT, seed), p2, d2),
        ):
            xl = x.clone().requires_grad_()
            ql = {k: v.clone().requires_grad_() for k, v in pp.items()}
            if b == TRAIN_B:
                plain[name[:-4]] = time_ms(lambda: fn(x, pp), reps=5, warmup=1)
            out = fn(xl, ql)
            inputs = [xl, *ql.values()]
            plain[name] = time_ms(lambda: torch.autograd.grad(out, inputs, dout,
                                                              retain_graph=True),
                                  reps=5, warmup=1)
            del out
        bounds = {
            "fused_recurrent_layer_bwd": k1_bwd_bound_ms(b, T, p1, 4),
            "fused_recurrent_layer_last_bwd": k2_bwd_bound_ms(lens.cpu(), T, p2, 4),
            "fused_recurrent_layer": k1_bound_ms(b, T, p1, 4),
            "fused_recurrent_layer_last": k2_bound_ms(lens.cpu(), p2, 4),
        }
        fma = {"fused_recurrent_layer_bwd": k1_bwd_bound_ms(b, T, p1, 4, priced_fma=True),
               "fused_recurrent_layer_last_bwd": k2_bwd_bound_ms(lens.cpu(), T, p2, 4,
                                                                 priced_fma=True),
               "fused_recurrent_layer": k1_bound_ms(b, T, p1, 4, priced_fma=True),
               "fused_recurrent_layer_last": k2_bound_ms(lens.cpu(), p2, 4, priced_fma=True)}
        for name, ms in times.items():
            bound, flops, by = bounds[name]
            phase("kernel-time", kernel=name, B=b, T=T, dtype="float32", p=DROPOUT,
                  ms=f"{ms:.4f}", plain_ms=f"{plain[name]:.4f}", bound_ms=f"{bound:.5f}",
                  gflop=f"{flops / 1e9:.3f}", bound_by=by, share_of_bound=f"{bound / ms:.4f}",
                  **_fma_field(fma, name))
            rows[(name, b)] = (ms, plain[name], bound, by)
    return rows


def requests(rng, b, t=T, n_items=N_ITEMS):
    seqs = [list(rng.integers(1, n_items, size=rng.integers(2, t))) for _ in range(b)]
    if b >= 4:
        seqs[0] = []                                     # empty history
        seqs[1] = [int(rng.integers(1, n_items))]        # one item
        seqs[2] = list(rng.integers(1, n_items, t + 37))  # longer than T
    return seqs


# per served model: its phases' prefix, the kernels one recommend()
# launches, and its scores' reference through the plain versions
SERVED = {
    "RecBLR": ("serve", (FL.fused_recurrent_layer, FL.fused_recurrent_layer_last),
               plain_seq_output),
    "SASRec": ("serve-sasrec", ATTN_COUNTED, plain_baseline_output),
    "BERT4Rec": ("serve-bert4rec", ATTN_COUNTED, plain_baseline_output),
}
SERVED_XLONG = ("serve-xlong", (FLC.fused_recurrent_layer_chunked,
                                FL.fused_recurrent_layer_last), plain_seq_output)


def _at_full_width(model):
    if hasattr(model, "encoder"):
        return L._use_fused_attention() and (
            model.hidden_size, model.n_heads, model.inner_size, len(model.encoder),
            model.hidden_act) == (D, HEADS, INNER, 2, "gelu")
    return (model.use_fused_layer() or model.use_chunked_layer()) and (
        model.hidden_size, model.inner_hidden, len(model.layers)) == (D, C, 2)


def serving(dev, name, dtype_name, xlong=False, path=None):
    """``Recommender.recommend`` at B users against the same model through
    the plain versions, with one launch of each of the model's kernels per
    call, and its time; with ``xlong`` RecBLR at the XLong shape (T 1,024,
    V 329,722: the chunked layer and the last-position layer); with
    ``path`` RecBLR on that path outside the whole-layer kernels
    (``SLICE_PATHS``: its kernels' launches per call as given there) or
    SASRec or BERT4Rec on a path of the per-op composition
    (``BASELINE_PATHS``: its users, and whether it is timed)."""
    from datamining_recblr_torch.eval.metrics import mask_scores
    from datamining_recblr_torch.ops.topk import topk_scores

    users, timed = B, True
    if path in SLICE_PATHS:
        spec = SLICE_PATHS[path]
        prefix, counted, plain_output = f"serve-{path}", spec["served"], plain_path_output
        t, n_items = spec["t"], spec["v"]
        expected = (spec["per_call"],) * len(counted)
        cfg = slice_config(path, dtype_name)
        on_path = functools.partial(on_slice_path, path=path)
    elif path is not None:
        spec = BASELINE_PATHS[path]
        prefix, counted = f"serve-{name.lower()}-{path}", PATH_SERVED
        plain_output, t, n_items = plain_per_op_output, spec["t"], N_ITEMS
        users, timed = spec["users"], spec["timed"]
        cfg = path_config(name, path, dtype_name)
        on_path = functools.partial(on_baseline_path, path=path)
    else:
        prefix, counted, plain_output = SERVED_XLONG if xlong else SERVED[name]
        t, n_items = (XT, XV) if xlong else (T, N_ITEMS)
        expected = (1,) * len(counted)
        cfg = Config(model=name, config_dict={"MAX_ITEM_LIST_LENGTH": t,
                                              "compute_dtype": dtype_name})
        on_path = _at_full_width
    model = get_model(name)(cfg, n_items, t, generator=torch.Generator().manual_seed(SEED))
    if path in BASELINE_PATHS:
        expected = per_op_launches(model, counted)
    check(model.device.type == "cuda", f"{name}: model not on the card")
    check(on_path(model), f"{name}: model is not at full width on its path")
    check(not xlong or (model.use_chunked_layer() and model.use_last_layer_kernel()),
          f"{name}: not the chunked composition at T {t}")
    rec = Recommender(model, top_k=TOP_K)
    rng = np.random.default_rng(SEED)
    seqs = requests(rng, users, t, n_items)

    for fn in counted:
        fn.launches = 0
    ids, vals = rec.recommend(seqs)
    launches = tuple(fn.launches for fn in counted)
    phase(f"{prefix}-launches", dtype=dtype_name, calls=1,
          **{fn.__name__: n for fn, n in zip(counted, launches)})
    check(launches == expected, f"{name}: expected launches {expected}, got {launches}")

    # reference: the same model through the plain versions on the card
    seq = np.zeros((users, t), np.int64)
    lens = np.zeros((users,), np.int32)
    hist = np.zeros((users, model.n_items_padded), bool)
    for i, items in enumerate(seqs):
        w = np.asarray(items, np.int64)[-t:]
        seq[i, : len(w)] = w
        lens[i] = len(w)
        if len(items):
            hist[i, np.asarray(items, np.int64)] = True
    with torch.inference_mode():
        out = plain_output(model, torch.from_numpy(seq).to(dev), torch.from_numpy(lens).to(dev))
        ref = model._mask_padded_vocab(model._logits(out))
        ref = mask_scores(ref, history=torch.from_numpy(hist[:, : ref.shape[-1]]).to(dev))
        ref_vals, ref_ids = topk_scores(ref, TOP_K)
    ref = ref.cpu().numpy()
    ref_vals = ref_vals.cpu().numpy()
    ref_ids = ref_ids.cpu().numpy()
    scale = float(np.abs(ref_vals).max())
    tol = 1e-4 if dtype_name == "float32" else scale / 32
    check(ids.shape == (users, TOP_K) and np.isfinite(vals).all(),
          f"{name}: bad serving output")
    err = float(np.abs(vals - ref_vals).max())
    ties = 0
    for i, j in zip(*np.nonzero(ids != ref_ids)):
        ties += 1
        check(abs(ref[i, ids[i, j]] - ref_vals[i, j]) <= tol,
              f"{name} row {i}: id {ids[i, j]} is not a near-tie of the reference")
    excluded = all(not set(ids[i].tolist()) & set(map(int, s)) for i, s in enumerate(seqs))
    phase(f"{prefix}-vs-plain", dtype=dtype_name, users=users, top_k=TOP_K,
          max_abs_score_err=f"{err:.3e}", tol=f"{tol:.3e}", id_mismatches_near_ties=ties,
          history_excluded=excluded)
    check(err <= tol, f"{name}: serving scores disagree with the plain model")
    check(excluded and (ids != 0).all() and (ids < n_items).all(),
          f"{name}: history, PAD or a padded id recommended")
    del ref

    # timings as bench.py's serve_main takes them: host clock around
    # recommend(), median over repeats, after a first call
    out = {"launches": launches}
    if not timed:
        return out
    for b, reps in ((1, 50), (B, 20)):
        batch = requests(rng, b, t, n_items)
        rec.recommend(batch)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            rec.recommend(batch)
            times.append(time.perf_counter() - t0)
        med = float(np.median(times))
        out[b] = med
        serve_profile(rec, batch, prefix, dtype_name)
    phase(f"{prefix}-time", dtype=dtype_name, p50_ms_1_user=f"{out[1] * 1e3:.3f}",
          users_per_s_batch256=f"{B / out[B]:.1f}", median_ms_batch256=f"{out[B] * 1e3:.3f}")
    return out


def topk_times(dev, users=B):
    """C6's top-k at XLong's catalog (``users`` rows of V 329,728 fp32
    scores), CUDA-event medians of three designs: the port's
    ``topk_scores`` (``torch.topk`` over 2k, then a stable re-sort of the
    candidates), a stable descending sort of the whole row cut to k, and
    ``torch.topk`` alone (no tie order: what ``recommend`` ran before C6).
    Two inputs: scores as ``recommend`` gives them (random, each row's
    history and the padded ids at -inf) and integer scores in [-3, 3]
    (every row a run of ties longer than 2k: ``topk_scores``' full-row
    fallback).  The two tie-ordered designs must give the same ids."""
    from datamining_recblr_torch.ops.topk import _order_keys, topk_scores

    def full_sort(s, k):
        ids = _order_keys(s).sort(dim=-1, descending=True, stable=True).indices[:, :k]
        return s.gather(-1, ids), ids

    vp = -(-XV // 2048) * 2048
    gen = torch.Generator(device=dev).manual_seed(SEED)
    served = torch.randn((users, vp), generator=gen, device=dev)
    served[:, XV:] = -torch.inf
    hist = torch.randint(1, XV, (users, XMAX_LEN), generator=gen, device=dev)
    served.scatter_(1, hist, -torch.inf)
    tied = torch.randint(-3, 4, (users, vp), generator=gen, device=dev).float()
    for name, s in (("served", served), ("ties", tied)):
        ids = topk_scores(s, TOP_K)[1]
        check(torch.equal(ids, full_sort(s, TOP_K)[1]),
              f"topk_scores and the stable full sort disagree on {name} scores")
        ms = {d: time_ms(lambda f=f: f(s, TOP_K))
              for d, f in (("topk_resort", topk_scores), ("stable_sort", full_sort),
                           ("torch_topk", lambda a, k: torch.topk(a, k, dim=-1)))}
        phase("topk-time", scores=name, B=users, V=vp, k=TOP_K,
              **{f"{d}_ms": f"{v:.4f}" for d, v in ms.items()})


def serve_profile(rec, batch, prefix, dtype_name, calls=5):
    """Device time by kernel over a few recommend() calls (torch.profiler,
    CUPTI), and the device's busy share of the profiled wall time (the
    profiler's own host overhead is inside that wall time)."""
    kernels, wall_us = profiled(_timed_loop(lambda _: rec.recommend(batch), calls),
                                fwd_mma_required(prefix, dtype_name))
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    phase(f"{prefix}-profile", dtype=dtype_name, users=len(batch), calls=calls,
          wall_ms_per_call=f"{wall_us / calls / 1e3:.3f}",
          device_ms_per_call=f"{busy_us / calls / 1e3:.3f}" if kernels else "not measured",
          device_busy_share=f"{busy_us / wall_us:.3f}" if kernels else "not measured",
          top=repr([(e.key[:48], round(e.self_device_time_total / calls, 1)) for e in top]))
    for name in fwd_mma_required(prefix, dtype_name):
        check(any(name in e.key for e in kernels), f"{prefix}: no {name} in the profile")


def kernel_times(dev, p1, p2, lens):
    gen = torch.Generator().manual_seed(SEED + 1)
    rows = {}
    for b in (B, 1):
        x = torch.randn((b, T, D), generator=gen).to(dev)
        ln = lens[:b] if b > 1 else torch.tensor([T], device=dev)
        k1 = time_ms(lambda: FL.fused_recurrent_layer(x, p1, prologue=True))
        k1p = time_ms(lambda: FL.fused_recurrent_layer_plain(x, p1, prologue=True), reps=10)
        k2 = time_ms(lambda: FL.fused_recurrent_layer_last(x, ln, p2))
        k2p = time_ms(lambda: FL.fused_recurrent_layer_last_plain(x, ln, p2), reps=10)
        fma = {"fused_recurrent_layer": k1_bound_ms(b, T, p1, 4, priced_fma=True),
               "fused_recurrent_layer_last": k2_bound_ms(ln.cpu(), p2, 4, priced_fma=True)}
        for name, ms, plain, (bound, flops, by) in (
            ("fused_recurrent_layer", k1, k1p, k1_bound_ms(b, T, p1, 4)),
            ("fused_recurrent_layer_last", k2, k2p, k2_bound_ms(ln.cpu(), p2, 4)),
        ):
            phase("kernel-time", kernel=name, B=b, T=T, dtype="float32", ms=f"{ms:.4f}",
                  plain_ms=f"{plain:.4f}", bound_ms=f"{bound:.5f}", gflop=f"{flops / 1e9:.3f}",
                  bound_by=by, share_of_bound=f"{bound / ms:.4f}", **_fma_field(fma, name))
            rows[(name, b)] = (ms, plain, bound, by)
    return rows


def _attn_mask(lens, t, causal):
    """[B * HEADS, T, T] additive float mask, -10000 where a key is dropped
    (the layout torch.nn.MultiheadAttention adds to its scores)."""
    col = torch.arange(t, device=lens.device)
    keep = (col[None, None, :] < lens[:, None, None]).expand(-1, t, t)
    if causal:
        keep = keep & (col[None, :] <= col[:, None])[None]
    return torch.where(keep, 0.0, FB.MASK_VALUE).repeat_interleave(HEADS, dim=0)


def library_layer(p, dev):
    """torch.nn.TransformerEncoderLayer with the kernel's weights: post-LN,
    tanh GELU, eps 1e-12, dropout 0.  A yardstick of time only: the port
    never calls it."""
    layer = torch.nn.TransformerEncoderLayer(
        D, HEADS, INNER, dropout=0.0, activation=lambda v: F.gelu(v, approximate="tanh"),
        layer_norm_eps=1e-12, batch_first=True, norm_first=False, device=dev)
    with torch.no_grad():
        attn = layer.self_attn
        attn.in_proj_weight.copy_(torch.cat([p["w_q"], p["w_k"], p["w_v"]], 1).T)
        attn.in_proj_bias.copy_(torch.cat([p["b_q"], p["b_k"], p["b_v"]]))
        attn.out_proj.weight.copy_(p["w_o"].T)
        attn.out_proj.bias.copy_(p["b_o"])
        for lin, w, b in ((layer.linear1, "w1", "b1"), (layer.linear2, "w2", "b2")):
            lin.weight.copy_(p[w].T)
            lin.bias.copy_(p[b])
        for norm, n in ((layer.norm1, "ln1"), (layer.norm2, "ln2")):
            norm.weight.copy_(p[f"{n}_s"])
            norm.bias.copy_(p[f"{n}_b"])
    return layer.eval()


def attn_kernel_times(dev):
    """The attention baselines' three kernels at B = 256 and 1, fp32,
    each beside its bound, its plain version and, where one exists, one
    PyTorch call of the same function (row 10: TransformerEncoderLayer,
    first checked against the plain version; row 6: add + layer_norm)."""
    gen = torch.Generator().manual_seed(SEED + 6)
    p = block_params(gen, dev)
    pos = (0.5 * torch.randn((T, D), generator=gen)).to(dev)
    s, bias = p["ln1_s"], p["ln1_b"]
    layer = library_layer(p, dev)
    rows = {}
    for b in (B, 1):
        x = torch.randn((b, T, D), generator=gen).to(dev)
        lens = serving_lens(gen, b).to(dev) if b > 1 else torch.tensor([T], device=dev)
        mask = _attn_mask(lens, T, causal=True)
        with torch.no_grad():
            lib_out = layer(x, src_mask=mask)
            want = FB.fused_transformer_layer_plain(x, lens, p, True, HEADS)
            lib_err = float((lib_out - want).abs().max())
            lib_ok = lib_err <= 1e-4 * float(want.abs().max())
            phase("library-vs-plain", call="torch.nn.TransformerEncoderLayer", B=b, T=T,
                  causal=True, max_abs_err=f"{lib_err:.3e}", tol="1e-4*max|plain|", ok=lib_ok)
            check(lib_ok, "TransformerEncoderLayer does not compute the plain layer's function")
            lib_ms = {
                "fused_ln_dropout": time_ms(
                    lambda: F.layer_norm(x + pos, (D,), s, bias, L.LN_EPS)),
                "fused_transformer_layer": time_ms(lambda: layer(x, src_mask=mask)),
                "fused_transformer_layer_last": None,
            }
        cases = (
            ("fused_ln_dropout", lambda: FL.fused_ln_dropout(x, pos, s, bias),
             lambda: FL.fused_ln_dropout_plain(x, pos, s, bias), ln_bound_ms(b, 4)),
            ("fused_transformer_layer",
             lambda: FB.fused_transformer_layer(x, lens, p, True, HEADS),
             lambda: FB.fused_transformer_layer_plain(x, lens, p, True, HEADS),
             block_bound_ms(lens.cpu(), T, True, p, 4)),
            ("fused_transformer_layer_last",
             lambda: FB.fused_transformer_layer_last(x, lens, p, HEADS),
             lambda: FB.fused_transformer_layer_last_plain(x, lens, p, HEADS),
             block_last_bound_ms(lens.cpu(), T, p, 4)),
        )
        fma = {"fused_transformer_layer": block_bound_ms(lens.cpu(), T, True, p, 4,
                                                         priced_fma=True),
               "fused_transformer_layer_last": block_last_bound_ms(lens.cpu(), T, p, 4,
                                                                   priced_fma=True)}
        for name, kernel, plain, (bound, flops, by) in cases:
            ms = time_ms(kernel)
            plain_ms = time_ms(plain, reps=10)
            lib = lib_ms[name]
            phase("kernel-time", kernel=name, B=b, T=T, dtype="float32", ms=f"{ms:.4f}",
                  plain_ms=f"{plain_ms:.4f}",
                  library_ms=f"{lib:.4f}" if lib is not None else "none",
                  bound_ms=f"{bound:.5f}", gflop=f"{flops / 1e9:.3f}", bound_by=by,
                  share_of_bound=f"{bound / ms:.4f}", **_fma_field(fma, name))
            rows[(name, b)] = (ms, plain_ms, bound, by, lib)
    return rows


def attn_training_kernel_times(dev):
    """The six kernels of SASRec's training step at B = 2,048, T = 200,
    fp32, p = 0.5 (the forwards keeping what the backwards read), each
    beside its bound, its plain version (a backward's: autograd's
    backward of the plain forward, its graph built once) and, where one
    exists, one PyTorch call of the same function: row 10
    torch.nn.TransformerEncoderLayer (its forward; for the backward
    ``autograd.grad`` through it, checked first to give the plain dx),
    row 6 add + layer_norm (the same), both at dropout 0."""
    gen = torch.Generator().manual_seed(SEED + 7)
    p = block_params(gen, dev)
    b = TRAIN_B
    x = torch.randn((b, T, D), generator=gen).to(dev)
    pos = (0.5 * torch.randn((T, D), generator=gen)).to(dev)
    s, bias = p["ln1_s"], p["ln1_b"]
    lens = torch.randint(2, T + 1, (b,), generator=gen).to(dev)
    d3 = torch.randn((b, T, D), generator=gen).to(dev)
    d2 = torch.randn((b, D), generator=gen).to(dev)
    seed = 4242
    drop = (SAS_DROPOUT, SAS_DROPOUT, seed)
    _, s10 = FB.fused_transformer_layer_train(x, lens, p, True, HEADS, "gelu", *drop)
    _, s11 = FB.fused_transformer_layer_last_train(x, lens, p, HEADS, "gelu", *drop)
    times = {
        "fused_ln_dropout": time_ms(lambda: FL.fused_ln_dropout(x, pos, s, bias, SAS_DROPOUT,
                                                                seed)),
        "fused_transformer_layer": time_ms(lambda: FB.fused_transformer_layer_train(
            x, lens, p, True, HEADS, "gelu", *drop)),
        "fused_transformer_layer_last": time_ms(lambda: FB.fused_transformer_layer_last_train(
            x, lens, p, HEADS, "gelu", *drop)),
        "fused_ln_dropout_bwd": time_ms(lambda: FL.fused_ln_dropout_bwd(
            x, pos, d3, s, bias, SAS_DROPOUT, seed)),
        "fused_transformer_layer_bwd": time_ms(lambda: FB.fused_transformer_layer_bwd(
            x, lens, d3, p, True, HEADS, "gelu", *drop, saved=s10)),
        "fused_transformer_layer_last_bwd": time_ms(lambda: FB.fused_transformer_layer_last_bwd(
            x, lens, d2, p, HEADS, "gelu", *drop, saved=s11)),
    }
    del s10, s11
    lp = {"pos": pos, "s": s, "b": bias}
    plain = {}
    for name, fn, pp, dout in (
        ("fused_ln_dropout", lambda a, q: FL.fused_ln_dropout_plain(
            a, q["pos"], q["s"], q["b"], SAS_DROPOUT, seed), lp, d3),
        ("fused_transformer_layer", lambda a, q: FB.fused_transformer_layer_plain(
            a, lens, q, True, HEADS, "gelu", *drop), p, d3),
        ("fused_transformer_layer_last", lambda a, q: FB.fused_transformer_layer_last_plain(
            a, lens, q, HEADS, "gelu", *drop), p, d2),
    ):
        with torch.no_grad():
            plain[name] = time_ms(lambda: fn(x, pp), reps=5, warmup=1)
        xl = x.clone().requires_grad_()
        ql = {k: v.clone().requires_grad_() for k, v in pp.items()}
        out = fn(xl, ql)
        inputs = [xl, *ql.values()]
        plain[name + "_bwd"] = time_ms(lambda: torch.autograd.grad(out, inputs, dout,
                                                                   retain_graph=True),
                                       reps=5, warmup=1)
        del out, inputs, xl, ql
    # the library yardsticks at dropout 0, each checked against the plain
    # version first
    layer = library_layer(p, dev).train()
    mask = _attn_mask(lens, T, causal=True)
    xl = x.clone().requires_grad_()
    lib_out = layer(xl, src_mask=mask)
    lib_dx, = torch.autograd.grad(lib_out, [xl], d3, retain_graph=True)
    _, want_dx, _ = _plain_vjp(lambda a, q: FB.fused_transformer_layer_plain(
        a, lens, q, True, HEADS), x, p, d3)
    lib_err = float((lib_dx - want_dx).abs().max())
    lib_ok = lib_err <= 1e-4 * float(want_dx.abs().max())
    phase("library-vs-plain", call="torch.nn.TransformerEncoderLayer backward", B=b, T=T,
          causal=True, max_abs_dx_err=f"{lib_err:.3e}", tol="1e-4*max|plain dx|", ok=lib_ok)
    check(lib_ok, "TransformerEncoderLayer's backward does not give the plain layer's dx")
    lib_params = [xl, *layer.parameters()]
    ql = {k: v.clone().requires_grad_() for k, v in lp.items()}
    xln = x.clone().requires_grad_()
    ln_out = F.layer_norm(xln + ql["pos"], (D,), ql["s"], ql["b"], L.LN_EPS)
    with torch.no_grad():
        lib = {
            "fused_ln_dropout": time_ms(lambda: F.layer_norm(x + pos, (D,), s, bias, L.LN_EPS)),
            "fused_transformer_layer": time_ms(lambda: layer(x, src_mask=mask)),
            "fused_transformer_layer_last": None,
            "fused_transformer_layer_last_bwd": None,
        }
    lib["fused_transformer_layer_bwd"] = time_ms(lambda: torch.autograd.grad(
        lib_out, lib_params, d3, retain_graph=True))
    lib["fused_ln_dropout_bwd"] = time_ms(lambda: torch.autograd.grad(
        ln_out, [xln, *ql.values()], d3, retain_graph=True))
    del lib_out, ln_out
    lc = lens.cpu()
    bounds = {
        "fused_ln_dropout": ln_bound_ms(b, 4),
        "fused_transformer_layer": block_bound_ms(lc, T, True, p, 4, stash=True),
        "fused_transformer_layer_last": block_last_bound_ms(lc, T, p, 4, stash=True),
        "fused_ln_dropout_bwd": ln_bwd_bound_ms(b, 4),
        "fused_transformer_layer_bwd": block_bwd_bound_ms(lc, T, True, p, 4),
        "fused_transformer_layer_last_bwd": block_last_bwd_bound_ms(lc, T, p, 4),
    }
    fma = {"fused_transformer_layer": block_bound_ms(lc, T, True, p, 4, stash=True,
                                                     priced_fma=True),
           "fused_transformer_layer_last": block_last_bound_ms(lc, T, p, 4, stash=True,
                                                               priced_fma=True)}
    rows = {}
    for name, ms in times.items():
        bound, flops, by = bounds[name]
        lib_ms = lib[name]
        phase("kernel-time", kernel=name, B=b, T=T, dtype="float32", p=SAS_DROPOUT,
              ms=f"{ms:.4f}", plain_ms=f"{plain[name]:.4f}",
              library_ms=f"{lib_ms:.4f}" if lib_ms is not None else "none",
              bound_ms=f"{bound:.5f}", gflop=f"{flops / 1e9:.3f}", bound_by=by,
              share_of_bound=f"{bound / ms:.4f}", **_fma_field(fma, name))
        rows[name] = (ms, plain[name], bound, by, lib_ms)
    return rows


# row 10's backward by phase: the kernels recblr_block_bwd launches
ROW10_BWD_PHASES = (("T'", "attn_tail_bwd_kernel"), ("A'", "attn_bwd_kernel"),
                    ("P'", "proj_bwd_kernel"), ("reduce", "reduce_partials_kernel"))


def row10_bwd_phase_times(dev, calls=10):
    """Row 10's backward at the bench shape (B 2,048, T 200, p 0.5 as
    SASRec's; causal as SASRec's layers, bidirectional as BERT4Rec's layer
    0; fp32 and bf16): its CUDA-event time beside each phase's device time
    per call, from torch.profiler over ``calls`` calls."""
    gen = torch.Generator().manual_seed(SEED + 7)
    p = block_params(gen, dev)
    x = torch.randn((TRAIN_B, T, D), generator=gen).to(dev)
    lens = torch.randint(2, T + 1, (TRAIN_B,), generator=gen).to(dev)
    d3 = torch.randn((TRAIN_B, T, D), generator=gen).to(dev)
    drop = (SAS_DROPOUT, SAS_DROPOUT, 4242)
    for causal in (True, False):
        for dt in (torch.float32, torch.bfloat16):
            xd, dd = x.to(dt), d3.to(dt)
            _, saved = FB.fused_transformer_layer_train(xd, lens, p, causal, HEADS, "gelu", *drop)

            def call():
                return FB.fused_transformer_layer_bwd(xd, lens, dd, p, causal, HEADS, "gelu",
                                                      *drop, saved=saved)

            phase("kernel-time-phase", kernel="fused_transformer_layer_bwd", B=TRAIN_B, T=T,
                  causal=causal, dtype=str(dt).replace("torch.", ""), p=SAS_DROPOUT,
                  **_phase_times(call, ROW10_BWD_PHASES, calls))
            del saved


def _phase_times(call, phases, calls, require=()):
    """kernel-time-phase fields of ``call``: its CUDA-event ms and, from
    torch.profiler over ``calls`` calls, each phase's device ms per call
    (the kernels whose names hold the phase's) and share of the device
    total, and that total.  Fails unless a kernel whose name holds each
    of ``require`` ran."""
    ms = time_ms(call)
    events, _ = profiled(_timed_loop(lambda _: call(), calls), require)
    dev_us = {e.key: e.self_device_time_total for e in events}
    total = sum(dev_us.values())
    fields = {"ms": f"{ms:.4f}"}
    for label, kernel in phases:
        us = sum(v for k, v in dev_us.items() if kernel in k)
        fields[f"{label}_ms"] = f"{us / calls / 1e3:.4f}" if us else "not measured"
        if us:
            fields[f"{label}_share"] = f"{us / total:.4f}"
    fields["device_ms"] = f"{total / calls / 1e3:.4f}"
    for name in require:
        check(any(name in k for k in dev_us), f"no {name} in the profile of {phases}")
    return fields


# row 10's forward by phase: the projection, attention, the layer's tail
ROW10_FWD_PHASES = (("P", "proj_kernel"), ("A", "attn_kernel"), ("C", "tail_kernel"))


def row10_fwd_phase_times(dev, calls=10):
    """Row 10's forward at the bench training shape (B 2,048, T 200, p 0.5,
    the forward that keeps what the backward reads; causal as SASRec's
    layers, bidirectional as BERT4Rec's layer 0; fp32 and bf16): its
    CUDA-event time beside each phase's device time per call, from
    torch.profiler over ``calls`` calls."""
    gen = torch.Generator().manual_seed(SEED + 7)
    p = block_params(gen, dev)
    x = torch.randn((TRAIN_B, T, D), generator=gen).to(dev)
    lens = torch.randint(2, T + 1, (TRAIN_B,), generator=gen).to(dev)
    drop = (SAS_DROPOUT, SAS_DROPOUT, 4242)
    for causal in (True, False):
        for dt in (torch.float32, torch.bfloat16):
            xd = x.to(dt)
            phase("kernel-time-phase", kernel="fused_transformer_layer", B=TRAIN_B, T=T,
                  causal=causal, dtype=str(dt).replace("torch.", ""), p=SAS_DROPOUT,
                  **_phase_times(lambda: FB.fused_transformer_layer_train(
                      xd, lens, p, causal, HEADS, "gelu", *drop), ROW10_FWD_PHASES, calls))


def row10_fwd_kernel_times(dev):
    """Row 10's forward beyond its fp32 rows (``attn_training_kernel_times``
    at B 2,048, ``attn_kernel_times`` at B 256): bf16 x at the bench
    training shape (B 2,048, T 200, causal, p 0.5, the forward that keeps
    what the backward reads) and at serving B 256 (p 0), each beside its
    bound (bf16 products at the bf16 tensor-core peak; the FMA-priced bound
    beside it), its plain version and one PyTorch call:
    torch.nn.TransformerEncoderLayer in bf16 (module and x in bf16, dropout
    0), checked first against the plain bf16 layer within 2^-4 of its
    largest value (the module rounds its activations to bf16 after every
    operation, the plain layer only the products' operands)."""
    gen = torch.Generator().manual_seed(SEED + 8)
    p = block_params(gen, dev)
    layer = library_layer(p, dev).to(torch.bfloat16)
    rows = {}
    for b, drop, shape in ((TRAIN_B, SAS_DROPOUT, "train"), (B, 0.0, "serve")):
        x = torch.randn((b, T, D), generator=gen).to(dev, torch.bfloat16)
        lens = (torch.randint(2, T + 1, (b,), generator=gen) if drop
                else serving_lens(gen, b)).to(dev)
        args = (x, lens, p, True, HEADS, "gelu", drop, drop, 4242)
        mask = _attn_mask(lens, T, causal=True).to(torch.bfloat16)
        with torch.no_grad():
            want = FB.fused_transformer_layer_plain(x, lens, p, True, HEADS)
            lib_err = float((layer(x, src_mask=mask).float() - want.float()).abs().max())
            tol = 2.0 ** -4 * float(want.float().abs().max())
            phase("library-vs-plain", call="torch.nn.TransformerEncoderLayer bf16", B=b, T=T,
                  causal=True, max_abs_err=f"{lib_err:.3e}", tol=f"{tol:.3e}",
                  ok=lib_err <= tol)
            check(lib_err <= tol, "the bf16 TransformerEncoderLayer does not compute the "
                                  "plain bf16 layer's function")
            lib_ms = time_ms(lambda: layer(x, src_mask=mask))
            kernel = ((lambda: FB.fused_transformer_layer_train(*args)) if drop
                      else (lambda: FB.fused_transformer_layer(*args)))
            ms = time_ms(kernel)
            plain_ms = time_ms(lambda: FB.fused_transformer_layer_plain(*args), reps=5,
                               warmup=1)
        lc = lens.cpu()
        bound, flops, by = block_bound_ms(lc, T, True, p, 2, stash=bool(drop))
        fma = {"fused_transformer_layer": block_bound_ms(lc, T, True, p, 2, stash=bool(drop),
                                                         priced_fma=True)}
        phase("kernel-time", kernel="fused_transformer_layer", shape=shape, B=b, T=T,
              dtype="bfloat16", p=drop, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
              library_ms=f"{lib_ms:.4f}", bound_ms=f"{bound:.5f}", gflop=f"{flops / 1e9:.3f}",
              bound_by=by, share_of_bound=f"{bound / ms:.4f}",
              **_fma_field(fma, "fused_transformer_layer"))
        rows[shape] = (ms, plain_ms, bound, by, lib_ms)
    return rows


def b4r_training_kernel_times(dev):
    """The four new kernels of BERT4Rec's training step at its shapes, fp32:
    the selected-positions layer at B 2,048, T 200, S 40, p = 0.2 (the
    forward keeping what the backward reads) and the CE at N 81,920, V
    3,417, D 64 with a bias, each beside its bound, its plain version (a
    backward's: autograd's backward of the plain forward, its graph built
    once) and, for the CE, one PyTorch call of the same function:
    ``F.cross_entropy(x @ table.T + bias, tgt, reduction="none")`` and
    ``autograd.grad`` through it, checked first against the plain version.
    No single call computes row 12."""
    gen = torch.Generator().manual_seed(SEED + 12)
    p = block_params(gen, dev)
    b, n = TRAIN_B, TRAIN_B * MASK_LEN
    x = torch.randn((b, T, D), generator=gen).to(dev)
    lens = torch.randint(2, T + 1, (b,), generator=gen).to(dev)
    sel = b4r_sel_idx(gen, b, T, MASK_LEN).to(dev)
    d3 = torch.randn((b, MASK_LEN, D), generator=gen).to(dev)
    xc = torch.randn((n, D), generator=gen).to(dev)
    table = (0.3 * torch.randn((N_ITEMS, D), generator=gen)).to(dev)
    bias = (0.1 * torch.randn((N_ITEMS,), generator=gen)).to(dev)
    tgt = torch.randint(1, N_ITEMS, (n,), generator=gen).to(dev)
    dnll = torch.rand((n,), generator=gen).to(dev)
    drop = (B4R_DROPOUT, B4R_DROPOUT, 4242)
    _, s12 = FB.fused_transformer_layer_sel_train(x, lens, sel, p, HEADS, "gelu", *drop)
    _, lse = FCE.fused_softmax_ce_train(xc, table, tgt, bias)
    times = {
        "fused_transformer_layer_sel": time_ms(lambda: FB.fused_transformer_layer_sel_train(
            x, lens, sel, p, HEADS, "gelu", *drop)),
        "fused_transformer_layer_sel_bwd": time_ms(lambda: FB.fused_transformer_layer_sel_bwd(
            x, lens, sel, d3, p, HEADS, "gelu", *drop, saved=s12)),
        "fused_softmax_ce": time_ms(lambda: FCE.fused_softmax_ce_train(xc, table, tgt, bias)),
        "fused_softmax_ce_bwd": time_ms(lambda: FCE.fused_softmax_ce_bwd(
            xc, table, tgt, dnll, bias, lse=lse)),
    }
    del s12
    plain = {}
    cp = {"table": table, "bias": bias}
    for name, fn, pp, inp, dout in (
        ("fused_transformer_layer_sel", lambda a, q: FB.fused_transformer_layer_sel_plain(
            a, lens, sel, q, HEADS, "gelu", *drop), p, x, d3),
        ("fused_softmax_ce", lambda a, q: FCE.fused_softmax_ce_plain(
            a, q["table"], tgt, q["bias"]), cp, xc, dnll),
    ):
        with torch.no_grad():
            plain[name] = time_ms(lambda: fn(inp, pp), reps=5, warmup=1)
        xl = inp.clone().requires_grad_()
        ql = {k: v.clone().requires_grad_() for k, v in pp.items()}
        out = fn(xl, ql)
        inputs = [xl, *ql.values()]
        plain[name + "_bwd"] = time_ms(lambda: torch.autograd.grad(out, inputs, dout,
                                                                   retain_graph=True),
                                       reps=5, warmup=1)
        del out, inputs, xl, ql
    # the library yardstick, checked against the plain version first
    xl, tl, bl = (a.clone().requires_grad_() for a in (xc, table, bias))
    lib_out = F.cross_entropy(xl @ tl.T + bl, tgt, reduction="none")
    with torch.no_grad():
        want = FCE.fused_softmax_ce_plain(xc, table, tgt, bias)
    lib_err = float((lib_out.detach() - want).abs().max())
    lib_ok = lib_err <= 1e-4 * float(want.abs().max())
    phase("library-vs-plain", call="F.cross_entropy(x @ table.T + bias)", N=n, V=N_ITEMS,
          max_abs_err=f"{lib_err:.3e}", tol="1e-4*max|plain|", ok=lib_ok)
    check(lib_ok, "F.cross_entropy does not compute the plain CE's function")
    with torch.no_grad():
        lib = {"fused_softmax_ce": time_ms(lambda: F.cross_entropy(xc @ table.T + bias, tgt,
                                                                   reduction="none")),
               "fused_transformer_layer_sel": None, "fused_transformer_layer_sel_bwd": None}
    lib["fused_softmax_ce_bwd"] = time_ms(lambda: torch.autograd.grad(
        lib_out, [xl, tl, bl], dnll, retain_graph=True))
    del lib_out
    lc = lens.cpu()
    bounds = {
        "fused_transformer_layer_sel": sel_bound_ms(lc, MASK_LEN, p, 4, stash=True),
        "fused_transformer_layer_sel_bwd": sel_bwd_bound_ms(lc, MASK_LEN, p, 4),
        "fused_softmax_ce": ce_bound_ms(n, N_ITEMS, 4, train=True),
        "fused_softmax_ce_bwd": ce_bwd_bound_ms(n, N_ITEMS, 4),
    }
    fma = {"fused_transformer_layer_sel": sel_bound_ms(lc, MASK_LEN, p, 4, stash=True,
                                                        priced_fma=True),
           "fused_softmax_ce": ce_bound_ms(n, N_ITEMS, 4, train=True, priced_fma=True)}
    rows = {}
    for name, ms in times.items():
        bound, flops, by = bounds[name]
        lib_ms = lib[name]
        phase("kernel-time", kernel=name, B=b, T=T, S=MASK_LEN, N=n, V=N_ITEMS, dtype="float32",
              p=B4R_DROPOUT if "sel" in name else 0.0, ms=f"{ms:.4f}",
              plain_ms=f"{plain[name]:.4f}",
              library_ms=f"{lib_ms:.4f}" if lib_ms is not None else "none",
              bound_ms=f"{bound:.5f}", gflop=f"{flops / 1e9:.3f}", bound_by=by,
              share_of_bound=f"{bound / ms:.4f}", **_fma_field(fma, name))
        rows[name] = (ms, plain[name], bound, by, lib_ms)
    return rows


# row 13's backward at the cloze loss in bf16 and at the d256 path's D 256
ROW13_CASES = ((D, torch.bfloat16), (256, torch.float32), (256, torch.bfloat16))


def row13_kernel_times(dev):
    """Row 13's backward beyond the fp32 row of ``b4r_training_kernel_times``
    (N 81,920, V 3,417, with a bias): bf16 x with bf16 products at D 64, and
    D 256 (the d256 path) in fp32 and bf16, each beside its bound, its plain
    version (autograd's backward of the plain forward, its graph built
    once) and one PyTorch call: ``autograd.grad`` through
    ``F.cross_entropy`` of the logits, in bf16 of the bf16 product
    ``x @ table.bfloat16().T`` (cuBLAS rounds those logits to bf16), checked
    first against the plain nll (fp32: 1e-4 of its largest value; bf16: 2^-8
    of the largest logit, two bf16 roundings of a logit)."""
    gen = torch.Generator().manual_seed(SEED + 14)
    n = TRAIN_B * MASK_LEN
    rows = {}
    xc = None
    for d, dt in ROW13_CASES:
        if xc is None or xc.shape[1] != d:
            xc, table, bias, tgt, dnll = ce_inputs(gen, dev, n, d)
        mm = dt == torch.bfloat16
        x = xc.to(dt)
        dname = str(dt).split(".")[-1]
        _, lse = FCE.fused_softmax_ce_train(x, table, tgt, bias, None, mm)
        ms = time_ms(lambda: FCE.fused_softmax_ce_bwd(x, table, tgt, dnll, bias, None, mm,
                                                      lse=lse))
        xl, tl, bl = (a.clone().requires_grad_() for a in (x, table, bias))
        out = FCE.fused_softmax_ce_plain(xl, tl, tgt, bl, None, mm)
        plain_ms = time_ms(lambda: torch.autograd.grad(out, [xl, tl, bl], dnll,
                                                       retain_graph=True), reps=5, warmup=1)
        want = out.detach()
        del out
        logits = xl @ (tl.bfloat16() if mm else tl).T + bl
        lib_out = F.cross_entropy(logits, tgt, reduction="none")
        lib_err = float((lib_out.detach() - want).abs().max())
        tol = (2.0 ** -8 * float(logits.detach().abs().max()) if mm
               else 1e-4 * float(want.abs().max()))
        del logits
        phase("library-vs-plain", call="F.cross_entropy(x @ table.T + bias)", N=n, V=N_ITEMS,
              D=d, dtype=dname, max_abs_err=f"{lib_err:.3e}", tol=f"{tol:.3e}",
              ok=lib_err <= tol)
        check(lib_err <= tol, f"F.cross_entropy at D {d} {dname} does not compute the plain "
                              "CE's function")
        lib_ms = time_ms(lambda: torch.autograd.grad(lib_out, [xl, tl, bl], dnll,
                                                     retain_graph=True))
        del lib_out, xl, tl, bl
        bound, flops, by = ce_bwd_bound_ms(n, N_ITEMS, x.element_size(), mm_bf16=mm, d=d)
        phase("kernel-time", kernel="fused_softmax_ce_bwd", shape="b4r" if d == D else "d256",
              B=TRAIN_B, N=n, V=N_ITEMS, D=d, dtype=dname, mm_bf16=mm, ms=f"{ms:.4f}",
              plain_ms=f"{plain_ms:.4f}", library_ms=f"{lib_ms:.4f}", bound_ms=f"{bound:.5f}",
              gflop=f"{flops / 1e9:.3f}", bound_by=by, share_of_bound=f"{bound / ms:.4f}")
        rows[d, dname] = (ms, plain_ms, bound, by, lib_ms)
    return rows


# row 13's backward on the tensor cores by pass: (a) logits, g and dx, (b)
# logits, g, the dtable and dbias partials, their ordered sum
ROW13_BWD_PHASES = (("a", "ce_dx_mma_kernel"), ("b", "ce_dtab_mma_kernel"),
                    ("reduce", "ce_reduce_kernel"))


def row13_bwd_phase_times(dev, calls=10):
    """Row 13's backward at the cloze loss (N 81,920, V 3,417, with a
    bias) at D 64 and 256, fp32 and bf16 (bf16 x and products): its
    CUDA-event time beside each pass's device time per call, from
    torch.profiler over ``calls`` calls, and the row splits of pass (b)."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator().manual_seed(SEED + 15)
    n = TRAIN_B * MASK_LEN
    for d in (D, 256):
        xc, table, bias, tgt, dnll = ce_inputs(gen, dev, n, d)
        for dt in (torch.float32, torch.bfloat16):
            mm = dt == torch.bfloat16
            x = xc.to(dt)
            check(FCE.bwd_uses_mma(d, mm), f"row 13's backward at D {d} is not the mma path")
            _, lse = FCE.fused_softmax_ce_train(x, table, tgt, bias, None, mm)

            def call():
                return FCE.fused_softmax_ce_bwd(x, table, tgt, dnll, bias, None, mm, lse=lse)

            ms = time_ms(call)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    call()
                torch.cuda.synchronize()
            dev_us = {e.key: e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA}
            parts = {}
            for label, kernel in ROW13_BWD_PHASES:
                us = sum(v for k, v in dev_us.items() if kernel in k)
                parts[label] = f"{us / calls / 1e3:.4f}" if us else "not measured"
            splits = FCE._cuda.library("fused_ce.cu").recblr_ce_bwd_splits(
                n, N_ITEMS, d, int(mm), dev.index)
            phase("kernel-time-phase", kernel="fused_softmax_ce_bwd",
                  shape="b4r" if d == D else "d256", N=n, V=N_ITEMS, D=d,
                  dtype=str(dt).split(".")[-1], mm_bf16=mm, ms=f"{ms:.4f}",
                  **{f"{k}_ms": v for k, v in parts.items()},
                  device_ms=f"{sum(dev_us.values()) / calls / 1e3:.4f}", row_splits=splits)


def ce_fwd_kernel_times(dev, calls=10):
    """The CE forwards beyond the fp32 row of ``b4r_training_kernel_times``
    and the bf16 row of ``xlong_kernel_times``: row 13 at the cloze loss (N
    81,920, V 3,417, with a bias) in bf16 (bf16 x and products) at D 64, and
    at the d256 path's D 256 in fp32 and bf16; row 14 at the longodd step's
    loss in fp32 (N 512, V 329,728, 329,722 valid, D 64, no bias).  Each
    beside its bound (tensor-core priced, the FMA-priced one beside), its
    plain version and one PyTorch call, ``F.cross_entropy`` of the logits
    (row 13 in bf16 of the bf16 product, cuBLAS rounding those logits to
    bf16; row 14 with the columns beyond valid_v at -1e30), checked first
    against the plain nll as ``row13_kernel_times`` checks it.  Then row
    14's forward by kernel at XLong (bf16) and longodd (fp32): the split
    partials and ``cce_lse_kernel``, from torch.profiler over ``calls``
    calls.  Uses only the wrappers' public calls, so it times a parent's
    kernels too (``chip_compare.py``)."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator().manual_seed(SEED + 16)
    n = TRAIN_B * MASK_LEN

    def emit(name, ms, plain_ms, lib_ms, bnd, fma, **shape):
        bound, flops, by = bnd
        phase("kernel-time", kernel=name, **shape, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
              library_ms=f"{lib_ms:.4f}", bound_ms=f"{bound:.5f}", gflop=f"{flops / 1e9:.3f}",
              bound_by=by, share_of_bound=f"{bound / ms:.4f}", fma_bound_ms=f"{fma[0]:.5f}")

    def library(logits_fn, tgt, want, tol, **shape):
        with torch.no_grad():
            lib_out = F.cross_entropy(logits_fn(), tgt, reduction="none")
            lib_err = float((lib_out - want).abs().max())
            phase("library-vs-plain", call="F.cross_entropy(logits)", **shape,
                  max_abs_err=f"{lib_err:.3e}", tol=f"{tol:.3e}", ok=lib_err <= tol)
            check(lib_err <= tol, f"F.cross_entropy {shape} does not compute the plain CE")
            return time_ms(lambda: F.cross_entropy(logits_fn(), tgt, reduction="none"))

    xc = None
    for d, dt in ROW13_CASES:
        if xc is None or xc.shape[1] != d:
            xc, table, bias, tgt, _ = ce_inputs(gen, dev, n, d)
        mm = dt == torch.bfloat16
        x = xc.to(dt)
        dname = str(dt).split(".")[-1]
        ms = time_ms(lambda: FCE.fused_softmax_ce_train(x, table, tgt, bias, None, mm))
        with torch.no_grad():
            plain_ms = time_ms(lambda: FCE.fused_softmax_ce_plain(x, table, tgt, bias, None, mm),
                               reps=5, warmup=1)
            want = FCE.fused_softmax_ce_plain(x, table, tgt, bias, None, mm)
            lib_tab = table.bfloat16() if mm else table
            top = float((x @ lib_tab.T + bias).abs().max())
        tol = 2.0 ** -8 * top if mm else 1e-4 * float(want.abs().max())
        shape = dict(shape="b4r" if d == D else "d256", B=TRAIN_B, N=n, V=N_ITEMS, D=d,
                     dtype=dname)
        lib_ms = library(lambda: x @ lib_tab.T + bias, tgt, want, tol, **shape)
        emit("fused_softmax_ce", ms, plain_ms, lib_ms,
             ce_bound_ms(n, N_ITEMS, x.element_size(), train=True, mm_bf16=mm, d=d),
             ce_bound_ms(n, N_ITEMS, x.element_size(), train=True, mm_bf16=mm, d=d,
                         priced_fma=True), **shape, mm_bf16=mm)
        del want
    del xc, table, bias, tgt

    xc, table, tgt, _ = _xlong_ce_inputs(gen, dev)
    vp = table.shape[0]
    mask = torch.where(torch.arange(vp, device=dev) < XV, 0.0, FCE.NEG)
    shape = dict(shape="longodd", B=XB, T=LT, N=XB, V=vp, dtype="float32")
    ms = time_ms(lambda: FCE.fused_softmax_ce_chunked_train(xc, table, tgt, None, XV, False))
    with torch.no_grad():
        plain_ms = time_ms(lambda: FCE.fused_softmax_ce_chunked_fwd_plain(
            xc, table, tgt, None, XV, False), reps=5, warmup=1)
        want = FCE.fused_softmax_ce_chunked_fwd_plain(xc, table, tgt, None, XV, False)[0]
    lib_ms = library(lambda: xc @ table.T + mask, tgt, want, 1e-4 * float(want.abs().max()),
                     **shape)
    emit("fused_softmax_ce_chunked", ms, plain_ms, lib_ms,
         ce_bound_ms(XB, vp, 4, train=True), ce_bound_ms(XB, vp, 4, train=True, priced_fma=True),
         **shape, mm_bf16=False)

    for label, x, mm in (("xlong", xc.to(torch.bfloat16), True), ("longodd", xc, False)):
        def call():
            return FCE.fused_softmax_ce_chunked_train(x, table, tgt, None, XV, mm)

        ms = time_ms(call)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
        dev_us = {e.key: e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA}
        parts = {}
        for part, kernel in (("partials", "cce_fwd"), ("lse", "cce_lse_kernel")):
            us = sum(v for k, v in dev_us.items() if kernel in k)
            parts[part] = f"{us / calls / 1e3:.4f}" if us else "not measured"
        phase("kernel-time-phase", kernel="fused_softmax_ce_chunked", shape=label, N=XB, V=vp,
              D=D, dtype=str(x.dtype).split(".")[-1], mm_bf16=mm, ms=f"{ms:.4f}",
              **{f"{k}_ms": v for k, v in parts.items()},
              device_ms=f"{sum(dev_us.values()) / calls / 1e3:.4f}",
              kernels=repr(sorted(k[:40] for k in dev_us)))


def served_kernel_times(dev):
    """The forwards that a ``recommend()`` of B 256 users launches outside
    the whole-layer kernels, at p 0: row 5 (onelayer: T 200, D 64, fp32),
    row 7 (wide: T 200, C 256), row 8 (longodd: T 1,020, C 128, in the
    path's serving bf16) and row 9 (XLong: T 1,024, bf16, with the
    prologue), each beside its bound, its plain version (rows 8 and 9 walk
    T in Python: two calls each, no warm-up) and, for row 5,
    ``F.layer_norm``, checked first against the plain version."""
    gen = torch.Generator().manual_seed(SEED + 35)

    def emit(name, ms, plain_ms, bnd, lib=None, fma=None, **shape):
        bound, flops, by = bnd
        phase("kernel-time", kernel=name, **shape, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
              library_ms=f"{lib:.4f}" if lib is not None else "none", bound_ms=f"{bound:.5f}",
              gflop=f"{flops / 1e9:.3f}", bound_by=by, share_of_bound=f"{bound / ms:.4f}",
              **({"fma_bound_ms": f"{fma[0]:.5f}"} if fma else {}))

    with torch.no_grad():
        x = (2 * torch.randn((B, T, D), generator=gen)).to(dev)
        sc = (1 + 0.1 * torch.randn(D, generator=gen)).to(dev)
        bias = (0.1 * torch.randn(D, generator=gen)).to(dev)
        ms = time_ms(lambda: FL.fused_dropout_ln(x, sc, bias, 0.0, 0))
        plain = time_ms(lambda: FL.fused_dropout_ln_plain(x, sc, bias, 0.0, 0), reps=5, warmup=1)
        want = FL.fused_dropout_ln_plain(x, sc, bias, 0.0, 0)
        lib_err = float((F.layer_norm(x, (D,), sc, bias, L.LN_EPS) - want).abs().max())
        lib_ok = lib_err <= 1e-4 * float(want.abs().max())
        phase("library-vs-plain", call="F.layer_norm(x)", B=B, T=T, max_abs_err=f"{lib_err:.3e}",
              tol="1e-4*max|plain|", ok=lib_ok)
        check(lib_ok, "F.layer_norm does not compute row 5's function at p 0")
        lib = time_ms(lambda: F.layer_norm(x, (D,), sc, bias, L.LN_EPS))
        emit("fused_dropout_ln", ms, plain, dropout_ln_bound_ms(B, T, 4), lib, shape="onelayer",
             B=B, T=T, D=D, dtype="float32", p=0.0)
        del x, want

        g = (0.3 + 0.699 * torch.rand((B, T, WIDE_C), generator=gen)).to(dev)
        xs = torch.randn((B, T, WIDE_C), generator=gen).to(dev)
        ms = time_ms(lambda: SC.linear_scan(g, xs))
        plain = time_ms(lambda: SC.linear_scan_serial(g, xs), reps=5, warmup=1)
        emit("linear_scan", ms, plain, scan_bound_ms(B, T, WIDE_C), shape="wide", B=B, T=T,
             C=WIDE_C, dtype="float32")
        del g, xs

        p = bdlru_params(gen, dev)
        xb = torch.randn((B, LT, C), generator=gen).to(dev, torch.bfloat16)
        ms = time_ms(lambda: FBD.fused_bdlru(xb, *p.values()), reps=10)
        plain = time_ms(lambda: FBD.fused_bdlru_plain(xb, *p.values()), reps=2, warmup=0)
        emit("fused_bdlru", ms, plain, bdlru_bound_ms(B, LT, C, p, 2),
             fma=bdlru_bound_ms(B, LT, C, p, 2, priced_fma=True), shape="longodd", B=B, T=LT,
             C=C, K=K, dtype="bfloat16")
        del xb

        p1 = layer_params(gen, dev, prologue=True)
        xx = torch.randn((B, XT, D), generator=gen).to(dev, torch.bfloat16)
        args = (True, True, True, 0.0, 0)
        ms = time_ms(lambda: FLC.fused_recurrent_layer_chunked(xx, p1, *args), reps=10)
        plain = time_ms(lambda: FLC.fused_recurrent_layer_chunked_plain(xx, p1, *args), reps=2,
                        warmup=0)
        emit("fused_recurrent_layer_chunked", ms, plain, chunked_bound_ms(B, XT, p1, 2),
             fma=chunked_bound_ms(B, XT, p1, 2, priced_fma=True), shape="xlong", B=B, T=XT,
             dtype="bfloat16", p=0.0)


# ---------------------------------------------------------------------------
# the XLong configuration: the chunked layer, the vocab-chunked CE and the
# table gradient
# ---------------------------------------------------------------------------

def _xlong_ce_inputs(gen, dev, n=XB):
    """Row 14's inputs at the XLong loss: x [512, 64], the 329,728-row
    padded table (329,722 valid), no bias (RecBLR's loss), targets."""
    vp = -(-XV // 2048) * 2048
    x = torch.randn((n, D), generator=gen).to(dev)
    table = (0.05 * torch.randn((vp, D), generator=gen)).to(dev)
    tgt = torch.randint(1, XV, (n,), generator=gen).to(dev)
    dnll = torch.rand((n,), generator=gen).to(dev)
    return x, table, tgt, dnll


def _xlong_emb_inputs(gen, dev):
    """Row 16's inputs at the XLong step: 512 x 1,024 ids with the lengths
    of ``synthetic_splits`` (uniform in 2 .. 1,000, PAD after them) and
    bf16 cotangents."""
    vp = -(-XV // 2048) * 2048
    lens = torch.randint(2, XMAX_LEN + 1, (XB, 1), generator=gen)
    ids = torch.randint(1, XV, (XB, XT), generator=gen)
    ids = torch.where(torch.arange(XT)[None] < lens, ids, 0).to(dev)
    g = torch.randn((XB, XT, D), generator=gen).to(dev, torch.bfloat16)
    return ids, g, vp


def _bench_emb_inputs(gen, dev):
    """Row 16's inputs at the bench step: the int32 ids of the 2,048 rows
    ``train_step_phase`` batches first from ``synthetic_splits`` at T 200
    (lengths uniform in 2 .. 200, PAD after them), the catalog padded as
    the model pads it, and bf16 cotangents."""
    from datamining_recblr_torch.data.synthetic import synthetic_splits

    train, _ = synthetic_splits(6040, N_ITEMS, T, 8192, seed=SEED)
    perm = np.random.default_rng((SEED, 0)).permutation(len(train))
    ids = torch.from_numpy(np.ascontiguousarray(train.item_seq[perm[:TRAIN_B]])).to(dev)
    model = get_model("RecBLR")(_train_config("RecBLR", "bfloat16"), N_ITEMS, T,
                                generator=torch.Generator().manual_seed(SEED))
    g = torch.randn((TRAIN_B, T, D), generator=gen).to(dev, torch.bfloat16)
    return ids, g, model.n_items_padded


def emb_grad_check(name, ids, g, vp):
    """Row 16 against the exact sum (fp64 ``index_add_``) within 1e-6 of
    its largest value, against its plain version (fp32 atomics) within
    1e-4 of it, and against itself: the same bits on a rerun.  Returns
    the largest distance from the plain version."""
    got = E.embedding_grad(ids, g, vp)
    again = E.embedding_grad(ids, g, vp)
    want = E.embedding_grad_plain(ids, g, vp)
    exact = torch.zeros((vp, D), device=g.device, dtype=torch.float64).index_add_(
        0, ids.reshape(-1), g.reshape(-1, D).double())
    torch.cuda.synchronize()
    scale = float(exact.abs().max())
    err = float((got - want).abs().max())
    err_exact = float((got.double() - exact).abs().max())
    plain_exact = float((want.double() - exact).abs().max())
    same = torch.equal(got, again)
    ok = err_exact <= 1e-6 * scale and err <= 1e-4 * scale and same
    phase(name, kernel="embedding_grad", shape=f"N{ids.numel()}xV{vp}xD{D}",
          ids_dtype=str(ids.dtype).split(".")[-1], g_dtype="bfloat16",
          pad_share=f"{float((ids == 0).float().mean()):.3f}",
          max_abs_err=f"{err:.3e}", max_abs_err_vs_fp64=f"{err_exact:.3e}",
          plain_max_abs_err_vs_fp64=f"{plain_exact:.3e}", max_abs_fp64=f"{scale:.3f}",
          tol="1e-6*max|fp64| against the fp64 sum, 1e-4*max against the plain (fp32 atomic) one",
          same_bits_on_rerun=same, ok=ok)
    check(ok, "embedding_grad disagrees with the exact sum, its plain version or itself")
    return err


def xlong_kernels_vs_plain(dev):
    """The new kernels against their plain versions at the XLong shapes:
    row 9 (forward: output and record; backward: dx and every grad against
    autograd of the plain version) at the step's B 512, T 1,024, full width
    with the prologue, p = 0 and 0.2, fp32 and bf16, and K1 and its
    backward on the recompute branch against the same plain version; K2
    and its backward on the recompute branch at the same shape; row 14 at
    N 512, V 329,728 (valid 329,722), fp32 products and bf16 x with bf16
    products; row 16 at N 524,288, V 329,728, bf16 cotangents, the same
    bits on a rerun; both CE paths with a bf16 table and bias.  Returns the
    largest fp32 |kernel - plain| of each new kernel."""
    gen = torch.Generator().manual_seed(SEED + 20)
    p1 = layer_params(gen, dev, prologue=True)
    p2 = layer_params(gen, dev, prologue=False)
    x = torch.randn((XB, XT, D), generator=gen).to(dev)
    d1 = torch.randn((XB, XT, D), generator=gen).to(dev)
    d2 = torch.randn((XB, D), generator=gen).to(dev)
    lens = torch.randint(1, XT + 1, (XB,), generator=gen)
    lens[:3] = torch.tensor([0, 1, XT])
    lens = lens.to(dev)
    errs = {}
    shape = f"B{XB}xT{XT}xD{D}"
    for dt in (torch.float32, torch.bfloat16):
        for pd in (0.0, DROPOUT):
            xd, dout1, dout2 = x.to(dt), d1.to(dt), d2.to(dt)
            seed = 13579 + int(pd * 10)
            args = (True, True, True, pd, seed)
            out, rec = FLC.fused_recurrent_layer_chunked_train(xd, p1, *args)
            dx, grads = FLC.fused_recurrent_layer_chunked_bwd(xd, dout1, rec, p1, *args)
            k1, k1_saved = FL.fused_recurrent_layer_train(xd, p1, *args)
            k1dx, k1g = FL.fused_recurrent_layer_bwd(xd, dout1, p1, *args, saved=None)
            k2, k2_saved = FL.fused_recurrent_layer_last_train(xd, lens, p2, True, True, pd,
                                                               seed)
            k2dx, k2g = FL.fused_recurrent_layer_last_bwd(xd, lens, dout2, p2, True, True, pd,
                                                          seed, saved=None)
            check(k1_saved is None and k2_saved is None,
                  "the stash policy kept K1's or K2's scratch at T 1,024")
            _, wrec = FLC.fused_recurrent_layer_chunked_plain(xd, p1, *args)
            want1 = _plain_vjp(lambda a, q: FLC.fused_recurrent_layer_chunked_plain(
                a, q, *args)[0], xd, p1, dout1)
            want2 = _plain_vjp(lambda a, q: FL.fused_recurrent_layer_last_plain(
                a, lens, q, True, True, pd, seed), xd, p2, dout2)
            torch.cuda.synchronize()
            tag = dict(dtype=str(dt).split(".")[-1], p=pd)
            rec_err = float((rec - wrec).abs().max())
            rec_ok = rec_err <= 1e-4 * float(wrec.abs().max())
            for name, o, g_dx, g, (wout, wdx, wgrads) in (
                ("fused_recurrent_layer_chunked", out, dx, grads, want1),
                ("fused_recurrent_layer", k1, k1dx, k1g, want1),
                ("fused_recurrent_layer_last", k2, k2dx, k2g, want2),
            ):
                ok_out = (torch.allclose(o, wout, **FP32_TOL) if dt == torch.float32
                          else _bf16_ok(o, wout))
                check(bool(torch.isfinite(g_dx).all()), f"{name} bwd {tag}: non-finite dx")
                rows = {"dx": _grad_err_ok(g_dx, wdx, dt, True)}
                rows.update({k: _grad_err_ok(v, wgrads[k], dt, False) for k, v in g.items()})
                ok = ok_out and all(o_ for _, o_ in rows.values())
                extra = {}
                if name == "fused_recurrent_layer_chunked":
                    ok = ok and rec_ok
                    extra = dict(record_max_abs_err=f"{rec_err:.3e}",
                                 record_tol="1e-4*max|plain|")
                phase("xlong-kernel-vs-plain", kernel=name + "_bwd", **tag, shape=shape,
                      branch="record" if name.endswith("chunked") else "recompute",
                      out_max_abs_err=f"{(o.float() - wout.float()).abs().max().item():.3e}",
                      rel_err=repr({k: float(f"{e:.3e}") for k, (e, _) in rows.items()}),
                      tol=f"max|err|/max|plain| <= {GRAD_RTOL}"
                          + (" (bf16 dx: + 2^-7*|plain|)" if dt == torch.bfloat16 else ""),
                      **extra, ok=ok)
                check(ok, f"{name} bwd {tag}: kernel disagrees with its plain version at T {XT}")
                if dt == torch.float32 and name == "fused_recurrent_layer_chunked":
                    errs[name] = max(errs.get(name, 0.0), float((o - wout).abs().max()),
                                     rec_err)
                    errs[name + "_bwd"] = max(
                        [errs.get(name + "_bwd", 0.0), float((g_dx - wdx).abs().max())]
                        + [float((v - wgrads[k]).abs().max()) for k, v in g.items()])
            del want1, want2, wrec, out, rec, dx, grads, k1, k1dx, k1g, k2, k2dx, k2g

    # row 14 at the XLong loss
    xc, table, tgt, dnll = _xlong_ce_inputs(gen, dev)
    for dt, mm in ((torch.float32, False), (torch.float32, True), (torch.bfloat16, True)):
        dname = str(dt).split(".")[-1]
        xd = xc.to(dt)
        fwd = FCE.fused_softmax_ce_chunked_train
        before = fwd.mma_launches
        nll, lse = fwd(xd, table, tgt, None, XV, mm)
        fwd_mma = fwd.mma_launches - before
        fwd_same = all(torch.equal(a, b) for a, b in zip(fwd(xd, table, tgt, None, XV, mm),
                                                        (nll, lse)))
        dx, dtab, dbias = FCE.fused_softmax_ce_chunked_bwd(xd, table, tgt, dnll, None, XV, mm,
                                                           lse=lse)
        bias = torch.zeros((table.shape[0],), device=dev)
        xl, tl, bl = (a.detach().clone().requires_grad_() for a in (xd, table, bias))
        want = FCE.fused_softmax_ce_chunked_plain(xl, tl, tgt, bl, XV, mm)
        gx, gt, gb = torch.autograd.grad(want, [xl, tl, bl], dnll)
        torch.cuda.synchronize()
        nll_err = float((nll - want.detach()).abs().max())
        ok_nll = bool(((nll - want.detach()).abs() <= 1e-4 + 1e-5 * want.detach().abs()).all())
        rows = {"dx": _grad_err_ok(dx, gx, dt, True), "dtable": _grad_err_ok(dtab, gt, dt, False),
                "dbias": _grad_err_ok(dbias, gb, dt, False)}
        ok = (ok_nll and fwd_same and all(o for _, o in rows.values())
              and fwd_mma == int(FCE.chunked_fwd_uses_mma(D, mm)))
        phase("xlong-kernel-vs-plain", kernel="fused_softmax_ce_chunked_bwd", dtype=dname,
              mm_bf16=mm, path="tensor cores" if FCE.chunked_bwd_uses_mma(D, mm) else "fp32 FMA",
              fwd_mma_launches=fwd_mma, fwd_rerun_bit_equal=fwd_same,
              shape=f"N{XB}xV{table.shape[0]}xD{D}", valid_v=XV,
              nll_max_abs_err=f"{nll_err:.3e}", nll_tol="1e-4 + 1e-5*|plain|",
              rel_err=repr({k: float(f"{e:.3e}") for k, (e, _) in rows.items()}),
              tol=f"max|err|/max|plain| <= {GRAD_RTOL}"
                  + (" (bf16 dx: + 2^-7*|plain|)" if mm else ""), ok=ok)
        check(ok, f"fused_softmax_ce_chunked {dname}: kernel disagrees with its plain version, "
                  "or its forward takes another path than its gate or changes on a rerun")
        if dt == torch.float32 and not mm:
            errs["fused_softmax_ce_chunked"] = nll_err
        errs["fused_softmax_ce_chunked_bwd"] = max(
            [errs.get("fused_softmax_ce_chunked_bwd", 0.0)]
            + [float((a.float() - w.float()).abs().max())
               for a, w in ((dx, gx), (dtab, gt), (dbias, gb))])
        del want, gx, gt, gb, xl, tl, bl, dx, dtab, dbias

    # C2: a bf16 table and bias through both CE paths (autograd)
    for name, tab in (("whole-table", table[:N_ITEMS]), ("chunked", table)):
        tab16 = tab.to(torch.bfloat16)
        b16 = (0.1 * torch.randn((tab.shape[0],), generator=gen)).to(dev, torch.bfloat16)
        res = []
        for fn in (FCE.fused_softmax_ce, FCE.fused_softmax_ce_chunked_plain
                   if name == "chunked" else FCE.fused_softmax_ce_plain):
            tl, bl = tab16.clone().requires_grad_(), b16.clone().requires_grad_()
            out = fn(xc, tl, tgt % tab.shape[0], bl)
            out.backward(dnll)
            res.append((out.detach(), tl.grad, bl.grad))
        (nll, gt, gb), (wnll, wgt, wgb) = res
        torch.cuda.synchronize()
        ok = (gt.dtype == gb.dtype == torch.bfloat16
              and bool(((nll - wnll).abs() <= 1e-4 + 1e-5 * wnll.abs()).all())
              and all(bool(((g.float() - w.float()).abs()
                            <= BF16_RTOL * w.float().abs()
                            + GRAD_RTOL * float(w.float().abs().max())).all())
                      for g, w in ((gt, wgt), (gb, wgb))))
        phase("xlong-kernel-vs-plain", kernel="fused_softmax_ce (bf16 table and bias)",
              path=name, shape=f"N{XB}xV{tab.shape[0]}xD{D}", grad_dtype=str(gt.dtype),
              nll_max_abs_err=f"{float((nll - wnll).abs().max()):.3e}",
              tol="nll 1e-4 + 1e-5*|plain|; grads 2^-7*|plain| + 1e-4*max|plain|", ok=ok)
        check(ok, f"fused_softmax_ce {name}: a bf16 table or bias disagrees with the plain CE")

    # row 16 at the XLong step
    errs["embedding_grad"] = emb_grad_check("xlong-kernel-vs-plain", *_xlong_emb_inputs(gen, dev))
    return errs


def xlong_mask_bits(dev):
    """Row 9's prologue mask bit for bit against the plain Philox mask over
    T = 1,024 (eight chunks), and at each chunk's first and last position
    against ``philox.dropout_mask_at``: with W_in = 0 and the FFN off, the
    backward's dx is LN_pl'(dv1) * m0, 0 exactly where m0 drops.  The masks
    m1-m3 enter every value that xlong-kernel-vs-plain compares at p = 0.2."""
    gen = torch.Generator().manual_seed(SEED + 21)
    p1 = layer_params(gen, dev, prologue=True)
    p1 = {k: v for k, v in p1.items() if k not in ("w1", "b1", "w2", "b2", "ln2_s", "ln2_b")}
    p1["w_in"] = torch.zeros_like(p1["w_in"])
    x = torch.randn((XB, XT, D), generator=gen).to(dev)
    dout = torch.randn((XB, XT, D), generator=gen).to(dev)
    seed = 24680
    _, rec = FLC.fused_recurrent_layer_chunked_train(x, p1, True, False, True, DROPOUT, seed)
    dx, _ = FLC.fused_recurrent_layer_chunked_bwd(x, dout, rec, p1, True, False, True, DROPOUT,
                                                  seed)
    want = philox.dropout_mask(seed, philox.M0, XB, XT, D, DROPOUT, dev) > 0
    got = dx != 0
    tc = FLC.pick_chunk(XT)
    edges = torch.tensor([e for s in range(tc, XT, tc) for e in (s - 1, s)], device=dev)
    pos = edges[None].expand(XB, -1)
    want_at = philox.dropout_mask_at(seed, philox.M0, pos, D, DROPOUT) > 0
    got_at = got[torch.arange(XB, device=dev)[:, None], pos]
    flips = int((got != want).sum())
    flips_at = int((got_at != want_at).sum())
    phase("xlong-mask-bits", mask="m0 (row 9 prologue)", elements=want.numel(), chunk=tc,
          keep_fraction=f"{float(want.float().mean()):.5f}", mismatches=flips,
          chunk_edge_positions=edges.numel(), edge_mismatches=flips_at)
    check(flips == 0 and flips_at == 0,
          f"row 9 m0: {flips} mask bits ({flips_at} at chunk edges) differ from the plain mask")


def xlong_train_phase(dev, dtype_name, steps=XTRAIN_STEPS):
    """RecBLR at the XLong configuration (batch 512, T 1,024, V 329,722,
    dropout 0.2, CE, Adam), all at batch 512: launches of each of the
    step's kernels in one step, the step against the plain step (whose CE
    materializes the [512, V] logits, 675 MB), the plain step's time and
    peak memory, and the kernel step's."""
    from datamining_recblr_torch.data.synthetic import synthetic_splits
    from datamining_recblr_torch.train.trainer import Trainer

    prefix = "xlong-train"
    counted = XLONG_COUNTED + ((E.embedding_grad,) if dtype_name == "bfloat16" else ())
    cfg = Config(model="RecBLR", config_dict={
        "MAX_ITEM_LIST_LENGTH": XT, "compute_dtype": dtype_name, "train_batch_size": XB,
        "seed": SEED, "dropout_prob": DROPOUT, "hidden_size": D, "num_layers": 2, "expand": 2,
        "d_conv": K})
    model = get_model("RecBLR")(cfg, XV, XT, generator=torch.Generator().manual_seed(SEED))
    check(_at_full_width(model) and model.use_chunked_layer() and model.use_last_layer_kernel(),
          "RecBLR at XLong: not the chunked composition at full width")
    check(model._use_fused_ce(model.n_items_padded, D, XB)
          and not FCE.supports(model.n_items_padded, D),
          "RecBLR at XLong: the loss does not take the vocab-chunked CE kernel")
    trainer = Trainer(cfg, model)
    train, _ = synthetic_splits(5000, XV, XT, 4096, seed=SEED)
    # the xlong-synth histories are at most 1,000 long (the preset's max_len)
    train.item_seq_len[:] = np.minimum(train.item_seq_len, XMAX_LEN)
    train.item_seq[:, XMAX_LEN:] = 0
    data = trainer.device_split(train)
    perm = np.random.default_rng((SEED, 1)).permutation(len(train))
    weight = torch.ones(XB, device=dev)

    def batch_of(s):
        idx = perm[(s * XB) % len(train):][:XB]
        return trainer.gather_batch(data, torch.from_numpy(idx).to(dev), weight)

    # launches: one step of the main path at batch 512
    model.train()
    model.zero_grad(set_to_none=True)
    for fn in counted:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    model.calculate_loss(batch_of(0), step=7).backward()
    torch.cuda.synchronize()
    launches = tuple(fn.launches for fn in counted)
    fwd_bwd_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    model.zero_grad(set_to_none=True)
    phase(f"{prefix}-launches", dtype=dtype_name, batch=XB, T=XT, steps=1,
          **{fn.__name__: n for fn, n in zip(counted, launches)})
    check(launches == (1,) * len(counted),
          f"RecBLR at XLong: expected one launch of each kernel, got {launches}")

    # the step against the plain step
    batch = batch_of(1)
    tol = GRAD_RTOL if dtype_name == "float32" else BF16_RTOL
    _, loss, want_loss, loss_err, errs = step_vs_plain(model, batch, counted,
                                                       TRAINED["RecBLR"][3], 0.0, tol)
    worst = max(errs, key=errs.get)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    TRAINED["RecBLR"][3](model, batch, 7).backward()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    plain_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    model.zero_grad(set_to_none=True)
    phase(f"{prefix}-step-vs-plain", dtype=dtype_name, batch=XB, T=XT, V=XV, p=DROPOUT,
          loss=f"{loss:.6f}", plain_loss=f"{want_loss:.6f}", loss_rel_err=f"{loss_err:.3e}",
          loss_tol="1e-4", grad_rel_err_max=f"{errs[worst]:.3e}", worst_param=worst,
          grad_tol=f"max|err|/max|plain| <= {tol}", params=len(errs),
          plain_fwd_bwd_ms=f"{plain_ms:.1f}", plain_peak_device_gb=f"{plain_peak:.3f}")
    check(np.isfinite(loss), "RecBLR at XLong: train loss is not finite")
    check(loss_err <= 1e-4, "RecBLR at XLong: train loss disagrees with the plain step")
    check(all(e <= tol for e in errs.values()),
          "RecBLR at XLong: gradients disagree with the plain step")

    med, lo, hi, peak = time_steps(trainer, batch_of, steps)
    phase(f"{prefix}-time", dtype=dtype_name, batch=XB, T=XT, V=XV, steps=steps,
          median_ms_per_step=f"{med:.3f}", examples_per_s=f"{XB / med * 1e3:.1f}",
          positions_per_s=f"{XB * XT / med * 1e3:.4g}", min_ms=f"{lo:.3f}", max_ms=f"{hi:.3f}",
          peak_device_gb=f"{peak:.3f}", fwd_bwd_peak_device_gb=f"{fwd_bwd_peak:.3f}")
    train_profile(trainer, batch_of, dtype_name, prefix, steps=3)
    return {"launches": dict(zip((fn.__name__ for fn in counted), launches)), "ms": med,
            "peak_gb": peak}


# row 14's backward on the tensor cores by pass: (a) logits, g and dx
# partials, the ordered sum of the partials, (b) logits, g, dtable and dbias
ROW14_BWD_PHASES = (("a", "cce_dx_mma_kernel"), ("reduce", "cce_dx_reduce_kernel"),
                    ("b", "cce_dtab_mma_kernel"))


def row14_bwd_phase_times(dev, calls=10):
    """Row 14's backward at the XLong loss (N 512, V 329,728, D 64, bf16 x,
    bf16 products, the tensor-core path): its CUDA-event time beside each
    pass's device time per call, from torch.profiler over ``calls``
    calls."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator().manual_seed(SEED + 22)
    x, table, tgt, dnll = _xlong_ce_inputs(gen, dev)
    x = x.to(torch.bfloat16)
    check(FCE.chunked_bwd_uses_mma(D, True), "row 14's XLong backward is not the mma path")
    _, lse = FCE.fused_softmax_ce_chunked_train(x, table, tgt, None, XV, True)

    def call():
        return FCE.fused_softmax_ce_chunked_bwd(x, table, tgt, dnll, None, XV, True, lse=lse)

    ms = time_ms(call)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    dev_us = {e.key: e.self_device_time_total for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA}
    parts = {}
    for label, kernel in ROW14_BWD_PHASES:
        us = sum(v for k, v in dev_us.items() if kernel in k)
        parts[label] = f"{us / calls / 1e3:.4f}" if us else "not measured"
    phase("kernel-time-phase", kernel="fused_softmax_ce_chunked_bwd", shape="xlong", N=XB,
          V=table.shape[0], D=D, dtype="bfloat16", mm_bf16=True, ms=f"{ms:.4f}",
          **{f"{k}_ms": v for k, v in parts.items()},
          device_ms=f"{sum(dev_us.values()) / calls / 1e3:.4f}")


# rows 2, 4 and 9's backwards by phase: the kernels their entry points
# launch (names as substrings, the parent's FMA kernels included)
RECBLR_BWD_PHASES = {
    "fused_recurrent_layer_bwd": (
        ("A'", "tail_bwd"), ("B'", "linear_scan"), ("C1'", "gate_bwd"), ("C2'", "inproj_bwd"),
        ("reduce", "reduce_partials")),
    "fused_recurrent_layer_last_bwd": (
        ("A'", "tail_bwd"), ("B'", "rev_scan_last"), ("C1'", "gate_bwd"),
        ("C2'", "inproj_bwd"), ("reduce", "reduce_partials")),
    "fused_recurrent_layer_chunked_bwd": (
        ("A", "phase_a"), ("B", "::chunk_scan"), ("A'", "tail_bwd"), ("B'", "rev_chunk"),
        ("C1'", "gate_bwd"), ("C2'", "inproj_bwd"), ("reduce", "reduce_partials")),
}
# the three phase kernels whose products run on the tensor cores
RECBLR_MMA_KERNELS = ("tail_bwd_mma_kernel", "gate_bwd_mma_kernel", "inproj_bwd_mma_kernel")


def recblr_bwd_phase_times(dev, calls=10):
    """Rows 2 and 4 at the bench training shape (B 2,048, T 200, p 0.2,
    with the forward's stash; fp32 and bf16) and row 9 at XLong (B 512,
    T 1,024, bf16) by phase: the CUDA-event time of a call beside each
    phase's device ms per call and its share of the device total, from
    torch.profiler.  Fails unless A', C1' and C2' ran their tensor-core
    kernels."""
    gen = torch.Generator().manual_seed(SEED + 4)
    p1 = layer_params(gen, dev, prologue=True)
    p2 = layer_params(gen, dev, prologue=False)
    x = torch.randn((TRAIN_B, T, D), generator=gen).to(dev)
    lens = torch.randint(2, T + 1, (TRAIN_B,), generator=gen).to(dev)
    d1 = torch.randn((TRAIN_B, T, D), generator=gen).to(dev)
    d2 = torch.randn((TRAIN_B, D), generator=gen).to(dev)
    seed = 4242
    for dt in (torch.float32, torch.bfloat16):
        xd, dd1, dd2 = x.to(dt), d1.to(dt), d2.to(dt)
        _, s1 = FL.fused_recurrent_layer_train(xd, p1, True, True, True, DROPOUT, seed)
        _, s2 = FL.fused_recurrent_layer_last_train(xd, lens, p2, True, True, DROPOUT, seed)
        calls_of = {
            "fused_recurrent_layer_bwd": lambda: FL.fused_recurrent_layer_bwd(
                xd, dd1, p1, True, True, True, DROPOUT, seed, saved=s1),
            "fused_recurrent_layer_last_bwd": lambda: FL.fused_recurrent_layer_last_bwd(
                xd, lens, dd2, p2, True, True, DROPOUT, seed, saved=s2),
        }
        for name, call in calls_of.items():
            phase("kernel-time-phase", kernel=name, B=TRAIN_B, T=T,
                  dtype=str(dt).replace("torch.", ""), p=DROPOUT,
                  **_phase_times(call, RECBLR_BWD_PHASES[name], calls, RECBLR_MMA_KERNELS))
        del s1, s2
    del x, d1, d2
    x = torch.randn((XB, XT, D), generator=gen).to(dev, torch.bfloat16)
    d1 = torch.randn((XB, XT, D), generator=gen).to(dev, torch.bfloat16)
    args = (True, True, True, DROPOUT, seed)
    _, rec = FLC.fused_recurrent_layer_chunked_train(x, p1, *args)
    name = "fused_recurrent_layer_chunked_bwd"
    phase("kernel-time-phase", kernel=name, shape="xlong", B=XB, T=XT, dtype="bfloat16",
          p=DROPOUT, **_phase_times(lambda: FLC.fused_recurrent_layer_chunked_bwd(
              x, d1, rec, p1, *args), RECBLR_BWD_PHASES[name], calls, RECBLR_MMA_KERNELS))


# rows 1, 3, 9 and 8's forwards by phase: the kernels their entry points
# launch (names as substrings, the parent's FMA kernels included)
RECBLR_FWD_PHASES = {
    "fused_recurrent_layer": (("A", "phase_a"), ("scan", "linear_scan"), ("tail", "tail_")),
    "fused_recurrent_layer_last": (("A", "phase_a"), ("scan", "scan_last"), ("tail", "tail_")),
    "fused_recurrent_layer_chunked": (("A", "phase_a"), ("B1", "chunk_state"),
                                      ("B2", "chunk_scan"), ("tail", "tail_")),
    "fused_bdlru": (("A", "phase_a"), ("scan", "linear_scan")),
}


def recblr_fwd_phase_times(dev, calls=10):
    """Rows 1 and 3 at the bench training shape (B 2,048, T 200, p 0.2,
    the forward that keeps the stash; fp32 and bf16), row 9 at XLong (B
    512, T 1,024, bf16) and row 8 at longodd (B 512, T 1,020, C 128, bf16)
    by phase: the CUDA-event time of a call beside each phase's device ms
    per call, its share and the device total, from torch.profiler.  Fails
    unless phase A and the tail ran their tensor-core kernels (row 8:
    phase A)."""
    gen = torch.Generator().manual_seed(SEED + 4)
    p1 = layer_params(gen, dev, prologue=True)
    p2 = layer_params(gen, dev, prologue=False)
    x = torch.randn((TRAIN_B, T, D), generator=gen).to(dev)
    lens = torch.randint(2, T + 1, (TRAIN_B,), generator=gen).to(dev)
    seed = 4242
    for dt in (torch.float32, torch.bfloat16):
        xd = x.to(dt)
        calls_of = {
            "fused_recurrent_layer": lambda: FL.fused_recurrent_layer_train(
                xd, p1, True, True, True, DROPOUT, seed),
            "fused_recurrent_layer_last": lambda: FL.fused_recurrent_layer_last_train(
                xd, lens, p2, True, True, DROPOUT, seed),
        }
        for name, call in calls_of.items():
            phase("kernel-time-phase", kernel=name, B=TRAIN_B, T=T,
                  dtype=str(dt).replace("torch.", ""), p=DROPOUT,
                  **_phase_times(call, RECBLR_FWD_PHASES[name], calls, RECBLR_FWD_MMA))
    del x
    x = torch.randn((XB, XT, D), generator=gen).to(dev, torch.bfloat16)
    name = "fused_recurrent_layer_chunked"
    phase("kernel-time-phase", kernel=name, shape="xlong", B=XB, T=XT, dtype="bfloat16",
          p=DROPOUT, **_phase_times(lambda: FLC.fused_recurrent_layer_chunked_train(
              x, p1, True, True, True, DROPOUT, seed), RECBLR_FWD_PHASES[name], calls,
              RECBLR_FWD_MMA))
    del x
    pb = bdlru_params(gen, dev)
    xb = torch.randn((XB, LT, C), generator=gen).to(dev, torch.bfloat16)
    phase("kernel-time-phase", kernel="fused_bdlru", shape="longodd", B=XB, T=LT, C=C,
          dtype="bfloat16", **_phase_times(lambda: FBD.fused_bdlru(xb, *pb.values()),
                                           RECBLR_FWD_PHASES["fused_bdlru"], calls,
                                           RECBLR_FWD_MMA[:1]))


def chunked_bound_ms(b, t, p, act_bytes, priced_fma=False):
    # K1's operations; x read and out written once, the params, the record
    # [B, T / chunk, 8, C] fp32 written
    nbytes = (2 * b * t * D * act_bytes + _params_bytes(p)
              + b * (t // FLC.pick_chunk(t)) * FLC.REC_ROWS * C * 4)
    return _recblr_bound(b * t * K1_MM, b * t * K1_REST, nbytes, priced_fma)


def chunked_bwd_bound_ms(b, t, p, act_bytes, priced_fma=False):
    # the forward recomputed and two gradient products per forward product
    # (K1's backward work); x, dout and dx, the record read, the params read
    # and their grads written
    nbytes = (3 * b * t * D * act_bytes + b * (t // FLC.pick_chunk(t)) * FLC.REC_ROWS * C * 4
              + 2 * _params_bytes(p))
    return _recblr_bound(*_bwd_flops_k1(b, t), nbytes, priced_fma)


def emb_grad_bound_ms(n, v, g_bytes, id_bytes=8):
    # ids and the [N, D] cotangents read once, the [V, D] fp32 sum written
    # once; one add per cotangent element
    return _bound(n * D, n * id_bytes + n * D * g_bytes + v * D * 4)


def xlong_kernel_times(dev):
    """The new kernels at the XLong step's shapes, in the configuration's
    bf16: row 9 forward (keeping the record) and backward at B 512, T 1,024,
    p = 0.2; row 14 forward and backward at N 512, V 329,728 with bf16 x
    and bf16 products; row 16 at N 524,288; each beside its bound, its
    plain version (a backward's: autograd's backward of the plain forward,
    its graph built once) and one PyTorch call of the same function where
    there is one (row 14: ``F.cross_entropy`` on materialized logits and
    ``autograd.grad`` through it; row 16: one ``index_add_`` into fp32
    zeros).  K2 and its backward (recompute branch) at the same shape, for
    the record of their T = 1,024 times."""
    gen = torch.Generator().manual_seed(SEED + 22)
    p1 = layer_params(gen, dev, prologue=True)
    p2 = layer_params(gen, dev, prologue=False)
    x = torch.randn((XB, XT, D), generator=gen).to(dev, torch.bfloat16)
    d1 = torch.randn((XB, XT, D), generator=gen).to(dev, torch.bfloat16)
    d2 = torch.randn((XB, D), generator=gen).to(dev, torch.bfloat16)
    lens = torch.randint(2, XMAX_LEN + 1, (XB,), generator=gen).to(dev)
    seed = 4242
    args = (True, True, True, DROPOUT, seed)
    _, rec = FLC.fused_recurrent_layer_chunked_train(x, p1, *args)
    times = {
        "fused_recurrent_layer_chunked": time_ms(
            lambda: FLC.fused_recurrent_layer_chunked_train(x, p1, *args), reps=10),
        "fused_recurrent_layer_chunked_bwd": time_ms(
            lambda: FLC.fused_recurrent_layer_chunked_bwd(x, d1, rec, p1, *args), reps=10),
        "fused_recurrent_layer_last": time_ms(lambda: FL.fused_recurrent_layer_last_train(
            x, lens, p2, True, True, DROPOUT, seed), reps=10),
        "fused_recurrent_layer_last_bwd": time_ms(lambda: FL.fused_recurrent_layer_last_bwd(
            x, lens, d2, p2, True, True, DROPOUT, seed), reps=10),
    }
    plain, lib = {}, {}
    for name, fn, pp, dout in (
        ("fused_recurrent_layer_chunked", lambda a, q: FLC.fused_recurrent_layer_chunked_plain(
            a, q, *args)[0], p1, d1),
        ("fused_recurrent_layer_last", lambda a, q: FL.fused_recurrent_layer_last_plain(
            a, lens, q, True, True, DROPOUT, seed), p2, d2),
    ):
        # the plain versions walk T in Python: two calls each, no warm-up
        with torch.no_grad():
            plain[name] = time_ms(lambda: fn(x, pp), reps=2, warmup=0)
        xl = x.clone().requires_grad_()
        ql = {k: v.clone().requires_grad_() for k, v in pp.items()}
        out = fn(xl, ql)
        inputs = [xl, *ql.values()]
        plain[name + "_bwd"] = time_ms(lambda: torch.autograd.grad(out, inputs, dout,
                                                                   retain_graph=True),
                                       reps=2, warmup=0)
        lib[name] = lib[name + "_bwd"] = None
        del out, inputs, xl, ql

    xc, table, tgt, dnll = _xlong_ce_inputs(gen, dev)
    xc = xc.to(torch.bfloat16)
    vp = table.shape[0]
    _, lse = FCE.fused_softmax_ce_chunked_train(xc, table, tgt, None, XV, True)
    times["fused_softmax_ce_chunked"] = time_ms(
        lambda: FCE.fused_softmax_ce_chunked_train(xc, table, tgt, None, XV, True))
    times["fused_softmax_ce_chunked_bwd"] = time_ms(lambda: FCE.fused_softmax_ce_chunked_bwd(
        xc, table, tgt, dnll, None, XV, True, lse=lse))
    with torch.no_grad():
        plain["fused_softmax_ce_chunked"] = time_ms(
            lambda: FCE.fused_softmax_ce_chunked_fwd_plain(xc, table, tgt, None, XV, True),
            reps=5, warmup=1)
    plain["fused_softmax_ce_chunked_bwd"] = time_ms(
        lambda: FCE.fused_softmax_ce_chunked_bwd_plain(xc, table, tgt, dnll, None, XV, True,
                                                       lse=lse), reps=5, warmup=1)
    # the library yardstick: the same function on bf16-rounded operands, the
    # padded columns at -1e30, checked against the plain version first
    xr = xc.float()
    tr = table.to(torch.bfloat16).float()
    bias = torch.where(torch.arange(vp, device=dev) < XV, 0.0, FCE.NEG)
    xl, tl = xr.clone().requires_grad_(), tr.clone().requires_grad_()
    lib_out = F.cross_entropy(xl @ tl.T + bias, tgt, reduction="none")
    want = FCE.fused_softmax_ce_chunked_fwd_plain(xc, table, tgt, None, XV, True)[0]
    lib_err = float((lib_out.detach() - want).abs().max())
    lib_ok = lib_err <= 1e-4 * float(want.abs().max())
    phase("library-vs-plain", call="F.cross_entropy(x @ table.T - 1e30 beyond V)", N=XB, V=vp,
          max_abs_err=f"{lib_err:.3e}", tol="1e-4*max|plain|", ok=lib_ok)
    check(lib_ok, "F.cross_entropy does not compute the chunked plain CE's function")
    with torch.no_grad():
        lib["fused_softmax_ce_chunked"] = time_ms(lambda: F.cross_entropy(
            xr @ tr.T + bias, tgt, reduction="none"))
    lib["fused_softmax_ce_chunked_bwd"] = time_ms(lambda: torch.autograd.grad(
        lib_out, [xl, tl], dnll, retain_graph=True))
    del lib_out, xl, tl, want

    ids, g, _ = _xlong_emb_inputs(gen, dev)
    flat_ids, flat_g = ids.reshape(-1), g.reshape(-1, D).float()
    times["embedding_grad"] = time_ms(lambda: E.embedding_grad(ids, g, vp))
    plain["embedding_grad"] = time_ms(lambda: E.embedding_grad_plain(ids, g, vp))
    zeros = torch.zeros((vp, D), device=dev)
    lib["embedding_grad"] = time_ms(lambda: zeros.zero_().index_add_(0, flat_ids, flat_g))

    n_ids = ids.numel()
    bounds = {
        "fused_recurrent_layer_chunked": chunked_bound_ms(XB, XT, p1, 2),
        "fused_recurrent_layer_chunked_bwd": chunked_bwd_bound_ms(XB, XT, p1, 2),
        "fused_recurrent_layer_last": k2_bound_ms(lens.cpu(), p2, 2, t=XT),
        "fused_recurrent_layer_last_bwd": k2_bwd_bound_ms(lens.cpu(), XT, p2, 2),
        "fused_softmax_ce_chunked": ce_bound_ms(XB, vp, 2, train=True, mm_bf16=True),
        "fused_softmax_ce_chunked_bwd": ce_bwd_bound_ms(XB, vp, 2, mm_bf16=True),
        "embedding_grad": emb_grad_bound_ms(n_ids, vp, 2),
    }
    fma = {"fused_recurrent_layer_chunked_bwd": chunked_bwd_bound_ms(XB, XT, p1, 2,
                                                                     priced_fma=True),
           "fused_recurrent_layer_last_bwd": k2_bwd_bound_ms(lens.cpu(), XT, p2, 2,
                                                             priced_fma=True),
           "fused_recurrent_layer_chunked": chunked_bound_ms(XB, XT, p1, 2, priced_fma=True),
           "fused_recurrent_layer_last": k2_bound_ms(lens.cpu(), p2, 2, t=XT, priced_fma=True),
           "fused_softmax_ce_chunked": ce_bound_ms(XB, vp, 2, train=True, mm_bf16=True,
                                                   priced_fma=True)}
    rows = {}
    for name, ms in times.items():
        bound, flops, by = bounds[name]
        phase("kernel-time", kernel=name, shape="xlong", B=XB, T=XT, N=n_ids if name ==
              "embedding_grad" else XB, V=vp, dtype="bfloat16", p=DROPOUT if "layer" in name
              else 0.0, ms=f"{ms:.4f}", plain_ms=f"{plain[name]:.4f}",
              library_ms=f"{lib[name]:.4f}" if lib[name] is not None else "none",
              bound_ms=f"{bound:.5f}", gflop=f"{flops / 1e9:.3f}", bound_by=by,
              share_of_bound=f"{bound / ms:.4f}", **_fma_field(fma, name))
        rows[name] = (ms, plain[name], bound, by, lib[name])
    return rows



# embedding_grad's launches by sub-kernel (names as substrings, the
# parent's kernels included): the sort passes with the scratch memset,
# the segment bounds, the piece sums, the group sums, the row sums
ROW16_PHASES = (("sort", ("radix_", "exclusive_scan", "Memset")), ("bounds", ("seg_bounds",)),
                ("pieces", ("piece_sum",)), ("groups", ("group_sum",)),
                ("rows", ("row_fix", "row_sum")))


def row16_times(dev, calls=10):
    """Row 16 at the bench step (the ids ``train_step_phase`` batches,
    N 409,600, V 3,417, bf16 g): first the same check as at XLong
    (``emb-grad-kernel-vs-plain``), then its kernel-time line beside its
    bound, its plain version and ``index_add_`` into fp32 zeros; then at
    XLong and at the bench step, ``kernel-time-phase``: the CUDA-event ms
    of a call and, from torch.profiler over ``calls`` calls, the device ms
    per call of each group of ``ROW16_PHASES``, of the rest (``other``:
    any kernel outside them, such as an id cast), the device total, the
    kernels a call launches, the wrapper's share (event minus device ms)
    and each kernel's device ms (``by_kernel``)."""
    gen = torch.Generator().manual_seed(SEED + 36)
    ids, g, vp = _bench_emb_inputs(gen, dev)
    emb_grad_check("emb-grad-kernel-vs-plain", ids, g, vp)
    flat_ids, flat_g = ids.reshape(-1).long(), g.reshape(-1, D).float()
    ms = time_ms(lambda: E.embedding_grad(ids, g, vp))
    plain = time_ms(lambda: E.embedding_grad_plain(ids, g, vp))
    zeros = torch.zeros((vp, D), device=dev)
    lib = time_ms(lambda: zeros.zero_().index_add_(0, flat_ids, flat_g))
    bound, flops, by = emb_grad_bound_ms(ids.numel(), vp, 2, ids.element_size())
    phase("kernel-time", kernel="embedding_grad", shape="bench", B=TRAIN_B, T=T, N=ids.numel(),
          V=vp, dtype="bfloat16", p=0.0, ms=f"{ms:.4f}", plain_ms=f"{plain:.4f}",
          library_ms=f"{lib:.4f}", bound_ms=f"{bound:.5f}", gflop=f"{flops / 1e9:.3f}",
          bound_by=by, share_of_bound=f"{bound / ms:.4f}")
    del zeros, flat_ids, flat_g
    for label, (ids, g, vp) in (("xlong", _xlong_emb_inputs(gen, dev)), ("bench", (ids, g, vp))):
        ms = time_ms(lambda: E.embedding_grad(ids, g, vp))
        events, _ = profiled(_timed_loop(lambda _: E.embedding_grad(ids, g, vp), calls))
        dev_us = {e.key: (e.self_device_time_total, e.count) for e in events}
        if not dev_us:
            phase("kernel-time-phase", kernel="embedding_grad", shape=label, ms=f"{ms:.4f}",
                  device_ms="not measured (no device events in three profiles)")
            continue
        total = sum(us for us, _ in dev_us.values())
        fields, seen = {}, set()
        for name, keys in ROW16_PHASES:
            hit = [k for k in dev_us if any(s in k for s in keys)]
            seen.update(hit)
            us = sum(dev_us[k][0] for k in hit)
            fields[f"{name}_ms"] = f"{us / calls / 1e3:.4f}" if hit else "none"
        other = sum(us for k, (us, _) in dev_us.items() if k not in seen)
        by_name = {}
        for k, (us, _) in dev_us.items():
            by_name[_kernel_name(k)] = by_name.get(_kernel_name(k), 0.0) + us
        device_ms = total / calls / 1e3
        phase("kernel-time-phase", kernel="embedding_grad", shape=label, N=ids.numel(), V=vp,
              D=D, ids_dtype=str(ids.dtype).split(".")[-1], dtype="bfloat16", ms=f"{ms:.4f}",
              **fields, other_ms=f"{other / calls / 1e3:.4f}", device_ms=f"{device_ms:.4f}",
              wrapper_ms=f"{ms - device_ms:.4f}",
              launches_per_call=f"{sum(n for _, n in dev_us.values()) / calls:.1f}",
              by_kernel="|".join(f"{name}:{us / calls / 1e3:.4f}"
                                 for name, us in sorted(by_name.items())))


def _kernel_name(key):
    """A profiler key's kernel name without its namespace, template
    arguments and parameters."""
    key = re.sub(r"^void |\(anonymous namespace\)::|\w+::", "", key)
    return re.split(r"[<(]", key, maxsplit=1)[0].strip() or key[:40]


def ln_fwd_kernel_times(dev):
    """Rows 6 and 5's forwards (``fused_ln_dropout``, ``fused_dropout_ln``)
    at T 200, D 64, fp32 and bf16: at B 2,048 with the training rates
    (SASRec's 0.5, RecBLR's 0.2) and at B 256 with p 0 (serving), each
    beside its bound, its plain version and ``F.layer_norm`` of the same LN
    input without the dropout, in x's dtype (``shape=ln-fwd``)."""
    gen = torch.Generator().manual_seed(SEED + 37)
    pos = (0.5 * torch.randn((T, D), generator=gen)).to(dev)
    s = (1 + 0.1 * torch.randn(D, generator=gen)).to(dev)
    bias = (0.1 * torch.randn(D, generator=gen)).to(dev)
    with torch.no_grad():
        for b, p6, p5 in ((TRAIN_B, SAS_DROPOUT, DROPOUT), (B, 0.0, 0.0)):
            x32 = torch.randn((b, T, D), generator=gen).to(dev)
            for dt in (torch.float32, torch.bfloat16):
                x = x32.to(dt)
                act = x.element_size()
                pl, sl, bl = pos.to(dt), s.to(dt), bias.to(dt)
                for name, p, kernel, plain, lib, bnd in (
                    ("fused_ln_dropout", p6,
                     lambda: FL.fused_ln_dropout(x, pos, s, bias, p6, 7),
                     lambda: FL.fused_ln_dropout_plain(x, pos, s, bias, p6, 7),
                     lambda: F.layer_norm(x + pl, (D,), sl, bl, L.LN_EPS), ln_bound_ms(b, act)),
                    ("fused_dropout_ln", p5,
                     lambda: FL.fused_dropout_ln(x, s, bias, p5, 7),
                     lambda: FL.fused_dropout_ln_plain(x, s, bias, p5, 7),
                     lambda: F.layer_norm(x, (D,), sl, bl, L.LN_EPS),
                     dropout_ln_bound_ms(b, T, act)),
                ):
                    ms = time_ms(kernel)
                    plain_ms = time_ms(plain, reps=5, warmup=1)
                    lib_ms = time_ms(lib)
                    bound, flops, by = bnd
                    phase("kernel-time", kernel=name, shape="ln-fwd", B=b, T=T, D=D,
                          dtype=str(dt).split(".")[-1], p=p, ms=f"{ms:.4f}",
                          plain_ms=f"{plain_ms:.4f}", library_ms=f"{lib_ms:.4f}",
                          bound_ms=f"{bound:.5f}", gflop=f"{flops / 1e9:.3f}", bound_by=by,
                          share_of_bound=f"{bound / ms:.4f}")
            del x32, x


# ---------------------------------------------------------------------------
# RecBLR outside the whole-layer kernels: LN(dropout(x)) (row 5), the linear
# scan (row 7) and the standalone BD-LRU (row 8)
# ---------------------------------------------------------------------------

def _bwd_rows(dx, wdx, grads, wgrads, dt):
    rows = {"dx": _grad_err_ok(dx, wdx, dt, True)}
    rows.update({k: _grad_err_ok(v, wgrads[k], dt, False) for k, v in grads.items()})
    return rows


def _max_err(pairs):
    return max(float((a.float() - b.float()).abs().max()) for a, b in pairs)


def dropout_ln_kernels_vs_plain(dev):
    """Row 5 at the onelayer path's shape (B 2,048, T 200, D 64), fp32 and
    bf16, p 0, 0.2 and H&M's 0.4: the output, dx, dscale and dbias against
    autograd of the plain version.  Returns the largest fp32 |kernel -
    plain| of the forward and of the backward."""
    gen = torch.Generator().manual_seed(SEED + 30)
    x = (2 * torch.randn((TRAIN_B, T, D), generator=gen)).to(dev)
    d3 = torch.randn((TRAIN_B, T, D), generator=gen).to(dev)
    q = {"s": (1 + 0.1 * torch.randn(D, generator=gen)).to(dev),
         "b": (0.1 * torch.randn(D, generator=gen)).to(dev)}
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        for pd in (0.0, DROPOUT, HM_DROPOUT):
            xd, dout = x.to(dt), d3.to(dt)
            seed = 8642 + int(pd * 10)
            out = FL.fused_dropout_ln(xd, q["s"], q["b"], pd, seed)
            dx, ds, db = FL.fused_dropout_ln_bwd(xd, dout, q["s"], q["b"], pd, seed)
            wout, wdx, wg = _plain_vjp(lambda a, p: FL.fused_dropout_ln_plain(
                a, p["s"], p["b"], pd, seed), xd, q, dout)
            torch.cuda.synchronize()
            ok_out = (torch.allclose(out, wout, **FP32_TOL) if dt == torch.float32
                      else _bf16_ok(out, wout))
            rows = _bwd_rows(dx, wdx, {"s": ds, "b": db}, wg, dt)
            ok = ok_out and all(o for _, o in rows.values())
            phase("dropout-ln-kernel-vs-plain", kernel="fused_dropout_ln_bwd",
                  dtype=str(dt).split(".")[-1], p=pd, shape=f"B{TRAIN_B}xT{T}xD{D}",
                  out_max_abs_err=f"{float((out.float() - wout.float()).abs().max()):.3e}",
                  rel_err=repr({k: float(f"{e:.3e}") for k, (e, _) in rows.items()}),
                  tol=f"out as kernel-vs-plain; max|err|/max|plain| <= {GRAD_RTOL}"
                      + (" (bf16 dx: + 2^-7*|plain|)" if dt == torch.bfloat16 else ""),
                  ok=ok)
            check(ok, f"fused_dropout_ln {dt} p={pd}: kernel disagrees with its plain version")
            if dt == torch.float32:
                errs["fused_dropout_ln"] = max(errs.get("fused_dropout_ln", 0.0),
                                               _max_err([(out, wout)]))
                errs["fused_dropout_ln_bwd"] = max(
                    errs.get("fused_dropout_ln_bwd", 0.0),
                    _max_err([(dx, wdx), (ds, wg["s"]), (db, wg["b"])]))
    return errs


def dropout_ln_mask_bits(dev):
    """Row 5's mask bit for bit against the plain Philox mask of
    ``layers.dropout(x)`` at B 2,048, T 200, D 64: the backward's dx =
    LN'(dv) * m0 is 0 exactly where m0 drops; the forward's bits enter
    every value dropout-ln-kernel-vs-plain compares at p > 0."""
    gen = torch.Generator().manual_seed(SEED + 31)
    x = torch.randn((TRAIN_B, T, D), generator=gen).to(dev)
    dout = torch.randn((TRAIN_B, T, D), generator=gen).to(dev)
    seed = 97531
    dx, _, _ = FL.fused_dropout_ln_bwd(x, dout, torch.ones(D, device=dev),
                                       torch.zeros(D, device=dev), DROPOUT, seed)
    want = philox.dropout_mask(seed, philox.M0, TRAIN_B, T, D, DROPOUT, dev) > 0
    flips = int(((dx != 0) != want).sum())
    phase("dropout-ln-mask-bits", mask="m0 (row 5, the input of the LN)", elements=want.numel(),
          keep_fraction=f"{float(want.float().mean()):.5f}", mismatches=flips)
    check(flips == 0, f"row 5 m0: {flips} mask bits differ from the plain Philox mask")


def scan_kernels_vs_plain(dev, shapes=((TRAIN_B, T, WIDE_C), (TRAIN_B, T, 200))):
    """Row 7 at ``shapes`` (by default the wide path's, B 2,048, T 200, C
    256, and C 200): the forward and the reverse mode against the serial
    scans (fp32, atol and rtol 1e-4), and the gradients of ``linear_scan``
    (the reverse kernel on shift_left(gates)) against autograd of the
    serial scan.  Returns the largest |kernel - plain| of each."""
    gen = torch.Generator().manual_seed(SEED + 32)
    errs = {}
    for b, t, c in shapes:
        g = (0.3 + 0.699 * torch.rand((b, t, c), generator=gen)).to(dev)
        x = torch.randn((b, t, c), generator=gen).to(dev)
        dh = torch.randn((b, t, c), generator=gen).to(dev)
        h = SC.linear_scan(g, x)
        r = SC.linear_scan_reverse(g, x)
        gl, xl = g.clone().requires_grad_(), x.clone().requires_grad_()
        SC.linear_scan(gl, xl).backward(dh)
        with torch.no_grad():
            wh, wr = SC.linear_scan_serial(g, x), SC.linear_scan_reverse_serial(g, x)
        gp, xp = g.clone().requires_grad_(), x.clone().requires_grad_()
        wgg, wgx = torch.autograd.grad(SC.linear_scan_serial(gp, xp), [gp, xp], dh)
        torch.cuda.synchronize()
        rows = {"d_gates": _grad_err_ok(gl.grad, wgg, torch.float32, False),
                "d_tokens": _grad_err_ok(xl.grad, wgx, torch.float32, False)}
        ok = (torch.allclose(h, wh, **FP32_TOL) and torch.allclose(r, wr, **FP32_TOL)
              and all(o for _, o in rows.values()))
        phase("scan-kernel-vs-plain", kernel="linear_scan, linear_scan_reverse",
              dtype="float32", shape=f"B{b}xT{t}xC{c}",
              fwd_max_abs_err=f"{_max_err([(h, wh)]):.3e}",
              reverse_max_abs_err=f"{_max_err([(r, wr)]):.3e}",
              grad_rel_err=repr({k: float(f"{e:.3e}") for k, (e, _) in rows.items()}),
              tol=f"atol {FP32_TOL['atol']} rtol {FP32_TOL['rtol']}; grads max|err|/max|plain| "
                  f"<= {GRAD_RTOL}", ok=ok)
        check(ok, f"linear_scan C={c}: kernel disagrees with the serial scan")
        errs["linear_scan"] = max(errs.get("linear_scan", 0.0), _max_err([(h, wh)]))
        errs["linear_scan_reverse"] = max(errs.get("linear_scan_reverse", 0.0),
                                          _max_err([(r, wr), (gl.grad, wgg), (xl.grad, wgx)]))
        del g, x, dh, h, r, gl, xl, wh, wr, gp, xp, wgg, wgx
    return errs


def bdlru_params(gen, dev, c=C):
    def r(*s, std=0.05):
        return (std * torch.randn(s, generator=gen)).to(dev)

    return {"wc": r(K, c, std=0.5), "bc": r(c, std=0.5), "wg": r(c, 2 * c), "bg": r(2 * c),
            "lam": torch.linspace(-2.2, -6.9, c).to(dev)}


def bdlru_kernels_vs_plain(dev):
    """Row 8 at the longodd path's shape (B 512, T 1,020, C 128, K 4), fp32
    and bf16, with and without the conv: h, dx and the five weight grads
    against autograd of the plain version (the serial scan over 1,020
    steps).  Returns the largest fp32 |kernel - plain| of each."""
    gen = torch.Generator().manual_seed(SEED + 33)
    p = bdlru_params(gen, dev)
    x = torch.randn((XB, LT, C), generator=gen).to(dev)
    d3 = torch.randn((XB, LT, C), generator=gen).to(dev)
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        for use_conv in (True, False):
            xd, dh = x.to(dt), d3.to(dt)
            out = FBD.fused_bdlru(xd, *p.values(), use_conv)
            dx, *grads = FBD.fused_bdlru_bwd(xd, dh, *p.values(), use_conv)
            grads = dict(zip(p, grads))
            # without the conv the plain version does not read its weights:
            # their gradients are 0
            used = p if use_conv else {k: p[k] for k in ("wg", "bg", "lam")}
            wout, wdx, wg = _plain_vjp(lambda a, q: FBD.fused_bdlru_plain(
                a, *dict(p, **q).values(), use_conv), xd, used, dh)
            torch.cuda.synchronize()
            for k in set(p) - set(used):
                wg[k] = torch.zeros_like(p[k])
            ok_out = (torch.allclose(out, wout, **FP32_TOL) if dt == torch.float32
                      else _bf16_ok(out, wout))
            rows = _bwd_rows(dx, wdx, grads, wg, dt)
            ok = ok_out and all(o for _, o in rows.values())
            phase("bdlru-kernel-vs-plain", kernel="fused_bdlru_bwd", dtype=str(dt).split(".")[-1],
                  use_conv=use_conv, shape=f"B{XB}xT{LT}xC{C}xK{K}",
                  out_max_abs_err=f"{float((out.float() - wout.float()).abs().max()):.3e}",
                  rel_err=repr({k: float(f"{e:.3e}") for k, (e, _) in rows.items()}),
                  tol=f"out as kernel-vs-plain; max|err|/max|plain| <= {GRAD_RTOL}"
                      + (" (bf16 dx: + 2^-7*|plain|)" if dt == torch.bfloat16 else ""),
                  ok=ok)
            check(ok, f"fused_bdlru {dt} use_conv={use_conv}: kernel disagrees with its plain "
                      "version")
            if dt == torch.float32:
                errs["fused_bdlru"] = max(errs.get("fused_bdlru", 0.0), _max_err([(out, wout)]))
                errs["fused_bdlru_bwd"] = max(
                    errs.get("fused_bdlru_bwd", 0.0),
                    _max_err([(dx, wdx)] + [(v, wg[k]) for k, v in grads.items()]))
            del out, dx, grads, wout, wdx, wg
    return errs


# the wrappers of RecBLR's paths outside the whole-layer kernels and their
# plain versions, where models/recblr.py reaches them
PLAIN_TWINS = ((RB, "fused_dropout_ln", FL.fused_dropout_ln_plain),
               (RB, "fused_recurrent_layer_last", FL.fused_recurrent_layer_last_plain),
               (RB, "linear_scan", SC.linear_scan_serial),
               (RB, "fused_bdlru", FBD.fused_bdlru_plain))


@contextlib.contextmanager
def plain_kernels(model, twins, embed=None):
    """The model with each kernel wrapper of ``twins`` (module, name, plain
    version) swapped for its plain version and the plain embedding
    gather, or ``embed(ids)`` (the same dropout seeds, so the same masks)."""
    saved = [(mod, n, getattr(mod, n)) for mod, n, _ in twins]
    try:
        for mod, n, f in twins:
            setattr(mod, n, f)
        model.embed = embed or (lambda ids: plain_embed(model, ids))
        yield
    finally:
        for mod, n, f in saved:
            setattr(mod, n, f)
        del model.embed


def plain_path_output(model, seq, lens, step=None, embed=None):
    """RecBLR's own forward through the plain versions of these paths."""
    with plain_kernels(model, PLAIN_TWINS, embed):
        return model(seq, lens, step=step)


def slice_config(path, dtype_name):
    spec = SLICE_PATHS[path]
    return Config(model="RecBLR", config_dict={
        "MAX_ITEM_LIST_LENGTH": spec["t"], "compute_dtype": dtype_name,
        "train_batch_size": spec["batch"], "seed": SEED, "dropout_prob": DROPOUT,
        "hidden_size": D, "num_layers": 2, "expand": C // D, "d_conv": K, **spec["cfg"]})


def on_slice_path(model, path):
    """The model is at full width on ``path``'s composition."""
    width = (model.hidden_size, model.d_conv, model.max_seq_len) == (
        D, K, SLICE_PATHS[path]["t"])
    if path in ("onelayer", "hm"):
        return width and model.use_fused_layer() and len(model.layers) == 1 and (
            model.inner_hidden == C)
    unfused = not (model.use_fused_layer() or model.use_chunked_layer())
    if path == "wide":
        return width and unfused and model.inner_hidden == WIDE_C and not model.use_fused_bdlru()
    return width and unfused and model.inner_hidden == C and model.use_fused_bdlru()


def _slice_data(trainer, path):
    """The path's training split on the card: the bench data at T 200 (50
    for H&M), or PR 6's XLong data (histories of 2 .. 1,000) at T 1,020."""
    from datamining_recblr_torch.data.synthetic import synthetic_splits

    spec = SLICE_PATHS[path]
    if path == "longodd":
        train, _ = synthetic_splits(5000, XV, LT, 4096, seed=SEED)
        train.item_seq_len[:] = np.minimum(train.item_seq_len, XMAX_LEN)
        train.item_seq[:, XMAX_LEN:] = 0
    else:
        train, _ = synthetic_splits(6040, N_ITEMS, spec["t"], 8192, seed=SEED)
    return train, trainer.device_split(train)


def _capturing(embed, store):
    """``embed`` that keeps its ids and the cotangent of its output in
    ``store``."""
    def f(ids):
        e = embed(ids)
        store["ids"] = ids
        e.register_hook(lambda g: store.update(g=g.detach().clone()))
        return e
    return f


def item_grad_parts(model, batch, step):
    """Where a bf16 step's item-embedding gradient leaves the plain bf16
    step's.  Each part is a max |difference| over the plain gradient's
    largest value: ``total``; ``rows``, the cotangents at the embedding
    output (the layers' backward), each step's summed into the table in
    fp64; ``table_sum``, the ``embedding_grad`` kernel's sum of the step's
    own cotangents against that fp64 sum (``plain_table_sum``: autograd's
    fp32 sum); ``ce``, the rest, the CE's table gradient (row 14 and the
    plain CE, each on its step's output).  ``rows_rel``: max |cotangent
    difference| over the largest plain cotangent."""
    v = model.item_embedding.shape[0]
    got, want = {}, {}
    model.train()
    model.zero_grad(set_to_none=True)
    model.embed = _capturing(model.embed, got)
    try:
        model.calculate_loss(batch, step=step).backward()
    finally:
        del model.embed
    g_k = model.item_embedding.grad.detach().clone()
    model.zero_grad(set_to_none=True)
    plain_out = functools.partial(
        plain_path_output, embed=_capturing(lambda ids: plain_embed(model, ids), want))
    plain_ce_loss(plain_out)(model, batch, step).backward()
    g_p = model.item_embedding.grad.detach().clone()
    model.zero_grad(set_to_none=True)

    def sum64(part):
        d = part["g"].shape[-1]
        return torch.zeros((v, d), dtype=torch.float64, device=g_p.device).index_add_(
            0, part["ids"].reshape(-1).long(), part["g"].reshape(-1, d).double())

    s_k, s_p = sum64(got), sum64(want)
    e_k = E.embedding_grad(got["ids"], got["g"], v)
    e_p = E.embedding_grad_plain(want["ids"], want["g"], v)
    top = float(g_p.abs().max())

    def rel(a, b):
        return float((a.double() - b.double()).abs().max()) / top

    parts = {"total": rel(g_k, g_p), "rows": rel(s_k, s_p), "table_sum": rel(e_k, s_k),
             "plain_table_sum": rel(e_p, s_p), "ce": rel(g_k - e_k, g_p - e_p),
             "rows_rel": float((got["g"].float() - want["g"].float()).abs().max()
                               / want["g"].float().abs().max())}
    return parts, top


def slice_train_phase(dev, path, dtype_name, timed=True):
    """RecBLR on one path outside the whole-layer kernels at full width:
    one step of the main path with every count at 0 before it (launches,
    and the step against the same step through the plain versions), then
    the step time and a profile.  A bf16 step's gradients are held within
    2^-7 of each gradient's largest value, the item embedding's within
    ITEM_BF16_RTOL; on the longodd path the item embedding's is taken
    apart (``item_grad_parts``) at this step and at the next batch and
    step."""
    from datamining_recblr_torch.train.trainer import Trainer

    spec = SLICE_PATHS[path]
    prefix = f"{path}-train"
    counted = spec["counted"]
    expected = spec["per_step"]
    if dtype_name == "bfloat16":
        counted, expected = counted + (E.embedding_grad,), expected + (1,)
    cfg = slice_config(path, dtype_name)
    model = get_model("RecBLR")(cfg, spec["v"], spec["t"],
                                generator=torch.Generator().manual_seed(SEED))
    check(on_slice_path(model, path), f"RecBLR {path}: not that path at full width")
    trainer = Trainer(cfg, model)
    train, data = _slice_data(trainer, path)
    b = spec["batch"]
    perm = np.random.default_rng((SEED, 2)).permutation(len(train))
    weight = torch.ones(b, device=dev)

    def batch_of(s):
        idx = perm[(s * b) % len(train):][:b]
        return trainer.gather_batch(data, torch.from_numpy(idx).to(dev), weight)

    tol = GRAD_RTOL if dtype_name == "float32" else BF16_RTOL
    plain_loss = plain_ce_loss(plain_path_output)
    batch = batch_of(0)
    launches, loss, want_loss, loss_err, errs = step_vs_plain(model, batch, counted, plain_loss,
                                                              0.0, tol)
    bf16 = dtype_name == "bfloat16"
    tols = {k: ITEM_BF16_RTOL if bf16 and k == "item_embedding" else tol for k in errs}
    worst = max(errs, key=lambda k: errs[k] / tols[k])
    phase(f"{prefix}-step-vs-plain", dtype=dtype_name, batch=b, T=spec["t"], V=spec["v"],
          C=model.inner_hidden, layers=len(model.layers), p=model.dropout_prob,
          loss=f"{loss:.6f}", plain_loss=f"{want_loss:.6f}", loss_rel_err=f"{loss_err:.3e}",
          loss_tol="1e-4", grad_rel_err_max=f"{max(errs.values()):.3e}", worst_param=worst,
          worst_rel_err=f"{errs[worst]:.3e}", worst_tol=f"{tols[worst]:.3e}",
          item_embedding_rel_err=f"{errs['item_embedding']:.3e}",
          grad_tol=f"max|err|/max|plain| <= {tol}"
          + (f", item_embedding {ITEM_BF16_RTOL}" if bf16 else ""), params=len(errs))
    check(np.isfinite(loss), f"RecBLR {path}: train loss is not finite")
    check(loss_err <= 1e-4, f"RecBLR {path}: train loss disagrees with the plain step")
    check(all(errs[k] <= tols[k] for k in errs),
          f"RecBLR {path}: gradients disagree with the plain step")
    if bf16 and path == "longodd":
        for s, bt in ((7, batch), (8, batch_of(1))):
            parts, top = item_grad_parts(model, bt, s)
            phase(f"{prefix}-item-grad", dtype=dtype_name, step=s, plain_max=f"{top:.4e}",
                  **{k: f"{v:.3e}" for k, v in parts.items()}, tol=ITEM_BF16_RTOL)
            check(all(np.isfinite(v) for v in parts.values())
                  and parts["total"] <= ITEM_BF16_RTOL,
                  f"RecBLR {path}: the item-embedding gradient at step {s} disagrees")
    phase(f"{prefix}-launches", dtype=dtype_name, steps=1,
          **{fn.__name__: n for fn, n in zip(counted, launches)})
    check(launches == expected, f"RecBLR {path}: expected launches {expected}, got {launches}")
    out = {"launches": dict(zip((fn.__name__ for fn in counted), launches))}
    if not timed:
        return out
    steps = XTRAIN_STEPS if path == "longodd" else TRAIN_STEPS
    med, lo, hi, peak = time_steps(trainer, batch_of, steps)
    phase(f"{prefix}-time", dtype=dtype_name, batch=b, T=spec["t"], steps=steps,
          median_ms_per_step=f"{med:.3f}", examples_per_s=f"{b / med * 1e3:.1f}",
          min_ms=f"{lo:.3f}", max_ms=f"{hi:.3f}", peak_device_gb=f"{peak:.3f}")
    train_profile(trainer, batch_of, dtype_name, prefix, steps=3 if path == "longodd" else 5)
    out.update(ms=med, examples_per_s=b / med * 1e3, peak_gb=peak)
    return out


def dropout_ln_bound_ms(b, t, act_bytes):
    # x read and out written once, scale and bias [D]; about 8 operations
    # per element (mask, mean, centre, square-sum, scale, shift)
    return _bound(8 * b * t * D, 2 * b * t * D * act_bytes + 2 * D * 4)


def dropout_ln_bwd_bound_ms(b, t, act_bytes):
    # x, dout read and dx written once, scale read, dscale and dbias
    # written; about 16 operations per element (the LN recomputed and its
    # backward)
    return _bound(16 * b * t * D, 3 * b * t * D * act_bytes + 3 * D * 4)


def scan_bound_ms(b, t, c):
    # gates and tokens read, h written once (fp32); one multiply-add each
    return _bound(2 * b * t * c, 3 * b * t * c * 4)


def bdlru_bound_ms(b, t, c, p, act_bytes, priced_fma=False):
    # per position the gate product (2 C x 2C, on the tensor cores), the
    # conv (2 K C) and the scan (2 C); x read and h written once, the
    # params read
    return _recblr_bound(b * t * 2 * c * 2 * c, b * t * (2 * K * c + 2 * c),
                         2 * b * t * c * act_bytes + _params_bytes(p), priced_fma)


def bdlru_bwd_bound_ms(b, t, c, p, act_bytes, priced_fma=False):
    # the gate product recomputed and its two gradient products (on the
    # tensor cores), the conv and its two gradients, both scans; x, dh read
    # and dx written, the params read and their grads written
    return _recblr_bound(b * t * 3 * 2 * c * 2 * c, b * t * (6 * K * c + 4 * c),
                         3 * b * t * c * act_bytes + 2 * _params_bytes(p), priced_fma)


def slice_kernel_times(dev):
    """Rows 5, 7 and 8 at their paths' shapes, fp32 (row 8 also bf16, the
    longodd path's dtype): row 5 at B 2,048, T 200, D 64, p 0.2; row 7 at
    B 2,048, T 200, C 256; row 8 at B 512, T 1,020, C 128, each beside its
    bound, its plain version (a backward's: autograd's backward of the
    plain forward, its graph built once) and, for row 5, one PyTorch call
    of the same function: ``F.layer_norm`` on the dropped input and
    ``autograd.grad`` through it, checked first against the plain version.
    Rows 7 and 8 have no single-call library equivalent."""
    gen = torch.Generator().manual_seed(SEED + 34)
    rows = {}

    def emit(name, ms, plain_ms, bnd, lib, fma=None, **shape):
        bound, flops, by = bnd
        phase("kernel-time", kernel=name, **shape, ms=f"{ms:.4f}",
              plain_ms=f"{plain_ms:.4f}" if plain_ms is not None else "not measured",
              library_ms=f"{lib:.4f}" if lib is not None else "none", bound_ms=f"{bound:.5f}",
              gflop=f"{flops / 1e9:.3f}", bound_by=by, share_of_bound=f"{bound / ms:.4f}",
              **_fma_field({name: fma} if fma else {}, name))
        if shape.get("dtype", "float32") == "float32":
            rows[name] = (ms, plain_ms, bound, by, lib)

    # row 5
    x = (2 * torch.randn((TRAIN_B, T, D), generator=gen)).to(dev)
    d3 = torch.randn((TRAIN_B, T, D), generator=gen).to(dev)
    s = (1 + 0.1 * torch.randn(D, generator=gen)).to(dev)
    bias = (0.1 * torch.randn(D, generator=gen)).to(dev)
    seed = 4242
    ms = time_ms(lambda: FL.fused_dropout_ln(x, s, bias, DROPOUT, seed))
    ms_bwd = time_ms(lambda: FL.fused_dropout_ln_bwd(x, d3, s, bias, DROPOUT, seed))
    with torch.no_grad():
        plain = time_ms(lambda: FL.fused_dropout_ln_plain(x, s, bias, DROPOUT, seed), reps=5,
                        warmup=1)
    xl, sl, bl = (a.clone().requires_grad_() for a in (x, s, bias))
    out = FL.fused_dropout_ln_plain(xl, sl, bl, DROPOUT, seed)
    plain_bwd = time_ms(lambda: torch.autograd.grad(out, [xl, sl, bl], d3, retain_graph=True),
                        reps=5, warmup=1)
    xdrop = x * philox.dropout_mask(seed, philox.M0, TRAIN_B, T, D, DROPOUT, dev)
    xdl = xdrop.clone().requires_grad_()
    lib_out = F.layer_norm(xdl, (D,), sl, bl, L.LN_EPS)
    lib_err = float((lib_out.detach() - out.detach()).abs().max())
    lib_ok = lib_err <= 1e-4 * float(out.detach().abs().max())
    phase("library-vs-plain", call="F.layer_norm(dropout(x))", B=TRAIN_B, T=T,
          max_abs_err=f"{lib_err:.3e}", tol="1e-4*max|plain|", ok=lib_ok)
    check(lib_ok, "F.layer_norm on the dropped input does not compute row 5's function")
    with torch.no_grad():
        lib = time_ms(lambda: F.layer_norm(xdrop, (D,), s, bias, L.LN_EPS))
    lib_bwd = time_ms(lambda: torch.autograd.grad(lib_out, [xdl, sl, bl], d3, retain_graph=True))
    shape = dict(B=TRAIN_B, T=T, D=D, dtype="float32", p=DROPOUT)
    emit("fused_dropout_ln", ms, plain, dropout_ln_bound_ms(TRAIN_B, T, 4), lib, **shape)
    emit("fused_dropout_ln_bwd", ms_bwd, plain_bwd, dropout_ln_bwd_bound_ms(TRAIN_B, T, 4),
         lib_bwd, **shape)
    del x, d3, xl, out, xdrop, xdl, lib_out

    # row 7
    g = (0.3 + 0.699 * torch.rand((TRAIN_B, T, WIDE_C), generator=gen)).to(dev)
    xs = torch.randn((TRAIN_B, T, WIDE_C), generator=gen).to(dev)
    shape = dict(B=TRAIN_B, T=T, C=WIDE_C, dtype="float32")
    for name, fn, plain_fn in (("linear_scan", SC.linear_scan, SC.linear_scan_serial),
                               ("linear_scan_reverse", SC.linear_scan_reverse,
                                SC.linear_scan_reverse_serial)):
        ms = time_ms(lambda: fn(g, xs))
        plain = time_ms(lambda: plain_fn(g, xs), reps=5, warmup=1)
        emit(name, ms, plain, scan_bound_ms(TRAIN_B, T, WIDE_C), None, **shape)
    del g, xs

    # row 8
    p = bdlru_params(gen, dev)
    x = torch.randn((XB, LT, C), generator=gen).to(dev)
    d3 = torch.randn((XB, LT, C), generator=gen).to(dev)
    for dt in (torch.float32, torch.bfloat16):
        xd, dh = x.to(dt), d3.to(dt)
        act = xd.element_size()
        shape = dict(B=XB, T=LT, C=C, K=K, dtype=str(dt).split(".")[-1])
        ms = time_ms(lambda: FBD.fused_bdlru(xd, *p.values()), reps=10)
        ms_bwd = time_ms(lambda: FBD.fused_bdlru_bwd(xd, dh, *p.values()), reps=10)
        if dt == torch.float32:
            # the plain version walks T in Python: two calls each, no warm-up
            with torch.no_grad():
                plain = time_ms(lambda: FBD.fused_bdlru_plain(xd, *p.values()), reps=2,
                                warmup=0)
            xl = xd.clone().requires_grad_()
            ql = [v.clone().requires_grad_() for v in p.values()]
            out = FBD.fused_bdlru_plain(xl, *ql)
            plain_bwd = time_ms(lambda: torch.autograd.grad(out, [xl, *ql], dh,
                                                            retain_graph=True), reps=2, warmup=0)
            del out, xl, ql
        else:
            plain = plain_bwd = None
        emit("fused_bdlru", ms, plain, bdlru_bound_ms(XB, LT, C, p, act), None,
             fma=bdlru_bound_ms(XB, LT, C, p, act, priced_fma=True), **shape)
        emit("fused_bdlru_bwd", ms_bwd, plain_bwd, bdlru_bwd_bound_ms(XB, LT, C, p, act), None,
             fma=bdlru_bwd_bound_ms(XB, LT, C, p, act, priced_fma=True), **shape)
    return rows


# ---------------------------------------------------------------------------
# the attention baselines beyond the whole-layer kernels: queue B row 15
# ---------------------------------------------------------------------------

# [B, H, T, dh] of row 15 on the d256 path (batch 2,048, 2 heads of 128, T
# 200) and on the long one (2 heads of 32, T 2,048; a batch of 4 here)
ROW15_SHAPES = {"d256": (TRAIN_B, 2, T, 128), "long": (4, 2, 2048, 32)}
ROW15_DROPOUT = 0.2


def _row15_inputs(gen, shape, dev, dt):
    b, h, t, dh = shape
    q, k, v, dout = (torch.randn(shape, generator=gen).to(dev, dt) for _ in range(4))
    lens = torch.randint(1, t + 1, (b,), generator=gen)
    lens[:3] = torch.tensor([0, 1, t])
    return q, k, v, dout, lens.to(dev)


def _row15_err(got, want, dtype):
    """(max |kernel - plain|, ok): fp32 within 1e-4 of the largest plain
    value (a row of lens 0 sits at -10000, where an fp32 ulp is 2^-10);
    bf16 within one bf16 ulp of the value plus 1e-4 of the largest."""
    g, w = got.float(), want.float()
    top = float(w.abs().max())
    rtol = BF16_RTOL if dtype == torch.bfloat16 else 0.0
    ok = bool(torch.isfinite(g).all()) and bool(((g - w).abs() <= rtol * w.abs()
                                                 + 1e-4 * top).all())
    return float((g - w).abs().max()), ok


def attention_kernels_vs_plain(dev):
    """Row 15 forward and backward (dq, dk, dv) against autograd of the
    plain version at the d256 shape and at T 2,048 (B 4), fp32 and bf16,
    causal and bidirectional, p = 0 and 0.2, rows of lens 0, 1 and T."""
    gen = torch.Generator().manual_seed(SEED + 40)
    errs = {"fused_attention": 0.0, "fused_attention_bwd": 0.0}
    for shape_name, shape in ROW15_SHAPES.items():
        for dt in (torch.float32, torch.bfloat16):
            q, k, v, dout, lens = _row15_inputs(gen, shape, dev, dt)
            for causal in (True, False):
                for p in (0.0, ROW15_DROPOUT):
                    args = (4242, causal, p)
                    mma = (A.fused_attention.mma_launches, A.fused_attention_bwd.mma_launches)
                    out, saved = A.fused_attention_train(q, k, v, lens, *args)
                    grads = A.fused_attention_bwd(q, k, v, lens, dout, *args, saved=saved)
                    mma = (A.fused_attention.mma_launches - mma[0],
                           A.fused_attention_bwd.mma_launches - mma[1])
                    again = A.fused_attention_bwd(q, k, v, lens, dout, *args, saved=saved)
                    same = all(torch.equal(g, a) for g, a in zip(grads, again))
                    leaves = [a.clone().requires_grad_() for a in (q, k, v)]
                    want = A.fused_attention_plain(*leaves, lens, *args)
                    wgrads = torch.autograd.grad(want, leaves, dout)
                    torch.cuda.synchronize()
                    fwd = _row15_err(out, want.detach(), dt)
                    bwd = [_row15_err(g, w, dt) for g, w in zip(grads, wgrads)]
                    ok = fwd[1] and all(e[1] for e in bwd) and same and mma == (1, 1)
                    phase("attention-kernel-vs-plain", shape=shape_name,
                          B_H_T_dh="x".join(map(str, shape)), dtype=str(dt).split(".")[-1],
                          causal=causal, p=p, out_max_abs_err=f"{fwd[0]:.3e}",
                          dq_dk_dv_max_abs_err="/".join(f"{e[0]:.3e}" for e in bwd),
                          tol="1e-4*max|plain|" + (" + 1 bf16 ulp" if dt != torch.float32
                                                    else ""),
                          mma_launches_fwd_bwd="/".join(map(str, mma)),
                          rerun_bit_equal=same, ok=ok)
                    check(ok, f"row 15 {shape_name} {dt} causal={causal} p={p}: the kernels "
                          "disagree with the plain version, miss the tensor cores or give "
                          "other bits on a rerun")
                    if dt == torch.float32:
                        errs["fused_attention"] = max(errs["fused_attention"], fwd[0])
                        errs["fused_attention_bwd"] = max(errs["fused_attention_bwd"],
                                                          *(e[0] for e in bwd))
                    del out, saved, grads, again, leaves, want, wgrads
    return errs


def attention_mask_bits(dev):
    """Each head's probability mask as row 15's forward draws it, bit for
    bit against the plain Philox mask: T = dh = 128 keys and v the
    identity, so out[b, h, i, j] = p_ij m_ij with every p_ij > 0 where the
    key is kept (lens T, one row of lens 0), causal and bidirectional."""
    gen = torch.Generator().manual_seed(SEED + 41)
    b, h, t, seed = B, 2, 128, 97531
    q, k = (torch.randn((b, h, t, t), generator=gen).to(dev) for _ in range(2))
    v = torch.eye(t, device=dev).expand(b, h, t, t).contiguous()
    lens = torch.full((b,), t, device=dev)
    lens[3] = 0
    masks = A.prob_masks(seed, ROW15_DROPOUT, b, h, t, dev) > 0
    for causal in (False, True):
        out = A.fused_attention(q, k, v, lens, seed, causal, ROW15_DROPOUT)
        want = masks.clone()
        if causal:
            want[lens > 0] &= torch.ones((t, t), dtype=torch.bool, device=dev).tril()
        flips = int(((out != 0) != want).sum())
        phase("attention-mask-bits", mask="probabilities (4 + h)", causal=causal,
              elements=want.numel(), keep_fraction=f"{float(want.float().mean()):.5f}",
              mismatches=flips)
        check(flips == 0, f"row 15 causal={causal}: {flips} mask bits differ from the plain "
              "Philox mask")


# a seq rank's query chunk of row 15 at the bench widths (hidden 64: 2 heads
# of 32, T 200, B 2,048) on two seq ranks: Tq 100, the second chunk at q0 100
ROW15_CHUNK = (TRAIN_B, 2, T, 32)
ROW15_CHUNK_TQ = ROW15_CHUNK_Q0 = T // 2
ROW15_CHUNK_DROPOUT = 0.1


def row15_chunk_vs_plain(dev):
    """Row 15 at a seq rank's query chunk (``ROW15_CHUNK``: Tq 100 of T 200,
    q0 0 and 100), fp32 and bf16, causal and bidirectional, p 0 and 0.1,
    rows of lens 0, 1 and T among random ones: the forward, dq and the
    chunk's share of dk and dv against autograd of the plain version at
    the same chunk (``_row15_err``), one tensor-core launch each, a rerun's
    bits; and in fp32 the two chunks' dk and dv summed against the whole
    call's kernel.  Returns the largest fp32 |kernel - plain| of each."""
    gen = torch.Generator().manual_seed(SEED + 43)
    errs = {"fused_attention": 0.0, "fused_attention_bwd": 0.0}
    tq, shape = ROW15_CHUNK_TQ, ROW15_CHUNK
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[-1]
        q, k, v, dout, lens = _row15_inputs(gen, shape, dev, dt)
        for causal in (True, False):
            for p in (0.0, ROW15_CHUNK_DROPOUT):
                args = (4343, causal, p)
                shares = [torch.zeros(k.shape, device=dev), torch.zeros(v.shape, device=dev)]
                for q0 in (0, ROW15_CHUNK_Q0):
                    qc, oc = (a[:, :, q0:q0 + tq].contiguous() for a in (q, dout))
                    mma = (A.fused_attention.mma_launches, A.fused_attention_bwd.mma_launches)
                    out, saved = A.fused_attention_train(qc, k, v, lens, *args, q0)
                    grads = A.fused_attention_bwd(qc, k, v, lens, oc, *args, q0, saved=saved)
                    mma = (A.fused_attention.mma_launches - mma[0],
                           A.fused_attention_bwd.mma_launches - mma[1])
                    again = A.fused_attention_bwd(qc, k, v, lens, oc, *args, q0, saved=saved)
                    same = all(torch.equal(g, a) for g, a in zip(grads, again))
                    leaves = [a.clone().requires_grad_() for a in (qc, k, v)]
                    want = A.fused_attention_plain(*leaves, lens, *args, q0)
                    wgrads = torch.autograd.grad(want, leaves, oc)
                    torch.cuda.synchronize()
                    fwd = _row15_err(out, want.detach(), dt)
                    bwd = [_row15_err(g, w, dt) for g, w in zip(grads, wgrads)]
                    ok = fwd[1] and all(e[1] for e in bwd) and same and mma == (1, 1)
                    phase("attention-chunk-kernel-vs-plain", B_H_T_dh="x".join(map(str, shape)),
                          Tq=tq, q0=q0, dtype=dname, causal=causal, p=p,
                          out_max_abs_err=f"{fwd[0]:.3e}",
                          dq_dk_dv_max_abs_err="/".join(f"{e[0]:.3e}" for e in bwd),
                          tol="1e-4*max|plain|" + (" + 1 bf16 ulp" if dt != torch.float32
                                                    else ""),
                          mma_launches_fwd_bwd="/".join(map(str, mma)),
                          rerun_bit_equal=same, ok=ok)
                    check(ok, f"row 15 at the query chunk q0={q0} {dt} causal={causal} p={p}: "
                          "the kernels disagree with the plain version, miss the tensor "
                          "cores or give other bits on a rerun")
                    if dt == torch.float32:
                        errs["fused_attention"] = max(errs["fused_attention"], fwd[0])
                        errs["fused_attention_bwd"] = max(errs["fused_attention_bwd"],
                                                          *(e[0] for e in bwd))
                    shares[0] += grads[1].float()
                    shares[1] += grads[2].float()
                    del out, saved, grads, again, leaves, want, wgrads
                if dt == torch.float32:
                    _, saved = A.fused_attention_train(q, k, v, lens, *args)
                    _, dk, dv = A.fused_attention_bwd(q, k, v, lens, dout, *args, saved=saved)
                    sums = [_row15_err(a, w, dt) for a, w in zip(shares, (dk, dv))]
                    phase("attention-chunk-shares", B_H_T_dh="x".join(map(str, shape)),
                          chunks=f"2x{tq}", causal=causal, p=p,
                          dk_dv_sum_vs_whole_max_abs_err="/".join(f"{e[0]:.3e}" for e in sums),
                          tol="1e-4*max|whole|", ok=all(e[1] for e in sums))
                    check(all(e[1] for e in sums), f"row 15 causal={causal} p={p}: the chunks' "
                          "dk and dv do not add up to the whole call's")
                    del saved, dk, dv
        del q, k, v, dout
    return errs


def row6_chunk_vs_plain(dev):
    """Row 6 at a seq rank's chunk: B 2,048, positions 100 .. 199 of T 200
    (t0 100, its rows of the positional table), D 64, fp32 and bf16, p 0
    and 0.5 (SASRec's): the output, dx, dpos, dscale and dbias against
    autograd of the plain version at the same t0, and the output against
    the whole call's rows there, bit for bit.  Returns the largest fp32
    |kernel - plain| of the forward and (over max |plain|) of the
    backward."""
    gen = torch.Generator().manual_seed(SEED + 44)
    t0 = tc = T // 2
    pos = (0.5 * torch.randn((T, D), generator=gen)).to(dev)
    s = (1 + 0.1 * torch.randn(D, generator=gen)).to(dev)
    bias = (0.1 * torch.randn(D, generator=gen)).to(dev)
    pc = pos[t0:].contiguous()
    errs = {"fused_ln_dropout": 0.0, "fused_ln_dropout_bwd": 0.0}
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn((TRAIN_B, T, D), generator=gen).to(dev, dt)
        dout = torch.randn((TRAIN_B, tc, D), generator=gen).to(dev, dt)
        xc = x[:, t0:].contiguous()
        for p in (0.0, SAS_DROPOUT):
            out = FL.fused_ln_dropout(xc, pc, s, bias, p, 7, t0)
            bits = torch.equal(out, FL.fused_ln_dropout(x, pos, s, bias, p, 7)[:, t0:])
            dx, *grads = FL.fused_ln_dropout_bwd(xc, pc, dout, s, bias, p, 7, t0)
            leaves = [a.clone().requires_grad_() for a in (xc, pc, s, bias)]
            want = FL.fused_ln_dropout_plain(*leaves, p, 7, t0)
            wdx, *wgrads = torch.autograd.grad(want, leaves, dout)
            torch.cuda.synchronize()
            fwd = _row15_err(out, want.detach(), dt)
            rows = _bwd_rows(dx, wdx, dict(zip(("dpos", "dscale", "dbias"), grads)),
                             dict(zip(("dpos", "dscale", "dbias"), wgrads)), dt)
            ok = fwd[1] and bits and all(r[1] for r in rows.values())
            phase("ln-chunk-kernel-vs-plain", B=TRAIN_B, T=T, Tc=tc, t0=t0, D=D,
                  dtype=str(dt).split(".")[-1], p=p, out_max_abs_err=f"{fwd[0]:.3e}",
                  out_bit_equal_to_whole_rows=bits,
                  grad_rel_err=repr({k: f"{v[0]:.3e}" for k, v in rows.items()}), ok=ok)
            check(ok, f"row 6 at t0={t0} {dt} p={p}: the kernels disagree with the plain "
                  "version or the whole call's rows")
            if dt == torch.float32:
                errs["fused_ln_dropout"] = max(errs["fused_ln_dropout"], fwd[0])
                errs["fused_ln_dropout_bwd"] = max(errs["fused_ln_dropout_bwd"],
                                                   *(r[0] for r in rows.values()))
    return errs


def chunk_kernel_times(dev):
    """Rows 15 and 6 at a seq rank's chunk, the seq cases' shapes: row 15 at
    ``ROW15_CHUNK`` (Tq 100 at q0 100, lengths 2 .. T), causal and
    bidirectional, fp32 and bf16, p 0, forward and backward, each beside
    its bound (the chunk's kept pairs and bytes), its plain version and
    ``F.scaled_dot_product_attention`` with the chunk's [B, 1, Tq, T]
    mask (autograd through it for the backward), checked first against the
    plain version as ``row15_kernel_times`` does; row 6 at B 2,048,
    positions 100 .. 199, D 64, fp32, p 0.5, forward and backward, beside
    its bound, its plain version and add + ``F.layer_norm`` (autograd
    through it for the backward) (``shape=chunk``)."""
    gen = torch.Generator().manual_seed(SEED + 45)
    shape, tq, q0 = ROW15_CHUNK, ROW15_CHUNK_TQ, ROW15_CHUNK_Q0
    t = shape[2]
    q32, k32, v32, _, _ = _row15_inputs(gen, shape, dev, torch.float32)
    q32 = q32[:, :, q0:q0 + tq].contiguous()
    dout32 = torch.randn(q32.shape, generator=gen).to(dev)
    lens = torch.randint(2, t + 1, (shape[0],), generator=gen).to(dev)
    blens = lens.cpu()
    tag = "x".join(map(str, shape)) + f"_Tq{tq}_q0{q0}"
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[-1]
        q, k, v, dout = (a.to(dt) for a in (q32, k32, v32, dout32))
        for causal in (True, False):
            args = (lens, 4242, causal, 0.0, q0)
            mask = FB.attention_mask(lens, t, causal, dev, q0, tq)[:, None].to(dt)
            leaves = [a.clone().requires_grad_() for a in (q, k, v)]
            want = A.fused_attention_plain(*leaves, *args)
            lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
            lib_err = float((lib_out.float() - want.float()).detach().abs().max())
            tol = (2.0 ** -5 if dt == torch.bfloat16 else 1e-4) * float(
                want.detach().float().abs().max())
            phase("library-vs-plain", shape="chunk",
                  call="F.scaled_dot_product_attention(attn_mask=the chunk's -10000 mask)",
                  B_H_T_dh=tag, causal=causal, dtype=dname, max_abs_err=f"{lib_err:.3e}",
                  tol=f"{tol:.3e}", ok=lib_err <= tol)
            check(lib_err <= tol, "scaled_dot_product_attention does not compute row 15's "
                                  "function at the chunk")
            _, saved = A.fused_attention_train(q, k, v, *args)
            with torch.no_grad():
                ms = time_ms(lambda: A.fused_attention(q, k, v, *args))
                plain = time_ms(lambda: A.fused_attention_plain(q, k, v, *args), reps=5,
                                warmup=1)
                lib = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
            ms_bwd = time_ms(lambda: A.fused_attention_bwd(q, k, v, lens, dout, 4242, causal,
                                                           0.0, q0, saved=saved))
            plain_bwd = time_ms(lambda: torch.autograd.grad(want, leaves, dout,
                                                            retain_graph=True),
                                reps=5, warmup=1)
            lib_bwd = time_ms(lambda: torch.autograd.grad(lib_out, leaves, dout,
                                                          retain_graph=True))
            size = q.element_size()
            for name, t_ms, t_plain, t_lib, bnd in (
                    ("fused_attention", ms, plain, lib,
                     row15_bound_ms(blens, shape, causal, size, tq=tq, q0=q0)),
                    ("fused_attention_bwd", ms_bwd, plain_bwd, lib_bwd,
                     row15_bwd_bound_ms(blens, shape, causal, size, tq=tq, q0=q0))):
                bound, flops, by = bnd
                phase("kernel-time", kernel=name, shape="chunk", B_H_T_dh=tag, causal=causal,
                      dtype=dname, p=0.0, ms=f"{t_ms:.4f}", plain_ms=f"{t_plain:.4f}",
                      library_ms=f"{t_lib:.4f}", bound_ms=f"{bound:.5f}",
                      gflop=f"{flops / 1e9:.3f}", bound_by=by,
                      share_of_bound=f"{bound / t_ms:.4f}")
            del leaves, want, lib_out, saved
    t0 = tc = T // 2
    x = torch.randn((TRAIN_B, tc, D), generator=gen).to(dev)
    d3 = torch.randn((TRAIN_B, tc, D), generator=gen).to(dev)
    pos = (0.5 * torch.randn((tc, D), generator=gen)).to(dev)
    s = (1 + 0.1 * torch.randn(D, generator=gen)).to(dev)
    bias = (0.1 * torch.randn(D, generator=gen)).to(dev)
    leaves = [a.clone().requires_grad_() for a in (x, pos, s, bias)]
    want = FL.fused_ln_dropout_plain(*leaves, SAS_DROPOUT, 7, t0)
    lib_out = F.layer_norm(leaves[0] + leaves[1], (D,), leaves[2], leaves[3], L.LN_EPS)
    with torch.no_grad():
        fwd = (time_ms(lambda: FL.fused_ln_dropout(x, pos, s, bias, SAS_DROPOUT, 7, t0)),
               time_ms(lambda: FL.fused_ln_dropout_plain(x, pos, s, bias, SAS_DROPOUT, 7, t0),
                       reps=5, warmup=1),
               time_ms(lambda: F.layer_norm(x + pos, (D,), s, bias, L.LN_EPS)))
    bwd = (time_ms(lambda: FL.fused_ln_dropout_bwd(x, pos, d3, s, bias, SAS_DROPOUT, 7, t0)),
           time_ms(lambda: torch.autograd.grad(want, leaves, d3, retain_graph=True), reps=5,
                   warmup=1),
           time_ms(lambda: torch.autograd.grad(lib_out, leaves, d3, retain_graph=True)))
    for name, (t_ms, t_plain, t_lib), bnd in (
            ("fused_ln_dropout", fwd, ln_bound_ms(TRAIN_B, 4, tc)),
            ("fused_ln_dropout_bwd", bwd, ln_bwd_bound_ms(TRAIN_B, 4, tc))):
        bound, flops, by = bnd
        phase("kernel-time", kernel=name, shape="chunk", B=TRAIN_B, T=T, Tc=tc, t0=t0, D=D,
              dtype="float32", p=SAS_DROPOUT, ms=f"{t_ms:.4f}", plain_ms=f"{t_plain:.4f}",
              library_ms=f"{t_lib:.4f}", bound_ms=f"{bound:.5f}", gflop=f"{flops / 1e9:.3f}",
              bound_by=by, share_of_bound=f"{bound / t_ms:.4f}")


# ---------------------------------------------------------------------------
# queue B row 17: the probes (probes/) at the JAX probes' defaults
# ---------------------------------------------------------------------------

# each probe kernel's wrapper, whose launches the probes' entry points count
PROBE_COUNTED = {"unit_overlap": PUO.run, "vpu_ops": PVO.vpu_chain, "scan_flat": PSC.scan_flat,
                 "scan_chunk": PSC.scan_chunk, "ce_mm": PCE.mm, "emb_gather": PEG.gather,
                 "mask_forward": PMR.masks_forward, "mask_reversed": PMR.masks_reversed}
UO_GRID, UO_NM, UO_NV = 64, 16, 48   # unit_overlap's defaults
CE_N, CE_V = 81_920, 3_456           # ce_mxu's defaults
# mask_replay_check's sizes: the JAX probe's defaults, and the chunked
# layer's at XLong (B 512 in blocks of 8 rows, T 1,024 in chunks of 128,
# D 64, FFN 256)
MASK_SIZES = {"default": dict(nb=PMR.NB, nc=PMR.NC, bt=PMR.BT, tc=PMR.TC, d=PMR.D,
                              ff=4 * PMR.D),
              "xlong": dict(nb=64, nc=8, bt=8, tc=128, d=64, ff=256)}
# a mask's drop fraction against 1 - keep (65,536 draws of m0 at the
# default sizes: sigma 0.0016)
DROP_TOL = 0.01
# 32-bit integer operations a second on each of two pipes, the ALU pipe
# (LOP3, IADD3, ISETP, FSEL) and the FMA-heavy one (IMAD, IMUL): 64 lanes
# an SM each, against the 128 fp32 lanes behind PEAK_FP32_FLOPS (an FMA
# counting two)
PEAK_INT32_OPS = PEAK_FP32_FLOPS / 4
# the bf16 product: products of bf16 values are exact in fp32, sums of 64
# in another order
MXU_TOL = dict(atol=1e-5, rtol=1e-5)
# the scans: one 200-step recurrence in three orders (fmaf in the kernels,
# a multiply and an add in the plain versions), |h| up to about 30
SCAN_RTOL = 1e-5


def _finite_err(got, want):
    """(max |got - want| over want's finite entries, whether both hold
    their infinities and NaNs at the same places with the same signs)."""
    fin = torch.isfinite(want)
    same = bool(torch.equal(fin, torch.isfinite(got))) and bool(
        torch.equal(got[~fin].nan_to_num(), want[~fin].nan_to_num()))
    err = float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0
    return err, same


def probe_kernels_vs_plain(dev):
    """Rows 17a-17f against their plain versions at the JAX probes'
    default shapes (``probe-vs-plain``): unit_overlap's five modes (grid
    64, nm 16, nv 48), vpu_ops' fourteen chains ([8, 512, 128], 64 steps),
    both scans (B 2,048, T 200, C 128), the bf16 product at every block
    height (N 81,920, V 3,456), the gather (N 409,600, V 3,417, D 64, bf16
    and fp32, bit for bit) and both mask kernels at the default and the
    XLong sizes (bit for bit against the plain masks and each other, each
    mask's drop fraction within DROP_TOL of 1 - keep).  Returns the
    largest |kernel - plain| of each kernel."""
    errs = {}
    x, x2, w, a, b = PUO.inputs(UO_GRID, dev)
    for mode in PUO.MODES:
        got = PUO.run(x, x2, w, a, b, mode, UO_NM, UO_NV, UO_GRID)
        want = PUO.run_plain(x, x2, w, a, b, mode, UO_NM, UO_NV)
        err = _max_err([(got, want)])
        ok = bool(torch.allclose(got, want, **FP32_TOL))
        phase("probe-vs-plain", kernel="unit_overlap", mode=mode,
              shape=f"{UO_GRID * PUO.ROWS}x{PUO.C}", nm=UO_NM, nv=UO_NV,
              max_abs_err=f"{err:.3e}", tol=f"atol {FP32_TOL['atol']} rtol {FP32_TOL['rtol']}",
              ok=ok)
        check(ok, f"unit_overlap {mode}: kernel disagrees with its plain version")
        errs["unit_overlap"] = max(errs.get("unit_overlap", 0.0), err)
    del x, x2, got, want
    x = PVO.inputs(dev)
    op_errs = {}
    for name in PVO.OPS:
        got = PVO.vpu_chain(x, name, PVO.REPEAT)
        want = PVO.vpu_chain_plain(x, name, PVO.REPEAT)
        err, same = _finite_err(got, want)
        fin = torch.isfinite(want)
        ok = same and bool(torch.allclose(got[fin], want[fin], **FP32_TOL))
        check(ok, f"vpu_ops {name}: kernel disagrees with its plain version (err {err:.3e})")
        op_errs[name] = err
    phase("probe-vs-plain", kernel="vpu_ops", shape="x".join(map(str, PVO.SHAPE)),
          repeat=PVO.REPEAT, max_abs_err=repr({k: float(f"{e:.3e}") for k, e in op_errs.items()}),
          tol=f"atol {FP32_TOL['atol']} rtol {FP32_TOL['rtol']} on finite values, the same "
              "infinities", ok=True)
    errs["vpu_ops"] = max(op_errs.values())
    g, x = PSC.inputs(dev)
    for name, kern, plain in (("scan_flat", PSC.scan_flat, PSC.scan_flat_plain),
                              ("scan_chunk", PSC.scan_chunk, PSC.scan_chunk_plain)):
        got, want = kern(g, x), plain(g, x)
        err = _max_err([(got, want)])
        rel = err / float(want.abs().max())
        ok = rel <= SCAN_RTOL
        phase("probe-vs-plain", kernel=name, shape=f"B{PSC.B}xT{PSC.T}xC{PSC.C}",
              max_abs_err=f"{err:.3e}", rel_err=f"{rel:.3e}", tol=f"max|err|/max|h| <= {SCAN_RTOL}",
              ok=ok)
        check(ok, f"{name}: kernel disagrees with its plain version")
        errs[name] = err
        del got, want
    del g, x
    x, table, _, _ = PCE.inputs(CE_N, CE_V, dev)
    want = PCE.mm_plain(x, table)
    for bn in PCE.BNS:
        got = PCE.mm(x, table, bn)
        err = _max_err([(got, want)])
        ok = bool(torch.allclose(got, want, **MXU_TOL))
        phase("probe-vs-plain", kernel="ce_mm", shape=f"N{CE_N}xV{CE_V}xD{PCE.D}", bn=bn,
              max_abs_err=f"{err:.3e}", tol=f"atol {MXU_TOL['atol']} rtol {MXU_TOL['rtol']}",
              ok=ok)
        check(ok, f"ce_mm bn={bn}: kernel disagrees with its plain version")
        errs["ce_mm"] = max(errs.get("ce_mm", 0.0), err)
        del got
    del x, table, want
    for dt in ("bfloat16", "float32"):
        ids, tab = PEG.inputs(dev, dtype=PEG.DTYPES[dt])
        got, want = PEG.gather(ids, tab), PEG.gather_plain(ids, tab)
        ok = bool(torch.equal(got, want))
        phase("probe-vs-plain", kernel="emb_gather", shape=f"N{PEG.N}xV{PEG.V}xD{PEG.D}",
              dtype=dt, bn=PEG.BN, max_abs_err=f"{_max_err([(got, want)]):.3e}",
              tol="bit for bit", ok=ok)
        check(ok, f"emb_gather {dt}: kernel disagrees with tab[ids]")
        errs["emb_gather"] = 0.0
        del ids, tab, got, want
    for shape, sizes in MASK_SIZES.items():
        plain = PMR.masks_plain(PMR.SEED, PMR.KP, device=dev, **sizes)
        fwd = PMR.masks_forward(PMR.SEED, PMR.KP, device=dev, **sizes)
        rev = PMR.masks_reversed(PMR.SEED, PMR.KP, device=dev, **sizes)
        drops = [PMR.drop_fraction(m) for m in fwd]
        for name, got in (("mask_forward", fwd), ("mask_reversed", rev)):
            ok = all(bool(torch.equal(a, b)) for a, b in zip(got, plain))
            phase("probe-vs-plain", kernel=name, shape=shape,
                  sizes="x".join(str(sizes[k]) for k in sizes),
                  max_abs_err=f"{_max_err(list(zip(got, plain))):.3e}", tol="bit for bit",
                  ok=ok)
            check(ok, f"{name} {shape}: kernel disagrees with the plain masks")
            errs[name] = 0.0
        same = all(bool(torch.equal(a, b)) for a, b in zip(fwd, rev))
        ok = all(abs(f - (1 - PMR.KP)) <= DROP_TOL for f in drops)
        phase("probe-vs-plain", kernel="mask_forward=mask_reversed", shape=shape,
              bitwise_equal=same, drop_fractions=repr([round(f, 4) for f in drops]),
              tol=f"|drop - {1 - PMR.KP:.1f}| <= {DROP_TOL}", ok=same and ok)
        check(same, f"mask_forward and mask_reversed drew different masks ({shape})")
        check(ok, f"a mask's drop fraction is off {1 - PMR.KP:.1f} ({shape}): {drops}")
        del plain, fwd, rev
    return errs


def mask_bound(nb, nc, bt, tc, d, ff):
    """(bound ms, integer operations, what bounds it) of the four masks:
    each element written once as fp32, against the integer work the draw
    needs on each pipe at ``PEAK_INT32_OPS``: one Philox4x32-10 call per
    4 elements, ten rounds of two wide multiplies (mul.hi and mul.lo of
    one product, the FMA-heavy pipe) and two three-input xors (the ALU
    pipe), then a compare and a select an element (the ALU pipe): 5 and 7
    operations an element.  The key schedule depends on the seed alone."""
    elems = nb * bt * nc * tc * sum(PMR.widths(d, ff))
    alu, fma = elems * (20 // 4 + 2), elems * 20 // 4
    t_ops, t_bytes = max(alu, fma) / PEAK_INT32_OPS, elems * 4 / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3, alu + fma,
            "operations" if t_ops >= t_bytes else "bytes")


def probe_bounds():
    """(bound ms, what bounds it) of each probe kernel at its default
    shape: unit_overlap's mm_only as 3xTF32 products (x read, out written),
    the vpu_ops mul chain (a multiply and a multiply-add an element-step at
    the fp32 peak; the block read and written), each scan (g and x read, h
    written), the bf16 product (its [N, V] fp32 output written), the bf16
    gather (the int32 ids and the table read, the rows written) and the
    masks (``mask_bound``)."""
    rows = UO_GRID * PUO.ROWS
    n = int(np.prod(PVO.SHAPE))
    uo = _bound(0, (2 * rows * PUO.C + PUO.C * PUO.C) * 4, 0,
                3 * 2 * rows * PUO.C * PUO.C * UO_NM)
    vo = _bound(3 * n * PVO.REPEAT, 2 * n * 4)
    sc = scan_bound_ms(PSC.B, PSC.T, PSC.C)
    ce = _bound(0, (CE_N * CE_V + (CE_N + CE_V) * PCE.D) * 4, 2 * CE_N * CE_V * PCE.D)
    eg = _bound(0, PEG.N * 4 + (PEG.N + PEG.V) * PEG.D * 2)
    mk = mask_bound(**MASK_SIZES["default"])
    return {name: (bd[0], bd[2]) for name, bd in (("unit_overlap", uo), ("vpu_ops", vo),
                                                    ("scan_flat", sc), ("scan_chunk", sc),
                                                    ("ce_mm", ce), ("emb_gather", eg),
                                                    ("mask_forward", mk),
                                                    ("mask_reversed", mk))}


def _mask_argv(sizes):
    return [w for k, v in sizes.items() for w in (f"--{k}", str(v))]


def probe_phases(dev):
    """The probes' entry points at their defaults, as a user runs them
    (``probe-time``): each prints its JAX probe's lines; then unit_overlap
    again at an nv that brings vpu_only within 2x of mm_only, the only
    point where its overlap fraction says anything, and mask_replay_check
    again at the XLong layer's sizes.  Every probe kernel's count is set to
    0 just before and read just after (``probe-launches``).  Then the plain
    versions are timed (``probe-kernel-time``) beside each kernel's time,
    its bound and, for the bf16 product and the gather, the library's
    (``torch.mm``, from ce_mxu's torch-mm line; ``tab[ids]``, the gather's
    plain version too, with ``index_select`` and ``F.embedding`` beside
    it): rows 17a-17d from their runs' own timers, 17e and 17f as medians
    of 20 CUDA-event timings (``time_ms``), the masks also at XLong, and
    the gathers' and default-shape masks' device time (torch.profiler).
    Returns each kernel's row for the kernels JSON."""
    for fn in PROBE_COUNTED.values():
        fn.launches = 0
    uo = PUO.main([])
    nv, bal = UO_NV, uo
    for _ in range(3):
        ratio = bal["ms"]["vpu_only"] / bal["ms"]["mm_only"]
        if bal is not uo and 0.5 <= ratio <= 2.0:
            break
        nv = max(4, 4 * round(nv / ratio / 4))
        bal = PUO.main(["--nv", str(nv)])
    ratio = bal["ms"]["vpu_only"] / bal["ms"]["mm_only"]
    phase("probe-time", probe="unit_overlap", balanced_nv=nv, vpu_over_mm=f"{ratio:.3f}",
          overlap_il=f"{bal['overlap_il']:.3f}", ok=0.5 <= ratio <= 2.0)
    check(0.5 <= ratio <= 2.0, f"unit_overlap: no nv brought vpu_only within 2x of mm_only "
                               f"(last nv {nv}, ratio {ratio:.3f})")
    vo = PVO.main([])
    sc = PSC.main([])
    ce = PCE.main([])
    eg = PEG.main([])
    mr = {shape: PMR.main(_mask_argv(sizes)) for shape, sizes in MASK_SIZES.items()}
    launches = {name: fn.launches for name, fn in PROBE_COUNTED.items()}
    phase("probe-launches", **launches)
    for name, count in launches.items():
        check(count > 0, f"{name}: the probe's entry point launched its kernel no time")
    check(eg["ok"], "emb_gather: the entry point's gather disagrees with tab[ids]")
    for shape, out in mr.items():
        ok = out["ok"] and all(abs(f - (1 - PMR.KP)) <= DROP_TOL for f in out["drop"])
        phase("probe-time", probe="mask_replay_check", shape=shape, bitwise_equal=out["ok"],
              drop_fractions=repr([round(f, 4) for f in out["drop"]]),
              forward_ms=f"{out['ms']['forward']:.4f}",
              reversed_ms=f"{out['ms']['reversed']:.4f}", ok=ok)
        check(ok, f"mask_replay_check {shape}: the orders differ or a drop fraction is off")
    # a vpu_ops call is host-bound (the wrapper's Python and the launch):
    # its device time by op, from torch.profiler over 20 calls each, per
    # kernel the profile holds (a capture can come back short of events)
    x = PVO.inputs(dev)
    dev_us, captured = {}, {}
    for name in PVO.OPS:
        events, _ = profiled(_timed_loop(lambda _, f=PVO.make_fn(name): f(x), 20),
                             ("vpu_op_kernel",))
        kern = [e for e in events if "vpu_op_kernel" in e.key]
        count = sum(e.count for e in kern)
        us = sum(e.self_device_time_total for e in kern)
        dev_us[name] = round(us / count, 3) if count else "not measured"
        captured[name] = count
    phase("probe-device-time", probe="vpu_ops", us_per_call=repr(dev_us),
          kernels_captured=repr(captured))
    del x
    x, x2, w, a, b = PUO.inputs(UO_GRID, dev)
    plain = {"unit_overlap": PB.time_chain(
        lambda xv: PUO.run_plain(xv, x2, w, a, b, "mm_only", UO_NM, UO_NV), x, dev, 5, 1)}
    del x, x2
    x = PVO.inputs(dev)
    plain["vpu_ops"] = PB.time_chain(lambda v: PVO.vpu_chain_plain(v, "mul", PVO.REPEAT), x,
                                     dev, 20, 1)
    g, x = PSC.inputs(dev)
    plain["scan_flat"] = PB.time_calls(lambda: PSC.scan_flat_plain(g, x), dev, 5)
    plain["scan_chunk"] = PB.time_calls(lambda: PSC.scan_chunk_plain(g, x), dev, 5)
    del g, x
    x, table, _, _ = PCE.inputs(CE_N, CE_V, dev)
    plain["ce_mm"] = PB.time_calls(lambda: PCE.mm_plain(x, table), dev, 5)
    del x, table
    bn0 = PCE.DEFAULT_BNS[0]
    ms = {"unit_overlap": uo["ms"]["mm_only"], "vpu_ops": vo["ms"]["mul"],
          "scan_flat": sc["ms"]["flat"], "scan_chunk": sc["ms"]["chunk"],
          "ce_mm": ce[f"cuda-mm bn={bn0}"]}
    # 17e: the gather at the default bn and others, in bf16 and fp32;
    # tab[ids] is both its plain version and the library's call, with
    # PyTorch's two other gathers beside it, each equal to it first
    ids, tab = PEG.inputs(dev)
    ms["emb_gather"] = time_ms(lambda: PEG.gather(ids, tab))
    plain["emb_gather"] = time_ms(lambda: PEG.gather_plain(ids, tab))
    others = {"index_select": lambda t: torch.index_select(t, 0, ids),
              "embedding": lambda t: F.embedding(ids, t)}
    for name, fn in others.items():
        check(bool(torch.equal(fn(tab), PEG.gather_plain(ids, tab))),
              f"{name} disagrees with tab[ids]")
    others_ms = {name: time_ms(lambda fn=fn: fn(tab)) for name, fn in others.items()}
    bn_ms = {bn: time_ms(lambda bn=bn: PEG.gather(ids, tab, bn)) for bn in (1024, 256)}
    tab32 = tab.float()
    f32 = (time_ms(lambda: PEG.gather(ids, tab32)), time_ms(lambda: PEG.gather_plain(ids, tab32)),
           _bound(0, PEG.N * 4 + (PEG.N + PEG.V) * PEG.D * 4)[0])
    del tab32
    # 17f: both mask kernels at both sizes beside the plain masks
    mask_ms, mask_plain = {}, {}
    for shape, sizes in MASK_SIZES.items():
        for name, fn in (("mask_forward", PMR.masks_forward),
                         ("mask_reversed", PMR.masks_reversed)):
            mask_ms[name, shape] = time_ms(lambda fn=fn: fn(PMR.SEED, PMR.KP, device=dev,
                                                             **sizes))
        mask_plain[shape] = time_ms(lambda: PMR.masks_plain(PMR.SEED, PMR.KP, device=dev,
                                                            **sizes), reps=5, warmup=1)
    for name in ("mask_forward", "mask_reversed"):
        ms[name] = mask_ms[name, "default"]
        plain[name] = mask_plain["default"]
    # the default-shape calls are microseconds of device work: their device
    # time from torch.profiler over 20 calls each; PyTorch's gathers by all
    # the device work of a call (every kernel a call launches)
    dev_us = {}
    for name, kern, call in (
            ("emb_gather", "gather_kernel", lambda _: PEG.gather(ids, tab)),
            ("mask_forward", "masks_forward_kernel",
             lambda _: PMR.masks_forward(PMR.SEED, PMR.KP, device=dev)),
            ("mask_reversed", "masks_reversed_kernel",
             lambda _: PMR.masks_reversed(PMR.SEED, PMR.KP, device=dev))):
        events, _ = profiled(_timed_loop(call, 20), (kern,))
        found = [e for e in events if kern in e.key]
        count = sum(e.count for e in found)
        dev_us[name] = (round(sum(e.self_device_time_total for e in found) / count, 3) if count
                        else "not measured")
    # a library call's kernels are each launched once a call: its device
    # time is the sum of their mean times, which a capture short of some
    # launches leaves right (a capture has come back short: the counts of
    # 20 calls are printed beside it)
    lib_dev_us, lib_kernels = {}, {}
    for name, fn in {"tab[ids]": lambda t: PEG.gather_plain(ids, t), **others}.items():
        events, _ = profiled(_timed_loop(lambda _, fn=fn: fn(tab), 20))
        lib_dev_us[name] = (round(sum(e.self_device_time_total / e.count for e in events), 3)
                            if events else "not measured")
        lib_kernels[name] = {e.key[:48]: e.count for e in events}
    phase("probe-device-time", probe="emb_gather, mask_replay_check",
          us_per_call=repr(dev_us), gather_library_us_per_call=repr(lib_dev_us),
          gather_library_kernels=repr(lib_kernels))
    del ids, tab
    xbound = mask_bound(**MASK_SIZES["xlong"])
    extra = {
        "unit_overlap": {"mode": "mm_only", "modes_ms": uo["ms"], "overlap_il": uo["overlap_il"],
                         "balanced": {"nv": nv, "modes_ms": bal["ms"],
                                      "overlap_il": bal["overlap_il"]}},
        "vpu_ops": {"op": "mul", "ops_ms": vo["ms"], "ops_device_us": dev_us},
        "scan_flat": {"row7_linear_scan_ms": sc["ms"]["serial"]},
        "scan_chunk": {"row7_linear_scan_ms": sc["ms"]["serial"]},
        "ce_mm": {"bn": bn0, "bn_ms": {k: v for k, v in ce.items() if k.startswith("cuda-mm")},
                  "library_trio_ms": ce["torch-mm"][1], "fused_ce_ms": ce["fused-ce"],
                  "fused_ce_tile": PCE.ROW13_TILE},
        "emb_gather": {"dtype": "bfloat16", "bn": PEG.BN, "bn_ms": bn_ms,
                       "entry_point_ms": eg["ms"], "entry_point_library_ms": eg["library_ms"],
                       "device_us": dev_us["emb_gather"], "library_device_us": lib_dev_us,
                       "library_kernels": lib_kernels,
                       "other_library_ms": others_ms,
                       "float32": {"ms": f32[0], "library_ms": f32[1], "bound_ms": f32[2]}},
    }
    for name in ("mask_forward", "mask_reversed"):
        order = name.removeprefix("mask_")
        extra[name] = {
            "shape": MASK_SIZES["default"], "device_us": dev_us[name],
            "entry_point_ms": mr["default"]["ms"][order],
            "xlong": {"shape": MASK_SIZES["xlong"], "ms": mask_ms[name, "xlong"],
                      "plain_ms": mask_plain["xlong"], "bound_ms": xbound[0],
                      "bound_by": xbound[2], "entry_point_ms": mr["xlong"]["ms"][order]}}
        x = extra[name]["xlong"]
        phase("probe-kernel-time", kernel=name, shape="xlong", ms=f"{x['ms']:.4f}",
              plain_ms=f"{x['plain_ms']:.4f}", bound_ms=f"{x['bound_ms']:.4f}",
              bound_by=x["bound_by"], int_ops_needed=xbound[1])
    phase("probe-kernel-time", kernel="emb_gather", dtype="float32", ms=f"{f32[0]:.4f}",
          library_ms=f"{f32[1]:.4f}", bound_ms=f"{f32[2]:.5f}", bound_by="bytes",
          bn_ms_bf16=repr({k: round(v, 4) for k, v in bn_ms.items()}),
          other_library_ms_bf16=repr({k: round(v, 4) for k, v in others_ms.items()}))
    library = {"ce_mm": ce["torch-mm"][0], "emb_gather": plain["emb_gather"]}
    rows = {}
    for name, (bound, by) in probe_bounds().items():
        rows[name] = {"launches": launches[name], "ms": ms[name], "plain_ms": plain[name],
                      "bound_ms": bound, "bound_by": by, "library_ms": library.get(name),
                      "extra": extra[name]}
        phase("probe-kernel-time", kernel=name, ms=f"{ms[name]:.4f}",
              plain_ms=f"{plain[name]:.4f}", bound_ms=f"{bound:.5f}", bound_by=by,
              library_ms=library.get(name), launches=launches[name])
    return rows


def row15_row6_digests(dev):
    """The whole calls of rows 15 and 6 as every caller before the seq
    axis makes them (no query chunk, no t0), hashed: row 15 at the d256
    shape (B 2,048, 2 heads of 128, T 200, lengths 0, 1, T and random),
    fp32 and bf16, causal and bidirectional, p 0 and 0.2, the training
    forward's output, fp32 output and lse and the backward's dq, dk and
    dv; row 6 at B 2,048, T 200, D 64, fp32 and bf16, p 0 and 0.5, the
    output, dx, dpos, dscale and dbias.  One ``[digest]`` line each;
    ``chip_compare.py --bits`` holds a tree's digests to another's (a
    parent's: the same bits where the change keeps them)."""
    import hashlib

    def digest(*ts):
        h = hashlib.sha256()
        for a in ts:
            h.update(a.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    gen = torch.Generator().manual_seed(SEED + 46)
    shape = ROW15_SHAPES["d256"]
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[-1]
        q, k, v, dout, lens = _row15_inputs(gen, shape, dev, dt)
        for causal in (True, False):
            for p in (0.0, ROW15_DROPOUT):
                args = (4242, causal, p)
                out, saved = A.fused_attention_train(q, k, v, lens, *args)
                grads = A.fused_attention_bwd(q, k, v, lens, dout, *args, saved=saved)
                phase("digest", kernel="fused_attention", B_H_T_dh="x".join(map(str, shape)),
                      dtype=dname, causal=causal, p=p, sha256=digest(out, *saved))
                phase("digest", kernel="fused_attention_bwd",
                      B_H_T_dh="x".join(map(str, shape)), dtype=dname, causal=causal, p=p,
                      sha256=digest(*grads))
                del out, saved, grads
        del q, k, v, dout
    pos = (0.5 * torch.randn((T, D), generator=gen)).to(dev)
    s = (1 + 0.1 * torch.randn(D, generator=gen)).to(dev)
    bias = (0.1 * torch.randn(D, generator=gen)).to(dev)
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn((TRAIN_B, T, D), generator=gen).to(dev, dt)
        dout = torch.randn((TRAIN_B, T, D), generator=gen).to(dev, dt)
        for p in (0.0, SAS_DROPOUT):
            out = FL.fused_ln_dropout(x, pos, s, bias, p, 7)
            grads = FL.fused_ln_dropout_bwd(x, pos, dout, s, bias, p, 7)
            for name, ts in (("fused_ln_dropout", (out,)), ("fused_ln_dropout_bwd", grads)):
                phase("digest", kernel=name, B=TRAIN_B, T=T, D=D,
                      dtype=str(dt).split(".")[-1], p=p, sha256=digest(*ts))


# the d256 path: SASRec and BERT4Rec at hidden 256, the top of BERT4Rec's
# own d sweep (Sun et al., CIKM 2019: d 16 .. 256 on ML-1M at T 200, FFN
# 4d), which fused_block.supports rejects: 2 heads of 128, FFN 1,024, 2
# layers, gelu, T 200, V 3,417, batch 2,048 (dropout and cloze as the bench
# shape's).  The long path: SASRec at hidden 64, 2 heads, FFN 256 and T
# 2,048 (beyond the whole-layer kernels' T 1,024), one step at batch 32 and
# one request of 8 users, untimed.  Each with the kernels a step can
# launch and those a recommend() can launch (how often: per_op_launches;
# under bf16 row 16 once more)
BASELINE_PATHS = {
    "d256": dict(cfg={"hidden_size": 256, "n_heads": 2, "inner_size": 1024}, t=T,
                 batch=TRAIN_B, users=B, timed=True),
    "long": dict(cfg={"hidden_size": D, "n_heads": 2, "inner_size": 4 * D}, t=2048, batch=32,
                 users=8, timed=False),
    # heads of 264 (above row 15's 256), a prologue above the LN kernel's
    # 512 and an item table above the CE kernels' D 512: the per-op
    # composition without a kernel of its own, in bf16 the table gradient
    # (row 16) in two slices
    "h528": dict(cfg={"hidden_size": 528, "n_heads": 2, "inner_size": 2112}, t=T, batch=32,
                 users=8, timed=False),
}
PATH_COUNTED = {
    "SASRec": (FL.fused_ln_dropout, A.fused_attention, FL.fused_ln_dropout_bwd,
               A.fused_attention_bwd),
    "BERT4Rec": (FL.fused_ln_dropout, A.fused_attention, FCE.fused_softmax_ce,
                 FL.fused_ln_dropout_bwd, A.fused_attention_bwd, FCE.fused_softmax_ce_bwd),
}
PATH_SERVED = (FL.fused_ln_dropout, A.fused_attention)


def per_op_launches(model, counted):
    """How often one step or request of ``model`` on the per-op
    composition launches each of ``counted``, by the gates the models
    take: row 6 once where the width is at most ``MAX_LN_D``, row 15 once
    a layer where ``attention.supports`` the head width, row 13 once where
    ``fused_ce.supports`` the item table."""
    h = model.hidden_size
    ln = int(h <= FL.MAX_LN_D)
    attn = len(model.encoder) * int(A.supports(h // model.n_heads))
    ce = int(FCE.supports(model.n_items, h))
    per = {FL.fused_ln_dropout: ln, FL.fused_ln_dropout_bwd: ln, A.fused_attention: attn,
           A.fused_attention_bwd: attn, FCE.fused_softmax_ce: ce, FCE.fused_softmax_ce_bwd: ce}
    return tuple(per[fn] for fn in counted)
# fp32 gradients of a per-op step against its plain step: only rows 6, 13
# and 15 differ between the two, each an fp32 sum in another order
PATH_GRAD_RTOL = 1e-5
# the per-op composition's kernel wrappers and their plain versions, where
# the models reach them
PATH_TWINS = ((L, "fused_attention", A.fused_attention_plain),
              (L, "fused_ln_dropout", FL.fused_ln_dropout_plain),
              (FCE, "fused_softmax_ce", FCE.fused_softmax_ce_plain))


def plain_per_op_output(model, seq, lens, step=None):
    with plain_kernels(model, PATH_TWINS):
        return model(seq, lens, step=step)


def plain_per_op_loss(model, batch, step):
    with plain_kernels(model, PATH_TWINS):
        return model.calculate_loss(batch, step=step)


def path_config(name, path, dtype_name):
    spec = BASELINE_PATHS[path]
    return Config(model=name, config_dict={
        "MAX_ITEM_LIST_LENGTH": spec["t"], "compute_dtype": dtype_name,
        "train_batch_size": spec["batch"], "seed": SEED, "n_layers": 2, "hidden_act": "gelu",
        **TRAINED[name][2], **spec["cfg"]})


def on_baseline_path(model, path):
    """The model is on the per-op composition at the path's full width."""
    spec = BASELINE_PATHS[path]
    width = (model.hidden_size, model.n_heads, model.inner_size, len(model.encoder),
             model.hidden_act, model.max_seq_len) == (
        spec["cfg"]["hidden_size"], 2, spec["cfg"]["inner_size"], 2, "gelu", spec["t"])
    return width and L._use_fused_attention() and not FB.supports(
        model.hidden_size, model.n_heads, model.inner_size, model.max_seq_len, model.hidden_act)


def path_train_phase(dev, name, path, dtype_name):
    """SASRec or BERT4Rec on a path of the per-op composition: one step of
    the main path with every count at 0 before it (launches, and the step
    against the same step through the plain versions: fp32 gradients
    within 1e-5 of their largest value, bf16 as the other bf16 steps),
    then, on a timed path, the step time, peak memory and a profile."""
    from datamining_recblr_torch.data.synthetic import synthetic_splits
    from datamining_recblr_torch.train.trainer import Trainer

    spec = BASELINE_PATHS[path]
    prefix = f"{name.lower()}-{path}-train"
    cfg = path_config(name, path, dtype_name)
    model = get_model(name)(cfg, N_ITEMS, spec["t"], generator=torch.Generator().manual_seed(SEED))
    counted = PATH_COUNTED[name]
    expected = per_op_launches(model, counted)
    if dtype_name == "bfloat16":
        counted, expected = counted + (E.embedding_grad,), expected + (1,)
    check(on_baseline_path(model, path), f"{name} {path}: not the per-op path at full width")
    trainer = Trainer(cfg, model)
    b = spec["batch"]
    train, _ = synthetic_splits(6040, N_ITEMS, spec["t"], max(8192, 4 * b), seed=SEED)
    data = trainer.device_split(train)
    perm = np.random.default_rng((SEED, 3)).permutation(len(train))
    weight = torch.ones(b, device=dev)

    def batch_of(s):
        idx = perm[(s * b) % len(train):][:b]
        return trainer.gather_batch(data, torch.from_numpy(idx).to(dev), weight)

    bf16 = dtype_name == "bfloat16"
    tol = BF16_RTOL if bf16 else PATH_GRAD_RTOL
    launches, loss, want_loss, loss_err, errs = step_vs_plain(
        model, batch_of(0), counted, plain_per_op_loss, 1e-6, tol)
    tols = {k: ITEM_BF16_RTOL if bf16 and k == "item_embedding" else tol for k in errs}
    worst = max(errs, key=lambda k: errs[k] / tols[k])
    phase(f"{prefix}-step-vs-plain", dtype=dtype_name, batch=b, T=spec["t"],
          D=model.hidden_size, p=repr((model.hidden_dropout_prob, model.attn_dropout_prob)),
          loss=f"{loss:.6f}", plain_loss=f"{want_loss:.6f}", loss_rel_err=f"{loss_err:.3e}",
          loss_tol="1e-4", grad_rel_err_max=f"{max(errs.values()):.3e}", worst_param=worst,
          worst_rel_err=f"{errs[worst]:.3e}", worst_tol=f"{tols[worst]:.3e}",
          grad_tol=f"max|err|/max|plain| <= {tol} (at least 1e-6*max over all grads)"
          + (f", item_embedding {ITEM_BF16_RTOL}" if bf16 else ""), params=len(errs))
    check(np.isfinite(loss), f"{name} {path}: train loss is not finite")
    check(loss_err <= 1e-4, f"{name} {path}: train loss disagrees with the plain step")
    check(all(errs[k] <= tols[k] for k in errs),
          f"{name} {path}: gradients disagree with the plain step")
    phase(f"{prefix}-launches", dtype=dtype_name, steps=1,
          **{fn.__name__: n for fn, n in zip(counted, launches)})
    check(launches == expected, f"{name} {path}: expected launches {expected}, got {launches}")
    out = {"launches": dict(zip((fn.__name__ for fn in counted), launches))}
    if not spec["timed"]:
        return out
    med, lo, hi, peak = time_steps(trainer, batch_of, TRAIN_STEPS)
    phase(f"{prefix}-time", dtype=dtype_name, batch=b, T=spec["t"], steps=TRAIN_STEPS,
          median_ms_per_step=f"{med:.3f}", examples_per_s=f"{b / med * 1e3:.1f}",
          min_ms=f"{lo:.3f}", max_ms=f"{hi:.3f}", peak_device_gb=f"{peak:.3f}")
    train_profile(trainer, batch_of, dtype_name, prefix)
    out.update(ms=med, examples_per_s=b / med * 1e3, peak_gb=peak)
    return out


def dconv_train_phase(dev):
    """RecBLR at the bench shape with d_conv 9 (above the 8 taps the layer
    kernels held before): the whole-layer composition, one launch of each
    of its four kernels, and the step against the plain step (fp32, the
    bench step's tolerance)."""
    from datamining_recblr_torch.data.synthetic import synthetic_splits
    from datamining_recblr_torch.train.trainer import Trainer

    cfg = _train_config("RecBLR", "float32", d_conv=9)
    model = get_model("RecBLR")(cfg, N_ITEMS, T, generator=torch.Generator().manual_seed(SEED))
    check(model.use_fused_layer() and model.d_conv == 9, "RecBLR d_conv 9: not the fused path")
    trainer = Trainer(cfg, model)
    train, _ = synthetic_splits(6040, N_ITEMS, T, TRAIN_B, seed=SEED)
    data = trainer.device_split(train)
    idx = torch.arange(TRAIN_B, device=dev)
    batch = trainer.gather_batch(data, idx, torch.ones(TRAIN_B, device=dev))
    launches, loss, want_loss, loss_err, errs = step_vs_plain(
        model, batch, LAUNCH_COUNTED, plain_ce_loss(plain_seq_output), 0.0, GRAD_RTOL)
    worst = max(errs, key=errs.get)
    phase("dconv9-train-step-vs-plain", dtype="float32", batch=TRAIN_B, T=T, d_conv=9,
          loss=f"{loss:.6f}", plain_loss=f"{want_loss:.6f}", loss_rel_err=f"{loss_err:.3e}",
          grad_rel_err_max=f"{errs[worst]:.3e}", worst_param=worst,
          grad_tol=f"max|err|/max|plain| <= {GRAD_RTOL}",
          **{fn.__name__: n for fn, n in zip(LAUNCH_COUNTED, launches)})
    check(launches == (1,) * len(LAUNCH_COUNTED), f"RecBLR d_conv 9: launches {launches}")
    check(loss_err <= 1e-4 and all(e <= GRAD_RTOL for e in errs.values()),
          "RecBLR d_conv 9: the step disagrees with the plain step")


def _row15_pairs(lens, t, causal, tq=None, q0=0):
    """Per-head (query, key) pairs this data can weigh: keys below the
    length (every key on a row of lens 0), and not after the query when
    causal; the queries q0 .. q0 + tq - 1 (a seq rank's chunk; all T by
    default)."""
    n = _kept_keys(lens, t).double()
    tq = t if tq is None else tq
    if causal:
        rows = torch.arange(q0 + 1, q0 + tq + 1, dtype=torch.float64)
        upto = torch.minimum(n[:, None], rows[None, :]).sum(1)
        pairs = torch.where(lens.clamp(0, t) == 0, n * tq, upto)
    else:
        pairs = n * tq
    return float(pairs.sum())


def row15_bound_ms(lens, shape, causal, act_bytes, priced_fma=False, tq=None, q0=0):
    # QK^T and P.V, 2 dh FLOP each per kept pair, on the tensor cores (dh
    # <= 128): fp32 3xTF32 (three TF32 products each); bf16 QK^T bf16
    # products, P.V two TF32 products (P split, V exact in TF32); with
    # ``priced_fma`` every product at the fp32 FMA peak.  q, k, v read and
    # out written once (q and out at the tq queries of a chunk).
    b, h, t, dh = shape
    tq = t if tq is None else tq
    mm = 2 * dh * h * _row15_pairs(lens, t, causal, tq, q0)
    nbytes = 2 * b * h * (tq + t) * dh * act_bytes
    if priced_fma:
        return _bound(2 * mm, nbytes)
    if act_bytes == 2:
        return _bound(0, nbytes, mm, 2 * mm)
    return _bound(0, nbytes, 0, 6 * mm)


def row15_bwd_bound_ms(lens, shape, causal, act_bytes, priced_fma=False, tq=None, q0=0):
    # S again and dP (bf16 products in bf16), dV, dK and dQ (P or dS split
    # against an operand: two TF32 products in bf16), 2 dh FLOP each per
    # kept pair; fp32 3xTF32 throughout; with ``priced_fma`` at the fp32
    # FMA peak.  q, k, v, dout and the fp32 output read, the lse read, dq,
    # dk, dv written (q, dout, the output, the lse and dq at the tq
    # queries of a chunk, k, v, dk and dv at all T keys).
    b, h, t, dh = shape
    tq = t if tq is None else tq
    mm = 2 * dh * h * _row15_pairs(lens, t, causal, tq, q0)
    nbytes = b * h * (tq * (dh * (3 * act_bytes + 4) + 4) + 4 * t * dh * act_bytes)
    if priced_fma:
        return _bound(5 * mm, nbytes)
    if act_bytes == 2:
        return _bound(0, nbytes, 2 * mm, 6 * mm)
    return _bound(0, nbytes, 0, 15 * mm)


def row15_kernel_times(dev):
    """Row 15 at the d256 shape, causal (SASRec) and bidirectional
    (BERT4Rec), p = 0 (and the causal forward at p 0.5, SASRec's rate), fp32
    and bf16: each beside its bound (the tensor cores' products at their
    rate, the FMA-priced bound beside it), its plain version (the
    backward's: autograd of the plain forward, its graph built once) and
    one PyTorch call of the same function, ``F.scaled_dot_product_attention``
    with the same additive mask (in bf16 for bf16 q: the mask and the call
    in bf16), first checked against the plain version: fp32 within 1e-4 of
    its largest value; bf16 within 2^-5 of it (the library rounds the
    probabilities to bf16 before P V, the kernel keeps them fp32)."""
    gen = torch.Generator().manual_seed(SEED + 42)
    shape = ROW15_SHAPES["d256"]
    t = shape[2]
    q32, k32, v32, dout32, _ = _row15_inputs(gen, shape, dev, torch.float32)
    # the bench data's lengths, 2 .. T
    lens = torch.randint(2, t + 1, (shape[0],), generator=gen).to(dev)
    bwd_lens = lens.cpu()
    rows = {}
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[-1]
        q, k, v, dout = (a.to(dt) for a in (q32, k32, v32, dout32))
        for causal in (True, False):
            args = (lens, 4242, causal, 0.0)
            mask = FB.attention_mask(lens, t, causal, dev)[:, None].to(dt)
            leaves = [a.clone().requires_grad_() for a in (q, k, v)]
            want = A.fused_attention_plain(*leaves, *args)
            lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
            lib_err = float((lib_out.float() - want.float()).detach().abs().max())
            tol = (2.0 ** -5 if dt == torch.bfloat16 else 1e-4) * float(
                want.detach().float().abs().max())
            phase("library-vs-plain",
                  call="F.scaled_dot_product_attention(attn_mask=-10000 mask)",
                  B_H_T_dh="x".join(map(str, shape)), causal=causal, dtype=dname,
                  max_abs_err=f"{lib_err:.3e}", tol=f"{tol:.3e}", ok=lib_err <= tol)
            check(lib_err <= tol, "scaled_dot_product_attention does not compute row 15's "
                                  "function")
            _, saved = A.fused_attention_train(q, k, v, *args)
            with torch.no_grad():
                ms = time_ms(lambda: A.fused_attention(q, k, v, *args))
                plain = time_ms(lambda: A.fused_attention_plain(q, k, v, *args), reps=5,
                                warmup=1)
                lib = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
            ms_bwd = time_ms(lambda: A.fused_attention_bwd(q, k, v, lens, dout, 4242, causal,
                                                           0.0, saved=saved))
            plain_bwd = time_ms(lambda: torch.autograd.grad(want, leaves, dout,
                                                            retain_graph=True),
                                reps=5, warmup=1)
            lib_bwd = time_ms(lambda: torch.autograd.grad(lib_out, leaves, dout,
                                                          retain_graph=True))
            size = q.element_size()
            for name, t_ms, t_plain, t_lib, bnd, fma in (
                    ("fused_attention", ms, plain, lib,
                     row15_bound_ms(bwd_lens, shape, causal, size),
                     row15_bound_ms(bwd_lens, shape, causal, size, priced_fma=True)),
                    ("fused_attention_bwd", ms_bwd, plain_bwd, lib_bwd,
                     row15_bwd_bound_ms(bwd_lens, shape, causal, size),
                     row15_bwd_bound_ms(bwd_lens, shape, causal, size, priced_fma=True))):
                bound, flops, by = bnd
                phase("kernel-time", kernel=name, B_H_T_dh="x".join(map(str, shape)),
                      causal=causal, dtype=dname, p=0.0, ms=f"{t_ms:.4f}",
                      plain_ms=f"{t_plain:.4f}", library_ms=f"{t_lib:.4f}",
                      bound_ms=f"{bound:.5f}", gflop=f"{flops / 1e9:.3f}", bound_by=by,
                      share_of_bound=f"{bound / t_ms:.4f}", fma_bound_ms=f"{fma[0]:.5f}")
                if causal and dt == torch.float32:
                    rows[name] = (t_ms, t_plain, bound, by, t_lib)
            if causal:
                with torch.no_grad():
                    ms_p = time_ms(lambda: A.fused_attention(q, k, v, lens, 4242, True,
                                                             SAS_DROPOUT))
                phase("kernel-time", kernel="fused_attention",
                      B_H_T_dh="x".join(map(str, shape)), causal=True, dtype=dname,
                      p=SAS_DROPOUT, ms=f"{ms_p:.4f}")
            del leaves, want, lib_out, saved
    return rows


# row 15 by launch: the training forward, and the backward's three
ROW15_PHASES = {"fused_attention": (("fwd", "attn_fwd_mma_kernel"),),
                "fused_attention_bwd": (("delta", "delta_kernel"), ("dkdv", "dkdv_mma_kernel"),
                                        ("dq", "dq_mma_kernel"))}


def row15_phase_times(dev, calls=10):
    """Row 15 at the d256 shape (lengths 2 .. T, p 0.2), causal and
    bidirectional, fp32 and bf16: the training forward's and the backward's
    CUDA-event time beside each launch's device time per call, from
    torch.profiler over ``calls`` calls; the blocks an SM holds of each
    tensor-core kernel at dh 128; and the kernels that
    ``F.scaled_dot_product_attention``'s forward and backward launch (the
    library call of the kernel-time rows), by device time."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator().manual_seed(SEED + 43)
    shape = ROW15_SHAPES["d256"]
    b, h, t, dh = shape
    q32, k32, v32, dout32, _ = _row15_inputs(gen, shape, dev, torch.float32)
    lens = torch.randint(2, t + 1, (b,), generator=gen).to(dev)
    fwd_lib = _cuda.library("attention.cu")
    bwd_lib = _cuda.library("attention_bwd.cu")
    for bf16 in (0, 1):
        phase("occupancy", kernel="row 15", dh=dh, dtype="bfloat16" if bf16 else "float32",
              blocks_per_sm_fwd=fwd_lib.recblr_attn_fwd_blocks_per_sm(dh, bf16, dev.index),
              blocks_per_sm_dkdv=bwd_lib.recblr_attn_bwd_blocks_per_sm(dh, bf16, 0, dev.index),
              blocks_per_sm_dq=bwd_lib.recblr_attn_bwd_blocks_per_sm(dh, bf16, 1, dev.index))
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, dout = (a.to(dt) for a in (q32, k32, v32, dout32))
        for causal in (True, False):
            args = (lens, 4242, causal, ROW15_DROPOUT)
            _, saved = A.fused_attention_train(q, k, v, *args)
            for name, call in (
                    ("fused_attention", lambda: A.fused_attention_train(q, k, v, *args)),
                    ("fused_attention_bwd", lambda: A.fused_attention_bwd(
                        q, k, v, lens, dout, *args[1:], saved=saved))):
                phase("kernel-time-phase", kernel=name, B_H_T_dh="x".join(map(str, shape)),
                      causal=causal, dtype=str(dt).split(".")[-1], p=ROW15_DROPOUT,
                      **_phase_times(call, ROW15_PHASES[name], calls))
            del saved
    q, k, v = (a.clone().requires_grad_() for a in (q32, k32, v32))
    mask = FB.attention_mask(lens, t, True, dev)[:, None]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
            torch.autograd.grad(out, [q, k, v], dout32)
        torch.cuda.synchronize()
    dev_us = sorted(((e.self_device_time_total, e.key) for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA), reverse=True)
    for us, key in dev_us[:4]:
        phase("library-kernels", call="F.scaled_dot_product_attention fwd + bwd, fp32, causal",
              kernel=repr(key[:120]), device_ms_per_call=f"{us / calls / 1e3:.4f}")


KERNELS = (
    ("fused_recurrent_layer", "datamining_recblr_torch/csrc/fused_layer.cu",
     "datamining_recblr_tpu/ops/fused_layer.py:245"),
    ("fused_recurrent_layer_last", "datamining_recblr_torch/csrc/fused_layer_last.cu",
     "datamining_recblr_tpu/ops/fused_layer.py:826"),
    ("fused_recurrent_layer_bwd", "datamining_recblr_torch/csrc/fused_layer_bwd.cu",
     "datamining_recblr_tpu/ops/fused_layer.py:419"),
    ("fused_recurrent_layer_last_bwd", "datamining_recblr_torch/csrc/fused_layer_last_bwd.cu",
     "datamining_recblr_tpu/ops/fused_layer.py:844"),
)
XLONG_KERNELS = (
    ("fused_recurrent_layer_chunked", "datamining_recblr_torch/csrc/fused_layer_chunked.cu",
     "datamining_recblr_tpu/ops/fused_layer_chunked.py:118"),
    ("fused_recurrent_layer_chunked_bwd",
     "datamining_recblr_torch/csrc/fused_layer_chunked_bwd.cu",
     "datamining_recblr_tpu/ops/fused_layer_chunked.py:192"),
    ("fused_softmax_ce_chunked", "datamining_recblr_torch/csrc/fused_ce_chunked.cu",
     "datamining_recblr_tpu/ops/fused_ce.py:296"),
    ("fused_softmax_ce_chunked_bwd", "datamining_recblr_torch/csrc/fused_ce_chunked.cu",
     "datamining_recblr_tpu/ops/fused_ce.py:327"),
    ("embedding_grad", "datamining_recblr_torch/csrc/emb_grad.cu",
     "datamining_recblr_tpu/ops/embedding.py:62"),
)
SHORT_DTYPE = {"float32": "fp32", "bfloat16": "bf16"}
ATTN_KERNELS = (
    ("fused_ln_dropout", "datamining_recblr_torch/csrc/ln_dropout.cu",
     "datamining_recblr_tpu/ops/fused_layer.py:1292"),
    ("fused_transformer_layer", "datamining_recblr_torch/csrc/fused_block.cu",
     "datamining_recblr_tpu/ops/fused_block.py:260"),
    ("fused_transformer_layer_last", "datamining_recblr_torch/csrc/fused_block_last.cu",
     "datamining_recblr_tpu/ops/fused_block.py:637"),
    ("fused_ln_dropout_bwd", "datamining_recblr_torch/csrc/ln_dropout.cu",
     "datamining_recblr_tpu/ops/fused_layer.py:1303"),
    ("fused_transformer_layer_bwd", "datamining_recblr_torch/csrc/fused_block_bwd.cu",
     "datamining_recblr_tpu/ops/fused_block.py:284"),
    ("fused_transformer_layer_last_bwd", "datamining_recblr_torch/csrc/fused_block_last_bwd.cu",
     "datamining_recblr_tpu/ops/fused_block.py:655"),
)
SLICE_KERNELS = (  # name, source, TPU kernel, the path whose step counts its launches
    ("fused_dropout_ln", "datamining_recblr_torch/csrc/ln_dropout.cu",
     "datamining_recblr_tpu/ops/fused_layer.py:1217", "onelayer"),
    ("fused_dropout_ln_bwd", "datamining_recblr_torch/csrc/ln_dropout.cu",
     "datamining_recblr_tpu/ops/fused_layer.py:1242", "onelayer"),
    ("linear_scan", "datamining_recblr_torch/csrc/linear_scan.cu",
     "datamining_recblr_tpu/ops/pallas_scan.py:110", "wide"),
    ("linear_scan_reverse", "datamining_recblr_torch/csrc/linear_scan.cu",
     "datamining_recblr_tpu/ops/pallas_scan.py:110", "wide"),
    ("fused_bdlru", "datamining_recblr_torch/csrc/fused_bdlru.cu",
     "datamining_recblr_tpu/ops/fused_bdlru.py:253", "longodd"),
    ("fused_bdlru_bwd", "datamining_recblr_torch/csrc/fused_bdlru_bwd.cu",
     "datamining_recblr_tpu/ops/fused_bdlru.py:280", "longodd"),
)
ROW15_KERNELS = (
    ("fused_attention", "datamining_recblr_torch/csrc/attention.cu",
     "datamining_recblr_tpu/ops/attention.py:167"),
    ("fused_attention_bwd", "datamining_recblr_torch/csrc/attention_bwd.cu",
     "datamining_recblr_tpu/ops/attention.py:191"),
)
# queue B row 17a-17f: the probes' kernels (probes/), name, source, TPU
# kernel (the function that reaches its pallas_call)
PROBE_KERNELS = (
    ("unit_overlap", "datamining_recblr_torch/csrc/probe_unit_overlap.cu",
     "benchmarks/unit_overlap.py:114"),
    ("vpu_ops", "datamining_recblr_torch/csrc/probe_vpu_ops.cu", "benchmarks/vpu_ops.py:40"),
    ("scan_flat", "datamining_recblr_torch/csrc/probe_scan_chunked.cu",
     "benchmarks/scan_chunked.py:79"),
    ("scan_chunk", "datamining_recblr_torch/csrc/probe_scan_chunked.cu",
     "benchmarks/scan_chunked.py:79"),
    ("ce_mm", "datamining_recblr_torch/csrc/probe_ce_mxu.cu", "benchmarks/ce_mxu.py:106"),
    ("emb_gather", "datamining_recblr_torch/csrc/probe_emb_gather.cu",
     "benchmarks/emb_gather.py:36"),
    ("mask_forward", "datamining_recblr_torch/csrc/probe_mask_replay_check.cu",
     "benchmarks/mask_replay_check.py:56"),
    ("mask_reversed", "datamining_recblr_torch/csrc/probe_mask_replay_check.cu",
     "benchmarks/mask_replay_check.py:56"),
)
B4R_KERNELS = (
    ("fused_transformer_layer_sel", "datamining_recblr_torch/csrc/fused_block_sel.cu",
     "datamining_recblr_tpu/ops/fused_block.py:968"),
    ("fused_softmax_ce", "datamining_recblr_torch/csrc/fused_ce.cu",
     "datamining_recblr_tpu/ops/fused_ce.py:84"),
    ("fused_transformer_layer_sel_bwd", "datamining_recblr_torch/csrc/fused_block_sel_bwd.cu",
     "datamining_recblr_tpu/ops/fused_block.py:995"),
    ("fused_softmax_ce_bwd", "datamining_recblr_torch/csrc/fused_ce.cu",
     "datamining_recblr_tpu/ops/fused_ce.py:99"),
)


# ---------------------------------------------------------------------------
# the meshed path (parallel/) on the one card: NCCL at world size 1, then a
# {data: 2, model: 2} mesh as four gloo ranks sharing the card
# ---------------------------------------------------------------------------

MESH = {"data": 2, "model": 2}
MESH_STEPS = 3
MESH_EVAL_B = 2048    # one full-sort eval batch of RecBLR (1,024 rows a data rank)
MESH_USERS = 256      # recommend() requests through sharded_topk
MESH_UNI_ROWS = 2048  # the BPR case's uni100 evaluation rows (eval batch 1,024)
# each case: the model and its config (on top of the bench config at p 0),
# the shape (T, V, global batch), the train steps, the kernels it counts
# with their launches a rank makes a step, and what it checks after the
# steps; the single-process reference runs the same config unmeshed from
# the same seed on the same batches
MESH_CASES = {
    "recblr": dict(
        model="RecBLR", cfg={"vocab_row_shard": "always"}, t=T, v=N_ITEMS, b=TRAIN_B,
        steps=MESH_STEPS, counted=LAUNCH_COUNTED, per_step=(1, 1, 1, 1), after=(2, 2, 0, 0),
        sharded=True, check=("eval", "serve")),
    "sasrec": dict(
        model="SASRec", cfg={}, t=T, v=N_ITEMS, b=TRAIN_B, steps=2, counted=SAS_COUNTED,
        per_step=(1,) * 6, after=(0,) * 6, sharded=False, check=()),
    "bert4rec": dict(
        model="BERT4Rec", cfg={}, t=T, v=N_ITEMS, b=TRAIN_B, steps=2, counted=B4R_COUNTED,
        per_step=(1,) * 8, after=(0,) * 8, sharded=False, check=()),
    "bpr-uni100": dict(
        model="RecBLR", cfg={"vocab_row_shard": "always", "loss_type": "BPR",
                             "eval_args": {"mode": "uni100"}, "eval_batch_size": 1024},
        t=T, v=N_ITEMS, b=TRAIN_B, steps=2, counted=LAUNCH_COUNTED + (E.embedding_grad,),
        per_step=(1, 1, 1, 1, 1), after=(2, 2, 0, 0, 0), sharded=True, check=("sampled",)),
    # XLong's own config (bf16, T 1,024, batch 512, V 329,722) under auto:
    # 329,728 x 64 rows row-shard; the vocab-parallel CE takes row 14's place
    "xlong": dict(
        model="RecBLR", cfg={"compute_dtype": "bfloat16", "train_batch_size": XB}, t=XT, v=XV,
        b=XB, steps=1, counted=XLONG_COUNTED + (E.embedding_grad,),
        per_step=(1, 1, 0, 0, 1, 1, 1), after=(0,) * 7, sharded=True, check=("emb-grad",)),
}
MESH_LOSS_RTOL = {"float32": 1e-5, "bfloat16": 1e-4}
# the first step's gradients (the sharded ones gathered) against the single
# process's, as step_vs_plain: max |mesh - single| of each parameter within
# this share of its largest single-process value, or within 1e-6 of the
# largest gradient of all.  fp32 runs the same kernels on both sides; in
# bf16 the single process's CE is row 14, which rounds its softmax
# cotangent to bf16, and the mesh's the fp32 vocab-parallel CE, and a
# bf16 value summed over the ranks is rounded once a rank (2^-8 of it
# each, up to two a side).  A half batch, a missing shard or a gradient
# divided by a rank's own weights is off by O(1) of the largest value.
MESH_GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the parameters after the steps: the share of each parameter's entries
# whose update (final - initial) differs from the single process's by
# more than half the learning rate (Adam moves an entry about lr a step,
# so a sign flip or a missed update is about lr); the share of entries
# whose near-zero gradient may flip sign on rounding is far below it
MESH_PARAM_SHARE = {"float32": 1e-3, "bfloat16": 1e-2}
# a meshed Trainer.fit (resident and stream input) against the unmeshed
# fit: RecBLR at the bench widths (fp32, p 0, table row-sharded) on a
# small synthetic log, EPOCHS epochs with validation, the best
# checkpoint's test metrics; records at the CPU tests' trajectory
# tolerance (rtol 2e-4, atol 5e-5)
MESH_FIT = {"n_users": 600, "min_len": 5, "max_len": 40, "epochs": 2, "eval_batch_size": 1024}


def _spec(case):
    return MESH_CASES[case] if case in MESH_CASES else SEQ_CASES[case]


@contextlib.contextmanager
def _per_op(model):
    """``model`` held to the per-op composition a ``seq`` axis runs, at any
    shape, while the context is open: RecBLR's ``_gated_recurrent`` (row 7
    in each layer; there an empty request reads position T-1, where the
    fused kernels select nothing), the attention models' per-op layers with
    row 15 for the masked softmax (``fused_block.supports`` refuses every
    shape; an empty request reads position 0, where the fused top layer
    reads another)."""
    if isinstance(model, RB.RecBLR):
        model.use_fused_layer = model.use_chunked_layer = model.use_fused_bdlru = lambda: False
        yield model
        return
    keep = FB.supports
    FB.supports = lambda *a, **k: False
    try:
        yield model
    finally:
        FB.supports = keep


def _mesh_config(case, meshed):
    spec = _spec(case)
    extra = dict(spec["cfg"])
    if spec["model"] == "RecBLR":
        extra.setdefault("dropout_prob", 0.0)
    else:
        extra.update(hidden_dropout_prob=0.0, attn_dropout_prob=0.0)
    if spec["t"] == XT:
        extra.update(MAX_ITEM_LIST_LENGTH=XT, hidden_size=D, num_layers=2, expand=2, d_conv=K)
    if meshed:
        extra["mesh_shape"] = spec.get("mesh", MESH)
    return _train_config(spec["model"], extra.pop("compute_dtype", "float32"), **extra)


def _mesh_batches(case):
    """The case's global training batches as numpy (the same in every
    process): rows of ``synthetic_splits`` in a seeded order, the last 5
    rows of each at weight 0 (all on the last data rank), BPR's negatives
    drawn uniformly."""
    from datamining_recblr_torch.data.synthetic import synthetic_splits

    spec = _spec(case)
    t, v, b = spec["t"], spec["v"], spec["b"]
    n = b * spec["steps"] if t == XT else max(b * spec["steps"], 8 * MESH_UNI_ROWS)
    train, valid = synthetic_splits(6040 if t == T else 5000, v, t, n, seed=SEED)
    if t == XT:  # the xlong-synth histories are at most 1,000 long
        for split in (train, valid):
            split.item_seq_len[:] = np.minimum(split.item_seq_len, XMAX_LEN)
            split.item_seq[:, XMAX_LEN:] = 0
    rng = np.random.default_rng((SEED, 21))
    perm = rng.permutation(len(train))
    weight = np.ones(b, np.float32)
    weight[-5:] = 0.0
    batches = []
    for s in range(spec["steps"]):
        idx = perm[s * b:(s + 1) * b]
        batch = {"item_seq": train.item_seq[idx], "item_seq_len": train.item_seq_len[idx],
                 "pos_item": train.pos_item[idx], "weight": weight}
        if spec["cfg"].get("loss_type") == "BPR":
            batch["neg_item"] = rng.integers(1, v, b).astype(np.int32)
        batches.append(batch)
    return batches, valid


def _mesh_eval_batch(n):
    from datamining_recblr_torch.data.synthetic import synthetic_splits

    split, _ = synthetic_splits(6040, N_ITEMS, T, n, seed=SEED + 5)
    return {"item_seq": split.item_seq[:n], "item_seq_len": split.item_seq_len[:n],
            "pos_item": split.pos_item[:n]}


def _to(dev, batch, rows=slice(None)):
    return {k: torch.from_numpy(np.ascontiguousarray(v[rows])).to(dev) for k, v in batch.items()}


def _eval_ranks(model, batch, dev):
    """(ranks, scores) of one full-sort batch: this rank's columns on a
    mesh, where the ranks are reduced over ``model``."""
    from datamining_recblr_torch.eval.metrics import mask_scores, target_ranks

    lo, _ = model.score_cols()
    model.eval()
    with torch.no_grad():
        put = _to(dev, batch)
        scores = mask_scores(model.full_sort_scores(put["item_seq"], put["item_seq_len"]),
                             col0=lo)
        ranks = target_ranks(scores, put["pos_item"], col0=lo, mesh=model.score_mesh())
    return ranks.cpu(), scores.cpu()


def _full_grads(model):
    """Every parameter's gradient on the CPU, a sharded one gathered over
    ``model`` (a collective on a mesh), the vocab-leading rows cut to an
    unmeshed model's padding (as ``gather_state``)."""
    from datamining_recblr_torch.parallel.collectives import all_gather
    from datamining_recblr_torch.parallel.mesh import MODEL_AXIS

    cut = {name: model.pad_vocab_rows(n, meshed=False) for name, n in model.vocab_rows().items()}
    out = {}
    for name, p in model.named_parameters():
        if p.grad is None:
            continue
        g = all_gather(p.grad, model.mesh, MODEL_AXIS) if name in model.shards else p.grad
        out[name] = (g[: cut[name]] if name in cut else g).detach().cpu().clone()
    return out


def _mesh_drive(dev, case, meshed, params=None, per_op=False):
    """One case in this process (a rank of the mesh, or the single-process
    reference): the steps' losses, the first step's gradients
    (``_full_grads``), the parameters before (reference) and after the
    steps (gathered on a mesh), the kernels' launches from just before
    the first step to the end of the checks, the wall seconds (without
    the copies of gradients and parameters), and the checks' outputs; the
    reference evaluates with ``params`` (the meshed run's final
    parameters) where given, so the checks hold the meshed evaluation and
    serving to the single process's on the same parameters.  A rank of
    the XLong case then holds row 16 against its plain version at its
    shard and on its rows' ids (``emb_grad_check``), uncounted; a seq
    rank of it at the whole table on its time chunk's ids.  With
    ``per_op`` the single process runs the seq axis's composition
    (``_per_op``)."""
    spec = _spec(case)
    cfg = _mesh_config(case, meshed)
    model = get_model(spec["model"])(cfg, spec["v"], spec["t"], device=dev,
                                     generator=torch.Generator().manual_seed(SEED))
    with _per_op(model) if per_op else contextlib.nullcontext():
        return _drive(dev, case, spec, cfg, model, params)


def _drive(dev, case, spec, cfg, model, params):
    """``_mesh_drive``'s run of ``model``."""
    from datamining_recblr_torch.eval.evaluator import Evaluator
    from datamining_recblr_torch.parallel.input import process_local_rows, seq_chunk
    from datamining_recblr_torch.parallel.sharding import gather_state
    from datamining_recblr_torch.train.trainer import Trainer

    trainer = Trainer(cfg, model)
    mesh = trainer.mesh
    meshed = mesh is not None
    batches, valid = _mesh_batches(case)
    lo, hi = process_local_rows(spec["b"], mesh)
    out = {"shards": dict(model.shards), "lr": float(cfg["learning_rate"]),
           "init": None if meshed else {k: v.detach().cpu().clone()
                                        for k, v in model.state_dict().items()}}
    for fn in spec["counted"]:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    copy_s = 0.0
    out["losses"] = []
    for s, bt in enumerate(batches):
        out["losses"].append(float(trainer.train_step(_to(dev, bt, slice(lo, hi)), s)))
        if s == 0:
            t1 = time.perf_counter()
            out["grads"] = _full_grads(model)
            copy_s += time.perf_counter() - t1
    t1 = time.perf_counter()
    out["params"] = (gather_state(model)[0] if mesh is not None else
                     {k: v.detach().cpu().clone() for k, v in model.state_dict().items()})
    copy_s += time.perf_counter() - t1
    if params is not None:
        model.load_state_dict(params)
    if "eval" in spec["check"]:
        eb = _mesh_eval_batch(MESH_EVAL_B)
        elo, ehi = process_local_rows(MESH_EVAL_B, mesh)
        out["ranks"], out["scores"] = _eval_ranks(
            model, {k: v[elo:ehi] for k, v in eb.items()}, dev)
    if "serve" in spec["check"]:
        users = requests(np.random.default_rng(SEED + 6), MESH_USERS)
        out["ids"], out["vals"] = Recommender(model, top_k=TOP_K, mesh=mesh).recommend(users)
    if "sampled" in spec["check"]:
        out["sampled"] = Evaluator(model, cfg, mesh=mesh).evaluate(
            valid.take(np.arange(MESH_UNI_ROWS)))
    torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t0 - copy_s
    out["launches"] = {fn.__name__: fn.launches for fn in spec["counted"]}
    if "emb-grad" in spec["check"] and mesh is not None:
        # the lookup's input to row 16 on this rank (models/base.py
        # sharded_rows): the ids it holds as local rows, the others at
        # local row 0 with a zero cotangent
        ids = batches[0]["item_seq"][lo:hi]
        if model.seq_shards() > 1:
            ids = ids[:, slice(*seq_chunk(spec["t"], mesh))]
        ids = torch.from_numpy(np.ascontiguousarray(ids)).to(dev).long()
        row0, row1 = model.shards.get("item_embedding", (0, model.item_embedding.shape[0]))
        local = ids - row0
        own = (local >= 0) & (local < row1 - row0)
        gen = torch.Generator().manual_seed(SEED + 21 + dist_rank())
        g = torch.randn((*ids.shape, D), generator=gen).to(dev, torch.bfloat16)
        g = torch.where(own[..., None], g, torch.zeros((), device=dev, dtype=g.dtype))
        tag = "mesh" if case in MESH_CASES else case
        out["emb_grad_err"] = emb_grad_check(
            f"{tag}-emb-grad-kernel-vs-plain-rank{dist_rank()}",
            torch.where(own, local, torch.zeros_like(local)), g, row1 - row0)
        out["emb_grad_own_share"] = float(own.float().mean())
    return out


def dist_rank():
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _mesh_fit(dev, ckpt_dir, mesh_input=None):
    """``Trainer.fit`` as MESH_FIT says, then ``trainer.evaluate(test,
    load_best=True)`` (on a mesh: rank 0 writes the gathered checkpoint,
    every rank re-shards it); ``mesh_input`` None runs unmeshed.  Returns
    the epoch records (train loss, valid score), the test metrics, the
    best epoch, the launches and the wall seconds."""
    from datamining_recblr_torch.data.dataset import build_from_dataframe
    from datamining_recblr_torch.data.synthetic import generate_synthetic_interactions
    from datamining_recblr_torch.train.trainer import Trainer

    data = build_from_dataframe(generate_synthetic_interactions(
        n_users=MESH_FIT["n_users"], n_items=N_ITEMS, min_len=MESH_FIT["min_len"],
        max_len=MESH_FIT["max_len"], seed=SEED), max_seq_len=T)
    extra = dict(dropout_prob=0.0, vocab_row_shard="always", epochs=MESH_FIT["epochs"],
                 eval_batch_size=MESH_FIT["eval_batch_size"], checkpoint_dir=ckpt_dir)
    if mesh_input is not None:
        extra.update(mesh_shape=MESH, mesh_input=mesh_input)
    cfg = _train_config("RecBLR", "float32", **extra)
    model = get_model("RecBLR")(cfg, data.n_items, T, device=dev,
                                generator=torch.Generator().manual_seed(SEED))
    trainer = Trainer(cfg, model)
    for fn in LAUNCH_COUNTED:
        fn.launches = 0
    t0 = time.perf_counter()
    trainer.fit(data, checkpoint_path=f"{ckpt_dir}/fit-{mesh_input or 'single'}")
    test = trainer.evaluate(data.test, load_best=True)
    torch.cuda.synchronize()
    return {"records": [(float(r["train_loss"]), float(r["valid_score"]))
                        for r in trainer.metrics.epoch_records()],
            "test": test, "best_epoch": trainer.best_epoch, "shards": dict(model.shards),
            "launches": {fn.__name__: fn.launches for fn in LAUNCH_COUNTED},
            "wall_s": time.perf_counter() - t0, "n_train": len(data.train),
            "n_items": data.n_items}


def _gloo_collectives(dev):
    """The collectives the port calls, on CUDA tensors over the four gloo
    ranks: all_reduce (sum, max) in fp32, bf16 and int64, all_gather in
    int32, int64 and fp32, broadcast and barrier; True where each gave
    the expected values."""
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    got = {}
    for dt in (torch.float32, torch.bfloat16, torch.int64):
        for op, want in (("sum", world * (world + 1) // 2), ("max", world)):
            x = torch.full((5,), rank + 1, device=dev, dtype=dt)
            dist.all_reduce(x, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX)
            got[f"all_reduce_{op}_{str(dt)[6:]}"] = bool((x == want).all())
    for dt in (torch.int32, torch.int64, torch.float32):
        x = torch.full((3,), rank, device=dev, dtype=dt)
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        got[f"all_gather_{str(dt)[6:]}"] = bool(
            (torch.cat(parts).cpu() == torch.arange(world).repeat_interleave(3).to(dt)).all())
    x = torch.full((2,), float(rank), device=dev)
    dist.broadcast(x, 1)
    got["broadcast"] = bool((x == 1).all())
    dist.barrier()
    got["barrier"] = True
    return got


def _mesh_rank(rank, world, port, out_dir, device):
    """One rank of the four-rank run (a process of ``mesh_phases``) on
    ``device``: every case in order, then the fits, its results saved for
    the parent."""
    import torch.distributed as dist

    dev = torch.device(device)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        out = {"collectives": _gloo_collectives(dev)}
        for case in MESH_CASES:
            out[case] = _mesh_drive(dev, case, meshed=True)
            if rank:  # the gathered tensors are the same on every rank
                out[case].pop("grads")
                out[case].pop("params")
        for mode in ("resident", "stream"):
            out[f"fit-{mode}"] = _mesh_fit(dev, out_dir, mode)
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def mesh_nccl_phase(dev, smi, steps=10):
    """(a) RecBLR at the bench shape (fp32, p 0) through the meshed Trainer
    at {data: 1, model: 1} on an NCCL group of one rank, against the
    unmeshed Trainer from the same seed on the same batches: MESH_STEPS
    losses (rel err <= 1e-6), each step's launches, and both step times."""
    import torch.distributed as dist

    from datamining_recblr_torch.data.synthetic import synthetic_splits
    from datamining_recblr_torch.train.trainer import Trainer

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}", rank=0,
                            world_size=1, device_id=dev)
    try:
        train, _ = synthetic_splits(6040, N_ITEMS, T, 8192, seed=SEED)
        perm = np.random.default_rng((SEED, 0)).permutation(len(train))
        out = {}
        for tag, extra in (("unmeshed", {}), ("meshed", {"mesh_shape": {"data": 1, "model": 1}})):
            cfg = _train_config("RecBLR", "float32", dropout_prob=0.0, **extra)
            model = get_model("RecBLR")(cfg, N_ITEMS, T,
                                        generator=torch.Generator().manual_seed(SEED))
            trainer = Trainer(cfg, model)
            check((trainer.mesh is not None) == (tag == "meshed"), f"mesh-nccl: {tag} trainer")
            data = trainer.device_split(train)
            weight = torch.ones(TRAIN_B, device=dev)

            def batch_of(s, trainer=trainer, data=data, weight=weight):
                idx = perm[(s * TRAIN_B) % len(train):][:TRAIN_B]
                return trainer.gather_batch(data, torch.from_numpy(idx).to(dev), weight)

            for fn in LAUNCH_COUNTED:
                fn.launches = 0
            losses = [float(trainer.train_step(batch_of(s), s)) for s in range(MESH_STEPS)]
            torch.cuda.synchronize()
            launches = tuple(fn.launches for fn in LAUNCH_COUNTED)
            med, lo, hi, _ = time_steps(trainer, batch_of, steps)
            out[tag] = {"losses": losses, "launches": launches, "ms": med, "min": lo, "max": hi,
                        "backend": dist.get_backend(trainer.mesh.group("data"))
                        if trainer.mesh else None}
    finally:
        dist.destroy_process_group()
    err = max(_rel(a, b) for a, b in zip(out["meshed"]["losses"], out["unmeshed"]["losses"]))
    phase("mesh-nccl-world1", card=repr(smi), mesh=repr({"data": 1, "model": 1}),
          backend=out["meshed"]["backend"], dtype="float32", batch=TRAIN_B, T=T, p=0.0,
          losses=repr([f"{x:.7f}" for x in out["meshed"]["losses"]]),
          unmeshed_losses=repr([f"{x:.7f}" for x in out["unmeshed"]["losses"]]),
          loss_rel_err_max=f"{err:.3e}", loss_tol="1e-6",
          bit_equal=out["meshed"]["losses"] == out["unmeshed"]["losses"],
          launches=repr(dict(zip((fn.__name__ for fn in LAUNCH_COUNTED),
                                 out["meshed"]["launches"]))),
          meshed_ms_per_step=f"{out['meshed']['ms']:.3f}",
          unmeshed_ms_per_step=f"{out['unmeshed']['ms']:.3f}",
          meshed_min_max_ms=f"{out['meshed']['min']:.3f}/{out['meshed']['max']:.3f}",
          unmeshed_min_max_ms=f"{out['unmeshed']['min']:.3f}/{out['unmeshed']['max']:.3f}",
          timed_steps=steps)
    check(out["meshed"]["backend"] == "nccl", "mesh-nccl: the mesh is not on NCCL")
    check(err <= 1e-6, f"mesh-nccl: meshed losses {out['meshed']['losses']} against "
          f"{out['unmeshed']['losses']}")
    check(out["meshed"]["launches"] == (MESH_STEPS,) * 4,
          f"mesh-nccl: launches {out['meshed']['launches']}")
    return out


def mesh_phases(dev, smi):
    """The meshed path on the one card (``parallel/``): (a)
    ``mesh_nccl_phase``; (b) the ``MESH_CASES`` on a {data: 2, model: 2}
    mesh of four processes sharing the card over gloo, each held against
    the same case in this process, unmeshed, from the same seed on the
    same batches: the losses of every rank (equal on every rank, within
    ``MESH_LOSS_RTOL`` of the reference), each rank's launches, the rows
    each rank holds, the first step's gradients within ``MESH_GRAD_TOL``
    and the parameters after the steps within ``MESH_PARAM_SHARE`` of the
    reference's own, and the case's checks: RecBLR's full-sort ranks and
    ``recommend`` ids (through ``sharded_topk``) equal to the reference's
    from the meshed run's final parameters, the BPR case's uni100 metrics
    within 1e-5, row 16 against its plain version at each XLong rank's
    shard; then a meshed ``Trainer.fit`` with resident and with stream
    input against the unmeshed fit (``MESH_FIT``).  Returns {"nccl": ...,
    "gloo": {case: {"launches", "wall_s"}}}."""
    import gc
    import tempfile

    import torch.multiprocessing as mp

    nccl = mesh_nccl_phase(dev, smi)
    _cuda.build()  # the ranks load the built libraries
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mp.spawn(_mesh_rank, args=(4, _free_port(), tmp, str(dev)), nprocs=4, join=True)
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False) for r in range(4)]
    coll = ranks[0]["collectives"]
    phase("mesh-gloo-collectives", ranks=4, device="cuda:0", **coll)
    check(all(all(r["collectives"].values()) for r in ranks),
          f"mesh-gloo: a collective on CUDA tensors failed: {[r['collectives'] for r in ranks]}")
    gloo = {}
    for case, spec in MESH_CASES.items():
        cfg = _mesh_config(case, False)
        dtype = cfg["compute_dtype"]
        ref = _mesh_drive(dev, case, meshed=False, params=ranks[0][case]["params"])
        got = [r[case] for r in ranks]
        fields, checks, launches = _compare(f"mesh-{case}", spec, got, ref, dtype)
        phase(f"mesh-gloo-{case}", mesh=repr(MESH), backend="gloo", ranks=4,
              model=spec["model"], dtype=dtype, batch=spec["b"], T=spec["t"], V=spec["v"],
              vocab_row_shard=cfg.get("vocab_row_shard", "auto"),
              shards=repr([g["shards"] for g in got[:2]]), **fields)
        for ok, msg in checks:
            check(ok, msg)
        check(bool(got[0]["shards"]) == spec["sharded"], f"mesh-{case}: shards {got[0]['shards']}")
        gloo[case] = {"launches": launches[0], "wall_s": [g["wall_s"] for g in got]}
    with tempfile.TemporaryDirectory() as tmp:
        ref = _mesh_fit(dev, tmp)
    for mode in ("resident", "stream"):
        got = [r[f"fit-{mode}"] for r in ranks]
        rec_err = max(abs(a - b) / (5e-5 + 2e-4 * abs(b)) for g in got
                      for mine, theirs in zip(g["records"], ref["records"])
                      for a, b in zip(mine, theirs))
        test_err = max(abs(g["test"][k] - v) / (5e-5 + 2e-4 * abs(v)) for g in got
                       for k, v in ref["test"].items())
        phase(f"mesh-gloo-fit-{mode}", mesh=repr(MESH), backend="gloo", ranks=4,
              model="RecBLR", dtype="float32", batch=TRAIN_B, T=T, V=ref["n_items"],
              train_rows=ref["n_train"], epochs=MESH_FIT["epochs"],
              shards=repr([g["shards"] for g in got[:2]]),
              records=repr([(f"{a:.7f}", f"{b:.7f}") for a, b in got[0]["records"]]),
              single_records=repr([(f"{a:.7f}", f"{b:.7f}") for a, b in ref["records"]]),
              test=repr({k: round(v, 6) for k, v in sorted(got[0]["test"].items())}),
              single_test=repr({k: round(v, 6) for k, v in sorted(ref["test"].items())}),
              best_epoch=got[0]["best_epoch"], single_best_epoch=ref["best_epoch"],
              err_over_tol=f"{max(rec_err, test_err):.3e}", tol="rtol 2e-4, atol 5e-5",
              launches_per_rank=repr(got[0]["launches"]),
              wall_s_time_shared_on_one_card=repr([round(g["wall_s"], 2) for g in got]),
              single_wall_s=f"{ref['wall_s']:.2f}")
        check(all(len(g["records"]) == len(ref["records"]) == MESH_FIT["epochs"] for g in got)
              and rec_err <= 1.0 and test_err <= 1.0,
              f"mesh-fit-{mode}: the meshed fit is off the single process's")
        check(all(g["best_epoch"] == ref["best_epoch"] for g in got),
              f"mesh-fit-{mode}: best epochs {[g['best_epoch'] for g in got]}")
        check(all(all(g["launches"].values()) and g["shards"] for g in got),
              f"mesh-fit-{mode}: launches {[g['launches'] for g in got]}")
    phase("mesh-summary", spawn_s=f"{spawn_s:.1f}", card=repr(smi),
          note="four ranks time-share one card: no time here is a multi-GPU time")
    return {"nccl": nccl, "gloo": gloo}


# ---------------------------------------------------------------------------
# the seq axis (every model's time axis sharded over ranks: RecBLR's
# ops/seq_parallel_scan.py, the attention models' K / V gathers and row 15
# at a query chunk): four gloo ranks sharing the card, after the meshed path
# ---------------------------------------------------------------------------

SEQ_SCAN = (XB, XT, C)  # XLong's recurrence: B 512, T 1,024, C 128, fp32
SEQ_RANKS = 4
# row 7 launches a layer a step: two local scans forward, their two
# reverse scans backward (and two scans a layer a forward without grad)
SEQ_COUNTED = (SC.linear_scan, SC.linear_scan_reverse)
# the attention models' seq path a step: the prologue (row 6) once and row 15
# once a layer (two layers), forward and backward; a forward without grad
# (an eval batch, a recommend() call) row 6 once and row 15 twice
SEQ_ATTN_COUNTED = (FL.fused_ln_dropout, A.fused_attention, FL.fused_ln_dropout_bwd,
                    A.fused_attention_bwd)
# each case on the mesh ``mesh`` against the same config in one process
# from the same seed on the same batches (``_mesh_drive``), twice: in the
# seq axis's per-op composition (``_per_op``; row 7, and XLong's rows 14
# and 16; the attention models' rows 6 and 15, and BERT4Rec's row 13 on a
# replicated table), every check, and on the model's own kernels (the
# bench widths rows 1-4, XLong rows 9, 3, 14 and 16, the attention models'
# rows 6 and 10-13), the steps: the bench widths on {data: 2, seq: 2}
# (RecBLR, SASRec, BERT4Rec) and on {model: 2, seq: 2} with the table
# row-sharded (RecBLR, BERT4Rec: the vocab-parallel CE), and XLong's own
# config on {seq: 4}
SEQ_CASES = {
    "seq-recblr": dict(
        model="RecBLR", mesh={"data": 2, "seq": 2}, cfg={}, t=T, v=N_ITEMS, b=TRAIN_B,
        steps=MESH_STEPS, counted=SEQ_COUNTED, per_step=(4, 4), after=(8, 0),
        check=("eval", "serve")),
    "seq-xlong": dict(
        model="RecBLR", mesh={"seq": SEQ_RANKS},
        cfg={"compute_dtype": "bfloat16", "train_batch_size": XB, "dropout_prob": DROPOUT},
        t=XT, v=XV, b=XB, steps=1,
        counted=SEQ_COUNTED + (FCE.fused_softmax_ce_chunked, FCE.fused_softmax_ce_chunked_bwd,
                               E.embedding_grad),
        per_step=(4, 4, 1, 1, 1), after=(0,) * 5, check=("emb-grad",)),
    "seq-sasrec": dict(
        model="SASRec", mesh={"data": 2, "seq": 2}, cfg={}, t=T, v=N_ITEMS, b=TRAIN_B,
        steps=2, counted=SEQ_ATTN_COUNTED, per_step=(1, 2, 1, 2), after=(2, 4, 0, 0),
        check=("eval", "serve")),
    "seq-bert4rec": dict(
        model="BERT4Rec", mesh={"data": 2, "seq": 2}, cfg={}, t=T, v=N_ITEMS, b=TRAIN_B,
        steps=2, counted=SEQ_ATTN_COUNTED + (FCE.fused_softmax_ce, FCE.fused_softmax_ce_bwd),
        per_step=(1, 2, 1, 2, 1, 1), after=(2, 4, 0, 0, 0, 0), check=("eval", "serve")),
    "seq-model-recblr": dict(
        model="RecBLR", mesh={"model": 2, "seq": 2}, cfg={"vocab_row_shard": "always"}, t=T,
        v=N_ITEMS, b=TRAIN_B, steps=2, counted=SEQ_COUNTED, per_step=(4, 4), after=(8, 0),
        check=("eval", "serve")),
    "seq-model-bert4rec": dict(
        model="BERT4Rec", mesh={"model": 2, "seq": 2}, cfg={"vocab_row_shard": "always"},
        t=T, v=N_ITEMS, b=TRAIN_B, steps=2, counted=SEQ_ATTN_COUNTED, per_step=(1, 2, 1, 2),
        after=(2, 4, 0, 0), check=("eval", "serve")),
}


def _seq_scan_rank(dev):
    """(a) on this rank of {seq: 4}: ``seq_parallel_scan`` of its [512, 256,
    128] chunk of XLong's recurrence (gates in [0.3, 0.999), fp32) and its
    backward against a random cotangent, its row 7 launches and wall
    seconds; then, uncounted, the whole T = 1,024 in this process through
    one ``linear_scan`` and through the serial plain scan, and the
    chunk's errors against each: the forward's max |err|, each
    gradient's max |err| over the reference's largest value."""
    from datamining_recblr_torch.ops.seq_parallel_scan import seq_parallel_scan
    from datamining_recblr_torch.parallel.input import seq_chunk
    from datamining_recblr_torch.parallel.mesh import make_mesh

    mesh = make_mesh({"seq": SEQ_RANKS}, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    g = 0.3 + 0.699 * torch.rand(SEQ_SCAN, generator=gen, device=dev)
    x = torch.randn(SEQ_SCAN, generator=gen, device=dev)
    dh = torch.randn(SEQ_SCAN, generator=gen, device=dev)
    t0, t1 = seq_chunk(SEQ_SCAN[1], mesh)
    gl = g[:, t0:t1].contiguous().requires_grad_()
    xl = x[:, t0:t1].contiguous().requires_grad_()
    for fn in SEQ_COUNTED:
        fn.launches = 0
    torch.cuda.synchronize()
    w0 = time.perf_counter()
    h = seq_parallel_scan(gl, xl, mesh)
    h.backward(dh[:, t0:t1])
    torch.cuda.synchronize()
    out = {"wall_s": time.perf_counter() - w0, "chunk": (t0, t1),
           "launches": {fn.__name__: fn.launches for fn in SEQ_COUNTED}}
    for name, scan in (("whole", SC.linear_scan), ("plain", SC.linear_scan_serial)):
        gw, xw = g.clone().requires_grad_(), x.clone().requires_grad_()
        hw = scan(gw, xw)
        hw.backward(dh)
        out[name] = {
            "fwd": float((h.detach() - hw.detach()[:, t0:t1]).abs().max()),
            "d_gates": float((gl.grad - gw.grad[:, t0:t1]).abs().max() / gw.grad.abs().max()),
            "d_tokens": float((xl.grad - xw.grad[:, t0:t1]).abs().max() / xw.grad.abs().max())}
        del gw, xw, hw
    return out


def _seq_rank(rank, world, port, out_dir, device):
    """One rank of the four-rank run of ``seq_phases`` on ``device``: (a),
    then each ``SEQ_CASES`` case, its results saved for the parent."""
    import torch.distributed as dist

    dev = torch.device(device)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        out = {"seq-scan": _seq_scan_rank(dev)}
        for case in SEQ_CASES:
            out[case] = _mesh_drive(dev, case, meshed=True)
            if rank:  # the gathered tensors are the same on every rank
                out[case].pop("grads")
                out[case].pop("params")
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def seq_phases(dev, smi):
    """The ``seq`` axis on the one card, four gloo ranks sharing it: row 7
    against its plain version at the chunk shape [512, 256, 128], row 15
    at a query chunk and row 6 at a t0 (``row15_chunk_vs_plain``,
    ``row6_chunk_vs_plain``); (a) ``seq-scan``, ``seq_parallel_scan`` on
    {seq: 4} at XLong's recurrence against one process
    (``_seq_scan_rank``); (b) ``seq-recblr``, RecBLR at the bench widths
    on {data: 2, seq: 2} for ``MESH_STEPS`` steps, one eval batch's
    full-sort ranks and 256 users' ``recommend`` ids; (c) ``seq-xlong``,
    XLong's config on {seq: 4} for one step with row 16 at each rank's
    ids; (d) ``seq-sasrec`` and ``seq-bert4rec`` at the bench widths on
    {data: 2, seq: 2}, ``seq-model-recblr`` and ``seq-model-bert4rec`` on
    {model: 2, seq: 2} with the table row-sharded, two steps each and
    (b)'s checks.  Each case is held to one process in the seq axis's
    composition by ``_compare`` (every check) and to one process on the
    model's own kernels by ``_steps_vs_single`` (the losses and the
    gradients held, the update share read).  No time here is a multi-GPU
    time.  Returns {"errs": rows 7, 15 and 6's errors at the chunk
    shapes, "launches": {phase: {kernel: launches a rank}}}."""
    import gc
    import tempfile

    import torch.multiprocessing as mp

    errs = scan_kernels_vs_plain(dev, shapes=((XB, XT // SEQ_RANKS, C),))
    errs.update(row15_chunk_vs_plain(dev))
    errs.update(row6_chunk_vs_plain(dev))
    _cuda.build()  # the ranks load the built libraries
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mp.spawn(_seq_rank, args=(SEQ_RANKS, _free_port(), tmp, str(dev)), nprocs=SEQ_RANKS,
                 join=True)
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False) for r in range(SEQ_RANKS)]
    scans = [r["seq-scan"] for r in ranks]
    tol = MESH_GRAD_TOL["float32"]
    worst = {ref: {k: max(sc[ref][k] for sc in scans) for k in ("fwd", "d_gates", "d_tokens")}
             for ref in ("whole", "plain")}
    phase("seq-scan", mesh=repr({"seq": SEQ_RANKS}), backend="gloo", ranks=SEQ_RANKS,
          card=repr(smi), shape=f"B{SEQ_SCAN[0]}xT{SEQ_SCAN[1]}xC{SEQ_SCAN[2]}",
          chunks=repr([sc["chunk"] for sc in scans]),
          launches_per_rank=repr([sc["launches"] for sc in scans]),
          vs_one_linear_scan=repr({k: f"{v:.3e}" for k, v in worst["whole"].items()}),
          vs_serial_plain=repr({k: f"{v:.3e}" for k, v in worst["plain"].items()}),
          tol=f"fwd atol {FP32_TOL['atol']}; grads max|err|/max|ref| <= {tol}",
          wall_s_time_shared_on_one_card=repr([round(sc["wall_s"], 3) for sc in scans]))
    for ref, e in worst.items():
        check(e["fwd"] <= FP32_TOL["atol"] and e["d_gates"] <= tol and e["d_tokens"] <= tol,
              f"seq-scan: the chunks off the {ref} scan: {e}")
    check(all(sc["launches"] == {"linear_scan": 2, "linear_scan_reverse": 2} for sc in scans),
          f"seq-scan: launches {[sc['launches'] for sc in scans]}, expected 2 and 2 a rank")
    launches = {"seq-scan": scans[0]["launches"]}
    for case, spec in SEQ_CASES.items():
        cfg = _mesh_config(case, False)
        dtype = cfg["compute_dtype"]
        got = [r[case] for r in ranks]
        ref = _mesh_drive(dev, case, meshed=False, params=ranks[0][case]["params"],
                          per_op=True)
        fields, checks, case_launches = _compare(case, spec, got, ref, dtype)
        own_fields, own_checks = _steps_vs_single(f"{case} (own path)", got,
                                                  _mesh_drive(dev, case, meshed=False),
                                                  dtype, prefix="own_path_")
        p = cfg["dropout_prob"] if spec["model"] == "RecBLR" else cfg["hidden_dropout_prob"]
        phase(case, mesh=repr(spec["mesh"]), backend="gloo", ranks=SEQ_RANKS,
              model=spec["model"], dtype=dtype, batch=spec["b"], T=spec["t"], V=spec["v"],
              p=p, **fields, **own_fields)
        # against the model's own kernels the steps hold to the loss and
        # gradient tolerances; the update share is read, not held (a bf16
        # per-op composition and the fused kernels round apart, and one
        # Adam sign flip is 1/64 of an LN scale)
        for ok, msg in checks + own_checks[:2]:
            check(ok, msg)
        launches[case] = case_launches[0]
    phase("seq-summary", spawn_s=f"{spawn_s:.1f}", card=repr(smi),
          note="four ranks time-share one card: no time here is a multi-GPU time")
    return {"errs": errs, "launches": launches}


def _steps_vs_single(name, got, ref, dtype, prefix=""):
    """The steps of a four-rank case (``got``, by rank) against a single
    process (``ref``): (fields, checks): the losses (equal on every rank,
    within ``MESH_LOSS_RTOL``), the first step's gradients within
    ``MESH_GRAD_TOL`` of the single process's own, and the share of the
    parameters' entries whose update is off (``MESH_PARAM_SHARE``, the
    third check); ``prefix`` the fields' and the messages' tag."""
    err = max(_rel(a, b) for g in got for a, b in zip(g["losses"], ref["losses"]))
    grad_errs, worst_grad = _grad_errs(got[0]["grads"], ref["grads"], MESH_GRAD_TOL[dtype])
    shares, worst_share = _param_shares(got[0]["params"], ref["params"], ref["init"], ref["lr"])
    fields = {
        f"{prefix}single_losses": repr([f"{x:.7f}" for x in ref["losses"]]),
        f"{prefix}loss_rel_err_max": f"{err:.3e}", f"{prefix}loss_tol": MESH_LOSS_RTOL[dtype],
        f"{prefix}single_wall_s": f"{ref['wall_s']:.2f}",
        f"{prefix}grad_err_max": f"{grad_errs[worst_grad]:.3e}",
        f"{prefix}grad_err_worst": worst_grad, f"{prefix}grad_tol": MESH_GRAD_TOL[dtype],
        f"{prefix}param_update_share_off": f"{shares[worst_share]:.3e}",
        f"{prefix}param_worst": worst_share,
        f"{prefix}param_share_tol": MESH_PARAM_SHARE[dtype]}
    checks = [
        (err <= MESH_LOSS_RTOL[dtype],
         f"{name}: losses {got[0]['losses']} against the single-process {ref['losses']}"),
        (set(got[0]["grads"]) == set(ref["grads"]) and grad_errs[worst_grad] <= 1.0,
         f"{name}: first-step gradients off the single process's: {grad_errs}"),
        (shares[worst_share] <= MESH_PARAM_SHARE[dtype],
         f"{name}: parameters after the steps off the single process's: {shares}"),
    ]
    return fields, checks


def _compare(name, spec, got, ref, dtype):
    """A four-rank case (``got``, by rank) against its single process
    (``ref``): ``_steps_vs_single``, each rank's launches (the spec's per
    step and after), and the case's checks: full-sort ranks and
    ``recommend`` ids equal to the single process's from the meshed run's
    final parameters, uni100 metrics within 1e-5, row 16 at each rank's
    ids.  Returns (the phase's fields, the checks, the launches by rank)."""
    launches = [g["launches"] for g in got]
    want = {fn.__name__: spec["steps"] * a + b
            for fn, a, b in zip(spec["counted"], spec["per_step"], spec["after"])}
    fields, checks = _steps_vs_single(name, got, ref, dtype)
    fields = {"losses": repr([f"{x:.7f}" for x in got[0]["losses"]]), **fields,
              "launches_per_rank": repr(launches[0]),
              "wall_s_time_shared_on_one_card": repr([round(g["wall_s"], 2) for g in got])}
    checks += [
        (all(g["losses"] == got[0]["losses"] for g in got),
         f"{name}: the ranks report different losses"),
        (all(x == want for x in launches), f"{name}: launches {launches}, expected {want} a rank"),
    ]
    if "emb-grad" in spec["check"]:
        fields.update(emb_grad_err=repr([f"{g['emb_grad_err']:.3e}" for g in got]),
                      emb_grad_own_share=repr([round(g["emb_grad_own_share"], 3) for g in got]))
    if "eval" in spec["check"]:
        # the reference ranks the global batch; rank r holds the rows of its
        # data index, r // (the ranks a data index)
        full_ranks, full_scores = ref["ranks"], ref["scores"]
        data = spec.get("mesh", MESH).get("data", 1)
        rows_a = MESH_EVAL_B // data
        diff_ranks = diff_bits = 0
        score_err = 0.0
        for r, g in enumerate(got):
            d = r // (len(got) // data)
            rows = slice(d * rows_a, (d + 1) * rows_a)
            lo, hi = g["shards"].get("item_embedding", (0, full_scores.shape[1]))
            mine = full_scores[rows, lo:hi]  # the reference pads no column
            theirs = g["scores"][:, :mine.shape[1]]
            diff_ranks += int((g["ranks"] != full_ranks[rows]).sum())
            diff_bits += int((theirs.view(torch.int32) != mine.view(torch.int32)).sum())
            fin = torch.isfinite(mine)
            score_err = max(score_err, float((theirs - mine)[fin].abs().max()))
        fields.update(eval_rows=MESH_EVAL_B, ranks_differing=diff_ranks,
                      score_bits_differing=diff_bits, score_abs_err_max=f"{score_err:.3e}")
        checks.append((diff_ranks == 0, f"{name}: {diff_ranks} full-sort ranks differ from the "
                       f"single-process ranks ({diff_bits} score bits differ, max "
                       f"{score_err:.3e})"))
    if "serve" in spec["check"]:
        diff_ids = sum(int((g["ids"] != ref["ids"]).sum()) for g in got)
        val_err = max(float(np.abs(g["vals"] - ref["vals"]).max()) for g in got)
        fields.update(users=MESH_USERS, top_k=TOP_K, ids_differing=diff_ids,
                      topk_value_abs_err=f"{val_err:.3e}")
        checks.append((diff_ids == 0, f"{name}: {diff_ids} recommended ids differ from the "
                       "single-process recommend()"))
    if "sampled" in spec["check"]:
        s_err = max(abs(g["sampled"][k] - v) for g in got for k, v in ref["sampled"].items())
        fields.update(uni100=repr({k: round(v, 4) for k, v in sorted(ref["sampled"].items())}),
                      uni100_abs_err_max=f"{s_err:.3e}")
        checks.append((s_err <= 1e-5, f"{name}: uni100 metrics differ by {s_err}"))
    return fields, checks, launches


def _grad_errs(got, want, tol, floor=1e-6):
    """{param: max |got - want| over tol times the larger of its largest
    |want| and floor x the largest |want| of all / tol} (<= 1 within the
    tolerance) and the worst parameter."""
    top = max(float(w.abs().max()) for w in want.values())
    errs = {k: float((got[k].double() - w.double()).abs().max())
            / (tol * max(float(w.abs().max()), floor * top / tol, 1e-30))
            for k, w in want.items() if k in got}
    return errs, max(errs, key=errs.get)


def _param_shares(got, want, init, lr):
    """{param: share of its entries whose update from ``init`` differs
    between ``got`` and ``want`` by more than lr / 2} and the worst."""
    shares = {k: float(((got[k].double() - w.double()).abs() > 0.5 * lr).double().mean())
              for k, w in want.items() if torch.is_floating_point(w)}
    return shares, max(shares, key=shares.get)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on a card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = environment()
    p1, p2, lens, errs = kernels_vs_plain(dev)
    mask_bits(dev)
    train_errs = training_kernels_vs_plain(dev)
    attn_errs = attn_kernels_vs_plain(dev)
    attn_train_errs = attn_train_kernels_vs_plain(dev)
    attn_mask_bits(dev)
    b4r_errs = b4r_kernels_vs_plain(dev)
    b4r_mask_bits(dev)
    xlong_errs = xlong_kernels_vs_plain(dev)
    xlong_mask_bits(dev)
    slice_errs = dropout_ln_kernels_vs_plain(dev)
    dropout_ln_mask_bits(dev)
    slice_errs.update(scan_kernels_vs_plain(dev))
    slice_errs.update(bdlru_kernels_vs_plain(dev))
    row15_errs = attention_kernels_vs_plain(dev)
    attention_mask_bits(dev)
    probe_errs = probe_kernels_vs_plain(dev)
    serve = {(name, dt): serving(dev, name, dt)
             for name in SERVED for dt in ("float32", "bfloat16")}
    xserve = serving(dev, "RecBLR", "bfloat16", xlong=True)
    topk_times(dev)
    train = {(name, dt): train_step_phase(dev, dt, name)
             for name in TRAINED for dt in ("float32", "bfloat16")}
    xtrain = {dt: xlong_train_phase(dev, dt) for dt in ("float32", "bfloat16")}
    served = [path for path, spec in SLICE_PATHS.items() if "served" in spec]
    sserve = {(path, dt): serving(dev, "RecBLR", dt, path=path)
              for path in served for dt in SLICE_PATHS[path]["serve_dtypes"]}
    strain = {(path, dt): slice_train_phase(dev, path, dt)
              for path in served for dt in ("float32", "bfloat16")}
    slice_train_phase(dev, "hm", "float32", timed=False)
    dconv_train_phase(dev)
    baselines = ("SASRec", "BERT4Rec")
    pserve = {(name, dt): serving(dev, name, dt, path="d256")
              for name in baselines for dt in ("float32", "bfloat16")}
    ptrain = {(name, dt): path_train_phase(dev, name, "d256", dt)
              for name in baselines for dt in ("float32", "bfloat16")}
    serving(dev, "SASRec", "float32", path="long")
    path_train_phase(dev, "SASRec", "long", "float32")
    for name in baselines:
        serving(dev, name, "bfloat16", path="h528")
        path_train_phase(dev, name, "h528", "bfloat16")
    for name in TRAINED:
        fit_phase(dev, name)
    jaxck = jax_checkpoint_phase(dev)
    experiments = experiment_phases(dev)
    cold = cold_start_phases(dev)
    mesh = mesh_phases(dev, smi)
    seq = seq_phases(dev, smi)
    kernel_times(dev, p1, p2, lens)
    rows = training_kernel_times(dev)
    attn_kernel_times(dev)
    sas_rows = attn_training_kernel_times(dev)
    row10_fwd_kernel_times(dev)
    row10_fwd_phase_times(dev)
    row10_bwd_phase_times(dev)
    b4r_rows = b4r_training_kernel_times(dev)
    row13_kernel_times(dev)
    row13_bwd_phase_times(dev)
    ce_fwd_kernel_times(dev)
    xlong_rows = xlong_kernel_times(dev)
    row16_times(dev)
    row14_bwd_phase_times(dev)
    recblr_bwd_phase_times(dev)
    recblr_fwd_phase_times(dev)
    slice_rows = slice_kernel_times(dev)
    served_kernel_times(dev)
    ln_fwd_kernel_times(dev)
    row15_rows = row15_kernel_times(dev)
    row15_phase_times(dev)
    chunk_kernel_times(dev)
    probe_rows = probe_phases(dev)
    # launches: each model's kernels in one training step of its main path
    # (fp32), the forwards' launches per recommend() beside them (RecBLR's;
    # the attention kernels' in SASRec's and BERT4Rec's)
    launches = dict(zip((k[0] for k in KERNELS), train["RecBLR", "float32"]["launches"]))
    kernels = []
    for name, src, tpu in KERNELS:
        ms, plain, bound, by = rows[(name, TRAIN_B)]
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": launches[name],
            "max_abs_err": max(errs.get(name, 0.0), train_errs[name]),
            "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "library_ms": None,
        }
        if name in errs:
            entry["launches_per_recommend"] = serve["RecBLR", "float32"]["launches"][len(kernels)]
        kernels.append(entry)
    sas_launches = dict(zip((fn.__name__ for fn in SAS_COUNTED),
                            train["SASRec", "float32"]["launches"]))
    for i, (name, src, tpu) in enumerate(ATTN_KERNELS):
        ms, plain, bound, by, lib = sas_rows[name]
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": sas_launches[name],
            "max_abs_err": max(attn_errs.get(name, 0.0), attn_train_errs[name]),
            "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "library_ms": lib,
        }
        if i < len(ATTN_COUNTED):
            entry["launches_per_recommend"] = {m: serve[m, "float32"]["launches"][i]
                                               for m in ("SASRec", "BERT4Rec")}
        kernels.append(entry)
    b4r_launches = dict(zip((fn.__name__ for fn in B4R_COUNTED),
                            train["BERT4Rec", "float32"]["launches"]))
    for name, src, tpu in B4R_KERNELS:
        ms, plain, bound, by, lib = b4r_rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": b4r_launches[name], "max_abs_err": b4r_errs[name],
            "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by, "library_ms": lib,
        })
    # the long-context kernels: launches in one bf16 XLong step (the
    # configuration's dtype, the only one that runs row 16)
    for name, src, tpu in XLONG_KERNELS:
        ms, plain, bound, by, lib = xlong_rows[name]
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": xtrain["bfloat16"]["launches"][name], "max_abs_err": xlong_errs[name],
            "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by, "library_ms": lib,
        }
        if name == "fused_recurrent_layer_chunked":
            entry["launches_per_recommend"] = xserve["launches"][0]
        kernels.append(entry)
    # the kernels outside the whole-layer ones: launches in one step of their
    # path (row 8's in the longodd path's configured bf16, rows 5 and 7 fp32)
    for name, src, tpu, path in SLICE_KERNELS:
        ms, plain, bound, by, lib = slice_rows[name]
        dt = "bfloat16" if path == "longodd" else "float32"
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": strain[path, dt]["launches"][name], "max_abs_err": slice_errs[name],
            "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by, "library_ms": lib,
        }
        names = [fn.__name__ for fn in SLICE_PATHS[path]["served"]]
        if name in names:
            entry["launches_per_recommend"] = sserve[
                path, SLICE_PATHS[path]["serve_dtypes"][0]]["launches"][names.index(name)]
        kernels.append(entry)
    # row 15: launches in one fp32 step of SASRec's d256 path, per
    # recommend() in SASRec's and BERT4Rec's
    for name, src, tpu in ROW15_KERNELS:
        ms, plain, bound, by, lib = row15_rows[name]
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": ptrain["SASRec", "float32"]["launches"][name],
            "max_abs_err": row15_errs[name],
            "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by, "library_ms": lib,
        }
        if name == "fused_attention":
            entry["launches_per_recommend"] = {m: pserve[m, "float32"]["launches"][1]
                                               for m in baselines}
        kernels.append(entry)
    # row 17: launches in the probes' entry-point runs (probe_phases)
    for name, src, tpu in PROBE_KERNELS:
        r = probe_rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": r["launches"], "max_abs_err": probe_errs[name],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], **r["extra"],
        })
    serve_summary = {}
    for (name, dt), out in serve.items():
        tag = ("" if name == "RecBLR" else name.lower() + "_") + SHORT_DTYPE[dt]
        serve_summary[f"serve_p50_ms_{tag}"] = f"{out[1] * 1e3:.3f}"
        serve_summary[f"serve_users_per_s_{tag}"] = f"{B / out[B]:.1f}"
    train_summary = {}
    for (name, dt), out in train.items():
        tag = ("" if name == "RecBLR" else name.lower() + "_") + "train"
        train_summary[f"{tag}_ms_per_step_{SHORT_DTYPE[dt]}"] = f"{out['ms']:.3f}"
        train_summary[f"{tag}_examples_per_s_{SHORT_DTYPE[dt]}"] = (
            f"{TRAIN_B / out['ms'] * 1e3:.1f}")
    serve_summary["serve_xlong_p50_ms_bf16"] = f"{xserve[1] * 1e3:.3f}"
    serve_summary["serve_xlong_users_per_s_bf16"] = f"{B / xserve[B]:.1f}"
    for dt, out in xtrain.items():
        train_summary[f"xlong_train_ms_per_step_{SHORT_DTYPE[dt]}"] = f"{out['ms']:.3f}"
        train_summary[f"xlong_train_peak_gb_{SHORT_DTYPE[dt]}"] = f"{out['peak_gb']:.3f}"
    for (path, dt), out in sserve.items():
        serve_summary[f"serve_{path}_p50_ms_{SHORT_DTYPE[dt]}"] = f"{out[1] * 1e3:.3f}"
        serve_summary[f"serve_{path}_users_per_s_{SHORT_DTYPE[dt]}"] = f"{B / out[B]:.1f}"
    for (path, dt), out in strain.items():
        train_summary[f"{path}_train_ms_per_step_{SHORT_DTYPE[dt]}"] = f"{out['ms']:.3f}"
        train_summary[f"{path}_train_examples_per_s_{SHORT_DTYPE[dt]}"] = (
            f"{out['examples_per_s']:.1f}")
    for (name, dt), out in pserve.items():
        tag = f"{name.lower()}_d256_{SHORT_DTYPE[dt]}"
        serve_summary[f"serve_p50_ms_{tag}"] = f"{out[1] * 1e3:.3f}"
        serve_summary[f"serve_users_per_s_{tag}"] = f"{B / out[B]:.1f}"
    for (name, dt), out in ptrain.items():
        tag = f"{name.lower()}_d256_train"
        train_summary[f"{tag}_ms_per_step_{SHORT_DTYPE[dt]}"] = f"{out['ms']:.3f}"
        train_summary[f"{tag}_examples_per_s_{SHORT_DTYPE[dt]}"] = (
            f"{out['examples_per_s']:.1f}")
        train_summary[f"{tag}_peak_gb_{SHORT_DTYPE[dt]}"] = f"{out['peak_gb']:.3f}"
    # the experiment path's launches (one epoch and its evaluations) of
    # each kernel it runs, by run
    for entry in kernels:
        runs = {name: out["launches"][entry["name"]] for name, out in experiments.items()
                if entry["name"] in out["launches"]}
        if runs:
            entry["launches_experiment"] = runs
    # the launches of the JAX checkpoint's recommend() and of its three
    # resumed steps
    for entry in kernels:
        if entry["name"] in jaxck["recommend"]:
            entry["launches_jax_checkpoint"] = {k: v[entry["name"]] for k, v in jaxck.items()}
    # the cold-start pipeline's launches (an epoch, its evaluations and the
    # held-out users'), by mode
    for entry in kernels:
        if entry["name"] in cold["none"]["launches"]:
            entry["launches_cold_start"] = {mode: out["launches"][entry["name"]]
                                            for mode, out in cold.items()}
    # the meshed path's launches a rank: NCCL at world size 1 (its MESH_STEPS
    # steps), then each four-rank gloo case that runs the kernel
    nccl_launches = dict(zip((fn.__name__ for fn in LAUNCH_COUNTED),
                             mesh["nccl"]["meshed"]["launches"]))
    for entry in kernels:
        runs = {f"gloo-{case}": out["launches"][entry["name"]]
                for case, out in mesh["gloo"].items() if entry["name"] in out["launches"]}
        if entry["name"] in nccl_launches:
            runs = {"nccl-world1": nccl_launches[entry["name"]], **runs}
        if runs:
            entry["launches_mesh_per_rank"] = runs
    # the seq axis's launches a rank: each seq phase that runs the kernel,
    # and row 7's error at the chunk shape
    for entry in kernels:
        runs = {case: out[entry["name"]] for case, out in seq["launches"].items()
                if entry["name"] in out}
        if runs:
            entry["launches_seq_per_rank"] = runs
        if entry["name"] in seq["errs"]:
            entry["max_abs_err"] = max(entry["max_abs_err"], seq["errs"][entry["name"]])
    for tag in ("meshed", "unmeshed"):
        train_summary[f"mesh_nccl_world1_{tag}_ms_per_step_fp32"] = (
            f"{mesh['nccl'][tag]['ms']:.3f}")
    for mode, out in cold.items():
        for key in ("train_s", "unseen_eval_s", "similarity_s"):
            train_summary[f"cold_start_{mode}_{key}"] = f"{out[key]:.3f}"
    for name, out in experiments.items():
        tag = name.removeprefix("experiment-").replace("-", "_")
        train_summary[f"{tag}_train_s"] = f"{out['train_s']:.2f}"
        train_summary[f"{tag}_examples_per_s"] = f"{out['examples_per_s']:.1f}"
        train_summary[f"{tag}_eval_s"] = f"{out['eval_s']:.2f}"
    check(len(kernels) == 35, f"the kernels JSON lists {len(kernels)} kernels, not 35")
    phase("summary", card=repr(smi), **serve_summary, **train_summary)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
