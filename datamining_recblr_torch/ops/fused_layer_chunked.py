"""Sequence-chunked RecBLR RecurrentLayer, forward and backward: the
long-context (T > 512) counterpart of ``fused_recurrent_layer``, as
hand-written CUDA kernels for Hopper beside their plain PyTorch versions.

Counterpart of ``datamining_recblr_tpu/ops/fused_layer_chunked.py``
(``fused_recurrent_layer_chunked`` :494; ``_fwd_kernel`` via
``_chunked_fwd`` :398, ``_bwd_kernel`` via ``_chunked_bwd`` :456).  The
layer is ``fused_recurrent_layer``'s, with the same parameters, dropout
masks (Philox at absolute (row, position, channel), so K1's bits) and
math.  T is cut into chunks of ``pick_chunk(T)`` positions, and the
forward returns beside the output a **record** [B, nc, 8, C] fp32 per
(row, chunk): row 0 the scan state entering the chunk, rows 1 .. K-1 the
previous chunk's last K-1 xb rows (pre-conv, after W_in), the rest zero
(the JAX kernel's ``carry`` [B, nc * 8, C]).  The backward reads only x,
dout and the record.

* ``fused_recurrent_layer_chunked`` forward: ``csrc/fused_layer_chunked.cu``;
* its backward, ``fused_recurrent_layer_chunked_bwd``:
  ``csrc/fused_layer_chunked_bwd.cu``.

The plain versions follow the JAX kernels chunk by chunk: the state
entering a chunk is carried as ``h = h_local + cumprod(alpha) * carry``
(``:154-156``) and the conv reads the previous chunk's tail; the plain
backward recomputes each chunk from x and the record, walking the chunks
in reverse and handing the cotangents of the carry and the tail to the
chunk before.

On a CPU tensor ``fused_recurrent_layer_chunked`` computes its plain
version (autograd gives the plain backward); on a CUDA tensor it launches
its kernel or raises.  ``launches`` on ``fused_recurrent_layer_chunked``
and ``fused_recurrent_layer_chunked_bwd`` counts their kernel launches.
Params are fp32; x is fp32 or bf16 and the output (and dx) has x's dtype.
"""

from __future__ import annotations

import torch

from datamining_recblr_torch.ops import _cuda, fastmath
from datamining_recblr_torch.ops.conv import causal_depthwise_conv
from datamining_recblr_torch.ops.fused_bdlru import _gate_math
from datamining_recblr_torch.ops.fused_layer import (
    MAX_K,
    PARAM_ORDER,
    _bwd_buffers,
    _check_dout,
    _drop,
    _dropout_args,
    _ffn_tail,
    _ffn_width,
    _grad_tuple,
    _ln,
    _masks,
    _needs_grad,
    _param_dict,
    _param_list,
    _require_cuda,
    _stream,
    _unflatten_grads,
)
from datamining_recblr_torch.ops.scan import linear_scan_serial

REC_ROWS = MAX_K  # record rows per (row, chunk): csrc/common.cuh REC_ROWS
CHUNK_TARGET = 128


def pick_chunk(t: int, target: int = CHUNK_TARGET) -> int:
    """The largest multiple of 8 in [8, target] that divides T, or 0 (the
    JAX package's ``pick_chunk``: e.g. 1,024 -> 128, 1,000 -> 40, 997 ->
    0)."""
    best = 0
    for d in range(8, min(t, target) + 1, 8):
        if t % d == 0:
            best = d
    return best


def chunk_of(t: int, k: int, chunk: int = 0) -> int:
    """The chunk the kernels run T in (``chunk`` or ``pick_chunk(T)``), or
    0 where the chunked layer does not take the shape: the chunk must lie
    in [max(8, K), T] and divide T, and K <= 8 (``_chunked_fwd:381``)."""
    tc = int(chunk) or pick_chunk(t)
    ok = k <= MAX_K and 8 <= tc <= t and t % tc == 0 and tc >= k
    return tc if ok else 0


def _chunk_or_raise(t, k, chunk):
    tc = chunk_of(t, k, chunk)
    if not tc:
        raise ValueError(f"the chunked layer needs a chunk in [max(8, d_conv), T] that divides "
                         f"T and d_conv <= {MAX_K} (got T={t}, chunk={chunk}, d_conv={k})")
    return tc


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _chunk_fwd(xj, carry, tail, p, m, use_conv, use_ffn, prologue):
    """One chunk, as the JAX kernel's body: xj [B, Tc, D] (the raw
    embedding block with the prologue), carry [B, C] the state entering
    the chunk, tail [B, K-1, C] the previous chunk's last xb rows, m the
    chunk's masks.  Returns (out fp32 [B, Tc, D], the state at the
    chunk's last position, the chunk's last K-1 xb rows)."""
    xf = xj.float()
    if prologue:
        xf = _ln(_drop(xf, m, "m0"), p["pl_s"], p["pl_b"])
    c = p["w_in"].shape[1] // 2
    k = p["wc"].shape[0]
    tc = xf.shape[1]
    xz = xf @ p["w_in"]
    xb, z = xz[..., :c], xz[..., c:]
    if use_conv:
        u = causal_depthwise_conv(torch.cat([tail, xb], 1), p["wc"], p["bc"])[:, k - 1:]
        xc = fastmath.silu(u)
    else:
        xc = xb
    alpha, beta, _, _, _ = _gate_math(xc, p["wg"], p["bg"], p["lam"])
    h = linear_scan_serial(alpha, beta * xc) + torch.cumprod(alpha, 1) * carry[:, None]
    y = _drop((fastmath.silu(z) * h) @ p["w_out"], m, "m1")
    out = _ln(y + xf, p["ln1_s"], p["ln1_b"])
    if use_ffn:
        out = _ffn_tail(out, p, m)
    return out, h[:, -1], xb[:, tc - (k - 1):]


def _chunk_masks(masks, s, e):
    return {n: v[:, s:e] for n, v in masks.items()}


def _layer_masks(x, params, use_ffn, prologue, dropout_p, seed):
    b, t, d = x.shape
    return _masks(dropout_p, seed, b, t, d, _ffn_width(params, use_ffn), use_ffn, prologue,
                  x.device)


def fused_recurrent_layer_chunked_plain(x, params, use_conv=True, use_ffn=True, prologue=False,
                                        dropout_p=0.0, seed=0, chunk=0):
    """Plain PyTorch version of ``fused_recurrent_layer_chunked`` (any
    device; differentiable): (out [B, T, D] in x's dtype, record [B, nc,
    8, C] fp32)."""
    p = params
    b, t, _ = x.shape
    c = p["w_out"].shape[0]
    k = p["wc"].shape[0]
    tc = _chunk_or_raise(t, k, chunk)
    m = _layer_masks(x, p, use_ffn, prologue, dropout_p, seed)
    carry = x.new_zeros((b, c), dtype=torch.float32)
    tail = x.new_zeros((b, k - 1, c), dtype=torch.float32)
    pad = x.new_zeros((b, REC_ROWS - k, c), dtype=torch.float32)
    outs, recs = [], []
    for s in range(0, t, tc):
        recs.append(torch.cat([carry[:, None], tail, pad], 1))
        out, carry, tail = _chunk_fwd(x[:, s:s + tc], carry, tail, p,
                                      _chunk_masks(m, s, s + tc), use_conv, use_ffn, prologue)
        outs.append(out)
    return torch.cat(outs, 1).to(x.dtype), torch.stack(recs, 1)


def fused_recurrent_layer_chunked_bwd_plain(x, dout, record, params, use_conv=True,
                                            use_ffn=True, prologue=False, dropout_p=0.0, seed=0,
                                            chunk=0):
    """Plain PyTorch version of ``fused_recurrent_layer_chunked_bwd``: (dx
    in x's dtype, {param name: fp32 grad}) from x, dout and the record
    alone.  Each chunk is recomputed from its record, last chunk first;
    the cotangents of its entering state and conv tail go to the chunk
    before it as those of its end state and last xb rows."""
    b, t, _ = x.shape
    k = params["wc"].shape[0]
    tc = _chunk_or_raise(t, k, chunk)
    m = _layer_masks(x, params, use_ffn, prologue, dropout_p, seed)
    used = [n for n in PARAM_ORDER if n in params
            and (use_ffn or n not in ("w1", "b1", "w2", "b2", "ln2_s", "ln2_b"))
            and (prologue or n not in ("pl_s", "pl_b"))]
    leaves = {n: params[n].detach().float().requires_grad_() for n in used}
    grads = {n: torch.zeros_like(v) for n, v in leaves.items()}
    d_end = torch.zeros_like(record[:, 0, 0])
    d_tail = torch.zeros_like(record[:, 0, 1:k])
    dxs = []
    with torch.enable_grad():
        for s in reversed(range(0, t, tc)):
            j = s // tc
            xj = x[:, s:s + tc].detach().float().requires_grad_()
            carry = record[:, j, 0].detach().float().requires_grad_()
            tail = record[:, j, 1:k].detach().float().requires_grad_()
            outs = _chunk_fwd(xj, carry, tail, leaves, _chunk_masks(m, s, s + tc), use_conv,
                              use_ffn, prologue)
            inputs = [xj, carry, tail, *leaves.values()]
            got = torch.autograd.grad(outs, inputs, [dout[:, s:s + tc].float(), d_end, d_tail],
                                      allow_unused=True)
            got = [torch.zeros_like(v) if g is None else g for g, v in zip(got, inputs)]
            dxs.append(got[0])
            d_end, d_tail = got[1], got[2]
            for n, g in zip(leaves, got[3:]):
                grads[n] += g
    return torch.cat(dxs[::-1], 1).to(x.dtype), grads


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _launch_fwd(x, plist, dims, tc, use_conv, use_ffn, prologue, dropout_p, seed):
    """The chunked forward; returns (out, record)."""
    b, t, d, c, k, f = dims
    nc = t // tc
    lib = _cuda.library("fused_layer_chunked.cu")
    out = torch.empty_like(x)
    alpha = torch.empty((b, t, c), device=x.device, dtype=torch.float32)
    bxh = torch.empty_like(alpha)
    hend = torch.empty((b, nc, c), device=x.device, dtype=torch.float32)
    pend = torch.empty_like(hend)
    record = torch.zeros((b, nc, REC_ROWS, c), device=x.device, dtype=torch.float32)
    ptrs = _cuda.pointer_array(plist)
    with torch.cuda.device(x.device):
        err = lib.recblr_layer_chunked_fwd(
            x.data_ptr(), out.data_ptr(), ptrs, alpha.data_ptr(), bxh.data_ptr(),
            hend.data_ptr(), pend.data_ptr(), record.data_ptr(), b, t, d, c, k, f, tc,
            int(use_conv), int(use_ffn), int(prologue), int(x.dtype == torch.bfloat16),
            *_dropout_args(dropout_p, seed), x.device.index, _stream(x),
        )
    _cuda.check(lib, err, "fused_recurrent_layer_chunked")
    fused_recurrent_layer_chunked.launches += 1
    return out, record


def fused_recurrent_layer_chunked_train(x, params, use_conv=True, use_ffn=True, prologue=False,
                                        dropout_p=0.0, seed=0, chunk=0):
    """The chunked forward on the card: (out, record)."""
    _require_cuda(x)
    plist, dims = _param_list(x, params, use_ffn, prologue)
    tc = _chunk_or_raise(dims[1], dims[4], chunk)
    return _launch_fwd(x, plist, dims, tc, use_conv, use_ffn, prologue, dropout_p, seed)


def fused_recurrent_layer_chunked_bwd(x, dout, record, params, use_conv=True, use_ffn=True,
                                      prologue=False, dropout_p=0.0, seed=0, chunk=0):
    """Backward of ``fused_recurrent_layer_chunked`` on the card: (dx in
    x's dtype, {param name: fp32 grad}) from x, dout and the forward's
    record, the weight grads summed in a fixed order."""
    _require_cuda(x)
    plist, dims = _param_list(x, params, use_ffn, prologue)
    b, t, d, c, k, f = dims
    tc = _chunk_or_raise(t, k, chunk)
    nc = t // tc
    dout = _check_dout(dout, (b, t, d), x)
    if record.dtype != torch.float32 or tuple(record.shape) != (b, nc, REC_ROWS, c) \
            or record.device != x.device or not record.is_contiguous():
        raise ValueError(f"record must be the forward's contiguous float32 "
                         f"{(b, nc, REC_ROWS, c)} on {x.device}")
    alpha = torch.empty((b, t, c), device=x.device, dtype=torch.float32)
    h = torch.empty_like(alpha)
    ds = torch.empty_like(alpha)
    dz = torch.empty_like(alpha)
    dxr = torch.empty((b, t, d), device=x.device, dtype=torch.float32)
    aend = torch.empty((b, nc, c), device=x.device, dtype=torch.float32)
    mend = torch.empty_like(aend)
    dx = torch.empty_like(x)
    ptrs, _keep, partial, grads, g = _bwd_buffers(x, plist, dims)
    lib = _cuda.library("fused_layer_chunked_bwd.cu")
    with torch.cuda.device(x.device):
        err = lib.recblr_layer_chunked_bwd(
            x.data_ptr(), dout.data_ptr(), ptrs, record.data_ptr(), alpha.data_ptr(),
            h.data_ptr(), ds.data_ptr(), dz.data_ptr(), dxr.data_ptr(), aend.data_ptr(),
            mend.data_ptr(), partial.data_ptr(), g, grads.data_ptr(), dx.data_ptr(),
            b, t, d, c, k, f, tc, int(use_conv), int(use_ffn), int(prologue),
            int(x.dtype == torch.bfloat16), *_dropout_args(dropout_p, seed),
            x.device.index, _stream(x),
        )
    _cuda.check(lib, err, "fused_recurrent_layer_chunked_bwd")
    fused_recurrent_layer_chunked_bwd.launches += 1
    return dx, _unflatten_grads(grads, plist, dims)


fused_recurrent_layer_chunked_bwd.launches = 0


class _LayerChunked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, opts, *plist):
        use_conv, use_ffn, prologue, p, seed, tc = opts
        out, record = fused_recurrent_layer_chunked_train(x, _param_dict(plist), use_conv,
                                                          use_ffn, prologue, p, seed, tc)
        ctx.opts = opts
        ctx.save_for_backward(x, record, *plist)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, record, *plist = ctx.saved_tensors
        dx, grads = fused_recurrent_layer_chunked_bwd(x, dout, record, _param_dict(plist),
                                                      *ctx.opts)
        return (dx, None, *_grad_tuple(grads))


def fused_recurrent_layer_chunked(x, params, use_conv=True, use_ffn=True, prologue=False,
                                  dropout_p=0.0, seed=0, chunk=0):
    """Complete RecurrentLayer forward with T in chunks of ``chunk``
    (``pick_chunk(T)`` when 0), differentiable in x and every param; the
    arguments as ``fused_recurrent_layer``'s.  Returns [B, T, D] in x's
    dtype."""
    if x.device.type == "cpu":
        return fused_recurrent_layer_chunked_plain(x, params, use_conv, use_ffn, prologue,
                                                   dropout_p, seed, chunk)[0]
    _require_cuda(x)
    plist, dims = _param_list(x, params, use_ffn, prologue)
    tc = _chunk_or_raise(dims[1], dims[4], chunk)
    if _needs_grad(x, plist):
        opts = (use_conv, use_ffn, prologue, float(dropout_p), int(seed), tc)
        return _LayerChunked.apply(x, opts, *plist)
    return _launch_fwd(x, plist, dims, tc, use_conv, use_ffn, prologue, dropout_p, seed)[0]


fused_recurrent_layer_chunked.launches = 0
