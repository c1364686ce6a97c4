"""Whole-layer RecBLR RecurrentLayer, forward and backward: hand-written
CUDA kernels for Hopper, each beside its plain PyTorch version.

Counterpart of ``datamining_recblr_tpu/ops/fused_layer.py``:

    x    = LN(dropout_m0(x); pl_s, pl_b)     [prologue]
    xz   = x @ W_in ;  xb, z = split(xz)
    xc   = silu(causal_conv(xb))             [use_conv]
    h    = BD-LRU scan of xc                 (gates matmul + decay math)
    y    = (silu(z) * h) @ W_out
    r1   = LN1(dropout_m1(y) + x)
    out  = LN2(dropout_m3(dropout_m2(silu(r1 @ W1 + b1)) @ W2 + b2) + r1)
                                             [use_ffn; else r1]

Four kernels:

* ``fused_recurrent_layer`` forward replaces ``_fwd_kernel``
  (``fused_layer.py:245``, via ``_layer_fwd``); ``csrc/fused_layer.cu``.
* its backward, ``fused_recurrent_layer_bwd``, replaces ``_bwd_kernel``
  and ``_bwd_kernel_multi`` (``:419``, ``:462``, via ``_layer_bwd``);
  ``csrc/fused_layer_bwd.cu``.
* ``fused_recurrent_layer_last`` forward replaces ``_last_fwd_kernel``
  (``:826``, via ``_layer_last_fwd``): the same layer with everything
  after the scan at each row's last position only, returning [B, D];
  ``csrc/fused_layer_last.cu``.
* its backward, ``fused_recurrent_layer_last_bwd``, replaces
  ``_last_bwd_kernel`` (``:844``, via ``_layer_last_bwd``);
  ``csrc/fused_layer_last_bwd.cu``.

Beside them, ``fused_ln_dropout`` (dropout(LN(x + pos)), the attention
baselines' embedding prologue) replaces ``_ln_dropout_fwd_kernel``
(``:1292``, via ``_ln_dropout_fwd`` :1332) and its backward,
``fused_ln_dropout_bwd``, ``_ln_dropout_bwd_kernel`` (``:1303``, via
``_ln_dropout_bwd`` :1357); and ``fused_dropout_ln`` (LN(dropout(x)), a
one-layer RecBLR's input dropout and LN, whose top layer cannot take the
prologue) replaces ``_dropout_ln_fwd_kernel`` (``:1172``, via
``_dropout_ln_fwd`` :1211), its backward ``fused_dropout_ln_bwd``
``_dropout_ln_bwd_kernel`` (``:1182``, via ``_dropout_ln_bwd`` :1235);
all four in ``csrc/ln_dropout.cu``.

The four layer kernels are bound by fp32 operations at the bench shape; the sources'
head comments say what each design does about it.  Dropout masks are
Philox draws keyed by the call's seed (``ops/philox.py``), the same bits
in a kernel, its backward and the plain versions.  A training forward
keeps alpha and h [B, T, C] fp32 for the backward while the stash policy
of the JAX package allows (T <= 256, at most 1 GiB a call); beyond it the
backward recomputes them.

On a CPU tensor a wrapper computes its plain version (autograd gives
the plain backward); on a CUDA tensor it launches its kernel or raises.
``launches`` on each of the four public functions counts its kernel
launches.  Params are fp32; x is fp32 or bf16 and the output (and dx)
has x's dtype, with fp32 math inside.
"""

from __future__ import annotations

import torch

from datamining_recblr_torch.ops import _cuda, fastmath, philox
from datamining_recblr_torch.ops.fused_bdlru import fused_bdlru_plain

LN_EPS = 1e-12

# the order of the kernels' parameter array (csrc/common.cuh LayerParams)
# and of their flat weight-grad output (csrc/common_bwd.cuh GradLayout)
PARAM_ORDER = (
    "w_in", "wc", "bc", "wg", "bg", "lam", "w_out", "ln1_s", "ln1_b",
    "w1", "b1", "w2", "b2", "ln2_s", "ln2_b", "pl_s", "pl_b",
)
_FFN_NAMES = ("w1", "b1", "w2", "b2", "ln2_s", "ln2_b")
# weights the backward kernels read transposed (common_bwd.cuh LayerParamsT)
_TRANSPOSED = ("w_in", "w_out", "w1", "w2", "wg")

MAX_D = 128
MAX_C = 128
# conv taps the kernels take: the halo rows are sized to K at run time
# (csrc/common.cuh xs_rows), up to the standalone BD-LRU's bound
MAX_K = 64
MAX_FFN = 512  # FFN width the kernels' shared memory holds
MAX_B = 65535  # grid dimension that carries the batch

# stash policy of the JAX package (fused_layer.py:700-712): keep the
# forward's intermediates for the backward iff T <= 256 and they take at
# most this many bytes in one call; the port keeps alpha and h
STASH_MAX_T = 256
STASH_BUDGET_BYTES = 1024**3


def supports(d: int, c: int) -> bool:
    return d <= MAX_D and c <= MAX_C


def stash_policy(b: int, t: int, c: int) -> bool:
    return t <= STASH_MAX_T and 2 * b * t * c * 4 <= STASH_BUDGET_BYTES


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _ln(v, scale, bias):
    mu = v.mean(-1, keepdim=True)
    var = (v - mu).square().mean(-1, keepdim=True)
    return (v - mu) * torch.rsqrt(var + LN_EPS) * scale + bias


def _masks(p, seed, b, t, d, f, use_ffn, prologue, device):
    """The layer's scaled keep-masks {m0 [B,T,D], m1, m2 [B,T,F], m3};
    empty at p = 0.  The last-position layer passes t = 1."""
    if not p:
        return {}
    m = {}
    if prologue:
        m["m0"] = philox.dropout_mask(seed, philox.M0, b, t, d, p, device)
    m["m1"] = philox.dropout_mask(seed, philox.M1, b, t, d, p, device)
    if use_ffn:
        m["m2"] = philox.dropout_mask(seed, philox.M2, b, t, f, p, device)
        m["m3"] = philox.dropout_mask(seed, philox.M3, b, t, d, p, device)
    return m


def _drop(v, masks, name):
    return v * masks[name].reshape(v.shape) if name in masks else v


def _ffn_tail(r1, p, masks=None):
    masks = masks or {}
    a1 = _drop(fastmath.silu(r1 @ p["w1"] + p["b1"]), masks, "m2")
    f2 = _drop(a1 @ p["w2"] + p["b2"], masks, "m3")
    return _ln(f2 + r1, p["ln2_s"], p["ln2_b"])


def _bdlru(xb, p, use_conv):
    return fused_bdlru_plain(xb, p["wc"], p["bc"], p["wg"], p["bg"], p["lam"], use_conv)


def _ffn_width(params, use_ffn):
    return params["w1"].shape[1] if use_ffn else 0


def fused_recurrent_layer_plain(x, params, use_conv=True, use_ffn=True,
                                prologue=False, dropout_p=0.0, seed=0):
    """Plain PyTorch version of ``fused_recurrent_layer`` (any device;
    differentiable, and its autograd gradient is the plain version of
    ``fused_recurrent_layer_bwd``)."""
    p = params
    xf = x.float()
    b, t, d = xf.shape
    m = _masks(dropout_p, seed, b, t, d, _ffn_width(p, use_ffn), use_ffn, prologue,
               x.device)
    if prologue:
        xf = _ln(_drop(xf, m, "m0"), p["pl_s"], p["pl_b"])
    c = p["w_in"].shape[1] // 2
    xz = xf @ p["w_in"]
    xb, z = xz[..., :c], xz[..., c:]
    h = _bdlru(xb, p, use_conv)
    y = _drop((fastmath.silu(z) * h) @ p["w_out"], m, "m1")
    out = _ln(y + xf, p["ln1_s"], p["ln1_b"])
    if use_ffn:
        out = _ffn_tail(out, p, m)
    return out.to(x.dtype)


def fused_recurrent_layer_last_plain(x, lens, params, use_conv=True,
                                     use_ffn=True, dropout_p=0.0, seed=0):
    """Plain PyTorch version of ``fused_recurrent_layer_last``.  The row
    is chosen by a one-hot of ``pos == lens - 1``, so a length of 0 (or
    above T) selects nothing and the tail runs on zeros.  The masks are
    [B, 1, .]: row b, position 0."""
    p = params
    xf = x.float()
    b, t, d = xf.shape
    m = _masks(dropout_p, seed, b, 1, d, _ffn_width(p, use_ffn), use_ffn, False,
               x.device)
    c = p["w_in"].shape[1] // 2
    h = _bdlru(xf @ p["w_in"][:, :c], p, use_conv)
    pos = torch.arange(t, device=x.device)[None, :]
    sel = (pos == lens.to(device=x.device, dtype=torch.long)[:, None] - 1)
    sel = sel.to(torch.float32)[:, :, None]
    xl = (sel * xf).sum(1)
    hl = (sel * h).sum(1)
    zl = xl @ p["w_in"][:, c:]
    yl = _drop((fastmath.silu(zl) * hl) @ p["w_out"], m, "m1")
    out = _ln(yl + xl, p["ln1_s"], p["ln1_b"])
    if use_ffn:
        out = _ffn_tail(out, p, m)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# argument checks shared by the kernel wrappers
# ---------------------------------------------------------------------------

def _shapes(d, c, k, f):
    return {
        "w_in": (d, 2 * c), "wc": (k, c), "bc": (c,), "wg": (c, 2 * c),
        "bg": (2 * c,), "lam": (c,), "w_out": (c, d), "ln1_s": (d,),
        "ln1_b": (d,), "w1": (d, f), "b1": (f,), "w2": (f, d), "b2": (d,),
        "ln2_s": (d,), "ln2_b": (d,), "pl_s": (d,), "pl_b": (d,),
    }


def _param_list(x, params, use_ffn, prologue):
    """Check x and the params against what the kernels take; return the
    kernels' parameter array in PARAM_ORDER (None where unused) and the
    sizes (B, T, D, C, K, F)."""
    if x.dim() != 3:
        raise ValueError(f"x must be [B, T, D], got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    b, t, d = x.shape
    c = params["w_out"].shape[0]
    k = params["wc"].shape[0]
    f = _ffn_width(params, use_ffn)
    if not supports(d, c) or not 1 <= k <= min(t, MAX_K) or f > MAX_FFN \
            or not 1 <= b <= MAX_B:
        raise ValueError(
            f"unsupported shape B={b} T={t} D={d} C={c} K={k} F={f}: the "
            f"kernels take D, C <= 128, 1 <= K <= min(T, {MAX_K}), "
            f"F <= {MAX_FFN}, 1 <= B <= {MAX_B}"
        )
    want = _shapes(d, c, k, f)
    used = set(PARAM_ORDER[:9])
    if use_ffn:
        used |= set(_FFN_NAMES)
    if prologue:
        used |= {"pl_s", "pl_b"}
    plist = []
    for name in PARAM_ORDER:
        if name not in used:
            plist.append(None)
            continue
        v = params[name]
        if v.dtype != torch.float32 or not v.is_contiguous() \
                or v.device != x.device or tuple(v.shape) != want[name]:
            raise ValueError(
                f"param {name}: want contiguous float32 {want[name]} on "
                f"{x.device}, got {v.dtype} {tuple(v.shape)} on {v.device}"
            )
        plist.append(v)
    return plist, (b, t, d, c, k, f)


def _lens32(lens, x):
    b = x.shape[0]
    if lens.shape != (b,) or lens.device != x.device:
        raise ValueError(f"lens must be [{b}] on {x.device}")
    if lens.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"lens must be an integer tensor, got {lens.dtype}")
    return lens.to(torch.int32).contiguous()


def _dropout_args(p, seed):
    """(on, seed, threshold, scale) of the kernels' Dropout struct."""
    p = float(p)
    if p == 0.0:
        return 0, 0, 0, 1.0
    if not 0.0 < p < 1.0:
        raise ValueError(f"dropout_p must be in [0, 1), got {p}")
    return 1, int(seed) & 0xFFFFFFFFFFFFFFFF, philox.keep_threshold(p), 1.0 / (1.0 - p)


def _check_dout(dout, shape, x):
    if tuple(dout.shape) != tuple(shape) or dout.dtype != x.dtype \
            or dout.device != x.device:
        raise ValueError(
            f"dout must be {x.dtype} {tuple(shape)} on {x.device}, got "
            f"{dout.dtype} {tuple(dout.shape)} on {dout.device}"
        )
    return dout.contiguous()


def _check_saved(saved, b, t, c, x):
    for v in saved:
        if v.dtype != torch.float32 or tuple(v.shape) != (b, t, c) \
                or v.device != x.device or not v.is_contiguous():
            raise ValueError(f"saved alpha/h must be contiguous float32 "
                             f"{(b, t, c)} on {x.device}")
    return saved


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _launch_fwd(x, plist, dims, use_conv, use_ffn, prologue, dropout_p, seed):
    """K1 forward; returns (out, alpha, h): the scratch holds alpha and h
    [B, T, C] fp32 on return."""
    b, t, d, c, k, f = dims
    lib = _cuda.library("fused_layer.cu")
    out = torch.empty_like(x)
    alpha = torch.empty((b, t, c), device=x.device, dtype=torch.float32)
    h = torch.empty_like(alpha)
    ptrs = _cuda.pointer_array(plist)
    with torch.cuda.device(x.device):
        err = lib.recblr_layer_fwd(
            x.data_ptr(), out.data_ptr(), ptrs, alpha.data_ptr(), h.data_ptr(),
            b, t, d, c, k, f, int(use_conv), int(use_ffn), int(prologue),
            int(x.dtype == torch.bfloat16), *_dropout_args(dropout_p, seed),
            x.device.index, _cuda.stream(x),
        )
    _cuda.check(lib, err, "fused_recurrent_layer")
    fused_recurrent_layer.launches += 1
    return out, alpha, h


def _launch_last_fwd(x, lens32, plist, dims, use_conv, use_ffn, dropout_p, seed,
                     stash):
    """K2 forward; returns (out, alpha, h) where with ``stash`` the
    scratch holds alpha and h below each row's length on return."""
    b, t, d, c, k, f = dims
    lib = _cuda.library("fused_layer_last.cu")
    out = torch.empty((b, d), device=x.device, dtype=x.dtype)
    alpha = torch.empty((b, t, c), device=x.device, dtype=torch.float32)
    h = torch.empty_like(alpha)
    h_last = torch.empty((b, c), device=x.device, dtype=torch.float32)
    ptrs = _cuda.pointer_array(plist)
    with torch.cuda.device(x.device):
        err = lib.recblr_layer_last_fwd(
            x.data_ptr(), lens32.data_ptr(), out.data_ptr(), ptrs,
            alpha.data_ptr(), h.data_ptr(), h_last.data_ptr(),
            b, t, d, c, k, f, int(use_conv), int(use_ffn),
            int(x.dtype == torch.bfloat16), int(stash),
            *_dropout_args(dropout_p, seed), x.device.index, _cuda.stream(x),
        )
    _cuda.check(lib, err, "fused_recurrent_layer_last")
    fused_recurrent_layer_last.launches += 1
    return out, alpha, h


def _bwd_buffers(x, plist, dims):
    """Pointer array with the transposed weights appended, the zeroed
    [G, P] partials, the [P] grads and G."""
    b, t, d, c, k, f = dims
    named = dict(zip(PARAM_ORDER, plist))
    tlist = [None if named[n] is None else named[n].t().contiguous() for n in _TRANSPOSED]
    ptrs = _cuda.pointer_array(plist + tlist)
    size = sum(int(torch.Size(s).numel()) for s in _shapes(d, c, k, f).values())
    g = _cuda.grad_blocks(x.device)
    partial = torch.zeros((g, size), device=x.device, dtype=torch.float32)
    grads = torch.empty((size,), device=x.device, dtype=torch.float32)
    return ptrs, tlist, partial, grads, g


def _unflatten_grads(grads, plist, dims):
    """The flat [P] grads (GradLayout order) -> {name: grad} of the
    params in use."""
    b, t, d, c, k, f = dims
    shapes = _shapes(d, c, k, f)
    out = {}
    o = 0
    for name, v in zip(PARAM_ORDER, plist):
        n = int(torch.Size(shapes[name]).numel())
        if v is not None:
            out[name] = grads[o:o + n].view(shapes[name])
        o += n
    return out


def fused_recurrent_layer_bwd(x, dout, params, use_conv=True, use_ffn=True,
                              prologue=False, dropout_p=0.0, seed=0, saved=None):
    """Backward of ``fused_recurrent_layer`` on the card: (dx in x's
    dtype, {param name: fp32 grad}).  ``saved``: (alpha, h) kept by a
    training forward (``fused_recurrent_layer_train``), or None to
    recompute them."""
    _cuda.require_cuda(x)
    plist, dims = _param_list(x, params, use_ffn, prologue)
    b, t, d, c, k, f = dims
    dout = _check_dout(dout, (b, t, d), x)
    if saved is None:
        alpha = torch.empty((b, t, c), device=x.device, dtype=torch.float32)
        h = torch.empty_like(alpha)
    else:
        alpha, h = _check_saved(saved, b, t, c, x)
    ds = torch.empty((b, t, c), device=x.device, dtype=torch.float32)
    dz = torch.empty_like(ds)
    dxr = torch.empty((b, t, d), device=x.device, dtype=torch.float32)
    dx = torch.empty_like(x)
    ptrs, _keep, partial, grads, g = _bwd_buffers(x, plist, dims)
    lib = _cuda.library("fused_layer_bwd.cu")
    with torch.cuda.device(x.device):
        err = lib.recblr_layer_bwd(
            x.data_ptr(), dout.data_ptr(), ptrs, alpha.data_ptr(), h.data_ptr(),
            int(saved is None), ds.data_ptr(), dz.data_ptr(), dxr.data_ptr(),
            partial.data_ptr(), g, grads.data_ptr(), dx.data_ptr(),
            b, t, d, c, k, f, int(use_conv), int(use_ffn), int(prologue),
            int(x.dtype == torch.bfloat16), *_dropout_args(dropout_p, seed),
            x.device.index, _cuda.stream(x),
        )
    _cuda.check(lib, err, "fused_recurrent_layer_bwd")
    fused_recurrent_layer_bwd.launches += 1
    return dx, _unflatten_grads(grads, plist, dims)


def fused_recurrent_layer_last_bwd(x, lens, dout, params, use_conv=True,
                                   use_ffn=True, dropout_p=0.0, seed=0, saved=None):
    """Backward of ``fused_recurrent_layer_last`` on the card: (dx
    [B, T, D] in x's dtype, 0 at and beyond each row's length; {param
    name: fp32 grad}).  ``saved``: (alpha, h) kept by a training forward,
    or None to recompute them."""
    _cuda.require_cuda(x)
    plist, dims = _param_list(x, params, use_ffn, False)
    b, t, d, c, k, f = dims
    lens32 = _lens32(lens, x)
    dout = _check_dout(dout, (b, d), x)
    if saved is None:
        alpha = torch.empty((b, t, c), device=x.device, dtype=torch.float32)
        h = torch.empty_like(alpha)
    else:
        alpha, h = _check_saved(saved, b, t, c, x)
    ds = torch.empty((b, t, c), device=x.device, dtype=torch.float32)
    dhl = torch.empty((b, c), device=x.device, dtype=torch.float32)
    dxr = torch.empty((b, d), device=x.device, dtype=torch.float32)
    dx = torch.empty_like(x)
    ptrs, _keep, partial, grads, g = _bwd_buffers(x, plist, dims)
    lib = _cuda.library("fused_layer_last_bwd.cu")
    with torch.cuda.device(x.device):
        err = lib.recblr_layer_last_bwd(
            x.data_ptr(), lens32.data_ptr(), dout.data_ptr(), ptrs, alpha.data_ptr(),
            h.data_ptr(), int(saved is None), ds.data_ptr(), dhl.data_ptr(),
            dxr.data_ptr(), partial.data_ptr(), g, grads.data_ptr(), dx.data_ptr(),
            b, t, d, c, k, f, int(use_conv), int(use_ffn),
            int(x.dtype == torch.bfloat16), *_dropout_args(dropout_p, seed),
            x.device.index, _cuda.stream(x),
        )
    _cuda.check(lib, err, "fused_recurrent_layer_last_bwd")
    fused_recurrent_layer_last_bwd.launches += 1
    return dx, _unflatten_grads(grads, plist, dims)


fused_recurrent_layer_bwd.launches = 0
fused_recurrent_layer_last_bwd.launches = 0


# ---------------------------------------------------------------------------
# training forwards and autograd
# ---------------------------------------------------------------------------

def fused_recurrent_layer_train(x, params, use_conv=True, use_ffn=True,
                                prologue=False, dropout_p=0.0, seed=0):
    """K1 forward on the card that keeps what the backward reads: (out,
    (alpha, h)), or (out, None) beyond the stash policy."""
    _cuda.require_cuda(x)
    plist, dims = _param_list(x, params, use_ffn, prologue)
    out, alpha, h = _launch_fwd(x, plist, dims, use_conv, use_ffn, prologue,
                                dropout_p, seed)
    b, t, _, c, _, _ = dims
    return out, ((alpha, h) if stash_policy(b, t, c) else None)


def fused_recurrent_layer_last_train(x, lens, params, use_conv=True, use_ffn=True,
                                     dropout_p=0.0, seed=0):
    """K2 forward on the card that keeps what the backward reads: (out,
    (alpha, h)), or (out, None) beyond the stash policy."""
    _cuda.require_cuda(x)
    plist, dims = _param_list(x, params, use_ffn, False)
    b, t, _, c, _, _ = dims
    stash = stash_policy(b, t, c)
    out, alpha, h = _launch_last_fwd(x, _lens32(lens, x), plist, dims, use_conv,
                                     use_ffn, dropout_p, seed, stash)
    return out, ((alpha, h) if stash else None)


def _param_dict(plist):
    return {n: v for n, v in zip(PARAM_ORDER, plist) if v is not None}


def _grad_tuple(grads):
    return tuple(grads.get(n) for n in PARAM_ORDER)


class _Layer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, opts, *plist):
        use_conv, use_ffn, prologue, p, seed = opts
        out, saved = fused_recurrent_layer_train(x, _param_dict(plist), use_conv,
                                                 use_ffn, prologue, p, seed)
        ctx.opts = opts
        ctx.stashed = saved is not None
        ctx.save_for_backward(x, *(saved or ()), *plist)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, *rest = ctx.saved_tensors
        saved, plist = (rest[:2], rest[2:]) if ctx.stashed else (None, rest)
        dx, grads = fused_recurrent_layer_bwd(x, dout, _param_dict(plist), *ctx.opts,
                                              saved=saved)
        return (dx, None, *_grad_tuple(grads))


class _LayerLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lens, opts, *plist):
        use_conv, use_ffn, p, seed = opts
        out, saved = fused_recurrent_layer_last_train(x, lens, _param_dict(plist),
                                                      use_conv, use_ffn, p, seed)
        ctx.opts = opts
        ctx.stashed = saved is not None
        ctx.save_for_backward(x, lens, *(saved or ()), *plist)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, lens, *rest = ctx.saved_tensors
        saved, plist = (rest[:2], rest[2:]) if ctx.stashed else (None, rest)
        dx, grads = fused_recurrent_layer_last_bwd(x, lens, dout, _param_dict(plist),
                                                   *ctx.opts, saved=saved)
        return (dx, None, None, *_grad_tuple(grads))


# ---------------------------------------------------------------------------
# public forwards
# ---------------------------------------------------------------------------

def fused_recurrent_layer(x, params, use_conv=True, use_ffn=True,
                          prologue=False, dropout_p=0.0, seed=0):
    """Complete RecurrentLayer forward, differentiable in x and every
    param.  x: [B, T, D]; params: w_in [D,2C], wc [K,C], bc [C],
    wg [C,2C], bg [2C], lam [C], w_out [C,D], ln1_s/ln1_b [D], with
    use_ffn w1 [D,F], b1 [F], w2 [F,D], b2 [D], ln2_s/ln2_b [D], with
    prologue pl_s/pl_b [D] (x is then the raw embedding block);
    dropout_p and the 64-bit seed of its masks (0: no masks).  Returns
    [B, T, D] in x's dtype."""
    if x.device.type == "cpu":
        return fused_recurrent_layer_plain(x, params, use_conv, use_ffn, prologue,
                                           dropout_p, seed)
    _cuda.require_cuda(x)
    plist, dims = _param_list(x, params, use_ffn, prologue)
    if _cuda.needs_grad(x, plist):
        opts = (use_conv, use_ffn, prologue, float(dropout_p), int(seed))
        return _Layer.apply(x, opts, *plist)
    out, _, _ = _launch_fwd(x, plist, dims, use_conv, use_ffn, prologue, dropout_p,
                            seed)
    return out


def fused_recurrent_layer_last(x, lens, params, use_conv=True, use_ffn=True,
                               dropout_p=0.0, seed=0):
    """Top RecurrentLayer forward at each row's last valid position only,
    differentiable in x and every param.  x: [B, T, D]; lens: int [B]
    1-based valid lengths (0 or above T selects nothing); params as for
    ``fused_recurrent_layer`` without the prologue.  Returns [B, D] in
    x's dtype."""
    if x.device.type == "cpu":
        return fused_recurrent_layer_last_plain(x, lens, params, use_conv, use_ffn,
                                                dropout_p, seed)
    _cuda.require_cuda(x)
    plist, dims = _param_list(x, params, use_ffn, False)
    lens32 = _lens32(lens, x)
    if _cuda.needs_grad(x, plist):
        opts = (use_conv, use_ffn, float(dropout_p), int(seed))
        return _LayerLast.apply(x, lens32, opts, *plist)
    out, _, _ = _launch_last_fwd(x, lens32, plist, dims, use_conv, use_ffn, dropout_p,
                                 seed, False)
    return out


fused_recurrent_layer.launches = 0
fused_recurrent_layer_last.launches = 0


# ---------------------------------------------------------------------------
# dropout(LN(x + pos)): the attention baselines' embedding prologue
# ---------------------------------------------------------------------------

MAX_LN_D = 512  # the prologue is fused for D <= 512 (models/layers.py)


def fused_ln_dropout_plain(x, pos, scale, bias, dropout_p=0.0, seed=0, t0=0):
    """Plain PyTorch version of ``fused_ln_dropout``: LN(x + pos) over D,
    pos [T, D] added in fp32, times the M0 mask at positions t0 .. t0 + T
    - 1, returned in x's dtype (differentiable; its autograd gradient is
    the plain version of ``fused_ln_dropout_bwd``)."""
    out = _ln(x.float() + pos.float(), scale, bias)
    if dropout_p:
        b, t, d = x.shape
        out = out * philox.dropout_mask(seed, philox.M0, b, t, d, dropout_p, x.device, t0)
    return out.to(x.dtype)


def _ln_checks(x, pos, scale, bias):
    """Check x [B, T, D] and the [T, D] pos (None: none), [D] scale and
    bias against what the LN kernels take; return (B, T, D)."""
    if x.dim() != 3 or x.dtype not in (torch.float32, torch.bfloat16) \
            or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous float32 or bfloat16 [B, T, D], got "
                         f"{x.dtype} {tuple(x.shape)}")
    b, t, d = x.shape
    if d > MAX_LN_D or b < 1:
        raise ValueError(f"unsupported shape B={b} D={d}: the kernels take B >= 1, "
                         f"D <= {MAX_LN_D}")
    for name, v, shape in (("pos", pos, (t, d)), ("scale", scale, (d,)),
                           ("bias", bias, (d,))):
        if v is None and name == "pos":
            continue
        if v.dtype != torch.float32 or not v.is_contiguous() \
                or v.device != x.device or tuple(v.shape) != shape:
            raise ValueError(f"{name}: want contiguous float32 {shape} on {x.device}, "
                             f"got {v.dtype} {tuple(v.shape)} on {v.device}")
    return b, t, d


def _launch_ln_fwd(x, pos, scale, bias, dropout_p, seed, t0=0):
    b, t, d = _ln_checks(x, pos, scale, bias)
    lib = _cuda.library("ln_dropout.cu")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.recblr_ln_pos_fwd(
            x.data_ptr(), pos.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), b, t, d, int(t0), int(x.dtype == torch.bfloat16),
            *_dropout_args(dropout_p, seed), x.device.index, _cuda.stream(x),
        )
    _cuda.check(lib, err, "fused_ln_dropout")
    fused_ln_dropout.launches += 1
    return out


def _ln_bwd_chunks(b: int) -> int:
    """Batch chunks of the LN backwards' grid (csrc/ln_dropout.cu): each
    block walks the rows of one chunk (32 or more) at a tile of positions,
    so B 2,048 gives 64 chunks and enough blocks to fill the card."""
    return max(1, min(64, b // 32))


def fused_ln_dropout_bwd(x, pos, dout, scale, bias, dropout_p=0.0, seed=0, t0=0):
    """Backward of ``fused_ln_dropout`` on the card: (dx in x's dtype,
    dpos [T, D], dscale [D], dbias [D]; fp32), dpos the batch sum of the
    LN input's gradient (a chunk's rows at ``t0``), every sum in a fixed
    order."""
    _cuda.require_cuda(x)
    b, t, d = _ln_checks(x, pos, scale, bias)
    dout = _check_dout(dout, (b, t, d), x)
    chunks = _ln_bwd_chunks(b)
    dx = torch.empty_like(x)
    pos_part = torch.empty((chunks, t, d), device=x.device, dtype=torch.float32)
    sb_part = torch.empty((chunks * t, 2 * d), device=x.device, dtype=torch.float32)
    dpos = torch.empty((t, d), device=x.device, dtype=torch.float32)
    dsb = torch.empty((2 * d,), device=x.device, dtype=torch.float32)
    lib = _cuda.library("ln_dropout.cu")
    with torch.cuda.device(x.device):
        err = lib.recblr_ln_pos_bwd(
            x.data_ptr(), pos.data_ptr(), dout.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), dx.data_ptr(), pos_part.data_ptr(), sb_part.data_ptr(),
            dpos.data_ptr(), dsb.data_ptr(), b, t, d, chunks, int(t0),
            int(x.dtype == torch.bfloat16), *_dropout_args(dropout_p, seed),
            x.device.index, _cuda.stream(x),
        )
    _cuda.check(lib, err, "fused_ln_dropout_bwd")
    fused_ln_dropout_bwd.launches += 1
    return dx, dpos, dsb[:d], dsb[d:]


class _LnDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pos, scale, bias, opts):
        ctx.opts = opts
        ctx.save_for_backward(x, pos, scale, bias)
        return _launch_ln_fwd(x, pos, scale, bias, *opts)

    @staticmethod
    def backward(ctx, dout):
        x, pos, scale, bias = ctx.saved_tensors
        dx, dpos, dscale, dbias = fused_ln_dropout_bwd(x, pos, dout, scale, bias, *ctx.opts)
        return dx, dpos, dscale, dbias, None


def fused_ln_dropout(x, pos, scale, bias, dropout_p=0.0, seed=0, t0=0):
    """dropout(LN(x + pos)) with eps 1e-12, the embedding prologue of SASRec
    and BERT4Rec (``fused_layer.py:fused_ln_dropout`` of the JAX package),
    differentiable in x, pos, scale and bias.  x: [B, T, D] fp32 or bf16;
    pos [T, D], scale and bias [D] fp32; the M0 mask of ``seed`` at rate
    ``dropout_p``, drawn at positions t0 .. t0 + T - 1 (a seq rank's time
    chunk, whose rows of the positional table ``pos`` holds).  Returns
    [B, T, D] in x's dtype."""
    if x.device.type == "cpu":
        return fused_ln_dropout_plain(x, pos, scale, bias, dropout_p, seed, t0)
    _cuda.require_cuda(x)
    opts = (float(dropout_p), int(seed), int(t0))
    if _cuda.needs_grad(x, [pos, scale, bias]):
        return _LnDropout.apply(x, pos, scale, bias, opts)
    return _launch_ln_fwd(x, pos, scale, bias, *opts)


fused_ln_dropout.launches = 0
fused_ln_dropout_bwd.launches = 0


# ---------------------------------------------------------------------------
# LN(dropout(x)): a one-layer RecBLR's input dropout and LN
# ---------------------------------------------------------------------------

def fused_dropout_ln_plain(x, scale, bias, dropout_p=0.0, seed=0):
    """Plain PyTorch version of ``fused_dropout_ln``: LN over D of x times
    the M0 mask of ``seed`` (the bits of ``layers.dropout(x, p, seed)``),
    in fp32, returned in x's dtype (differentiable; its autograd gradient
    is the plain version of ``fused_dropout_ln_bwd``)."""
    xf = x.float()
    if dropout_p:
        b, t, d = x.shape
        xf = xf * philox.dropout_mask(seed, philox.M0, b, t, d, dropout_p, x.device)
    return _ln(xf, scale, bias).to(x.dtype)


def _launch_dln_fwd(x, scale, bias, dropout_p, seed):
    b, t, d = _ln_checks(x, None, scale, bias)
    lib = _cuda.library("ln_dropout.cu")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.recblr_dropout_ln_fwd(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), b, t, d,
            int(x.dtype == torch.bfloat16), *_dropout_args(dropout_p, seed),
            x.device.index, _cuda.stream(x),
        )
    _cuda.check(lib, err, "fused_dropout_ln")
    fused_dropout_ln.launches += 1
    return out


def fused_dropout_ln_bwd(x, dout, scale, bias, dropout_p=0.0, seed=0):
    """Backward of ``fused_dropout_ln`` on the card: (dx in x's dtype,
    dscale [D], dbias [D] fp32), the sums over every (row, position) in a
    fixed order; the mask is drawn again, not stored."""
    _cuda.require_cuda(x)
    b, t, d = _ln_checks(x, None, scale, bias)
    dout = _check_dout(dout, (b, t, d), x)
    chunks = _ln_bwd_chunks(b)
    dx = torch.empty_like(x)
    sb_part = torch.empty((chunks * t, 2 * d), device=x.device, dtype=torch.float32)
    dsb = torch.empty((2 * d,), device=x.device, dtype=torch.float32)
    lib = _cuda.library("ln_dropout.cu")
    with torch.cuda.device(x.device):
        err = lib.recblr_dropout_ln_bwd(
            x.data_ptr(), dout.data_ptr(), scale.data_ptr(), dx.data_ptr(), sb_part.data_ptr(),
            dsb.data_ptr(), b, t, d, chunks, int(x.dtype == torch.bfloat16),
            *_dropout_args(dropout_p, seed), x.device.index, _cuda.stream(x),
        )
    _cuda.check(lib, err, "fused_dropout_ln_bwd")
    fused_dropout_ln_bwd.launches += 1
    return dx, dsb[:d], dsb[d:]


class _DropoutLn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, opts):
        ctx.opts = opts
        ctx.save_for_backward(x, scale, bias)
        return _launch_dln_fwd(x, scale, bias, *opts)

    @staticmethod
    def backward(ctx, dout):
        x, scale, bias = ctx.saved_tensors
        dx, dscale, dbias = fused_dropout_ln_bwd(x, dout, scale, bias, *ctx.opts)
        return dx, dscale, dbias, None


def fused_dropout_ln(x, scale, bias, dropout_p=0.0, seed=0):
    """LN(dropout(x)) with eps 1e-12, a one-layer RecBLR's input dropout
    and LN (``fused_layer.py:fused_dropout_ln`` of the JAX package),
    differentiable in x, scale and bias.  x: [B, T, D] fp32 or bf16;
    scale and bias [D] fp32; x's element (b, t, d) is kept by the M0 mask
    of ``seed`` at rate ``dropout_p`` at the same coordinates, the bits of
    ``layers.dropout``.  Returns [B, T, D] in x's dtype."""
    if x.device.type == "cpu":
        return fused_dropout_ln_plain(x, scale, bias, dropout_p, seed)
    _cuda.require_cuda(x)
    opts = (float(dropout_p), int(seed))
    if _cuda.needs_grad(x, [scale, bias]):
        return _DropoutLn.apply(x, scale, bias, opts)
    return _launch_dln_fwd(x, scale, bias, *opts)


fused_dropout_ln.launches = 0
fused_dropout_ln_bwd.launches = 0
