"""Softmax cross-entropy against the whole catalog, forward and backward:
hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.  Two paths, as in ``datamining_recblr_tpu/ops/fused_ce.py``:

* whole-table (``supports``): ``_ce_fwd_kernel`` via ``_ce_fwd`` :127
  and ``_ce_bwd_kernel`` via ``_ce_bwd`` :149, which the JAX package
  takes for a loss of ``MIN_ROWS`` rows or more (BERT4Rec's cloze loss:
  batch x mask budget = 81,920 rows at the bench shape);
  ``csrc/fused_ce.cu``:

      l     = x table^T + bias            fp32; columns >= valid_v at -1e30
      nll   = logsumexp(l) - l[target]    exp as fastmath.exp
      g     = (softmax(l) - onehot(target)) dnll
      dx    = g table,  dtable = g^T x,  dbias = sum_rows g

  With ``mm_bf16`` the logits take x and the table rounded to bf16 (fp32
  sums), dx takes g and the table rounded, dtable takes g and x unrounded
  (``fused_ce.py:114-122``).  The backward runs its products on the
  tensor cores at D <= 256 in both precisions (``bwd_uses_mma``: 3xTF32 in
  fp32, bf16 products with ``mm_bf16``), the fp32 FMA kernels above; so
  does the forward (``fwd_uses_mma``: 3xTF32 on ``mma.sync`` in fp32, with
  ``mm_bf16`` bf16 products on wgmma, the table rounded once a call into
  a [V, 64, 128 or 256] scratch the wrapper allocates), the FMA kernel
  above D 256.
* vocab-chunked, for tables beyond ``supports`` (XLong: V = 329,728):
  ``_cce_fwd_kernel`` via ``_cce_fwd`` :413 and the kernels of
  ``_cce_bwd`` :448; ``csrc/fused_ce_chunked.cu``, whose forward runs its
  logits on the tensor cores at D <= 128 in both precisions
  (``chunked_fwd_uses_mma``) and whose backward runs its products there
  with ``mm_bf16`` at D <= 128 (``chunked_bwd_uses_mma``).  The same function
  with the JAX chunked path's own rounding points: the target logit is
  x . table[t] + bias[t] with x unrounded (``:404-407``); g = softmax
  dnll without the one-hot term, dx = g table - dnll table[t] with the
  one-hot term unrounded, dtable = g^T x - dnll x at each target and
  dbias = sum g - dnll at each target (``:525-531``).

The kernels compute the logits in their own bodies and never write the
[N, V] logits to device memory; the forward keeps the per-row logsumexp
for the backward.  The table and the bias may be of any float type: they
are upcast to fp32 first, and with grad enabled their gradients come back
in their own types.

On a CPU tensor ``fused_softmax_ce`` computes its plain version (its
autograd runs the plain backward); on a CUDA tensor it launches its
kernel or raises, and with grad enabled it runs a
``torch.autograd.Function`` whose backward is the backward kernel.
``launches`` on ``fused_softmax_ce`` and ``fused_softmax_ce_bwd`` (the
whole-table kernels) and on ``fused_softmax_ce_chunked`` and
``fused_softmax_ce_chunked_bwd`` counts their kernel launches (a forward's
from any entry point), and ``mma_launches`` on the two backwards and on
``fused_softmax_ce_train`` and ``fused_softmax_ce_chunked_train`` (the
forwards', from any entry point) those of their tensor-core paths.
"""

from __future__ import annotations

import torch

from datamining_recblr_torch.ops import _cuda, fastmath

NEG = -1e30
# the JAX package's crossover below which its XLA CE is used (fused_ce.py:62)
MIN_ROWS = 8192
# the chunked kernel pays off once the [rows, V] fp32 logits the plain CE
# would materialize take this many bytes (fused_ce.py:260)
CHUNK_MIN_LOGITS_BYTES = 64 * 1024 * 1024
MAX_D = 512  # the kernels' 16 x 16 tiles hold rows of up to 512 floats
MMA_MAX_D = 128  # the chunked kernels' tensor-core tiles hold rows of up to 128
BWD_MMA_MAX_D = 256  # the whole-table kernels' tensor-core tiles: rows of up to 256


def supports(v: int, d: int) -> bool:
    """Whether the [V, D] table takes the whole-table kernel (the JAX
    package's VMEM-resident rule, ``fused_ce.py:65-66``)."""
    return v * d * 4 <= 32 * 1024 * 1024 and d <= MAX_D


def supports_chunked(v: int, d: int) -> bool:
    """Whether the [V, D] table takes the vocab-chunked kernel: any V."""
    return d <= MAX_D


def chunked_fwd_uses_mma(d: int, mm_bf16: bool) -> bool:
    """Whether the chunked forward runs its logits on the tensor cores
    (``csrc/fused_ce_chunked.cu`` ``cce_fwd_mma_kernel``): at D <= 128 in
    both precisions (bf16 products with ``mm_bf16``, else 3xTF32); above,
    the fp32 FMA kernel."""
    return d <= MMA_MAX_D


def chunked_bwd_uses_mma(d: int, mm_bf16: bool) -> bool:
    """Whether the chunked backward runs its products on the tensor cores
    (``csrc/fused_ce_chunked.cu`` passes (a) and (b)): with ``mm_bf16`` at
    D <= 128; otherwise it takes the fp32 FMA kernels."""
    return bool(mm_bf16) and d <= MMA_MAX_D


def bwd_uses_mma(d: int, mm_bf16: bool) -> bool:
    """Whether the whole-table backward runs its products on the tensor
    cores (``csrc/fused_ce.cu`` passes (a) and (b)): at D <= 256 in both
    precisions (``mm_bf16`` picks bf16 products or 3xTF32); above, the fp32
    FMA kernels."""
    return d <= BWD_MMA_MAX_D


def fwd_uses_mma(d: int, mm_bf16: bool) -> bool:
    """Whether the whole-table forward runs its logits on the tensor cores:
    where the backward does, at D <= 256 (``csrc/fused_ce.cu``
    ``ce_fwd_mma_kernel``, 3xTF32, and with ``mm_bf16``
    ``ce_fwd_wgmma_kernel``, bf16 products on wgmma); above, the fp32 FMA
    kernel."""
    return d <= BWD_MMA_MAX_D


def mma_dp(d: int) -> int:
    """D padded to the tensor-core kernels' width: 64, 128 or 256 (the
    rounded table's row in the bf16 forward's scratch)."""
    return 64 if d <= 64 else 128 if d <= 128 else 256


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _round(a, rb):
    return a.to(torch.bfloat16).float() if rb else a


def _logits(x, table, bias, valid_v, mm_bf16):
    """[N, V] fp32 logits, columns >= valid_v at -1e30."""
    logits = _round(x.float(), mm_bf16) @ _round(table.float(), mm_bf16).t() + bias.float()
    v = table.shape[0]
    if valid_v < v:
        col = torch.arange(v, device=x.device)[None, :]
        logits = torch.where(col < valid_v, logits, torch.full((), NEG, device=x.device))
    return logits


def _onehot(targets, v):
    return targets.long()[:, None] == torch.arange(v, device=targets.device)[None, :]


def _plain_fwd(x, table, bias, targets, valid_v, mm_bf16):
    """(nll, lse) [N] fp32."""
    logits = _logits(x, table, bias, valid_v, mm_bf16)
    m = logits.amax(-1, keepdim=True)
    lse = m[:, 0] + torch.log(fastmath.exp(logits - m).sum(-1))
    tgt = torch.where(_onehot(targets, table.shape[0]), logits, 0.0).sum(-1)
    return lse - tgt, lse


def fused_softmax_ce_bwd_plain(x, table, targets, dnll, bias=None, valid_v=None,
                               mm_bf16=False):
    """Plain PyTorch version of ``fused_softmax_ce_bwd``: (dx in x's
    dtype, dtable fp32 [V, D], dbias fp32 [V])."""
    v = table.shape[0]
    bias = _bias(bias, v, x.device)
    logits = _logits(x, table, bias, v if valid_v is None else int(valid_v), mm_bf16)
    e = fastmath.exp(logits - logits.amax(-1, keepdim=True))
    g = (e / e.sum(-1, keepdim=True) - _onehot(targets, v).float()) * dnll.float()[:, None]
    dx = (_round(g, mm_bf16) @ _round(table.float(), mm_bf16)).to(x.dtype)
    return dx, g.t() @ x.float(), g.sum(0)


class _PlainCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, table, bias, targets, valid_v, mm_bf16):
        ctx.save_for_backward(x, table, bias, targets)
        ctx.opts = (valid_v, mm_bf16)
        return _plain_fwd(x, table, bias, targets, valid_v, mm_bf16)[0]

    @staticmethod
    def backward(ctx, dnll):
        x, table, bias, targets = ctx.saved_tensors
        dx, dtab, dbias = fused_softmax_ce_bwd_plain(x, table, targets, dnll, bias, *ctx.opts)
        return dx, dtab.to(table.dtype), dbias.to(bias.dtype), None, None, None


def _bias(bias, v, device):
    return torch.zeros((v,), device=device) if bias is None else bias


def fused_softmax_ce_plain(x, table, targets, bias=None, valid_v=None, mm_bf16=False):
    """Plain PyTorch version of the whole-table ``fused_softmax_ce`` (any
    device): per-row nll [N] fp32, differentiable in x, table and bias;
    its backward is ``fused_softmax_ce_bwd_plain``, which rounds where the
    kernel rounds."""
    v = table.shape[0]
    return _PlainCE.apply(x, table, _bias(bias, v, x.device), targets,
                          v if valid_v is None else int(valid_v), bool(mm_bf16))


def _chunked_logits(x, table, bias, valid_v, mm_bf16):
    """[N, V] fp32 logits with the masked columns folded into the bias at
    -1e30 (the JAX package's ``_masked_bias``, ``fused_ce.py:385-391``)."""
    v = table.shape[0]
    b = bias.float()
    if valid_v < v:
        b = torch.where(torch.arange(v, device=b.device) < valid_v, b,
                        torch.full((), NEG, device=b.device))
    return _round(x.float(), mm_bf16) @ _round(table.float(), mm_bf16).t() + b


def _target_rows(table, targets, mm_bf16):
    """[N, D] fp32 table rows of the targets, rounded to bf16 with
    ``mm_bf16`` (``fused_ce.py:_tgt_rows``)."""
    return _round(table.float()[targets.long()], mm_bf16)


def fused_softmax_ce_chunked_fwd_plain(x, table, targets, bias=None, valid_v=None,
                                       mm_bf16=False):
    """Plain PyTorch version of ``fused_softmax_ce_chunked_train``: (nll,
    lse) [N] fp32, the target logit with x unrounded."""
    v = table.shape[0]
    bias = _bias(bias, v, x.device)
    logits = _chunked_logits(x, table, bias, v if valid_v is None else int(valid_v), mm_bf16)
    m = logits.amax(-1, keepdim=True)
    lse = m[:, 0] + torch.log(fastmath.exp(logits - m).sum(-1))
    tl = (x.float() * _target_rows(table, targets, mm_bf16)).sum(-1) \
        + bias.float()[targets.long()]
    return lse - tl, lse


def fused_softmax_ce_chunked_bwd_plain(x, table, targets, dnll, bias=None, valid_v=None,
                                       mm_bf16=False, lse=None):
    """Plain PyTorch version of ``fused_softmax_ce_chunked_bwd``: (dx in
    x's dtype, dtable fp32 [V, D], dbias fp32 [V]); ``lse`` is recomputed
    when None."""
    v = table.shape[0]
    bias = _bias(bias, v, x.device)
    valid_v = v if valid_v is None else int(valid_v)
    if lse is None:
        lse = fused_softmax_ce_chunked_fwd_plain(x, table, targets, bias, valid_v, mm_bf16)[1]
    dn = dnll.float()
    tgt = targets.long()
    xf = x.float()
    g = fastmath.exp(_chunked_logits(x, table, bias, valid_v, mm_bf16) - lse[:, None]) \
        * dn[:, None]
    dx = _round(g, mm_bf16) @ _round(table.float(), mm_bf16) \
        - dn[:, None] * _target_rows(table, tgt, mm_bf16)
    dtable = (g.t() @ xf).index_add(0, tgt, -(dn[:, None] * xf))
    dbias = g.sum(0).index_add(0, tgt, -dn)
    return dx.to(x.dtype), dtable, dbias


class _PlainCCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, table, bias, targets, valid_v, mm_bf16):
        nll, lse = fused_softmax_ce_chunked_fwd_plain(x, table, targets, bias, valid_v, mm_bf16)
        ctx.save_for_backward(x, table, bias, targets, lse)
        ctx.opts = (valid_v, mm_bf16)
        return nll

    @staticmethod
    def backward(ctx, dnll):
        x, table, bias, targets, lse = ctx.saved_tensors
        dx, dtab, dbias = fused_softmax_ce_chunked_bwd_plain(x, table, targets, dnll, bias,
                                                             *ctx.opts, lse=lse)
        return dx, dtab.to(table.dtype), dbias.to(bias.dtype), None, None, None


def fused_softmax_ce_chunked_plain(x, table, targets, bias=None, valid_v=None, mm_bf16=False):
    """Plain PyTorch version of ``fused_softmax_ce_chunked`` (any device):
    per-row nll [N] fp32, differentiable in x, table and bias; its backward
    is ``fused_softmax_ce_chunked_bwd_plain``."""
    v = table.shape[0]
    return _PlainCCE.apply(x, table, _bias(bias, v, x.device), targets,
                           v if valid_v is None else int(valid_v), bool(mm_bf16))


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------

def _check(x, table, targets, bias, valid_v, chunked):
    """Check the inputs against what the kernels take; return (table
    fp32, bias fp32, targets int32, valid_v).  The table and the bias are
    upcast (differentiably) from any float type."""
    if x.dim() != 2 or table.dim() != 2 or x.shape[1] != table.shape[1] or x.shape[0] < 1:
        raise ValueError(f"x must be [N >= 1, D] and table [V, D], got {tuple(x.shape)} and "
                         f"{tuple(table.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    n, d = x.shape
    v = table.shape[0]
    if chunked and not supports_chunked(v, d):
        raise ValueError(f"D = {d} is beyond the CE kernels (D <= {MAX_D})")
    if not chunked and not supports(v, d):
        raise ValueError(f"table [{v}, {d}] is beyond the whole-table kernel (V*D*4 <= 32 MiB, "
                         f"D <= {MAX_D}); fused_softmax_ce_chunked takes it")
    bias = _bias(bias, v, x.device)
    for name, t, shape in (("table", table, (v, d)), ("bias", bias, (v,))):
        if not t.is_floating_point() or t.device != x.device or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be a float {shape} tensor on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    table, bias = table.float(), bias.float()
    if not x.is_contiguous() or not table.is_contiguous() or not bias.is_contiguous():
        raise ValueError("x, table and bias must be contiguous")
    if targets.shape != (n,) or targets.device != x.device:
        raise ValueError(f"targets must be [{n}] on {x.device}")
    if targets.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"targets must be an integer tensor, got {targets.dtype}")
    valid_v = v if valid_v is None else int(valid_v)
    if not 0 <= valid_v <= v:
        raise ValueError(f"valid_v must be in [0, {v}], got {valid_v}")
    return table, bias, targets.to(torch.int32).contiguous(), valid_v


def _check_bwd_rows(x, dnll, lse):
    n = x.shape[0]
    for name, t in (("dnll", dnll), ("lse", lse)):
        if t is None or t.shape != (n,) or t.device != x.device:
            raise ValueError(f"{name} must be [{n}] on {x.device}")
    return dnll.float().contiguous(), lse.float().contiguous()


def _launch_fwd(x, table, bias, tgt32, valid_v, mm_bf16, train):
    """(nll, lse) [N] fp32; lse only when ``train``."""
    n, d = x.shape
    mma = fwd_uses_mma(d, mm_bf16)  # the C side dispatches on the same facts
    if mma and table.data_ptr() % 16:
        table = table.clone()  # the tensor-core kernels take a 16-byte aligned table
    # the bf16 forward on wgmma rounds the table once into [V, DP] bf16
    scratch = (torch.empty((table.shape[0], mma_dp(d)), device=x.device, dtype=torch.bfloat16)
               if mma and mm_bf16 else None)
    lib = _cuda.library("fused_ce.cu")
    nll = torch.empty((n,), device=x.device, dtype=torch.float32)
    lse = torch.empty_like(nll) if train else None
    with torch.cuda.device(x.device):
        err = lib.recblr_ce_fwd(
            x.data_ptr(), table.data_ptr(), bias.data_ptr(), tgt32.data_ptr(), nll.data_ptr(),
            None if lse is None else lse.data_ptr(),
            None if scratch is None else scratch.data_ptr(), n, table.shape[0], d, valid_v,
            int(x.dtype == torch.bfloat16), int(bool(mm_bf16)), x.device.index, _cuda.stream(x),
        )
    _cuda.check(lib, err, "fused_softmax_ce")
    fused_softmax_ce.launches += 1
    fused_softmax_ce_train.mma_launches += int(mma)
    return nll, lse


def fused_softmax_ce_train(x, table, targets, bias=None, valid_v=None, mm_bf16=False):
    """Whole-table forward on the card that keeps what the backward
    reads: (nll, lse) [N] fp32."""
    _cuda.require_cuda(x)
    table, bias, tgt32, valid_v = _check(x, table, targets, bias, valid_v, False)
    return _launch_fwd(x, table, bias, tgt32, valid_v, mm_bf16, True)


# the whole-table forward's launches on the tensor cores, from any entry
# point (``fused_softmax_ce.launches`` counts them all)
fused_softmax_ce_train.mma_launches = 0


def fused_softmax_ce_bwd(x, table, targets, dnll, bias=None, valid_v=None, mm_bf16=False, *,
                         lse):
    """Backward of the whole-table ``fused_softmax_ce`` on the card: (dx in
    x's dtype, dtable [V, D] fp32, dbias [V] fp32).  ``dnll``: [N]
    cotangent; ``lse``: [N] fp32 kept by ``fused_softmax_ce_train`` with
    the same arguments.  dtable and dbias are summed in a fixed order: the
    same bits from run to run; on the tensor cores where
    ``bwd_uses_mma``."""
    _cuda.require_cuda(x)
    table, bias, tgt32, valid_v = _check(x, table, targets, bias, valid_v, False)
    n, d = x.shape
    v = table.shape[0]
    dnll, lse = _check_bwd_rows(x, dnll, lse)
    mma = bwd_uses_mma(d, mm_bf16)  # the C side dispatches on the same fact
    if mma and table.data_ptr() % 16:
        table = table.clone()  # the tensor-core kernels copy it and x in 16-byte pieces
    if mma and x.data_ptr() % 16:
        x = x.clone()
    lib = _cuda.library("fused_ce.cu")
    # the dtable pass's row splits, from the kernel's occupancy on this card
    r = lib.recblr_ce_bwd_splits(n, v, d, int(bool(mm_bf16)), x.device.index)
    if r < 1:
        _cuda.check(lib, -r, "fused_softmax_ce_bwd")
    dx = torch.empty_like(x)
    partial = torch.empty((r, v * d + v), device=x.device, dtype=torch.float32)
    grads = torch.empty((v * d + v,), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = lib.recblr_ce_bwd(
            x.data_ptr(), table.data_ptr(), bias.data_ptr(), tgt32.data_ptr(), dnll.data_ptr(),
            lse.data_ptr(), dx.data_ptr(), r, partial.data_ptr(), grads.data_ptr(), n, v, d,
            valid_v, int(x.dtype == torch.bfloat16), int(bool(mm_bf16)), x.device.index,
            _cuda.stream(x),
        )
    _cuda.check(lib, err, "fused_softmax_ce_bwd")
    fused_softmax_ce_bwd.launches += 1
    fused_softmax_ce_bwd.mma_launches += int(mma)
    return dx, grads[: v * d].view(v, d), grads[v * d:]


fused_softmax_ce_bwd.launches = 0
fused_softmax_ce_bwd.mma_launches = 0  # those of them on the tensor cores


def _vocab_splits(n, v, d, device):
    """The chunked kernels' vocab splits: about four blocks per SM over
    the row blocks (64 rows for D <= 128, else 16), at most one per vocab
    tile."""
    tile = 64 if d <= 128 else 16
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-v // tile), -(-4 * sms // -(-n // tile))))


def _launch_cfwd(x, table, bias, tgt32, valid_v, mm_bf16, train):
    """(nll, lse) [N] fp32 of the chunked forward; lse only when
    ``train``."""
    n, d = x.shape
    v = table.shape[0]
    mma = chunked_fwd_uses_mma(d, mm_bf16)  # the C side dispatches on the same fact
    if mma and table.data_ptr() % 16:
        table = table.clone()  # the tensor-core kernel copies it in 16-byte pieces
    s = _vocab_splits(n, v, d, x.device)
    part = torch.empty((2, s, n), device=x.device, dtype=torch.float32)
    nll = torch.empty((n,), device=x.device, dtype=torch.float32)
    lse = torch.empty_like(nll) if train else None
    lib = _cuda.library("fused_ce_chunked.cu")
    with torch.cuda.device(x.device):
        err = lib.recblr_cce_fwd(
            x.data_ptr(), table.data_ptr(), bias.data_ptr(), tgt32.data_ptr(), part.data_ptr(), s,
            nll.data_ptr(), None if lse is None else lse.data_ptr(), n, v, d, valid_v,
            int(x.dtype == torch.bfloat16), int(bool(mm_bf16)), x.device.index, _cuda.stream(x),
        )
    _cuda.check(lib, err, "fused_softmax_ce_chunked")
    fused_softmax_ce_chunked.launches += 1
    fused_softmax_ce_chunked_train.mma_launches += int(mma)
    return nll, lse


def fused_softmax_ce_chunked_train(x, table, targets, bias=None, valid_v=None, mm_bf16=False):
    """Vocab-chunked forward on the card that keeps what the backward
    reads: (nll, lse) [N] fp32."""
    _cuda.require_cuda(x)
    table, bias, tgt32, valid_v = _check(x, table, targets, bias, valid_v, True)
    return _launch_cfwd(x, table, bias, tgt32, valid_v, mm_bf16, True)


# the chunked forward's launches on the tensor cores, from any entry point
# (``fused_softmax_ce_chunked.launches`` counts them all)
fused_softmax_ce_chunked_train.mma_launches = 0


def fused_softmax_ce_chunked_bwd(x, table, targets, dnll, bias=None, valid_v=None,
                                 mm_bf16=False, *, lse):
    """Backward of ``fused_softmax_ce_chunked`` on the card: (dx in x's
    dtype, dtable [V, D] fp32, dbias [V] fp32), every sum in a fixed
    order; on the tensor cores where ``chunked_bwd_uses_mma``.  ``lse``:
    [N] fp32 kept by ``fused_softmax_ce_chunked_train`` with the same
    arguments."""
    _cuda.require_cuda(x)
    table, bias, tgt32, valid_v = _check(x, table, targets, bias, valid_v, True)
    n, d = x.shape
    v = table.shape[0]
    dnll, lse = _check_bwd_rows(x, dnll, lse)
    mma = chunked_bwd_uses_mma(d, mm_bf16)  # the C side dispatches on the same two facts
    if mma and table.data_ptr() % 16:
        table = table.clone()  # the tensor-core kernels copy it and x in 16-byte pieces
    if mma and x.data_ptr() % 16:
        x = x.clone()
    s = _vocab_splits(n, v, d, x.device)
    dx = torch.empty_like(x)
    dxp = torch.empty((s, n, d), device=x.device, dtype=torch.float32)
    grads = torch.empty((v * d + v,), device=x.device, dtype=torch.float32)
    lib = _cuda.library("fused_ce_chunked.cu")
    with torch.cuda.device(x.device):
        err = lib.recblr_cce_bwd(
            x.data_ptr(), table.data_ptr(), bias.data_ptr(), tgt32.data_ptr(), dnll.data_ptr(),
            lse.data_ptr(), dx.data_ptr(), dxp.data_ptr(), s, grads.data_ptr(), n, v, d,
            valid_v, int(x.dtype == torch.bfloat16), int(bool(mm_bf16)), x.device.index,
            _cuda.stream(x),
        )
    _cuda.check(lib, err, "fused_softmax_ce_chunked_bwd")
    fused_softmax_ce_chunked_bwd.launches += 1
    fused_softmax_ce_chunked_bwd.mma_launches += int(mma)
    return dx, grads[: v * d].view(v, d), grads[v * d:]


fused_softmax_ce_chunked_bwd.launches = 0
fused_softmax_ce_chunked_bwd.mma_launches = 0  # those of them on the tensor cores


class _CE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, table, bias, tgt32, valid_v, mm_bf16, chunked):
        launch = _launch_cfwd if chunked else _launch_fwd
        nll, lse = launch(x, table, bias, tgt32, valid_v, mm_bf16, True)
        ctx.opts = (valid_v, mm_bf16)
        ctx.chunked = chunked
        ctx.save_for_backward(x, table, bias, tgt32, lse)
        return nll

    @staticmethod
    def backward(ctx, dnll):
        x, table, bias, tgt32, lse = ctx.saved_tensors
        bwd = fused_softmax_ce_chunked_bwd if ctx.chunked else fused_softmax_ce_bwd
        dx, dtab, dbias = bwd(x, table, tgt32, dnll, bias, *ctx.opts, lse=lse)
        return dx, dtab, dbias, None, None, None, None


def _on_card(x, table, targets, bias, valid_v, mm_bf16, chunked):
    _cuda.require_cuda(x)
    table, bias, tgt32, valid_v = _check(x, table, targets, bias, valid_v, chunked)
    if torch.is_grad_enabled() and (x.requires_grad or table.requires_grad
                                    or bias.requires_grad):
        return _CE.apply(x, table, bias, tgt32, valid_v, bool(mm_bf16), chunked)
    launch = _launch_cfwd if chunked else _launch_fwd
    return launch(x, table, bias, tgt32, valid_v, mm_bf16, False)[0]


def fused_softmax_ce_chunked(x, table, targets, bias=None, valid_v=None, mm_bf16=False):
    """``fused_softmax_ce`` through the vocab-chunked kernels at any V
    (D <= 512): the path of tables beyond ``supports``, which a caller may
    also take at a smaller V."""
    if x.device.type == "cpu":
        return fused_softmax_ce_chunked_plain(x, table, targets, bias, valid_v, mm_bf16)
    return _on_card(x, table, targets, bias, valid_v, mm_bf16, True)


fused_softmax_ce_chunked.launches = 0


def fused_softmax_ce(x, table, targets, bias=None, valid_v=None, mm_bf16=False):
    """Per-row softmax cross-entropy nll [N] fp32 of ``x [N, D]`` (fp32 or
    bf16) against the whole catalog ``table [V, D]`` plus ``bias [V]``
    (zeros when None; both of any float type), columns >= ``valid_v``
    (default V) masked; differentiable in x, table and bias.  ``mm_bf16``
    rounds the products' operands to bf16.  The whole-table kernel takes
    tables within ``supports``, ``fused_softmax_ce_chunked`` the others."""
    if not supports(*table.shape):
        return fused_softmax_ce_chunked(x, table, targets, bias, valid_v, mm_bf16)
    if x.device.type == "cpu":
        return fused_softmax_ce_plain(x, table, targets, bias, valid_v, mm_bf16)
    return _on_card(x, table, targets, bias, valid_v, mm_bf16, False)


fused_softmax_ce.launches = 0
