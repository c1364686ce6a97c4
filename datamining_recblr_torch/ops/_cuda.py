"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes``; all
sources build in parallel, one ``nvcc`` each: ``SOURCES``, the model
paths', and ``PROBE_SOURCES``, the probes', when asked for.  Builds go to
``build/torch_kernels/`` beside the package (listed in ``.gitignore``),
named by a hash of the sources and flags, so a changed source is
rebuilt and an unchanged one is reused.  Nothing here runs at import
time: the first kernel launch builds what it needs.  The helpers at the
end are shared by every kernel wrapper (the device check, the stream,
the rows of the weight-grad partials, whether autograd must see a call).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
SOURCES = ("fused_layer.cu", "fused_layer_last.cu", "fused_layer_bwd.cu",
           "fused_layer_last_bwd.cu", "ln_dropout.cu", "fused_block.cu",
           "fused_block_last.cu", "fused_block_bwd.cu", "fused_block_last_bwd.cu",
           "fused_block_sel.cu", "fused_block_sel_bwd.cu", "fused_ce.cu",
           "fused_layer_chunked.cu", "fused_layer_chunked_bwd.cu", "fused_ce_chunked.cu",
           "emb_grad.cu", "linear_scan.cu", "fused_bdlru.cu", "fused_bdlru_bwd.cu",
           "attention.cu", "attention_bwd.cu")
# the probes' kernels (probes/, queue B row 17): built at a probe's first
# use, apart from the model paths' sources
PROBE_SOURCES = ("probe_unit_overlap.cu", "probe_vpu_ops.cu", "probe_scan_chunked.cu",
                 "probe_ce_mxu.cu", "probe_emb_gather.cu", "probe_mask_replay_check.cu")
HEADERS = ("common.cuh", "common_bwd.cuh", "attn_common.cuh", "attn_bwd.cuh", "ce_common.cuh",
           "ce_mma.cuh",
           "attention.cuh", "gemm_tile.cuh", "mma_tile.cuh", "mma_smem.cuh", "layer_fwd.cuh")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",  # registers, shared memory and spills per kernel
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# one whole Dropout (csrc/common.cuh: on, seed, thresh, scale); every entry
# point ends with the card and the stream
_D1 = [_I, ctypes.c_uint64, ctypes.c_uint32, _F]
_SIGNATURES = {
    "fused_layer.cu": {
        "recblr_layer_fwd": [_P] * 5 + [_I] * 10 + _D1 + [_I, _P],
    },
    "fused_layer_last.cu": {
        "recblr_layer_last_fwd": [_P] * 7 + [_I] * 10 + _D1 + [_I, _P],
    },
    "fused_layer_bwd.cu": {
        "recblr_layer_bwd": [_P] * 5 + [_I] + [_P] * 4 + [_I] + [_P] * 2 + [_I] * 10 + _D1
        + [_I, _P],
    },
    "fused_layer_last_bwd.cu": {
        "recblr_layer_last_bwd": [_P] * 6 + [_I] + [_P] * 4 + [_I] + [_P] * 2 + [_I] * 9
        + _D1 + [_I, _P],
    },
    "ln_dropout.cu": {
        "recblr_ln_pos_fwd": [_P] * 5 + [_I] * 5 + _D1 + [_I, _P],
        "recblr_ln_pos_bwd": [_P] * 10 + [_I] * 6 + _D1 + [_I, _P],
        "recblr_dropout_ln_fwd": [_P] * 4 + [_I] * 4 + _D1 + [_I, _P],
        "recblr_dropout_ln_bwd": [_P] * 6 + [_I] * 5 + _D1 + [_I, _P],
    },
    "fused_block.cu": {
        "recblr_block_fwd": [_P] * 6 + [_I] * 7 + [_F, _I] + _D1 * 2 + [_I, _P],
    },
    "fused_block_last.cu": {
        "recblr_block_last_fwd": [_P] * 6 + [_I] * 6 + [_F, _I] + _D1 * 2 + [_I, _P],
    },
    "fused_block_bwd.cu": {
        "recblr_block_bwd": [_P] * 10 + [_I] + [_P] * 2 + [_I] * 7 + [_F, _I] + _D1 * 2
        + [_I, _P],
    },
    "fused_block_last_bwd.cu": {
        "recblr_block_last_bwd": [_P] * 10 + [_I] + [_P] * 2 + [_I] * 6 + [_F, _I]
        + _D1 * 2 + [_I, _P],
    },
    "fused_block_sel.cu": {
        "recblr_block_sel_fwd": [_P] * 8 + [_I] * 7 + [_F, _I] + _D1 * 2 + [_I, _P],
    },
    "fused_block_sel_bwd.cu": {
        "recblr_block_sel_bwd": [_P] * 13 + [_I] + [_P] * 2 + [_I] * 7 + [_F, _I] + _D1 * 2
        + [_I, _P],
    },
    "fused_ce.cu": {
        "recblr_ce_fwd": [_P] * 6 + [_I] * 6 + [_I, _P],
        "recblr_ce_bwd": [_P] * 7 + [_I] + [_P] * 2 + [_I] * 6 + [_I, _P],
        "recblr_ce_bwd_splits": [_I] * 5,
    },
    "fused_layer_chunked.cu": {
        "recblr_layer_chunked_fwd": [_P] * 8 + [_I] * 11 + _D1 + [_I, _P],
    },
    "fused_layer_chunked_bwd.cu": {
        "recblr_layer_chunked_bwd": [_P] * 12 + [_I] + [_P] * 2 + [_I] * 11 + _D1 + [_I, _P],
    },
    "fused_ce_chunked.cu": {
        "recblr_cce_fwd": [_P] * 5 + [_I] + [_P] * 2 + [_I] * 6 + [_I, _P],
        "recblr_cce_bwd": [_P] * 8 + [_I] + [_P] + [_I] * 6 + [_I, _P],
    },
    "emb_grad.cu": {
        "recblr_emb_grad": [_P, _I, _P, _I, _P, _P, ctypes.c_int64] + [_I] * 3 + [_I, _P],
    },
    "linear_scan.cu": {
        "recblr_linear_scan": [_P] * 3 + [_I] * 4 + [_I, _P],
    },
    "fused_bdlru.cu": {
        "recblr_bdlru_fwd": [_P] * 5 + [_I] * 6 + [_I, _P],
    },
    "fused_bdlru_bwd.cu": {
        "recblr_bdlru_bwd": [_P] * 7 + [_I] + [_P] * 2 + [_I] * 6 + [_I, _P],
    },
    "attention.cu": {
        "recblr_attn_fwd": [_P] * 7 + [_I] * 7 + [_F, _I] + _D1 + [_I, _P],
        "recblr_attn_fwd_blocks_per_sm": [_I] * 3,
    },
    "attention_bwd.cu": {
        "recblr_attn_bwd": [_P] * 11 + [_I] * 7 + [_F, _I] + _D1 + [_I, _P],
        "recblr_attn_bwd_blocks_per_sm": [_I] * 4,
    },
    "probe_unit_overlap.cu": {
        "recblr_probe_unit_overlap": [_P] * 6 + [_I] * 4 + [_I, _P],
    },
    "probe_vpu_ops.cu": {
        "recblr_probe_vpu_op": [_P] * 2 + [_I] * 3 + [_I, _P],
    },
    "probe_scan_chunked.cu": {
        "recblr_probe_scan": [_P] * 3 + [_I] * 4 + [_I, _P],
    },
    "probe_ce_mxu.cu": {
        "recblr_probe_ce_mm": [_P] * 3 + [_I] * 4 + [_I, _P],
    },
    "probe_emb_gather.cu": {
        "recblr_probe_emb_gather": [_P, _I, _P, _P, ctypes.c_int64] + [_I] * 3 + [_I, _P],
    },
    "probe_mask_replay_check.cu": {
        "recblr_probe_masks": [_I] + [_P] * 4 + [_I] * 6 + _D1[1:] + [_I, _P],
    },
}

_loaded: dict[str, ctypes.CDLL] = {}
BUILD_LOGS: dict[str, str] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(source: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (source, *HEADERS):
        h.update((SRC_DIR / name).read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(sources=SOURCES) -> dict[str, float]:
    """Compile every source whose library is missing, all at once.
    Returns the build seconds of each source built (0.0 if reused); the
    compiler's output is kept in ``BUILD_LOGS``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    seconds = {}
    t0 = time.perf_counter()
    for src in sources:
        out = _lib_path(src)
        if out.exists():
            seconds[src] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(SRC_DIR), "-o", str(tmp), str(SRC_DIR / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for src, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[src] = time.perf_counter() - t0
        BUILD_LOGS[src] = log
        if proc.returncode != 0:
            failed.append(f"{src}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return seconds


def library(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    lib = _loaded.get(source)
    if lib is not None:
        return lib
    path = _lib_path(source)
    if not path.exists():
        build((source,))
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _SIGNATURES[source].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.recblr_error_string.argtypes = [ctypes.c_int]
    lib.recblr_error_string.restype = ctypes.c_char_p
    _loaded[source] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.recblr_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def require_cuda(x) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}; use cpu or cuda")


def stream(x) -> int:
    """The handle of PyTorch's current stream on x's card, read without
    building a ``torch.cuda.Stream`` object (host time every launch pays)."""
    return torch._C._cuda_getCurrentRawStream(x.device.index)


def grad_blocks(device) -> int:
    """Rows of a backward's weight-grad partials: the blocks of its
    grid-stride phases, two per SM."""
    return 2 * torch.cuda.get_device_properties(device).multi_processor_count


def needs_grad(x, tensors) -> bool:
    """Whether autograd must see a call on x and ``tensors`` (None
    entries are skipped)."""
    return torch.is_grad_enabled() and (
        x.requires_grad or any(v is not None and v.requires_grad for v in tensors))


def pointer_array(tensors) -> ctypes.Array:
    """A C array of device pointers (null for None)."""
    return (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors]
    )
