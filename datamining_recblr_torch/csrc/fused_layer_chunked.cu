// Sequence-chunked RecurrentLayer forward for Hopper, with in-kernel
// Philox dropout: the long-context (T > 512) counterpart of
// fused_layer.cu.
//
// Replaces the TPU kernel datamining_recblr_tpu/ops/fused_layer_chunked.py:
// _fwd_kernel (reached through _chunked_fwd / fused_recurrent_layer_chunked),
// with the embedding LN prologue as a flag.  The function is K1's
// (fused_layer.cu); what the chunking adds is its residual contract: T is
// cut into nc = T / chunk chunks, and besides the output the forward writes
// a record per (row, chunk) of REC_ROWS x C fp32 (common.cuh): row 0 the
// scan state entering the chunk, rows 1 .. K-1 the previous chunk's last
// K-1 xb rows (pre-conv, after W_in), the JAX kernel's `carry` output.  The
// backward (fused_layer_chunked_bwd.cu) reads only x, dout and that record,
// so no [B, T, C] intermediate lives from the forward to the backward.  It
// reads row 0 alone and recomputes the conv halo from x: the tails (1.5 KiB
// per (row, chunk) at d_conv 4, C 128) are written only so that the record
// is the JAX carry, which the plain backward reads.
//
// What bounds it: as K1, fp32 operations (~180 kFLOP per position at D 64,
// C 128, FFN 256 against ~256 bytes of activations).  The TPU grid walks
// the chunks in order, carrying the state in scratch; a GPU grid runs in
// no order, so the design splits the recurrence instead of the grid:
//   A     phase A of common.cuh over (row, time tile) blocks, which also
//         writes the record's conv tails;
//   B1    chunk_state_kernel: every chunk's scan from a zero state at once,
//         one thread per (row, chunk, channel): its end state and the
//         product of its gates;
//   B2    chunk_scan_kernel: each chunk composes its entering state from
//         the earlier chunks' (end state, product), writes it to the
//         record, and scans the chunk from it (h over beta*xc in place);
//   C     the tail of common.cuh over (row, time tile) blocks.
// At B 512, T 1,024 the scan runs as 524,288 threads of 128 steps where
// K1's runs as 65,536 threads of 1,024.
//
// C interface (loaded with ctypes): returns a cudaError_t, 0 on success.
#include "common.cuh"

using namespace recblr;

namespace {

template <typename Tin>
cudaError_t layer_chunked_fwd(const Tin* x, Tin* out, LayerParams p, Dropout dr, float* alpha,
                              float* bxh, float* hend, float* pend, float* rec, int B, int T,
                              int D, int C, int K, int F, int chunk, int use_conv, int use_ffn,
                              int prologue, cudaStream_t stream) {
  const int tiles = (T + TT - 1) / TT;
  const size_t sa = phase_a_smem_bytes(D, C);
  cudaError_t e = cudaFuncSetAttribute(phase_a_kernel<Tin>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sa);
  if (e != cudaSuccess) return e;
  phase_a_kernel<Tin><<<dim3(B, tiles), THREADS, sa, stream>>>(
      x, nullptr, p, dr, alpha, bxh, T, D, C, K, use_conv, prologue, rec, chunk);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const int n = B * (T / chunk) * C;
  const int blocks = (n + SCAN_THREADS - 1) / SCAN_THREADS;
  chunk_state_kernel<<<blocks, SCAN_THREADS, 0, stream>>>(alpha, bxh, hend, pend, B, T, C, chunk);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  chunk_scan_kernel<<<blocks, SCAN_THREADS, 0, stream>>>(alpha, bxh, hend, pend, nullptr, rec, B,
                                                        T, C, chunk);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const size_t sc = tail_smem_bytes(D, C, use_ffn ? F : 0);
  e = cudaFuncSetAttribute(tail_kernel<Tin, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sc);
  if (e != cudaSuccess) return e;
  tail_kernel<Tin, false><<<dim3(B, tiles), THREADS, sc, stream>>>(
      x, nullptr, bxh, out, p, dr, B, T, D, C, F, use_ffn, prologue);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, out: [B, T, D] fp32 (bf16 == 0) or bf16; params: N_PARAMS device
// pointers (common.cuh LayerParams order, null where unused); alpha, bxh:
// [B, T, C] fp32 scratch; hend, pend: [B, T / chunk, C] fp32 scratch; rec:
// [B, T / chunk, REC_ROWS, C] fp32 zeros, the record on return; chunk
// divides T and K <= min(chunk, MAX_K); drop, seed, thresh, scale: the
// dropout masks (common.cuh Dropout); device: the card that holds them.
int recblr_layer_chunked_fwd(const void* x, void* out, const void* const* params, void* alpha,
                             void* bxh, void* hend, void* pend, void* rec, int B, int T, int D,
                             int C, int K, int F, int chunk, int use_conv, int use_ffn,
                             int prologue, int bf16, int drop, unsigned long long seed,
                             unsigned thresh, float scale, int device, void* stream) {
  // this library has its own (static) CUDA runtime: select the tensors' card
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const LayerParams p = unpack_params(params);
  const Dropout dr = make_dropout(drop, seed, thresh, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* a = static_cast<float*>(alpha);
  float* h = static_cast<float*>(bxh);
  float* he = static_cast<float*>(hend);
  float* pe = static_cast<float*>(pend);
  float* r = static_cast<float*>(rec);
  if (bf16)
    return layer_chunked_fwd(static_cast<const __nv_bfloat16*>(x),
                             static_cast<__nv_bfloat16*>(out), p, dr, a, h, he, pe, r, B, T, D,
                             C, K, F, chunk, use_conv, use_ffn, prologue, s);
  return layer_chunked_fwd(static_cast<const float*>(x), static_cast<float*>(out), p, dr, a, h,
                           he, pe, r, B, T, D, C, K, F, chunk, use_conv, use_ffn, prologue, s);
}

const char* recblr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
