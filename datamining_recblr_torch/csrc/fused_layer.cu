// Whole RecurrentLayer forward for Hopper, with in-kernel Philox dropout.
//
// Replaces the TPU kernel datamining_recblr_tpu/ops/fused_layer.py:
// _fwd_kernel (reached through _layer_fwd / fused_recurrent_layer), with
// the embedding LN prologue as a flag.  At the serving shape (D 64,
// C 128, FFN 256) one position costs ~180 kFLOP of fp32 matmul against
// ~256 bytes of activation traffic, so the layer is bound by fp32
// operations, not bytes.  The design keeps every matmul operand in
// shared memory and the weights in L1/L2, and spreads the per-position
// phases over (row, time tile) blocks so that a batch of rows fills the
// SMs; only the scan, which is serial in T, runs one thread per
// (row, channel).  Phase A/B scratch (alpha, beta*xc, then h in place)
// goes through device memory, allocated by the caller; a training
// forward keeps alpha and h there for the backward (fused_layer_bwd.cu).
// With dropout the masks m0 (prologue), m1, m2, m3 are Philox draws
// (common.cuh); at p = 0 no mask is drawn.
//
// C interface (loaded with ctypes): returns a cudaError_t, 0 on success.
#include "common.cuh"

using namespace recblr;

namespace {

template <typename Tin>
cudaError_t layer_fwd(const Tin* x, Tin* out, LayerParams p, Dropout dr, float* alpha,
                      float* bxh, int B, int T, int D, int C, int K, int F, int use_conv,
                      int use_ffn, int prologue, cudaStream_t stream) {
  const int tiles = (T + TT - 1) / TT;
  const size_t sa = phase_a_smem_bytes(D, C, K);
  cudaError_t e = cudaFuncSetAttribute(phase_a_kernel<Tin>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sa);
  if (e != cudaSuccess) return e;
  phase_a_kernel<Tin><<<dim3(B, tiles), THREADS, sa, stream>>>(
      x, nullptr, p, dr, alpha, bxh, T, D, C, K, use_conv, prologue);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  linear_scan_kernel<false, float, float>
      <<<(B * C + SCAN_THREADS - 1) / SCAN_THREADS, SCAN_THREADS, 0, stream>>>(alpha, bxh, bxh, B,
                                                                              T, C, 0);
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
// pointers (common.cuh LayerParams order, null where unused); alpha,
// bxh: [B, T, C] fp32 scratch, which hold alpha and h on return; drop,
// seed, thresh, scale: the dropout masks (common.cuh Dropout); device:
// the card that holds them.
int recblr_layer_fwd(const void* x, void* out, const void* const* params, void* alpha,
                     void* bxh, int B, int T, int D, int C, int K, int F, int use_conv,
                     int use_ffn, int prologue, int bf16, int drop, unsigned long long seed,
                     unsigned thresh, float scale, int device, void* stream) {
  // this library has its own (static) CUDA runtime: select the tensors' card
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const LayerParams p = unpack_params(params);
  const Dropout dr = make_dropout(drop, seed, thresh, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* a = static_cast<float*>(alpha);
  float* h = static_cast<float*>(bxh);
  if (bf16)
    return layer_fwd(static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
                     p, dr, a, h, B, T, D, C, K, F, use_conv, use_ffn, prologue, s);
  return layer_fwd(static_cast<const float*>(x), static_cast<float*>(out), p, dr, a, h, B, T,
                   D, C, K, F, use_conv, use_ffn, prologue, s);
}

const char* recblr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
