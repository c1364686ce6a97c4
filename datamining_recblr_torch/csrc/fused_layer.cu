// Whole RecurrentLayer forward for Hopper, with in-kernel Philox dropout.
//
// Replaces the TPU kernel datamining_recblr_tpu/ops/fused_layer.py:
// _fwd_kernel (reached through _layer_fwd / fused_recurrent_layer), with
// the embedding LN prologue as a flag.  At the serving shape (D 64,
// C 128, FFN 256) one position costs ~180 kFLOP of products against
// ~1 KB of activation and scratch traffic, so the layer is bound by
// operations, not bytes.  Every product runs on the tensor cores as
// 3xTF32 (layer_fwd.cuh): phase A over (row, time tile) blocks with its
// activations split once into shared memory, the tail over 128 positions
// a block with each warp's rows in registers; only the scan, which is
// serial in T, runs one thread per (row, channel).  Phase A/B scratch (alpha, beta*xc, then h in place)
// goes through device memory, allocated by the caller; a training
// forward keeps alpha and h there for the backward (fused_layer_bwd.cu).
// With dropout the masks m0 (prologue), m1, m2, m3 are Philox draws
// (common.cuh); at p = 0 no mask is drawn.
//
// C interface (loaded with ctypes): returns a cudaError_t, 0 on success.
#include "layer_fwd.cuh"

using namespace recblr;

namespace {

template <typename Tin>
cudaError_t layer_fwd(const Tin* x, Tin* out, LayerParams p, Dropout dr, float* alpha,
                      float* bxh, int B, int T, int D, int C, int K, int F, int use_conv,
                      int use_ffn, int prologue, cudaStream_t stream) {
  cudaError_t e = launch_phase_a(x, nullptr, p, dr, alpha, bxh, B, T, D, C, K, use_conv,
                                 prologue, stream);
  if (e != cudaSuccess) return e;

  linear_scan_kernel<false, float, float>
      <<<(B * C + SCAN_THREADS - 1) / SCAN_THREADS, SCAN_THREADS, 0, stream>>>(alpha, bxh, bxh, B,
                                                                              T, C, 0);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  return launch_tail<Tin, false>(x, nullptr, bxh, out, p, dr, B, T, D, C, F, use_ffn, prologue,
                                 stream);
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
