// The BD-LRU of RecBLR's unfused composition in one call for Hopper:
// causal conv + SiLU + gate matmul + decay + scan, forward.
//
// Replaces the TPU kernel datamining_recblr_tpu/ops/fused_bdlru.py:
// _fwd_kernel (reached through _fused_fwd / fused_bdlru), which the JAX
// model runs in every layer where C <= 128 and the whole-layer kernels
// do not (T beyond 512 with no chunk, or with d_conv beyond 8 there).  It is the
// recurrent layer kernel's (fused_layer.cu) phases A and B without the
// in-projection and the tail:
//   A  phase_a_mma_kernel<Tin, XB = true> (layer_fwd.cuh), per (row, tile of 32
//      positions): xb rows with the conv's K-1 halo (sized to K at run
//      time, as in the layer kernels) -> conv + SiLU -> xc @ W_g + b_g ->
//      alpha, beta*xc [B, T, C] fp32 to scratch
//   B  linear_scan_kernel: one thread per (row, channel), serial over T,
//      writing h in x's dtype
// fp32 inside; x (xb, after W_in) and h in the compute dtype, the
// parameters fp32, as the TPU kernel.
//
// What bounds it: the gate product, 4 C^2 FLOP per position (34.2 GFLOP
// at B 512, T 1,020, C 128: 0.21 ms as 3xTF32 at 495 TFLOP/s) against
// 2 C activations per position of traffic, so operations.  The product
// runs on the tensor cores as 3xTF32, xc split once into shared memory,
// W_g read from L1/L2 (layer_fwd.cuh mm_planes); only alpha and beta*xc
// (8 C bytes a position) go through device memory between the two
// phases.
//
// C interface (loaded with ctypes): returns a cudaError_t, 0 on success.
#include "layer_fwd.cuh"

using namespace recblr;

namespace {

template <typename Tin>
cudaError_t bdlru_fwd(const Tin* x, LayerParams p, float* alpha, float* bx, Tin* h, int B, int T,
                      int C, int K, int use_conv, cudaStream_t stream) {
  cudaError_t e = launch_phase_a<Tin, true>(x, nullptr, p, make_dropout(0, 0, 0, 1.f), alpha,
                                            bx, B, T, 0, C, K, use_conv, 0, stream);
  if (e != cudaSuccess) return e;
  linear_scan_kernel<false, float, Tin>
      <<<(B * C + SCAN_THREADS - 1) / SCAN_THREADS, SCAN_THREADS, 0, stream>>>(alpha, bx, h, B,
                                                                                T, C, 0);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, h: [B, T, C] fp32 (bf16 == 0) or bf16, C <= 128; params: wc [K, C]
// (K <= 64, common.cuh xs_rows), bc [C], wg [C, 2C], bg [2C], lam [C] fp32 device pointers; alpha, bx:
// [B, T, C] fp32 scratch; device: the card that holds them.
int recblr_bdlru_fwd(const void* x, const void* const* params, void* alpha, void* bx, void* h,
                     int B, int T, int C, int K, int use_conv, int bf16, int device,
                     void* stream) {
  // this library has its own (static) CUDA runtime: select the tensors' card
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const LayerParams p = unpack_bdlru_params(params);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* a = static_cast<float*>(alpha);
  float* b = static_cast<float*>(bx);
  if (bf16)
    return bdlru_fwd(static_cast<const __nv_bfloat16*>(x), p, a, b,
                     static_cast<__nv_bfloat16*>(h), B, T, C, K, use_conv, s);
  return bdlru_fwd(static_cast<const float*>(x), p, a, b, static_cast<float*>(h), B, T, C, K,
                   use_conv, s);
}

const char* recblr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
