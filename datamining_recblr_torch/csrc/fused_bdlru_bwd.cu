// Backward of the standalone BD-LRU (fused_bdlru.cu) for Hopper: dx and
// the five weight grads.
//
// Replaces the TPU kernel datamining_recblr_tpu/ops/fused_bdlru.py:
// _bwd_kernel (reached through _fused_bwd from the custom VJP of
// fused_bdlru).  It recomputes the forward from x, then runs the
// recurrent layer backward's middle (common_bwd.cuh) without the
// in-projection and the tail:
//   A   phase_a_mma_kernel<Tin, XB = true> (layer_fwd.cuh) and
//       linear_scan_kernel: alpha and h
//       [B, T, C] fp32, recomputed (nothing is kept by the forward)
//   B'  linear_scan_kernel in reverse on shift_left(alpha): d_states =
//       reverse_scan(shift_left(alpha), dh)
//   C1' gate_bwd_mma_kernel<Tin, XB = true>: the gates recomputed from xb,
//       then d_beta, d_alpha, d_r, d_i, the W_g, b_g and lambda grads, du
//       = (dg @ W_g^T + d_states * beta) * silu'(u), the conv grads;
//       du over d_states
//   dx  conv_t_kernel: the transposed conv of du (du itself without it),
//       in x's dtype
// Weight grads are summed without atomics, as the layer backward's: a
// fixed grid of blocks walks the (row, tile) items in a fixed order into
// its own fp32 slice of `partial`, and reduce_partials_kernel adds the
// slices in order, so two runs give the same bits.  Without the conv
// (use_conv = 0) dwc and dbc stay 0, as in the TPU kernel.
//
// What bounds it: the gate product recomputed and its two gradient
// products, 12 C^2 FLOP per position (~104 GFLOP at B 512, T 1,020,
// C 128), so operations, as the layer backward's gate phase, whose
// design it reuses: those products on the tensor cores as 3xTF32
// (common_bwd.cuh mm_tc, ~0.63 ms at 495 TFLOP/s).
//
// C interface (loaded with ctypes): returns a cudaError_t, 0 on success.
#include "common_bwd.cuh"
#include "layer_fwd.cuh"

using namespace recblr;

namespace {

// dx[t] = sum_j du[t + j] * wc[K-1-j] over t + j < T (the conv's
// transpose, in the order of the TPU kernel's shifted sums), or du.
template <typename Tout>
__global__ void __launch_bounds__(256)
conv_t_kernel(const float* __restrict__ du, const float* __restrict__ wc, Tout* __restrict__ dx,
              int T, int C, int K, int use_conv, size_t n) {
  const size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = du[i];
  if (use_conv) {
    const int c = (int)(i % C), t = (int)((i / C) % T);
    s *= wc[(K - 1) * C + c];
    for (int j = 1; j < K; ++j)
      if (t + j < T) s += du[i + (size_t)j * C] * wc[(K - 1 - j) * C + c];
  }
  store_act(dx, i, s);
}

template <typename Tin>
cudaError_t bdlru_bwd(const Tin* x, const Tin* dh, LayerParams p, LayerParamsT q, float* alpha,
                      float* h, float* ds, float* partial, int G, float* grads, Tin* dx, int B,
                      int T, int C, int K, int use_conv, cudaStream_t stream) {
  cudaError_t e;
  const Dropout off = make_dropout(0, 0, 0, 1.f);
  const int tiles = (T + TT - 1) / TT;
  e = launch_phase_a<Tin, true>(x, nullptr, p, off, alpha, h, B, T, 0, C, K, use_conv, 0,
                                stream);
  if (e != cudaSuccess) return e;
  const int sblocks = (B * C + SCAN_THREADS - 1) / SCAN_THREADS;
  linear_scan_kernel<false, float, float><<<sblocks, SCAN_THREADS, 0, stream>>>(alpha, h, h, B, T,
                                                                                C, 0);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  linear_scan_kernel<true, Tin, float><<<sblocks, SCAN_THREADS, 0, stream>>>(alpha, dh, ds, B, T,
                                                                             C, 1);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const GradLayout gl = grad_layout(0, C, K, 0);
  const size_t s2 = gate_bwd_smem_bytes(0, C, K);
  if ((e = set_smem(gate_bwd_mma_kernel<Tin, true>, s2)) != cudaSuccess) return e;
  gate_bwd_mma_kernel<Tin, true><<<min(G, B * tiles), BWD_THREADS, s2, stream>>>(
      x, nullptr, h, ds, p, q, off, partial, gl, B, T, 0, C, K, use_conv, 0);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const size_t n = (size_t)B * T * C;
  conv_t_kernel<Tin><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(ds, p.wc, dx, T, C, K,
                                                                      use_conv, n);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  reduce_partials_kernel<<<(gl.total + 255) / 256, 256, 0, stream>>>(partial, G, gl.total,
                                                                      grads);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, dh, dx: [B, T, C] fp32 (bf16 == 0) or bf16, C <= 128; params: wc,
// bc, wg, bg, lam (as recblr_bdlru_fwd) then wg^T [2C, C], fp32 device
// pointers; alpha, h, ds: [B, T, C] fp32 scratch; partial: [G, P] fp32
// zeros; grads: [P] fp32 out, P = K C + C + 2 C^2 + 2 C + C in that
// order (GradLayout with D = F = 0); device: the card.
int recblr_bdlru_bwd(const void* x, const void* dh, const void* const* params, void* alpha,
                     void* h, void* ds, void* partial, int G, void* grads, void* dx, int B,
                     int T, int C, int K, int use_conv, int bf16, int device, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const LayerParams p = unpack_bdlru_params(params);
  LayerParamsT q = {};
  q.wgT = static_cast<const float*>(params[5]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* a = static_cast<float*>(alpha);
  float* hh = static_cast<float*>(h);
  float* d = static_cast<float*>(ds);
  float* pt = static_cast<float*>(partial);
  float* gr = static_cast<float*>(grads);
  if (bf16)
    return bdlru_bwd(static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dh),
                     p, q, a, hh, d, pt, G, gr, static_cast<__nv_bfloat16*>(dx), B, T, C, K,
                     use_conv, s);
  return bdlru_bwd(static_cast<const float*>(x), static_cast<const float*>(dh), p, q, a, hh, d, pt,
                   G, gr, static_cast<float*>(dx), B, T, C, K, use_conv, s);
}

const char* recblr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
