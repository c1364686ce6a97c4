// Top RecurrentLayer forward for Hopper, output at each row's last
// valid position only ([B, D]), dropout 0.
//
// Replaces the TPU kernel datamining_recblr_tpu/ops/fused_layer.py:
// _last_fwd_kernel (reached through _layer_last_fwd /
// fused_recurrent_layer_last).  Only the xb half of the in-projection,
// the conv, the gates and the scan run over the sequence (~82 kFLOP of
// fp32 matmul per position at the serving shape); z, the
// out-projection, LN1 and the FFN run once per row.  Like the full
// layer it is bound by fp32 operations.  What the design does about
// that: the per-position phase skips every time tile at or beyond the
// row's valid length, and the scan stops there, because the output
// reads the state at position len-1 alone; the per-row tail batches 32
// rows a block so each weight load serves 32 rows.  A row whose length
// is 0 (or above T) selects nothing: x_last = 0 and h_last = 0, as the
// TPU kernel's one-hot `pos == lens-1` gives.
//
// C interface (loaded with ctypes): returns a cudaError_t, 0 on success.
#include "common.cuh"

using namespace recblr;

namespace {

__global__ void __launch_bounds__(SCAN_THREADS)
scan_last_kernel(const float* __restrict__ alpha, const float* __restrict__ bx,
                 const int* __restrict__ lens, float* __restrict__ h_last, int B, int T,
                 int C) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * C) return;
  const int b = i / C, c = i % C;
  const int n = valid_len(lens[b], T);
  size_t o = (size_t)b * T * C + c;
  float h = 0.f;
  for (int t = 0; t < n; ++t, o += C) h = alpha[o] * h + bx[o];
  h_last[i] = h;
}

template <typename Tin>
cudaError_t layer_last_fwd(const Tin* x, const int* lens, Tin* out, LayerParams p,
                           float* alpha, float* bx, float* h_last, int B, int T, int D,
                           int C, int K, int F, int use_conv, int use_ffn,
                           cudaStream_t stream) {
  const int tiles = (T + TT - 1) / TT;
  const size_t sa = phase_a_smem_bytes(D, C);
  cudaError_t e = cudaFuncSetAttribute(phase_a_kernel<Tin>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sa);
  if (e != cudaSuccess) return e;
  phase_a_kernel<Tin><<<dim3(B, tiles), THREADS, sa, stream>>>(
      x, lens, p, alpha, bx, T, D, C, K, use_conv, 0);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  scan_last_kernel<<<(B * C + SCAN_THREADS - 1) / SCAN_THREADS, SCAN_THREADS, 0, stream>>>(
      alpha, bx, lens, h_last, B, T, C);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const size_t sc = tail_smem_bytes(D, C, use_ffn ? F : 0);
  e = cudaFuncSetAttribute(tail_kernel<Tin, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sc);
  if (e != cudaSuccess) return e;
  tail_kernel<Tin, true><<<(B + TT - 1) / TT, THREADS, sc, stream>>>(
      x, lens, h_last, out, p, B, T, D, C, F, use_ffn, 0);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: [B, T, D] fp32 (bf16 == 0) or bf16; lens: [B] int32; out: [B, D]
// in x's type; params: N_PARAMS device pointers (LayerParams order, null
// where unused); alpha, bx: [B, T, C] fp32 scratch; h_last: [B, C] fp32; device: the card that holds them.
int recblr_layer_last_fwd(const void* x, const void* lens, void* out,
                          const void* const* params, void* alpha, void* bx, void* h_last,
                          int B, int T, int D, int C, int K, int F, int use_conv,
                          int use_ffn, int bf16, int device, void* stream) {
  // this library has its own (static) CUDA runtime: select the tensors' card
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const LayerParams p = unpack_params(params);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* l = static_cast<const int*>(lens);
  float* a = static_cast<float*>(alpha);
  float* b = static_cast<float*>(bx);
  float* hl = static_cast<float*>(h_last);
  if (bf16)
    return layer_last_fwd(static_cast<const __nv_bfloat16*>(x), l,
                          static_cast<__nv_bfloat16*>(out), p, a, b, hl, B, T, D, C, K, F,
                          use_conv, use_ffn, s);
  return layer_last_fwd(static_cast<const float*>(x), l, static_cast<float*>(out), p, a, b,
                        hl, B, T, D, C, K, F, use_conv, use_ffn, s);
}

const char* recblr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
