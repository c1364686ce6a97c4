// Top RecurrentLayer forward for Hopper, output at each row's last
// valid position only ([B, D]), with in-kernel Philox dropout.
//
// Replaces the TPU kernel datamining_recblr_tpu/ops/fused_layer.py:
// _last_fwd_kernel (reached through _layer_last_fwd /
// fused_recurrent_layer_last).  Only the xb half of the in-projection,
// the conv, the gates and the scan run over the sequence (~82 kFLOP of
// products per position at the serving shape); z, the out-projection,
// LN1 and the FFN run once per row.  Like the full layer it is bound by
// operations, its products on the tensor cores as 3xTF32
// (layer_fwd.cuh).  What the design does about that: the per-position
// phase skips every time tile at or beyond the row's valid length, and
// the scan stops there, because the output reads the state at position
// len-1 alone; the per-row tail batches 128 rows a block so each weight
// chunk staged serves 128 rows.  A row whose length
// is 0 (or above T) selects nothing: x_last = 0 and h_last = 0, as the
// TPU kernel's one-hot `pos == lens-1` gives.  The dropout masks m1,
// m2, m3 are [B, 1, .] Philox draws (row b, position 0); a training
// forward keeps alpha and h (below each row's length) for the backward
// (fused_layer_last_bwd.cu).
//
// C interface (loaded with ctypes): returns a cudaError_t, 0 on success.
#include "layer_fwd.cuh"

using namespace recblr;

namespace {

template <typename Tin>
cudaError_t layer_last_fwd(const Tin* x, const int* lens, Tin* out, LayerParams p,
                           Dropout dr, float* alpha, float* bx, float* h_last, int B, int T,
                           int D, int C, int K, int F, int use_conv, int use_ffn, int stash,
                           cudaStream_t stream) {
  cudaError_t e = launch_phase_a(x, lens, p, dr, alpha, bx, B, T, D, C, K, use_conv, 0, stream);
  if (e != cudaSuccess) return e;

  scan_last_kernel<<<(B * C + SCAN_THREADS - 1) / SCAN_THREADS, SCAN_THREADS, 0, stream>>>(
      alpha, bx, lens, h_last, B, T, C, stash);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  return launch_tail<Tin, true>(x, lens, h_last, out, p, dr, B, T, D, C, F, use_ffn, 0, stream);
}

}  // namespace

extern "C" {

// x: [B, T, D] fp32 (bf16 == 0) or bf16; lens: [B] int32; out: [B, D]
// in x's type; params: N_PARAMS device pointers (LayerParams order, null
// where unused); alpha, bx: [B, T, C] fp32 scratch (with stash, alpha
// and h below each row's length on return); h_last: [B, C] fp32; drop,
// seed, thresh, scale: the dropout masks (common.cuh Dropout); device:
// the card that holds them.
int recblr_layer_last_fwd(const void* x, const void* lens, void* out,
                          const void* const* params, void* alpha, void* bx, void* h_last,
                          int B, int T, int D, int C, int K, int F, int use_conv,
                          int use_ffn, int bf16, int stash, int drop, unsigned long long seed,
                          unsigned thresh, float scale, int device, void* stream) {
  // this library has its own (static) CUDA runtime: select the tensors' card
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const LayerParams p = unpack_params(params);
  const Dropout dr = make_dropout(drop, seed, thresh, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* l = static_cast<const int*>(lens);
  float* a = static_cast<float*>(alpha);
  float* b = static_cast<float*>(bx);
  float* hl = static_cast<float*>(h_last);
  if (bf16)
    return layer_last_fwd(static_cast<const __nv_bfloat16*>(x), l,
                          static_cast<__nv_bfloat16*>(out), p, dr, a, b, hl, B, T, D, C, K,
                          F, use_conv, use_ffn, stash, s);
  return layer_last_fwd(static_cast<const float*>(x), l, static_cast<float*>(out), p, dr, a,
                        b, hl, B, T, D, C, K, F, use_conv, use_ffn, stash, s);
}

const char* recblr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
