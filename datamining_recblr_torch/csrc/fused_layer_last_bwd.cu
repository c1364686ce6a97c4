// Top RecurrentLayer backward for Hopper: the layer whose output is
// taken at each row's last valid position only.
//
// Replaces the TPU kernel datamining_recblr_tpu/ops/fused_layer.py:
// _last_bwd_kernel (reached through _layer_last_bwd from the custom VJP
// of fused_recurrent_layer_last).  The tail backward (LN2, FFN, LN1,
// W_out) runs once per row at its last position; the z half of W_in is
// contracted there too.  The single cotangent dh is spread back over
// the positions below the row's length by the reverse scan, and the
// gate, lambda, conv and W_in[:, :C] grads and dx follow per tile as in
// the full layer (common_bwd.cuh).  Positions at or beyond a row's
// length carry no cotangent: their tiles are skipped and dx there is 0.
// A length of 0 (or above T) selects nothing: the row's dx is 0, while
// the LN and FFN grads still take its tail on zeros, as the TPU kernel's
// one-hot does.
//
// What bounds it: operations below each row's length (~250 kFLOP per
// position: the gates and the xb half of the in-projection recomputed,
// their two gradient products each, the conv); the per-row tail is small.
// The products run on the tensor cores as 3xTF32 (common_bwd.cuh mm_tc).
// Weight grads are per-block partials reduced in a fixed order.
//
// C interface (loaded with ctypes): returns a cudaError_t, 0 on success.
#include "common_bwd.cuh"
#include "layer_fwd.cuh"

using namespace recblr;

namespace {

template <typename Tin>
cudaError_t layer_last_bwd(const Tin* x, const int* lens, const Tin* dout, LayerParams p,
                           LayerParamsT q, Dropout dr, float* alpha, float* h, int recompute,
                           float* ds, float* dhl, float* dxr, float* partial, int G,
                           float* grads, Tin* dx, int B, int T, int D, int C, int K, int F,
                           int use_conv, int use_ffn, cudaStream_t stream) {
  cudaError_t e;
  const int tiles = (T + TT - 1) / TT;
  if (recompute) {
    e = launch_phase_a(x, lens, p, dr, alpha, h, B, T, D, C, K, use_conv, 0, stream);
    if (e != cudaSuccess) return e;
    // h_last goes to dhl, which phase A' overwrites
    scan_last_kernel<<<(B * C + SCAN_THREADS - 1) / SCAN_THREADS, SCAN_THREADS, 0, stream>>>(
        alpha, h, lens, dhl, B, T, C, 1);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  int dev = 0, max_smem = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return e;
  const int Fu = use_ffn ? F : 0;
  const GradLayout gl = grad_layout(D, C, K, F);

  const int rt = tail_bwd_rows(D, C, Fu, max_smem);
  const size_t s1 = tail_bwd_smem_bytes(rt, D, C, Fu);
  if ((e = set_smem(tail_bwd_mma_kernel<Tin, true>, s1)) != cudaSuccess) return e;
  const int items_a = (B + rt - 1) / rt;
  tail_bwd_mma_kernel<Tin, true><<<min(G, items_a), BWD_THREADS, s1, stream>>>(
      x, lens, dout, h, p, q, dr, dxr, dhl, nullptr, partial, gl, rt, B, T, D, C, Fu, use_ffn,
      0);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  rev_scan_last_kernel<<<(B * C + SCAN_THREADS - 1) / SCAN_THREADS, SCAN_THREADS, 0, stream>>>(
      alpha, ds, lens, dhl, B, T, C);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const int items_c = B * tiles;
  const size_t s2 = gate_bwd_smem_bytes(D, C, K);
  if ((e = set_smem(gate_bwd_mma_kernel<Tin>, s2)) != cudaSuccess) return e;
  gate_bwd_mma_kernel<Tin><<<min(G, items_c), BWD_THREADS, s2, stream>>>(
      x, lens, h, ds, p, q, dr, partial, gl, B, T, D, C, K, use_conv, 0);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const size_t s3 = inproj_bwd_smem_bytes(D, C);
  if ((e = set_smem(inproj_bwd_mma_kernel<Tin>, s3)) != cudaSuccess) return e;
  inproj_bwd_mma_kernel<Tin><<<min(G, items_c), THREADS, s3, stream>>>(
      x, lens, ds, nullptr, dxr, dx, p, q, dr, partial, gl, B, T, D, C, K, use_conv, 0);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  reduce_partials_kernel<<<(gl.total + 255) / 256, 256, 0, stream>>>(partial, G, gl.total,
                                                                      grads);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, dx: [B, T, D] fp32 (bf16 == 0) or bf16; lens: [B] int32; dout: [B,
// D] in x's type; params: N_PARAMS device pointers (null where unused)
// then the N_PARAMS_T transposed weights; alpha, h: [B, T, C] fp32 kept
// by the forward (valid below each row's length), or scratch it fills
// when recompute != 0; ds: [B, T, C] fp32 scratch; dhl: [B, C] and dxr:
// [B, D] fp32 scratch; partial: [G, P] fp32 zeros; grads: [P] fp32 out;
// drop, seed, thresh, scale: the forward's dropout; device: the card.
int recblr_layer_last_bwd(const void* x, const void* lens, const void* dout,
                          const void* const* params, void* alpha, void* h, int recompute,
                          void* ds, void* dhl, void* dxr, void* partial, int G, void* grads,
                          void* dx, int B, int T, int D, int C, int K, int F, int use_conv,
                          int use_ffn, int bf16, int drop, unsigned long long seed,
                          unsigned thresh, float scale, int device, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const LayerParams p = unpack_params(params);
  const LayerParamsT q = unpack_params_t(params);
  const Dropout dr = make_dropout(drop, seed, thresh, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* l = static_cast<const int*>(lens);
  float* a = static_cast<float*>(alpha);
  float* hh = static_cast<float*>(h);
  float* d = static_cast<float*>(ds);
  float* hl = static_cast<float*>(dhl);
  float* r = static_cast<float*>(dxr);
  float* pt = static_cast<float*>(partial);
  float* gr = static_cast<float*>(grads);
  if (bf16)
    return layer_last_bwd(static_cast<const __nv_bfloat16*>(x), l,
                          static_cast<const __nv_bfloat16*>(dout), p, q, dr, a, hh, recompute,
                          d, hl, r, pt, G, gr, static_cast<__nv_bfloat16*>(dx), B, T, D, C, K,
                          F, use_conv, use_ffn, s);
  return layer_last_bwd(static_cast<const float*>(x), l, static_cast<const float*>(dout), p, q,
                        dr, a, hh, recompute, d, hl, r, pt, G, gr, static_cast<float*>(dx), B,
                        T, D, C, K, F, use_conv, use_ffn, s);
}

const char* recblr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
