// Whole RecurrentLayer backward for Hopper: dx and every weight grad.
//
// Replaces the TPU kernels datamining_recblr_tpu/ops/fused_layer.py:
// _bwd_kernel and _bwd_kernel_multi (reached through _layer_bwd from the
// custom VJP of fused_recurrent_layer), with the math of _bwd_core.  It
// reads the alpha and h a training forward kept (fused_layer.cu), or
// recomputes them, replays the Philox dropout masks m0-m3, and runs the
// phases A', B', C1', C2' of common_bwd.cuh, then one reduction of the
// per-block weight-grad partials in a fixed order (no atomics).
//
// What bounds it: the forward tail is recomputed and every matmul of the
// layer has two gradient products, about 3x the forward's work (~544 kFLOP
// per position at D 64, C 128, FFN 256) against a few kB of [B, T, .]
// scratch traffic per position, so it is bound by operations.  Every
// product of A', C1' and C2' runs on the tensor cores as 3xTF32 (three
// TF32 products a product at 495 TFLOP/s, keeping fp32 accuracy), each
// item's activations in shared memory, the weights read from device
// memory through the read-only cache; only dh, dz, the dv1 residual and
// du go through device memory between phases.
//
// C interface (loaded with ctypes): returns a cudaError_t, 0 on success.
#include "common_bwd.cuh"
#include "layer_fwd.cuh"

using namespace recblr;

namespace {

template <typename Tin>
cudaError_t layer_bwd(const Tin* x, const Tin* dout, LayerParams p, LayerParamsT q,
                      Dropout dr, float* alpha, float* h, int recompute, float* ds,
                      float* dz, float* dxr, float* partial, int G, float* grads, Tin* dx,
                      int B, int T, int D, int C, int K, int F, int use_conv, int use_ffn,
                      int prologue, cudaStream_t stream) {
  cudaError_t e;
  const int tiles = (T + TT - 1) / TT;
  if (recompute) {
    e = launch_phase_a(x, nullptr, p, dr, alpha, h, B, T, D, C, K, use_conv, prologue, stream);
    if (e != cudaSuccess) return e;
    linear_scan_kernel<false, float, float>
        <<<(B * C + SCAN_THREADS - 1) / SCAN_THREADS, SCAN_THREADS, 0, stream>>>(alpha, h, h, B,
                                                                                T, C, 0);
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
  if ((e = set_smem(tail_bwd_mma_kernel<Tin, false>, s1)) != cudaSuccess) return e;
  const int items_a = B * ((T + rt - 1) / rt);
  tail_bwd_mma_kernel<Tin, false><<<min(G, items_a), BWD_THREADS, s1, stream>>>(
      x, nullptr, dout, h, p, q, dr, dxr, ds, dz, partial, gl, rt, B, T, D, C, Fu, use_ffn,
      prologue);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  linear_scan_kernel<true, float, float>
      <<<(B * C + SCAN_THREADS - 1) / SCAN_THREADS, SCAN_THREADS, 0, stream>>>(alpha, ds, ds, B,
                                                                              T, C, 1);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const int items_c = B * tiles;
  const size_t s2 = gate_bwd_smem_bytes(D, C, K);
  if ((e = set_smem(gate_bwd_mma_kernel<Tin>, s2)) != cudaSuccess) return e;
  gate_bwd_mma_kernel<Tin><<<min(G, items_c), BWD_THREADS, s2, stream>>>(
      x, nullptr, h, ds, p, q, dr, partial, gl, B, T, D, C, K, use_conv, prologue);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const size_t s3 = inproj_bwd_smem_bytes(D, C);
  if ((e = set_smem(inproj_bwd_mma_kernel<Tin>, s3)) != cudaSuccess) return e;
  inproj_bwd_mma_kernel<Tin><<<min(G, items_c), THREADS, s3, stream>>>(
      x, nullptr, ds, dz, dxr, dx, p, q, dr, partial, gl, B, T, D, C, K, use_conv, prologue);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  reduce_partials_kernel<<<(gl.total + 255) / 256, 256, 0, stream>>>(partial, G, gl.total,
                                                                      grads);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, dout, dx: [B, T, D] fp32 (bf16 == 0) or bf16; params: N_PARAMS
// device pointers (LayerParams order, null where unused) followed by
// the N_PARAMS_T transposed weights (LayerParamsT order); alpha, h:
// [B, T, C] fp32 kept by the forward, or scratch it fills when
// recompute != 0; ds, dz: [B, T, C] fp32 scratch; dxr: [B, T, D] fp32
// scratch; partial: [G, P] fp32 zeros (P floats of GradLayout); grads:
// [P] fp32 out, in LayerParams order; drop, seed, thresh, scale: the
// forward's dropout (common.cuh Dropout); device: the card.
int recblr_layer_bwd(const void* x, const void* dout, const void* const* params, void* alpha,
                     void* h, int recompute, void* ds, void* dz, void* dxr, void* partial,
                     int G, void* grads, void* dx, int B, int T, int D, int C, int K, int F,
                     int use_conv, int use_ffn, int prologue, int bf16, int drop,
                     unsigned long long seed, unsigned thresh, float scale, int device,
                     void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const LayerParams p = unpack_params(params);
  const LayerParamsT q = unpack_params_t(params);
  const Dropout dr = make_dropout(drop, seed, thresh, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* a = static_cast<float*>(alpha);
  float* hh = static_cast<float*>(h);
  float* d = static_cast<float*>(ds);
  float* z = static_cast<float*>(dz);
  float* r = static_cast<float*>(dxr);
  float* pt = static_cast<float*>(partial);
  float* gr = static_cast<float*>(grads);
  if (bf16)
    return layer_bwd(static_cast<const __nv_bfloat16*>(x),
                     static_cast<const __nv_bfloat16*>(dout), p, q, dr, a, hh, recompute, d,
                     z, r, pt, G, gr, static_cast<__nv_bfloat16*>(dx), B, T, D, C, K, F,
                     use_conv, use_ffn, prologue, s);
  return layer_bwd(static_cast<const float*>(x), static_cast<const float*>(dout), p, q, dr, a,
                   hh, recompute, d, z, r, pt, G, gr, static_cast<float*>(dx), B, T, D, C, K,
                   F, use_conv, use_ffn, prologue, s);
}

const char* recblr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
