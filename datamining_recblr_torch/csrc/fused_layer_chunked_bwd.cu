// Sequence-chunked RecurrentLayer backward for Hopper: dx and every weight
// grad from x, dout and the forward's record alone.
//
// Replaces the TPU kernel datamining_recblr_tpu/ops/fused_layer_chunked.py:
// _bwd_kernel (reached through _chunked_bwd from the custom VJP of
// fused_recurrent_layer_chunked).  The TPU kernel walks the chunks in
// reverse, recomputing each from its record and carrying the reverse-scan
// state and the conv cotangent head between them.  Here the recompute and
// the position-wise phases run over (row, time tile) blocks as K1's
// backward (fused_layer_bwd.cu, common_bwd.cuh), and only the two scans
// know the chunks:
//   A     phase A recomputes alpha and beta*xc from x (its conv halo from x
//         as well: the same arithmetic as the forward, so the same values
//         as the record's conv tails);
//   B     chunk_scan_kernel rebuilds h with every chunk scanned at once
//         from the state the record gives it (no pass over the chunks
//         before it: that is what the record is for);
//   A'    the tail backward down to dh and dz (common_bwd.cuh);
//   B'    rev_chunk_state_kernel and rev_chunk_scan_kernel: the reverse
//         scan with every chunk at once, the carries composed across the
//         chunks in between (d_states over dh in place);
//   C1'   gate, lambda and conv backward; C2' in-projection, prologue and
//         dx (common_bwd.cuh, the conv's right halo read across chunk
//         edges from du);
// then one reduction of the per-block weight-grad partials in a fixed
// order (no atomics).  What bounds it: as K1's backward, fp32 operations
// (~544 kFLOP per position at D 64, C 128, FFN 256).
//
// C interface (loaded with ctypes): returns a cudaError_t, 0 on success.
#include "common_bwd.cuh"

using namespace recblr;

namespace {

template <typename Tin>
cudaError_t layer_chunked_bwd(const Tin* x, const Tin* dout, LayerParams p, LayerParamsT q,
                              Dropout dr, const float* rec, float* alpha, float* h, float* ds,
                              float* dz, float* dxr, float* aend, float* mend, float* partial,
                              int G, float* grads, Tin* dx, int B, int T, int D, int C, int K,
                              int F, int chunk, int use_conv, int use_ffn, int prologue,
                              cudaStream_t stream) {
  cudaError_t e;
  const int tiles = (T + TT - 1) / TT;
  const size_t sa = phase_a_smem_bytes(D, C);
  if ((e = set_smem(phase_a_kernel<Tin>, sa)) != cudaSuccess) return e;
  phase_a_kernel<Tin><<<dim3(B, tiles), THREADS, sa, stream>>>(
      x, nullptr, p, dr, alpha, h, T, D, C, K, use_conv, prologue);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int n = B * (T / chunk) * C;
  const int sblocks = (n + SCAN_THREADS - 1) / SCAN_THREADS;
  chunk_scan_kernel<<<sblocks, SCAN_THREADS, 0, stream>>>(alpha, h, nullptr, nullptr, rec,
                                                         nullptr, B, T, C, chunk);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  int dev = 0, max_smem = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return e;
  const int Fu = use_ffn ? F : 0;
  const GradLayout gl = grad_layout(D, C, K, F);

  const int rt = tail_bwd_rows(D, C, Fu, max_smem);
  const size_t s1 = tail_bwd_smem_bytes(rt, D, C, Fu);
  if ((e = set_smem(tail_bwd_kernel<Tin, false>, s1)) != cudaSuccess) return e;
  const int items_a = B * ((T + rt - 1) / rt);
  tail_bwd_kernel<Tin, false><<<min(G, items_a), THREADS, s1, stream>>>(
      x, nullptr, dout, h, p, q, dr, dxr, ds, dz, partial, gl, rt, B, T, D, C, Fu, use_ffn,
      prologue);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  rev_chunk_state_kernel<<<sblocks, SCAN_THREADS, 0, stream>>>(alpha, ds, aend, mend, B, T, C,
                                                              chunk);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  rev_chunk_scan_kernel<<<sblocks, SCAN_THREADS, 0, stream>>>(alpha, ds, aend, mend, B, T, C,
                                                             chunk);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const int items_c = B * tiles;
  const size_t s2 = gate_bwd_smem_bytes(D, C);
  if ((e = set_smem(gate_bwd_kernel<Tin>, s2)) != cudaSuccess) return e;
  gate_bwd_kernel<Tin><<<min(G, items_c), THREADS, s2, stream>>>(
      x, nullptr, h, ds, p, q, dr, partial, gl, B, T, D, C, K, use_conv, prologue);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const size_t s3 = inproj_bwd_smem_bytes(D, C);
  if ((e = set_smem(inproj_bwd_kernel<Tin>, s3)) != cudaSuccess) return e;
  inproj_bwd_kernel<Tin><<<min(G, items_c), THREADS, s3, stream>>>(
      x, nullptr, ds, dz, dxr, dx, p, q, dr, partial, gl, B, T, D, C, K, use_conv, prologue);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  reduce_partials_kernel<<<(gl.total + 255) / 256, 256, 0, stream>>>(partial, G, gl.total,
                                                                      grads);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, dout, dx: [B, T, D] fp32 (bf16 == 0) or bf16; params: N_PARAMS
// device pointers (LayerParams order, null where unused) followed by the
// N_PARAMS_T transposed weights (LayerParamsT order); rec: [B, T / chunk,
// REC_ROWS, C] fp32, the forward's record; alpha, h, ds, dz: [B, T, C]
// fp32 scratch; dxr: [B, T, D] fp32 scratch; aend, mend: [B, T / chunk, C]
// fp32 scratch; partial: [G, P] fp32 zeros (P floats of GradLayout);
// grads: [P] fp32 out, in LayerParams order; drop, seed, thresh, scale:
// the forward's dropout (common.cuh Dropout); device: the card.
int recblr_layer_chunked_bwd(const void* x, const void* dout, const void* const* params,
                             const void* rec, void* alpha, void* h, void* ds, void* dz, void* dxr,
                             void* aend, void* mend, void* partial, int G, void* grads, void* dx,
                             int B, int T, int D, int C, int K, int F, int chunk, int use_conv,
                             int use_ffn, int prologue, int bf16, int drop,
                             unsigned long long seed, unsigned thresh, float scale, int device,
                             void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const LayerParams p = unpack_params(params);
  const LayerParamsT q = unpack_params_t(params);
  const Dropout dr = make_dropout(drop, seed, thresh, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* rc = static_cast<const float*>(rec);
  float* a = static_cast<float*>(alpha);
  float* hh = static_cast<float*>(h);
  float* d = static_cast<float*>(ds);
  float* z = static_cast<float*>(dz);
  float* r = static_cast<float*>(dxr);
  float* ae = static_cast<float*>(aend);
  float* me = static_cast<float*>(mend);
  float* pt = static_cast<float*>(partial);
  float* gr = static_cast<float*>(grads);
  if (bf16)
    return layer_chunked_bwd(static_cast<const __nv_bfloat16*>(x),
                             static_cast<const __nv_bfloat16*>(dout), p, q, dr, rc, a, hh, d, z,
                             r, ae, me, pt, G, gr, static_cast<__nv_bfloat16*>(dx), B, T, D, C, K,
                             F, chunk, use_conv, use_ffn, prologue, s);
  return layer_chunked_bwd(static_cast<const float*>(x), static_cast<const float*>(dout), p, q,
                           dr, rc, a, hh, d, z, r, ae, me, pt, G, gr, static_cast<float*>(dx), B,
                           T, D, C, K, F, chunk, use_conv, use_ffn, prologue, s);
}

const char* recblr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
