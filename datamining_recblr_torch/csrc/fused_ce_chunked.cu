// Vocab-chunked softmax cross-entropy for Hopper, forward and backward, for
// tables beyond the whole-table kernel (fused_ce.cu): the logits live in
// registers only, at any catalog size.
//
// Replaces the TPU kernels datamining_recblr_tpu/ops/fused_ce.py:
// _cce_fwd_kernel (reached through _cce_fwd) and _cce_bwd1_kernel,
// _cce_dx_kernel and _cce_dtab_kernel (through _cce_bwd), the vocab-chunked
// path of fused_softmax_ce, with its own rounding points: the logits
// l = x table^T + bias (x and the table rounded to bf16 with mm_bf16, fp32
// sums), columns >= valid_v at -1e30; the target logit x . table[t] +
// bias[t] with x unrounded (the table row rounded with mm_bf16); the
// backward g = exp(l - lse) dnll, dx = g table - dnll table[t] (with
// mm_bf16 g and the table rounded, the one-hot term unrounded), dtable =
// g^T x - dnll x at each target and dbias = sum g - dnll at each target
// (g and x unrounded).
//
// What bounds it: at the XLong shape (N = 512 rows, V = 329,728, D = 64)
// the logits are 2NVD = 21.6 GFLOP of fp32 FMA per pass against 84 MB of
// table: bound by fp32 operations.  N = 512 rows make only 8 row blocks of
// 64, so a row-parallel grid would fill 8 of the 132 SMs; the grid splits
// the vocab instead:
//   fwd     block (row block, vocab split) keeps an online logsumexp per
//           row over its split's table tiles and writes (max, sum);
//           cce_lse_kernel merges the splits in a fixed order, adds the
//           target logit and writes nll and lse.
//   dx      the same grid: g of its tiles and dx += g table in registers,
//           written to the split's own [N, D] slice; cce_dx_reduce_kernel
//           sums the slices in order and subtracts dnll table[t].
//   dtable  one block per 64-column vocab tile over all rows
//           (ce_common.cuh ce_dtab_kernel with one row split): the only
//           writer of its columns, so dtable and dbias need no atomics.
// Every sum runs in a fixed order: the same bits from run to run.  Left for
// later PRs: tensor cores (wgmma) and one table pass for dx and dtable.
//
// C interface (loaded with ctypes): returns a cudaError_t, 0 on success.
#include "ce_common.cuh"

using namespace recblr;

namespace {

// Forward partials.  Block (row block rb, vocab split sp): rows n0 .. n0 +
// BM - 1 over the table tiles sp * tps .. (sp + 1) * tps - 1; writes the
// rows' (max, sum of exp) to part_m, part_s [S, N].
template <typename Tin, bool RB, int RT>
__global__ void __launch_bounds__(CE_THREADS)
cce_fwd_kernel(const Tin* __restrict__ x, const float* __restrict__ tab,
               const float* __restrict__ bias, float* __restrict__ part_m,
               float* __restrict__ part_s, int N, int V, int D, int valid_v, int tps) {
  extern __shared__ __align__(16) float smem[];
  constexpr int BM = 16 * RT, BV = 16 * RT;
  const int D4 = ce_stride(D), Dk = (D + 3) / 4 * 4;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n0 = blockIdx.x * BM, sp = blockIdx.y;
  const int ntiles = (V + BV - 1) / BV;
  const int vt_end = min(ntiles, (sp + 1) * tps);
  float* xs = smem;          // [BM, D4] x rows (rounded when RB)
  float* ts = xs + BM * D4;  // [BV, D4] table tile (rounded when RB)
  load_rows<RB>(x, n0, min(BM, N - n0), D, D4, BM, xs);
  float m[RT], s[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m[i] = -INFINITY;
    s[i] = 0.f;
  }
  for (int vt = sp * tps; vt < vt_end; ++vt) {
    __syncthreads();  // the previous tile is consumed (and xs written)
    load_table_tile<RB>(tab, vt * BV, V, D, D4, BV, ts);
    __syncthreads();
    float acc[RT][RT];
    tile_logits<RT, false>(xs, ts, D4, Dk, tx, ty, acc);
    lse_update<RT>(acc, bias, vt * BV, V, valid_v, tx, m, s);
  }
  // the 16 lanes of a row (one half of a warp) combine their states
#pragma unroll
  for (int i = 0; i < RT; ++i) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, m[i], o);
      const float os = __shfl_xor_sync(0xffffffffu, s[i], o);
      lse_merge(m[i], s[i], om, os);
    }
    const int row = n0 + ty + 16 * i;
    if (tx == 0 && row < N) {
      part_m[(size_t)sp * N + row] = m[i];
      part_s[(size_t)sp * N + row] = s[i];
    }
  }
}

// lse and nll.  One warp per row: lane l merges the splits l, l + 32, ...
// in order, then the lanes in a fixed butterfly; the target logit is
// x . table[t] (the table row rounded when RB) + bias[t].
template <typename Tin, bool RB>
__global__ void cce_lse_kernel(const Tin* __restrict__ x, const float* __restrict__ tab,
                               const float* __restrict__ bias, const int* __restrict__ tgt,
                               const float* __restrict__ part_m, const float* __restrict__ part_s,
                               int S, float* __restrict__ nll, float* __restrict__ lse_out, int N,
                               int D) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= N) return;
  float m = -INFINITY, s = 0.f;
  for (int k = lane; k < S; k += 32)
    lse_merge(m, s, part_m[(size_t)k * N + row], part_s[(size_t)k * N + row]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, m, o);
    const float os = __shfl_xor_sync(0xffffffffu, s, o);
    lse_merge(m, s, om, os);
  }
  const int t = tgt[row];
  float tl = 0.f;
  for (int d = lane; d < D; d += 32)
    tl = fmaf(load_act(x, (size_t)row * D + d), mm_op<RB>(__ldg(tab + (size_t)t * D + d)), tl);
  tl = warp_sum(tl);
  if (lane == 0) {
    const float L = m + logf(s);
    nll[row] = L - (tl + __ldg(bias + t));
    if (lse_out != nullptr) lse_out[row] = L;
  }
}

// dx partials.  Block (row block rb, vocab split sp): g = exp(l - lse)
// dnll of its tiles (no one-hot term: cce_dx_reduce_kernel adds it
// unrounded) and dx += g table, written to dxp[sp] ([S, N, D] fp32).
template <typename Tin, bool RB, int RT>
__global__ void __launch_bounds__(CE_THREADS)
cce_dx_kernel(const Tin* __restrict__ x, const float* __restrict__ tab,
              const float* __restrict__ bias, const int* __restrict__ tgt,
              const float* __restrict__ dnll, const float* __restrict__ lse,
              float* __restrict__ dxp, int N, int V, int D, int valid_v, int tps) {
  extern __shared__ __align__(16) float smem[];
  constexpr int BM = 16 * RT, BV = 16 * RT, GS = BV + 4, MAXJ = 32 / RT;
  const int D4 = ce_stride(D), Dk = (D + 3) / 4 * 4, NJ = (D + 15) / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n0 = blockIdx.x * BM, sp = blockIdx.y;
  const int ntiles = (V + BV - 1) / BV;
  const int vt_end = min(ntiles, (sp + 1) * tps);
  float* xs = smem;          // [BM, D4] x rows (rounded when RB)
  float* ts = xs + BM * D4;  // [BV, D4] table tile (rounded when RB)
  float* gs = ts + BV * D4;  // [BM, GS] g of the tile (rounded when RB)
  load_rows<RB>(x, n0, min(BM, N - n0), D, D4, BM, xs);
  int tg[RT];
  float ls[RT], dn[RT];
  ce_row_inputs<RT>(tgt, lse, dnll, n0, N, ty, tg, ls, dn);
#pragma unroll
  for (int i = 0; i < RT; ++i) tg[i] = -1;  // g without the one-hot term
  float dacc[RT][MAXJ];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int jj = 0; jj < MAXJ; ++jj) dacc[i][jj] = 0.f;
  for (int vt = sp * tps; vt < vt_end; ++vt) {
    __syncthreads();  // the previous tile and its g are consumed
    load_table_tile<RB>(tab, vt * BV, V, D, D4, BV, ts);
    __syncthreads();
    float acc[RT][RT], g[RT][RT];
    tile_logits<RT, false>(xs, ts, D4, Dk, tx, ty, acc);
    ce_grad<RT>(acc, bias, vt * BV, V, valid_v, tx, tg, ls, dn, g);
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < RT; ++j) gs[(ty + 16 * i) * GS + tx + 16 * j] = mm_op<RB>(g[i][j]);
    __syncthreads();
    tile_g_table<RT, MAXJ>(gs, GS, ts, D4, BV, D, NJ, tx, ty, dacc);
  }
  float* out = dxp + (size_t)sp * N * D;
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = n0 + ty + 16 * i;
    if (row >= N) continue;
#pragma unroll
    for (int jj = 0; jj < MAXJ; ++jj) {
      const int d = tx + 16 * jj;
      if (jj < NJ && d < D) out[(size_t)row * D + d] = dacc[i][jj];
    }
  }
}

// dx[n, d] = sum over splits, in order, of dxp[., n, d] - dnll[n]
// table[t_n, d] (the table row rounded when RB), in x's type.
template <typename Tin, bool RB>
__global__ void cce_dx_reduce_kernel(const float* __restrict__ dxp, int S,
                                     const float* __restrict__ tab, const int* __restrict__ tgt,
                                     const float* __restrict__ dnll, Tin* __restrict__ dx, int N,
                                     int D) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t P = (size_t)N * D;
  if (i >= P) return;
  const int row = (int)(i / D), d = (int)(i % D);
  float s = 0.f;
  for (int k = 0; k < S; ++k) s += dxp[(size_t)k * P + i];
  s -= dnll[row] * mm_op<RB>(__ldg(tab + (size_t)tgt[row] * D + d));
  store_act(dx, i, s);
}

template <typename Tin, bool RB, int RT>
cudaError_t cce_fwd(const Tin* x, const float* tab, const float* bias, const int* tgt,
                    float* part, int S, float* nll, float* lse, int N, int V, int D, int valid_v,
                    cudaStream_t stream) {
  constexpr int BM = 16 * RT, BV = 16 * RT;
  const int tps = ((V + BV - 1) / BV + S - 1) / S;
  const size_t sm = sizeof(float) * 2 * (size_t)BM * ce_stride(D);
  cudaError_t e = ce_set_smem(cce_fwd_kernel<Tin, RB, RT>, sm);
  if (e != cudaSuccess) return e;
  float* part_m = part;
  float* part_s = part + (size_t)S * N;
  cce_fwd_kernel<Tin, RB, RT><<<dim3((N + BM - 1) / BM, S), CE_THREADS, sm, stream>>>(
      x, tab, bias, part_m, part_s, N, V, D, valid_v, tps);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  cce_lse_kernel<Tin, RB><<<(N + 7) / 8, 256, 0, stream>>>(x, tab, bias, tgt, part_m, part_s, S,
                                                          nll, lse, N, D);
  return cudaGetLastError();
}

template <typename Tin, bool RB, int RT>
cudaError_t cce_bwd(const Tin* x, const float* tab, const float* bias, const int* tgt,
                    const float* dnll, const float* lse, Tin* dx, float* dxp, int S,
                    float* grads, int N, int V, int D, int valid_v, cudaStream_t stream) {
  constexpr int BM = 16 * RT, BV = 16 * RT, GS = BV + 4;
  const int D4 = ce_stride(D);
  const int tps = ((V + BV - 1) / BV + S - 1) / S;
  cudaError_t e;
  const size_t s1 = sizeof(float) * ((size_t)(BM + BV) * D4 + (size_t)BM * GS);
  if ((e = ce_set_smem(cce_dx_kernel<Tin, RB, RT>, s1)) != cudaSuccess) return e;
  cce_dx_kernel<Tin, RB, RT><<<dim3((N + BM - 1) / BM, S), CE_THREADS, s1, stream>>>(
      x, tab, bias, tgt, dnll, lse, dxp, N, V, D, valid_v, tps);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const size_t P = (size_t)N * D;
  cce_dx_reduce_kernel<Tin, RB><<<(unsigned)((P + 255) / 256), 256, 0, stream>>>(
      dxp, S, tab, tgt, dnll, dx, N, D);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const size_t s2 = s1 + sizeof(float) * 16 * BV;
  if ((e = ce_set_smem(ce_dtab_kernel<Tin, RB, RT>, s2)) != cudaSuccess) return e;
  ce_dtab_kernel<Tin, RB, RT><<<dim3((V + BV - 1) / BV, 1), CE_THREADS, s2, stream>>>(
      x, tab, bias, tgt, dnll, lse, grads, N, V, D, valid_v, 1);
  return cudaGetLastError();
}

// The instantiation for mm_bf16 and the tile size of D.
template <typename Tin>
cudaError_t cce_fwd_any(const Tin* x, const float* tab, const float* bias, const int* tgt,
                        float* part, int S, float* nll, float* lse, int N, int V, int D,
                        int valid_v, int mm_bf16, cudaStream_t s) {
  if (D <= 128)
    return mm_bf16
               ? cce_fwd<Tin, true, 4>(x, tab, bias, tgt, part, S, nll, lse, N, V, D, valid_v, s)
               : cce_fwd<Tin, false, 4>(x, tab, bias, tgt, part, S, nll, lse, N, V, D, valid_v,
                                        s);
  return mm_bf16
             ? cce_fwd<Tin, true, 1>(x, tab, bias, tgt, part, S, nll, lse, N, V, D, valid_v, s)
             : cce_fwd<Tin, false, 1>(x, tab, bias, tgt, part, S, nll, lse, N, V, D, valid_v, s);
}

template <typename Tin>
cudaError_t cce_bwd_any(const Tin* x, const float* tab, const float* bias, const int* tgt,
                        const float* dnll, const float* lse, Tin* dx, float* dxp, int S,
                        float* grads, int N, int V, int D, int valid_v, int mm_bf16,
                        cudaStream_t s) {
  if (D <= 128)
    return mm_bf16 ? cce_bwd<Tin, true, 4>(x, tab, bias, tgt, dnll, lse, dx, dxp, S, grads, N,
                                           V, D, valid_v, s)
                   : cce_bwd<Tin, false, 4>(x, tab, bias, tgt, dnll, lse, dx, dxp, S, grads, N,
                                            V, D, valid_v, s);
  return mm_bf16 ? cce_bwd<Tin, true, 1>(x, tab, bias, tgt, dnll, lse, dx, dxp, S, grads, N, V,
                                         D, valid_v, s)
                 : cce_bwd<Tin, false, 1>(x, tab, bias, tgt, dnll, lse, dx, dxp, S, grads, N, V,
                                          D, valid_v, s);
}

}  // namespace

extern "C" {

// x: [N, D] fp32 (bf16 == 0) or bf16; table: [V, D] and bias: [V] fp32;
// tgt: [N] int32; part: [2, S, N] fp32 scratch for the S vocab splits;
// nll: [N] fp32 out; lse: [N] fp32 out, or null; valid_v: columns at or
// beyond it are masked; mm_bf16: round x and the table to bf16 for the
// logits; device: the card that holds them.
int recblr_cce_fwd(const void* x, const void* table, const void* bias, const void* tgt,
                   void* part, int S, void* nll, void* lse, int N, int V, int D, int valid_v,
                   int bf16, int mm_bf16, int device, void* stream) {
  // this library has its own (static) CUDA runtime: select the tensors' card
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(table);
  const float* b = static_cast<const float*>(bias);
  const int* g = static_cast<const int*>(tgt);
  float* pt = static_cast<float*>(part);
  float* n = static_cast<float*>(nll);
  float* l = static_cast<float*>(lse);
  if (bf16)
    return cce_fwd_any(static_cast<const __nv_bfloat16*>(x), t, b, g, pt, S, n, l, N, V, D,
                       valid_v, mm_bf16, s);
  return cce_fwd_any(static_cast<const float*>(x), t, b, g, pt, S, n, l, N, V, D, valid_v,
                     mm_bf16, s);
}

// x, dx: [N, D] fp32 (bf16 == 0) or bf16; table, bias, tgt, valid_v,
// mm_bf16: the forward's; dnll: [N] fp32; lse: [N] fp32 kept by the
// forward; dxp: [S, N, D] fp32 scratch; grads: [V * D + V] fp32 out,
// dtable [V, D] then dbias [V].
int recblr_cce_bwd(const void* x, const void* table, const void* bias, const void* tgt,
                   const void* dnll, const void* lse, void* dx, void* dxp, int S, void* grads,
                   int N, int V, int D, int valid_v, int bf16, int mm_bf16, int device,
                   void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(table);
  const float* b = static_cast<const float*>(bias);
  const int* g = static_cast<const int*>(tgt);
  const float* dn = static_cast<const float*>(dnll);
  const float* l = static_cast<const float*>(lse);
  float* p = static_cast<float*>(dxp);
  float* gr = static_cast<float*>(grads);
  if (bf16)
    return cce_bwd_any(static_cast<const __nv_bfloat16*>(x), t, b, g, dn, l,
                       static_cast<__nv_bfloat16*>(dx), p, S, gr, N, V, D, valid_v, mm_bf16, s);
  return cce_bwd_any(static_cast<const float*>(x), t, b, g, dn, l, static_cast<float*>(dx), p, S,
                     gr, N, V, D, valid_v, mm_bf16, s);
}

const char* recblr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
