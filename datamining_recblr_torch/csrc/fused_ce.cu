// Whole-table softmax cross-entropy for Hopper, forward and backward, with
// the logits computed in the kernels' own bodies and never written to
// device memory.
//
// Replaces the TPU kernels datamining_recblr_tpu/ops/fused_ce.py:
// _ce_fwd_kernel (reached through _ce_fwd) and _ce_bwd_kernel (through
// _ce_bwd), the whole-table path of fused_softmax_ce.  Semantics: fp32
// logits l = x table^T + bias (with mm_bf16 both x and the table rounded to
// bf16 first, the products summed in fp32), columns >= valid_v at -1e30,
// nll = logsumexp(l) - l[target] with exp as exp2(x log2 e); the backward
// g = (softmax(l) - onehot(target)) dnll, dx = g table (with mm_bf16 g and
// the table rounded), dtable = g^T x and dbias = sum g (g unrounded).
//
// What bounds it: at BERT4Rec's cloze loss (N = 81,920 rows, V = 3,417,
// D = 64) the logits are 2NVD = 35.8 GFLOP of fp32 FMA per pass against
// 22 MB of x, table and nll traffic: bound by fp32 operations.  The TPU
// kernel exists so that the [N, V] logits (1.12 GB fp32) never reach HBM;
// here too every logit lives in registers only.  The design:
//   fwd   a block per BM rows holds its x rows in shared memory and streams
//         the table in [BV, D] tiles; each thread computes an RT x RT block
//         of logits (float4 reads along D from rows padded to an odd number
//         of float4s, so 8 lanes never share a bank) and keeps an online
//         logsumexp per row (running max, rescaled sum); the 16 lanes of a
//         row combine theirs with shuffles.  It writes nll and, in
//         training, the lse the backward reads.
//   dx    the same stream of table tiles per row block: the logits again,
//         g from the saved lse, and dx += g table accumulated in registers.
//   dtab  a block per (vocab tile, row split) holds its table tile and
//         streams every BM-row block of its split: the logits, g, dbias and
//         dtable += g^T x in registers, written once to the split's own
//         partial slice; a reduction sums the R slices in order, so the
//         gradients are the same bits from run to run (no atomics).
// RT = 4 (64-row, 64-column tiles) for D <= 128, else RT = 1 (16 x 16
// tiles) so that D <= 512 fits shared memory.  Left for later PRs: tensor
// cores (wgmma) for the bf16 products and one pass for dx and dtable.
//
// C interface (loaded with ctypes): returns a cudaError_t, 0 on success.
#include "ce_common.cuh"

using namespace recblr;

namespace {

// Forward.  Block: rows n0 .. n0 + BM - 1.  nll, lse: [N] fp32 (lse may be
// null).
template <typename Tin, bool RB, int RT>
__global__ void __launch_bounds__(CE_THREADS)
ce_fwd_kernel(const Tin* __restrict__ x, const float* __restrict__ tab,
              const float* __restrict__ bias, const int* __restrict__ tgt,
              float* __restrict__ nll, float* __restrict__ lse_out, int N, int V, int D,
              int valid_v) {
  extern __shared__ __align__(16) float smem[];
  constexpr int BM = 16 * RT, BV = 16 * RT;
  const int D4 = ce_stride(D), Dk = (D + 3) / 4 * 4;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n0 = blockIdx.x * BM;
  float* xs = smem;         // [BM, D4] x rows (rounded when RB)
  float* ts = xs + BM * D4; // [BV, D4] table tile (rounded when RB)
  load_rows<RB>(x, n0, min(BM, N - n0), D, D4, BM, xs);
  int tg[RT];
  float m[RT], s[RT], tl[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = n0 + ty + 16 * i;
    tg[i] = row < N ? tgt[row] : -1;
    m[i] = -INFINITY;
    s[i] = 0.f;
    tl[i] = 0.f;
  }
  for (int v0 = 0; v0 < V; v0 += BV) {
    __syncthreads();  // the previous tile is consumed (and xs written)
    load_table_tile<RB>(tab, v0, V, D, D4, BV, ts);
    __syncthreads();
    float acc[RT][RT];
    tile_logits<RT, false>(xs, ts, D4, Dk, tx, ty, acc);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      float l[RT];
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        const int col = v0 + tx + 16 * j;
        l[j] = -INFINITY;
        if (col < V) {
          l[j] = ce_logit(acc[i][j], bias, col, valid_v);
          if (col == tg[i]) tl[i] = l[j];
          tmax = fmaxf(tmax, l[j]);
        }
      }
      if (tmax == -INFINITY) continue;
      const float nm = fmaxf(m[i], tmax);
      float si = m[i] == -INFINITY ? 0.f : s[i] * exp_t(m[i] - nm);
#pragma unroll
      for (int j = 0; j < RT; ++j)
        if (l[j] != -INFINITY) si += exp_t(l[j] - nm);
      s[i] = si;
      m[i] = nm;
    }
  }
  // the 16 lanes of a row (one half of a warp) combine their states
#pragma unroll
  for (int i = 0; i < RT; ++i) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, m[i], o);
      const float os = __shfl_xor_sync(0xffffffffu, s[i], o);
      tl[i] += __shfl_xor_sync(0xffffffffu, tl[i], o);
      lse_merge(m[i], s[i], om, os);
    }
    const int row = n0 + ty + 16 * i;
    if (tx == 0 && row < N) {
      const float L = m[i] + logf(s[i]);
      nll[row] = L - tl[i];
      if (lse_out != nullptr) lse_out[row] = L;
    }
  }
}

// dx.  Block: rows n0 .. n0 + BM - 1; dx [N, D] in x's type.  The thread
// accumulates dx[ty + 16 i, tx + 16 jj] over every table tile.
template <typename Tin, bool RB, int RT>
__global__ void __launch_bounds__(CE_THREADS)
ce_dx_kernel(const Tin* __restrict__ x, const float* __restrict__ tab,
             const float* __restrict__ bias, const int* __restrict__ tgt,
             const float* __restrict__ dnll, const float* __restrict__ lse,
             Tin* __restrict__ dx, int N, int V, int D, int valid_v) {
  extern __shared__ __align__(16) float smem[];
  constexpr int BM = 16 * RT, BV = 16 * RT, GS = BV + 4, MAXJ = 32 / RT;
  const int D4 = ce_stride(D), Dk = (D + 3) / 4 * 4, NJ = (D + 15) / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n0 = blockIdx.x * BM;
  float* xs = smem;          // [BM, D4] x rows (rounded when RB)
  float* ts = xs + BM * D4;  // [BV, D4] table tile (rounded when RB)
  float* gs = ts + BV * D4;  // [BM, GS] g of the tile (rounded when RB)
  load_rows<RB>(x, n0, min(BM, N - n0), D, D4, BM, xs);
  int tg[RT];
  float ls[RT], dn[RT];
  ce_row_inputs<RT>(tgt, lse, dnll, n0, N, ty, tg, ls, dn);
  float dacc[RT][MAXJ];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int jj = 0; jj < MAXJ; ++jj) dacc[i][jj] = 0.f;
  for (int v0 = 0; v0 < V; v0 += BV) {
    __syncthreads();  // the previous tile and its g are consumed
    load_table_tile<RB>(tab, v0, V, D, D4, BV, ts);
    __syncthreads();
    float acc[RT][RT], g[RT][RT];
    tile_logits<RT, false>(xs, ts, D4, Dk, tx, ty, acc);
    ce_grad<RT>(acc, bias, v0, V, valid_v, tx, tg, ls, dn, g);
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < RT; ++j) gs[(ty + 16 * i) * GS + tx + 16 * j] = mm_op<RB>(g[i][j]);
    __syncthreads();
    // dx[m, d] += sum_v g[m, v] table[v, d]
    tile_g_table<RT, MAXJ>(gs, GS, ts, D4, BV, D, NJ, tx, ty, dacc);
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = n0 + ty + 16 * i;
    if (row >= N) continue;
#pragma unroll
    for (int jj = 0; jj < MAXJ; ++jj) {
      const int d = tx + 16 * jj;
      if (jj < NJ && d < D) store_act(dx, (size_t)row * D + d, dacc[i][jj]);
    }
  }
}

// out[p] = sum over r = 0 .. R-1, in order, of partial[r, p].
__global__ void ce_reduce_kernel(const float* __restrict__ partial, int R, size_t P,
                                 float* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P) return;
  float s = 0.f;
  for (int r = 0; r < R; ++r) s += partial[(size_t)r * P + i];
  out[i] = s;
}

template <typename K>
inline cudaError_t ce_set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename Tin, bool RB, int RT>
cudaError_t ce_fwd(const Tin* x, const float* tab, const float* bias, const int* tgt, float* nll,
                   float* lse, int N, int V, int D, int valid_v, cudaStream_t stream) {
  constexpr int BM = 16 * RT;
  const size_t sm = sizeof(float) * 2 * (size_t)BM * ce_stride(D);
  cudaError_t e = ce_set_smem(ce_fwd_kernel<Tin, RB, RT>, sm);
  if (e != cudaSuccess) return e;
  ce_fwd_kernel<Tin, RB, RT><<<(N + BM - 1) / BM, CE_THREADS, sm, stream>>>(
      x, tab, bias, tgt, nll, lse, N, V, D, valid_v);
  return cudaGetLastError();
}

template <typename Tin, bool RB, int RT>
cudaError_t ce_bwd(const Tin* x, const float* tab, const float* bias, const int* tgt,
                   const float* dnll, const float* lse, Tin* dx, int R, float* partial,
                   float* grads, int N, int V, int D, int valid_v, cudaStream_t stream) {
  constexpr int BM = 16 * RT, BV = 16 * RT, GS = BV + 4;
  const int D4 = ce_stride(D);
  cudaError_t e;
  const size_t s1 = sizeof(float) * ((size_t)(BM + BV) * D4 + (size_t)BM * GS);
  if ((e = ce_set_smem(ce_dx_kernel<Tin, RB, RT>, s1)) != cudaSuccess) return e;
  ce_dx_kernel<Tin, RB, RT><<<(N + BM - 1) / BM, CE_THREADS, s1, stream>>>(
      x, tab, bias, tgt, dnll, lse, dx, N, V, D, valid_v);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const size_t s2 = s1 + sizeof(float) * 16 * BV;
  if ((e = ce_set_smem(ce_dtab_kernel<Tin, RB, RT>, s2)) != cudaSuccess) return e;
  ce_dtab_kernel<Tin, RB, RT><<<dim3((V + BV - 1) / BV, R), CE_THREADS, s2, stream>>>(
      x, tab, bias, tgt, dnll, lse, partial, N, V, D, valid_v, R);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const size_t P = (size_t)V * D + V;
  ce_reduce_kernel<<<(unsigned)((P + 255) / 256), 256, 0, stream>>>(partial, R, P, grads);
  return cudaGetLastError();
}

// The instantiation for x's type, mm_bf16 and the tile size of D.
template <typename Tin>
cudaError_t ce_fwd_any(const Tin* x, const float* tab, const float* bias, const int* tgt,
                       float* nll, float* lse, int N, int V, int D, int valid_v, int mm_bf16,
                       cudaStream_t s) {
  if (D <= 128)
    return mm_bf16 ? ce_fwd<Tin, true, 4>(x, tab, bias, tgt, nll, lse, N, V, D, valid_v, s)
                   : ce_fwd<Tin, false, 4>(x, tab, bias, tgt, nll, lse, N, V, D, valid_v, s);
  return mm_bf16 ? ce_fwd<Tin, true, 1>(x, tab, bias, tgt, nll, lse, N, V, D, valid_v, s)
                 : ce_fwd<Tin, false, 1>(x, tab, bias, tgt, nll, lse, N, V, D, valid_v, s);
}

template <typename Tin>
cudaError_t ce_bwd_any(const Tin* x, const float* tab, const float* bias, const int* tgt,
                       const float* dnll, const float* lse, Tin* dx, int R, float* partial,
                       float* grads, int N, int V, int D, int valid_v, int mm_bf16,
                       cudaStream_t s) {
  if (D <= 128)
    return mm_bf16 ? ce_bwd<Tin, true, 4>(x, tab, bias, tgt, dnll, lse, dx, R, partial, grads,
                                          N, V, D, valid_v, s)
                   : ce_bwd<Tin, false, 4>(x, tab, bias, tgt, dnll, lse, dx, R, partial, grads,
                                           N, V, D, valid_v, s);
  return mm_bf16 ? ce_bwd<Tin, true, 1>(x, tab, bias, tgt, dnll, lse, dx, R, partial, grads, N,
                                        V, D, valid_v, s)
                 : ce_bwd<Tin, false, 1>(x, tab, bias, tgt, dnll, lse, dx, R, partial, grads, N,
                                         V, D, valid_v, s);
}

}  // namespace

extern "C" {

// x: [N, D] fp32 (bf16 == 0) or bf16; table: [V, D] and bias: [V] fp32;
// tgt: [N] int32; nll: [N] fp32 out; lse: [N] fp32 out, or null; valid_v:
// columns at or beyond it are masked; mm_bf16: round x and the table to
// bf16 for the logits; device: the card that holds them.
int recblr_ce_fwd(const void* x, const void* table, const void* bias, const void* tgt,
                  void* nll, void* lse, int N, int V, int D, int valid_v, int bf16, int mm_bf16,
                  int device, void* stream) {
  // this library has its own (static) CUDA runtime: select the tensors' card
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(table);
  const float* b = static_cast<const float*>(bias);
  const int* g = static_cast<const int*>(tgt);
  float* n = static_cast<float*>(nll);
  float* l = static_cast<float*>(lse);
  if (bf16)
    return ce_fwd_any(static_cast<const __nv_bfloat16*>(x), t, b, g, n, l, N, V, D, valid_v,
                      mm_bf16, s);
  return ce_fwd_any(static_cast<const float*>(x), t, b, g, n, l, N, V, D, valid_v, mm_bf16, s);
}

// x, dx: [N, D] fp32 (bf16 == 0) or bf16; table, bias, tgt, valid_v,
// mm_bf16: the forward's; dnll: [N] fp32; lse: [N] fp32 kept by the
// forward; partial: [R, V * D + V] fp32 scratch; grads: [V * D + V] fp32
// out, dtable [V, D] then dbias [V].
int recblr_ce_bwd(const void* x, const void* table, const void* bias, const void* tgt,
                  const void* dnll, const void* lse, void* dx, int R, void* partial, void* grads,
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
  float* pt = static_cast<float*>(partial);
  float* gr = static_cast<float*>(grads);
  if (bf16)
    return ce_bwd_any(static_cast<const __nv_bfloat16*>(x), t, b, g, dn, l,
                      static_cast<__nv_bfloat16*>(dx), R, pt, gr, N, V, D, valid_v, mm_bf16, s);
  return ce_bwd_any(static_cast<const float*>(x), t, b, g, dn, l, static_cast<float*>(dx), R,
                    pt, gr, N, V, D, valid_v, mm_bf16, s);
}

const char* recblr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
