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
#include "common.cuh"

using namespace recblr;

namespace {

constexpr int CE_THREADS = 256;  // 16 x 16 threads: tx = column lane, ty = row lane
constexpr float NEG = -1e30f;    // the logit of a masked column

// A row's stride in shared memory: D rounded up to 8, plus 4.  The stride
// is then an odd number of float4s, so 8 lanes reading float4s of 8
// consecutive rows hit 8 distinct groups of 4 banks.
__host__ __device__ inline int ce_stride(int D) { return (D + 7) / 8 * 8 + 4; }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// rows[r, k] = x[n0 + r, k] for r < BM, k < D4 (0 outside the M rows and
// the D columns), rounded to bf16 when ROUND.
template <bool ROUND, typename Tin>
__device__ void load_rows(const Tin* __restrict__ x, int n0, int M, int D, int D4, int BM,
                          float* rows) {
  for (int i = threadIdx.x; i < BM * D4; i += blockDim.x) {
    const int r = i / D4, k = i % D4;
    const float v = (r < M && k < D) ? load_act(x, (size_t)(n0 + r) * D + k) : 0.f;
    rows[i] = mm_op<ROUND>(v);
  }
}

// acc[i][j] = sum_k xs[ty + 16 i, k] ts[tx + 16 j, k] over k < Dk (a
// multiple of 4), the x operand rounded to bf16 as it is read when RX.
template <int RT, bool RX>
__device__ __forceinline__ void tile_logits(const float* __restrict__ xs,
                                            const float* __restrict__ ts, int D4, int Dk,
                                            int tx, int ty, float (&acc)[RT][RT]) {
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < RT; ++j) acc[i][j] = 0.f;
  for (int k = 0; k < Dk; k += 4) {
    float4 a[RT], b[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      a[i] = ld4(xs + (ty + 16 * i) * D4 + k);
      if (RX) {
        a[i].x = mm_op<true>(a[i].x);
        a[i].y = mm_op<true>(a[i].y);
        a[i].z = mm_op<true>(a[i].z);
        a[i].w = mm_op<true>(a[i].w);
      }
    }
#pragma unroll
    for (int j = 0; j < RT; ++j) b[j] = ld4(ts + (tx + 16 * j) * D4 + k);
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        acc[i][j] = fmaf(a[i].w, b[j].w, s);
      }
  }
}

// The logit of column col (< V) from its product: bias added, -1e30 at
// col >= valid_v.
__device__ __forceinline__ float ce_logit(float prod, const float* __restrict__ bias, int col,
                                          int valid_v) {
  return col < valid_v ? prod + __ldg(bias + col) : NEG;
}

// (m, s) <- the logsumexp state of the union of (m, s) and (om, os): m the
// largest logit seen, s the sum of exp(l - m); m = -inf means no logit yet.
__device__ __forceinline__ void lse_merge(float& m, float& s, float om, float os) {
  const float nm = fmaxf(m, om);
  if (nm == -INFINITY) return;
  s = (m == -INFINITY ? 0.f : s * exp_t(m - nm)) + (om == -INFINITY ? 0.f : os * exp_t(om - nm));
  m = nm;
}

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
    for (int i = threadIdx.x; i < BV * D4; i += blockDim.x) {
      const int r = i / D4, k = i % D4;
      ts[i] = (v0 + r < V && k < D) ? mm_op<RB>(__ldg(tab + (size_t)(v0 + r) * D + k)) : 0.f;
    }
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

// g of the thread's RT x RT logits: (exp(l - lse) - onehot) dnll, 0 on
// columns >= V.
template <int RT>
__device__ __forceinline__ void ce_grad(const float (&acc)[RT][RT], const float* bias, int v0,
                                        int V, int valid_v, int tx, const int (&tg)[RT],
                                        const float (&lse)[RT], const float (&dn)[RT],
                                        float (&g)[RT][RT]) {
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < RT; ++j) {
      const int col = v0 + tx + 16 * j;
      float gv = 0.f;
      if (col < V) {
        const float p = exp_t(ce_logit(acc[i][j], bias, col, valid_v) - lse[i]);
        gv = (p - (col == tg[i] ? 1.f : 0.f)) * dn[i];
      }
      g[i][j] = gv;
    }
}

// The per-row inputs of the backward: target, lse and dnll of the
// thread's rows; a row beyond N gets lse +inf and dnll 0, so its g is 0.
template <int RT>
__device__ __forceinline__ void ce_row_inputs(const int* tgt, const float* lse,
                                              const float* dnll, int n0, int N, int ty,
                                              int (&tg)[RT], float (&ls)[RT], float (&dn)[RT]) {
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = n0 + ty + 16 * i;
    const bool in = row < N;
    tg[i] = in ? tgt[row] : -1;
    ls[i] = in ? lse[row] : INFINITY;
    dn[i] = in ? dnll[row] : 0.f;
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
    for (int i = threadIdx.x; i < BV * D4; i += blockDim.x) {
      const int r = i / D4, k = i % D4;
      ts[i] = (v0 + r < V && k < D) ? mm_op<RB>(__ldg(tab + (size_t)(v0 + r) * D + k)) : 0.f;
    }
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
    for (int v = 0; v < BV; ++v) {
      float gv[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) gv[i] = gs[(ty + 16 * i) * GS + v];
#pragma unroll
      for (int jj = 0; jj < MAXJ; ++jj) {
        const int d = tx + 16 * jj;
        if (jj < NJ && d < D) {
          const float tv = ts[v * D4 + d];
#pragma unroll
          for (int i = 0; i < RT; ++i) dacc[i][jj] = fmaf(gv[i], tv, dacc[i][jj]);
        }
      }
    }
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

// dtable and dbias.  Block (vocab tile vt, row split r): columns v0 .. v0 +
// BV - 1 over the row blocks r, r + R, ...; writes its [V, D] dtable and
// [V] dbias part into partial[r] ([V * D + V] floats; only its columns).
template <typename Tin, bool RB, int RT>
__global__ void __launch_bounds__(CE_THREADS)
ce_dtab_kernel(const Tin* __restrict__ x, const float* __restrict__ tab,
               const float* __restrict__ bias, const int* __restrict__ tgt,
               const float* __restrict__ dnll, const float* __restrict__ lse,
               float* __restrict__ partial, int N, int V, int D, int valid_v, int R) {
  extern __shared__ __align__(16) float smem[];
  constexpr int BM = 16 * RT, BV = 16 * RT, GS = BV + 4, MAXJ = 32 / RT;
  const int D4 = ce_stride(D), Dk = (D + 3) / 4 * 4, NJ = (D + 15) / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int v0 = blockIdx.x * BV;
  const int r = blockIdx.y;
  float* ts = smem;           // [BV, D4] the block's table tile (rounded when RB)
  float* xs = ts + BV * D4;   // [BM, D4] x rows, unrounded
  float* gs = xs + BM * D4;   // [BM, GS] g of the row block, unrounded
  float* red = gs + BM * GS;  // [16, BV] dbias partial sums of the 16 row lanes
  for (int i = threadIdx.x; i < BV * D4; i += blockDim.x) {
    const int rr = i / D4, k = i % D4;
    ts[i] = (v0 + rr < V && k < D) ? mm_op<RB>(__ldg(tab + (size_t)(v0 + rr) * D + k)) : 0.f;
  }
  float tacc[RT][MAXJ], bacc[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    bacc[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < MAXJ; ++jj) tacc[i][jj] = 0.f;
  }
  const int nrb = (N + BM - 1) / BM;
  for (int rb = r; rb < nrb; rb += R) {
    const int n0 = rb * BM;
    __syncthreads();  // the previous row block is consumed (and ts written)
    load_rows<false>(x, n0, min(BM, N - n0), D, D4, BM, xs);
    __syncthreads();
    int tg[RT];
    float ls[RT], dn[RT];
    ce_row_inputs<RT>(tgt, lse, dnll, n0, N, ty, tg, ls, dn);
    float acc[RT][RT], g[RT][RT];
    tile_logits<RT, RB>(xs, ts, D4, Dk, tx, ty, acc);
    ce_grad<RT>(acc, bias, v0, V, valid_v, tx, tg, ls, dn, g);
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        gs[(ty + 16 * i) * GS + tx + 16 * j] = g[i][j];
        bacc[j] += g[i][j];
      }
    __syncthreads();
    // dtable[v, d] += sum_m g[m, v] x[m, d]: the thread's rows v = ty + 16 i
    for (int mm = 0; mm < BM; ++mm) {
      float gv[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) gv[i] = gs[mm * GS + ty + 16 * i];
#pragma unroll
      for (int jj = 0; jj < MAXJ; ++jj) {
        const int d = tx + 16 * jj;
        if (jj < NJ && d < D) {
          const float xv = xs[mm * D4 + d];
#pragma unroll
          for (int i = 0; i < RT; ++i) tacc[i][jj] = fmaf(gv[i], xv, tacc[i][jj]);
        }
      }
    }
  }
  float* part = partial + (size_t)r * ((size_t)V * D + V);
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int v = v0 + ty + 16 * i;
    if (v >= V) continue;
#pragma unroll
    for (int jj = 0; jj < MAXJ; ++jj) {
      const int d = tx + 16 * jj;
      if (jj < NJ && d < D) part[(size_t)v * D + d] = tacc[i][jj];
    }
  }
  // dbias: the thread summed columns tx + 16 j over its rows; add the 16
  // row lanes in order
#pragma unroll
  for (int j = 0; j < RT; ++j) red[ty * BV + tx + 16 * j] = bacc[j];
  __syncthreads();
  for (int c = threadIdx.x; c < BV; c += blockDim.x) {
    float sum = 0.f;
    for (int t = 0; t < 16; ++t) sum += red[t * BV + c];
    if (v0 + c < V) part[(size_t)V * D + v0 + c] = sum;
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
