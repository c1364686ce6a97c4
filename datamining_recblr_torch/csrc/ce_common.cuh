// Shared device code of the softmax cross-entropy kernels: the whole-table
// ones (fused_ce.cu) and the vocab-chunked ones (fused_ce_chunked.cu).
//
// A block of CE_THREADS = 16 x 16 threads (tx the column lane, ty the row
// lane) holds BM = 16 RT rows of x and a BV = 16 RT column tile of the
// table in shared memory; each thread computes an RT x RT block of logits
// with float4 reads along D from rows padded to an odd number of float4s,
// so 8 lanes never share a bank.  RT = 4 (64 x 64 tiles) for D <= 128,
// else RT = 1 (16 x 16) so that D <= 512 fits shared memory.
#pragma once

#include "common.cuh"

namespace recblr {

constexpr int CE_THREADS = 256;  // 16 x 16 threads: tx = column lane, ty = row lane
constexpr float CE_NEG = -1e30f; // the logit of a masked column

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

// ts[r, k] = table[v0 + r, k] for r < BV (0 beyond V and D), rounded to
// bf16 when ROUND.
template <bool ROUND>
__device__ void load_table_tile(const float* __restrict__ tab, int v0, int V, int D, int D4,
                                int BV, float* ts) {
  for (int i = threadIdx.x; i < BV * D4; i += blockDim.x) {
    const int r = i / D4, k = i % D4;
    ts[i] = (v0 + r < V && k < D) ? mm_op<ROUND>(__ldg(tab + (size_t)(v0 + r) * D + k)) : 0.f;
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
  return col < valid_v ? prod + __ldg(bias + col) : CE_NEG;
}

// (m, s) <- the logsumexp state of the union of (m, s) and (om, os): m the
// largest logit seen, s the sum of exp(l - m); m = -inf means no logit yet.
__device__ __forceinline__ void lse_merge(float& m, float& s, float om, float os) {
  const float nm = fmaxf(m, om);
  if (nm == -INFINITY) return;
  s = (m == -INFINITY ? 0.f : s * exp_t(m - nm)) + (om == -INFINITY ? 0.f : os * exp_t(om - nm));
  m = nm;
}

// The online logsumexp state (m, s) of each of the thread's RT rows over
// the table tile's logits acc (columns v0 + tx + 16 j < V).
template <int RT>
__device__ __forceinline__ void lse_update(const float (&acc)[RT][RT],
                                           const float* __restrict__ bias, int v0, int V,
                                           int valid_v, int tx, float (&m)[RT], float (&s)[RT]) {
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

// g of the thread's RT x RT logits: (exp(l - lse) - onehot) dnll, 0 on
// columns >= V; a target of -1 takes no one-hot term.
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

// dacc[i][jj] += sum_v gs[ty + 16 i, v] ts[v, tx + 16 jj] over the BV
// columns of a tile: the thread's RT rows and D / 16 columns of g table.
template <int RT, int MAXJ>
__device__ __forceinline__ void tile_g_table(const float* __restrict__ gs, int GS,
                                             const float* __restrict__ ts, int D4, int BV,
                                             int D, int NJ, int tx, int ty,
                                             float (&dacc)[RT][MAXJ]) {
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

// dtable and dbias.  Block (vocab tile vt, row split r): columns v0 .. v0 +
// BV - 1 over the row blocks r, r + R, ...; writes its [V, D] dtable and
// [V] dbias part into partial[r] ([V * D + V] floats; only its columns).
// With R = 1, partial is the [V * D + V] gradient itself.  The logits take
// x and the table rounded when RB, g and x enter dtable unrounded.
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
  load_table_tile<RB>(tab, v0, V, D, D4, BV, ts);
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

template <typename K>
inline cudaError_t ce_set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace recblr
