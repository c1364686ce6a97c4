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
// D = 64) the logits are 2NVD = 35.8 GFLOP per pass against 22 MB of x,
// table and nll traffic: bound by operations.  The TPU kernel exists so
// that the [N, V] logits (1.12 GB fp32) never reach HBM; here too every
// logit lives in registers only.
//
// The forward, and the backward at D > 256, compute the products as fp32
// FMA on the CUDA cores (ce_common.cuh's 16 x 16 thread tiles):
//   fwd   a block per BM rows holds its x rows in shared memory and streams
//         the table in [BV, D] tiles; each thread computes an RT x RT block
//         of logits and keeps an online logsumexp per row (running max,
//         rescaled sum); the 16 lanes of a row combine theirs with
//         shuffles.  It writes nll and, in training, the lse the backward
//         reads.  RT = 4 (64 x 64 tiles) for D <= 128, else RT = 1.
//   dx, dtab (D 257-512, RT = 1) as the passes below, one logit a thread.
//
// The backward at D <= 256 runs its four products (the logits once per
// pass, dx = g table, dtable = g^T x) on the tensor cores through mma.sync
// (mma_tile.cuh), with the plain version's rounding points: with mm_bf16
// the logits and dx take bf16 operands (m16n8k16; g rounded with its
// one-hot term), otherwise every product is 3xTF32 (m16n8k8: a = hi + lo
// by tf32_split, a b ~ hi hi + hi lo + lo hi in fp32 sums, what it leaves
// below 2^-21 of |a| |b| a term); dtable always keeps g unrounded (g in two
// TF32 terms against a bf16 x, exact in TF32, three against an fp32 x).
// The bound is then 3 (fp32) or 2 + 2 (bf16) logit-sized products at the
// TF32 and bf16 peaks, some 0.65 and 0.22 ms at the cloze loss; the kernels
// do four, and one exp per logit and pass.  D is padded to 64, 128 or 256
// (mma_dp); the tiles hold 4,096 elements of a row's width:
//   (a) ce_dx_mma_kernel, a block per 128 rows over every table tile (640
//       blocks at the cloze loss, no vocab split): x's rows stay in shared
//       memory (round(x) for ldmatrix, or fp32 split as each A fragment is
//       read); each tile is copied a tile ahead by cp.async and converted
//       once (to bf16, or to its TF32 hi and lo); each warp computes its 16
//       rows' logits, g = (exp(l - lse) - onehot) dnll in registers, and
//       dx += g table with g's C fragments as the A fragments (packed to
//       bf16, or split with the depth read in the C fragment's column
//       order, split_c_as_a): dx leaves registers once, in x's type.
//   (b) ce_dtab_mma_kernel, a block per (128 vocab rows, row split): V =
//       3,417 gives 27 vocab blocks for 132 SMs, so the rows split into R
//       fixed partials (recblr_ce_bwd_splits picks R for the fullest last
//       wave), each block walking the row chunks r, r + R, ..., each copied
//       a chunk ahead by cp.async; each warp recomputes its 16 vocab rows'
//       logits transposed (vocab x rows) against the chunk's x, forms g,
//       sums dbias on the CUDA cores and adds g^T x on the tensor cores in
//       TF32; the partials go to the split's own slice and
//       ce_reduce_kernel sums the R slices in order.  Folding dtable into
//       pass (a) would need a [V, D] slice per row block; the partials here
//       take R of them.
// Two points of accuracy, both measured against the plain version:
//   - A tensor core's fp32 sum rounds toward zero, a bias that grows with
//     every product added to one accumulator (dx over 3,417 vocab rows read
//     2.8e-5 of its largest value, dtable 4e-5).  Every product is summed
//     per tile in a fresh accumulator and added to the running sum in fp32
//     (add_tile): 7e-6 and 4e-6, the FMA kernels' order of error.
//   - With mm_bf16, round(g) flips where g lies within its logit's error of
//     a bf16 rounding boundary, a flip of up to one bf16 ulp of g times a
//     table row in dx.  The tensor-core logits differ from an fp32 FMA sum
//     by up to ~2e-6 at D 64, which flipped enough entries to put 7 of
//     dx's values out of the smoke's bound at the cloze loss.  Pass (a)
//     therefore recomputes each logit whose g lies that near a boundary
//     (near_bf16_tie, some 0.4% of them at D 64, 1.6% at D 256) as the
//     FMA forward sums it, so round(g) is the FMA backward's.
// Every sum runs in a fixed order (the mma accumulation order within a
// block, the splits in order, dbias's four lanes in a fixed butterfly): the
// same bits from run to run, no atomics.  Left for later PRs: the forward
// on the tensor cores, D 257-512 on them, wgmma.
//
// C interface (loaded with ctypes): returns a cudaError_t, 0 on success.
#include <cstdint>
#include <type_traits>

#include "ce_common.cuh"
#include "mma_tile.cuh"

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

// ---------------------------------------------------------------------------
// the tensor-core backward (D <= 256)
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 256;  // 8 warps
constexpr int MMA_BM = 128;       // rows of a pass (a) block, 16 a warp
constexpr int MMA_VB = 128;       // vocab rows of a pass (b) block, 16 a warp
constexpr int MMA_MAX_D = 256;

// D padded to DP = 64, 128 or 256 columns (zeros beyond D).  Pass (a)'s
// table tile and pass (b)'s row chunk hold 4,096 elements: 64, 32 or 16
// rows.  fp32 rows take a stride of DP + 4 floats (the TF32 fragment loads
// of a warp hit 32 distinct banks), bf16 rows DP + 8 (the 8 rows of an
// ldmatrix matrix hit 8 distinct 16-byte bank groups).  The kernels ask for
// two blocks an SM at DP 64 (128 registers a thread), one wider.
inline int mma_dp(int D) { return D <= 64 ? 64 : D <= 128 ? 128 : 256; }
template <int DP>
struct MmaTile {
  static constexpr int ROWS = 4096 / DP;
  static constexpr int XS = DP + 4;
  static constexpr int BS = DP + 8;
};

__device__ __forceinline__ float ld_x(const void* x, int xbf, size_t i) {
  return xbf ? __bfloat162float(static_cast<const __nv_bfloat16*>(x)[i])
             : static_cast<const float*>(x)[i];
}

// The bias of vocab row col: -1e30 at col >= valid_v, -inf beyond V (g 0).
__device__ __forceinline__ float mma_col_bias(const float* bias, int col, int V, int valid_v) {
  return col < valid_v ? __ldg(bias + col) : (col < V ? CE_NEG : -INFINITY);
}

// s += a b (m16n8k16, bf16 operands) through a fresh accumulator: the
// logits' sum over D rounds as an fp32 sum does, so g, and its rounding to
// bf16, departs from the plain version's as little as an FMA sum's would.
__device__ __forceinline__ void mma_bf16_add(float (&s)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  mma_bf16_16816(c, a, b0, b1);
  add_tile(s, c);
}

// Whether g = (p - onehot) dnll, computed from a tensor-core logit, may
// round to bf16 otherwise than the g of the logit's sequential fp32 FMA sum:
// a rounding boundary (g's low 16 bits at 0x8000) lies within p dnll
// LOGIT_TOL of it.  LOGIT_TOL bounds |tensor-core logit - FMA logit|: at the
// cloze loss (81,920 x 3,417 logits, bf16 operands) the largest was 1.9e-6
// at D 64 and 9.5e-6 at D 256 (NVIDIA H100 80GB HBM3), against 2^-17 =
// 7.6e-6 per 64 columns here.  An fp32 ulp of g is at least |g| 2^-24.
template <int DP>
__device__ __forceinline__ bool near_bf16_tie(float g, float pd) {
  constexpr float LOGIT_TOL = 0x1p-17f * (DP / 64);
  const int dist = abs((int)(__float_as_uint(g) & 0xffffu) - 0x8000);
  return (float)dist * fabsf(g) * 0x1p-24f < pd * LOGIT_TOL;
}

// The logit x . t over DP bf16 columns (zeros beyond D) as one fp32 FMA
// chain in column order: the sum the FMA forward takes for the logits its
// lse comes from (ce_common.cuh tile_logits), so the g of it is the FMA
// backward's to the bit.  (Four chains of 64 columns, added in order, put
// 630 values of the cloze loss's bf16 dx at D 256 out of the plain bound
// against this chain's 120: cuBLAS's fp32 sum is nearer one chain.)
template <int DP>
__device__ __forceinline__ float bf16_dot_fma(const __nv_bfloat16* x, const __nv_bfloat16* t) {
  float acc = 0.f;
#pragma unroll 8
  for (int d = 0; d < DP; d += 2) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + d));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(t + d));
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
  }
  return acc;
}

template <bool MM, int DP>
constexpr size_t dx_mma_smem() {
  using S = MmaTile<DP>;
  return sizeof(float) * (2 * (size_t)S::ROWS * DP + S::ROWS
                          + (MM ? 0 : (size_t)(MMA_BM + 2 * S::ROWS) * S::XS))
         + (MM ? sizeof(__nv_bfloat16) * (size_t)(MMA_BM + S::ROWS) * S::BS : 0);
}

template <bool MM, int DP>
constexpr size_t dtab_mma_smem() {
  using S = MmaTile<DP>;
  return sizeof(float) * (2 * (size_t)S::ROWS * (DP + S::XS) + 3 * S::ROWS
                          + (MM ? 0 : (size_t)MMA_VB * S::XS))
         + (MM ? sizeof(__nv_bfloat16) * (size_t)(MMA_VB + S::ROWS) * S::BS : 0);
}

// Pass (a), dx.  Block: rows n0 .. n0 + 127, warp w rows n0 + 16 w .. + 15,
// over every BV-row table tile; dx [N, D] in x's type (xbf: bf16).
template <bool MM, int DP>
__global__ void __launch_bounds__(MMA_THREADS, DP == 64 ? 2 : 1)
ce_dx_mma_kernel(const void* __restrict__ x, int xbf, const float* __restrict__ tab,
                 const float* __restrict__ bias, const int* __restrict__ tgt,
                 const float* __restrict__ dnll, const float* __restrict__ lse,
                 void* __restrict__ dx, int N, int V, int D, int valid_v) {
  using S = MmaTile<DP>;
  constexpr int BV = S::ROWS, XS = S::XS, BS = S::BS, NT = BV / 8, DT = DP / 8;
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;              // [2][BV * D] table tiles as copied
  float* cb = stage + 2 * BV * DP;  // [BV] the tile's bias (mma_col_bias)
  float* xs = cb + BV;              // fp32: [BM][XS] x rows
  float* th = xs + (MM ? 0 : MMA_BM * XS);  // fp32: [BV][XS] the tile's tf32 hi
  float* tl = th + (MM ? 0 : BV * XS);      // fp32: [BV][XS] its tf32 lo
  __nv_bfloat16* xb = reinterpret_cast<__nv_bfloat16*>(tl + (MM ? 0 : BV * XS));  // MM: round(x)
  __nv_bfloat16* tb = xb + (MM ? MMA_BM * BS : 0);  // MM: [BV][BS] round(table)
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gid = lane / 4, t4 = lane % 4, mi = lane / 8;
  const int n0 = blockIdx.x * MMA_BM;
  const int r0 = n0 + 16 * warp + gid, r1 = r0 + 8;
  const int ntiles = (V + BV - 1) / BV;

  // the table tile vt, a contiguous run of rows, into stage[buf] in 16-byte
  // pieces (zeros beyond V)
  auto copy_tile = [&](int vt, int buf) {
    const long long left = (long long)min(BV, V - vt * BV) * D;
    const float* src = tab + (size_t)vt * BV * D;
    float* dst = stage + buf * BV * DP;
    for (int c = threadIdx.x; c < BV * D / 4; c += MMA_THREADS) {
      const int n = (int)max(0LL, min(4LL, left - 4LL * c));
      cp_async16(dst + 4 * c, n > 0 ? src + 4 * c : tab, 4 * n);
    }
    cp_async_commit();
  };
  copy_tile(0, 0);
  // x rows any D: a plain loader
  for (int i = threadIdx.x; i < MMA_BM * DP; i += MMA_THREADS) {
    const int r = i / DP, k = i % DP;
    const float v = (n0 + r < N && k < D) ? ld_x(x, xbf, (size_t)(n0 + r) * D + k) : 0.f;
    if constexpr (MM)
      xb[r * BS + k] = __float2bfloat16(v);
    else
      xs[r * XS + k] = v;
  }
  const int tg[2] = {r0 < N ? tgt[r0] : -1, r1 < N ? tgt[r1] : -1};
  const float ls[2] = {r0 < N ? lse[r0] : INFINITY, r1 < N ? lse[r1] : INFINITY};
  const float dn[2] = {r0 < N ? dnll[r0] : 0.f, r1 < N ? dnll[r1] : 0.f};
  float dacc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dacc[j][e] = 0.f;

  for (int vt = 0; vt < ntiles; ++vt) {
    const int buf = vt & 1, v0 = vt * BV;
    cp_async_wait_all();
    __syncthreads();  // the tile landed for every thread; the previous one is consumed
    const float* st = stage + buf * BV * DP;
    if constexpr (MM) {
      for (int p = threadIdx.x; p < BV * DP / 2; p += MMA_THREADS) {
        const int r = p / (DP / 2), c = 2 * (p % (DP / 2));
        const float a = c < D ? st[r * D + c] : 0.f;
        const float b = c + 1 < D ? st[r * D + c + 1] : 0.f;
        *reinterpret_cast<uint32_t*>(tb + r * BS + c) = pack_bf16(a, b);
      }
    } else {
      for (int p = threadIdx.x; p < BV * DP; p += MMA_THREADS) {
        const int r = p / DP, c = p % DP;
        uint32_t hi, lo;
        tf32_split(c < D ? st[r * D + c] : 0.f, hi, lo);
        th[r * XS + c] = __uint_as_float(hi);
        tl[r * XS + c] = __uint_as_float(lo);
      }
    }
    if (threadIdx.x < BV) cb[threadIdx.x] = mma_col_bias(bias, v0 + threadIdx.x, V, valid_v);
    if (vt + 1 < ntiles) copy_tile(vt + 1, buf ^ 1);
    __syncthreads();

    // logits s[j]: rows r0 / r1, columns v0 + 8 j + 2 t4 (+1)
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    if constexpr (MM) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t xa[4];
        ldmatrix_x4<false>(xa, xb + (16 * warp + lane % 16) * BS + 16 * kk + 8 * (lane / 16));
#pragma unroll
        for (int jp = 0; jp < BV / 16; ++jp) {
          uint32_t b[4];
          ldmatrix_x4<false>(b, tb + (16 * jp + 8 * (mi >> 1) + lane % 8) * BS + 16 * kk
                                    + 8 * (mi & 1));
          mma_bf16_add(s[2 * jp], xa, b[0], b[1]);
          mma_bf16_add(s[2 * jp + 1], xa, b[2], b[3]);
        }
      }
    } else {
      const float* xw = xs + (16 * warp + gid) * XS + t4;
#pragma unroll
      for (int k0 = 0; k0 < DP; k0 += 8) {
        uint32_t ah[4], al[4];
        tf32_split(xw[k0], ah[0], al[0]);
        tf32_split(xw[8 * XS + k0], ah[1], al[1]);
        tf32_split(xw[k0 + 4], ah[2], al[2]);
        tf32_split(xw[8 * XS + k0 + 4], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int o = (8 * j + gid) * XS + k0 + t4;
          float c[4] = {0.f, 0.f, 0.f, 0.f};
          mma_3xtf32(c, ah, al, th[o], th[o + 4], tl[o], tl[o + 4]);
          add_tile(s[j], c);
        }
      }
    }
    // g = (exp(l - lse) - onehot) dnll; with MM, amb marks the elements
    // whose rounding to bf16 the logit's error could flip (near_bf16_tie)
    uint32_t amb = 0;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t4 + (e & 1), h = e >> 1;
        const float p = exp_t(s[j][e] + cb[c] - ls[h]);
        s[j][e] = (p - (v0 + c == tg[h] ? 1.f : 0.f)) * dn[h];
        if constexpr (MM) amb |= (uint32_t)near_bf16_tie<DP>(s[j][e], p * dn[h]) << (4 * j + e);
      }
    if constexpr (MM) {
      // round(g) must be the FMA backward's: each lane recomputes the logits
      // it marked as the FMA forward sums them (bf16_dot_fma) and g from them
      while (amb) {
        const int bit = __ffs(amb) - 1, j = bit >> 2, e = bit & 3, h = e >> 1;
        amb &= amb - 1;
        const int c = 8 * j + 2 * t4 + (e & 1);
        const float l = bf16_dot_fma<DP>(xb + (16 * warp + gid + 8 * h) * BS, tb + c * BS);
        const float p = exp_t(l + cb[c] - (h ? ls[1] : ls[0]));
        const float g = (p - (v0 + c == (h ? tg[1] : tg[0]) ? 1.f : 0.f)) * (h ? dn[1] : dn[0]);
#pragma unroll
        for (int jj = 0; jj < NT; ++jj)
#pragma unroll
          for (int ee = 0; ee < 4; ++ee)
            if (4 * jj + ee == bit) s[jj][ee] = g;
      }
    }
    // dx += g table: depth over the tile's BV vocab rows, summed in a fresh
    // accumulator and added to dacc in fp32 (add_tile)
    if constexpr (MM) {
      // round(g) round(table): g's C fragments are the A fragments
      uint32_t ga[BV / 16][4];
#pragma unroll
      for (int kv = 0; kv < BV / 16; ++kv) pack_c_as_a(s[2 * kv], s[2 * kv + 1], ga[kv]);
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kv = 0; kv < BV / 16; ++kv) {
          uint32_t b[4];
          ldmatrix_x4<true>(b, tb + (16 * kv + 8 * (mi & 1) + lane % 8) * BS + 16 * dp
                                   + 8 * (mi >> 1));
          mma_bf16_16816(c0, ga[kv], b[0], b[1]);
          mma_bf16_16816(c1, ga[kv], b[2], b[3]);
        }
        add_tile(dacc[2 * dp], c0);
        add_tile(dacc[2 * dp + 1], c1);
      }
    } else {
      uint32_t gh[NT][4], gl[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) split_c_as_a(s[j], gh[j], gl[j]);
      const int o = 2 * t4 * XS + gid;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int oj = o + 8 * j * XS + 8 * dt;
          mma_3xtf32(c, gh[j], gl[j], th[oj], th[oj + XS], tl[oj], tl[oj + XS]);
        }
        add_tile(dacc[dt], c);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = e < 2 ? r0 : r1, d = 8 * j + 2 * t4 + (e & 1);
      if (row < N && d < D) {
        const size_t i = (size_t)row * D + d;
        if (xbf)
          static_cast<__nv_bfloat16*>(dx)[i] = __float2bfloat16(dacc[j][e]);
        else
          static_cast<float*>(dx)[i] = dacc[j][e];
      }
    }
}

// Pass (b), dtable and dbias.  Block (vocab block vb, row split r): vocab
// rows vb * 128 .., warp w rows + 16 w .. + 15, over the NC-row chunks r, r
// + R, ...; writes its rows' dtable and dbias into partial[r] ([V * D + V]).
template <bool MM, int DP>
__global__ void __launch_bounds__(MMA_THREADS, DP == 64 ? 2 : 1)
ce_dtab_mma_kernel(const void* __restrict__ x, int xbf, const float* __restrict__ tab,
                   const float* __restrict__ bias, const int* __restrict__ tgt,
                   const float* __restrict__ dnll, const float* __restrict__ lse,
                   float* __restrict__ partial, int N, int V, int D, int valid_v, int R) {
  using S = MmaTile<DP>;
  constexpr int NC = S::ROWS, XS = S::XS, BS = S::BS, NT = NC / 8, DT = DP / 8;
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;                           // [2][NC * D] x chunks as copied, x's type
  float* xh = stage + 2 * NC * DP;               // [NC][XS] the chunk's x (fp32 x: tf32 hi)
  float* xl = xh + NC * XS;                      // [NC][XS] fp32 x's tf32 lo
  float* rl = xl + NC * XS;                      // [NC] lse of the chunk's rows
  float* rd = rl + NC;                           // [NC] dnll
  int* rt = reinterpret_cast<int*>(rd + NC);     // [NC] targets
  float* ts = reinterpret_cast<float*>(rt + NC); // fp32: [VB][XS] the block's table rows
  __nv_bfloat16* tb = reinterpret_cast<__nv_bfloat16*>(ts + (MM ? 0 : MMA_VB * XS));  // MM
  __nv_bfloat16* xb = tb + (MM ? MMA_VB * BS : 0);  // MM: [NC][BS] round(x)
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gid = lane / 4, t4 = lane % 4, mi = lane / 8;
  const int vb0 = blockIdx.x * MMA_VB, r = blockIdx.y;
  const int vr[2] = {vb0 + 16 * warp + gid, vb0 + 16 * warp + gid + 8};
  const bool split_x = !xbf;  // a bf16 x is exact in TF32

  for (int i = threadIdx.x; i < MMA_VB * DP; i += MMA_THREADS) {
    const int rr = i / DP, k = i % DP, v = vb0 + rr;
    const float t = (v < V && k < D) ? __ldg(tab + (size_t)v * D + k) : 0.f;
    if constexpr (MM)
      tb[rr * BS + k] = __float2bfloat16(t);
    else
      ts[rr * XS + k] = t;
  }
  const float cb[2] = {mma_col_bias(bias, vr[0], V, valid_v),
                       mma_col_bias(bias, vr[1], V, valid_v)};
  float tacc[DT][4], bsum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) tacc[j][e] = 0.f;

  // the row chunk ch, a contiguous run of x's rows, into stage[buf] in
  // 16-byte pieces (zeros beyond N)
  const int es = xbf ? 2 : 4;
  auto copy_chunk = [&](int ch, int buf) {
    const long long left = (long long)min(NC, N - ch * NC) * D * es;
    const char* src = static_cast<const char*>(x) + (size_t)ch * NC * D * es;
    char* dst = reinterpret_cast<char*>(stage + buf * NC * DP);
    for (int c = threadIdx.x; c < NC * D * es / 16; c += MMA_THREADS) {
      const int n = (int)max(0LL, min(16LL, left - 16LL * c));
      cp_async16(dst + 16 * c, n > 0 ? src + 16 * c : x, n);
    }
    cp_async_commit();
  };
  const int nchunks = (N + NC - 1) / NC;
  if (r < nchunks) copy_chunk(r, 0);
  for (int ch = r, buf = 0; ch < nchunks; ch += R, buf ^= 1) {
    const int c0 = ch * NC;
    cp_async_wait_all();
    __syncthreads();  // the chunk landed for every thread; the previous one is consumed
    const float* sf = stage + buf * NC * DP;
    const __nv_bfloat16* sb = reinterpret_cast<const __nv_bfloat16*>(sf);
    for (int p = threadIdx.x; p < NC * DP; p += MMA_THREADS) {
      const int rr = p / DP, d = p % DP;
      const float v = d < D ? (xbf ? __bfloat162float(sb[rr * D + d]) : sf[rr * D + d]) : 0.f;
      if constexpr (MM) xb[rr * BS + d] = __float2bfloat16(v);
      uint32_t hi, lo;
      tf32_split(v, hi, lo);
      xh[rr * XS + d] = __uint_as_float(hi);
      xl[rr * XS + d] = __uint_as_float(lo);
    }
    if (threadIdx.x < NC) {
      const int n = c0 + threadIdx.x;
      const bool in = n < N;
      rl[threadIdx.x] = in ? lse[n] : INFINITY;
      rd[threadIdx.x] = in ? dnll[n] : 0.f;
      rt[threadIdx.x] = in ? tgt[n] : -1;
    }
    if (ch + R < nchunks) copy_chunk(ch + R, buf ^ 1);
    __syncthreads();

    // the logits transposed, s[j]: vocab rows vr[0] / vr[1], chunk rows
    // 8 j + 2 t4 (+1)
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    if constexpr (MM) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t ta[4];
        ldmatrix_x4<false>(ta, tb + (16 * warp + lane % 16) * BS + 16 * kk + 8 * (lane / 16));
#pragma unroll
        for (int jp = 0; jp < NC / 16; ++jp) {
          uint32_t b[4];
          ldmatrix_x4<false>(b, xb + (16 * jp + 8 * (mi >> 1) + lane % 8) * BS + 16 * kk
                                    + 8 * (mi & 1));
          mma_bf16_add(s[2 * jp], ta, b[0], b[1]);
          mma_bf16_add(s[2 * jp + 1], ta, b[2], b[3]);
        }
      }
    } else {
      const float* tw = ts + (16 * warp + gid) * XS + t4;
#pragma unroll
      for (int k0 = 0; k0 < DP; k0 += 8) {
        uint32_t ah[4], al[4];
        tf32_split(tw[k0], ah[0], al[0]);
        tf32_split(tw[8 * XS + k0], ah[1], al[1]);
        tf32_split(tw[k0 + 4], ah[2], al[2]);
        tf32_split(tw[8 * XS + k0 + 4], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int o = (8 * j + gid) * XS + k0 + t4;
          float c[4] = {0.f, 0.f, 0.f, 0.f};
          mma_3xtf32(c, ah, al, xh[o], xh[o + 4], xl[o], xl[o + 4], split_x);
          add_tile(s[j], c);
        }
      }
    }
    // g = (exp(l - lse) - onehot) dnll, unrounded; dbias sums it
    uint32_t gh[NT][4], gl[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 8 * j + 2 * t4 + (e & 1), h = e >> 1;
        const float p = exp_t(s[j][e] + cb[h] - rl[n]);
        s[j][e] = (p - (rt[n] == vr[h] ? 1.f : 0.f)) * rd[n];
        bsum[h] += s[j][e];
      }
      split_c_as_a(s[j], gh[j], gl[j]);
    }
    // dtable += g^T x over the chunk's rows, g split in TF32 (x too when
    // fp32), summed in a fresh accumulator and added to tacc in fp32
    const int o = 2 * t4 * XS + gid;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int oj = o + 8 * j * XS + 8 * dt;
        mma_3xtf32(c, gh[j], gl[j], xh[oj], xh[oj + XS], xl[oj], xl[oj + XS], split_x);
      }
      add_tile(tacc[dt], c);
    }
  }
  float* part = partial + (size_t)r * ((size_t)V * D + V);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    bsum[h] += __shfl_xor_sync(0xffffffffu, bsum[h], 1);
    bsum[h] += __shfl_xor_sync(0xffffffffu, bsum[h], 2);
    if (t4 == 0 && vr[h] < V) part[(size_t)V * D + vr[h]] = bsum[h];
  }
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int v = vr[e >> 1], d = 8 * j + 2 * t4 + (e & 1);
      if (v < V && d < D) part[(size_t)v * D + d] = tacc[j][e];
    }
}

// The row splits R of pass (b): the R (at most one per row chunk) whose
// vocab blocks x R blocks take the fewest waves of the card per split, so
// that the last wave is as full as it can be; negative: a CUDA error.
template <bool MM, int DP>
int ce_mma_splits(int N, int V, int device) {
  const size_t sm = dtab_mma_smem<MM, DP>();
  cudaError_t e = ce_set_smem(ce_dtab_mma_kernel<MM, DP>, sm);
  int per_sm = 0, sms = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ce_dtab_mma_kernel<MM, DP>,
                                                      MMA_THREADS, sm);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return -(int)e;
  // the fewest waves of blocks per split, up to four waves
  const int vblocks = (V + MMA_VB - 1) / MMA_VB, slots = max(1, per_sm * sms);
  const int chunks = (N + MmaTile<DP>::ROWS - 1) / MmaTile<DP>::ROWS;
  int best = 1;
  for (int R = 2; R <= min(chunks, 4 * slots / vblocks); ++R)
    if ((long long)((vblocks * R + slots - 1) / slots) * best
        < (long long)((vblocks * best + slots - 1) / slots) * R)
      best = R;
  return best;
}

// f(MM, DP) for mm_bf16 and mma_dp(D), each as a std::integral_constant.
template <typename F>
auto mma_dispatch(int mm_bf16, int D, F f) {
  using B1 = std::true_type;
  using B0 = std::false_type;
  const int dp = mma_dp(D);
  if (mm_bf16)
    return dp == 64    ? f(B1{}, std::integral_constant<int, 64>{})
           : dp == 128 ? f(B1{}, std::integral_constant<int, 128>{})
                       : f(B1{}, std::integral_constant<int, 256>{});
  return dp == 64    ? f(B0{}, std::integral_constant<int, 64>{})
         : dp == 128 ? f(B0{}, std::integral_constant<int, 128>{})
                     : f(B0{}, std::integral_constant<int, 256>{});
}

template <bool MM, int DP>
cudaError_t ce_bwd_mma(const void* x, int xbf, const float* tab, const float* bias,
                       const int* tgt, const float* dnll, const float* lse, void* dx, int R,
                       float* partial, float* grads, int N, int V, int D, int valid_v,
                       cudaStream_t stream) {
  cudaError_t e;
  const size_t s1 = dx_mma_smem<MM, DP>();
  if ((e = ce_set_smem(ce_dx_mma_kernel<MM, DP>, s1)) != cudaSuccess) return e;
  ce_dx_mma_kernel<MM, DP><<<(N + MMA_BM - 1) / MMA_BM, MMA_THREADS, s1, stream>>>(
      x, xbf, tab, bias, tgt, dnll, lse, dx, N, V, D, valid_v);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const size_t s2 = dtab_mma_smem<MM, DP>();
  if ((e = ce_set_smem(ce_dtab_mma_kernel<MM, DP>, s2)) != cudaSuccess) return e;
  ce_dtab_mma_kernel<MM, DP><<<dim3((V + MMA_VB - 1) / MMA_VB, R), MMA_THREADS, s2, stream>>>(
      x, xbf, tab, bias, tgt, dnll, lse, partial, N, V, D, valid_v, R);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const size_t P = (size_t)V * D + V;
  ce_reduce_kernel<<<(unsigned)((P + 255) / 256), 256, 0, stream>>>(partial, R, P, grads);
  return cudaGetLastError();
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

// D <= MMA_MAX_D takes the tensor-core kernels (mm_bf16: bf16 products;
// else 3xTF32), a wider D the fp32 FMA kernels with 16 x 16 tiles.
template <typename Tin>
cudaError_t ce_bwd_any(const Tin* x, const float* tab, const float* bias, const int* tgt,
                       const float* dnll, const float* lse, Tin* dx, int R, float* partial,
                       float* grads, int N, int V, int D, int valid_v, int mm_bf16,
                       cudaStream_t s) {
  if (D <= MMA_MAX_D) {
    // the table tiles and x's row chunks are copied in 16-byte pieces
    if (reinterpret_cast<uintptr_t>(tab) % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)
      return cudaErrorInvalidValue;
    const int xbf = std::is_same<Tin, __nv_bfloat16>::value;
    return mma_dispatch(mm_bf16, D, [&](auto mm, auto dp) {
      return ce_bwd_mma<decltype(mm)::value, decltype(dp)::value>(
          x, xbf, tab, bias, tgt, dnll, lse, dx, R, partial, grads, N, V, D, valid_v, s);
    });
  }
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

// The row splits R that recblr_ce_bwd takes for these sizes on the card:
// its dtable pass runs R blocks over each vocab block (negative: a CUDA
// error).
int recblr_ce_bwd_splits(int N, int V, int D, int mm_bf16, int device) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return -(int)e;
  if (D <= MMA_MAX_D)
    return mma_dispatch(mm_bf16, D, [&](auto mm, auto dp) {
      return ce_mma_splits<decltype(mm)::value, decltype(dp)::value>(N, V, device);
    });
  // the FMA kernels: about four blocks per SM over the 16-column vocab
  // tiles, at most one split per 16-row block
  int sms = 0;
  const cudaError_t e2 = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e2 != cudaSuccess) return -(int)e2;
  const int tiles = (V + 15) / 16;
  return max(1, min((N + 15) / 16, (4 * sms + tiles - 1) / tiles));
}

// x, dx: [N, D] fp32 (bf16 == 0) or bf16; table, bias, tgt, valid_v,
// mm_bf16: the forward's; dnll: [N] fp32; lse: [N] fp32 kept by the
// forward; R: recblr_ce_bwd_splits; partial: [R, V * D + V] fp32 scratch;
// grads: [V * D + V] fp32 out, dtable [V, D] then dbias [V].  D <= 256
// needs a 16-byte aligned x and table.
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
