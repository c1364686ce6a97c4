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
// the logits are 2NVD = 21.6 GFLOP per pass against 84 MB of table, and
// N = 512 rows make only 8 row blocks of 64, so a row-parallel grid would
// fill 8 of the 132 SMs; the grid splits the vocab instead.
//
// The forward at D <= 128 (cce_fwd_mma_kernel) runs its logits on the
// tensor cores in both precisions through ce_mma.cuh's ce_fwd_mma_tiles
// (bf16 products with mm_bf16, the XLong path; else 3xTF32, longodd's fp32
// step), each k-tile in a fresh accumulator: block (128 rows, vocab split)
// over its split's MmaTile<DP>::ROWS-row table tiles, each copied a tile
// ahead by cp.async and converted once; an online (max, sum of exp) a lane,
// the four lanes of a row merged in a fixed butterfly, the split's partial
// written to part; cce_lse_kernel merges the splits in a fixed order, adds
// the target logit (x unrounded, the chunked path's own rounding point)
// and writes nll and lse.  N = 512 makes 4 row blocks, so the vocab splits
// fill the card.  The bound is one logit-sized product, bf16 or 3xTF32, or
// the table's bytes: 0.026 ms (bytes) at XLong in bf16, 0.131 at longodd's
// fp32.  The forward at D > 128 keeps the fp32 FMA kernel below.
//
// The backward without mm_bf16 or at D > 128, and the forward at D > 128,
// compute the products as fp32 FMA on the CUDA cores (ce_common.cuh's
// 16 x 16 thread tiles), bound by fp32 operations:
//   fwd     block (row block, vocab split) keeps an online logsumexp per
//           row over its split's table tiles and writes (max, sum);
//           cce_lse_kernel merges the splits as above.
//   dx      the same grid: g of its tiles and dx += g table in registers,
//           written to the split's own [N, D] slice; cce_dx_reduce_kernel
//           sums the slices in order and subtracts dnll table[t].
//   dtable  one block per 64-column vocab tile over all rows
//           (ce_common.cuh ce_dtab_kernel with one row split): the only
//           writer of its columns, so dtable and dbias need no atomics.
//
// The backward with mm_bf16 at D <= 128 (XLong's training path) runs the
// products on the tensor cores through mma.sync (mma_tile.cuh), which
// leaves the 2 x 2NVD bf16 products and the 2 x 2NVD TF32 ones of the
// split below, some 0.13 ms at the card's peaks, and the exp of each of
// the 2NV logits (one per pass) on the special-function units:
//   (a) cce_dx_mma_kernel, block (128 rows, vocab split): each warp holds
//       its 16 rows of round(x) as bf16 A fragments in registers for the
//       whole split; each 64-row table tile is copied to shared memory by
//       cp.async one tile ahead, rounded to bf16 once there, and feeds
//       both products through ldmatrix: the logits (m16n8k16, bf16
//       operands, fp32 sums), g = exp(l - lse) dnll in registers, g
//       rounded to bf16 as the next product's A fragment, and dx += g
//       round(table).  cce_dx_reduce_kernel then sums the splits in order.
//   (b) cce_dtab_mma_kernel, one block per 128 vocab rows over all rows in
//       chunks of 64: each warp holds its 16 table rows rounded to bf16 as
//       A fragments, recomputes the logits transposed (vocab x rows) from
//       x staged in shared memory, forms g with its one-hot term, sums
//       dbias from the unrounded g on the CUDA cores and adds g^T x on the
//       tensor cores in TF32 with g split in two terms, hi = tf32(g) and
//       lo = tf32(g - hi): dtable += hi x + lo x.  A bf16 x is exact in
//       TF32; an fp32 x is split too (hi hi + hi lo + lo hi).  The split
//       keeps the plain version's rounding point, g and x unrounded: what
//       it leaves out is below 2^-21 of |g| |x| a term, against the 1e-4
//       of the largest value the card tests allow.
// Every sum runs in a fixed order (the mma accumulation order within a
// block, the dx splits in order, one writer per dtable and dbias column,
// dbias's four lanes in a fixed butterfly): the same bits from run to
// run.  Left for later PRs: the fp32 backward (mm_bf16 off) as 3xTF32, and
// D > 128 on the tensor cores.
//
// C interface (loaded with ctypes): returns a cudaError_t, 0 on success.
#include <cstdint>
#include <type_traits>

#include "ce_common.cuh"
#include "ce_mma.cuh"
#include "mma_tile.cuh"

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

// ---------------------------------------------------------------------------
// the tensor-core backward (mm_bf16, D <= 128)
// ---------------------------------------------------------------------------

constexpr int MMA_WARPS = 8;
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int MMA_BM = 16 * MMA_WARPS;  // rows of a pass (a) block, 16 a warp
constexpr int MMA_BV = 64;              // vocab rows of a pass (a) table tile
constexpr int MMA_VB = 16 * MMA_WARPS;  // vocab rows of a pass (b) block, 16 a warp
constexpr int MMA_NC = 64;              // rows of a pass (b) chunk
constexpr int MMA_MAX_D = 128;

// D padded to KS k-steps of 16 (KS = 1, 2, 4 or 8), zeros beyond D.  Tiles
// of bf16 rows take a stride of DP + 8 (16 bytes apart plus 16: the 8 rows
// of an ldmatrix matrix hit 8 distinct 16-byte bank groups), fp32 rows
// DP + 4 (the TF32 B loads of lanes t = 0..3 start 8 banks apart).
inline int mma_ks(int D) { return D <= 16 ? 1 : D <= 32 ? 2 : D <= 64 ? 4 : 8; }

// Pass (a).  Block (row block rb, vocab split sp): rows rb * 128 .. over the
// 64-row table tiles sp * tps .. (sp + 1) * tps - 1; writes its dx partial
// g round(table) (no one-hot term) to dxp[sp] ([S, N, D] fp32).
template <typename Tin, int KS>
__global__ void __launch_bounds__(MMA_THREADS)
cce_dx_mma_kernel(const Tin* __restrict__ x, const float* __restrict__ tab,
                  const float* __restrict__ bias, const float* __restrict__ dnll,
                  const float* __restrict__ lse, float* __restrict__ dxp, int N, int V, int D,
                  int valid_v, int tps) {
  constexpr int DP = 16 * KS, TS = DP + 8;
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;  // [2][MMA_BV * D] fp32 table tiles as copied
  __nv_bfloat16* tb = reinterpret_cast<__nv_bfloat16*>(stage + 2 * MMA_BV * D);  // [BV][TS]
  float* cb = reinterpret_cast<float*>(tb + MMA_BV * TS);  // [BV] bias, or the mask
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gid = lane / 4, t4 = lane % 4, mi = lane / 8;
  const int r0 = blockIdx.x * MMA_BM + 16 * warp + gid, r1 = r0 + 8;
  const int sp = blockIdx.y;
  const int ntiles = (V + MMA_BV - 1) / MMA_BV;
  const int vt0 = sp * tps, vt_end = min(ntiles, vt0 + tps);

  // the warp's 16 rows of round(x), as A fragments for the whole split
  auto xv = [&](int r, int d) {
    return (r < N && d < D) ? load_act(x, (size_t)r * D + d) : 0.f;
  };
  uint32_t xa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int d = 16 * kk + 2 * t4;
    xa[kk][0] = pack_bf16(xv(r0, d), xv(r0, d + 1));
    xa[kk][1] = pack_bf16(xv(r1, d), xv(r1, d + 1));
    xa[kk][2] = pack_bf16(xv(r0, d + 8), xv(r0, d + 9));
    xa[kk][3] = pack_bf16(xv(r1, d + 8), xv(r1, d + 9));
  }
  const float ls[2] = {r0 < N ? lse[r0] : INFINITY, r1 < N ? lse[r1] : INFINITY};
  const float dn[2] = {r0 < N ? dnll[r0] : 0.f, r1 < N ? dnll[r1] : 0.f};
  float dacc[2 * KS][4];
#pragma unroll
  for (int j = 0; j < 2 * KS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dacc[j][e] = 0.f;

  // the table tile vt, a contiguous run of rows, into stage[buf] in
  // 16-byte pieces (zeros beyond V)
  auto copy_tile = [&](int vt, int buf) {
    const long long left = (long long)min(MMA_BV, V - vt * MMA_BV) * D;
    const float* src = tab + (size_t)vt * MMA_BV * D;
    float* dst = stage + buf * MMA_BV * D;
    for (int c = threadIdx.x; c < MMA_BV * D / 4; c += MMA_THREADS) {
      const int n = (int)max(0LL, min(4LL, left - 4LL * c));
      cp_async16(dst + 4 * c, n > 0 ? src + 4 * c : tab, 4 * n);
    }
    cp_async_commit();
  };
  if (vt0 < vt_end) copy_tile(vt0, 0);
  for (int vt = vt0; vt < vt_end; ++vt) {
    const int buf = (vt - vt0) & 1, v0 = vt * MMA_BV;
    cp_async_wait_all();
    __syncthreads();  // the tile landed for every thread; the previous one is consumed
    const float* st = stage + buf * MMA_BV * D;
    for (int p = threadIdx.x; p < MMA_BV * DP / 2; p += MMA_THREADS) {
      const int r = p / (DP / 2), c = 2 * (p % (DP / 2));
      const float a = c < D ? st[r * D + c] : 0.f;
      const float b = c + 1 < D ? st[r * D + c + 1] : 0.f;
      *reinterpret_cast<uint32_t*>(tb + r * TS + c) = pack_bf16(a, b);
    }
    if (threadIdx.x < MMA_BV) {
      const int col = v0 + threadIdx.x;
      cb[threadIdx.x] = col < valid_v ? __ldg(bias + col) : (col < V ? CE_NEG : -INFINITY);
    }
    if (vt + 1 < vt_end) copy_tile(vt + 1, buf ^ 1);
    __syncthreads();

    // logits s[j]: rows r0 / r1, columns v0 + 8 j + 2 t4 (+1)
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t b[4];
        ldmatrix_x4<false>(b, tb + (16 * jp + 8 * (mi >> 1) + lane % 8) * TS + 16 * kk
                                  + 8 * (mi & 1));
        mma_bf16_16816(s[2 * jp], xa[kk], b[0], b[1]);
        mma_bf16_16816(s[2 * jp + 1], xa[kk], b[2], b[3]);
      }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = exp_t(s[j][e] + cb[8 * j + 2 * t4 + (e & 1)] - ls[e >> 1]) * dn[e >> 1];
    // dx += round(g) round(table): depth over the tile's 64 vocab rows
#pragma unroll
    for (int kv = 0; kv < 4; ++kv) {
      uint32_t ga[4];
      pack_c_as_a(s[2 * kv], s[2 * kv + 1], ga);
#pragma unroll
      for (int dp = 0; dp < KS; ++dp) {
        uint32_t b[4];
        ldmatrix_x4<true>(b, tb + (16 * kv + 8 * (mi & 1) + lane % 8) * TS + 16 * dp
                                 + 8 * (mi >> 1));
        mma_bf16_16816(dacc[2 * dp], ga, b[0], b[1]);
        mma_bf16_16816(dacc[2 * dp + 1], ga, b[2], b[3]);
      }
    }
  }
  float* out = dxp + (size_t)sp * N * D;
#pragma unroll
  for (int j = 0; j < 2 * KS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = e < 2 ? r0 : r1, d = 8 * j + 2 * t4 + (e & 1);
      if (row < N && d < D) out[(size_t)row * D + d] = dacc[j][e];
    }
}

// Pass (b).  Block vb: vocab rows vb * 128 .. over all N rows in chunks of
// MMA_NC; the only writer of their dtable rows and dbias entries
// (grads: [V * D + V]).
template <typename Tin, int KS>
__global__ void __launch_bounds__(MMA_THREADS)
cce_dtab_mma_kernel(const Tin* __restrict__ x, const float* __restrict__ tab,
                    const float* __restrict__ bias, const int* __restrict__ tgt,
                    const float* __restrict__ dnll, const float* __restrict__ lse,
                    float* __restrict__ grads, int N, int V, int D, int valid_v) {
  constexpr int DP = 16 * KS, TS = DP + 8, XS = DP + 4;
  constexpr bool SPLIT_X = !std::is_same<Tin, __nv_bfloat16>::value;
  extern __shared__ __align__(16) float smem[];
  float* xh = smem;                                     // [NC][XS] x (fp32 x: tf32 hi)
  float* xl = xh + MMA_NC * XS;                         // [NC][XS] fp32 x's tf32 lo
  float* rl = xl + (SPLIT_X ? MMA_NC * XS : 0);         // [NC] lse of the chunk's rows
  float* rd = rl + MMA_NC;                              // [NC] dnll
  int* rt = reinterpret_cast<int*>(rd + MMA_NC);        // [NC] targets
  __nv_bfloat16* xb = reinterpret_cast<__nv_bfloat16*>(rt + MMA_NC);  // [NC][TS] round(x)
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gid = lane / 4, t4 = lane % 4, mi = lane / 8;
  const int va = blockIdx.x * MMA_VB + 16 * warp + gid, vb = va + 8;

  // the warp's 16 table rows rounded to bf16, as A fragments
  auto tv = [&](int v, int d) {
    return (v < V && d < D) ? __ldg(tab + (size_t)v * D + d) : 0.f;
  };
  uint32_t ta[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int d = 16 * kk + 2 * t4;
    ta[kk][0] = pack_bf16(tv(va, d), tv(va, d + 1));
    ta[kk][1] = pack_bf16(tv(vb, d), tv(vb, d + 1));
    ta[kk][2] = pack_bf16(tv(va, d + 8), tv(va, d + 9));
    ta[kk][3] = pack_bf16(tv(vb, d + 8), tv(vb, d + 9));
  }
  const int vr[2] = {va, vb};
  float cb[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    cb[h] = vr[h] < valid_v ? __ldg(bias + vr[h]) : (vr[h] < V ? CE_NEG : -INFINITY);
  float tacc[2 * KS][4], bsum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 2 * KS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) tacc[j][e] = 0.f;

  for (int c0 = 0; c0 < N; c0 += MMA_NC) {
    __syncthreads();  // the previous chunk is consumed
    for (int p = threadIdx.x; p < MMA_NC * DP; p += MMA_THREADS) {
      const int r = p / DP, d = p % DP, n = c0 + r;
      const float v = (n < N && d < D) ? load_act(x, (size_t)n * D + d) : 0.f;
      xb[r * TS + d] = __float2bfloat16(v);
      if (SPLIT_X) {
        uint32_t hi, lo;
        tf32_split(v, hi, lo);
        xh[r * XS + d] = __uint_as_float(hi);
        xl[r * XS + d] = __uint_as_float(lo);
      } else {
        xh[r * XS + d] = v;  // bf16: exact in TF32
      }
    }
    if (threadIdx.x < MMA_NC) {
      const int n = c0 + threadIdx.x;
      const bool in = n < N;
      rl[threadIdx.x] = in ? lse[n] : INFINITY;
      rd[threadIdx.x] = in ? dnll[n] : 0.f;
      rt[threadIdx.x] = in ? tgt[n] : -1;
    }
    __syncthreads();

    // the chunk in two halves of 32 rows (fewer live registers): the
    // logits transposed, s[j]: vocab rows va / vb, chunk rows 32 hf + 8 j +
    // 2 t4 (+1)
#pragma unroll 1
    for (int hf = 0; hf < 2; ++hf) {
      float s[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t b[4];
          ldmatrix_x4<false>(b, xb + (32 * hf + 16 * jp + 8 * (mi >> 1) + lane % 8) * TS
                                    + 16 * kk + 8 * (mi & 1));
          mma_bf16_16816(s[2 * jp], ta[kk], b[0], b[1]);
          mma_bf16_16816(s[2 * jp + 1], ta[kk], b[2], b[3]);
        }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n0 = 32 * hf + 8 * j;
        // g = (exp(l - lse) - onehot) dnll, unrounded; dbias sums it
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = n0 + 2 * t4 + (e & 1), h = e >> 1;
          const float p = exp_t(s[j][e] + cb[h] - rl[n]);
          s[j][e] = (p - (rt[n] == vr[h] ? 1.f : 0.f)) * rd[n];
          bsum[h] += s[j][e];
        }
        // dtable += g^T x over the tile's 8 rows: depth k = t4 is row
        // 2 t4, k = t4 + 4 row 2 t4 + 1 (A and B take the same order)
        uint32_t hi[4], lo[4];
        tf32_split(s[j][0], hi[0], lo[0]);
        tf32_split(s[j][2], hi[1], lo[1]);
        tf32_split(s[j][1], hi[2], lo[2]);
        tf32_split(s[j][3], hi[3], lo[3]);
        const int x0 = (n0 + 2 * t4) * XS + gid, x1 = x0 + XS;
#pragma unroll
        for (int dt = 0; dt < 2 * KS; ++dt) {
          const uint32_t b0 = __float_as_uint(xh[x0 + 8 * dt]);
          const uint32_t b1 = __float_as_uint(xh[x1 + 8 * dt]);
          mma_tf32_1688(tacc[dt], hi, b0, b1);
          mma_tf32_1688(tacc[dt], lo, b0, b1);
          if (SPLIT_X)
            mma_tf32_1688(tacc[dt], hi, __float_as_uint(xl[x0 + 8 * dt]),
                          __float_as_uint(xl[x1 + 8 * dt]));
        }
      }
    }
  }
  float* dtab = grads;
  float* dbias = grads + (size_t)V * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    bsum[h] += __shfl_xor_sync(0xffffffffu, bsum[h], 1);
    bsum[h] += __shfl_xor_sync(0xffffffffu, bsum[h], 2);
    if (t4 == 0 && vr[h] < V) dbias[vr[h]] = bsum[h];
  }
#pragma unroll
  for (int j = 0; j < 2 * KS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int v = vr[e >> 1], d = 8 * j + 2 * t4 + (e & 1);
      if (v < V && d < D) dtab[(size_t)v * D + d] = tacc[j][e];
    }
}

// The forward on the tensor cores (D <= 128).  Block (row block rb, vocab
// split sp): rows rb * 128 .. over the MmaTile<DP>::ROWS-row table tiles
// sp * tps .. (sp + 1) * tps - 1 (ce_mma.cuh ce_fwd_mma_tiles); writes the
// rows' (max, sum of exp) to part_m, part_s [S, N] for cce_lse_kernel.
template <bool MM, int DP>
__global__ void __launch_bounds__(CE_MMA_THREADS, DP == 64 ? 2 : 1)
cce_fwd_mma_kernel(const void* __restrict__ x, int xbf, const float* __restrict__ tab,
                   const float* __restrict__ bias, float* __restrict__ part_m,
                   float* __restrict__ part_s, int N, int V, int D, int valid_v, int tps) {
  extern __shared__ __align__(16) float smem[];
  const int n0 = blockIdx.x * CE_MMA_BM, sp = blockIdx.y;
  const int r0 = n0 + 16 * (threadIdx.x / 32) + threadIdx.x % 32 / 4;
  const int row[2] = {r0, r0 + 8};
  const int none[2] = {-1, -1};  // the target logit comes with x unrounded, in cce_lse_kernel
  const int ntiles = (V + MmaTile<DP>::ROWS - 1) / MmaTile<DP>::ROWS;
  const int vt0 = sp * tps, vt_end = min(ntiles, vt0 + tps);
  float m[2], s[2], tl[2];
  ce_fwd_mma_tiles<MM, DP>(x, xbf, tab, bias, none, N, V, D, valid_v, n0, vt0, vt_end, smem, m,
                           s, tl);
  ce_quad_merge(m, s, tl);
  if (threadIdx.x % 4 != 0) return;
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (row[h] < N) {
      part_m[(size_t)sp * N + row[h]] = m[h];
      part_s[(size_t)sp * N + row[h]] = s[h];
    }
}

template <typename Tin, bool MM, int DP>
cudaError_t cce_fwd_mma(const Tin* x, const float* tab, const float* bias, const int* tgt,
                        float* part, int S, float* nll, float* lse, int N, int V, int D,
                        int valid_v, cudaStream_t stream) {
  constexpr int BV = MmaTile<DP>::ROWS;
  const int tps = ((V + BV - 1) / BV + S - 1) / S;
  const size_t sm = ce_fwd_mma_smem<MM, DP>();
  cudaError_t e = ce_set_smem(cce_fwd_mma_kernel<MM, DP>, sm);
  if (e != cudaSuccess) return e;
  float* part_m = part;
  float* part_s = part + (size_t)S * N;
  const int xbf = std::is_same<Tin, __nv_bfloat16>::value;
  cce_fwd_mma_kernel<MM, DP><<<dim3((N + CE_MMA_BM - 1) / CE_MMA_BM, S), CE_MMA_THREADS, sm,
                               stream>>>(x, xbf, tab, bias, part_m, part_s, N, V, D, valid_v,
                                         tps);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  cce_lse_kernel<Tin, MM><<<(N + 7) / 8, 256, 0, stream>>>(x, tab, bias, tgt, part_m, part_s, S,
                                                          nll, lse, N, D);
  return cudaGetLastError();
}

template <typename Tin, int KS>
cudaError_t cce_bwd_mma(const Tin* x, const float* tab, const float* bias, const int* tgt,
                        const float* dnll, const float* lse, Tin* dx, float* dxp, int S,
                        float* grads, int N, int V, int D, int valid_v, cudaStream_t stream) {
  constexpr int DP = 16 * KS;
  constexpr bool SPLIT_X = !std::is_same<Tin, __nv_bfloat16>::value;
  const int tps = ((V + MMA_BV - 1) / MMA_BV + S - 1) / S;
  cudaError_t e;
  const size_t s1 = sizeof(float) * (2 * (size_t)MMA_BV * D + MMA_BV)
                    + sizeof(__nv_bfloat16) * MMA_BV * (DP + 8);
  if ((e = ce_set_smem(cce_dx_mma_kernel<Tin, KS>, s1)) != cudaSuccess) return e;
  cce_dx_mma_kernel<Tin, KS><<<dim3((N + MMA_BM - 1) / MMA_BM, S), MMA_THREADS, s1, stream>>>(
      x, tab, bias, dnll, lse, dxp, N, V, D, valid_v, tps);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const size_t P = (size_t)N * D;
  cce_dx_reduce_kernel<Tin, true><<<(unsigned)((P + 255) / 256), 256, 0, stream>>>(
      dxp, S, tab, tgt, dnll, dx, N, D);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const size_t s2 = sizeof(float) * ((SPLIT_X ? 2 : 1) * (size_t)MMA_NC * (DP + 4) + 3 * MMA_NC)
                    + sizeof(__nv_bfloat16) * MMA_NC * (DP + 8);
  if ((e = ce_set_smem(cce_dtab_mma_kernel<Tin, KS>, s2)) != cudaSuccess) return e;
  cce_dtab_mma_kernel<Tin, KS><<<(V + MMA_VB - 1) / MMA_VB, MMA_THREADS, s2, stream>>>(
      x, tab, bias, tgt, dnll, lse, grads, N, V, D, valid_v);
  return cudaGetLastError();
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

// D <= MMA_MAX_D takes the tensor-core kernel in both precisions (mm_bf16:
// bf16 products; else 3xTF32), a wider D the fp32 FMA kernel with 16 x 16
// tiles (RT = 1).
template <typename Tin>
cudaError_t cce_fwd_any(const Tin* x, const float* tab, const float* bias, const int* tgt,
                        float* part, int S, float* nll, float* lse, int N, int V, int D,
                        int valid_v, int mm_bf16, cudaStream_t s) {
  if (D <= MMA_MAX_D) {
    // the table tiles are copied in 16-byte pieces
    if (reinterpret_cast<uintptr_t>(tab) % 16 != 0) return cudaErrorInvalidValue;
    return mma_dispatch<MMA_MAX_D>(mm_bf16, D, [&](auto mm, auto dp) {
      return cce_fwd_mma<Tin, decltype(mm)::value, decltype(dp)::value>(
          x, tab, bias, tgt, part, S, nll, lse, N, V, D, valid_v, s);
    });
  }
  return mm_bf16
             ? cce_fwd<Tin, true, 1>(x, tab, bias, tgt, part, S, nll, lse, N, V, D, valid_v, s)
             : cce_fwd<Tin, false, 1>(x, tab, bias, tgt, part, S, nll, lse, N, V, D, valid_v, s);
}

// mm_bf16 at D <= MMA_MAX_D takes the tensor-core kernels, any other
// combination the fp32 ones.
template <typename Tin>
cudaError_t cce_bwd_any(const Tin* x, const float* tab, const float* bias, const int* tgt,
                        const float* dnll, const float* lse, Tin* dx, float* dxp, int S,
                        float* grads, int N, int V, int D, int valid_v, int mm_bf16,
                        cudaStream_t s) {
  if (mm_bf16 && D <= MMA_MAX_D) {
    // the table tiles are copied in 16-byte pieces
    if (reinterpret_cast<uintptr_t>(tab) % 16 != 0) return cudaErrorInvalidValue;
    switch (mma_ks(D)) {
      case 1:
        return cce_bwd_mma<Tin, 1>(x, tab, bias, tgt, dnll, lse, dx, dxp, S, grads, N, V, D,
                                   valid_v, s);
      case 2:
        return cce_bwd_mma<Tin, 2>(x, tab, bias, tgt, dnll, lse, dx, dxp, S, grads, N, V, D,
                                   valid_v, s);
      case 4:
        return cce_bwd_mma<Tin, 4>(x, tab, bias, tgt, dnll, lse, dx, dxp, S, grads, N, V, D,
                                   valid_v, s);
      default:
        return cce_bwd_mma<Tin, 8>(x, tab, bias, tgt, dnll, lse, dx, dxp, S, grads, N, V, D,
                                   valid_v, s);
    }
  }
  if (mm_bf16)
    return cce_bwd<Tin, true, 1>(x, tab, bias, tgt, dnll, lse, dx, dxp, S, grads, N, V, D,
                                 valid_v, s);
  if (D <= 128)
    return cce_bwd<Tin, false, 4>(x, tab, bias, tgt, dnll, lse, dx, dxp, S, grads, N, V, D,
                                  valid_v, s);
  return cce_bwd<Tin, false, 1>(x, tab, bias, tgt, dnll, lse, dx, dxp, S, grads, N, V, D,
                                valid_v, s);
}

}  // namespace

extern "C" {

// x: [N, D] fp32 (bf16 == 0) or bf16; table: [V, D] and bias: [V] fp32;
// tgt: [N] int32; part: [2, S, N] fp32 scratch for the S vocab splits;
// nll: [N] fp32 out; lse: [N] fp32 out, or null; valid_v: columns at or
// beyond it are masked; mm_bf16: round x and the table to bf16 for the
// logits; device: the card that holds them.  D <= 128 needs a 16-byte
// aligned table.
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
// dtable [V, D] then dbias [V].  mm_bf16 at D <= 128 needs a 16-byte
// aligned table.
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
