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
// The fp32 forward at D <= 256 (ce_fwd_mma_kernel) runs its logits on the
// tensor cores as 3xTF32 through ce_mma.cuh's ce_fwd_mma_tiles: a block per
// 128 rows over every table tile, 16 rows a warp, as pass (a) below minus
// its dx product, each k-tile in a fresh accumulator; an online (max, sum
// of exp) a lane, the four lanes of a row merged in a fixed butterfly; nll
// = lse - l[target] from the same logits, and in training the lse the
// backward reads.  The bound is one logit-sized 3xTF32 product: 0.217 ms at
// the cloze loss.
// The bf16 forward (mm_bf16) at D <= 256 (ce_fwd_wgmma_kernel) runs on
// wgmma and TMA: the table rounded to bf16 once a call into the caller's
// scratch ([V, DP], D padded to DP = 64, 128 or 256 with zeros); persistent
// blocks, one a multiprocessor, each over a contiguous run of 128-row
// units; a producer warp brings each [128, DP] table tile by TMA (DP / 64
// boxes of 64 columns, 128-byte swizzle, a ring of 128 KB at DP <= 128 and
// 192 KB at 256, hinted to stay in L2) with its column biases; two
// consumer warpgroups of 64 rows a unit hold round(x) as wgmma A fragments
// and run DP / 16 m64n128k16 steps a tile, at most 8 into an fp32
// accumulator (WG_KGROUP: at DP 256 two added in fp32, the first point of
// accuracy below), then the online (max, sum of exp) of ce_fwd_mma_tiles on
// the accumulator's fragment layout (a lane's two rows' sums interleaved,
// each in column order; exp2 on the special-function unit alone,
// exp_sfu), the four lanes of a row merged in the same butterfly.  At DP
// 64 a warpgroup holds two units' rows against each tile (16 registers of
// A fragments each), so the table is read from L2 once per 256 rows and
// one unit's exps run while the other's products do.  The two warpgroups
// take turns to issue a tile's products (two
// named barriers), so that one's exps run while the other's products do,
// and the producer's warpgroup gives its registers to theirs
// (setmaxnreg).  The products' bound is one logit-sized bf16 product
// (0.036 ms at the cloze loss, 0.145 at D 256); the N V exps take at least
// 0.067 ms on the special-function units.
// The forward and the backward at D 257-512 compute the products as fp32
// FMA on the CUDA cores (ce_common.cuh's 16 x 16 thread tiles):
//   fwd   a block per 16 rows holds its x rows in shared memory and streams
//         the table in [16, D] tiles; each thread computes one logit a
//         tile and keeps an online logsumexp per row (running max,
//         rescaled sum); the 16 lanes of a row combine theirs with
//         shuffles.
//   dx, dtab as the passes below, one logit a thread.
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
//     (add_tile): 7e-6 and 4e-6, the FMA kernels' order of error.  The
//     wgmma forward sums 8 k16 steps (depth 128) in an accumulator and adds
//     the two in fp32: a numpy model of the truncation puts one
//     accumulator over all 16 steps beyond 1e-5 of JAX's nll at D 256, the
//     two within it (tests/test_torch_fused_ce_fwd_scheme.py); on the card
//     the smoke's nll read 1.5e-5 from the plain version's.
//   - With mm_bf16, round(g) flips where g lies within its logit's error of
//     a bf16 rounding boundary, a flip of up to one bf16 ulp of g times a
//     table row in dx.  The tensor-core logits differ from an fp32 FMA sum
//     by up to ~2e-6 at D 64, which flipped enough entries to put 7 of
//     dx's values out of the smoke's bound at the cloze loss.  Pass (a)
//     therefore recomputes each logit whose g lies that near a boundary
//     (near_bf16_tie, some 0.4% of them at D 64, 1.6% at D 256) as the
//     FMA forward sums it, so round(g) is the FMA backward's.  g also
//     takes the forward's lse, which moves every g of a row by exp(its
//     error); any fp32 sum of the logits (cuBLAS's, the FMA kernel's, the
//     tensor cores') rounds some g of a row the other way, so the card
//     check allows for the ties of g at every D (chip_smoke.py
//     TIE_WINDOW).  At D 64 the FMA forward's lse put 0-5 of the cloze
//     loss's dx values beyond the plain bound on eight inputs, the wgmma
//     forward's 0-21, at D 256 120 and 863, none beyond the allowance
//     (chip_compare.py --ce-seeds; NVIDIA H100 80GB HBM3, 700 W).
// Every sum runs in a fixed order (the mma accumulation order within a
// block, the splits in order, the four lanes of a row and dbias's in a
// fixed butterfly): the same bits from run to run, no atomics.  Left for
// later PRs: D 257-512 on the tensor cores, wgmma in the backward.
//
// C interface (loaded with ctypes): returns a cudaError_t, 0 on success.
#include <cstdint>
#include <type_traits>

#include "ce_common.cuh"
#include "ce_mma.cuh"
#include "mma_tile.cuh"
#include "wgmma.cuh"

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

// Pass (a)'s table tile and pass (b)'s row chunk hold MmaTile<DP>::ROWS
// rows (ce_mma.cuh: D padded to DP = 64, 128 or 256).  The kernels ask for
// two blocks an SM at DP 64 (128 registers a thread), one wider.

// The fp32 forward (D <= 256, 3xTF32).  Block: rows n0 .. n0 + 127, warp w
// rows n0 + 16 w .. + 15, over every table tile (ce_mma.cuh
// ce_fwd_mma_tiles); nll, lse: [N] fp32 (lse may be null).
template <int DP>
__global__ void __launch_bounds__(CE_MMA_THREADS, DP == 64 ? 2 : 1)
ce_fwd_mma_kernel(const void* __restrict__ x, int xbf, const float* __restrict__ tab,
                  const float* __restrict__ bias, const int* __restrict__ tgt,
                  float* __restrict__ nll, float* __restrict__ lse_out, int N, int V, int D,
                  int valid_v) {
  extern __shared__ __align__(16) float smem[];
  const int n0 = blockIdx.x * CE_MMA_BM;
  const int r0 = n0 + 16 * (threadIdx.x / 32) + threadIdx.x % 32 / 4;
  const int row[2] = {r0, r0 + 8};
  const int tg[2] = {r0 < N ? tgt[r0] : -1, r0 + 8 < N ? tgt[r0 + 8] : -1};
  float m[2], s[2], tl[2];
  const int ntiles = (V + MmaTile<DP>::ROWS - 1) / MmaTile<DP>::ROWS;
  ce_fwd_mma_tiles<false, DP>(x, xbf, tab, bias, tg, N, V, D, valid_v, n0, 0, ntiles, smem, m, s,
                              tl);
  ce_quad_merge(m, s, tl);
  if (threadIdx.x % 4 != 0) return;
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (row[h] < N) {
      const float L = m[h] + logf(s[h]);
      nll[row[h]] = L - tl[h];
      if (lse_out != nullptr) lse_out[row[h]] = L;
    }
}

// ---------------------------------------------------------------------------
// the bf16 forward (D <= 256) on wgmma and TMA
// ---------------------------------------------------------------------------

constexpr int WG_BV = 128;                       // table rows a tile: the products' N
constexpr int WG_CONS = 2;                       // consumer warpgroups
constexpr int WG_UNIT = 64 * WG_CONS;            // rows of a unit of work, 64 a consumer
constexpr int WG_BOX = 64;                       // bf16 columns of a 128-byte box
constexpr int WG_THREADS = 128 * (WG_CONS + 1);  // and a producer warpgroup
// registers a thread: the producer warpgroup gives back what the two
// consumers take (168 each at launch, 65,536 / 384 threads)
constexpr int WG_PRODUCER_REGS = 40, WG_CONSUMER_REGS = 232;
constexpr int WG_KGROUP = 8;  // k16 steps an fp32 accumulator at most (the header's first
                              // point of accuracy)

// The tiling at D padded to DP (64, 128 or 256, zeros beyond D): a table
// tile is [128 rows, DP] bf16 in DP / 64 boxes, STAGES of them in flight
// (128 KB at DP 64 and 128, 192 KB at 256); a consumer warpgroup holds RG
// groups of 64 rows against each tile: two at DP 64, where one group's A
// fragments take 16 registers, else one (64 registers at DP 256).  DP 256
// sums its 16 k16 steps in two accumulators of 8, DP 128 and 64 theirs in
// one.
template <int DP>
struct WgTile {
  static constexpr int KSTEPS = DP / 16;
  static constexpr int KGROUP = KSTEPS < WG_KGROUP ? KSTEPS : WG_KGROUP;
  static constexpr int RG = DP == 64 ? 2 : 1;
  static constexpr int STAGES = DP == 256 ? 3 : 8 * 64 / DP;
  static constexpr uint32_t BOX_BYTES = WG_BV * WG_BOX * 2;      // 16 KB
  static constexpr uint32_t TILE_BYTES = WG_BV * DP * 2;
  static constexpr uint32_t BIAS0 = STAGES * TILE_BYTES;         // [stage][128] column biases
  static constexpr uint32_t BAR0 = BIAS0 + STAGES * WG_BV * 4;
  static constexpr size_t SMEM = 1024 + BAR0 + 8 * 2 * STAGES;  // 1 KB of alignment slack
  static_assert(KSTEPS <= 2 * KGROUP && (KSTEPS == KGROUP || RG == 1), "accumulators");
};

// exp_t's exp2(x log2 e) on the special-function unit alone (ex2.approx.ftz,
// without exp2f's steps around it for a subnormal result): exp_t's value
// wherever that is a normal number, 0 where it would be below 2^-126, which
// no row's sum of exps (at least 1, the max's) keeps.
__device__ __forceinline__ float exp_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * LOG2E));
  return y;
}

// The table rounded to bf16 (nearest even) into [V, DP] with zeros beyond
// D, two columns a thread.
template <int DP>
__global__ void ce_round_table_kernel(const float* __restrict__ tab, uint32_t* __restrict__ out,
                                      int V, int D) {
  const long long n = (long long)V * (DP / 2);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int v = static_cast<int>(i / (DP / 2)), c = 2 * static_cast<int>(i % (DP / 2));
    const float* row = tab + (size_t)v * D;
    out[i] = pack_bf16(c < D ? __ldg(row + c) : 0.f, c + 1 < D ? __ldg(row + c + 1) : 0.f);
  }
}

// The bf16 forward (mm_bf16) at D <= 256.  The rows are cut into units of
// 128; block b takes the units b U / grid .. (b + 1) U / grid - 1 (U units,
// a persistent block a multiprocessor) and walks them RG at a time, a
// round, each round over every table tile.  Warp 8, the producer (the
// first of warpgroup 2, which gives its registers to the consumers),
// brings the rounded table's tiles ([128 rows, DP] bf16 in 64-column boxes,
// the 128-byte swizzle) by TMA into a ring of STAGES stages, with each
// tile's column biases (mma_col_bias) beside them; consumer warpgroup wg
// holds rows 64 wg .. + 63 of each unit of the round as the A fragments of
// round(x) and runs wgmma m64n128k16 against each tile, a group of products
// a unit, the two warpgroups taking turns to issue them, then the online
// (max, sum of exp) of each of its two rows per lane, as ce_fwd_mma_tiles,
// the first unit's while the second's products run; at the round's end
// the four lanes' butterfly (ce_quad_merge).  A
// round of one unit (the block's last, when it has an odd count) runs the
// second group on zero rows.  nll, lse: [N] fp32 (lse may be null).
template <typename Tin, int DP>
__global__ void __launch_bounds__(WG_THREADS, 1)
ce_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_tab, const Tin* __restrict__ x,
                    const float* __restrict__ bias, const int* __restrict__ tgt,
                    float* __restrict__ nll, float* __restrict__ lse_out, int N, int V, int D,
                    int valid_v) {
  using W = WgTile<DP>;
  extern __shared__ uint8_t wg_raw[];
  const uint32_t raw = smem_addr(wg_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzled tiles' 1 KB alignment
  float* cbias = reinterpret_cast<float*>(wg_raw + (base - raw) + W::BIAS0);
  const uint32_t full0 = base + W::BAR0, empty0 = full0 + 8 * W::STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < W::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 32);            // the producer's lanes, one with the bytes
      mbar_init(empty0 + 8 * s, 4 * WG_CONS);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int ntiles = (V + WG_BV - 1) / WG_BV, nunits = (N + WG_UNIT - 1) / WG_UNIT;
  const int u0 = (int)((long long)blockIdx.x * nunits / gridDim.x);
  const int u1 = (int)((long long)(blockIdx.x + 1) * nunits / gridDim.x);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= 4 * WG_CONS) {
    wg_setmaxnreg_dec<WG_PRODUCER_REGS>();
    if (warp > 4 * WG_CONS) return;
    // producer (the warpgroup's first warp): the table tiles of each round
    // in order, kept in L2
    const uint64_t keep = l2_evict_last();
    int f = 0;
    for (int u = u0; u < u1; u += W::RG)
      for (int vt = 0; vt < ntiles; ++vt, ++f) {
        const int s = f % W::STAGES, k = f / W::STAGES;
        const uint32_t full = full0 + 8 * s;
        if (k > 0) mbar_wait(empty0 + 8 * s, (k - 1) & 1);
        for (int c = lane; c < WG_BV; c += 32)
          cbias[s * WG_BV + c] = mma_col_bias(bias, vt * WG_BV + c, V, valid_v);
        if (lane == 0) {
          mbar_expect_tx(full, W::TILE_BYTES);
          for (int b = 0; b < DP / WG_BOX; ++b)
            tma_load_2d(base + s * W::TILE_BYTES + b * W::BOX_BYTES, &tm_tab, WG_BOX * b,
                        vt * WG_BV, full, keep);
        } else {
          mbar_arrive(full);
        }
      }
    return;
  }
  wg_setmaxnreg_inc<WG_CONSUMER_REGS>();
  // the two consumers take turns to issue a tile's products (named
  // barriers 1 and 2: wg waits at 1 + wg, then lets the other go), so that
  // one's exps run while the other's products do
  const int wg = warp / 4;
  if (wg == 1) named_barrier_arrive(1, 256);
  const int gid = lane / 4, t4 = lane % 4;
  const int wrow = 64 * wg + 16 * (warp % 4) + gid;  // the lane's first row of a unit
  const int rend = min(N, u1 * WG_UNIT);              // the block's rows end here
  auto xv = [&](int r, int d) {
    return (r < rend && d < D) ? load_act(x, (size_t)r * D + d) : 0.f;
  };
  int c = 0;  // table tiles consumed
  for (int u = u0; u < u1; u += W::RG) {
    const int nrg = min(W::RG, u1 - u);
    int row[W::RG][2], tg[W::RG][2];
    float m[W::RG][2], s[W::RG][2], tl[W::RG][2];
    uint32_t a[W::RG][W::KSTEPS][4];  // round(x) of the rows (wgmma.cuh's bf16 A fragments)
#pragma unroll
    for (int g = 0; g < W::RG; ++g) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        row[g][h] = (u + g) * WG_UNIT + wrow + 8 * h;
        tg[g][h] = row[g][h] < rend ? tgt[row[g][h]] : -1;
        m[g][h] = -INFINITY;
        s[g][h] = 0.f;
        tl[g][h] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < W::KSTEPS; ++kk) {
        const int d = 16 * kk + 2 * t4;
        a[g][kk][0] = pack_bf16(xv(row[g][0], d), xv(row[g][0], d + 1));
        a[g][kk][1] = pack_bf16(xv(row[g][1], d), xv(row[g][1], d + 1));
        a[g][kk][2] = pack_bf16(xv(row[g][0], d + 8), xv(row[g][0], d + 9));
        a[g][kk][3] = pack_bf16(xv(row[g][1], d + 8), xv(row[g][1], d + 9));
      }
    }
    for (int vt = 0; vt < ntiles; ++vt, ++c) {
      const int st = c % W::STAGES;
      mbar_wait(full0 + 8 * st, (c / W::STAGES) & 1);
      const uint32_t tile = base + st * W::TILE_BYTES;
      auto desc = [&](int kk) {
        return sw128_desc(tile + (kk / 4) * W::BOX_BYTES + 32 * (kk % 4));
      };
      // acc[g][4 j + 2 h + q]: row row[g][h], column 8 j + 2 t4 + q of the
      // tile; each accumulator fresh (a tensor core's fp32 sum truncates):
      // at DP 256 the first WG_KGROUP k16 steps into acc, the rest into
      // part, added in fp32
      float acc[W::RG][64];
      float part[W::KSTEPS > W::KGROUP ? 64 : 1];
      named_barrier(1 + wg, 256);
      wg_fence();
#pragma unroll
      for (int g = 0; g < W::RG; ++g) {
#pragma unroll
        for (int kk = 0; kk < W::KGROUP; ++kk)
          wgmma_m64n128k16_bf16(acc[g], a[g][kk], desc(kk), kk > 0);
        if constexpr (W::KSTEPS > W::KGROUP) {
#pragma unroll
          for (int kk = W::KGROUP; kk < W::KSTEPS; ++kk)
            wgmma_m64n128k16_bf16(part, a[g][kk], desc(kk), kk > W::KGROUP);
        }
        wg_commit();
      }
      named_barrier_arrive(2 - wg, 256);
      const float* cb = cbias + st * WG_BV + 2 * t4;
      const int v0 = vt * WG_BV;
#pragma unroll
      for (int g = 0; g < W::RG; ++g) {
        if (g + 1 < W::RG)
          wg_wait<1>();  // this group's products are done, the next one's run on
        else
          wg_wait<0>();
        if constexpr (W::KSTEPS > W::KGROUP) {
#pragma unroll
          for (int i = 0; i < 64; ++i) acc[g][i] += part[i];
        }
        // the logits: the tile's column biases (-1e30 at masked columns,
        // -inf beyond V), read before the stage is released
#pragma unroll
        for (int j = 0; j < WG_BV / 8; ++j) {
          const float2 b = *reinterpret_cast<const float2*>(cb + 8 * j);
          acc[g][4 * j] += b.x;
          acc[g][4 * j + 1] += b.y;
          acc[g][4 * j + 2] += b.x;
          acc[g][4 * j + 3] += b.y;
        }
        if (g + 1 == W::RG) {
          __syncwarp();
          if (lane == 0) mbar_arrive(empty0 + 8 * st);
        }
        if (g >= nrg) continue;  // a round of one unit: no rows here
        // the online (max, sum of exp) of each row, in column order; the
        // two rows' chains interleaved
        float mh[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int tc = tg[g][h] - v0;  // the target's column in the tile
          if ((unsigned)tc < (unsigned)WG_BV && ((tc >> 1) & 3) == t4) {
#pragma unroll
            for (int j = 0; j < WG_BV / 8; ++j)
#pragma unroll
              for (int q = 0; q < 2; ++q)
                if (8 * j + 2 * t4 + q == tc) tl[g][h] = acc[g][4 * j + 2 * h + q];
          }
          float t[WG_BV / 8];  // the tile's max, as a tree (a max is exact in any order)
#pragma unroll
          for (int j = 0; j < WG_BV / 8; ++j)
            t[j] = fmaxf(acc[g][4 * j + 2 * h], acc[g][4 * j + 2 * h + 1]);
          static_assert(WG_BV == 128, "a tree of 16");
#pragma unroll
          for (int j = 0; j < 8; ++j) t[j] = fmaxf(t[j], t[j + 8]);
#pragma unroll
          for (int j = 0; j < 4; ++j) t[j] = fmaxf(t[j], t[j + 4]);
          t[0] = fmaxf(fmaxf(t[0], t[2]), fmaxf(t[1], t[3]));
          if (t[0] > m[g][h]) {
            s[g][h] *= exp_sfu(m[g][h] - t[0]);  // 0 while m is -inf (s is 0 then)
            m[g][h] = t[0];
          }
          // while no column lies below V, m and every logit are -inf: an
          // exp of -inf adds 0
          mh[h] = m[g][h] == -INFINITY ? 0.f : m[g][h];
        }
#pragma unroll
        for (int j = 0; j < WG_BV / 8; ++j)
#pragma unroll
          for (int q = 0; q < 2; ++q)
#pragma unroll
            for (int h = 0; h < 2; ++h) s[g][h] += exp_sfu(acc[g][4 * j + 2 * h + q] - mh[h]);
      }
    }
#pragma unroll
    for (int g = 0; g < W::RG; ++g) {
      ce_quad_merge(m[g], s[g], tl[g]);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (t4 == 0 && row[g][h] < rend) {
          const float L = m[g][h] + logf(s[g][h]);
          nll[row[g][h]] = L - tl[g][h];
          if (lse_out != nullptr) lse_out[row[g][h]] = L;
        }
    }
  }
  if (wg == 0) named_barrier(1, 256);  // the other's last turn, so both barriers end even
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

template <int DP>
cudaError_t ce_fwd_mma(const void* x, int xbf, const float* tab, const float* bias,
                       const int* tgt, float* nll, float* lse, int N, int V, int D, int valid_v,
                       cudaStream_t stream) {
  const size_t sm = ce_fwd_mma_smem<false, DP>();
  cudaError_t e = ce_set_smem(ce_fwd_mma_kernel<DP>, sm);
  if (e != cudaSuccess) return e;
  ce_fwd_mma_kernel<DP><<<(N + CE_MMA_BM - 1) / CE_MMA_BM, CE_MMA_THREADS, sm, stream>>>(
      x, xbf, tab, bias, tgt, nll, lse, N, V, D, valid_v);
  return cudaGetLastError();
}

// The bf16 forward at D <= 256: the table rounded once into scratch ([V,
// DP] bf16, 16-byte aligned), then ce_fwd_wgmma_kernel on one persistent
// block a multiprocessor (at most one a unit of 128 rows).
template <typename Tin, int DP>
cudaError_t ce_fwd_wgmma(const Tin* x, const float* tab, void* scratch, const float* bias,
                         const int* tgt, float* nll, float* lse, int N, int V, int D,
                         int valid_v, int device, cudaStream_t s) {
  using W = WgTile<DP>;
  if (scratch == nullptr || reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return cudaErrorInvalidValue;
  const long long blocks = ((long long)V * (DP / 2) + 255) / 256;
  ce_round_table_kernel<DP><<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
      tab, static_cast<uint32_t*>(scratch), V, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  CUtensorMap tm;
  e = make_tensor_map_2d(&tm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, scratch, V, DP, DP * 2, WG_BV,
                         WG_BOX);
  if (e != cudaSuccess) return e;
  if ((e = ce_set_smem(ce_fwd_wgmma_kernel<Tin, DP>, W::SMEM)) != cudaSuccess) return e;
  int sms = 0;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return e;
  const int nunits = (N + WG_UNIT - 1) / WG_UNIT;
  ce_fwd_wgmma_kernel<Tin, DP><<<min(nunits, sms), WG_THREADS, W::SMEM, s>>>(
      tm, x, bias, tgt, nll, lse, N, V, D, valid_v);
  return cudaGetLastError();
}

// D <= MMA_MAX_D takes the tensor cores: ce_fwd_wgmma_kernel with mm_bf16
// (bf16 products), else ce_fwd_mma_kernel (3xTF32); a wider D the fp32 FMA
// kernel with 16 x 16 tiles.
template <typename Tin>
cudaError_t ce_fwd_any(const Tin* x, const float* tab, void* scratch, const float* bias,
                       const int* tgt, float* nll, float* lse, int N, int V, int D, int valid_v,
                       int mm_bf16, int device, cudaStream_t s) {
  if (D <= MMA_MAX_D) {
    // ce_fwd_mma_kernel copies the table in 16-byte pieces; the wrapper
    // hands both tensor-core forwards an aligned one (one gate, one rule)
    if (reinterpret_cast<uintptr_t>(tab) % 16 != 0) return cudaErrorInvalidValue;
    const int xbf = std::is_same<Tin, __nv_bfloat16>::value;
    return mma_dispatch(mm_bf16, D, [&](auto mm, auto dp) {
      constexpr int DP = decltype(dp)::value;
      if constexpr (decltype(mm)::value)
        return ce_fwd_wgmma<Tin, DP>(x, tab, scratch, bias, tgt, nll, lse, N, V, D, valid_v,
                                     device, s);
      else
        return ce_fwd_mma<DP>(x, xbf, tab, bias, tgt, nll, lse, N, V, D, valid_v, s);
    });
  }
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
// tgt: [N] int32; nll: [N] fp32 out; lse: [N] fp32 out, or null; scratch:
// with mm_bf16 at D <= 256, [V, DP] bf16 (the rounded table, DP = 64, 128
// or 256 by mma_dp, 16-byte aligned), else unused; valid_v: columns at or
// beyond it are masked; mm_bf16: round x and the table to bf16 for the
// logits; device: the card that holds them.  The tensor-core forwards (D
// <= 256) need a 16-byte aligned table.
int recblr_ce_fwd(const void* x, const void* table, const void* bias, const void* tgt,
                  void* nll, void* lse, void* scratch, int N, int V, int D, int valid_v, int bf16,
                  int mm_bf16, int device, void* stream) {
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
    return ce_fwd_any(static_cast<const __nv_bfloat16*>(x), t, scratch, b, g, n, l, N, V, D,
                      valid_v, mm_bf16, device, s);
  return ce_fwd_any(static_cast<const float*>(x), t, scratch, b, g, n, l, N, V, D, valid_v,
                    mm_bf16, device, s);
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
