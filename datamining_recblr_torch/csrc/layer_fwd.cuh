// The RecBLR recurrent-layer forward's two per-position phases for Hopper
// (sm_90a), every matrix product on the tensor cores: phase A
// (phase_a_mma_kernel) and the tail (tail_mma_kernel).  The whole-layer
// forwards (fused_layer.cu, fused_layer_last.cu, fused_layer_chunked.cu),
// the standalone BD-LRU (fused_bdlru.cu) and the backwards that recompute
// phase A launch them through launch_phase_a and launch_tail.
//
//   A     per (row, tile of TT positions): [prologue LN] -> xb = x W_in[:, :C]
//         over the tile and its conv halo -> causal conv + SiLU -> gates
//         xc W_g + b_g -> alpha, beta * xc [B, T, C] fp32 to scratch
//   tail  per TAIL_MMA_ROWS rows (positions of [B * T], or batch rows at
//         their last valid position): z = x W_in[:, C:] -> silu(z) h W_out
//         -> LN1 residual -> SiLU FFN -> LN2 residual
//
// What bounds them: at the bench widths (D 64, C 128, FFN 256) a position
// costs ~180 kFLOP of products against ~1 KB of activations and scratch,
// so operations.  Every product is m16n8k8 TF32 mma.sync as 3xTF32
// (mma_tile.cuh mma_3xtf32: both operands split into two TF32 terms, lo hi +
// hi lo + hi hi), each 8-deep k-tile summed in a fresh accumulator and added
// in fp32 (add_tile: the tensor cores' own fp32 sum truncates), so the
// products keep fp32 accuracy in both precisions (RecBLR asks for no bf16
// products).  What the design does about the splits, loads and latencies
// that bound an mma.sync loop (PERF.md):
//   - phase A splits each activation once, as it is staged: x after the LN
//     and xc after the conv go to shared memory as hi and lo planes in the
//     order a warp's lanes read their A fragments (frag_a_index), one 16-byte
//     load a plane a fragment; W_in and W_g come from L2 through the
//     read-only cache, split as read, two k-tiles in flight (two blocks an
//     SM); the gate math runs in the gates product's epilogue (a warp holds
//     the two gate columns of its channels), so the gates never touch shared
//     memory, and softplus(lambda) is taken once a channel; the conv walks
//     a channel's taps in order over 16 rows a thread;
//   - the tail runs over 128 rows a block, 16 a warp, each warp's rows kept
//     in registers from one product to the next (z and the FFN's activation
//     become the A operands of W_out and W2 as C fragments, split_c_as_a);
//     the weights go through shared memory in chunks of TAIL_CHUNK columns
//     of W_in[:, C:] / W1 with the matching rows of W_out / W2, each chunk
//     split once a block into the B fragments' order as it is staged, the
//     next chunk's loads in flight while the current one is multiplied;
//   - x rows and h are prefetched into L1 ahead of their use, and lanes t
//     and t ^ 1 share each Philox call (pair_keep_bits).
// Shared memory at the bench widths: phase A 68,656 bytes, the tail 67,584
// (two blocks an SM each: registers bound them).
// The CUDA-core work is fp32 and keeps its order: the LN, the conv, the
// gate math, SiLU, the residuals.  Dropout masks are the bits of drop_mask.
// No atomics: a rerun gives the same bits.
#pragma once

#include "common.cuh"
#include "mma_smem.cuh"  // pad16, ld_k, ld_n (and through it ld_of, mma_tile.cuh)

namespace recblr {

// ---------------------------------------------------------------------------
// A operands split once: hi and lo planes in fragment order
// ---------------------------------------------------------------------------

// Index of A(r, k) in a plane of kt k-tiles: the 16 x 8 tile (r / 16, k / 8)
// is 32 lanes of four words, word e of lane (gid, t) being A(gid + 8 (e & 1),
// t + 4 (e >> 1)) of the tile (mma_tile.cuh's tf32 A layout), so a warp reads
// a tile's fragments as one 16-byte load a lane.
__device__ __forceinline__ int frag_a_index(int r, int k, int kt) {
  const int lane = (r & 7) * 4 + (k & 3);
  const int e = ((r >> 3) & 1) | (((k >> 2) & 1) << 1);
  return (((r >> 4) * kt + (k >> 3)) * 32 + lane) * 4 + e;
}

// Asks L1 for the line that holds p (no register waits on it): rows a
// warp reads one after the other arrive together.
__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];\n" ::"l"(p));
}

// The keep bits of a lane's four C-fragment elements of the 8-column tile at
// col0 (col0 % 8 == 0): rows gid and gid + 8, at mask coordinates (b0, p0)
// and (b1, p1), columns col0 + 2t + e; bit 2 hf + e.  Lanes t and t ^ 1 read
// the words of one Philox call a row (columns 2t, 2t + 1 of one group of
// four, drop_mask's bits), so each computes the call of row t & 1 only and
// the pair swaps the two words the other needs.  Every lane of the warp
// calls it.
__device__ __forceinline__ unsigned pair_keep_bits(const Dropout& dr, int id, int col0, int b0,
                                                   int p0, int b1, int p1) {
  const int t = threadIdx.x % 4;
  const bool odd = t & 1;
  const uint4 w = philox4x32_10(make_uint4((unsigned)(col0 / 4 + t / 2), (unsigned)(odd ? p1 : p0),
                                           (unsigned)(odd ? b1 : b0), (unsigned)id),
                                dr.k0, dr.k1);
  const unsigned own = (unsigned)((odd ? w.z : w.x) < dr.thresh) |
                       (unsigned)((odd ? w.w : w.y) < dr.thresh) << 1;
  const unsigned r0 = __shfl_xor_sync(0xffffffffu, odd ? w.x : w.z, 1);
  const unsigned r1 = __shfl_xor_sync(0xffffffffu, odd ? w.y : w.w, 1);
  const unsigned other = (unsigned)(r0 < dr.thresh) | (unsigned)(r1 < dr.thresh) << 1;
  return odd ? other | own << 2 : own | other << 2;
}

// out[i], out[i + 1] = a, b in one store (i even).
__device__ __forceinline__ void store_act2(float* p, size_t i, float a, float b) {
  *reinterpret_cast<float2*>(p + i) = make_float2(a, b);
}
__device__ __forceinline__ void store_act2(__nv_bfloat16* p, size_t i, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p + i) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void put_split(uint32_t* hi, uint32_t* lo, int i, float v) {
  uint32_t h, l;
  split_i(v, h, l);
  hi[i] = h;
  lo[i] = l;
}

// Channels d0 .. d0 + 3 (d0 = 4 lane) of the x row at element offset base,
// zero beyond D and where the row is not live (warp-uniform): with the
// prologue, times mask m0 at (mb, mt), then the LN over the D channels.
template <typename Tin>
__device__ __forceinline__ void x_row4(const Tin* __restrict__ x, size_t base, bool live, int D,
                                       int prologue, const Dropout& dr, int mb, int mt,
                                       const LayerParams& p, float (&v)[4]) {
  const int lane = threadIdx.x % 32, d0 = 4 * lane;
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = 0.f;
  if (live && d0 < D) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (d0 + q < D) v[q] = load_act(x, base + d0 + q);
    if (prologue) {
      const float4 m = drop_mask4(dr, M0, mb, mt, lane);
      v[0] *= m.x;
      v[1] *= m.y;
      v[2] *= m.z;
      v[3] *= m.w;
    }
  }
  if (prologue && live) {
    const float mu = warp_sum(v[0] + v[1] + v[2] + v[3]) / D;
    float sq = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (d0 + q < D) sq += (v[q] - mu) * (v[q] - mu);
    const float inv = rsqrtf(warp_sum(sq) / D + LN_EPS);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (d0 + q < D) v[q] = (v[q] - mu) * inv * p.pl_s[d0 + q] + p.pl_b[d0 + q];
  }
}

// C(m, n) = sum_{k < K} A(m, k) W(k, col(n)) on the tensor cores, A from the
// planes ahp / alp (mtiles m-tiles of kt k-tiles, zero beyond the operand),
// W fp32 in device memory (row stride ldw), split as it is read.  A warp
// tile is MT m-tiles by NP n-tiles of 8 of the N output columns; with PAIRS
// it holds also the NP tiles N columns further on (W's columns N + n: the
// gates' second half), as tiles NP .. 2 NP - 1.  Delivered as
// tile_epi(mg, ng, acc) (m-tile group mg, n-tile group ng).  PF k-tiles of W
// are in flight ahead of the one multiplied.
template <int MT, int NP, bool PAIRS, int PF, typename TileEpi>
__device__ __forceinline__ void mm_planes(const uint32_t* __restrict__ ahp,
                                          const uint32_t* __restrict__ alp, int mtiles, int kt,
                                          const float* __restrict__ w, int ldw, int K, int N,
                                          TileEpi tile_epi) {
  constexpr int NT = PAIRS ? 2 * NP : NP;
  const int lane = threadIdx.x % 32, gid = lane / 4, t = lane % 4;
  const int gm = (mtiles + MT - 1) / MT, gn = ((N + 7) / 8 + NP - 1) / NP;
  const uint4* ah4 = reinterpret_cast<const uint4*>(ahp);
  const uint4* al4 = reinterpret_cast<const uint4*>(alp);
  for (int wt = threadIdx.x / 32; wt < gm * gn; wt += blockDim.x / 32) {
    const int mg = wt / gn, ng = wt % gn;
    int col[NT];  // the lane's column of W in n-tile j, -1 beyond N
    bool live[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = 8 * (ng * NP + j % NP);
      col[j] = n + gid < N ? n + gid + (j >= NP ? N : 0) : -1;
      live[j] = n < N;
    }
    auto load_b = [&](int k0, float (&v)[NT][2]) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        v[j][0] = col[j] >= 0 && k0 + t < K ? __ldg(w + (size_t)(k0 + t) * ldw + col[j]) : 0.f;
        v[j][1] =
            col[j] >= 0 && k0 + t + 4 < K ? __ldg(w + (size_t)(k0 + t + 4) * ldw + col[j]) : 0.f;
      }
    };
    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    float bq[PF][NT][2];  // a ring of the next PF k-tiles of W, in flight
#pragma unroll
    for (int s = 0; s < PF; ++s)
      if (s < kt) load_b(8 * s, bq[s]);
    for (int k0 = 0; k0 < kt; k0 += PF) {
#pragma unroll
      for (int s = 0; s < PF; ++s) {  // the ring's slots by constant index
        const int k = k0 + s;
        if (k >= kt) break;
        uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          split_i(bq[s][j][0], bh[j][0], bl[j][0]);
          split_i(bq[s][j][1], bh[j][1], bl[j][1]);
        }
        if (k + PF < kt) load_b(8 * (k + PF), bq[s]);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int mt = mg * MT + i;
          if (mt >= mtiles) continue;
          const uint4 h4 = ah4[(mt * kt + k) * 32 + lane], l4 = al4[(mt * kt + k) * 32 + lane];
          const uint32_t ah[4] = {h4.x, h4.y, h4.z, h4.w}, al[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            if (!live[j]) continue;
            float c[4] = {0.f, 0.f, 0.f, 0.f};
            mma_3xtf32(c, ah, al, __uint_as_float(bh[j][0]), __uint_as_float(bh[j][1]),
                       __uint_as_float(bl[j][0]), __uint_as_float(bl[j][1]));
            add_tile(acc[i][j], c);
          }
        }
      }
    }
    tile_epi(mg, ng, acc);
  }
}

// ---------------------------------------------------------------------------
// Phase A
// ---------------------------------------------------------------------------

// Shared memory of phase A, in floats: region X holds first x's hi and lo
// planes [pad16(xb_rows)][pad8(D)] each, then xc fp32 [TT][ld_of(C)] and its
// planes [TT][pad8(C)] each; then xb [xb_rows][ld_of(C)]; then softplus(lam)
// [C].  At D = C = 128, K = 64: 148,976 bytes; at the bench widths 68,656.
struct PhaseASmem {
  int lC, c8, xs_plane, xc_plane, xb, spl, floats;
  __host__ __device__ PhaseASmem(int D, int C, int K)
      : lC(ld_of(C)), c8(pad8(C)), xs_plane(pad16(xb_rows(K)) * pad8(D)), xc_plane(TT * c8) {
    const int xs = 2 * xs_plane, xc = TT * lC + 2 * xc_plane;
    xb = xs > xc ? xs : xc;  // after region X
    spl = xb + xb_rows(K) * lC;
    floats = spl + c8;
  }
};

// Block (b, tile): positions t0 .. t_end-1 of row b.  Writes alpha and
// beta*xc [B, T, C] fp32.  With `lens`, tiles at or beyond row b's valid
// length are skipped: the last-position layer reads the scan only below
// it.  XB: x is xb itself, [B, T, C] (the standalone BD-LRU of
// fused_bdlru.cu: no in-projection, no prologue; D = 0).  With tail_out,
// also the chunked layer's record of xb rows (below).
// Launch bounds and the depth of W's prefetch: two blocks an SM (128
// registers) with two k-tiles in flight, or, for the BD-LRU's smaller
// kernel, three blocks with one (the measured best of each, PERF.md).
template <typename Tin, bool XB = false>
__global__ void __launch_bounds__(THREADS, XB ? 3 : 2)
phase_a_mma_kernel(const Tin* __restrict__ x, const int* __restrict__ lens, LayerParams p,
                   Dropout dr, float* __restrict__ alpha_out, float* __restrict__ bx_out, int T,
                   int D, int C, int K, int use_conv, int prologue,
                   float* __restrict__ tail_out, int chunk) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int t0 = blockIdx.y * TT;
  int t_end = min(t0 + TT, T);
  if (lens != nullptr) t_end = min(t_end, valid_len(lens[b], T));
  if (t0 >= t_end) return;
  constexpr int PF = XB ? 1 : 2;  // k-tiles of W in flight
  const int H = use_conv ? K - 1 : 0;
  const int rows = t_end - t0, rows_h = rows + H;
  const PhaseASmem L(D, C, K);
  const int lC = L.lC, ktc = L.c8 / 8;
  uint32_t* xs_hi = reinterpret_cast<uint32_t*>(smem);  // x planes (region X)
  uint32_t* xs_lo = xs_hi + L.xs_plane;
  float* xc = smem;                                       // xc (region X, later)
  uint32_t* xc_hi = reinterpret_cast<uint32_t*>(smem + TT * lC);
  uint32_t* xc_lo = xc_hi + L.xc_plane;
  float* xb = smem + L.xb;    // [xb_rows][lC]  x W_in[:, :C] on rows t0-H .. t_end-1
  float* spl = smem + L.spl;  // [C]  softplus(lam)
  for (int c = threadIdx.x; c < C; c += blockDim.x) spl[c] = softplus_t(p.lam[c]);

  if (XB) {
    for (int i = threadIdx.x; i < rows_h * C; i += blockDim.x) {
      const int r = i / C, c = i % C, t = t0 - H + r;
      xb[r * lC + c] = t >= 0 ? load_act(x, ((size_t)b * T + t) * C + c) : 0.f;
    }
  } else {
    // x rows t0-H .. t_end-1, a warp a row, four channels a lane: mask m0
    // and the prologue LN, then split into the planes (zero beyond the
    // rows, the channels and below position 0)
    const int d8 = pad8(D), ktd = d8 / 8, mtiles = (rows_h + 15) / 16;
    const int lane = threadIdx.x % 32, d0 = 4 * lane;
    constexpr int LINE = 128 / (int)sizeof(Tin);  // elements a cache line
    for (int i = threadIdx.x; i < rows_h * 4; i += blockDim.x) {
      const int t = t0 - H + i / 4, off = (i % 4) * LINE;
      if (t >= 0 && off < D) prefetch_l1(x + ((size_t)b * T + t) * D + off);
    }
#pragma unroll 2
    for (int r = threadIdx.x / 32; r < 16 * mtiles; r += blockDim.x / 32) {
      const int t = t0 - H + r;
      const bool live = r < rows_h && t >= 0;
      float v[4];
      x_row4(x, live ? ((size_t)b * T + t) * D : 0, live, D, prologue, dr, b, t, p, v);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (d0 + q < d8) put_split(xs_hi, xs_lo, frag_a_index(r, d0 + q, ktd), v[q]);
    }
    __syncthreads();
    mm_planes<3, 2, false, PF>(xs_hi, xs_lo, mtiles, ktd, p.w_in, 2 * C, D, C,
                        [&](int mg, int ng, const float (&acc)[3][2][4]) {
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int m = frag_m(16 * 3 * mg, i, e), n = frag_n(8 * 2 * ng, j, e);
            if (m < rows_h && n < C) xb[m * lC + n] = acc[i][j][e];
          }
    });
    __syncthreads();
    if (tail_out != nullptr) {
      // the chunked layer's record: the last K-1 xb rows of chunk j are rows
      // 1 .. K-1 of chunk j + 1's REC_ROWS rows
      const int nc = T / chunk;
      for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
        const int r = i / C, c = i % C, t = t0 + r;
        const int j = t / chunk, q = t % chunk - (chunk - (K - 1));
        if (q >= 0 && j + 1 < nc)
          tail_out[(((size_t)b * nc + j + 1) * REC_ROWS + 1 + q) * C + c] = xb[(r + H) * lC + c];
      }
    }
  }
  __syncthreads();

  // xc = silu(conv(xb)) on the tile's rows: fp32 for beta * xc, and its
  // planes.  A thread takes channel c and CONV_ROWS rows from r0, the taps in
  // order over all of them: u[t] = x[t] wc[K-1] + bc + sum_{j>=1} x[t-j]
  // wc[K-1-j], zero history
  constexpr int CONV_ROWS = TT * 128 / THREADS;
  for (int q = threadIdx.x; q < (TT / CONV_ROWS) * L.c8; q += blockDim.x) {
    const int c = q % L.c8, r0 = q / L.c8 * CONV_ROWS;
    const bool live = c < C;
    float u[CONV_ROWS];
    if (use_conv && live) {
      const float w0 = __ldg(p.wc + (K - 1) * C + c), bc = __ldg(p.bc + c);
#pragma unroll
      for (int i = 0; i < CONV_ROWS; ++i)
        u[i] = r0 + i < rows ? xb[(r0 + i + H) * lC + c] * w0 + bc : 0.f;
      for (int j = 1; j < K; ++j) {
        const float wj = __ldg(p.wc + (K - 1 - j) * C + c);
#pragma unroll
        for (int i = 0; i < CONV_ROWS; ++i) {
          const int r = r0 + i;
          const float xv = r < rows && t0 + r - j >= 0 ? xb[(r + H - j) * lC + c] : 0.f;
          u[i] += xv * wj;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < CONV_ROWS; ++i) {
      const int r = r0 + i;
      float v = 0.f;
      if (live && r < rows) {
        v = use_conv ? silu_t(u[i]) : xb[r * lC + c];
        xc[r * lC + c] = v;
      }
      put_split(xc_hi, xc_lo, frag_a_index(r, c, ktc), v);
    }
  }
  __syncthreads();

  // gates g = xc W_g + b_g, a warp holding both halves of its channels; the
  // gate math in the epilogue
  constexpr int NP = 2;
  mm_planes<2, NP, true, PF>(xc_hi, xc_lo, (rows + 15) / 16, ktc, p.wg, 2 * C, C, C,
                      [&](int, int ng, const float (&acc)[2][2 * NP][4]) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < NP; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = frag_m(0, i, e), c = frag_n(8 * NP * ng, j, e);
          if (r >= rows || c >= C) continue;
          const float sr = sigmoid_t(acc[i][j][e] + __ldg(p.bg + c));
          const float si = sigmoid_t(acc[i][NP + j][e] + __ldg(p.bg + C + c));
          const float a = exp_t(-spl[c] * sr);
          const float beta = sqrtf(1.f - a * a + GATE_EPS) * si;
          const size_t o = ((size_t)b * T + t0 + r) * C + c;
          alpha_out[o] = a;
          bx_out[o] = beta * xc[r * lC + c];
        }
  });
}

template <typename Tin, bool XB = false>
inline cudaError_t launch_phase_a(const Tin* x, const int* lens, const LayerParams& p,
                                  const Dropout& dr, float* alpha, float* bx, int B, int T,
                                  int D, int C, int K, int use_conv, int prologue,
                                  cudaStream_t stream, float* tail_out = nullptr,
                                  int chunk = 0) {
  const size_t sa = sizeof(float) * (size_t)PhaseASmem(D, C, K).floats;
  cudaError_t e = cudaFuncSetAttribute(phase_a_mma_kernel<Tin, XB>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sa);
  if (e != cudaSuccess) return e;
  phase_a_mma_kernel<Tin, XB><<<dim3(B, (T + TT - 1) / TT), THREADS, sa, stream>>>(
      x, lens, p, dr, alpha, bx, T, D, C, K, use_conv, prologue, tail_out, chunk);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The tail
// ---------------------------------------------------------------------------

constexpr int TAIL_MMA_ROWS = 128;  // rows a block of tail_mma_kernel: 16 a warp
constexpr int TAIL_CHUNK = 16;  // weight columns a chunk (of C, then of the FFN)
constexpr int TAIL_NTC = TAIL_CHUNK / 8;  // their 8-column tiles

// A chunk's B fragments, split once: per (k-tile, n-tile) a uint4 a lane,
// {hi(ra, n), hi(rb, n), lo(ra, n), lo(rb, n)} of W at n = 8 n-tile + gid.
// The first part is W_in[:, C + c0 ..] or W1[:, f0 ..] ([D16][TAIL_CHUNK]:
// D16 / 8 k-tiles of TAIL_NTC n-tiles) against A fragments read in depth
// order, ra = 8 k + t and rb = ra + 4; the second W_out[c0 .., :] or W2[f0
// .., :] ([TAIL_CHUNK][D16]: TAIL_NTC k-tiles of D16 / 8) against A fragments
// made from C fragments (split_c_as_a), ra = 8 k + 2 t and rb = ra + 1.
// Either part is 32 TAIL_NTC nt uint4 (nt = D16 / 8).
inline __host__ __device__ int tail_part_u4(int D) { return 32 * TAIL_NTC * (pad16(D) / 8); }
inline __host__ __device__ int tail_chunk_u4(int D) { return 2 * tail_part_u4(D); }

inline size_t tail_smem_bytes(int D) {
  return 2 * (size_t)tail_chunk_u4(D) * 16 + sizeof(float) * TAIL_MMA_ROWS * ld_k<false>(pad16(D));
}

// The A fragment (its two TF32 terms) of the depth step at k0 of a warp's 16
// rows a (row stride lda), each value split as it is read.
__device__ __forceinline__ void rows_frag(const float* a, int lda, int k0, uint32_t (&hi)[4],
                                          uint32_t (&lo)[4]) {
  const int gid = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const float* q = a + gid * lda + k0 + t;
  split_i(q[0], hi[0], lo[0]);
  split_i(q[8 * lda], hi[1], lo[1]);
  split_i(q[4], hi[2], lo[2]);
  split_i(q[8 * lda + 4], hi[3], lo[3]);
}

// acc += A B for one 16 x 8 tile: 3xTF32 from the split fragments, in a
// fresh accumulator added in fp32.
__device__ __forceinline__ void frag_mma(float (&acc)[4], const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4], const uint4& b) {
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  mma_3xtf32(c, ah, al, __uint_as_float(b.x), __uint_as_float(b.y), __uint_as_float(b.z),
             __uint_as_float(b.w));
  add_tile(acc, c);
}

// The mask coordinates (row, position) of tail row g: LAST (g, 0), else
// (g / T, g % T); (0, 0) beyond the rows.
template <bool LAST>
__device__ __forceinline__ int2 tail_mask_at(long long g, long long nrows, int T) {
  if (g >= nrows) return make_int2(0, 0);
  return LAST ? make_int2((int)g, 0) : make_int2((int)(g / T), (int)(g % T));
}

// A warp's 16 rows after W_out or the FFN, from their C tiles: v = (acc +
// bias) * mask(id) + res, res the rows' values in r (row stride lr), then
// LayerNorm (lns, lnb) over the D columns (a row's values sit in the four
// lanes of a quad).  The result goes back to r (zero from D to pad16(D)) and,
// with out, to the layer's output at row g0 + lrow.  Mask coordinates
// tail_mask_at; one Philox call per four channels of a row
// (pair_keep_bits).
template <bool LAST, int NT, typename Tin>
__device__ __forceinline__ void tail_ln_rows(const float (&acc)[NT][4], const float* bias,
                                             const Dropout& dr, int id, float* r, int lr,
                                             const float* lns, const float* lnb, Tin* out,
                                             long long g0, long long nrows, int T, int D) {
  const int gid = threadIdx.x % 32 / 4, t = threadIdx.x % 4, nt = pad16(D) / 8;
  const int2 ma = tail_mask_at<LAST>(g0 + gid, nrows, T);
  const int2 mb = tail_mask_at<LAST>(g0 + gid + 8, nrows, T);
  unsigned long long keep = ~0ull;  // bit 4 j + 2 half + e
  if (dr.on) {
    keep = 0ull;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (j < nt)
        keep |= (unsigned long long)pair_keep_bits(dr, id, 8 * j, ma.x, ma.y, mb.x, mb.y)
                << (4 * j);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int lrow = gid + 8 * half;
    const long long g = g0 + lrow;
    const bool live = g < nrows;
    float v[NT][2];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = 8 * j + 2 * t;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cc = col + e;
        float z = 0.f;
        if (live && j < nt && cc < D) {
          const float mk = (keep >> (4 * j + 2 * half + e)) & 1ull ? (dr.on ? dr.scale : 1.f)
                                                                   : 0.f;
          const float y = bias != nullptr ? acc[j][2 * half + e] + __ldg(bias + cc)
                                          : acc[j][2 * half + e];
          z = y * mk + r[lrow * lr + cc];
        }
        v[j][e] = z;
        sum += z;
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float mu = sum / D;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (j < nt && 8 * j + 2 * t + e < D) {
          const float d = v[j][e] - mu;
          sq += d * d;
        }
    sq += __shfl_xor_sync(0xffffffffu, sq, 1);
    sq += __shfl_xor_sync(0xffffffffu, sq, 2);
    const float inv = rsqrtf(sq / D + LN_EPS);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j >= nt) continue;
      const int c0 = 8 * j + 2 * t;
      float y[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cc = c0 + e;
        y[e] = cc < D ? (v[j][e] - mu) * inv * __ldg(lns + cc) + __ldg(lnb + cc) : 0.f;
        r[lrow * lr + cc] = y[e];
      }
      if (out != nullptr && live && c0 < D) {
        const size_t o = (size_t)g * D + c0;
        if (c0 + 1 < D && o % 2 == 0) {
          store_act2(out, o, y[0], y[1]);
        } else {
          store_act(out, o, y[0]);
          if (c0 + 1 < D) store_act(out, o + 1, y[1]);
        }
      }
    }
  }
}

// LAST = false: block i covers rows i TAIL_MMA_ROWS .. of [B * T] (position
// g % T of row g / T), h is [B, T, C], out is [B, T, D].  LAST = true: it
// covers batch rows, each at its last valid position (x_last = 0 and h_last
// = 0 where nothing is selected), h is [B, C], out is [B, D].  Warp w takes
// the 16 rows from 16 w, in registers: pass 1 walks C in chunks: z = x
// W_in[:, C + c0 ..], then silu(z) h as the A operand of W_out[c0 .., :],
// W_out's sum kept; r1 = LN1(m1 y + x).  Pass 2 walks the FFN the same way:
// silu(r1 W1 + b1) m2 against W2, then out = LN2(m3 (that + b2) + r1).  The
// warps share only the weight chunks.  NT: 8-column tiles of D (8 up to D
// 64, 16 up to 128).
template <typename Tin, bool LAST, int NT>
__global__ void __launch_bounds__(THREADS, NT <= 8 ? 2 : 1)
tail_mma_kernel(const Tin* __restrict__ x, const int* __restrict__ lens,
                const float* __restrict__ h, Tin* __restrict__ out, LayerParams p, Dropout dr,
                int B, int T, int D, int C, int F, int use_ffn, int prologue) {
  extern __shared__ __align__(16) float smem[];
  const int D16 = pad16(D), nt = D16 / 8, lr = ld_k<false>(D16);
  const int lane = threadIdx.x % 32, gid = lane / 4, t = lane % 4;
  const int part_u4 = tail_part_u4(D);
  constexpr int SPT = (32 * TAIL_NTC * NT + THREADS - 1) / THREADS;  // units a thread a part
  uint4* wbuf = reinterpret_cast<uint4*>(smem);  // two chunks of two parts
  float* rw = smem + 2 * 4 * tail_chunk_u4(D) + 16 * (threadIdx.x / 32) * lr;  // the warp's rows
  const long long nrows = LAST ? (long long)B : (long long)B * T;
  const long long g0 = (long long)blockIdx.x * TAIL_MMA_ROWS + 16 * (threadIdx.x / 32);
  const int nc1 = (C + TAIL_CHUNK - 1) / TAIL_CHUNK;
  const int nck = nc1 + (use_ffn ? (F + TAIL_CHUNK - 1) / TAIL_CHUNK : 0);

  // part `part` of chunk k's weights, the units u = threadIdx.x + THREADS s
  // below part_u4, two values each; split into their TF32 terms by
  // store_part
  auto load_part = [&](int k, int part, float (&v)[SPT][2]) {
    const bool ffn = k >= nc1;
    const int c0 = (ffn ? k - nc1 : k) * TAIL_CHUNK, width = ffn ? F : C;
    const float* wa = ffn ? p.w1 + c0 : p.w_in + C + c0;  // [D][.] columns c0 ..
    const int lda = ffn ? F : 2 * C;
    const float* wb = (ffn ? p.w2 : p.w_out) + (size_t)c0 * D;  // rows c0 .., [.][D]
#pragma unroll
    for (int s = 0; s < SPT; ++s) {
      v[s][0] = v[s][1] = 0.f;
      const int u = threadIdx.x + THREADS * s;
      if (u >= part_u4) continue;
      const int ln = u % 32, g = ln / 4, tt = ln % 4;
      if (part == 0) {
        const int kt = u / 32 / TAIL_NTC, n = 8 * (u / 32 % TAIL_NTC) + g, ra = 8 * kt + tt;
        if (c0 + n < width) {
          if (ra < D) v[s][0] = __ldg(wa + (size_t)ra * lda + n);
          if (ra + 4 < D) v[s][1] = __ldg(wa + (size_t)(ra + 4) * lda + n);
        }
      } else {
        const int kt = u / 32 / nt, n = 8 * (u / 32 % nt) + g;
        const int ra = 8 * kt + 2 * tt;
        if (n < D) {
          if (c0 + ra < width) v[s][0] = __ldg(wb + (size_t)ra * D + n);
          if (c0 + ra + 1 < width) v[s][1] = __ldg(wb + (size_t)(ra + 1) * D + n);
        }
      }
    }
  };
  auto store_part = [&](int k, int part, const float (&v)[SPT][2]) {
    uint4* dst = wbuf + ((k & 1) * 2 + part) * part_u4;
#pragma unroll
    for (int s = 0; s < SPT; ++s) {
      const int u = threadIdx.x + THREADS * s;
      if (u >= part_u4) continue;
      uint32_t h0, l0, h1, l1;
      split_i(v[s][0], h0, l0);
      split_i(v[s][1], h1, l1);
      dst[u] = make_uint4(h0, h1, l0, l1);
    }
  };

  {  // the warp's x rows, a line a lane, land while chunk 0 is staged
    const long long g = g0 + lane % 16;
    const int off = lane / 16 * (128 / (int)sizeof(Tin));
    if (g < nrows && off < D) {
      const int n = LAST ? valid_len(lens[g], T) : 1;
      if (n > 0) prefetch_l1(x + (LAST ? ((size_t)g * T + n - 1) * D : (size_t)g * D) + off);
    }
  }
  const long long ga = g0 + gid, gb = ga + 8;  // the lane's two rows
  const int2 ma = tail_mask_at<LAST>(ga, nrows, T), mb = tail_mask_at<LAST>(gb, nrows, T);

  float st[SPT][2];
  for (int part = 0; part < 2; ++part) {
    load_part(0, part, st);
    store_part(0, part, st);
  }

  // the warp's rows: x (LAST: at the last valid position), mask m0 and the
  // prologue LN; four channels a lane, zero beyond D and beyond the rows
#pragma unroll 4
  for (int lrow = 0; lrow < 16; ++lrow) {
    const long long g = g0 + lrow;
    bool live = g < nrows;
    size_t base = 0;
    if (live && LAST) {
      const int n = valid_len(lens[g], T);
      live = n > 0;
      base = ((size_t)g * T + n - 1) * D;
    } else if (live) {
      base = (size_t)g * D;
    }
    const int2 m = tail_mask_at<LAST>(g, nrows, T);
    float v[4];
    x_row4(x, base, live, D, prologue, dr, m.x, m.y, p, v);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (4 * lane + q < D16) rw[lrow * lr + 4 * lane + q] = v[q];
  }
  __syncthreads();  // chunk 0 is staged; the warp's rows are written

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int k = 0; k < nck; ++k) {
    // chunk k + 1 goes to the other buffer, free since the last barrier: its
    // second part's loads in flight during the first product, its first
    // part's during the second
    const bool more = k + 1 < nck;
    if (more) load_part(k + 1, 1, st);
    const bool ffn = k >= nc1;
    const int c0 = (ffn ? k - nc1 : k) * TAIL_CHUNK;
    if (!ffn) {  // the chunk's h: a line at each end of the lane pair's row
      const long long g = t < 2 ? ga : gb;
      if (g < nrows)
        prefetch_l1(h + (size_t)g * C + c0 + (t & 1) * min(TAIL_CHUNK - 1, C - 1 - c0));
    }
    const uint4* wa = wbuf + (k & 1) * 2 * part_u4 + lane;
    const uint4* wb = wa + part_u4;
    // zc = rows . (W_in[:, C + c0 ..] or W1[:, c0 ..]), 4 tiles of 8 columns
    float zc[TAIL_NTC][4];
#pragma unroll
    for (int j = 0; j < TAIL_NTC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) zc[j][e] = 0.f;
#pragma unroll
    for (int kt = 0; kt < NT; ++kt) {  // unrolled: the k-tiles' chains interleave
      if (kt >= nt) break;
      uint32_t ah[4], al[4];
      rows_frag(rw, lr, 8 * kt, ah, al);
#pragma unroll
      for (int j = 0; j < TAIL_NTC; ++j) frag_mma(zc[j], ah, al, wa[(kt * TAIL_NTC + j) * 32]);
    }
    if (more) {
      store_part(k + 1, 1, st);
      load_part(k + 1, 0, st);
    }
    // pass 1: silu(z) h; pass 2: silu(zc + b1) m2.  Then acc += that W_out or W2
#pragma unroll
    for (int j = 0; j < TAIL_NTC; ++j) {
      unsigned keep = 0xFu;  // bit 2 hf + e
      if (ffn && dr.on)
        keep = pair_keep_bits(dr, M2, c0 + 8 * j, ma.x, ma.y, mb.x, mb.y);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const long long g = hf ? gb : ga;
        const bool live = g < nrows;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c0 + 8 * j + 2 * t + e;
          float& v = zc[j][2 * hf + e];
          if (!ffn) {
            v = live && c < C ? silu_t(v) * h[(size_t)g * C + c] : 0.f;
          } else {
            const float mk = (keep >> (2 * hf + e)) & 1u ? (dr.on ? dr.scale : 1.f) : 0.f;
            v = live && c < F ? silu_t(v + __ldg(p.b1 + c)) * mk : 0.f;
          }
        }
      }
      uint32_t hi[4], lo[4];
      split_c_as_a(zc[j], hi, lo);  // depth t: column 2 t, depth t + 4: column 2 t + 1
#pragma unroll
      for (int jn = 0; jn < NT; ++jn)
        if (jn < nt) frag_mma(acc[jn], hi, lo, wb[(j * nt + jn) * 32]);
    }
    if (k == nc1 - 1) {
      // r1 = LN1(m1 y + x) over the warp's rows (and the output without the FFN)
      __syncwarp();
      tail_ln_rows<LAST, NT>(acc, nullptr, dr, M1, rw, lr, p.ln1_s, p.ln1_b,
                             use_ffn ? (Tin*)nullptr : out, g0, nrows, T, D);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    }
    if (more) store_part(k + 1, 0, st);
    __syncthreads();
  }
  if (use_ffn)
    tail_ln_rows<LAST, NT>(acc, p.b2, dr, M3, rw, lr, p.ln2_s, p.ln2_b, out, g0, nrows, T, D);
}

template <typename Tin, bool LAST, int NT>
inline cudaError_t launch_tail_nt(const Tin* x, const int* lens, const float* h, Tin* out,
                                  const LayerParams& p, const Dropout& dr, int B, int T, int D,
                                  int C, int F, int use_ffn, int prologue,
                                  cudaStream_t stream) {
  const size_t sc = tail_smem_bytes(D);
  cudaError_t e = cudaFuncSetAttribute(tail_mma_kernel<Tin, LAST, NT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sc);
  if (e != cudaSuccess) return e;
  const long long nrows = LAST ? (long long)B : (long long)B * T;
  tail_mma_kernel<Tin, LAST, NT>
      <<<(unsigned)((nrows + TAIL_MMA_ROWS - 1) / TAIL_MMA_ROWS), THREADS, sc, stream>>>(
          x, lens, h, out, p, dr, B, T, D, C, F, use_ffn, prologue);
  return cudaGetLastError();
}

// The tail over [B * T] positions (LAST = false) or B last positions.
template <typename Tin, bool LAST>
inline cudaError_t launch_tail(const Tin* x, const int* lens, const float* h, Tin* out,
                               const LayerParams& p, const Dropout& dr, int B, int T, int D,
                               int C, int F, int use_ffn, int prologue, cudaStream_t stream) {
  if (pad16(D) <= 64)
    return launch_tail_nt<Tin, LAST, 8>(x, lens, h, out, p, dr, B, T, D, C, F, use_ffn,
                                        prologue, stream);
  return launch_tail_nt<Tin, LAST, 16>(x, lens, h, out, p, dr, B, T, D, C, F, use_ffn,
                                       prologue, stream);
}

}  // namespace recblr
