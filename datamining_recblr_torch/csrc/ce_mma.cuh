// The softmax cross-entropy forwards on the tensor cores, shared by the
// whole-table kernel (fused_ce.cu ce_fwd_mma_kernel, fp32 only: its bf16
// forward keeps the FMA kernel, see fused_ce.cu) and the vocab-chunked one
// (fused_ce_chunked.cu cce_fwd_mma_kernel, both precisions): the online
// logsumexp of a block's 128 rows over a run of table tiles, with the
// logits computed through mma.sync (mma_tile.cuh) and never leaving
// registers.  Also the tile sizes and the dispatch on (mm_bf16, D) that
// fused_ce.cu's backward takes.
//
// The products take the plain version's rounding points: with mm_bf16
// x and the table rounded to bf16 (m16n8k16, fp32 sums), otherwise fp32
// x table^T as 3xTF32 (m16n8k8 on the two-term TF32 splits, a b ~ al bh +
// ah bl + ah bh; what it leaves is below 2^-21 of |a| |b| a term).  Each
// 16-deep (bf16) or 8-deep (TF32) k-tile is summed in a fresh accumulator
// and added to the logit in fp32 (add_tile): a tensor core's own fp32 sum
// truncates, a bias that grows with the depth.
//
// Block: 256 threads, 8 warps of 16 rows.  x's rows are read once: with
// mm_bf16 rounded and packed into each warp's A fragments (registers, for
// every tile), otherwise kept in shared memory in fp32 and split as each A
// fragment is read.  Each table tile (MmaTile<DP>::ROWS rows of D floats,
// a contiguous run) is copied by cp.async one tile ahead and converted once
// in shared memory: to bf16 (ldmatrix B fragments), or to its TF32 hi and
// lo planes.  A lane holds the logits of its rows r0 = 16 w + gid and r0 + 8
// (gid = lane / 4) at the tile's columns 8 j + 2 t4 (+1) (t4 = lane % 4),
// adds the bias (-1e30 at columns >= valid_v, -inf beyond V) and updates
// its online (max, sum of exp) of each row: the sum rescaled when the
// tile's max exceeds the running one, then the tile's exps added in
// column order.  The caller merges the four lanes of a row (ce_quad_merge,
// a fixed butterfly): every sum runs in a fixed order, the same bits from
// run to run.
#pragma once

#include <cstdint>
#include <type_traits>

#include "ce_common.cuh"
#include "mma_tile.cuh"

namespace recblr {

constexpr int CE_MMA_THREADS = 256;  // 8 warps
constexpr int CE_MMA_BM = 128;       // rows of a block, 16 a warp

// D padded to DP = 64, 128 or 256 columns (zeros beyond D).  A table tile
// holds 4,096 elements: 64, 32 or 16 rows.  fp32 rows take a stride of DP
// + 4 floats (the TF32 fragment loads of a warp hit 32 distinct banks),
// bf16 rows DP + 8 (the 8 rows of an ldmatrix matrix hit 8 distinct
// 16-byte bank groups).
inline int mma_dp(int D) { return D <= 64 ? 64 : D <= 128 ? 128 : 256; }
template <int DP>
struct MmaTile {
  static constexpr int ROWS = 4096 / DP;
  static constexpr int XS = DP + 4;
  static constexpr int BS = DP + 8;
};

// f(MM, DP) for mm_bf16 and mma_dp(D) (at most MAXDP), each as a
// std::integral_constant.
template <int MAXDP = 256, typename F>
auto mma_dispatch(int mm_bf16, int D, F f) {
  auto by_dp = [&](auto mm) {
    const int dp = mma_dp(D);
    if constexpr (MAXDP > 128)
      if (dp == 256) return f(mm, std::integral_constant<int, 256>{});
    if (dp == 128) return f(mm, std::integral_constant<int, 128>{});
    return f(mm, std::integral_constant<int, 64>{});
  };
  return mm_bf16 ? by_dp(std::true_type{}) : by_dp(std::false_type{});
}

__device__ __forceinline__ float ld_x(const void* x, int xbf, size_t i) {
  return xbf ? __bfloat162float(static_cast<const __nv_bfloat16*>(x)[i])
             : static_cast<const float*>(x)[i];
}

// The bias of vocab row col: -1e30 at col >= valid_v, -inf beyond V (g 0).
__device__ __forceinline__ float mma_col_bias(const float* bias, int col, int V, int valid_v) {
  return col < valid_v ? __ldg(bias + col) : (col < V ? CE_NEG : -INFINITY);
}

// s += a b (m16n8k16, bf16 operands) through a fresh accumulator: the
// logits' sum over D rounds as an fp32 sum does.
__device__ __forceinline__ void mma_bf16_add(float (&s)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  mma_bf16_16816(c, a, b0, b1);
  add_tile(s, c);
}

// Dynamic shared memory of ce_fwd_mma_tiles.
template <bool MM, int DP>
constexpr size_t ce_fwd_mma_smem() {
  using S = MmaTile<DP>;
  return sizeof(float) * (2 * (size_t)S::ROWS * DP + S::ROWS
                          + (MM ? 0 : (size_t)(CE_MMA_BM + 2 * S::ROWS) * S::XS))
         + (MM ? sizeof(__nv_bfloat16) * (size_t)S::ROWS * S::BS : 0);
}

// The lane's online logsumexp state (m[h], s[h]) of row n0 + 16 w + gid +
// 8 h over its columns of the table tiles vt0 .. vt_end - 1, and tl[h] the
// logit of target tg[h] when it lies among them (-1: none; tl stays 0).
// x: [N, D] fp32 (xbf 0) or bf16; tab: [V, D] fp32, 16-byte aligned.
template <bool MM, int DP>
__device__ __forceinline__ void ce_fwd_mma_tiles(const void* __restrict__ x, int xbf,
                                                 const float* __restrict__ tab,
                                                 const float* __restrict__ bias,
                                                 const int (&tg)[2], int N, int V, int D,
                                                 int valid_v, int n0, int vt0, int vt_end,
                                                 float* smem, float (&m)[2], float (&s)[2],
                                                 float (&tl)[2]) {
  using S = MmaTile<DP>;
  constexpr int BV = S::ROWS, XS = S::XS, BS = S::BS, NT = BV / 8;
  float* stage = smem;              // [2][BV * D] table tiles as copied
  float* cb = stage + 2 * BV * DP;  // [BV] the tile's bias (mma_col_bias)
  float* xs = cb + BV;              // fp32: [BM][XS] x rows
  float* th = xs + (MM ? 0 : CE_MMA_BM * XS);  // fp32: [BV][XS] the tile's tf32 hi
  float* tlo = th + (MM ? 0 : BV * XS);        // fp32: [BV][XS] its tf32 lo
  __nv_bfloat16* tb = reinterpret_cast<__nv_bfloat16*>(tlo + (MM ? 0 : BV * XS));  // MM
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gid = lane / 4, t4 = lane % 4, mi = lane / 8;
  const int r0 = n0 + 16 * warp + gid, r1 = r0 + 8;

  // the table tile vt, a contiguous run of rows, into stage[buf] in 16-byte
  // pieces (zeros beyond V)
  auto copy_tile = [&](int vt, int buf) {
    const long long left = (long long)min(BV, V - vt * BV) * D;
    const float* src = tab + (size_t)vt * BV * D;
    float* dst = stage + buf * BV * DP;
    for (int c = threadIdx.x; c < BV * D / 4; c += CE_MMA_THREADS) {
      const int n = (int)max(0LL, min(4LL, left - 4LL * c));
      cp_async16(dst + 4 * c, n > 0 ? src + 4 * c : tab, 4 * n);
    }
    cp_async_commit();
  };
  if (vt0 < vt_end) copy_tile(vt0, 0);

  // x: with MM the warp's 16 rows of round(x) as A fragments, else fp32
  // rows in shared memory
  uint32_t xa[MM ? DP / 16 : 1][4];
  if constexpr (MM) {
    auto xv = [&](int r, int d) {
      return (r < N && d < D) ? ld_x(x, xbf, (size_t)r * D + d) : 0.f;
    };
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int d = 16 * kk + 2 * t4;
      xa[kk][0] = pack_bf16(xv(r0, d), xv(r0, d + 1));
      xa[kk][1] = pack_bf16(xv(r1, d), xv(r1, d + 1));
      xa[kk][2] = pack_bf16(xv(r0, d + 8), xv(r0, d + 9));
      xa[kk][3] = pack_bf16(xv(r1, d + 8), xv(r1, d + 9));
    }
  } else {
    for (int i = threadIdx.x; i < CE_MMA_BM * DP; i += CE_MMA_THREADS) {
      const int r = i / DP, k = i % DP;
      xs[r * XS + k] = (n0 + r < N && k < D) ? ld_x(x, xbf, (size_t)(n0 + r) * D + k) : 0.f;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m[h] = -INFINITY;
    s[h] = 0.f;
    tl[h] = 0.f;
  }

  for (int vt = vt0; vt < vt_end; ++vt) {
    const int buf = (vt - vt0) & 1, v0 = vt * BV;
    cp_async_wait_all();
    __syncthreads();  // the tile landed for every thread; the previous one is consumed
    const float* st = stage + buf * BV * DP;
    if constexpr (MM) {
      for (int p = threadIdx.x; p < BV * DP / 2; p += CE_MMA_THREADS) {
        const int r = p / (DP / 2), c = 2 * (p % (DP / 2));
        const float a = c < D ? st[r * D + c] : 0.f;
        const float b = c + 1 < D ? st[r * D + c + 1] : 0.f;
        *reinterpret_cast<uint32_t*>(tb + r * BS + c) = pack_bf16(a, b);
      }
    } else {
      for (int p = threadIdx.x; p < BV * DP; p += CE_MMA_THREADS) {
        const int r = p / DP, c = p % DP;
        uint32_t hi, lo;
        split_i(c < D ? st[r * D + c] : 0.f, hi, lo);
        th[r * XS + c] = __uint_as_float(hi);
        tlo[r * XS + c] = __uint_as_float(lo);
      }
    }
    if (threadIdx.x < BV) cb[threadIdx.x] = mma_col_bias(bias, v0 + threadIdx.x, V, valid_v);
    if (vt + 1 < vt_end) copy_tile(vt + 1, buf ^ 1);
    __syncthreads();

    // the products sc[j]: rows r0 / r1, columns v0 + 8 j + 2 t4 (+1)
    float sc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    if constexpr (MM) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
#pragma unroll
        for (int jp = 0; jp < BV / 16; ++jp) {
          uint32_t b[4];
          ldmatrix_x4<false>(b, tb + (16 * jp + 8 * (mi >> 1) + lane % 8) * BS + 16 * kk
                                    + 8 * (mi & 1));
          mma_bf16_add(sc[2 * jp], xa[kk], b[0], b[1]);
          mma_bf16_add(sc[2 * jp + 1], xa[kk], b[2], b[3]);
        }
    } else {
      const float* xw = xs + (16 * warp + gid) * XS + t4;
#pragma unroll
      for (int k0 = 0; k0 < DP; k0 += 8) {
        uint32_t ah[4], al[4];
        split_i(xw[k0], ah[0], al[0]);
        split_i(xw[8 * XS + k0], ah[1], al[1]);
        split_i(xw[k0 + 4], ah[2], al[2]);
        split_i(xw[8 * XS + k0 + 4], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int o = (8 * j + gid) * XS + k0 + t4;
          float c[4] = {0.f, 0.f, 0.f, 0.f};
          mma_3xtf32(c, ah, al, th[o], th[o + 4], tlo[o], tlo[o + 4]);
          add_tile(sc[j], c);
        }
      }
    }
    // the logits and the online (max, sum of exp) of each row
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int c = 8 * j + 2 * t4 + q;
          const float l = sc[j][2 * h + q] + cb[c];
          sc[j][2 * h + q] = l;
          tmax = fmaxf(tmax, l);
          if (v0 + c == tg[h]) tl[h] = l;
        }
      if (tmax > m[h]) {
        s[h] *= exp_t(m[h] - tmax);  // 0 while m is -inf (s is 0 then)
        m[h] = tmax;
      }
      if (m[h] == -INFINITY) continue;  // no column below V yet
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) s[h] += exp_t(sc[j][2 * h + q] - m[h]);
    }
  }
}

// The four lanes of a fragment row (t4 = 0 .. 3) merge their (m, s) and
// sum their target logits in a fixed butterfly: each lane ends with the
// same bits.
__device__ __forceinline__ void ce_quad_merge(float (&m)[2], float (&s)[2], float (&tl)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, m[h], o);
      const float os = __shfl_xor_sync(0xffffffffu, s[h], o);
      tl[h] += __shfl_xor_sync(0xffffffffu, tl[h], o);
      lse_merge(m[h], s[h], om, os);
    }
}

}  // namespace recblr
