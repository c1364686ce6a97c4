// A tensor-core product over shared memory for Hopper (sm_90a, mma.sync):
// the products of the transformer-layer forwards (fused_block.cu,
// fused_block_last.cu, fused_block_sel.cu and attn_common.cuh's
// projection and tail).
//
// mma_mm<RB, BT, MT, NT>(a, lda, b, ldb, M, N, K, epi) delivers
// C(m, n) = sum_k A(m, k) B(k, n) as epi(m, n, C(m, n)) for m < M, n < N.
// Both operands are fp32 in shared memory, as the caller staged them:
//   RB (bf16): m16n8k16 with bf16 operands and fp32 sums.  Each value is
//     rounded to bf16 (nearest even) as its fragment is packed, by the one
//     cvt.rn.bf16x2 the packing takes anyway: the product of the plain
//     version's _mm(rb=True), both operands rounded once, their products
//     exact, the sum in fp32.
//   fp32: m16n8k8 as 3xTF32: each value split by tf32_split as its
//     fragment is loaded, lo hi + hi lo + hi hi (mma_3xtf32), each 8-deep
//     k-tile summed in a fresh accumulator and added in fp32 (add_tile:
//     the tensor cores' own fp32 sum truncates).  One TF32 product would
//     round what the plain fp32 version keeps.
// A warp takes warp tiles of 16 MT rows by 8 NT columns in turn, and keeps
// a tile's MT x NT accumulators in registers for the whole depth; a value
// it reads from shared memory feeds NT (A) or MT (B) products.  In fp32,
// with AS the caller hands A already split (split_tf32: a the hi terms,
// a_lo the lo terms, both at lda): an A value that several warps read is
// split once, not by each of them.
//
// Layouts: A(m, k) = a[m * lda + k]; B(k, n) = b[k * ldb + n] (BT = false)
// or b[n * ldb + k] (BT = true).  K is a multiple of 16; the caller keeps
// rows m < pad16(M), depths k < K and columns n < pad8(N) finite, and zero
// wherever the other operand holds no value (the padding of a ragged
// width).  Row strides: ld_k for a k-contiguous array (A, and B with BT),
// ld_n for an n-contiguous one (B without BT); with them a warp's fragment
// loads hit 32 distinct banks.
#pragma once

#include <cstdint>

#include "gemm_tile.cuh"
#include "mma_tile.cuh"

namespace recblr {

__host__ __device__ __forceinline__ int pad16(int v) { return (v + 15) / 16 * 16; }

// The least stride >= pad16(width) that is r modulo 32 floats.
__host__ __device__ __forceinline__ int ld_mod32(int width, int r) {
  const int w = pad16(width);
  return w + ((r - w % 32) % 32 + 32) % 32;
}
// fp32 fragments read 4 lanes along k and 8 rows (k-contiguous: 4 mod 32)
// or 4 rows along k and 8 lanes along n (n-contiguous: 8 mod 32); bf16
// fragments read 8-byte pairs along k (8 mod 32) or two rows 2t, 2t + 1
// (4 mod 32).
template <bool RB>
__host__ __device__ __forceinline__ int ld_k(int width) { return ld_mod32(width, RB ? 8 : 4); }
template <bool RB>
__host__ __device__ __forceinline__ int ld_n(int width) { return ld_mod32(width, RB ? 4 : 8); }

// hi[r * ld + c], lo[r * ld + c] = tf32_split(v[r * ld + c]) for r < rows,
// c < cols (hi may be v itself).
__device__ __forceinline__ void split_tf32(const float* v, float* hi, float* lo, int ld,
                                           int rows, int cols) {
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int o = (i / cols) * ld + i % cols;
    uint32_t h, l;
    tf32_split(v[o], h, l);
    hi[o] = __uint_as_float(h);
    lo[o] = __uint_as_float(l);
  }
}

template <bool RB, bool BT, int MT, int NT, bool AS = false, typename Epi>
__device__ __forceinline__ void mma_mm(const float* __restrict__ a, int lda,
                                       const float* __restrict__ b, int ldb, int M, int N,
                                       int K, Epi epi, const float* __restrict__ a_lo = nullptr) {
  static_assert(!(RB && AS), "a split A is an fp32 operand");
  const int lane = threadIdx.x % 32, gid = lane / 4, t = lane % 4;
  const int gm = (M + 16 * MT - 1) / (16 * MT), gn = (N + 8 * NT - 1) / (8 * NT);
  for (int w = threadIdx.x / 32; w < gm * gn; w += blockDim.x / 32) {
    const int m0 = (w / gn) * 16 * MT, n0 = (w % gn) * 8 * NT;
    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    for (int k0 = 0; k0 < K; k0 += 16) {
      if constexpr (RB) {
        uint32_t af[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          if (m0 + 16 * i >= M) continue;
          const float* p = a + (size_t)(m0 + 16 * i + gid) * lda + k0 + 2 * t;
          const float2 v0 = *reinterpret_cast<const float2*>(p);
          const float2 v1 = *reinterpret_cast<const float2*>(p + 8 * lda);
          const float2 v2 = *reinterpret_cast<const float2*>(p + 8);
          const float2 v3 = *reinterpret_cast<const float2*>(p + 8 * lda + 8);
          af[i][0] = pack_bf16(v0.x, v0.y);
          af[i][1] = pack_bf16(v1.x, v1.y);
          af[i][2] = pack_bf16(v2.x, v2.y);
          af[i][3] = pack_bf16(v3.x, v3.y);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (n0 + 8 * j >= N) continue;
          const int n = n0 + 8 * j + gid;
          uint32_t b0, b1;
          if constexpr (BT) {
            const float* q = b + (size_t)n * ldb + k0 + 2 * t;
            const float2 u0 = *reinterpret_cast<const float2*>(q);
            const float2 u1 = *reinterpret_cast<const float2*>(q + 8);
            b0 = pack_bf16(u0.x, u0.y);
            b1 = pack_bf16(u1.x, u1.y);
          } else {
            const float* q = b + (size_t)(k0 + 2 * t) * ldb + n;
            b0 = pack_bf16(q[0], q[ldb]);
            b1 = pack_bf16(q[8 * ldb], q[9 * ldb]);
          }
#pragma unroll
          for (int i = 0; i < MT; ++i)
            if (m0 + 16 * i < M) mma_bf16_16816(acc[i][j], af[i], b0, b1);
        }
      } else {
#pragma unroll
        for (int kk = k0; kk < k0 + 16; kk += 8) {
          uint32_t ah[MT][4], al[MT][4];
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            if (m0 + 16 * i >= M) continue;
            const size_t o = (size_t)(m0 + 16 * i + gid) * lda + kk + t;
            const size_t os[4] = {o, o + 8 * lda, o + 4, o + 8 * lda + 4};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              if constexpr (AS) {
                ah[i][q] = __float_as_uint(a[os[q]]);
                al[i][q] = __float_as_uint(a_lo[os[q]]);
              } else {
                tf32_split(a[os[q]], ah[i][q], al[i][q]);
              }
            }
          }
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            if (n0 + 8 * j >= N) continue;
            const int n = n0 + 8 * j + gid;
            const float v0 = BT ? b[(size_t)n * ldb + kk + t] : b[(size_t)(kk + t) * ldb + n];
            const float v1 =
                BT ? b[(size_t)n * ldb + kk + t + 4] : b[(size_t)(kk + t + 4) * ldb + n];
            uint32_t bh0, bl0, bh1, bl1;
            tf32_split(v0, bh0, bl0);
            tf32_split(v1, bh1, bl1);
#pragma unroll
            for (int i = 0; i < MT; ++i) {
              if (m0 + 16 * i >= M) continue;
              float c[4] = {0.f, 0.f, 0.f, 0.f};
              mma_3xtf32(c, ah[i], al[i], __uint_as_float(bh0), __uint_as_float(bh1),
                         __uint_as_float(bl0), __uint_as_float(bl1));
              add_tile(acc[i][j], c);
            }
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = m0 + 16 * i + gid + (e >= 2 ? 8 : 0);
          const int n = n0 + 8 * j + 2 * t + (e & 1);
          if (m < M && n < N) epi(m, n, acc[i][j][e]);
        }
  }
}

}  // namespace recblr
