// Tensor-core tile helpers for Hopper (sm_90a) through mma.sync: the
// warp-level products m16n8k16 (bf16 operands, fp32 sums) and m16n8k8
// (TF32 operands, fp32 sums), their fragment loads (ldmatrix for bf16 tiles
// in shared memory), the two-term TF32 split and the 3xTF32 product of
// split operands, the fp32 sum of a product tile, cp.async copies, and the
// 3xTF32 products with guarded loads of the RecBLR layer kernels
// (mm_tc_tiles, mm_tc, mm_tc_add: common_bwd.cuh's backward phases).
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16" and
// "mma.m16n8k8" with .tf32).  In a warp, lane = 4 gid + t (gid = lane / 4,
// t = lane % 4):
//   bf16 A 16x16  a[0]: (gid, 2t..2t+1)  a[1]: (gid+8, 2t..)  a[2]: (gid, 2t+8..)
//                 a[3]: (gid+8, 2t+8..); two bf16 a register, the lower
//                 column in the low half
//   bf16 B 16x8   b[0]: (k 2t..2t+1, n gid)  b[1]: (k 2t+8..2t+9, n gid)
//   tf32 A 16x8   a[0]: (gid, t)  a[1]: (gid+8, t)  a[2]: (gid, t+4)  a[3]: (gid+8, t+4)
//   tf32 B 8x8    b[0]: (k t, n gid)  b[1]: (k t+4, n gid)
//   C 16x8 fp32   c[0], c[1]: (gid, 2t), (gid, 2t+1)  c[2], c[3]: (gid+8, 2t), (gid+8, 2t+1)
// A bf16 C tile pair (columns 0..7 and 8..15) packed to bf16 is the A
// fragment of a product whose depth runs over those 16 columns
// (pack_c_as_a).
#pragma once

#include <cuda_bf16.h>
#include <cstdint>

namespace recblr {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Two floats rounded to bf16 (nearest even) in one register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of a 16 x 16 bf16 operand from the fp32 C fragments of its
// two 16 x 8 halves (columns 0..7 in c0, 8..15 in c1), rounded to bf16.
__device__ __forceinline__ void pack_c_as_a(const float (&c0)[4], const float (&c1)[4],
                                            uint32_t (&a)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Four 8 x 8 bf16 matrices from shared memory: lanes 8i .. 8i + 7 give the
// row addresses (16 bytes each, 16-byte aligned) of matrix i; r[i] is the
// lane's (gid, 2t..2t+1) of matrix i, or with TRANS its (2t..2t+1, gid).
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  if (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(row)));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(row)));
}

// c += a b: 16 x 16 bf16 a, 16 x 8 bf16 b (b[0], b[1]), fp32 c.
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b: 16 x 8 TF32 a, 8 x 8 TF32 b, fp32 c.  The tensor core reads the
// top 19 bits of each operand; pass values that tf32_round made.
__device__ __forceinline__ void mma_tf32_1688(float (&c)[4], const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// v rounded to TF32 (10 mantissa bits, nearest, ties away from zero), as
// fp32 bits with the low 13 bits clear.
__device__ __forceinline__ uint32_t tf32_round(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r & 0xffffe000u;
}

// The two-term TF32 split v = hi + lo + r: hi = tf32(v), lo = tf32(v - hi),
// |r| <= 2^-22 |v| (each rounding keeps 11 significant bits).
__device__ __forceinline__ void tf32_split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_round(v);
  lo = tf32_round(v - __uint_as_float(hi));
}

// tf32_split (hi = tf32(v), lo = tf32(v - hi), rounded to nearest, ties
// away from zero) on the integer pipe: the same bits for every finite v as
// cvt.rna.tf32.f32, without the conversion unit, which the fp32 kernels
// would otherwise keep busy with two conversions a value.
__device__ __forceinline__ uint32_t tf32_bits(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_i(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(v);
  lo = tf32_bits(v - __uint_as_float(hi));
}

// c += a b at fp32 accuracy from TF32 products of the split operands a = ah
// + al, b = bh + bl: al bh + ah bl + ah bh (the lo lo term and what the
// splits leave are below 2^-21 of |a| |b|).  Without BL (b exact in TF32,
// bl = 0) the ah bl product is skipped.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], float bh0, float bh1,
                                           float bl0, float bl1, bool BL = true) {
  mma_tf32_1688(c, al, __float_as_uint(bh0), __float_as_uint(bh1));
  if (BL) mma_tf32_1688(c, ah, __float_as_uint(bl0), __float_as_uint(bl1));
  mma_tf32_1688(c, ah, __float_as_uint(bh0), __float_as_uint(bh1));
}

// acc += c in fp32 (round to nearest).  A tensor core's fp32 sum rounds
// toward zero, a bias that grows with every product added in the same
// accumulator; so each tile's product is summed in a fresh one and added
// here, and long sums round as fp32 FMA sums do.
__device__ __forceinline__ void add_tile(float (&acc)[4], const float (&c)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += c[e];
}

// The split TF32 A fragments (16 x 8, hi and lo) of a product whose depth
// runs over the 8 columns of the C fragment c: depth k = t is column 2t, k =
// t + 4 column 2t + 1, so the B operand's rows are read in that order too.
__device__ __forceinline__ void split_c_as_a(const float (&c)[4], uint32_t (&hi)[4],
                                             uint32_t (&lo)[4]) {
  tf32_split(c[0], hi[0], lo[0]);
  tf32_split(c[2], hi[1], lo[1]);
  tf32_split(c[1], hi[2], lo[2]);
  tf32_split(c[3], hi[3], lo[3]);
}

// 16 bytes from global to shared memory, asynchronously; the bytes past
// src_bytes (0 .. 16) are zero-filled and not read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <bool G>
__device__ __forceinline__ float ld_op(const float* p, int i) {
  if constexpr (G) return __ldg(p + i);
  return p[i];
}

// C(m, n) = sum_{k < K} A(m, k) B(k, n) for m < M, n < N on the tensor
// cores, delivered a warp tile at a time as tile_epi(m0, n0, acc) (the C
// fragments of the 16 MT x 8 NT tile at (m0, n0)).  Both operands are
// split into their two TF32 terms as they are read (split_i) and
// multiplied as 3xTF32 m16n8k8 products (mma_3xtf32), each 8-deep k-tile
// in a fresh accumulator added in fp32 (add_tile: the tensor cores' own
// sum truncates), so the result keeps fp32 accuracy.  A lives in shared
// memory: A(m, k) = a[m * lda + k], or with AT a[k * lda + m] (a weight
// grad, whose depth is the item's rows).  B(k, n) = b[k * ldb + n], in
// shared memory, or with BG in device memory (the layer's weights, read
// through the read-only cache, the next k-tiles' in flight while the
// current one is multiplied).  Nothing outside m < M, k < K, n < N is
// read: a ragged edge reads as zero, so zero operands give exact zeros.
// A warp takes output tiles of 16 MT rows by 8 NT columns in turn and
// keeps a tile's sums in registers over the whole depth.
template <bool AT, bool BG, int MT, int NT, typename TileEpi>
__device__ __forceinline__ void mm_tc_tiles(const float* __restrict__ a, int lda,
                                            const float* __restrict__ b, int ldb, int M, int N,
                                            int K, TileEpi tile_epi) {
  // k-tiles of B in flight: weights come from L2, whose latency is several
  // k-tiles' work; shared memory needs none ahead
  constexpr int PF = BG ? 4 : 1;
  const int lane = threadIdx.x % 32, gid = lane / 4, t = lane % 4;
  const int gm = (M + 16 * MT - 1) / (16 * MT), gn = (N + 8 * NT - 1) / (8 * NT);
  for (int w = threadIdx.x / 32; w < gm * gn; w += blockDim.x / 32) {
    const int m0 = (w / gn) * 16 * MT, n0 = (w % gn) * 8 * NT;
    // the lane's B values of the k-tile at k0: rows k0 + t, k0 + t + 4 of
    // its column in each 8-column tile
    auto load_b = [&](int k0, float (&v)[NT][2]) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + 8 * j + gid;
        v[j][0] = n < N && k0 + t < K ? ld_op<BG>(b, (k0 + t) * ldb + n) : 0.f;
        v[j][1] = n < N && k0 + t + 4 < K ? ld_op<BG>(b, (k0 + t + 4) * ldb + n) : 0.f;
      }
    };
    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    float bq[PF][NT][2];  // a ring of the next PF k-tiles of B
#pragma unroll
    for (int s = 0; s < PF; ++s) load_b(8 * s, bq[s]);
    for (int k0 = 0; k0 < K; k0 += 8 * PF) {
#pragma unroll
      for (int s = 0; s < PF; ++s) {
        const int ka = k0 + 8 * s + t, kb = ka + 4;
        if (ka - t >= K) break;
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int r0 = m0 + 16 * i + gid, r1 = r0 + 8;
          auto av = [&](int r, int k) {
            if (r >= M || k >= K) return 0.f;
            return AT ? a[k * lda + r] : a[r * lda + k];
          };
          split_i(av(r0, ka), ah[i][0], al[i][0]);
          split_i(av(r1, ka), ah[i][1], al[i][1]);
          split_i(av(r0, kb), ah[i][2], al[i][2]);
          split_i(av(r1, kb), ah[i][3], al[i][3]);
        }
        uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          split_i(bq[s][j][0], bh[j][0], bl[j][0]);
          split_i(bq[s][j][1], bh[j][1], bl[j][1]);
        }
        load_b(k0 + 8 * (s + PF), bq[s]);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
            if (m0 + 16 * i < M && n0 + 8 * j < N) {
              float c[4] = {0.f, 0.f, 0.f, 0.f};
              mma_3xtf32(c, ah[i], al[i], __uint_as_float(bh[j][0]), __uint_as_float(bh[j][1]),
                         __uint_as_float(bl[j][0]), __uint_as_float(bl[j][1]));
              add_tile(acc[i][j], c);
            }
      }
    }
    tile_epi(m0, n0, acc);
  }
}

// The (m, n) of element e of C tile (i, j) of a lane's tile at (m0, n0).
__device__ __forceinline__ int frag_m(int m0, int i, int e) {
  return m0 + 16 * i + threadIdx.x % 32 / 4 + (e >= 2 ? 8 : 0);
}
__device__ __forceinline__ int frag_n(int n0, int j, int e) {
  return n0 + 8 * j + 2 * (threadIdx.x % 4) + (e & 1);
}

// A data grad or a forward product: A in shared memory, B a weight in
// device memory, each C(m, n) delivered as epi(m, n, C(m, n)).
template <int MT, int NT, typename Epi>
__device__ __forceinline__ void mm_tc(const float* __restrict__ a, int lda,
                                      const float* __restrict__ w, int ldw, int M, int N, int K,
                                      Epi epi) {
  mm_tc_tiles<false, true, MT, NT>(a, lda, w, ldw, M, N, K,
                                   [&](int m0, int n0, const float (&acc)[MT][NT][4]) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = frag_m(m0, i, e), n = frag_n(n0, j, e);
          if (m < M && n < N) epi(m, n, acc[i][j][e]);
        }
  });
}

// A weight grad: g[m * ldg + n] += C(m, n), with A^T read from shared memory
// and B in shared memory.  A lane reads all its tile's old values before it
// writes any, so a tile costs one round trip to L2, not one an element.
template <int MT, int NT>
__device__ __forceinline__ void mm_tc_add(const float* __restrict__ a, int lda,
                                          const float* __restrict__ b, int ldb, int M, int N,
                                          int K, float* __restrict__ g, int ldg) {
  mm_tc_tiles<true, false, MT, NT>(a, lda, b, ldb, M, N, K,
                                   [&](int m0, int n0, const float (&acc)[MT][NT][4]) {
    float old[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = frag_m(m0, i, e), n = frag_n(n0, j, e);
          old[i][j][e] = m < M && n < N ? g[m * ldg + n] : 0.f;
        }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = frag_m(m0, i, e), n = frag_n(n0, j, e);
          if (m < M && n < N) g[m * ldg + n] = old[i][j][e] + acc[i][j][e];
        }
  });
}

}  // namespace recblr
