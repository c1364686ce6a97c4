// Tensor-core tile helpers for Hopper (sm_90a) through mma.sync: the
// warp-level products m16n8k16 (bf16 operands, fp32 sums) and m16n8k8
// (TF32 operands, fp32 sums), their fragment loads (ldmatrix for bf16 tiles
// in shared memory), the two-term TF32 split and the 3xTF32 product of
// split operands, the fp32 sum of a product tile, and cp.async copies.
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

}  // namespace recblr
