// A register-tiled fp32 product over shared memory: the products of the
// transformer-layer backward kernels (attn_bwd.cuh T' and P',
// fused_block_bwd.cu A').
//
// Each thread owns a TM x TN tile of the output and walks K in steps of
// four: per step it loads TM + TN 16-byte fragments from shared memory and
// does 4 TM TN FMAs from registers, so a value read from shared memory
// feeds TM or TN FMAs.
// The sums run in fp32 in increasing k, as the plain versions' products
// do up to order; no tensor cores (TF32 would round operands the plain
// version keeps).  The caller stages both operands in shared memory,
// rounded to bf16 once where the forward rounds them, and gets each
// output element through `epi(m, n, v)`.
#pragma once

#include "common.cuh"
#include "mma_tile.cuh"  // cp_async_wait_all

namespace recblr {

// Padded sizes: widths rounded up to 8, and a row stride of width + 4
// floats (16-byte rows whose float4 columns fall on different banks from
// one row to the next).
__host__ __device__ __forceinline__ int pad8(int v) { return (v + 7) / 8 * 8; }
__host__ __device__ __forceinline__ int ld_of(int width) { return pad8(width) + 4; }

// Tile t of a gm x gn grid of output tiles -> (tm, tn).  Where the grid
// allows, a warp takes a 4 x 8 block of tiles, so its A and B fragments
// are 4 and 8 distinct 16-byte loads, one shared-memory wavefront each
// (a warp along one row of tiles would read 32 distinct B fragments, and
// the loads, not the FMAs, would bound the product).
__device__ __forceinline__ void tile_coords(int t, int gm, int gn, int& tm, int& tn) {
  if (gm % 4 == 0 && gn % 8 == 0) {
    const int lane = t % 32, w = t / 32, wn = gn / 8;
    tm = (w / wn) * 4 + lane / 8;
    tn = (w % wn) * 8 + lane % 8;
  } else {
    tm = t / gn;
    tn = t % gn;
  }
}

// The TM x TN tile of C(m, n) = sum_k A(m, k) B(k, n) at rows m0 ..
// m0 + TM - 1 and columns col(j) (below); see smem_mm for the layouts.
template <int TM, int TN, bool AT, bool BT>
__device__ __forceinline__ void mm_tile(const float* __restrict__ a, int lda,
                                        const float* __restrict__ b, int ldb, int K, int m0,
                                        int tn, int gn, float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float af[TM][4], bf[4][TN];
    if (AT) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < TM; i += 4) {
          const float4 v = *reinterpret_cast<const float4*>(a + (size_t)(k + kk) * lda + m0 + i);
          af[i][kk] = v.x;
          af[i + 1][kk] = v.y;
          af[i + 2][kk] = v.z;
          af[i + 3][kk] = v.w;
        }
    } else {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(a + (size_t)(m0 + i) * lda + k);
        af[i][0] = v.x;
        af[i][1] = v.y;
        af[i][2] = v.z;
        af[i][3] = v.w;
      }
    }
    if (BT) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(b + (size_t)(tn + j * gn) * ldb + k);
        bf[0][j] = v.x;
        bf[1][j] = v.y;
        bf[2][j] = v.z;
        bf[3][j] = v.w;
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < TN; j += 4) {
          const float4 v =
              *reinterpret_cast<const float4*>(b + (size_t)(k + kk) * ldb + tn * TN + j);
          bf[kk][j] = v.x;
          bf[kk][j + 1] = v.y;
          bf[kk][j + 2] = v.z;
          bf[kk][j + 3] = v.w;
        }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(af[i][kk], bf[kk][j], acc[i][j]);
  }
}

// C(m, n) = sum_k A(m, k) B(k, n) for m < M, n < N, delivered as
// epi(m, n, C(m, n)).  A(m, k) = a[m * lda + k] (AT = false) or
// a[k * lda + m] (AT = true); B(k, n) = b[k * ldb + n] (BT = false) or
// b[n * ldb + k] (BT = true).  Needs M % TM == 0, N % TN == 0, K % 4 == 0,
// 16-byte aligned a and b, lda and ldb multiples of 4 (ld_of for the
// strided sides), TM % 4 == 0 when AT and TN % 4 == 0 unless BT.  With BT
// a thread's columns are tn + j N / TN, so a warp reads consecutive rows
// of b; otherwise tn TN + j, 16 bytes at a time along b's rows.
template <int TM, int TN, bool AT, bool BT, typename Epi>
__device__ __forceinline__ void smem_mm(const float* __restrict__ a, int lda,
                                        const float* __restrict__ b, int ldb, int M, int N,
                                        int K, Epi epi) {
  static_assert(!AT || TM % 4 == 0, "AT loads four rows of A at a time");
  static_assert(BT || TN % 4 == 0, "B's rows are loaded four columns at a time");
  const int gm = M / TM, gn = N / TN;
  for (int tile = threadIdx.x; tile < gm * gn; tile += blockDim.x) {
    int tm, tn;
    tile_coords(tile, gm, gn, tm, tn);
    const int m0 = tm * TM;
    float acc[TM][TN];
    mm_tile<TM, TN, AT, BT>(a, lda, b, ldb, K, m0, tn, gn, acc);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) epi(m0 + i, BT ? tn + j * gn : tn * TN + j, acc[i][j]);
  }
}

// smem_mm whose output is added into device memory: *dst(m, n) += C(m, n)
// where dst(m, n) is not null (a block's own slice of the weight-grad
// partials).  A thread reads its tile's old values before it writes any,
// so each tile costs one round trip to L2, not one an element.
template <int TM, int TN, bool AT, bool BT, typename Dst>
__device__ __forceinline__ void smem_mm_add(const float* __restrict__ a, int lda,
                                            const float* __restrict__ b, int ldb, int M, int N,
                                            int K, Dst dst) {
  const int gm = M / TM, gn = N / TN;
  for (int tile = threadIdx.x; tile < gm * gn; tile += blockDim.x) {
    int tm, tn;
    tile_coords(tile, gm, gn, tm, tn);
    const int m0 = tm * TM;
    float acc[TM][TN], old[TM][TN];
    float* ptr[TM][TN];
    mm_tile<TM, TN, AT, BT>(a, lda, b, ldb, K, m0, tn, gn, acc);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        ptr[i][j] = dst(m0 + i, BT ? tn + j * gn : tn * TN + j);
        old[i][j] = ptr[i][j] ? *ptr[i][j] : 0.f;
      }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (ptr[i][j]) *ptr[i][j] = old[i][j] + acc[i][j];
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// dst[r * ldd + c] = src(r, c) for r < rows, c < cols, rounded to bf16
// when RB; zero for r < rows_pad, c < cols_pad outside that (the padding
// a product reads; cols_pad a multiple of 4).  src(r, c) = src[r * lds +
// c] in device memory.  Every thread's copies are in flight at once
// (cp.async, 16 bytes each where rows are 16-byte aligned); the caller
// synchronises the block before reading dst.  With wait = false (RB
// false) the copies stay in flight: the caller waits (cp_async_wait_all)
// before that synchronisation.
template <bool RB>
__device__ __forceinline__ void stage(float* __restrict__ dst, int ldd,
                                      const float* __restrict__ src, size_t lds, int rows,
                                      int cols, int rows_pad, int cols_pad, bool wait = true) {
  const bool vec = cols % 4 == 0 && lds % 4 == 0 &&
                   (reinterpret_cast<size_t>(src) & 15) == 0;
  const int w = vec ? 4 : 1, cw = cols_pad / w;
  for (int i = threadIdx.x; i < rows_pad * cw; i += blockDim.x) {
    const int r = i / cw, c = (i % cw) * w;
    float* d = dst + r * ldd + c;
    if (r < rows && c < cols) {
      if (vec)
        cp_async16(d, src + r * lds + c);
      else
        cp_async4(d, src + r * lds + c);
    } else {
      for (int q = 0; q < w; ++q) d[q] = 0.f;
    }
  }
  if (wait) cp_async_wait_all();
  if (RB) {  // each thread rounds what it copied
    for (int i = threadIdx.x; i < rows_pad * cw; i += blockDim.x) {
      const int r = i / cw, c = (i % cw) * w;
      if (r < rows && c < cols)
        for (int q = 0; q < w; ++q) dst[r * ldd + c + q] = mm_op<true>(dst[r * ldd + c + q]);
    }
  }
}

}  // namespace recblr
