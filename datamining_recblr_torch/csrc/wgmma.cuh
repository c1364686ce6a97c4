// Hopper's asynchronous units for hand-written kernels (sm_90a): warpgroup
// products (wgmma) with B read from shared memory through a matrix
// descriptor and A from registers, the warpgroups' register counts
// (setmaxnreg), the mbarrier, and the Tensor Memory Accelerator (TMA)
// copies between device and shared memory described by a tensor map.  Used
// by the probes' redesigned kernels (probe_ce_mxu.cu: bf16 products, TMA
// loads and stores; probe_unit_overlap.cu: chained 3xTF32 products) and by
// row 13's bf16 forward (fused_ce.cu ce_fwd_wgmma_kernel: bf16 products,
// TMA loads, setmaxnreg); the layer kernels' phases can take the same
// pieces.
//
// Shared-memory operands use the 128-byte swizzle, K-major: a tile is rows
// of 128 bytes (64 bf16 or 32 fp32 of the depth), eight rows an atom of
// 1,024 bytes aligned to 1,024, and the 16-byte chunk c of row r sits at
// chunk c ^ (r % 8) (sw128_offset).  TMA with CU_TENSOR_MAP_SWIZZLE_128B
// writes and reads exactly that layout.  A product step of depth 32 bytes
// (k16 in bf16, k8 in tf32) starts 32 bytes further into the row; rows
// past the first eight are reached at the atom stride (SBO 1,024 bytes).
//
// Register fragments (PTX ISA, "Register Fragments and Shared Memory
// Matrix Layouts" for wgmma), warp w of the warpgroup holding rows 16 w ..
// 16 w + 15, lane = 4 gid + t:
//   A bf16 m64k16  a[0]: (gid, 2t..2t+1)  a[1]: (gid+8, 2t..)  a[2]: (gid, 2t+8..)
//                  a[3]: (gid+8, 2t+8..), two bf16 a register, lower column low
//   A tf32 m64k8   a[0]: (gid, t)  a[1]: (gid+8, t)  a[2]: (gid, t+4)  a[3]: (gid+8, t+4)
//   D fp32 m64nN   d[4j], d[4j+1]: (gid, 8j+2t), (gid, 8j+2t+1)
//                  d[4j+2], d[4j+3]: (gid+8, 8j+2t), (gid+8, 8j+2t+1)
// (the mma.sync m16n8 layouts of mma_tile.cuh, one warp's 16 rows each).
//
// A register operand of an issued wgmma, and its accumulator, are read and
// written asynchronously: they are touched again only after a wait_group
// that covers it, and registers written by other instructions are fenced
// (wg_fence) before a wgmma reads them.  ptxas tracks the registers of
// in-flight wgmma and serializes what it cannot prove safe (a C7515
// "Potential Performance Loss" note in its -v output).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "mma_tile.cuh"

namespace recblr {

// ---------------------------------------------------------------------------
// shared-memory matrix descriptors
// ---------------------------------------------------------------------------

// Byte offset of the 16-byte chunk `chunk` (0..7) of row `row` in a
// 128-byte-swizzled tile.
__host__ __device__ constexpr uint32_t sw128_offset(int row, int chunk) {
  return static_cast<uint32_t>(row) * 128u + static_cast<uint32_t>((chunk ^ (row & 7)) * 16);
}

// The descriptor of a K-major, 128-byte-swizzled operand starting at the
// shared address `saddr` (bits 0-13 the address / 16, 16-29 the leading
// byte offset / 16, unused by this layout, 32-45 the stride between
// eight-row atoms / 16, 62-63 the layout: 1 = 128-byte swizzle).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFFu) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

// ---------------------------------------------------------------------------
// wgmma: fence, groups and the products
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of the warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define RECBLR_WG_D64                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "  \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "   \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "   \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define RECBLR_WG_OUT64(d)                                                                    \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),              \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),           \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),           \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),           \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),           \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),           \
      "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),           \
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),           \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),           \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d (+)= a b: a 64 x 16 bf16 from registers, b 16 x 128 bf16 K-major in
// shared memory (descriptor db), d 64 x 128 fp32; accumulate = false
// overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16_bf16(float (&d)[64], const uint32_t (&a)[4],
                                                      uint64_t db, bool accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " RECBLR_WG_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : RECBLR_WG_OUT64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(static_cast<int>(accumulate)));
}

// d (+)= a b: a 64 x 8 tf32 from registers (fp32 bits, the low 13 clear),
// b 8 x 128 tf32 K-major in shared memory, d 64 x 128 fp32.
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64], const uint32_t (&a)[4],
                                                     uint64_t db, bool accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " RECBLR_WG_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : RECBLR_WG_OUT64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(static_cast<int>(accumulate)));
}

#undef RECBLR_WG_D64
#undef RECBLR_WG_OUT64

// The registers a thread of this warpgroup owns from here on: a producer
// warpgroup gives some back (dec), the consumers take them (inc).  Every
// warp of the warpgroup executes it; the kernel needs __launch_bounds__ so
// that ptxas fixes the count each warp starts with, and the registers
// taken can be no more than those given back.
template <int N>
__device__ __forceinline__ void wg_setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void wg_setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// mbarrier, proxy fences, named barriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Makes initialized barriers visible to the TMA unit; then a block barrier.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Arrive and expect `bytes` of TMA transfers to complete the phase.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity` (a
// barrier starts in phase 0; the phase before it counts as complete).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// Orders this thread's generic-proxy shared-memory writes before later
// async-proxy reads of them (wgmma operands, TMA stores).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier over `threads` threads (a multiple of 32) of the block, id 1-15.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Arrive at the named barrier without waiting: `threads` counts these
// threads and those that wait at it with named_barrier.
__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------------------
// TMA: 2-D tensor copies and their completion
// ---------------------------------------------------------------------------

// L2 eviction policies for the TMA copies' cache hints: evict_first for a
// stream written once (it should not push reused data out of L2),
// evict_last for data read again.
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

// Global -> shared: the box at (c0 inner, c1 outer) of the tensor map `tm`
// (a __grid_constant__ kernel parameter) into `dst`; its bytes complete
// the barrier's transaction count.  Elements outside the tensor read as 0.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* tm, int c0, int c1,
                                            uint32_t bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(c0), "r"(c1), "r"(bar), "l"(policy)
      : "memory");
}

// Shared -> global: `src` into the box at (c0, c1); elements outside the
// tensor are not written.  Tracked by this thread's bulk groups.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* tm, int c0, int c1, uint32_t src,
                                             uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0, {%1, %2}], [%3], %4;\n" ::"l"(reinterpret_cast<uint64_t>(tm)),
      "r"(c0), "r"(c1), "r"(src), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's bulk groups still read their
// shared-memory source.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Wait until every bulk group of this thread has completed its writes.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

// A row-major 2-D tensor map with the 128-byte swizzle: `rows` x `cols`
// elements, a row `row_bytes` apart (a multiple of 16), boxes of box_rows
// x box_cols (box_cols elements <= 128 bytes).  The encoder is the
// driver's cuTensorMapEncodeTiled, reached through the runtime so the
// library links no driver library.  Returns cudaErrorNotSupported without
// it, cudaErrorInvalidValue if it refuses the map.
inline cudaError_t make_tensor_map_2d(CUtensorMap* tm, CUtensorMapDataType dtype,
                                      const void* base, uint64_t rows, uint64_t cols,
                                      uint64_t row_bytes, uint32_t box_rows, uint32_t box_cols) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess || !fn)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = encode(tm, dtype, 2, const_cast<void*>(base), dims, strides, box,
                            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace recblr
