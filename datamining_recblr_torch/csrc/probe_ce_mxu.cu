// Probe: how far the whole-table CE kernels (rows 13 and 14) sit from a
// bare bf16 product of their shape.  out = bf16(x) bf16(table)^T in fp32,
// x [N, 64] and table [V, 64] fp32, out [N, V] fp32 written to device
// memory (BERT4Rec's cloze loss: N 81,920, V 3,456).
//
// Replaces the TPU kernel benchmarks/ce_mxu.py: _mm_kernel (through
// pallas_mm's pallas_call), the fused-CE grid of row blocks with the whole
// table resident and every non-matmul pass taken out.
//
// The table (442 KB in bf16) does not fit in shared memory, so it streams:
// a block holds its bn rows of x, rounded to bf16, in shared memory for the
// whole call, and walks its share of the table in 64-row tiles.  Each tile
// is read into registers one tile ahead (fp32, as the kernel's caller holds
// it), rounded to bf16 into shared memory, and multiplied by every warp's
// 16-row tiles of x on mma.sync m16n8k16 (mma_tile.cuh mma_bf16_16816;
// ldmatrix fragments; the tile's B fragments loaded once a warp), each
// 16-deep step in a fresh accumulator added in fp32 as the port's CE
// kernels do.  bn is the block's row height: 128, 256, 512 or 1,024 rows
// (x's rows take 144 bytes each with the padding that keeps ldmatrix free
// of bank conflicts; 2,048 rows would take 295 KB, beyond the 227 KB a
// block may use).  When the row blocks are fewer than two a multiprocessor,
// the table is split across blocks too (vsplit), so that every height fills
// the card.
//
// What bounds it: writing out, N V x 4 bytes (1.13 GB at the cloze loss,
// 0.338 ms at 3.35 TB/s), against 2 N V 64 = 36.2 GFLOP (0.037 ms at 989
// TFLOP/s): bytes.  Each lane stores its C fragments' column pairs (8
// bytes), a warp's store whole 32-byte sectors.
//
// C interface (loaded with ctypes): returns a cudaError_t, 0 on success.
#include "common.cuh"
#include "mma_tile.cuh"

using namespace recblr;

namespace {

constexpr int MX_D = 64;             // the product's depth
constexpr int MX_VT = 64;            // table rows a tile
constexpr int MX_WARPS = 8;
constexpr int MX_THREADS = 32 * MX_WARPS;
constexpr int MX_LD = MX_D + 8;      // bf16 row stride in shared memory
constexpr int MX_TILE_F4 = MX_VT * MX_D / 4 / MX_THREADS;  // float4 a thread a tile

__host__ __device__ constexpr size_t mx_smem(int bn) {
  return sizeof(__nv_bfloat16) * (size_t)(bn + MX_VT) * MX_LD;
}

__device__ __forceinline__ void store_bf16x4(__nv_bfloat16* dst, float4 v) {
  uint2 u;
  u.x = pack_bf16(v.x, v.y);
  u.y = pack_bf16(v.z, v.w);
  *reinterpret_cast<uint2*>(dst) = u;
}

__device__ __forceinline__ void mma_bf16_fresh(float (&s)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  mma_bf16_16816(c, a, b0, b1);
  add_tile(s, c);
}

__global__ void __launch_bounds__(MX_THREADS)
ce_mm_kernel(const float* __restrict__ x, const float* __restrict__ tab,
             float* __restrict__ out, int N, int V, int bn, int tiles_per_block) {
  extern __shared__ __align__(16) __nv_bfloat16 mx_smem_buf[];
  __nv_bfloat16* xs = mx_smem_buf;
  __nv_bfloat16* ts = mx_smem_buf + (size_t)bn * MX_LD;
  const int row0 = blockIdx.x * bn;
  const int ntiles = (V + MX_VT - 1) / MX_VT;
  const int vt0 = blockIdx.y * tiles_per_block;
  const int vt1 = min(ntiles, vt0 + tiles_per_block);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, gid = lane / 4, t = lane % 4;
  const int mi = lane / 8;
  // x's rows, rounded to bf16; rows past N are zero
  for (int i = threadIdx.x; i < bn * (MX_D / 4); i += MX_THREADS) {
    const int r = i / (MX_D / 4), q = i % (MX_D / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < N)
      v = __ldg(reinterpret_cast<const float4*>(x + (size_t)(row0 + r) * MX_D) + q);
    store_bf16x4(xs + r * MX_LD + 4 * q, v);
  }
  float4 pre[MX_TILE_F4];
  auto load_tile = [&](int vt) {
#pragma unroll
    for (int u = 0; u < MX_TILE_F4; ++u) {
      const int i = threadIdx.x + u * MX_THREADS;
      const int r = vt * MX_VT + i / (MX_D / 4), q = i % (MX_D / 4);
      pre[u] = r < V ? __ldg(reinterpret_cast<const float4*>(tab + (size_t)r * MX_D) + q)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  if (vt0 < vt1) load_tile(vt0);
  for (int vt = vt0; vt < vt1; ++vt) {
    __syncthreads();  // the last tile's fragments are read (and, at first, x is staged)
#pragma unroll
    for (int u = 0; u < MX_TILE_F4; ++u) {
      const int i = threadIdx.x + u * MX_THREADS;
      store_bf16x4(ts + (i / (MX_D / 4)) * MX_LD + 4 * (i % (MX_D / 4)), pre[u]);
    }
    __syncthreads();
    if (vt + 1 < vt1) load_tile(vt + 1);  // in flight while this tile is multiplied
    // the tile's B fragments: b[jp][kk] covers n-tiles 2 jp, 2 jp + 1 at depth 16 kk
    uint32_t b[MX_VT / 16][MX_D / 16][4];
#pragma unroll
    for (int jp = 0; jp < MX_VT / 16; ++jp)
#pragma unroll
      for (int kk = 0; kk < MX_D / 16; ++kk)
        ldmatrix_x4<false>(b[jp][kk],
                           ts + (16 * jp + 8 * (mi >> 1) + lane % 8) * MX_LD + 16 * kk
                               + 8 * (mi & 1));
    const int col0 = vt * MX_VT;
    for (int m = warp; m < bn / 16; m += MX_WARPS) {
      uint32_t a[MX_D / 16][4];
#pragma unroll
      for (int kk = 0; kk < MX_D / 16; ++kk)
        ldmatrix_x4<false>(a[kk], xs + (16 * m + lane % 16) * MX_LD + 16 * kk + 8 * (lane / 16));
      float s[MX_VT / 8][4];
#pragma unroll
      for (int j = 0; j < MX_VT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < MX_D / 16; ++kk)
#pragma unroll
        for (int jp = 0; jp < MX_VT / 16; ++jp) {
          mma_bf16_fresh(s[2 * jp], a[kk], b[jp][kk][0], b[jp][kk][1]);
          mma_bf16_fresh(s[2 * jp + 1], a[kk], b[jp][kk][2], b[jp][kk][3]);
        }
      const int r = row0 + 16 * m + gid;
#pragma unroll
      for (int j = 0; j < MX_VT / 8; ++j) {
        const int c = col0 + 8 * j + 2 * t;
        if (c >= V) continue;
        if (r < N)
          __stcs(reinterpret_cast<float2*>(out + (size_t)r * V + c),
                 make_float2(s[j][0], s[j][1]));
        if (r + 8 < N)
          __stcs(reinterpret_cast<float2*>(out + (size_t)(r + 8) * V + c),
                 make_float2(s[j][2], s[j][3]));
      }
    }
  }
}

}  // namespace

extern "C" {

// x [N, 64], table [V, 64], out [N, V]: fp32, V even; bn: 128, 256, 512 or
// 1,024; vsplit: the table's split across blocks (>= 1).
int recblr_probe_ce_mm(const void* x, const void* table, void* out, int N, int V, int bn,
                       int vsplit, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (N < 1 || V < 2 || V % 2 || vsplit < 1) return cudaErrorInvalidValue;
  if (bn != 128 && bn != 256 && bn != 512 && bn != 1024) return cudaErrorInvalidValue;
  const size_t smem = mx_smem(bn);
  e = cudaFuncSetAttribute(ce_mm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int ntiles = (V + MX_VT - 1) / MX_VT;
  const int per = (ntiles + vsplit - 1) / vsplit;
  const dim3 grid((N + bn - 1) / bn, (ntiles + per - 1) / per);
  ce_mm_kernel<<<grid, MX_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(table), static_cast<float*>(out),
      N, V, bn, per);
  return cudaGetLastError();
}

const char* recblr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
