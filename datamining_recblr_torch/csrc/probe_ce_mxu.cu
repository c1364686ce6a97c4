// Probe: how far the whole-table CE kernels (rows 13 and 14) sit from a
// bare bf16 product of their shape.  out = bf16(x) bf16(table)^T in fp32,
// x [N, 64] and table [V, 64] fp32, out [N, V] fp32 written to device
// memory (BERT4Rec's cloze loss: N 81,920, V 3,456).
//
// Replaces the TPU kernel benchmarks/ce_mxu.py: _mm_kernel (through
// pallas_mm's pallas_call), the fused-CE grid of row blocks with the whole
// table resident and every non-matmul pass taken out.
//
// What bounds it: writing out, N V x 4 bytes (1.13 GB at the cloze loss,
// 0.338 ms at 3.35 TB/s), against 2 N V 64 = 36.2 GFLOP (0.037 ms at 989
// TFLOP/s): bytes.  So the design keeps the stores streaming and the
// consumers off device memory:
//   * round_table_kernel rounds the table to bf16 once a call (442 KB at
//     the cloze loss), into the scratch the caller leaves after out;
//   * ce_mm_kernel runs one persistent block a multiprocessor over
//     128 x 128 output tiles, ordered by groups of bn rows (the JAX
//     probe's block height: the rows the walk covers under one table tile
//     before the next), within a group by table tile, then by row tile,
//     and dealt round-robin (tile t to block t mod grid), so that the
//     tiles in flight at a time are neighbours: the whole card writes one
//     compact region of out at a time.  (Blocks given contiguous shares of
//     the walk wrote 132 regions far apart and lost up to a quarter of the
//     write rate at bn >= 256.)  A block's consecutive tiles lie a grid
//     apart in the walk, so it loads x's row tile and the table tile for
//     nearly every tile, from L2 (48 KB against 64 KB written); bn sets
//     the shape of the region the card writes at a time;
//   * a producer warp brings x's row tile (128 rows x 64 fp32, 32 KB) and
//     each table tile (128 rows x 64 bf16, 16 KB, a ring of two stages) by
//     TMA loads in the 128-byte swizzle, on mbarriers, hinted to stay in
//     L2 (evict_last);
//   * two consumer warpgroups take 64 rows each: they read their x
//     fragments from shared memory once a row tile, rounded to bf16 in
//     registers (then the buffer is free for the next row tile), the A
//     operand of four wgmma m64n128k16 (wgmma.cuh) against the table
//     tile, summed in one fp32 accumulator (64 products of bf16 values:
//     exact products, a sum the tolerance of the smoke bounds);
//   * each warpgroup stages its 64 x 128 fp32 tile in shared memory (four
//     32-column boxes, 128-byte swizzle: conflict-free 8-byte stores) and
//     one thread writes it by four TMA tensor stores hinted evict_first,
//     so that the output stream does not push x and the table out of L2;
//     a ring of two such buffers a warpgroup lets a tile's stores run under
//     the next tile's products, and the edges past N and V are clipped and
//     zero-filled by the TMA unit.
// (Loaded by the consumers' own loads, one tile ahead, x held the call far
// from the same kernel without those loads; the products cost nothing.)
//
// C interface (loaded with ctypes): returns a cudaError_t, 0 on success.
#include "wgmma.cuh"

using namespace recblr;

namespace {

constexpr int MX_D = 64;             // the product's depth
constexpr int MX_BM = 128;           // rows of an output tile (two warpgroups of 64)
constexpr int MX_BV = 128;           // table rows (output columns) of a tile
constexpr int MX_WG = 2;             // consumer warpgroups
constexpr int MX_STAGES = 2;         // table tiles in flight
constexpr int MX_BOX = 32;           // fp32 columns of a 128-byte box (x's and out's)
constexpr int MX_THREADS = 128 * MX_WG + 32;  // and one producer warp
constexpr uint32_t MX_A_BYTES = MX_BM * MX_D * 4;        // a row tile of x, fp32
constexpr uint32_t MX_B_BYTES = MX_BV * MX_D * 2;        // a table tile, bf16
constexpr uint32_t MX_OUT_BYTES = 64 * MX_BV * 4;        // a warpgroup's output tile
constexpr uint32_t MX_B0 = MX_A_BYTES;                   // the table ring after x's tile
constexpr uint32_t MX_OUT0 = MX_B0 + MX_STAGES * MX_B_BYTES;  // then the staging
constexpr uint32_t MX_BAR0 = MX_OUT0 + MX_WG * 2 * MX_OUT_BYTES;
constexpr size_t MX_SMEM = 1024 + MX_BAR0 + 8 * (2 + 2 * MX_STAGES);  // 1 KB of alignment slack

// The walk over output tiles: groups of R = bn / 128 row tiles (the last
// group may be shorter), within a group table tile ct outer, row tile rt
// inner.
struct Walk {
  int nrt, nct, R, groups, last_r;
  __host__ __device__ Walk(int N, int V, int bn)
      : nrt((N + MX_BM - 1) / MX_BM), nct((V + MX_BV - 1) / MX_BV), R(bn / MX_BM),
        groups((nrt + R - 1) / R), last_r(nrt - (groups - 1) * R) {}
  __host__ __device__ long long tiles() const { return (long long)nrt * nct; }
  __device__ void tile(long long t, int& rt, int& ct) const {
    const long long per = (long long)R * nct;
    const int g = static_cast<int>(t / per);
    const int rg = g == groups - 1 ? last_r : R;
    const int rem = static_cast<int>(t - g * per);
    ct = rem / rg;
    rt = g * R + rem % rg;
  }
};

// The table rounded to bf16 (nearest even), four values a thread.
__global__ void round_table_kernel(const float4* __restrict__ tab, uint2* __restrict__ out,
                                   int n4) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += gridDim.x * blockDim.x) {
    const float4 v = __ldg(tab + i);
    out[i] = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
}

// A warpgroup's A fragments (wgmma.cuh, bf16 m64k16) from the x tile in
// shared memory: fp32 rows of two 32-column 128-byte-swizzled boxes, the
// lane's rows r and r + 8, rounded to bf16.
__device__ __forceinline__ void x_frags(uint32_t (&a)[MX_D / 16][4], const float* __restrict__ xs,
                                        int r, int t) {
#pragma unroll
  for (int kk = 0; kk < MX_D / 16; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 16 * kk + 8 * h + 2 * t;
      const float* box = xs + (c / MX_BOX) * (MX_BM * MX_BOX) + c % 4;
      const int chunk = (c % MX_BOX) / 4;
      const float2 lo = *reinterpret_cast<const float2*>(box + sw128_offset(r, chunk) / 4);
      const float2 hi = *reinterpret_cast<const float2*>(box + sw128_offset(r + 8, chunk) / 4);
      a[kk][2 * h] = pack_bf16(lo.x, lo.y);
      a[kk][2 * h + 1] = pack_bf16(hi.x, hi.y);
    }
}

__global__ void __launch_bounds__(MX_THREADS, 1)
ce_mm_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_tab,
             const __grid_constant__ CUtensorMap tm_out, int N, int V, int bn) {
  extern __shared__ uint8_t mx_raw[];
  const uint32_t raw = smem_addr(mx_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzled tiles' 1 KB alignment
  uint8_t* sm = mx_raw + (base - raw);
  // barriers: x's tile full / empty, then each table stage's full / empty
  const uint32_t a_full = base + MX_BAR0, a_empty = a_full + 8;
  const uint32_t b_full0 = a_full + 16, b_empty0 = b_full0 + 8 * MX_STAGES;
  if (threadIdx.x == 0) {
    mbar_init(a_full, 1);       // the producer's arrival and the tile's bytes
    mbar_init(a_empty, MX_WG);  // one arrival a consumer warpgroup
    for (int s = 0; s < MX_STAGES; ++s) {
      mbar_init(b_full0 + 8 * s, 1);
      mbar_init(b_empty0 + 8 * s, MX_WG);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const Walk walk(N, V, bn);
  const long long T = walk.tiles();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 4 * MX_WG) {
    // producer: x's row tile whenever the walk's row tile changes, a table
    // tile into the next stage whenever its column changes; both kept in L2
    if (lane == 0) {
      const uint64_t keep = l2_evict_last();
      int cur_r = -1, cur_c = -1, fills_a = 0, fills_b = 0;
      for (long long t = blockIdx.x; t < T; t += gridDim.x) {
        int rt, ct;
        walk.tile(t, rt, ct);
        if (rt != cur_r) {
          cur_r = rt;
          if (fills_a > 0) mbar_wait(a_empty, (fills_a - 1) & 1);
          mbar_expect_tx(a_full, MX_A_BYTES);
          for (int b = 0; b < MX_D / MX_BOX; ++b)
            tma_load_2d(base + b * (MX_BM * MX_BOX * 4), &tm_x, MX_BOX * b, rt * MX_BM, a_full,
                        keep);
          ++fills_a;
        }
        if (ct != cur_c) {
          cur_c = ct;
          const int s = fills_b % MX_STAGES, k = fills_b / MX_STAGES;
          if (k > 0) mbar_wait(b_empty0 + 8 * s, (k - 1) & 1);
          mbar_expect_tx(b_full0 + 8 * s, MX_B_BYTES);
          tma_load_2d(base + MX_B0 + s * MX_B_BYTES, &tm_tab, 0, ct * MX_BV, b_full0 + 8 * s,
                      keep);
          ++fills_b;
        }
      }
    }
    return;
  }
  const int wg = warp / 4, wt = threadIdx.x % 128, gid = lane / 4, t4 = lane % 4;
  const int wrow = 16 * (warp % 4);  // the warp's rows in its warpgroup's 64
  const float* xs = reinterpret_cast<const float*>(sm);
  float* stage_out = reinterpret_cast<float*>(sm + MX_OUT0 + wg * 2 * MX_OUT_BYTES);
  const uint32_t stage_out_s = base + MX_OUT0 + wg * 2 * MX_OUT_BYTES;
  const uint64_t stream = l2_evict_first();  // out is written once
  uint32_t a[MX_D / 16][4];
  int cur_r = -1, cur_c = -1, uses_a = 0, uses_b = 0, s = 0, buf = 0;
  for (long long t = blockIdx.x; t < T; t += gridDim.x) {
    int rt, ct;
    walk.tile(t, rt, ct);
    if (rt != cur_r) {  // this row tile's x into registers, then free the buffer
      mbar_wait(a_full, uses_a & 1);
      x_frags(a, xs, 64 * wg + wrow + gid, t4);
      ++uses_a;
      cur_r = rt;
      named_barrier(1 + wg, 128);
      if (wt == 0) mbar_arrive(a_empty);
    }
    if (ct != cur_c) {  // release the last table tile, wait for this one
      if (cur_c >= 0 && wt == 0) mbar_arrive(b_empty0 + 8 * s);
      s = uses_b % MX_STAGES;
      mbar_wait(b_full0 + 8 * s, (uses_b / MX_STAGES) & 1);
      ++uses_b;
      cur_c = ct;
    }
    float acc[64];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < MX_D / 16; ++kk)
      wgmma_m64n128k16_bf16(acc, a[kk], sw128_desc(base + MX_B0 + s * MX_B_BYTES + 32 * kk),
                            kk > 0);
    wg_commit();
    wg_wait<0>();
    // epilogue: the buffer of two tiles ago is free once its stores have read it
    if (wt == 0) bulk_wait_read<1>();
    named_barrier(1 + wg, 128);
    float* o = stage_out + buf * (MX_OUT_BYTES / 4);
#pragma unroll
    for (int j = 0; j < MX_BV / 8; ++j) {
      // column 8 j + 2 t4 sits in box j / 4, chunk 2 (j % 4) + t4 / 2 of its
      // 128-byte row (conflict-free: the swizzle spreads the 8 rows)
      float* box = o + (j / 4) * (64 * MX_BOX) + 2 * (t4 & 1);
      const int chunk = 2 * (j % 4) + t4 / 2;
      *reinterpret_cast<float2*>(box + sw128_offset(wrow + gid, chunk) / 4) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(box + sw128_offset(wrow + gid + 8, chunk) / 4) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    if (wt == 0) {
      const int n0 = rt * MX_BM + 64 * wg, v0 = ct * MX_BV;
      if (n0 < N)
        for (int b = 0; b < MX_BV / MX_BOX && v0 + MX_BOX * b < V; ++b)
          tma_store_2d(&tm_out, v0 + MX_BOX * b, n0,
                       stage_out_s + buf * MX_OUT_BYTES + b * (64 * MX_BOX * 4), stream);
      bulk_commit();
    }
    buf ^= 1;
  }
  if (wt == 0) bulk_wait_all();
}

}  // namespace

extern "C" {

// x [N, 64], table [V, 64]: fp32; out: [N, V] fp32 followed by V x 64 bf16
// of scratch (the rounded table), 16-byte aligned, V a multiple of 4; bn:
// 128, 256, 512, 1,024 or 2,048; blocks: the persistent grid (at most one
// block a multiprocessor fits).
int recblr_probe_ce_mm(const void* x, const void* table, void* out, int N, int V, int bn,
                       int blocks, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (N < 1 || V < 4 || V % 4 || blocks < 1) return cudaErrorInvalidValue;
  if (bn != 128 && bn != 256 && bn != 512 && bn != 1024 && bn != 2048)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  __nv_bfloat16* tab16 = reinterpret_cast<__nv_bfloat16*>(o + (size_t)N * V);
  const int n4 = V * MX_D / 4;
  round_table_kernel<<<(n4 + 255) / 256, 256, 0, st>>>(static_cast<const float4*>(table),
                                                       reinterpret_cast<uint2*>(tab16), n4);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  CUtensorMap tm_x, tm_tab, tm_out;
  e = make_tensor_map_2d(&tm_x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x, N, MX_D, MX_D * 4, MX_BM,
                         MX_BOX);
  if (e != cudaSuccess) return e;
  e = make_tensor_map_2d(&tm_tab, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, tab16, V, MX_D, MX_D * 2,
                         MX_BV, MX_D);
  if (e != cudaSuccess) return e;
  e = make_tensor_map_2d(&tm_out, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, o, N, V, (uint64_t)V * 4, 64,
                         MX_BOX);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(ce_mm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)MX_SMEM);
  if (e != cudaSuccess) return e;
  const long long tiles = Walk(N, V, bn).tiles();
  const int grid = static_cast<int>(tiles < blocks ? tiles : blocks);  // round-robin over tiles
  ce_mm_kernel<<<grid, MX_THREADS, MX_SMEM, st>>>(tm_x, tm_tab, tm_out, N, V, bn);
  return cudaGetLastError();
}

const char* recblr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
