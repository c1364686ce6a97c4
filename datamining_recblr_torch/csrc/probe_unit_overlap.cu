// Probe: does CUDA-core work hide under a chain of dependent tensor-core
// products on Hopper?  Five chains over [rows, 128] fp32 (rows = grid x
// 1,600, the fused layer kernels' block of 8 rows x T 200):
//   mm_only    nm dependent products y <- y w, w [128, 128]
//   vpu_only   nv dependent steps v <- v a + b, a tanh every 4th step
//   serial     one chain: a product, then nv / nm steps, nm times
//   indep_il   y's products and v's steps, two independent chains,
//              written stage-interleaved; out = y + v
//   indep_seq  the same two chains written one after the other
//
// Replaces the TPU kernel benchmarks/unit_overlap.py: _kernel (through
// _run's pallas_call), which asked the same of the v5e's MXU and VPU.
//
// The product is the port's fp32 product, 3xTF32 (al bh + ah bl + ah bh),
// on asynchronous warpgroup products (wgmma.cuh wgmma_m64n128k8_tf32).  A
// warpgroup owns 64 rows, and each output row depends on its own input
// row alone, so it chains its nm products in registers: the accumulator of
// one product, split into TF32 hi and lo terms on the integer pipe
// (split_i), is the register A operand of the next, k-tile by k-tile.  The
// accumulator's 8-column groups hold columns 2t, 2t + 1 where the A
// fragment wants depths t, t + 4, so w's depth is permuted within each
// k-tile (physical depth p holds w's row 2p, or 2(p - 4) + 1 for p >= 4;
// no shuffle).  w's hi and lo planes (2 x 64 KB, K-major, 128-byte
// swizzle, four 32-deep blocks of [128 columns][128 bytes]) are split and
// laid out in shared memory once a block.  Each product issues its 16
// k-tiles x 3 products into one fp32 accumulator, a group a k-tile: the
// next k-tile's split runs while the last group is in flight (wait_group
// 1).  In indep_il v's nv steps are spread evenly over the nm products
// (the JAX probe's stages, max(nm, nv) of them, put every step past the
// nm-th after the last product; the chains are independent, so the values
// are the same), and a product's share runs on v's columns of k-tile kt
// right after kt's products are issued, so CUDA-core work sits under the
// asynchronous products; indep_seq and serial keep their order.
// The elementwise chains run on the accumulator's layout, a and b read
// from shared memory as each lane's column pair.
//
// What bounds it: mm_only is 2 rows 128^2 nm FLOP, three TF32 products
// each (0.33 ms at 495 TFLOP/s for rows 102,400, nm 16); vpu_only moves x
// and out (and x2 in the indep modes) once, some 105-157 MB, and its
// arithmetic is rows 128 nv multiply-adds plus a tanh every 4th step.
// One block of two warpgroups an SM (129 KB of shared memory), persistent:
// each block takes a contiguous, equal share of the 64-row tiles, and its
// warpgroups alternate through it.
//
// C interface (loaded with ctypes): returns a cudaError_t, 0 on success.
#include "wgmma.cuh"

using namespace recblr;

namespace {

constexpr int UO_C = 128;            // the probe's width
constexpr int UO_NT = UO_C / 8;      // 8-column groups of a row, and k-tiles of a product
constexpr int UO_WG = 2;             // warpgroups a block
constexpr int UO_THREADS = 128 * UO_WG;
constexpr uint32_t UO_PLANE = UO_C * UO_C * 4;  // one of w's TF32 planes
constexpr uint32_t UO_AB0 = 2 * UO_PLANE;       // a and b after the planes
constexpr size_t UO_SMEM = 1024 + UO_AB0 + sizeof(float4) * UO_NT * 4;

enum Mode { MM_ONLY = 0, VPU_ONLY = 1, SERIAL = 2, INDEP_IL = 3, INDEP_SEQ = 4 };

// The row of w at physical depth k: within each k-tile, depth p holds row
// 2p (p < 4) or 2(p - 4) + 1, the accumulator's column order.
__device__ __forceinline__ int depth_row(int k) {
  const int p = k % 8;
  return (k & ~7) + (p < 4 ? 2 * p : 2 * (p - 4) + 1);
}

// Byte offset of w's (depth k, column n) in a plane.
__device__ __forceinline__ uint32_t plane_offset(int k, int n) {
  return (k / 32) * (UO_C * 128) + sw128_offset(n, (k % 32) / 4) + (k % 4) * 4;
}

// y <- y w for the warpgroup's 64 rows; side(kt) runs after k-tile kt's
// products are issued, while they are in flight.
template <class Side>
__device__ __forceinline__ void mm_step(float (&y)[4 * UO_NT], uint32_t whi, uint32_t wlo,
                                        Side&& side) {
  float acc[4 * UO_NT];
#pragma unroll
  for (int kt = 0; kt < UO_NT; ++kt) {
    uint32_t ah[4], al[4];
    split_i(y[4 * kt], ah[0], al[0]);
    split_i(y[4 * kt + 2], ah[1], al[1]);
    split_i(y[4 * kt + 1], ah[2], al[2]);
    split_i(y[4 * kt + 3], ah[3], al[3]);
    const uint32_t off = (kt / 4) * (UO_C * 128) + 32 * (kt % 4);
    const uint64_t dh = sw128_desc(whi + off), dl = sw128_desc(wlo + off);
    wg_fence();
    wgmma_m64n128k8_tf32(acc, al, dh, kt > 0);
    wgmma_m64n128k8_tf32(acc, ah, dl, true);
    wgmma_m64n128k8_tf32(acc, ah, dh, true);
    wg_commit();
    side(kt);
    wg_wait<1>();
  }
  wg_wait<0>();
#pragma unroll
  for (int i = 0; i < 4 * UO_NT; ++i) y[i] = acc[i];
}

// Step i (v <- v a + b, then a tanh when i % 4 == 0) on the columns of
// 8-column group j; ab[4 j + t] holds (a, a, b, b) of columns 8 j + 2 t,
// 8 j + 2 t + 1.
__device__ __forceinline__ void vpu_group(float (&v)[4 * UO_NT], const float4* __restrict__ ab,
                                          int t, int j, int i) {
  const float4 p = ab[4 * j + t];
  v[4 * j] = fmaf(v[4 * j], p.x, p.z);
  v[4 * j + 1] = fmaf(v[4 * j + 1], p.y, p.w);
  v[4 * j + 2] = fmaf(v[4 * j + 2], p.x, p.z);
  v[4 * j + 3] = fmaf(v[4 * j + 3], p.y, p.w);
  if (i % 4 == 0)
#pragma unroll
    for (int e = 0; e < 4; ++e) v[4 * j + e] = tanhf(v[4 * j + e]);
}

__device__ __forceinline__ void vpu_step(float (&v)[4 * UO_NT], const float4* __restrict__ ab,
                                         int t, int i) {
#pragma unroll
  for (int j = 0; j < UO_NT; ++j) vpu_group(v, ab, t, j, i);
}

// The accumulator-layout fragments of the warp's 16 rows at r0.
__device__ __forceinline__ void load_frags(float (&v)[4 * UO_NT], const float* __restrict__ p,
                                           int r0, int gid, int t) {
#pragma unroll
  for (int j = 0; j < UO_NT; ++j) {
    const float* row = p + (size_t)(r0 + gid) * UO_C + 8 * j + 2 * t;
    const float2 lo = *reinterpret_cast<const float2*>(row);
    const float2 hi = *reinterpret_cast<const float2*>(row + 8 * UO_C);
    v[4 * j] = lo.x;
    v[4 * j + 1] = lo.y;
    v[4 * j + 2] = hi.x;
    v[4 * j + 3] = hi.y;
  }
}

struct NoSide {
  __device__ void operator()(int) const {}
};

template <int MODE>
__global__ void __launch_bounds__(UO_THREADS, 1)
unit_overlap_kernel(const float* __restrict__ x, const float* __restrict__ x2,
                    const float* __restrict__ w, const float* __restrict__ a,
                    const float* __restrict__ b, float* __restrict__ out, int rows, int nm,
                    int nv) {
  extern __shared__ uint8_t uo_raw[];
  const uint32_t raw = smem_addr(uo_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzled planes' 1 KB alignment
  uint8_t* sm = uo_raw + (base - raw);
  const float4* ab = reinterpret_cast<const float4*>(sm + UO_AB0);
  if constexpr (MODE != VPU_ONLY) {
    // w's planes: consecutive threads take consecutive depths of a column
    for (int i = threadIdx.x; i < UO_C * UO_C; i += UO_THREADS) {
      const int k = i % UO_C, n = i / UO_C;
      uint32_t hi, lo;
      split_i(__ldg(w + depth_row(k) * UO_C + n), hi, lo);
      *reinterpret_cast<uint32_t*>(sm + plane_offset(k, n)) = hi;
      *reinterpret_cast<uint32_t*>(sm + UO_PLANE + plane_offset(k, n)) = lo;
    }
  }
  for (int i = threadIdx.x; i < UO_NT * 4; i += UO_THREADS) {
    const int n = 8 * (i / 4) + 2 * (i % 4);
    reinterpret_cast<float4*>(sm + UO_AB0)[i] = make_float4(a[n], a[n + 1], b[n], b[n + 1]);
  }
  fence_proxy_async();  // the planes are read by wgmma (the async proxy)
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gid = lane / 4, t = lane % 4;
  const int wg = warp / 4, wrow = 16 * (warp % 4);
  const uint32_t whi = base, wlo = base + UO_PLANE;
  const int tiles = rows / 64;
  const int tb = static_cast<int>((long long)tiles * blockIdx.x / gridDim.x);
  const int te = static_cast<int>((long long)tiles * (blockIdx.x + 1) / gridDim.x);
  for (int tile = tb + wg; tile < te; tile += UO_WG) {
    const int r0 = 64 * tile + wrow;
    float y[4 * UO_NT];
    load_frags(y, x, r0, gid, t);
    if constexpr (MODE == MM_ONLY) {
      for (int s = 0; s < nm; ++s) mm_step(y, whi, wlo, NoSide{});
    } else if constexpr (MODE == VPU_ONLY) {
      for (int i = 0; i < nv; ++i) vpu_step(y, ab, t, i);
    } else if constexpr (MODE == SERIAL) {
      const int per = max(1, nv / max(nm, 1));
      for (int s = 0; s < nm; ++s) {
        mm_step(y, whi, wlo, NoSide{});
        for (int i = 0; i < per; ++i) vpu_step(y, ab, t, i);
      }
    } else {
      float v[4 * UO_NT];
      load_frags(v, x2, r0, gid, t);
      if constexpr (MODE == INDEP_IL) {
        // v's steps spread evenly over the nm product stages: stage s runs
        // steps [s nv / nm, (s + 1) nv / nm) on v's group kt under kt's
        // products (the two chains are independent, so any interleaving
        // gives the plain version's values)
        for (int s = 0; s < nm; ++s) {
          const int lo = (s * nv) / nm, hi = ((s + 1) * nv) / nm;
          mm_step(y, whi, wlo, [&](int kt) {
            for (int i = lo; i < hi; ++i) vpu_group(v, ab, t, kt, i);
          });
        }
        if (nm == 0)
          for (int i = 0; i < nv; ++i) vpu_step(v, ab, t, i);
      } else {
        for (int s = 0; s < nm; ++s) mm_step(y, whi, wlo, NoSide{});
        for (int i = 0; i < nv; ++i) vpu_step(v, ab, t, i);
      }
#pragma unroll
      for (int i = 0; i < 4 * UO_NT; ++i) y[i] += v[i];
    }
#pragma unroll
    for (int j = 0; j < UO_NT; ++j) {
      *reinterpret_cast<float2*>(out + (size_t)(r0 + gid) * UO_C + 8 * j + 2 * t) =
          make_float2(y[4 * j], y[4 * j + 1]);
      *reinterpret_cast<float2*>(out + (size_t)(r0 + gid + 8) * UO_C + 8 * j + 2 * t) =
          make_float2(y[4 * j + 2], y[4 * j + 3]);
    }
  }
}

template <int MODE>
cudaError_t launch(const float* x, const float* x2, const float* w, const float* a,
                   const float* b, float* out, int rows, int nm, int nv, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(unit_overlap_kernel<MODE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)UO_SMEM);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int tiles = rows / 64;
  unit_overlap_kernel<MODE><<<tiles < sms ? tiles : sms, UO_THREADS, UO_SMEM, st>>>(
      x, x2, w, a, b, out, rows, nm, nv);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, x2, out: [rows, 128] fp32 (rows a multiple of 64); w [128, 128]; a,
// b [128]; mode: 0 mm_only, 1 vpu_only, 2 serial, 3 indep_il, 4 indep_seq.
int recblr_probe_unit_overlap(const void* x, const void* x2, const void* w, const void* a,
                              const void* b, void* out, int rows, int mode, int nm, int nv,
                              int device, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (rows < 64 || rows % 64 || nm < 0 || nv < 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *px = static_cast<const float*>(x), *px2 = static_cast<const float*>(x2),
              *pw = static_cast<const float*>(w), *pa = static_cast<const float*>(a),
              *pb = static_cast<const float*>(b);
  float* po = static_cast<float*>(out);
  switch (mode) {
    case MM_ONLY: return launch<MM_ONLY>(px, px2, pw, pa, pb, po, rows, nm, nv, st);
    case VPU_ONLY: return launch<VPU_ONLY>(px, px2, pw, pa, pb, po, rows, nm, nv, st);
    case SERIAL: return launch<SERIAL>(px, px2, pw, pa, pb, po, rows, nm, nv, st);
    case INDEP_IL: return launch<INDEP_IL>(px, px2, pw, pa, pb, po, rows, nm, nv, st);
    case INDEP_SEQ: return launch<INDEP_SEQ>(px, px2, pw, pa, pb, po, rows, nm, nv, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* recblr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
