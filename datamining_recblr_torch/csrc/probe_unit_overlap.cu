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
// The product is the port's fp32 product: 3xTF32 mma.sync (mma_tile.cuh
// mma_3xtf32), each 8-deep k-tile in a fresh accumulator added in fp32.
// Each output row depends on its own input row alone, so a warp owns 16
// rows and chains its nm products without a block barrier: the C
// fragments of one product are split into the A fragments of the next
// (split_c_as_a), k-tile by k-tile, while w's fragments, split into their
// TF32 hi and lo terms once per block, sit in shared memory in the order
// the lanes read them (one 16-byte load per k-tile and n-tile).  That is
// the dependent-mma loop of the RecBLR kernels' phases, which the probe
// isolates.  The elementwise chains run on the same C-fragment layout, a
// and b read from shared memory as each lane's column pair.
//
// What bounds it: mm_only is 2 rows 128^2 nm FLOP, three TF32 products
// each (0.33 ms at 495 TFLOP/s for rows 102,400, nm 16); vpu_only moves x
// and out (and x2 in the indep modes) once, some 105-157 MB, and its
// arithmetic is rows 128 nv multiply-adds plus a tanh every 4th step.
// A block holds 8 warps (128 rows): 129 KB of shared memory and 255
// registers a thread (ptxas spills 16-144 bytes a thread in every mode but
// vpu_only) keep one block on an SM.
//
// C interface (loaded with ctypes): returns a cudaError_t, 0 on success.
#include "common.cuh"
#include "mma_tile.cuh"

using namespace recblr;

namespace {

constexpr int UO_C = 128;            // the probe's width
constexpr int UO_NT = UO_C / 8;      // n-tiles of a row tile, and k-tiles of a product
constexpr int UO_WARPS = 8;
constexpr int UO_THREADS = 32 * UO_WARPS;
constexpr int UO_WFRAGS = UO_NT * UO_NT * 32;  // float4 (bh0, bh1, bl0, bl1) per (kt, j, lane)
constexpr size_t UO_SMEM = sizeof(float4) * (UO_WFRAGS + UO_NT * 4);

enum Mode { MM_ONLY = 0, VPU_ONLY = 1, SERIAL = 2, INDEP_IL = 3, INDEP_SEQ = 4 };

// y <- y w for the warp's 16 rows: y's C fragments (16 n-tiles) become the
// A fragments of the product one k-tile at a time.
__device__ __forceinline__ void mm_step(float (&y)[UO_NT][4], const float4* __restrict__ wf,
                                        int lane) {
  float nxt[UO_NT][4];
#pragma unroll
  for (int j = 0; j < UO_NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) nxt[j][e] = 0.f;
#pragma unroll
  for (int kt = 0; kt < UO_NT; ++kt) {
    uint32_t ah[4], al[4];
    split_c_as_a(y[kt], ah, al);
#pragma unroll
    for (int j = 0; j < UO_NT; ++j) {
      const float4 b = wf[(kt * UO_NT + j) * 32 + lane];
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      mma_3xtf32(c, ah, al, b.x, b.y, b.z, b.w);
      add_tile(nxt[j], c);
    }
  }
#pragma unroll
  for (int j = 0; j < UO_NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) y[j][e] = nxt[j][e];
}

// v <- v a + b (a tanh after it when i % 4 == 0); ab[4 j + t] holds the
// lane's columns 8 j + 2 t, 8 j + 2 t + 1 as (a0, a1, b0, b1).
__device__ __forceinline__ void vpu_step(float (&v)[UO_NT][4], const float4* __restrict__ ab,
                                         int t, int i) {
  const bool th = i % 4 == 0;
#pragma unroll
  for (int j = 0; j < UO_NT; ++j) {
    const float4 p = ab[4 * j + t];
    v[j][0] = fmaf(v[j][0], p.x, p.z);
    v[j][1] = fmaf(v[j][1], p.y, p.w);
    v[j][2] = fmaf(v[j][2], p.x, p.z);
    v[j][3] = fmaf(v[j][3], p.y, p.w);
    if (th)
#pragma unroll
      for (int e = 0; e < 4; ++e) v[j][e] = tanhf(v[j][e]);
  }
}

// The C fragments of the warp's 16 rows at row r0 of a [rows, 128] array.
__device__ __forceinline__ void load_frags(float (&v)[UO_NT][4], const float* __restrict__ p,
                                           int r0, int gid, int t) {
#pragma unroll
  for (int j = 0; j < UO_NT; ++j) {
    const float* row = p + (size_t)(r0 + gid) * UO_C + 8 * j + 2 * t;
    const float2 lo = *reinterpret_cast<const float2*>(row);
    const float2 hi = *reinterpret_cast<const float2*>(row + 8 * UO_C);
    v[j][0] = lo.x;
    v[j][1] = lo.y;
    v[j][2] = hi.x;
    v[j][3] = hi.y;
  }
}

template <int MODE>
__global__ void __launch_bounds__(UO_THREADS, 1)
unit_overlap_kernel(const float* __restrict__ x, const float* __restrict__ x2,
                    const float* __restrict__ w, const float* __restrict__ a,
                    const float* __restrict__ b, float* __restrict__ out, int rows, int nm,
                    int nv) {
  extern __shared__ float4 uo_smem[];
  float4* wf = uo_smem;
  float4* ab = uo_smem + UO_WFRAGS;
  // w's B fragments: lane (g, t) of (kt, j) reads depth rows 8 kt + 2 t and
  // 8 kt + 2 t + 1 (split_c_as_a's column order) of column 8 j + g
  for (int i = threadIdx.x; i < UO_WFRAGS; i += UO_THREADS) {
    const int ln = i % 32, j = (i / 32) % UO_NT, kt = i / (32 * UO_NT);
    const int k = 8 * kt + 2 * (ln % 4), n = 8 * j + ln / 4;
    uint32_t h0, l0, h1, l1;
    tf32_split(w[k * UO_C + n], h0, l0);
    tf32_split(w[(k + 1) * UO_C + n], h1, l1);
    wf[i] = make_float4(__uint_as_float(h0), __uint_as_float(h1), __uint_as_float(l0),
                        __uint_as_float(l1));
  }
  for (int i = threadIdx.x; i < UO_NT * 4; i += UO_THREADS) {
    const int n = 8 * (i / 4) + 2 * (i % 4);
    ab[i] = make_float4(a[n], a[n + 1], b[n], b[n + 1]);
  }
  __syncthreads();
  const int lane = threadIdx.x % 32, gid = lane / 4, t = lane % 4;
  const int r0 = (blockIdx.x * UO_WARPS + threadIdx.x / 32) * 16;
  if (r0 >= rows) return;
  float y[UO_NT][4];
  load_frags(y, x, r0, gid, t);
  if constexpr (MODE == MM_ONLY) {
    for (int s = 0; s < nm; ++s) mm_step(y, wf, lane);
  } else if constexpr (MODE == VPU_ONLY) {
    for (int i = 0; i < nv; ++i) vpu_step(y, ab, t, i);
  } else if constexpr (MODE == SERIAL) {
    const int per = max(1, nv / max(nm, 1));
    for (int s = 0; s < nm; ++s) {
      mm_step(y, wf, lane);
      for (int i = 0; i < per; ++i) vpu_step(y, ab, t, i);
    }
  } else {
    float v[UO_NT][4];
    load_frags(v, x2, r0, gid, t);
    if constexpr (MODE == INDEP_IL) {
      const int steps = max(nm, nv);
      for (int s = 0; s < steps; ++s) {
        if (s < nm) mm_step(y, wf, lane);
        const int hi = ((s + 1) * nv) / steps;
        for (int i = (s * nv) / steps; i < hi; ++i) vpu_step(v, ab, t, i);
      }
    } else {
      for (int s = 0; s < nm; ++s) mm_step(y, wf, lane);
      for (int i = 0; i < nv; ++i) vpu_step(v, ab, t, i);
    }
#pragma unroll
    for (int j = 0; j < UO_NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[j][e] += v[j][e];
  }
#pragma unroll
  for (int j = 0; j < UO_NT; ++j) {
    *reinterpret_cast<float2*>(out + (size_t)(r0 + gid) * UO_C + 8 * j + 2 * t) =
        make_float2(y[j][0], y[j][1]);
    *reinterpret_cast<float2*>(out + (size_t)(r0 + gid + 8) * UO_C + 8 * j + 2 * t) =
        make_float2(y[j][2], y[j][3]);
  }
}

template <int MODE>
cudaError_t launch(const float* x, const float* x2, const float* w, const float* a,
                   const float* b, float* out, int rows, int nm, int nv, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(unit_overlap_kernel<MODE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)UO_SMEM);
  if (e != cudaSuccess) return e;
  const int blocks = (rows / 16 + UO_WARPS - 1) / UO_WARPS;
  unit_overlap_kernel<MODE><<<blocks, UO_THREADS, UO_SMEM, st>>>(x, x2, w, a, b, out, rows, nm,
                                                                 nv);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, x2, out: [rows, 128] fp32 (rows a multiple of 16); w [128, 128]; a,
// b [128]; mode: 0 mm_only, 1 vpu_only, 2 serial, 3 indep_il, 4 indep_seq.
int recblr_probe_unit_overlap(const void* x, const void* x2, const void* w, const void* a,
                              const void* b, void* out, int rows, int mode, int nm, int nv,
                              int device, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (rows < 16 || rows % 16 || nm < 0 || nv < 0) return cudaErrorInvalidValue;
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
