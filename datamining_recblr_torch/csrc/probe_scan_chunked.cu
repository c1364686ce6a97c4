// Probe: two parallel designs of the first-order scan h_t = g_t h_{t-1} +
// x_t (h_{-1} = 0) over [B, T, C] fp32, set against row 7's serial
// linear_scan (linear_scan.cu) at the same shape:
//   flat   a Hillis-Steele scan over T: ceil(log2 T) rounds of
//          (x, f) <- (x_{t-d} f_t + x_t, f_{t-d} f_t), x_{t-d} = 0 and
//          f_{t-d} = 1 below d
//   chunk  two levels: a serial scan within each 8-wide chunk (the local
//          prefix and the gates' cumulative product), a Hillis-Steele scan
//          over the T/8 chunk carries, and a combine pass
//          out = local + carry_{k-1} cumprod.
//
// Replaces the TPU kernels benchmarks/scan_chunked.py: _kernel_flat (which
// runs datamining_recblr_tpu/ops/pallas_scan.py _scan_body) and
// _kernel_chunk (_scan_chunked), both through run's pallas_call.
//
// Tiling: 8 rows x 200 x 128 fp32 (the TPU's block) do not fit in 227 KB
// of shared memory, so a block takes one row and 32 channels, one warp
// lane a channel, so that every position's 32 channels are one 128-byte
// line.
//   flat   8 warps over the T positions, x and f in shared memory, double
//          buffered: each round reads one buffer and writes the other,
//          one barrier a round (8 at T 200); 512 T bytes of shared memory
//          (100 KB at T 200, two blocks an SM), T <= 454 in Hopper's 227 KB.
//   chunk  one warp a chunk (T / 8 warps, T <= 256): the chunk's 8
//          positions are loaded together into registers and scanned
//          serially there; the carries' scan runs in shared memory, one
//          barrier a round (5 at T 200); then each thread writes its 8
//          positions.
//
// What bounds both: reading g and x and writing h, 3 B T C x 4 bytes (629
// MB at B 2,048, T 200, C 128; 0.188 ms at 3.35 TB/s): bytes.
//
// C interface (loaded with ctypes): returns a cudaError_t, 0 on success.
#include "common.cuh"

using namespace recblr;

namespace {

constexpr int SC_LANES = 32;         // channels a block
constexpr int FLAT_WARPS = 8;
constexpr int CHUNK = 8;
constexpr int MAX_CHUNKS = 32;       // warps of a chunk block

__global__ void __launch_bounds__(32 * FLAT_WARPS)
scan_flat_kernel(const float* __restrict__ g, const float* __restrict__ x,
                 float* __restrict__ out, int T, int C) {
  // two buffers, each x then f, [T][32]
  extern __shared__ float flat_smem[];
  const int span = T * SC_LANES;
  const int slices = C / SC_LANES;
  const int b = blockIdx.x / slices, c0 = (blockIdx.x % slices) * SC_LANES;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const size_t base = (size_t)b * T * C + c0 + lane;
  for (int t = w; t < T; t += FLAT_WARPS) {
    flat_smem[t * SC_LANES + lane] = x[base + (size_t)t * C];
    flat_smem[span + t * SC_LANES + lane] = g[base + (size_t)t * C];
  }
  __syncthreads();
  int cur = 0;
  for (int d = 1; d < T; d *= 2) {
    const float* xc = flat_smem + cur * 2 * span;
    const float* fc = xc + span;
    float* xn = flat_smem + (cur ^ 1) * 2 * span;
    float* fn = xn + span;
    for (int t = w; t < T; t += FLAT_WARPS) {
      const int i = t * SC_LANES + lane;
      const float f = fc[i];
      float xl = 0.f, fl = 1.f;
      if (t >= d) {
        xl = xc[i - d * SC_LANES];
        fl = fc[i - d * SC_LANES];
      }
      xn[i] = fmaf(xl, f, xc[i]);
      fn[i] = fl * f;
    }
    cur ^= 1;
    __syncthreads();
  }
  const float* xc = flat_smem + cur * 2 * span;
  for (int t = w; t < T; t += FLAT_WARPS) out[base + (size_t)t * C] = xc[t * SC_LANES + lane];
}

__global__ void __launch_bounds__(32 * MAX_CHUNKS)
scan_chunk_kernel(const float* __restrict__ g, const float* __restrict__ x,
                  float* __restrict__ out, int T, int C) {
  __shared__ float cx[2][MAX_CHUNKS][SC_LANES], cf[2][MAX_CHUNKS][SC_LANES];
  const int nk = T / CHUNK, slices = C / SC_LANES;
  const int b = blockIdx.x / slices, c0 = (blockIdx.x % slices) * SC_LANES;
  const int lane = threadIdx.x % 32, k = threadIdx.x / 32;
  const size_t base = (size_t)b * T * C + (size_t)(k * CHUNK) * C + c0 + lane;
  float gv[CHUNK], xv[CHUNK];
#pragma unroll
  for (int i = 0; i < CHUNK; ++i) {
    gv[i] = g[base + (size_t)i * C];
    xv[i] = x[base + (size_t)i * C];
  }
  // within the chunk: xv <- local inclusive prefix, gv <- gates' cumprod
  float h = 0.f, p = 1.f;
#pragma unroll
  for (int i = 0; i < CHUNK; ++i) {
    h = fmaf(gv[i], h, xv[i]);
    p *= gv[i];
    xv[i] = h;
    gv[i] = p;
  }
  cx[0][k][lane] = h;
  cf[0][k][lane] = p;
  __syncthreads();
  int cur = 0;
  for (int d = 1; d < nk; d *= 2) {
    const float a = cx[cur][k][lane], f = cf[cur][k][lane];
    float al = 0.f, fl = 1.f;
    if (k >= d) {
      al = cx[cur][k - d][lane];
      fl = cf[cur][k - d][lane];
    }
    cx[cur ^ 1][k][lane] = fmaf(al, f, a);
    cf[cur ^ 1][k][lane] = fl * f;
    cur ^= 1;
    __syncthreads();
  }
  const float carry = k >= 1 ? cx[cur][k - 1][lane] : 0.f;
#pragma unroll
  for (int i = 0; i < CHUNK; ++i) out[base + (size_t)i * C] = fmaf(carry, gv[i], xv[i]);
}

}  // namespace

extern "C" {

// g, x, out: [B, T, C] fp32, C a multiple of 32; chunk: 0 flat (T <= 454),
// 1 two-level (T a multiple of 8, T <= 256).
int recblr_probe_scan(const void* g, const void* x, void* out, int B, int T, int C, int chunk,
                      int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (B < 1 || T < 1 || C < SC_LANES || C % SC_LANES) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pg = static_cast<const float*>(g);
  const float* px = static_cast<const float*>(x);
  float* po = static_cast<float*>(out);
  const int blocks = B * (C / SC_LANES);
  if (chunk) {
    if (T % CHUNK || T / CHUNK > MAX_CHUNKS) return cudaErrorInvalidValue;
    scan_chunk_kernel<<<blocks, 32 * (T / CHUNK), 0, st>>>(pg, px, po, T, C);
  } else {
    const size_t smem = sizeof(float) * 4 * (size_t)T * SC_LANES;
    e = cudaFuncSetAttribute(scan_flat_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    scan_flat_kernel<<<blocks, 32 * FLAT_WARPS, smem, st>>>(pg, px, po, T, C);
  }
  return cudaGetLastError();
}

const char* recblr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
