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
//   flat   a warp per 32 positions (T / 32 warps, T <= 512), each thread
//          holding its channel's 32 positions of x and f in registers, all
//          64 loads issued before the first round (some 170 KB in flight
//          an SM at T 200).  The rounds with d < 32 run in registers, from
//          the top position down, and take only the previous warp's last d
//          positions through shared memory; the rounds with d >= 32 (3 at T
//          200) read warp w - d / 32's registers, all of them passed
//          through shared memory (T x 32 x 8 bytes, 56 KB at T 200).  Each
//          round takes the same sums as a scan of x and f kept in shared
//          memory and read and written every round (x_t <- fmaf(x_{t-d},
//          f_t, x_t), f_t <- f_{t-d} f_t), bit for bit; such a scan moves 24
//          bytes an element a round through shared memory, 8 rounds at T
//          200, which its 128 bytes a clock hold to some 0.5 ms.
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
constexpr int FLAT_P = 32;           // positions a thread of the flat scan
constexpr int FLAT_MAX_WARPS = 16;   // T <= 512
constexpr int CHUNK = 8;
constexpr int MAX_CHUNKS = 32;       // warps of a chunk block

// One round of the flat scan at d < FLAT_P on a thread's registers: t - d
// lies in this thread, or for i < d in the previous warp's position i - d
// + FLAT_P, which comes through shared memory (none in warp 0: x_{t-d} =
// 0, f_{t-d} = 1).  sx, sf: [warp][i][lane].
template <int d>
__device__ __forceinline__ void flat_round_in_registers(float (&xr)[FLAT_P], float (&fr)[FLAT_P],
                                                        float* sx, float* sf, int w, int lane) {
  auto at = [&](int ww, int i) { return (ww * FLAT_P + i) * SC_LANES + lane; };
#pragma unroll
  for (int i = FLAT_P - d; i < FLAT_P; ++i) {
    sx[at(w, i)] = xr[i];
    sf[at(w, i)] = fr[i];
  }
  __syncthreads();
  // from the top down: position i reads i - d before it is updated
#pragma unroll
  for (int i = FLAT_P - 1; i >= d; --i) {
    xr[i] = fmaf(xr[i - d], fr[i], xr[i]);
    fr[i] = fr[i - d] * fr[i];
  }
#pragma unroll
  for (int i = 0; i < d; ++i) {
    const float xl = w > 0 ? sx[at(w - 1, i - d + FLAT_P)] : 0.f;
    const float fl = w > 0 ? sf[at(w - 1, i - d + FLAT_P)] : 1.f;
    xr[i] = fmaf(xl, fr[i], xr[i]);
    fr[i] = fl * fr[i];
  }
  __syncthreads();
}

// Block: row b, channels c0 .. c0 + 31; warp w positions 32 w .. 32 w + 31,
// lane the channel.  Positions at or beyond T hold (0, 1) and are never
// read by one below them (a round reads only t - d) nor written.
__global__ void __launch_bounds__(32 * FLAT_MAX_WARPS)
scan_flat_kernel(const float* __restrict__ g, const float* __restrict__ x,
                 float* __restrict__ out, int T, int C) {
  // x then f of every position, [warp][i][lane] each
  extern __shared__ float flat_smem[];
  float* sx = flat_smem;
  float* sf = flat_smem + blockDim.x * FLAT_P;
  const int slices = C / SC_LANES;
  const int b = blockIdx.x / slices, c0 = (blockIdx.x % slices) * SC_LANES;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32, t0 = w * FLAT_P;
  const size_t base = (size_t)b * T * C + c0 + lane;
  auto at = [&](int ww, int i) { return (ww * FLAT_P + i) * SC_LANES + lane; };
  float xr[FLAT_P], fr[FLAT_P];
#pragma unroll
  for (int i = 0; i < FLAT_P; ++i) {
    const bool in = t0 + i < T;
    xr[i] = in ? __ldg(x + base + (size_t)(t0 + i) * C) : 0.f;
    fr[i] = in ? __ldg(g + base + (size_t)(t0 + i) * C) : 1.f;
  }
  static_assert(FLAT_P == 32, "the rounds below in registers");
  if (T > 1) flat_round_in_registers<1>(xr, fr, sx, sf, w, lane);
  if (T > 2) flat_round_in_registers<2>(xr, fr, sx, sf, w, lane);
  if (T > 4) flat_round_in_registers<4>(xr, fr, sx, sf, w, lane);
  if (T > 8) flat_round_in_registers<8>(xr, fr, sx, sf, w, lane);
  if (T > 16) flat_round_in_registers<16>(xr, fr, sx, sf, w, lane);
  // d >= 32, a multiple of 32: t - d is position i of warp w - d / 32
  for (int d = FLAT_P; d < T; d *= 2) {
#pragma unroll
    for (int i = 0; i < FLAT_P; ++i) {
      sx[at(w, i)] = xr[i];
      sf[at(w, i)] = fr[i];
    }
    __syncthreads();
    const int ws = w - d / FLAT_P;
#pragma unroll
    for (int i = 0; i < FLAT_P; ++i) {
      const float xl = ws >= 0 ? sx[at(ws, i)] : 0.f;
      const float fl = ws >= 0 ? sf[at(ws, i)] : 1.f;
      xr[i] = fmaf(xl, fr[i], xr[i]);
      fr[i] = fl * fr[i];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < FLAT_P; ++i)
    if (t0 + i < T) out[base + (size_t)(t0 + i) * C] = xr[i];
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

// g, x, out: [B, T, C] fp32, C a multiple of 32; chunk: 0 flat (T <= 512),
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
    const int warps = (T + FLAT_P - 1) / FLAT_P;
    if (warps > FLAT_MAX_WARPS) return cudaErrorInvalidValue;
    const size_t smem = sizeof(float) * 2 * (size_t)warps * FLAT_P * SC_LANES;
    e = cudaFuncSetAttribute(scan_flat_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    scan_flat_kernel<<<blocks, 32 * warps, smem, st>>>(pg, px, po, T, C);
  }
  return cudaGetLastError();
}

const char* recblr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
