// LN(x + pos) over D for Hopper: the embedding prologue of SASRec and
// BERT4Rec, at dropout 0.
//
// Replaces the TPU kernel datamining_recblr_tpu/ops/fused_layer.py:
// _ln_dropout_fwd_kernel (reached through _ln_dropout_fwd /
// fused_ln_dropout).  pos [T, D] is added in fp32 before the LN, as the
// TPU kernel does.  A few operations per element against a read of x and
// a write of out (2 B T D x 4 bytes in fp32, 26.2 MB at B 256, T 200,
// D 64): bound by bytes.  The design reads each element once into
// registers, one warp per (row, position) with up to 16 values a lane,
// takes the mean and the centred variance from the registers with warp
// shuffles, and writes once; pos, scale and bias stay in L1/L2.  No
// shared memory, so many warps per SM hide the memory latency.
//
// C interface (loaded with ctypes): returns a cudaError_t, 0 on success.
#include "common.cuh"

using namespace recblr;

namespace {

constexpr int LN_THREADS = 256;
constexpr int PER_LANE = 16;  // D <= 32 * PER_LANE = 512

template <typename Tin>
__global__ void __launch_bounds__(LN_THREADS)
ln_pos_kernel(const Tin* __restrict__ x, const float* __restrict__ pos,
              const float* __restrict__ s, const float* __restrict__ bias,
              Tin* __restrict__ out, int rows, int T, int D) {
  const int row = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) / 32);
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const size_t o = (size_t)row * D;
  const float* pr = pos + (size_t)(row % T) * D;
  float v[PER_LANE];
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < PER_LANE; ++k) {
    const int d = lane + 32 * k;
    v[k] = d < D ? load_act(x, o + d) + __ldg(pr + d) : 0.f;
    sum += v[k];
  }
  const float mu = warp_sum(sum) / D;
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < PER_LANE; ++k) {
    const int d = lane + 32 * k;
    const float c = v[k] - mu;
    if (d < D) sq += c * c;
  }
  const float inv = rsqrtf(warp_sum(sq) / D + LN_EPS);
#pragma unroll
  for (int k = 0; k < PER_LANE; ++k) {
    const int d = lane + 32 * k;
    if (d < D) store_act(out, o + d, (v[k] - mu) * inv * __ldg(s + d) + __ldg(bias + d));
  }
}

template <typename Tin>
cudaError_t ln_pos_fwd(const Tin* x, const float* pos, const float* s, const float* b, Tin* out,
                       int B, int T, int D, cudaStream_t stream) {
  const int rows = B * T;
  const int warps = LN_THREADS / 32;
  ln_pos_kernel<Tin><<<(rows + warps - 1) / warps, LN_THREADS, 0, stream>>>(x, pos, s, b, out,
                                                                           rows, T, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, out: [B, T, D] fp32 (bf16 == 0) or bf16, D <= 512; pos: [T, D],
// scale, bias: [D] fp32; device: the card that holds them.
int recblr_ln_pos_fwd(const void* x, const void* pos, const void* scale, const void* bias,
                      void* out, int B, int T, int D, int bf16, int device, void* stream) {
  // this library has its own (static) CUDA runtime: select the tensors' card
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(pos);
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  if (bf16)
    return ln_pos_fwd(static_cast<const __nv_bfloat16*>(x), p, s, b,
                      static_cast<__nv_bfloat16*>(out), B, T, D, st);
  return ln_pos_fwd(static_cast<const float*>(x), p, s, b, static_cast<float*>(out), B, T, D,
                    st);
}

const char* recblr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
