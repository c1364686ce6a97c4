// Probe: the price of each elementwise op on the CUDA cores.  One block of
// [8, 512, 128] fp32; each element runs `repeat` dependent steps
// x <- op(x) 0.9 + 0.05 of one of fourteen ops, then is written back.
//
// Replaces the TPU kernel benchmarks/vpu_ops.py: make_fn's kernel (its
// pallas_call at :49), which priced the v5e's VPU ops.
//
// Each element is one thread's dependent chain, so the time is the op's
// latency chain spread over the threads the card keeps in flight.  The ops
// are JAX's formulas computed with CUDA's accurate fp32 functions (no
// fast-math flag, so nvcc cannot fold the chain); where the port's kernels
// already compute the op, with their device function (common.cuh), so the
// line prices what those kernels run: exp as exp_t (exp2 of x log2 e),
// sigmoid as sigmoid_t (through tanh), silu as silu_t, softplus as
// softplus_t, rsqrt as rsqrtf.  The step's multiply-add is one fmaf.
//
// What bounds it: 4 MB in and out (about 1.3 us at 3.35 TB/s) against 2^19
// x repeat dependent steps; at repeat 64 the mul chain is some 67M
// instructions, about 2 us on the FMA pipes, and a transcendental chain a
// few times that.  That is close to one launch's cost, so launch latency
// bounds the measured time from below.
//
// C interface (loaded with ctypes): returns a cudaError_t, 0 on success.
#include "common.cuh"

using namespace recblr;

namespace {

constexpr int VO_THREADS = 256;

// benchmarks/vpu_ops.py OPS, in its order
enum Op {
  MUL, ADD, EXP, EXP2, SIGMOID, TANH, LOG, SQRT, RSQRT, DIV, RECIP_MUL, SOFTPLUS, SILU, WHERE,
  N_OPS
};

template <int OP>
__device__ __forceinline__ float apply(float x) {
  if constexpr (OP == MUL) return x * 1.0000001f;
  if constexpr (OP == ADD) return x + 1e-7f;
  if constexpr (OP == EXP) return exp_t(x);
  if constexpr (OP == EXP2) return exp2f(x);
  if constexpr (OP == SIGMOID) return sigmoid_t(x);
  if constexpr (OP == TANH) return tanhf(x);
  if constexpr (OP == LOG) return logf(fabsf(x) + 1.0f);
  if constexpr (OP == SQRT) return sqrtf(fabsf(x) + 1e-6f);
  if constexpr (OP == RSQRT) return rsqrtf(fabsf(x) + 1e-6f);
  if constexpr (OP == DIV) return 1.0f / (x + 1.7f);
  if constexpr (OP == RECIP_MUL) return x * (x + 1.7f);
  if constexpr (OP == SOFTPLUS) return softplus_t(x);
  if constexpr (OP == SILU) return silu_t(x);
  if constexpr (OP == WHERE) return x > 0.5f ? x : x * 0.5f;
  return x;
}

template <int OP>
__global__ void __launch_bounds__(VO_THREADS)
vpu_op_kernel(const float* __restrict__ x, float* __restrict__ out, int n, int repeat) {
  const int i = blockIdx.x * VO_THREADS + threadIdx.x;
  if (i >= n) return;
  float v = x[i];
#pragma unroll 8
  for (int r = 0; r < repeat; ++r) v = fmaf(apply<OP>(v), 0.9f, 0.05f);
  out[i] = v;
}

template <int OP>
cudaError_t launch(const float* x, float* out, int n, int repeat, cudaStream_t st) {
  vpu_op_kernel<OP><<<(n + VO_THREADS - 1) / VO_THREADS, VO_THREADS, 0, st>>>(x, out, n, repeat);
  return cudaGetLastError();
}

template <int OP>
cudaError_t dispatch(int op, const float* x, float* out, int n, int repeat, cudaStream_t st) {
  if constexpr (OP == N_OPS) {
    return cudaErrorInvalidValue;
  } else {
    if (op == OP) return launch<OP>(x, out, n, repeat, st);
    return dispatch<OP + 1>(op, x, out, n, repeat, st);
  }
}

}  // namespace

extern "C" {

// x, out: n fp32 values; op: the index of the op in OPS' order; repeat:
// the chain's steps.
int recblr_probe_vpu_op(const void* x, void* out, int n, int op, int repeat, int device,
                        void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (n < 1 || repeat < 0) return cudaErrorInvalidValue;
  return dispatch<0>(op, static_cast<const float*>(x), static_cast<float*>(out), n, repeat,
                     static_cast<cudaStream_t>(stream));
}

const char* recblr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
