// dropout(LN(x + pos)) and LN(dropout(x)) over D for Hopper, forward and
// backward: the embedding prologue of SASRec and BERT4Rec, and the input
// dropout and LN of a one-layer RecBLR.
//
// Replaces the TPU kernels datamining_recblr_tpu/ops/fused_layer.py:
// _ln_dropout_fwd_kernel (reached through _ln_dropout_fwd /
// fused_ln_dropout) and _ln_dropout_bwd_kernel (through _ln_dropout_bwd);
// with PRE (the dropout before the LN, no pos), _dropout_ln_fwd_kernel
// (through _dropout_ln_fwd / fused_dropout_ln) and _dropout_ln_bwd_kernel
// (through _dropout_ln_bwd).  pos [T, D] is added in fp32 before the LN,
// as the TPU kernel does; the dropout is the Philox mask M0 of the call's
// seed (common.cuh), which under PRE keys the input element (row,
// position, channel), the bits of the plain dropout of x.
//
// Forward: a few operations per element against a read of x and a write
// of out (2 B T D x 4 bytes in fp32, 26.2 MB at B 256, T 200, D 64):
// bound by bytes.  One warp per (row, position) with up to 16 values a
// lane, mean and centred variance from the registers with warp shuffles,
// one write; pos, scale and bias stay in L1/L2.  No shared memory, so
// many warps per SM hide the memory latency.
//
// Backward: x, dout and dx once each (3 B T D x 4 bytes, 315 MB at
// B 2,048 in fp32), also bound by bytes.  The LN statistics are
// recomputed from x (no stash), the mask is drawn again.  dpos [T, D] is
// the batch sum of the LN input's gradient and dscale, dbias [D] sums
// over every (row, position), all without atomics: block (t, c) sums
// position t over batch chunk c in a fixed order into its own partial
// row; reduce_partials_kernel sums dpos over the chunks and
// colsum_kernel dscale and dbias over the (chunk, position) rows, both
// in a fixed order, so two runs give the same bits (PRE has no dpos).
// Left for later: 16-byte loads, and dscale / dbias summed in the same
// pass as dpos.
//
// C interface (loaded with ctypes): returns a cudaError_t, 0 on success.
#include "common_bwd.cuh"

using namespace recblr;

namespace {

constexpr int LN_THREADS = 256;
constexpr int LN_WARPS = LN_THREADS / 32;
constexpr int PER_LANE = 16;  // D <= 32 * PER_LANE = 512

// The input of the LN at (row b, position t, channel d): x + pos, or
// under PRE x times the M0 mask.
template <bool PRE, typename Tin>
__device__ __forceinline__ float ln_input(const Tin* x, const float* pos, const Dropout& dr,
                                          size_t o, int b, int t, int d, int D) {
  if (PRE) return load_act(x, o + d) * drop_mask(dr, M0, b, t, d);
  return load_act(x, o + d) + __ldg(pos + (size_t)t * D + d);
}

template <typename Tin, bool PRE>
__global__ void __launch_bounds__(LN_THREADS)
ln_pos_kernel(const Tin* __restrict__ x, const float* __restrict__ pos,
              const float* __restrict__ s, const float* __restrict__ bias, Dropout dr,
              Tin* __restrict__ out, int rows, int T, int D) {
  const int row = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) / 32);
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const size_t o = (size_t)row * D;
  const int b = row / T, t = row % T;
  float v[PER_LANE];
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < PER_LANE; ++k) {
    const int d = lane + 32 * k;
    v[k] = d < D ? ln_input<PRE>(x, pos, dr, o, b, t, d, D) : 0.f;
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
    if (d < D) {
      const float y = (v[k] - mu) * inv * __ldg(s + d) + __ldg(bias + d);
      store_act(out, o + d, PRE ? y : y * drop_mask(dr, M0, b, t, d));
    }
  }
}

// Block (t, c): position t of batch rows c, c + chunks, ...; warp w takes
// every LN_WARPS-th of them.  Writes dx, and the block's sums of dv
// (pos_part[c, t, :], not under PRE) and of dy * vhat, dy
// (sb_part[c * T + t, :]).
template <typename Tin, bool PRE>
__global__ void __launch_bounds__(LN_THREADS)
ln_pos_bwd_kernel(const Tin* __restrict__ x, const float* __restrict__ pos,
                  const Tin* __restrict__ dout, const float* __restrict__ s, Dropout dr,
                  Tin* __restrict__ dx, float* __restrict__ pos_part,
                  float* __restrict__ sb_part, int B, int T, int D, int chunks) {
  __shared__ float acc[3 * 32 * PER_LANE];  // dpos, dscale, dbias of the block
  const int t = blockIdx.x, c = blockIdx.y;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float dp[PER_LANE], ds[PER_LANE], db[PER_LANE];
#pragma unroll
  for (int k = 0; k < PER_LANE; ++k) dp[k] = ds[k] = db[k] = 0.f;
  for (int b = c + chunks * warp; b < B; b += chunks * LN_WARPS) {
    const size_t o = ((size_t)b * T + t) * D;
    float v[PER_LANE], dy[PER_LANE], m[PER_LANE];
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) {
      const int d = lane + 32 * k;
      // the mask multiplies the LN input under PRE, the output otherwise
      m[k] = d < D ? drop_mask(dr, M0, b, t, d) : 0.f;
      if (PRE) {
        v[k] = d < D ? load_act(x, o + d) * m[k] : 0.f;
        dy[k] = d < D ? load_act(dout, o + d) : 0.f;
      } else {
        v[k] = d < D ? load_act(x, o + d) + __ldg(pos + (size_t)t * D + d) : 0.f;
        dy[k] = d < D ? load_act(dout, o + d) * m[k] : 0.f;
      }
      sum += v[k];
    }
    const float mu = warp_sum(sum) / D;
    float sq = 0.f;
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) {
      const int d = lane + 32 * k;
      v[k] -= mu;
      if (d < D) sq += v[k] * v[k];
    }
    const float inv = rsqrtf(warp_sum(sq) / D + LN_EPS);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) {
      const int d = lane + 32 * k;
      v[k] *= inv;  // vhat
      if (d < D) {
        const float g = dy[k] * __ldg(s + d);
        ds[k] += dy[k] * v[k];
        db[k] += dy[k];
        s1 += g;
        s2 += g * v[k];
      }
    }
    const float m1 = warp_sum(s1) / D;
    const float m2 = warp_sum(s2) / D;
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) {
      const int d = lane + 32 * k;
      if (d < D) {
        const float dv = inv * (dy[k] * __ldg(s + d) - m1 - v[k] * m2);
        store_act(dx, o + d, PRE ? dv * m[k] : dv);
        dp[k] += dv;
      }
    }
  }
  // the warps' sums, added in warp order
  for (int i = threadIdx.x; i < 3 * 32 * PER_LANE; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();
  for (int w = 0; w < LN_WARPS; ++w) {
    if (warp == w) {
#pragma unroll
      for (int k = 0; k < PER_LANE; ++k) {
        const int d = lane + 32 * k;
        acc[d] += dp[k];
        acc[32 * PER_LANE + d] += ds[k];
        acc[64 * PER_LANE + d] += db[k];
      }
    }
    __syncthreads();
  }
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    if (!PRE) pos_part[((size_t)c * T + t) * D + d] = acc[d];
    sb_part[((size_t)c * T + t) * 2 * D + d] = acc[32 * PER_LANE + d];
    sb_part[((size_t)c * T + t) * 2 * D + D + d] = acc[64 * PER_LANE + d];
  }
}

// out[j] = sum over r < rows of a[r * cols + j]: one block per column,
// each thread a fixed stride of rows, then a fixed tree.
__global__ void __launch_bounds__(LN_THREADS)
colsum_kernel(const float* __restrict__ a, int rows, int cols, float* __restrict__ out) {
  __shared__ float sh[LN_THREADS];
  float sum = 0.f;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) sum += a[(size_t)r * cols + blockIdx.x];
  sh[threadIdx.x] = sum;
  __syncthreads();
  for (int o = LN_THREADS / 2; o > 0; o >>= 1) {
    if (threadIdx.x < o) sh[threadIdx.x] += sh[threadIdx.x + o];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = sh[0];
}

template <bool PRE, typename Tin>
cudaError_t ln_pos_fwd(const Tin* x, const float* pos, const float* s, const float* b, Dropout dr,
                       Tin* out, int B, int T, int D, cudaStream_t stream) {
  const int rows = B * T;
  ln_pos_kernel<Tin, PRE><<<(rows + LN_WARPS - 1) / LN_WARPS, LN_THREADS, 0, stream>>>(
      x, pos, s, b, dr, out, rows, T, D);
  return cudaGetLastError();
}

// PRE: no pos, pos_part or dpos.
template <bool PRE, typename Tin>
cudaError_t ln_pos_bwd(const Tin* x, const float* pos, const Tin* dout, const float* s,
                       Dropout dr, Tin* dx, float* pos_part, float* sb_part, float* dpos,
                       float* dsb, int B, int T, int D, int chunks, cudaStream_t stream) {
  ln_pos_bwd_kernel<Tin, PRE><<<dim3(T, chunks), LN_THREADS, 0, stream>>>(
      x, pos, dout, s, dr, dx, pos_part, sb_part, B, T, D, chunks);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (!PRE) {
    reduce_partials_kernel<<<(T * D + 255) / 256, 256, 0, stream>>>(pos_part, chunks, T * D,
                                                                    dpos);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  colsum_kernel<<<2 * D, LN_THREADS, 0, stream>>>(sb_part, chunks * T, 2 * D, dsb);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, out: [B, T, D] fp32 (bf16 == 0) or bf16, D <= 512; pos: [T, D],
// scale, bias: [D] fp32; drop, seed, thresh, drop_scale: the dropout
// (common.cuh Dropout); device: the card that holds them.
int recblr_ln_pos_fwd(const void* x, const void* pos, const void* scale, const void* bias,
                      void* out, int B, int T, int D, int bf16, int drop,
                      unsigned long long seed, unsigned thresh, float drop_scale, int device,
                      void* stream) {
  // this library has its own (static) CUDA runtime: select the tensors' card
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout dr = make_dropout(drop, seed, thresh, drop_scale);
  const float* p = static_cast<const float*>(pos);
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  if (bf16)
    return ln_pos_fwd<false>(static_cast<const __nv_bfloat16*>(x), p, s, b, dr,
                             static_cast<__nv_bfloat16*>(out), B, T, D, st);
  return ln_pos_fwd<false>(static_cast<const float*>(x), p, s, b, dr, static_cast<float*>(out),
                           B, T, D, st);
}

// x, dout, dx: [B, T, D] fp32 (bf16 == 0) or bf16; pos [T, D], scale [D]
// fp32 (bias is not read); pos_part: [chunks, T, D] and sb_part:
// [chunks * T, 2D] fp32 scratch; dpos: [T, D] and dsb: [2D] (dscale then
// dbias) fp32 out; the forward's dropout; device: the card.
int recblr_ln_pos_bwd(const void* x, const void* pos, const void* dout, const void* scale,
                      const void* bias, void* dx, void* pos_part, void* sb_part, void* dpos,
                      void* dsb, int B, int T, int D, int chunks, int bf16, int drop,
                      unsigned long long seed, unsigned thresh, float drop_scale, int device,
                      void* stream) {
  (void)bias;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout dr = make_dropout(drop, seed, thresh, drop_scale);
  const float* p = static_cast<const float*>(pos);
  const float* s = static_cast<const float*>(scale);
  float* pp = static_cast<float*>(pos_part);
  float* sp = static_cast<float*>(sb_part);
  float* dp = static_cast<float*>(dpos);
  float* dsbp = static_cast<float*>(dsb);
  if (bf16)
    return ln_pos_bwd<false>(static_cast<const __nv_bfloat16*>(x), p,
                             static_cast<const __nv_bfloat16*>(dout), s, dr,
                             static_cast<__nv_bfloat16*>(dx), pp, sp, dp, dsbp, B, T, D, chunks,
                             st);
  return ln_pos_bwd<false>(static_cast<const float*>(x), p, static_cast<const float*>(dout), s,
                           dr, static_cast<float*>(dx), pp, sp, dp, dsbp, B, T, D, chunks, st);
}

// LN(dropout(x)): x, out: [B, T, D] fp32 (bf16 == 0) or bf16, D <= 512;
// scale, bias: [D] fp32; the dropout of x (common.cuh Dropout, mask M0);
// device: the card that holds them.
int recblr_dropout_ln_fwd(const void* x, const void* scale, const void* bias, void* out, int B,
                          int T, int D, int bf16, int drop, unsigned long long seed,
                          unsigned thresh, float drop_scale, int device, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout dr = make_dropout(drop, seed, thresh, drop_scale);
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  if (bf16)
    return ln_pos_fwd<true>(static_cast<const __nv_bfloat16*>(x), nullptr, s, b, dr,
                            static_cast<__nv_bfloat16*>(out), B, T, D, st);
  return ln_pos_fwd<true>(static_cast<const float*>(x), nullptr, s, b, dr,
                          static_cast<float*>(out), B, T, D, st);
}

// Its backward: x, dout, dx: [B, T, D] fp32 (bf16 == 0) or bf16; scale
// [D] fp32; sb_part: [chunks * T, 2D] fp32 scratch; dsb: [2D] (dscale then
// dbias) fp32 out; the forward's dropout; device: the card.
int recblr_dropout_ln_bwd(const void* x, const void* dout, const void* scale, void* dx,
                          void* sb_part, void* dsb, int B, int T, int D, int chunks, int bf16,
                          int drop, unsigned long long seed, unsigned thresh, float drop_scale,
                          int device, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout dr = make_dropout(drop, seed, thresh, drop_scale);
  const float* s = static_cast<const float*>(scale);
  float* sp = static_cast<float*>(sb_part);
  float* dsbp = static_cast<float*>(dsb);
  if (bf16)
    return ln_pos_bwd<true>(static_cast<const __nv_bfloat16*>(x), nullptr,
                            static_cast<const __nv_bfloat16*>(dout), s, dr,
                            static_cast<__nv_bfloat16*>(dx), nullptr, sp, nullptr, dsbp, B, T, D,
                            chunks, st);
  return ln_pos_bwd<true>(static_cast<const float*>(x), nullptr,
                          static_cast<const float*>(dout), s, dr, static_cast<float*>(dx),
                          nullptr, sp, nullptr, dsbp, B, T, D, chunks, st);
}

const char* recblr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
