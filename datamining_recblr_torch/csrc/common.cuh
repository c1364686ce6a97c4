// Shared device code of the RecBLR recurrent-layer forward kernels
// (fused_layer.cu, fused_layer_last.cu).
//
// Each layer forward runs in three hand-written phases, all fp32 inside:
//   A  per (row, time tile): [prologue LN] -> xb = x @ W_in[:, :C] ->
//      causal conv + SiLU -> gates matmul -> alpha, beta*xc to scratch
//   B  the BD-LRU scan, one thread per (row, channel), serial over T
//   C  per tile of positions: z = x @ W_in[:, C:] -> silu(z)*h @ W_out ->
//      LN1 residual -> SiLU FFN -> LN2 residual
// Matmuls are fp32 FMA from shared memory (no TF32), so the kernels
// agree with the plain fp32 versions to rounding.  The work outside
// the scan is per time step apart from the conv's (K-1)-step halo,
// which phase A recomputes from x at the tile's left edge.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace recblr {

constexpr float LN_EPS = 1e-12f;    // LayerNorm eps of the reference model
constexpr float GATE_EPS = 1e-8f;   // beta = sqrt(1 - a^2 + eps) * sigmoid(i)
constexpr float LOG2E = 1.4426950408889634f;
constexpr int TT = 32;              // positions per block in phases A and C
constexpr int MAX_K = 8;            // conv taps the halo is sized for
constexpr int THREADS = 256;        // threads per block in phases A and C
constexpr int SCAN_THREADS = 128;
constexpr int RM = 8;               // output rows per thread in block_matmul
// rows of x / xb held by phase A: the tile plus the halo, rounded up to RM
constexpr int XR = (TT + MAX_K - 1 + RM - 1) / RM * RM;

// Parameter pointers in the order of the host-side array (all fp32).
struct LayerParams {
  const float *w_in, *wc, *bc, *wg, *bg, *lam, *w_out, *ln1_s, *ln1_b;
  const float *w1, *b1, *w2, *b2, *ln2_s, *ln2_b;
  const float *pl_s, *pl_b;
};
constexpr int N_PARAMS = 17;

inline LayerParams unpack_params(const void* const* p) {
  LayerParams q;
  const float** dst = reinterpret_cast<const float**>(&q);
  for (int i = 0; i < N_PARAMS; ++i) dst[i] = static_cast<const float*>(p[i]);
  return q;
}

__device__ __forceinline__ float load_act(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_act(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_act(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store_act(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

__device__ __forceinline__ float sigmoid_t(float x) { return 0.5f * tanhf(0.5f * x) + 0.5f; }
__device__ __forceinline__ float silu_t(float x) { return x * sigmoid_t(x); }
__device__ __forceinline__ float exp_t(float x) { return exp2f(x * LOG2E); }
// log(1 + e^x) that cannot overflow for large x
__device__ __forceinline__ float softplus_t(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// A row of length len >= 1 selects position len-1; any other value
// selects nothing (the one-hot `pos == lens-1` of the TPU kernel).
__device__ __forceinline__ int valid_len(int len, int T) {
  return (len >= 1 && len <= T) ? len : 0;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// out[m, n] = sum_k a[m, k] * w[k, n] (+ bias[n]) for m < M, n < N.
// a lives in shared memory with row stride lda and must have
// ceil(M / RM) * RM readable rows; w is global with row stride ldw.
// Each thread keeps RM accumulators for one column, so a warp reads one
// broadcast value of `a` and 32 consecutive weights per step.
__device__ void block_matmul(const float* __restrict__ a, int lda, int M, int K,
                             const float* __restrict__ w, int ldw, int N,
                             const float* __restrict__ bias,
                             float* __restrict__ out, int ldo) {
  const int mblocks = (M + RM - 1) / RM;
  for (int idx = threadIdx.x; idx < mblocks * N; idx += blockDim.x) {
    const int n = idx % N;
    const int m0 = (idx / N) * RM;
    float acc[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) acc[r] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float wv = __ldg(w + (size_t)k * ldw + n);
#pragma unroll
      for (int r = 0; r < RM; ++r) acc[r] = fmaf(a[(m0 + r) * lda + k], wv, acc[r]);
    }
    const float b = bias ? __ldg(bias + n) : 0.f;
#pragma unroll
    for (int r = 0; r < RM; ++r)
      if (m0 + r < M) out[(m0 + r) * ldo + n] = acc[r] + b;
  }
}

// v[m, :D] <- LN(v[m, :D]) * s + b for m < M, one warp per row.
__device__ void block_layernorm(float* v, int ld, int M, int D,
                                const float* __restrict__ s,
                                const float* __restrict__ b) {
  const int lane = threadIdx.x % 32;
  for (int m = threadIdx.x / 32; m < M; m += blockDim.x / 32) {
    float* row = v + m * ld;
    float sum = 0.f;
    for (int d = lane; d < D; d += 32) sum += row[d];
    const float mu = warp_sum(sum) / D;
    float sq = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float t = row[d] - mu;
      sq += t * t;
    }
    const float inv = rsqrtf(warp_sum(sq) / D + LN_EPS);
    for (int d = lane; d < D; d += 32) row[d] = (row[d] - mu) * inv * s[d] + b[d];
  }
}

inline size_t phase_a_smem_bytes(int D, int C) {
  return sizeof(float) * ((size_t)XR * D + (size_t)XR * C + (size_t)TT * C + (size_t)TT * 2 * C);
}

// Phase A.  Block (b, tile): positions t0 .. t_end-1 of row b.  Writes
// alpha and beta*xc [B, T, C] fp32.  With `lens`, tiles at or beyond
// row b's valid length are skipped: the last-position layer reads the
// scan only below it.
template <typename Tin>
__global__ void __launch_bounds__(THREADS)
phase_a_kernel(const Tin* __restrict__ x, const int* __restrict__ lens, LayerParams p,
               float* __restrict__ alpha_out, float* __restrict__ bx_out,
               int T, int D, int C, int K, int use_conv, int prologue) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int t0 = blockIdx.y * TT;
  int t_end = min(t0 + TT, T);
  if (lens != nullptr) t_end = min(t_end, valid_len(lens[b], T));
  if (t0 >= t_end) return;
  const int H = use_conv ? K - 1 : 0;
  const int rows = t_end - t0;
  const int rows_h = rows + H;
  float* xs = smem;             // [XR, D]   x rows t0-H .. t_end-1
  float* xb = xs + XR * D;      // [XR, C]   x @ W_in[:, :C] on those rows
  float* xc = xb + XR * C;      // [TT, C]   silu(conv(xb))
  float* g = xc + TT * C;       // [TT, 2C]  gates pre-activation

  for (int i = threadIdx.x; i < rows_h * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    const int t = t0 - H + r;
    xs[i] = t >= 0 ? load_act(x, ((size_t)b * T + t) * D + d) : 0.f;
  }
  __syncthreads();
  if (prologue) {
    block_layernorm(xs, D, rows_h, D, p.pl_s, p.pl_b);
    __syncthreads();
  }
  block_matmul(xs, D, rows_h, D, p.w_in, 2 * C, C, nullptr, xb, C);
  __syncthreads();

  for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
    const int r = i / C, c = i % C;
    float v;
    if (use_conv) {
      // u[t] = x[t]*wc[K-1] + bc + sum_{j>=1} x[t-j]*wc[K-1-j], zero history
      const int rr = r + H;
      float u = xb[rr * C + c] * p.wc[(K - 1) * C + c] + p.bc[c];
      for (int j = 1; j < K; ++j) {
        const float xv = (t0 + r - j >= 0) ? xb[(rr - j) * C + c] : 0.f;
        u += xv * p.wc[(K - 1 - j) * C + c];
      }
      v = silu_t(u);
    } else {
      v = xb[r * C + c];
    }
    xc[i] = v;
  }
  __syncthreads();
  block_matmul(xc, C, rows, C, p.wg, 2 * C, 2 * C, p.bg, g, 2 * C);
  __syncthreads();

  for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
    const int r = i / C, c = i % C;
    const float sr = sigmoid_t(g[r * 2 * C + c]);
    const float si = sigmoid_t(g[r * 2 * C + C + c]);
    const float a = exp_t(-softplus_t(p.lam[c]) * sr);
    const float beta = sqrtf(1.f - a * a + GATE_EPS) * si;
    const size_t o = ((size_t)b * T + t0 + r) * C + c;
    alpha_out[o] = a;
    bx_out[o] = beta * xc[i];
  }
}

inline size_t tail_smem_bytes(int D, int C, int F) {
  return sizeof(float) * (size_t)TT * (2 * D + C + F);
}

// Phase C.  LAST = false: block (b, tile) covers positions t0.. of row
// b, h is [B, T, C], out is [B, T, D].  LAST = true: block (tile) covers
// batch rows b0.., each at its last valid position (x_last = 0 and
// h_last = 0 where nothing is selected), h is [B, C], out is [B, D].
template <typename Tin, bool LAST>
__global__ void __launch_bounds__(THREADS)
tail_kernel(const Tin* __restrict__ x, const int* __restrict__ lens,
            const float* __restrict__ h, Tin* __restrict__ out, LayerParams p,
            int B, int T, int D, int C, int F, int use_ffn, int prologue) {
  extern __shared__ float smem[];
  float* xs = smem;            // [TT, D]  layer input (post-prologue); later f2
  float* zs = xs + TT * D;     // [TT, C]  z, then silu(z) * h
  float* ys = zs + TT * C;     // [TT, D]  y, then r1 = LN1(y + x)
  float* a1 = ys + TT * D;     // [TT, F]  silu(r1 @ W1 + b1)
  int b = blockIdx.x, t0 = 0, rows;
  if (LAST) {
    t0 = blockIdx.x * TT;  // first batch row of the tile
    rows = min(TT, B - t0);
  } else {
    t0 = blockIdx.y * TT;
    rows = min(TT, T - t0);
  }

  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    float v;
    if (LAST) {
      const int n = valid_len(lens[t0 + r], T);
      v = n > 0 ? load_act(x, ((size_t)(t0 + r) * T + n - 1) * D + d) : 0.f;
    } else {
      v = load_act(x, ((size_t)b * T + t0 + r) * D + d);
    }
    xs[i] = v;
  }
  __syncthreads();
  if (prologue) {
    block_layernorm(xs, D, rows, D, p.pl_s, p.pl_b);
    __syncthreads();
  }
  block_matmul(xs, D, rows, D, p.w_in + C, 2 * C, C, nullptr, zs, C);
  __syncthreads();
  for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
    const int r = i / C, c = i % C;
    const size_t ho = LAST ? (size_t)(t0 + r) * C + c : ((size_t)b * T + t0 + r) * C + c;
    zs[i] = silu_t(zs[i]) * h[ho];
  }
  __syncthreads();
  block_matmul(zs, C, rows, C, p.w_out, D, D, nullptr, ys, D);
  __syncthreads();
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) ys[i] += xs[i];
  __syncthreads();
  block_layernorm(ys, D, rows, D, p.ln1_s, p.ln1_b);
  __syncthreads();
  const float* res = ys;
  if (use_ffn) {
    block_matmul(ys, D, rows, D, p.w1, F, F, p.b1, a1, F);
    __syncthreads();
    for (int i = threadIdx.x; i < rows * F; i += blockDim.x) a1[i] = silu_t(a1[i]);
    __syncthreads();
    block_matmul(a1, F, rows, F, p.w2, D, D, p.b2, xs, D);
    __syncthreads();
    for (int i = threadIdx.x; i < rows * D; i += blockDim.x) xs[i] += ys[i];
    __syncthreads();
    block_layernorm(xs, D, rows, D, p.ln2_s, p.ln2_b);
    __syncthreads();
    res = xs;
  }
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    const size_t o = LAST ? (size_t)(t0 + r) * D + d : ((size_t)b * T + t0 + r) * D + d;
    store_act(out, o, res[i]);
  }
}

}  // namespace recblr
