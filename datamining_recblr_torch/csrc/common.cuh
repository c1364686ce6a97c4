// Shared device code of the RecBLR recurrent-layer kernels
// (fused_layer.cu, fused_layer_last.cu and, through common_bwd.cuh,
// their backwards).
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
//
// Dropout masks are counter-based Philox4x32-10 draws (ops/philox.py is
// the plain version): the key is the call's 64-bit seed and the counter
// is (channel / 4, position, row, mask id), so a mask element depends on
// (seed, mask, row, position, channel) alone.  A halo row, a recomputing
// backward and the plain PyTorch version all see the same bits.
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

// Mask ids of the Philox counter: m0 prologue, m1 after W_out (the
// transformer layer's W_o), m2 FFN inner (RecBLR only), m3 FFN out (the
// order of the TPU kernel's draws); ATTN_PROB + h the transformer layer's
// probabilities of head h, with the key index as the channel and the
// query position as t (ops/philox.py documents the same ids).
enum MaskId { M0 = 0, M1 = 1, M2 = 2, M3 = 3, ATTN_PROB = 4 };

struct Dropout {
  unsigned k0, k1;  // Philox key: low and high words of the call's seed
  unsigned thresh;  // keep iff bits < thresh = min(keep * 2^32, 2^32 - 1)
  float scale;      // 1 / keep
  int on;           // 0: no masks at all (dropout p = 0)
};

inline Dropout make_dropout(int on, unsigned long long seed, unsigned thresh, float scale) {
  Dropout d;
  d.k0 = (unsigned)(seed & 0xffffffffull);
  d.k1 = (unsigned)(seed >> 32);
  d.thresh = thresh;
  d.scale = scale;
  d.on = on;
  return d;
}

// Philox4x32 with 10 rounds (Salmon et al., SC'11; Random123's constants).
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, unsigned k0, unsigned k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const unsigned hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// Scaled keep-mask element (0 or 1/keep) of mask m at (row b, position
// t, channel ch); 1 when dropout is off.
__device__ __forceinline__ float drop_mask(const Dropout& dr, int m, int b, int t, int ch) {
  if (!dr.on) return 1.f;
  const uint4 w = philox4x32_10(make_uint4((unsigned)ch >> 2, (unsigned)t, (unsigned)b,
                                           (unsigned)m), dr.k0, dr.k1);
  const int q = ch & 3;
  const unsigned bits = q == 0 ? w.x : q == 1 ? w.y : q == 2 ? w.z : w.w;
  return bits < dr.thresh ? dr.scale : 0.f;
}

__device__ __forceinline__ float load_act(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_act(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_act(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store_act(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

// A matmul operand: rounded to bf16 (and back) when RB.
template <bool RB>
__device__ __forceinline__ float mm_op(float v) {
  if (RB) return __bfloat162float(__float2bfloat16(v));
  return v;
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

// out[m, n] = sum_k a[m, k] * w[k, n] (+ bias[n]) for m < M, n < N
// (ACC: out[m, n] += that sum).  a lives in shared memory with row
// stride lda and must have ceil(M / RM) * RM readable rows; w is global
// with row stride ldw.  Each thread keeps RM accumulators for one
// column, so a warp reads one broadcast value of `a` and 32 consecutive
// weights per step.
template <bool ACC = false>
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
    for (int r = 0; r < RM; ++r) {
      if (m0 + r >= M) continue;
      if (ACC)
        out[(m0 + r) * ldo + n] += acc[r] + b;
      else
        out[(m0 + r) * ldo + n] = acc[r] + b;
    }
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

// Rows per (row, chunk) of the chunked layer's record: row 0 the scan
// state entering the chunk, rows 1 .. K-1 the previous chunk's last K-1
// xb rows (pre-conv, after W_in), the rest zero.
constexpr int REC_ROWS = MAX_K;

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
               Dropout dr, float* __restrict__ alpha_out, float* __restrict__ bx_out,
               int T, int D, int C, int K, int use_conv, int prologue,
               float* __restrict__ tail_out = nullptr, int chunk = 0) {
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
    float v = 0.f;
    if (t >= 0) {
      v = load_act(x, ((size_t)b * T + t) * D + d);
      if (prologue) v *= drop_mask(dr, M0, b, t, d);
    }
    xs[i] = v;
  }
  __syncthreads();
  if (prologue) {
    block_layernorm(xs, D, rows_h, D, p.pl_s, p.pl_b);
    __syncthreads();
  }
  block_matmul(xs, D, rows_h, D, p.w_in, 2 * C, C, nullptr, xb, C);
  __syncthreads();
  if (tail_out != nullptr) {
    // the chunked layer's record: the last K-1 xb rows of chunk j are rows
    // 1 .. K-1 of chunk j + 1's REC_ROWS rows
    const int nc = T / chunk;
    for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
      const int r = i / C, c = i % C, t = t0 + r;
      const int j = t / chunk, q = t % chunk - (chunk - (K - 1));
      if (q >= 0 && j + 1 < nc)
        tail_out[(((size_t)b * nc + j + 1) * REC_ROWS + 1 + q) * C + c] = xb[(r + H) * C + c];
    }
  }

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
            const float* __restrict__ h, Tin* __restrict__ out, LayerParams p, Dropout dr,
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
      if (prologue) v *= drop_mask(dr, M0, b, t0 + r, d);
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
  // the masks of the last-position layer are [B, 1, .]: row t0 + r, position 0
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    const float m = LAST ? drop_mask(dr, M1, t0 + r, 0, d) : drop_mask(dr, M1, b, t0 + r, d);
    ys[i] = ys[i] * m + xs[i];
  }
  __syncthreads();
  block_layernorm(ys, D, rows, D, p.ln1_s, p.ln1_b);
  __syncthreads();
  const float* res = ys;
  if (use_ffn) {
    block_matmul(ys, D, rows, D, p.w1, F, F, p.b1, a1, F);
    __syncthreads();
    for (int i = threadIdx.x; i < rows * F; i += blockDim.x) {
      const int r = i / F, f = i % F;
      const float m = LAST ? drop_mask(dr, M2, t0 + r, 0, f) : drop_mask(dr, M2, b, t0 + r, f);
      a1[i] = silu_t(a1[i]) * m;
    }
    __syncthreads();
    block_matmul(a1, F, rows, F, p.w2, D, D, p.b2, xs, D);
    __syncthreads();
    for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
      const int r = i / D, d = i % D;
      const float m = LAST ? drop_mask(dr, M3, t0 + r, 0, d) : drop_mask(dr, M3, b, t0 + r, d);
      xs[i] = xs[i] * m + ys[i];
    }
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

// Forward scan of the full layer, in place: bx_h holds beta*xc on entry
// and h on exit.  One thread per (row, channel), serial over T.
__global__ void __launch_bounds__(SCAN_THREADS)
scan_kernel(const float* __restrict__ alpha, float* __restrict__ bx_h, int B, int T, int C) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * C) return;
  const int b = i / C, c = i % C;
  size_t o = (size_t)b * T * C + c;
  float h = 0.f;
  for (int t = 0; t < T; ++t, o += C) {
    h = alpha[o] * h + bx_h[o];
    bx_h[o] = h;
  }
}

// Forward scan of the last-position layer: stops at each row's valid
// length and writes the state there to h_last; with `stash`, also h over
// bx at the positions below the length (the others are left as they are).
__global__ void __launch_bounds__(SCAN_THREADS)
scan_last_kernel(const float* __restrict__ alpha, float* __restrict__ bx,
                 const int* __restrict__ lens, float* __restrict__ h_last, int B, int T,
                 int C, int stash) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * C) return;
  const int b = i / C, c = i % C;
  const int n = valid_len(lens[b], T);
  size_t o = (size_t)b * T * C + c;
  float h = 0.f;
  for (int t = 0; t < n; ++t, o += C) {
    h = alpha[o] * h + bx[o];
    if (stash) bx[o] = h;
  }
  h_last[i] = h;
}

// Pass 1 of the chunked scan: one thread per (row, chunk, channel), with
// T = nc * chunk.  The chunk's scan from a zero state, to its last
// position: hend = that state, pend = the product of the chunk's gates
// ([B, nc, C]); the true state there is hend + pend * (the state entering
// the chunk).
__global__ void __launch_bounds__(SCAN_THREADS)
chunk_state_kernel(const float* __restrict__ alpha, const float* __restrict__ bx,
                   float* __restrict__ hend, float* __restrict__ pend, int B, int T, int C,
                   int chunk) {
  const int nc = T / chunk;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * nc * C) return;
  const int c = i % C, j = (i / C) % nc, b = i / (C * nc);
  size_t o = ((size_t)b * T + (size_t)j * chunk) * C + c;
  float h = 0.f, pr = 1.f;
  for (int t = 0; t < chunk; ++t, o += C) {
    const float a = alpha[o];
    h = a * h + bx[o];
    pr *= a;
  }
  hend[i] = h;
  pend[i] = pr;
}

// Pass 2 of the chunked scan: one thread per (row, chunk, channel).  The
// state entering the chunk is read from the record (rec_in, [B, nc,
// REC_ROWS, C], row 0) or composed from the earlier chunks' (hend, pend)
// and written to rec_out; then the chunk's scan from it, h over bx in
// place, as scan_kernel's serial loop.
__global__ void __launch_bounds__(SCAN_THREADS)
chunk_scan_kernel(const float* __restrict__ alpha, float* __restrict__ bx_h,
                  const float* __restrict__ hend, const float* __restrict__ pend,
                  const float* __restrict__ rec_in, float* __restrict__ rec_out, int B, int T,
                  int C, int chunk) {
  const int nc = T / chunk;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * nc * C) return;
  const int c = i % C, j = (i / C) % nc, b = i / (C * nc);
  const size_t r0 = ((size_t)b * nc + j) * REC_ROWS * C + c;
  float h;
  if (rec_in != nullptr) {
    h = rec_in[r0];
  } else {
    h = 0.f;
    for (int jj = 0; jj < j; ++jj) {
      const size_t k = ((size_t)b * nc + jj) * C + c;
      h = hend[k] + pend[k] * h;
    }
    rec_out[r0] = h;
  }
  size_t o = ((size_t)b * T + (size_t)j * chunk) * C + c;
  for (int t = 0; t < chunk; ++t, o += C) {
    h = alpha[o] * h + bx_h[o];
    bx_h[o] = h;
  }
}

}  // namespace recblr
