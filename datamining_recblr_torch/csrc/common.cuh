// Shared device code of the RecBLR recurrent-layer kernels
// (fused_layer.cu, fused_layer_last.cu, fused_layer_chunked.cu,
// fused_bdlru.cu, their backwards, and what the other kernels borrow).
//
// Each layer forward runs in three hand-written phases:
//   A  per (row, time tile): [prologue LN] -> xb = x @ W_in[:, :C] ->
//      causal conv + SiLU -> gates matmul -> alpha, beta*xc to scratch
//   B  the BD-LRU scan, one thread per (row, channel), serial over T
//   C  per tile of positions: z = x @ W_in[:, C:] -> silu(z)*h @ W_out ->
//      LN1 residual -> SiLU FFN -> LN2 residual
// Phases A and C are layer_fwd.cuh's (their products on the tensor cores
// at fp32 accuracy); the scans of phase B, the layer's parameters, the
// Philox masks and the fp32 helpers are here.  The work outside the scan
// is per time step apart from the conv's (K-1)-step halo, which phase A
// recomputes from x at the tile's left edge.
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
constexpr int TT = 32;              // positions a tile of phase A and of the gate backward
constexpr int THREADS = 256;        // threads per block in phases A and C
constexpr int SCAN_THREADS = 128;

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

// The standalone BD-LRU's parameters (fused_bdlru.cu): wc, bc, wg, bg,
// lam in that order; the layer's other pointers stay null.
inline LayerParams unpack_bdlru_params(const void* const* p) {
  LayerParams q = {};
  q.wc = static_cast<const float*>(p[0]);
  q.bc = static_cast<const float*>(p[1]);
  q.wg = static_cast<const float*>(p[2]);
  q.bg = static_cast<const float*>(p[3]);
  q.lam = static_cast<const float*>(p[4]);
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

// drop_mask of channels 4g .. 4g+3 at once: the four words of one Philox
// call (the same bits drop_mask draws channel by channel).
__device__ __forceinline__ float4 drop_mask4(const Dropout& dr, int m, int b, int t, int g) {
  if (!dr.on) return make_float4(1.f, 1.f, 1.f, 1.f);
  const uint4 w = philox4x32_10(make_uint4((unsigned)g, (unsigned)t, (unsigned)b, (unsigned)m),
                                dr.k0, dr.k1);
  auto keep = [&](unsigned bits) { return bits < dr.thresh ? dr.scale : 0.f; };
  return make_float4(keep(w.x), keep(w.y), keep(w.z), keep(w.w));
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
// xb rows (pre-conv, after W_in), the rest zero.  The chunked layer takes
// K <= 8, the JAX package's bound (fused_layer_chunked.py:380).
constexpr int REC_ROWS = 8;

// Rows of x and of xb a phase-A or gate-backward tile holds: its TT
// positions and the conv's K - 1 halo rows, sized at run time.  The layer
// kernels and the standalone BD-LRU take K <= 64 (ops/fused_layer.py,
// ops/fused_bdlru.py MAX_K).
inline __host__ __device__ int xb_rows(int K) { return TT + K - 1; }

// The linear scan, in either direction, any C.  Forward h_t = g_t
// h_{t-1} + x_t from t = 0; REV h_t = g'_t h_{t+1} + x_t from t = T-1,
// with g'_t = g_t, or with `shift` g'_t = g_{t+1} and g'_{T-1} = 1 (the
// VJP's shift_left(gates), for a caller that holds the unshifted gates).
// h starts from 0.  One thread per (row, channel), serial over T;
// neighbouring threads read neighbouring channels.  Gates fp32; tokens
// and h fp32 or bf16, the sum fp32.  x and h may be the same array (the
// layers scan beta*xc into h in place, and reverse-scan dh into d_states):
// the steps go in groups of SCAN_GROUP, and a group reads all its gates
// and tokens before it writes any h, so SCAN_GROUP loads are in flight
// whether or not the arrays alias.
constexpr int SCAN_GROUP = 4;

template <bool REV, typename Tx, typename Th>
__global__ void __launch_bounds__(SCAN_THREADS)
linear_scan_kernel(const float* __restrict__ g, const Tx* x, Th* h, int B, int T, int C,
                   int shift) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * C) return;
  const int b = i / C, c = i % C;
  const size_t row = (size_t)b * T * C + c;
  float acc = 0.f;
  for (int s0 = 0; s0 < T; s0 += SCAN_GROUP) {
    float gv[SCAN_GROUP], xv[SCAN_GROUP];
#pragma unroll
    for (int k = 0; k < SCAN_GROUP; ++k) {
      const int t = REV ? T - 1 - (s0 + k) : s0 + k;
      if (s0 + k < T) {
        const size_t o = row + (size_t)t * C;
        gv[k] = !(REV && shift) ? g[o] : t + 1 < T ? g[o + C] : 1.f;
        xv[k] = load_act(x, o);
      }
    }
#pragma unroll
    for (int k = 0; k < SCAN_GROUP; ++k) {
      const int t = REV ? T - 1 - (s0 + k) : s0 + k;
      if (s0 + k < T) {
        acc = gv[k] * acc + xv[k];
        store_act(h, row + (size_t)t * C, acc);
      }
    }
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
// place, as linear_scan_kernel's serial loop.
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
