// Shared device code of the transformer-layer kernels (fused_block.cu,
// fused_block_last.cu, fused_block_sel.cu and, through attn_bwd.cuh, their
// backwards): the parameter struct, a small shared-memory matmul, the
// masked softmax, the activations and the layer's tail after attention.
//
// All math is fp32.  With bf16 input (RB = true) every matmul operand of
// the forward is rounded to bf16 as it is read and the products are
// summed in fp32, as the TPU kernels' _make_mm / _bmm do; softmax and LN
// stay fp32.  The backwards read the forward's operands rounded the same
// way and keep every gradient operand fp32.
//
// Dropout: Philox masks (common.cuh drop_mask) M1 after W_o and M3 after
// the FFN at the hidden rate, ATTN_PROB + h on head h's probabilities at
// the attention rate, both keyed by the call's seed.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace recblr {

constexpr float MASK_VALUE = -10000.0f;  // additive mask of the reference model
constexpr int ATT_THREADS = 256;         // threads per block
constexpr int PROJ_ROWS = 32;            // positions per block of the projection phase
constexpr int FC = 256;                  // FFN columns per chunk held in shared memory

// Parameter pointers in the order of the host-side array (all fp32;
// ops/fused_block.py PARAM_NAMES).
struct BlockParams {
  const float *w_q, *b_q, *w_k, *b_k, *w_v, *b_v, *w_o, *b_o;
  const float *ln1_s, *ln1_b, *w1, *b1, *w2, *b2, *ln2_s, *ln2_b;
};
constexpr int N_BLOCK_PARAMS = 16;

inline BlockParams unpack_block_params(const void* const* p) {
  BlockParams q;
  const float** dst = reinterpret_cast<const float**>(&q);
  for (int i = 0; i < N_BLOCK_PARAMS; ++i) dst[i] = static_cast<const float*>(p[i]);
  return q;
}

template <typename Tin>
constexpr bool IS_BF16 = std::is_same<Tin, __nv_bfloat16>::value;

// out[m, n] (+)= sum_k a[m, k] * b(k, n) (+ bias[n]) for m < M, n < N.
// a: shared memory, row stride lda, ceil(M / R) * R readable rows.
// TB = false: b(k, n) = w[k * ldw + n]; TB = true: b(k, n) = w[n * ldw + k].
// RA / RW: round a / b to bf16 as they are read.  Each thread keeps R
// accumulators for one column n, so a warp reads one broadcast value of
// `a` per step.  out may be shared or global.
template <int R, bool TB, bool RA, bool RW, bool ACC>
__device__ void tile_mm_r(const float* __restrict__ a, int lda, int M, int K,
                          const float* __restrict__ w, int ldw, int N,
                          const float* __restrict__ bias, float* __restrict__ out, int ldo) {
  const int mblocks = (M + R - 1) / R;
  for (int idx = threadIdx.x; idx < mblocks * N; idx += blockDim.x) {
    const int n = idx % N;
    const int m0 = (idx / N) * R;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float wv = mm_op<RW>(__ldg(TB ? w + (size_t)n * ldw + k : w + (size_t)k * ldw + n));
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(mm_op<RA>(a[(m0 + r) * lda + k]), wv, acc[r]);
    }
    const float bv = bias ? __ldg(bias + n) : 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (m0 + r >= M) continue;
      if (ACC)
        out[(size_t)(m0 + r) * ldo + n] += acc[r] + bv;
      else
        out[(size_t)(m0 + r) * ldo + n] = acc[r] + bv;
    }
  }
}

// The forward's product: both operands rounded when RB.
template <int R, bool TB, bool RB, bool ACC>
__device__ void tile_mm(const float* __restrict__ a, int lda, int M, int K,
                        const float* __restrict__ w, int ldw, int N,
                        const float* __restrict__ bias, float* __restrict__ out, int ldo) {
  tile_mm_r<R, TB, RB, RB, ACC>(a, lda, M, K, w, ldw, N, bias, out, ldo);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// In place over one row of T raw dot products (one warp): they become
// probabilities, softmax(dot * scale + mask) with exp(x) = exp2(x * log2 e).
// Key j is kept iff j < n and, when causal, j <= qpos; a dropped key adds
// exactly -10000, so a row whose keys are all dropped softmaxes over all
// T keys.  Multiply and add are rounded separately (no FMA), as the plain
// version computes them.
__device__ void softmax_row(float* row, int T, int n, int causal, int qpos, float scale) {
  const int lane = threadIdx.x % 32;
  float mx = __int_as_float(0xff800000);  // -inf
  for (int j = lane; j < T; j += 32) {
    const bool keep = j < n && (!causal || j <= qpos);
    const float v = __fadd_rn(__fmul_rn(row[j], scale), keep ? 0.f : MASK_VALUE);
    row[j] = v;
    mx = fmaxf(mx, v);
  }
  mx = warp_max(mx);
  float sum = 0.f;
  for (int j = lane; j < T; j += 32) {
    const float e = exp_t(__fsub_rn(row[j], mx));
    row[j] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  for (int j = lane; j < T; j += 32) row[j] = __fdiv_rn(row[j], sum);
}

// softmax_row over rows i < M of s (row stride ld), query position
// qpos0 + i, one warp per row.
__device__ void masked_softmax_rows(float* s, int ld, int M, int T, int n, int causal,
                                    int qpos0, float scale) {
  for (int i = threadIdx.x / 32; i < M; i += blockDim.x / 32)
    softmax_row(s + (size_t)i * ld, T, n, causal, qpos0 + i, scale);
}

// The FFN activation on its pre-activation (ops/fused_block.py act_fwd):
// 0 gelu (tanh form), 1 relu, 2 silu, 3 tanh, 4 sigmoid.
__device__ __forceinline__ float act_fwd(int act, float x) {
  switch (act) {
    case 0: {
      const float g = 0.7978845608028654f * (x + 0.044715f * x * x * x);
      return 0.5f * x * (1.f + tanhf(g));
    }
    case 1:
      return fmaxf(x, 0.f);
    case 2:
      return silu_t(x);
    case 3:
      return tanhf(x);
    default:
      return sigmoid_t(x);
  }
}

// Its derivative (the gradient autograd takes of ops/fused_block.py
// act_fwd; the df of the TPU kernel's _act_pair).
__device__ __forceinline__ float act_bwd(int act, float x) {
  switch (act) {
    case 0: {
      const float th = tanhf(0.7978845608028654f * (x + 0.044715f * x * x * x));
      const float dg = 0.7978845608028654f * (1.f + 3.f * 0.044715f * x * x);
      return 0.5f * (1.f + th) + 0.5f * x * (1.f - th * th) * dg;
    }
    case 1:
      return x > 0.f ? 1.f : 0.f;
    case 2: {
      const float sg = sigmoid_t(x);
      return sg * (1.f + x * (1.f - sg));
    }
    case 3: {
      const float th = tanhf(x);
      return 1.f - th * th;
    }
    default: {
      const float sg = sigmoid_t(x);
      return sg * (1.f - sg);
    }
  }
}

// The query position of a last-query row: lens - 1, or 0 where the length
// selects nothing; the coordinates of that row's dropout masks.
__device__ __forceinline__ int last_pos(int len, int T) {
  const int n = valid_len(len, T);
  return n > 0 ? n - 1 : 0;
}

// A selected position of the selected-positions layer, clamped into
// [0, T - 1] (ops/fused_block.py sel_positions): its query row and the
// coordinates of its masks.
__device__ __forceinline__ int sel_pos(int v, int T) { return min(max(v, 0), T - 1); }

// The selected-positions layer's query tile: its S queries in the fewest
// tiles of at most 32 rows, each a multiple of 8 (S 40: 24 and 16).
inline int sel_tile(int S) {
  const int n = (S + 31) / 32;
  return ((S + n - 1) / n + 7) / 8 * 8;
}

// probs[i, j] *= the mask of head h at (row, query qpos(i), key j) for
// i < M, j < T; nothing when attention dropout is off.
template <typename QCoord>
__device__ void drop_probs(float* probs, int ld, int M, int T, const Dropout& dra, int h,
                           QCoord coord) {
  if (!dra.on) return;
  for (int i = threadIdx.x; i < M * T; i += blockDim.x) {
    const int r = i / T, j = i % T;
    int b, t;
    coord(r, b, t);
    probs[(size_t)r * ld + j] *= drop_mask(dra, ATTN_PROB + h, b, t, j);
  }
}

// Projection phase.  Block (b, tile): positions t0 .. t0+PROJ_ROWS-1 of
// row b.  For each j < nproj: out[b, t, j*D : (j+1)*D] = x[b, t] @ w[j] + bias[j].
struct ProjParams {
  const float* w[3];
  const float* b[3];
};

template <typename Tin>
__global__ void __launch_bounds__(ATT_THREADS)
proj_kernel(const Tin* __restrict__ x, ProjParams pp, int nproj, float* __restrict__ out,
            int T, int D) {
  extern __shared__ float smem[];
  constexpr bool RB = IS_BF16<Tin>;
  const int b = blockIdx.x;
  const int t0 = blockIdx.y * PROJ_ROWS;
  const int rows = min(PROJ_ROWS, T - t0);
  float* xs = smem;  // [PROJ_ROWS, D]
  for (int i = threadIdx.x; i < PROJ_ROWS * D; i += blockDim.x) {
    const int r = i / D;
    xs[i] = r < rows ? load_act(x, ((size_t)b * T + t0) * D + i) : 0.f;
  }
  __syncthreads();
  const int ld = nproj * D;
  float* o = out + ((size_t)b * T + t0) * ld;
  for (int j = 0; j < nproj; ++j)
    tile_mm<8, false, RB, false>(xs, D, rows, D, pp.w[j], D, D, pp.b[j], o + j * D, ld);
}

inline size_t proj_smem_bytes(int D) { return sizeof(float) * (size_t)PROJ_ROWS * D; }

// The layer after attention, on rows i < M held in shared memory:
//   ys = LN1(m1 * (cs @ W_o + b_o) + xs)
//   fs = LN2(m3 * (act(ys @ W1 + b1) @ W2 + b2) + ys)
// with the FFN in chunks of FC columns through as [., FC]; coord(i, b, t)
// gives row i's mask coordinates.  R: the row blocking of the matmuls
// (the arrays hold ceil(M / R) * R rows).
template <int R, bool RB, typename Coord>
__device__ void block_tail(const float* cs, const float* xs, float* ys, float* as, float* fs,
                           int M, int D, int I, int act, const BlockParams& p,
                           const Dropout& drh, Coord coord) {
  tile_mm<R, false, RB, false>(cs, D, M, D, p.w_o, D, D, p.b_o, ys, D);
  __syncthreads();
  for (int i = threadIdx.x; i < M * D; i += blockDim.x) {
    int b, t;
    coord(i / D, b, t);
    ys[i] = ys[i] * drop_mask(drh, M1, b, t, i % D) + xs[i];
  }
  __syncthreads();
  block_layernorm(ys, D, M, D, p.ln1_s, p.ln1_b);
  __syncthreads();
  for (int c0 = 0; c0 < I; c0 += FC) {
    const int fc = min(FC, I - c0);
    tile_mm<R, false, RB, false>(ys, D, M, D, p.w1 + c0, I, fc, p.b1 + c0, as, FC);
    __syncthreads();
    for (int i = threadIdx.x; i < M * fc; i += blockDim.x) {
      const int r = i / fc, f = i % fc;
      as[r * FC + f] = act_fwd(act, as[r * FC + f]);
    }
    __syncthreads();
    if (c0 == 0)
      tile_mm<R, false, RB, false>(as, FC, M, fc, p.w2, D, D, nullptr, fs, D);
    else
      tile_mm<R, false, RB, true>(as, FC, M, fc, p.w2 + (size_t)c0 * D, D, D, nullptr, fs, D);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < M * D; i += blockDim.x) {
    int b, t;
    coord(i / D, b, t);
    fs[i] = (fs[i] + p.b2[i % D]) * drop_mask(drh, M3, b, t, i % D) + ys[i];
  }
  __syncthreads();
  block_layernorm(fs, D, M, D, p.ln2_s, p.ln2_b);
  __syncthreads();
}

}  // namespace recblr
