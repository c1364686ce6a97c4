// Shared device code of the transformer-layer kernels (fused_block.cu,
// fused_block_last.cu, fused_block_sel.cu and, through attn_bwd.cuh, their
// backwards): the parameter struct, a small shared-memory FMA matmul (the
// backwards', and the last-query and selected-positions forwards' attention
// loops), the masked softmax, the activations, and the forwards' projection
// phase and tail after attention on the tensor cores (mma_smem.cuh).
//
// All math is fp32.  With bf16 input (RB = true) every matmul operand of
// the forward is rounded to bf16 as it is read and the products are
// summed in fp32, as the TPU kernels' _make_mm / _bmm do; softmax and LN
// stay fp32.  In fp32 the tensor-core products are 3xTF32.  The backwards
// read the forward's operands rounded the same way and keep every gradient
// operand fp32.
//
// Dropout: Philox masks (common.cuh drop_mask) M1 after W_o and M3 after
// the FFN at the hidden rate, ATTN_PROB + h on head h's probabilities at
// the attention rate, both keyed by the call's seed.
#pragma once

#include <type_traits>

#include "attention.cuh"
#include "common.cuh"
#include "mma_smem.cuh"

namespace recblr {

constexpr float MASK_VALUE = -10000.0f;  // additive mask of the reference model
constexpr int ATT_THREADS = 256;         // threads per block
constexpr int PROJ_ROWS = 128;           // positions per block of the projection phase
constexpr int FC = 128;                  // FFN columns per chunk held in shared memory

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

// Projection phase on the tensor cores (mma_smem.cuh).  Block i: rows
// r0 = i PROJ_ROWS .. of x viewed as [B * T, D].  For each j < nproj:
// out[r, j*D : (j+1)*D] = x[r] @ w[j] + bias[j], W_j staged in shared
// memory by cp.async and the x tile read once for all nproj products.  In
// fp32 the rows of a sequence that keeps no key (lens <= 0) are FMA sums in
// depth order instead: all its scores sit at -10000, where an fp32 ulp is
// 2^-10, so a last-bit difference in q or k can move a probability by 0.1%,
// and 3xTF32's error is several times an FMA sum's.
struct ProjParams {
  const float* w[3];
  const float* b[3];
};

template <bool RB>
inline size_t proj_smem_bytes(int D) {
  return sizeof(float) * ((size_t)PROJ_ROWS * ld_k<RB>(pad16(D)) + (size_t)pad16(D) * ld_n<RB>(D));
}

template <typename Tin>
__global__ void __launch_bounds__(ATT_THREADS)
proj_kernel(const Tin* __restrict__ x, const int* __restrict__ lens, ProjParams pp, int nproj,
            float* __restrict__ out, long long nrows, int T, int D) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int keeps_none[PROJ_ROWS];  // the row's sequence keeps no key
  constexpr bool RB = IS_BF16<Tin>;
  const long long r0 = (long long)blockIdx.x * PROJ_ROWS;
  const int rows = (int)min((long long)PROJ_ROWS, nrows - r0);
  int mine = 0;
  for (int m = threadIdx.x; m < PROJ_ROWS; m += blockDim.x) {
    keeps_none[m] = !RB && m < rows && lens[(r0 + m) / T] <= 0;
    mine |= keeps_none[m];
  }
  const bool fma_rows = __syncthreads_or(mine);
  const int D16 = pad16(D), lx = ld_k<RB>(D16), lw = ld_n<RB>(D);
  float* xs = smem;                // [PROJ_ROWS][lx] x rows, zero beyond rows and D
  float* ws = xs + PROJ_ROWS * lx;  // [D16][lw] W_j
  if constexpr (RB) {
    for (int i = threadIdx.x; i < PROJ_ROWS * D16; i += blockDim.x) {
      const int r = i / D16, c = i % D16;
      xs[r * lx + c] = r < rows && c < D ? load_act(x, (size_t)(r0 + r) * D + c) : 0.f;
    }
  } else {
    stage<false>(xs, lx, x + (size_t)r0 * D, D, rows, D, PROJ_ROWS, D16);
  }
  const int ld = nproj * D;
  float* o = out + (size_t)r0 * ld;
  for (int j = 0; j < nproj; ++j) {
    if (j > 0) __syncthreads();  // every warp is done with W_{j-1}
    stage<false>(ws, lw, pp.w[j], D, D, D, D16, pad8(D));
    __syncthreads();
    const float* bias = pp.b[j];
    mma_mm<RB, false, 2, 4>(xs, lx, ws, lw, rows, D, D16, [&](int m, int n, float v) {
      if (!keeps_none[m]) o[(size_t)m * ld + j * D + n] = v + __ldg(bias + n);
    });
    if (fma_rows)
      for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
        const int m = i / D, n = i % D;
        if (!keeps_none[m]) continue;
        float acc = 0.f;
        for (int k = 0; k < D; ++k) acc = fmaf(xs[m * lx + k], ws[k * lw + n], acc);
        o[(size_t)m * ld + j * D + n] = acc + __ldg(bias + n);
      }
  }
}

// x [B * T, D] -> out [B * T, nproj * D] fp32 (proj_kernel), one launch.
template <typename Tin>
cudaError_t launch_proj(const Tin* x, const int* lens, const ProjParams& pp, int nproj,
                        float* out, long long nrows, int T, int D, cudaStream_t stream) {
  const size_t sm = proj_smem_bytes<IS_BF16<Tin>>(D);
  cudaError_t e = cudaFuncSetAttribute(proj_kernel<Tin>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm);
  if (e != cudaSuccess) return e;
  proj_kernel<Tin><<<(unsigned)((nrows + PROJ_ROWS - 1) / PROJ_ROWS), ATT_THREADS, sm, stream>>>(
      x, lens, pp, nproj, out, nrows, T, D);
  return cudaGetLastError();
}

// The shared-memory buffers of the layer's tail (block_tail), each of
// pad16(M) rows: xs (the layer input), cs (the attention context), ys and
// fs at row stride ld = ld_k<RB>(pad16(D)); as (an FFN chunk) and, in
// fp32, al (its tf32_split lo terms) at la = ld_k<RB>(FC); ws,
// tail_ws_floats<RB>(D) floats, where the weights are staged.  The caller
// zeroes the columns of cs and ys from D to pad16(D): the depth padding the
// products read.  In fp32 the tail splits each product's A operand once
// (mma_smem.cuh split_tf32) into buffers it no longer needs: cs into cs and
// fs, then ys into cs and xs.
struct TailBufs {
  float *xs, *cs, *ys, *fs, *as, *al, *ws;
  int ld, la;
};

template <bool RB>
__host__ __device__ inline int tail_ws_floats(int D) {
  const int a = pad16(D) * ld_n<RB>(FC), b = FC * ld_n<RB>(pad16(D));  // W1 and W2 chunks
  return a > b ? a : b;
}

// v[m, d] = (v[m, d] + bias[d]) * mask(m, d) + res[m, d] for m < M, d < D,
// the hidden dropout mask `id` at row m's coordinates: one Philox call
// for four channels (drop_mask4).
template <typename Coord>
__device__ void drop_residual(float* v, const float* res, int ld, int M, int D,
                              const float* bias, const Dropout& drh, int id, Coord coord) {
  const int G = (D + 3) / 4;
  for (int i = threadIdx.x; i < M * G; i += blockDim.x) {
    const int r = i / G, g = i % G;
    int b, t;
    coord(r, b, t);
    const float4 mk = drop_mask4(drh, id, b, t, g);
    const float m4[4] = {mk.x, mk.y, mk.z, mk.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int d = 4 * g + q;
      if (d >= D) break;
      float* e = v + r * ld + d;
      const float z = bias ? *e + __ldg(bias + d) : *e;
      *e = z * m4[q] + res[r * ld + d];
    }
  }
}

// The layer after attention, on rows i < M held in shared memory:
//   ys = LN1(m1 * (cs @ W_o + b_o) + xs)
//   fs = LN2(m3 * (act(ys @ W1 + b1) @ W2 + b2) + ys)
// every product on the tensor cores (mma_mm) with its weights staged in
// ws: W_o whole, W1 and W2 in chunks of FC FFN columns through as.
// coord(i, b, t) gives row i's mask coordinates.
template <bool RB, typename Coord>
__device__ void block_tail(const TailBufs& s, int M, int D, int I, int act,
                           const BlockParams& p, const Dropout& drh, Coord coord) {
  constexpr bool AS = !RB;  // fp32: A operands split once
  const int D16 = pad16(D), lw = ld_n<RB>(D16), l1 = ld_n<RB>(FC);
  __syncthreads();  // cs is complete and ws free
  stage<false>(s.ws, lw, p.w_o, D, D, D, D16, pad8(D));
  if constexpr (AS) split_tf32(s.cs, s.cs, s.fs, s.ld, M, D16);
  __syncthreads();
  mma_mm<RB, false, 2, 1, AS>(s.cs, s.ld, s.ws, lw, M, D, D16, [&](int m, int n, float v) {
    s.ys[m * s.ld + n] = v + __ldg(p.b_o + n);
  }, s.fs);
  __syncthreads();
  const int fc0 = min(FC, I);  // W1's first chunk lands during LN1
  stage<false>(s.ws, l1, p.w1, I, D, fc0, D16, pad8(fc0), false);
  drop_residual(s.ys, s.xs, s.ld, M, D, nullptr, drh, M1, coord);
  __syncthreads();
  block_layernorm(s.ys, s.ld, M, D, p.ln1_s, p.ln1_b);
  if constexpr (AS) {
    __syncthreads();
    split_tf32(s.ys, s.cs, s.xs, s.ld, M, D16);
  }
  const float* a1 = AS ? s.cs : s.ys;  // W1's A operand (fp32: its hi terms)
  for (int c0 = 0; c0 < I; c0 += FC) {
    const int fc = min(FC, I - c0);
    if (c0 > 0) {
      __syncthreads();  // ws and as free
      stage<false>(s.ws, l1, p.w1 + c0, I, D, fc, D16, pad8(fc));
    } else {
      cp_async_wait_all();
    }
    if (fc % 16)  // W2's depth padding
      for (int i = threadIdx.x; i < M * 16; i += blockDim.x) {
        const int c = fc + i % 16;
        if (c < pad16(fc)) {
          s.as[(i / 16) * s.la + c] = 0.f;
          if constexpr (AS) s.al[(i / 16) * s.la + c] = 0.f;
        }
      }
    __syncthreads();  // W1's chunk landed, A complete
    mma_mm<RB, false, 2, 2, AS>(a1, s.ld, s.ws, l1, M, fc, D16, [&](int m, int n, float v) {
      const float a = act_fwd(act, v + __ldg(p.b1 + c0 + n));
      if constexpr (AS) {
        uint32_t h, l;
        tf32_split(a, h, l);
        s.as[m * s.la + n] = __uint_as_float(h);
        s.al[m * s.la + n] = __uint_as_float(l);
      } else {
        s.as[m * s.la + n] = a;
      }
    }, s.xs);
    __syncthreads();
    stage<false>(s.ws, lw, p.w2 + (size_t)c0 * D, D, fc, D, pad16(fc), pad8(D));
    __syncthreads();
    mma_mm<RB, false, 2, 1, AS>(s.as, s.la, s.ws, lw, M, D, pad16(fc), [&](int m, int n, float v) {
      float* f = s.fs + m * s.ld + n;
      *f = c0 == 0 ? v : *f + v;
    }, s.al);
  }
  __syncthreads();
  drop_residual(s.fs, s.ys, s.ld, M, D, p.b2, drh, M3, coord);
  __syncthreads();
  block_layernorm(s.fs, s.ld, M, D, p.ln2_s, p.ln2_b);
  __syncthreads();
}

}  // namespace recblr
