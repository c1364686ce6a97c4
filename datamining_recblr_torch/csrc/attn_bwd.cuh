// Shared device code of the transformer-layer backward kernels
// (fused_block_bwd.cu, fused_block_last_bwd.cu, fused_block_sel_bwd.cu).
//
// A layer's backward reads what its training forward kept: the fp32
// q/k/v (last-query layer: k/v) projections and the attention context.
// It replays the Philox masks from their counters and runs three phases,
// all fp32 inside:
//   T'  per item of TRW = 56 rows (positions; last-query layer: batch rows
//       at their query position): recompute the tail forward from the
//       context (W_o, LN1, the FFN in FC-column chunks, LN2) and run its
//       backward: the LN, FFN and W_o weight grads, the residual part of
//       dx (dxr) and dctx.
//   A'  the attention backward (in the layer's own source).
//   P'  per item of TRW positions: the Q/K/V weight and bias grads and
//       dx = dxr + [dq dk dv] @ [W_q W_k W_v]^T.
// Weight grads are summed without atomics: a fixed grid of blocks walks
// the items in a fixed order, each block adding into its own fp32 slice
// of `partial` [G, P]; reduce_partials_kernel (common_bwd.cuh) then sums
// the G slices in order, so two runs give the same bits.
//
// What bounds T' and P': fp32 FMAs (at B 2,048, T 200, D 64, FFN 256, T'
// does ~104 GFLOP with the FFN's first product recomputed, P' ~20).  The
// design keeps them on the FMA pipe: every product is smem_mm
// (gemm_tile.cuh), a register tile of 4x4 outputs a thread fed by
// 16-byte shared-memory loads, with both operands in shared memory (each
// weight staged from L2 by cp.async once per product); items of 56 rows,
// so each staged weight and each read-modify-write of the block's slice
// of `partial` serves 1.75 times the rows it did at 32.  Partial traffic
// at that shape: T' 37,504 floats and P' 12,480 a slice per item, read
// and written, over 7,315 items each: 2.19 + 0.73 GB (12,800 items of 32
// rows before: 3.84 + 1.28 GB).  The grid is one wave of resident blocks
// (two T' blocks an SM at D 64, three P' blocks), so the slices in use
// stay in L2.  M1 and M3 are drawn once per item, one Philox call per
// four channels, and kept as bits.
//
// bf16 (RB): the forward's operands (x, the context, r1, the FFN
// activation, every weight) are rounded to bf16 once, as they are staged
// or formed, as the forward rounds them; every gradient operand stays
// fp32 (the plain versions' _RoundBF16 passes gradients unrounded).
#pragma once

#include <algorithm>

#include "attn_common.cuh"
#include "common_bwd.cuh"
#include "gemm_tile.cuh"

namespace recblr {

// Rows per T' and P' item: 56 lets two T' blocks share an SM at D 64
// (108.8 KB of shared memory each), so one block's LN, mask and
// reduction phases overlap the other's products.
constexpr int TRW = 56;
constexpr int MAX_SMEM_BYTES = 227 * 1024;  // dynamic shared memory a block may hold
constexpr int TWO_BLOCKS_SMEM_BYTES = 113 * 1024;  // two blocks an SM

// The blocks of one wave of `kernel` at `threads` threads and `smem`
// bytes each on the current card: a grid-stride phase launches no more,
// so its partial slices in use stay few.
template <typename K>
inline int resident_blocks(K kernel, int threads, size_t smem) {
  int dev = 0, sms = 1, per = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, threads, smem);
  return std::max(1, sms * per);
}

// Which rows a T' or P' pass walks, and where each row's query sits:
// every position of every row (the full layer), each batch row at its
// position lens - 1 (the last-query layer), or each batch row at its S
// selected positions sel[b, s] (the selected-positions layer).
enum RowMode { ROWS_ALL = 0, ROWS_LAST = 1, ROWS_SEL = 2 };

// Offsets of each parameter's gradient in a flat row of P floats, in
// BlockParams order.
enum BlockGradIdx {
  BG_W_Q, BG_B_Q, BG_W_K, BG_B_K, BG_W_V, BG_B_V, BG_W_O, BG_B_O,
  BG_LN1_S, BG_LN1_B, BG_W1, BG_B1, BG_W2, BG_B2, BG_LN2_S, BG_LN2_B
};

struct BlockGradLayout {
  int off[N_BLOCK_PARAMS];
  int total;
};

inline BlockGradLayout block_grad_layout(int D, int I) {
  const int sizes[N_BLOCK_PARAMS] = {D * D, D, D * D, D, D * D, D, D * D, D,
                                     D,     D, D * I, I, I * D, D, D,     D};
  BlockGradLayout g;
  int o = 0;
  for (int i = 0; i < N_BLOCK_PARAMS; ++i) {
    g.off[i] = o;
    o += sizes[i];
  }
  g.total = o;
  return g;
}

// Rows of an activation into shared memory in fp32, as stage (gemm_tile.cuh)
// does for fp32 (unrounded); bf16 rows four elements (8 bytes) a load
// where they are aligned, four loads in flight a thread.
__device__ __forceinline__ void stage_act(float* dst, int ldd, const float* src, size_t lds,
                                          int rows, int cols, int rows_pad, int cols_pad) {
  stage<false>(dst, ldd, src, lds, rows, cols, rows_pad, cols_pad);
}
__device__ __forceinline__ void stage_act(float* dst, int ldd, const __nv_bfloat16* src,
                                          size_t lds, int rows, int cols, int rows_pad,
                                          int cols_pad) {
  const bool vec = cols % 4 == 0 && lds % 4 == 0 && (reinterpret_cast<size_t>(src) & 7) == 0;
  const int w = vec ? 4 : 1, cw = cols_pad / w;
#pragma unroll 4
  for (int i = threadIdx.x; i < rows_pad * cw; i += blockDim.x) {
    const int r = i / cw, c = (i % cw) * w;
    float* d = dst + r * ldd + c;
    if (r >= rows || c >= cols) {
      for (int q = 0; q < w; ++q) d[q] = 0.f;
    } else if (vec) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(src + r * lds + c));
      const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
      *reinterpret_cast<float4*>(d) = make_float4(lo.x, lo.y, hi.x, hi.y);
    } else {
      d[0] = __bfloat162float(src[r * lds + c]);
    }
  }
}

// ---------------------------------------------------------------------------
// T': the tail backward
// ---------------------------------------------------------------------------

// Shared memory of T' at width D with FFN chunks of FC columns: four
// [TRW, ld_of(D)] row arrays, the FFN chunk's pre-activation and
// activation [TRW, FC + 4], the weight operand of the current product,
// two LN scales a row and the M1 / M3 keep bits.
__host__ __device__ inline int tail_weight_floats(int D, int FC) {
  const int Dp = pad8(D), LD = ld_of(D), LF = FC + 4;
  const int a = Dp * LD, b = Dp * LF, c = FC * LD;
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}
__host__ __device__ inline size_t attn_tail_bwd_smem_bytes(int D, int FC) {
  const size_t LD = ld_of(D), LF = FC + 4, mw = (pad8(D) + 31) / 32;
  return sizeof(float) *
         (4 * TRW * LD + 2 * TRW * LF + tail_weight_floats(D, FC) + 2 * TRW + 2 * TRW * mw);
}

// The FFN chunk of T': the widest of 128, 64, 32 columns (no wider than
// the FFN) with which two blocks share an SM, else the widest that fits
// one block.
inline int attn_tail_bwd_fc(int D, int I) {
  const size_t limits[2] = {TWO_BLOCKS_SMEM_BYTES, MAX_SMEM_BYTES};
  for (size_t limit : limits)
    for (int fc = 128; fc >= 32; fc /= 2)
      if ((fc == 32 || fc / 2 < pad8(I)) && attn_tail_bwd_smem_bytes(D, fc) <= limit) return fc;
  return 32;
}

// ROWS_ALL: row n of N = B*T is (b, t) = (n / T, n % T); x, ctx, dout,
// dxr and dctx are [N, D].  ROWS_LAST: row n of N = B is batch row n at
// its query position, x the selected row (zeros where none); ctx, dout,
// dxr and dctx are [B, D].  ROWS_SEL: row n of N = B*S is batch row n / S
// at position sel[n], x that row; ctx, dout, dxr and dctx are [B*S, D].
// Items are TRW rows; rows of an item beyond N are zeros in every operand
// (their gradients are exactly 0, so they add nothing to a weight grad).
template <typename Tin, int MODE>
__global__ void __launch_bounds__(ATT_THREADS, 2)
attn_tail_bwd_kernel(const Tin* __restrict__ x, const int* __restrict__ lens,
                     const float* __restrict__ ctx, const Tin* __restrict__ dout, BlockParams p,
                     Dropout drh, float* __restrict__ dxr, float* __restrict__ dctx,
                     float* __restrict__ partial, BlockGradLayout gl, int N, int T, int D,
                     int I, int act, const int* __restrict__ sel, int S, int FC) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool RB = IS_BF16<Tin>;
  const int Dp = pad8(D), LD = ld_of(D), LF = FC + 4, MW = (Dp + 31) / 32;
  float* v1 = smem;              // [TRW, LD] LN1 input -> vhat1
  float* r1 = v1 + TRW * LD;     // [TRW, LD] LN1 output; at the end the context
  float* cv = r1 + TRW * LD;     // [TRW, LD] context -> LN2 input -> vhat2 -> df2 -> dao
  float* g = cv + TRW * LD;      // [TRW, LD] dout -> dv2 -> dr1 -> dv1
  float* pre = g + TRW * LD;     // [TRW, LF] FFN pre-activation chunk
  float* a1 = pre + TRW * LF;    // [TRW, LF] its activation (rounded) -> dpre1
  float* ws = a1 + TRW * LF;     // the staged weight of the current product
  float* inv1 = ws + tail_weight_floats(D, FC);  // [TRW]
  float* inv2 = inv1 + TRW;      // [TRW]
  unsigned* kb = reinterpret_cast<unsigned*>(inv2 + TRW);  // [2, TRW, MW] M1, M3 keep bits
  float* gp = partial + (size_t)blockIdx.x * gl.total;
  const int chunks = (I + FC - 1) / FC;
  const size_t total = attn_tail_bwd_smem_bytes(D, FC) / sizeof(float);
  for (size_t i = threadIdx.x; i < total; i += blockDim.x) smem[i] = 0.f;
  for (int n0 = blockIdx.x * TRW; n0 < N; n0 += gridDim.x * TRW) {
    const int M = min(TRW, N - n0);
    // mask coordinates of row r < M
    auto coord = [&](int r, int& rb, int& rt) {
      if (MODE == ROWS_LAST) {
        rb = n0 + r;
        rt = last_pos(lens[n0 + r], T);
      } else if (MODE == ROWS_SEL) {
        rb = (n0 + r) / S;
        rt = sel_pos(sel[n0 + r], T);
      } else {
        rb = (n0 + r) / T;
        rt = (n0 + r) % T;
      }
    };
    // the keep mask (scaled) of M1 (which 0) or M3 (which 1) at row r, channel d
    auto keep = [&](int which, int r, int d) {
      if (!drh.on) return 1.f;
      return (kb[(which * TRW + r) * MW + d / 32] >> (d % 32)) & 1u ? drh.scale : 0.f;
    };
    // the residual input x at row r < M, channel d < D
    auto x_at = [&](int r, int d) {
      if (MODE == ROWS_LAST) {
        const int nv = valid_len(lens[n0 + r], T);
        return nv > 0 ? load_act(x, ((size_t)(n0 + r) * T + nv - 1) * D + d) : 0.f;
      }
      if (MODE == ROWS_SEL)
        return load_act(x, ((size_t)((n0 + r) / S) * T + sel_pos(sel[n0 + r], T)) * D + d);
      return load_act(x, (size_t)(n0 + r) * D + d);
    };
    __syncthreads();  // the previous item's reads of shared memory are done
    // the M1 and M3 bits of the item, one Philox call per four channels
    if (drh.on) {
      for (int i = threadIdx.x; i < 2 * TRW * MW; i += blockDim.x) {
        const int which = i / (TRW * MW), r = (i / MW) % TRW, w = i % MW;
        unsigned bits = 0u;
        if (r < M) {
          int b, t;
          coord(r, b, t);
          for (int q = 0; q < 8 && 32 * w + 4 * q < D; ++q) {
            const float4 m = drop_mask4(drh, which ? M3 : M1, b, t, 8 * w + q);
            bits |= (unsigned)(m.x != 0.f) << (4 * q) | (unsigned)(m.y != 0.f) << (4 * q + 1) |
                    (unsigned)(m.z != 0.f) << (4 * q + 2) | (unsigned)(m.w != 0.f) << (4 * q + 3);
          }
        }
        kb[i] = bits;
      }
    }
    stage<RB>(cv, LD, ctx + (size_t)n0 * D, D, M, D, TRW, Dp);
    stage_act(g, LD, dout + (size_t)n0 * D, D, M, D, TRW, Dp);
    stage<RB>(ws, LD, p.w_o, D, D, D, Dp, Dp);
    __syncthreads();

    // --- the tail forward, with the replayed masks -----------------------
    // v1 = (ctx W_o + b_o) m1 + x
    smem_mm<4, 4, false, false>(cv, LD, ws, LD, TRW, Dp, Dp, [&](int m, int n, float v) {
      v1[m * LD + n] = m < M && n < D ? (v + __ldg(p.b_o + n)) * keep(0, m, n) + x_at(m, n) : 0.f;
    });
    __syncthreads();
    block_layernorm_save(v1, LD, TRW, D, inv1, p.ln1_s, p.ln1_b, r1, LD);
    if (RB) {  // r1 is read by products only; the residual recomputes it
      __syncthreads();
      for (int i = threadIdx.x; i < TRW * D; i += blockDim.x)
        r1[(i / D) * LD + i % D] = mm_op<true>(r1[(i / D) * LD + i % D]);
    }
    for (int c0 = 0; c0 < I; c0 += FC) {
      const int fc = min(FC, I - c0), fcp = pad8(fc);
      __syncthreads();
      stage<RB>(ws, LF, p.w1 + c0, I, D, fc, Dp, fcp);
      __syncthreads();
      smem_mm<4, 4, false, false>(r1, LD, ws, LF, TRW, fcp, Dp, [&](int m, int n, float v) {
        const float pv = n < fc ? v + __ldg(p.b1 + c0 + n) : 0.f;
        pre[m * LF + n] = pv;
        a1[m * LF + n] = n < fc ? mm_op<RB>(act_fwd(act, pv)) : 0.f;
      });
      __syncthreads();
      stage<RB>(ws, LD, p.w2 + (size_t)c0 * D, D, fc, D, fcp, Dp);
      __syncthreads();
      smem_mm<4, 4, false, false>(a1, LF, ws, LD, TRW, Dp, fcp, [&](int m, int n, float v) {
        cv[m * LD + n] = c0 == 0 ? v : cv[m * LD + n] + v;
      });
    }
    __syncthreads();
    for (int i = threadIdx.x; i < TRW * D; i += blockDim.x) {
      const int r = i / D, d = i % D, o = r * LD + d;
      // r1 = vhat1 s + b, as block_layernorm_save computes it (r1 itself
      // holds the bf16-rounded operand under RB)
      const float r1v = RB ? __fmaf_rn(v1[o], __ldg(p.ln1_s + d), __ldg(p.ln1_b + d)) : r1[o];
      cv[o] = r < M ? (cv[o] + __ldg(p.b2 + d)) * keep(1, r, d) + r1v : 0.f;
    }
    __syncthreads();
    block_layernorm_save(cv, LD, TRW, D, inv2, nullptr, nullptr, nullptr, 0);
    __syncthreads();

    // --- LN2 and the FFN backward ---------------------------------------
    block_colsum(g, LD, cv, LD, M, D, gp + gl.off[BG_LN2_S]);
    block_colsum(g, LD, nullptr, 0, M, D, gp + gl.off[BG_LN2_B]);
    __syncthreads();
    block_layernorm_bwd(g, LD, cv, LD, inv2, M, D, p.ln2_s);  // g = dv2 = dr1 so far
    __syncthreads();
    for (int i = threadIdx.x; i < TRW * D; i += blockDim.x) {
      const int r = i / D, d = i % D;
      cv[r * LD + d] = r < M ? g[r * LD + d] * keep(1, r, d) : 0.f;  // df2
    }
    __syncthreads();
    block_colsum(cv, LD, nullptr, 0, M, D, gp + gl.off[BG_B2]);
    for (int c0 = 0; c0 < I; c0 += FC) {
      const int fc = min(FC, I - c0), fcp = pad8(fc);
      if (chunks > 1) {  // one chunk: pre and a1 still hold it
        __syncthreads();
        stage<RB>(ws, LF, p.w1 + c0, I, D, fc, Dp, fcp);
        __syncthreads();
        smem_mm<4, 4, false, false>(r1, LD, ws, LF, TRW, fcp, Dp, [&](int m, int n, float v) {
          const float pv = n < fc ? v + __ldg(p.b1 + c0 + n) : 0.f;
          pre[m * LF + n] = pv;
          a1[m * LF + n] = n < fc ? mm_op<RB>(act_fwd(act, pv)) : 0.f;
        });
      }
      __syncthreads();
      // W2 grad += a1^T df2, while W2's chunk is staged for da1
      smem_mm_add<4, 4, true, false>(a1, LF, cv, LD, fcp, Dp, TRW, [&](int m, int n) {
        return m < fc && n < D ? gp + gl.off[BG_W2] + (size_t)(c0 + m) * D + n : nullptr;
      });
      stage<RB>(ws, LD, p.w2 + (size_t)c0 * D, D, fc, D, fcp, Dp);
      __syncthreads();
      // dpre1 = (df2 W2[c0:c0+fc]^T) act'(pre)
      smem_mm<4, 4, false, true>(cv, LD, ws, LD, TRW, fcp, Dp, [&](int m, int n, float v) {
        a1[m * LF + n] = n < fc ? v * act_bwd(act, pre[m * LF + n]) : 0.f;
      });
      __syncthreads();
      // W1 grad += r1^T dpre1 and b1's, while W1's chunk is staged for dr1
      smem_mm_add<4, 4, true, false>(r1, LD, a1, LF, Dp, fcp, TRW, [&](int m, int n) {
        return m < D && n < fc ? gp + gl.off[BG_W1] + (size_t)m * I + c0 + n : nullptr;
      });
      block_colsum(a1, LF, nullptr, 0, M, fc, gp + gl.off[BG_B1] + c0);
      stage<RB>(ws, LF, p.w1 + c0, I, D, fc, Dp, fcp);
      __syncthreads();
      // dr1 += dpre1 W1[:, c0:c0+fc]^T
      smem_mm<4, 4, false, true>(a1, LF, ws, LF, TRW, Dp, fcp, [&](int m, int n, float v) {
        g[m * LD + n] += v;
      });
    }
    __syncthreads();

    // --- LN1, W_o and the context ----------------------------------------
    block_colsum(g, LD, v1, LD, M, D, gp + gl.off[BG_LN1_S]);
    block_colsum(g, LD, nullptr, 0, M, D, gp + gl.off[BG_LN1_B]);
    __syncthreads();
    block_layernorm_bwd(g, LD, v1, LD, inv1, M, D, p.ln1_s);  // g = dv1
    __syncthreads();
    for (int i = threadIdx.x; i < TRW * Dp; i += blockDim.x) {
      const int r = i / Dp, d = i % Dp, o = r * LD + d;
      const bool in = r < M && d < D;
      if (in) dxr[(size_t)(n0 + r) * D + d] = g[o];
      cv[o] = in ? g[o] * keep(0, r, d) : 0.f;  // dao
    }
    stage<RB>(r1, LD, ctx + (size_t)n0 * D, D, M, D, TRW, Dp);
    stage<RB>(ws, LD, p.w_o, D, D, D, Dp, Dp);
    __syncthreads();
    block_colsum(cv, LD, nullptr, 0, M, D, gp + gl.off[BG_B_O]);
    smem_mm_add<4, 4, true, false>(r1, LD, cv, LD, Dp, Dp, TRW, [&](int m, int n) {
      return m < D && n < D ? gp + gl.off[BG_W_O] + m * D + n : nullptr;
    });
    // dctx = dao W_o^T
    smem_mm<4, 4, false, true>(cv, LD, ws, LD, TRW, Dp, Dp, [&](int m, int n, float v) {
      if (m < M && n < D) dctx[(size_t)(n0 + m) * D + n] = v;
    });
  }
}

template <typename Tin, int MODE>
cudaError_t launch_tail_bwd(const Tin* x, const int* lens, const float* ctx, const Tin* dout,
                            const BlockParams& p, const Dropout& drh, float* dxr, float* dctx,
                            float* partial, int G, const BlockGradLayout& gl, int N, int T,
                            int D, int I, int act, const int* sel, int S, cudaStream_t stream) {
  const int fc = attn_tail_bwd_fc(D, I);
  const size_t bytes = attn_tail_bwd_smem_bytes(D, fc);
  cudaError_t e = set_smem(attn_tail_bwd_kernel<Tin, MODE>, bytes);
  if (e != cudaSuccess) return e;
  const int resident = resident_blocks(attn_tail_bwd_kernel<Tin, MODE>, ATT_THREADS, bytes);
  const int grid = std::min({G, (N + TRW - 1) / TRW, resident});
  attn_tail_bwd_kernel<Tin, MODE><<<grid, ATT_THREADS, bytes, stream>>>(
      x, lens, ctx, dout, p, drh, dxr, dctx, partial, gl, N, T, D, I, act, sel, S, fc);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// P': the projection backward
// ---------------------------------------------------------------------------

// One projection's weight, and per item the x rows, one projection's
// grads of them and dx so far.
inline size_t proj_bwd_smem_bytes(int D) {
  return sizeof(float) * ((size_t)pad8(D) + 3 * TRW) * ld_of(D);
}

// Items are tiles of TRW of the B*T positions (row-major).  ROWS_ALL:
// dproj [B*T, 3D] holds dq, dk, dv and dx = dxr + dproj @ [W_q W_k W_v]^T
// with dxr [B*T, D].  ROWS_LAST and ROWS_SEL: dproj [B*T, 2D] holds dk, dv
// and dx = dproj @ [W_k W_v]^T, plus dxr[b] [B, D] at each row's position
// lens - 1 (ROWS_LAST), or plus the sum over s, in order, of dxr[b, s]
// [B, S, D] at the positions sel[b, s] (ROWS_SEL: repeated positions add
// up, one writer per element).  dx sums the projections' products in
// order, each taken whole.
template <typename Tin, int MODE>
__global__ void __launch_bounds__(ATT_THREADS)
proj_bwd_kernel(const Tin* __restrict__ x, const int* __restrict__ lens,
                const float* __restrict__ dproj, const float* __restrict__ dxr,
                Tin* __restrict__ dx, BlockParams p, float* __restrict__ partial,
                BlockGradLayout gl, int N, int T, int D, const int* __restrict__ sel, int S) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool RB = IS_BF16<Tin>;
  constexpr bool KV = MODE != ROWS_ALL;  // dproj holds dk, dv only
  constexpr int NP = KV ? 2 : 3;
  const float* w[3] = {KV ? p.w_k : p.w_q, KV ? p.w_v : p.w_k, p.w_v};
  const int gw[3] = {KV ? BG_W_K : BG_W_Q, KV ? BG_W_V : BG_W_K, BG_W_V};
  const int gb[3] = {KV ? BG_B_K : BG_B_Q, KV ? BG_B_V : BG_B_K, BG_B_V};
  const int Dp = pad8(D), LD = ld_of(D);
  float* ws = smem;            // [Dp, LD]  W_j (rounded)
  float* xs = ws + Dp * LD;    // [TRW, LD] x rows
  float* ds = xs + TRW * LD;   // [TRW, LD] their grads of projection j
  float* dxs = ds + TRW * LD;  // [TRW, LD] dx so far
  float* gp = partial + (size_t)blockIdx.x * gl.total;
  for (int w0 = blockIdx.x * TRW; w0 < N; w0 += gridDim.x * TRW) {
    const int M = min(TRW, N - w0);
    __syncthreads();
    stage_act(xs, LD, x + (size_t)w0 * D, D, M, D, TRW, Dp);
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      if (j) __syncthreads();  // projection j - 1's reads are done
      stage<false>(ds, LD, dproj + (size_t)w0 * NP * D + j * D, NP * D, M, D, TRW, Dp);
      stage<RB>(ws, LD, w[j], D, D, D, Dp, Dp);
      __syncthreads();
      // W_j grad += x^T d_j, b_j grad += sum d_j
      smem_mm_add<4, 4, true, false>(xs, LD, ds, LD, Dp, Dp, TRW, [&](int m, int c) {
        return m < D && c < D ? gp + gl.off[gw[j]] + m * D + c : nullptr;
      });
      block_colsum(ds, LD, nullptr, 0, M, D, gp + gl.off[gb[j]]);
      // dx (+)= d_j W_j^T
      smem_mm<4, 4, false, true>(ds, LD, ws, LD, TRW, Dp, Dp, [&](int m, int d, float v) {
        dxs[m * LD + d] = j ? dxs[m * LD + d] + v : v;
      });
    }
    __syncthreads();
    for (int i = threadIdx.x; i < M * D; i += blockDim.x) {
      const int m = i / D, d = i % D;
      const int n = w0 + m;
      float v = dxs[m * LD + d];
      if (MODE == ROWS_ALL) {
        v += dxr[(size_t)n * D + d];
      } else if (MODE == ROWS_LAST) {
        const int b = n / T;
        if (n % T == valid_len(lens[b], T) - 1) v += dxr[(size_t)b * D + d];
      } else {
        const int b = n / T, t = n % T;
        for (int s = 0; s < S; ++s)
          if (sel_pos(__ldg(sel + (size_t)b * S + s), T) == t)
            v += dxr[((size_t)b * S + s) * D + d];
      }
      store_act(dx, (size_t)n * D + d, v);
    }
  }
}

template <typename Tin, int MODE>
cudaError_t launch_proj_bwd(const Tin* x, const int* lens, const float* dproj, const float* dxr,
                            Tin* dx, const BlockParams& p, float* partial, int G,
                            const BlockGradLayout& gl, int N, int T, int D, const int* sel,
                            int S, cudaStream_t stream) {
  const size_t bytes = proj_bwd_smem_bytes(D);
  cudaError_t e = set_smem(proj_bwd_kernel<Tin, MODE>, bytes);
  if (e != cudaSuccess) return e;
  const int grid = std::min({G, (N + TRW - 1) / TRW,
                             resident_blocks(proj_bwd_kernel<Tin, MODE>, ATT_THREADS, bytes)});
  proj_bwd_kernel<Tin, MODE><<<grid, ATT_THREADS, bytes, stream>>>(
      x, lens, dproj, dxr, dx, p, partial, gl, N, T, D, sel, S);
  return cudaGetLastError();
}

}  // namespace recblr
