// Shared device code of the transformer-layer backward kernels
// (fused_block_bwd.cu, fused_block_last_bwd.cu, fused_block_sel_bwd.cu).
//
// A layer's backward reads what its training forward kept: the fp32
// q/k/v (last-query layer: k/v) projections and the attention context.
// It replays the Philox masks from their counters and runs three phases,
// all fp32 inside:
//   T'  per tile of TR rows (positions; last-query layer: batch rows at
//       their query position): recompute the tail forward from the
//       context (W_o, LN1, the FFN in FC-column chunks, LN2) and run its
//       backward: the LN, FFN and W_o weight grads, the residual part of
//       dx (dxr) and dctx.
//   A'  the attention backward (in the layer's own source).
//   P'  per tile of PR positions: the Q/K/V weight and bias grads and
//       dx = dxr + [dq dk dv] @ [W_q W_k W_v]^T.
// Weight grads are summed without atomics: a fixed grid of blocks walks
// the items in a fixed order, each block adding into its own fp32 slice
// of `partial` [G, P]; reduce_partials_kernel (common_bwd.cuh) then sums
// the G slices in order, so two runs give the same bits.
//
// bf16 (RB): the forward's operands (x, the context, r1, the FFN
// activation, every weight) are rounded to bf16 as they are read, as in
// the forward; every gradient operand stays fp32 (the plain versions'
// _RoundBF16 passes gradients unrounded).
#pragma once

#include "attn_common.cuh"
#include "common_bwd.cuh"

namespace recblr {

constexpr int TR = 32;  // rows per T' item
constexpr int PR = 32;  // positions per P' item

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

// ---------------------------------------------------------------------------
// T': the tail backward
// ---------------------------------------------------------------------------

inline size_t attn_tail_bwd_smem_bytes(int D) {
  return sizeof(float) * ((size_t)TR * (8 * D + 2 * FC) + 2 * TR);
}

// ROWS_ALL: row n of N = B*T is (b, t) = (n / T, n % T); x, ctx, dout,
// dxr and dctx are [N, D].  ROWS_LAST: row n of N = B is batch row n at
// its query position, x the selected row (zeros where none); ctx, dout,
// dxr and dctx are [B, D].  ROWS_SEL: row n of N = B*S is batch row n / S
// at position sel[n], x that row; ctx, dout, dxr and dctx are [B*S, D].
template <typename Tin, int MODE>
__global__ void __launch_bounds__(ATT_THREADS)
attn_tail_bwd_kernel(const Tin* __restrict__ x, const int* __restrict__ lens,
                     const float* __restrict__ ctx, const Tin* __restrict__ dout, BlockParams p,
                     Dropout drh, float* __restrict__ dxr, float* __restrict__ dctx,
                     float* __restrict__ partial, BlockGradLayout gl, int N, int T, int D,
                     int I, int act, const int* __restrict__ sel, int S) {
  extern __shared__ float smem[];
  constexpr bool RB = IS_BF16<Tin>;
  float* xs = smem;            // [TR, D]  the residual input
  float* cs = xs + TR * D;     // [TR, D]  the context
  float* v1 = cs + TR * D;     // [TR, D]  LN1 input -> vhat1
  float* r1 = v1 + TR * D;     // [TR, D]  LN1 output
  float* v2 = r1 + TR * D;     // [TR, D]  LN2 input -> vhat2
  float* g = v2 + TR * D;      // [TR, D]  dout -> dv2
  float* dr = g + TR * D;      // [TR, D]  dr1 -> dv1
  float* df = dr + TR * D;     // [TR, D]  df2, then dao
  float* pre = df + TR * D;    // [TR, FC] FFN pre-activation chunk
  float* a1 = pre + TR * FC;   // [TR, FC] its activation -> da1 -> dpre1
  float* inv1 = a1 + TR * FC;  // [TR]
  float* inv2 = inv1 + TR;     // [TR]
  float* gp = partial + (size_t)blockIdx.x * gl.total;
  const int chunks = (I + FC - 1) / FC;
  for (int w = blockIdx.x; w * TR < N; w += gridDim.x) {
    const int n0 = w * TR;
    const int M = min(TR, N - n0);
    // mask coordinates of row r
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
    __syncthreads();  // the previous item's reads of shared memory are done
    for (int i = threadIdx.x; i < TR * D; i += blockDim.x) {
      const int r = i / D, d = i % D;
      float xv = 0.f, cv = 0.f, gv = 0.f;
      if (r < M) {
        const size_t o = (size_t)(n0 + r) * D + d;
        if (MODE == ROWS_LAST) {
          const int nv = valid_len(lens[n0 + r], T);
          if (nv > 0) xv = load_act(x, ((size_t)(n0 + r) * T + nv - 1) * D + d);
        } else if (MODE == ROWS_SEL) {
          const int bb = (n0 + r) / S;
          xv = load_act(x, ((size_t)bb * T + sel_pos(sel[n0 + r], T)) * D + d);
        } else {
          xv = load_act(x, o);
        }
        cv = ctx[o];
        gv = load_act(dout, o);
      }
      xs[i] = xv;
      cs[i] = cv;
      g[i] = gv;
    }
    __syncthreads();

    // --- the tail forward, with the replayed masks -----------------------
    tile_mm<8, false, RB, false>(cs, D, M, D, p.w_o, D, D, p.b_o, v1, D);
    __syncthreads();
    for (int i = threadIdx.x; i < M * D; i += blockDim.x) {
      int b, t;
      coord(i / D, b, t);
      v1[i] = v1[i] * drop_mask(drh, M1, b, t, i % D) + xs[i];
    }
    __syncthreads();
    block_layernorm_save(v1, D, M, D, inv1, p.ln1_s, p.ln1_b, r1, D);
    __syncthreads();
    for (int c0 = 0; c0 < I; c0 += FC) {
      const int fc = min(FC, I - c0);
      tile_mm<8, false, RB, false>(r1, D, M, D, p.w1 + c0, I, fc, p.b1 + c0, pre, FC);
      __syncthreads();
      for (int i = threadIdx.x; i < M * fc; i += blockDim.x) {
        const int r = i / fc, f = i % fc;
        a1[r * FC + f] = act_fwd(act, pre[r * FC + f]);
      }
      __syncthreads();
      if (c0 == 0)
        tile_mm<8, false, RB, false>(a1, FC, M, fc, p.w2, D, D, nullptr, v2, D);
      else
        tile_mm<8, false, RB, true>(a1, FC, M, fc, p.w2 + (size_t)c0 * D, D, D, nullptr, v2, D);
      __syncthreads();
    }
    for (int i = threadIdx.x; i < M * D; i += blockDim.x) {
      int b, t;
      coord(i / D, b, t);
      v2[i] = (v2[i] + p.b2[i % D]) * drop_mask(drh, M3, b, t, i % D) + r1[i];
    }
    __syncthreads();
    block_layernorm_save(v2, D, M, D, inv2, nullptr, nullptr, nullptr, 0);
    __syncthreads();

    // --- LN2 and the FFN backward ---------------------------------------
    block_colsum(g, D, v2, D, M, D, gp + gl.off[BG_LN2_S]);
    block_colsum(g, D, nullptr, 0, M, D, gp + gl.off[BG_LN2_B]);
    __syncthreads();
    block_layernorm_bwd(g, D, v2, D, inv2, M, D, p.ln2_s);  // g = dv2
    __syncthreads();
    for (int i = threadIdx.x; i < M * D; i += blockDim.x) {
      int b, t;
      coord(i / D, b, t);
      df[i] = g[i] * drop_mask(drh, M3, b, t, i % D);  // df2
      dr[i] = g[i];
    }
    __syncthreads();
    block_colsum(df, D, nullptr, 0, M, D, gp + gl.off[BG_B2]);
    for (int c0 = 0; c0 < I; c0 += FC) {
      const int fc = min(FC, I - c0);
      if (chunks > 1) {  // one chunk: pre and a1 still hold it
        tile_mm<8, false, RB, false>(r1, D, M, D, p.w1 + c0, I, fc, p.b1 + c0, pre, FC);
        __syncthreads();
        for (int i = threadIdx.x; i < M * fc; i += blockDim.x) {
          const int r = i / fc, f = i % fc;
          a1[r * FC + f] = act_fwd(act, pre[r * FC + f]);
        }
        __syncthreads();
      }
      block_grad_matmul<RB, false>(a1, FC, df, D, M, fc, D, gp + gl.off[BG_W2] + (size_t)c0 * D, D);
      __syncthreads();
      // da1 = df2 @ W2[c0:c0+fc]^T
      tile_mm_r<8, true, false, RB, false>(df, D, M, D, p.w2 + (size_t)c0 * D, D, fc, nullptr,
                                          a1, FC);
      __syncthreads();
      for (int i = threadIdx.x; i < M * fc; i += blockDim.x) {
        const int r = i / fc, f = i % fc;
        a1[r * FC + f] *= act_bwd(act, pre[r * FC + f]);  // dpre1
      }
      __syncthreads();
      block_grad_matmul<RB, false>(r1, D, a1, FC, M, D, fc, gp + gl.off[BG_W1] + c0, I);
      block_colsum(a1, FC, nullptr, 0, M, fc, gp + gl.off[BG_B1] + c0);
      // dr1 += dpre1 @ W1[:, c0:c0+fc]^T
      tile_mm_r<8, true, false, RB, true>(a1, FC, M, fc, p.w1 + c0, I, D, nullptr, dr, D);
      __syncthreads();
    }

    // --- LN1, W_o and the context ----------------------------------------
    block_colsum(dr, D, v1, D, M, D, gp + gl.off[BG_LN1_S]);
    block_colsum(dr, D, nullptr, 0, M, D, gp + gl.off[BG_LN1_B]);
    __syncthreads();
    block_layernorm_bwd(dr, D, v1, D, inv1, M, D, p.ln1_s);  // dr = dv1
    __syncthreads();
    for (int i = threadIdx.x; i < M * D; i += blockDim.x) {
      int b, t;
      coord(i / D, b, t);
      dxr[(size_t)n0 * D + i] = dr[i];
      df[i] = dr[i] * drop_mask(drh, M1, b, t, i % D);  // dao
    }
    __syncthreads();
    block_colsum(df, D, nullptr, 0, M, D, gp + gl.off[BG_B_O]);
    block_grad_matmul<RB, false>(cs, D, df, D, M, D, D, gp + gl.off[BG_W_O], D);
    // dctx = dao @ W_o^T
    tile_mm_r<8, true, false, RB, false>(df, D, M, D, p.w_o, D, D, nullptr,
                                        dctx + (size_t)n0 * D, D);
  }
}

// ---------------------------------------------------------------------------
// P': the projection backward
// ---------------------------------------------------------------------------

inline size_t proj_bwd_smem_bytes(int D, int nproj) {
  return sizeof(float) * (size_t)PR * (2 * D + nproj * D);
}

// Items are tiles of PR of the B*T positions (row-major).  ROWS_ALL:
// dproj [B*T, 3D] holds dq, dk, dv and dx = dxr + dproj @ [W_q W_k W_v]^T
// with dxr [B*T, D].  ROWS_LAST and ROWS_SEL: dproj [B*T, 2D] holds dk, dv
// and dx = dproj @ [W_k W_v]^T, plus dxr[b] [B, D] at each row's position
// lens - 1 (ROWS_LAST), or plus the sum over s, in order, of dxr[b, s]
// [B, S, D] at the positions sel[b, s] (ROWS_SEL: repeated positions add
// up, one writer per element).
template <typename Tin, int MODE>
__global__ void __launch_bounds__(ATT_THREADS)
proj_bwd_kernel(const Tin* __restrict__ x, const int* __restrict__ lens,
                const float* __restrict__ dproj, const float* __restrict__ dxr,
                Tin* __restrict__ dx, BlockParams p, float* __restrict__ partial,
                BlockGradLayout gl, int N, int T, int D, const int* __restrict__ sel, int S) {
  extern __shared__ float smem[];
  constexpr bool RB = IS_BF16<Tin>;
  constexpr bool KV = MODE != ROWS_ALL;  // dproj holds dk, dv only
  constexpr int NP = KV ? 2 : 3;
  const float* w[3] = {KV ? p.w_k : p.w_q, KV ? p.w_v : p.w_k, p.w_v};
  const int gw[3] = {KV ? BG_W_K : BG_W_Q, KV ? BG_W_V : BG_W_K, BG_W_V};
  const int gb[3] = {KV ? BG_B_K : BG_B_Q, KV ? BG_B_V : BG_B_K, BG_B_V};
  float* xs = smem;           // [PR, D]   x rows
  float* ds = xs + PR * D;    // [PR, NP*D] their projection grads
  float* dxs = ds + PR * NP * D;  // [PR, D]
  float* gp = partial + (size_t)blockIdx.x * gl.total;
  for (int w0 = blockIdx.x * PR; w0 < N; w0 += gridDim.x * PR) {
    const int M = min(PR, N - w0);
    __syncthreads();
    for (int i = threadIdx.x; i < PR * D; i += blockDim.x)
      xs[i] = i < M * D ? load_act(x, (size_t)w0 * D + i) : 0.f;
    for (int i = threadIdx.x; i < PR * NP * D; i += blockDim.x)
      ds[i] = i < M * NP * D ? dproj[(size_t)w0 * NP * D + i] : 0.f;
    __syncthreads();
    for (int j = 0; j < NP; ++j) {
      block_grad_matmul<RB, false>(xs, D, ds + j * D, NP * D, M, D, D, gp + gl.off[gw[j]], D);
      block_colsum(ds + j * D, NP * D, nullptr, 0, M, D, gp + gl.off[gb[j]]);
      if (j == 0)
        tile_mm_r<8, true, false, RB, false>(ds, NP * D, M, D, w[0], D, D, nullptr, dxs, D);
      else
        tile_mm_r<8, true, false, RB, true>(ds + j * D, NP * D, M, D, w[j], D, D, nullptr, dxs,
                                            D);
      __syncthreads();
    }
    for (int i = threadIdx.x; i < M * D; i += blockDim.x) {
      const int r = i / D, d = i % D;
      const int n = w0 + r;
      float v = dxs[i];
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

}  // namespace recblr
