// Shared device code of the RecBLR recurrent-layer backward kernels
// (fused_layer_bwd.cu, fused_layer_last_bwd.cu, and through them
// fused_layer_chunked_bwd.cu and fused_bdlru_bwd.cu).
//
// The backward reads the forward's alpha and h (kept by a training
// forward, or recomputed by layer_fwd.cuh's phase A and the scan), replays
// the dropout masks from their Philox counters, and runs four phases,
// all fp32 inside:
//   A'  per item (a tile of positions of one row; for the last-position
//       layer, a tile of batch rows at their last position): recompute
//       the tail forward (z, silu(z)*h @ W_out, LN1, FFN, LN2) and run its
//       backward down to dh and dz; the LN, FFN and W_out weight grads.
//   B'  the reverse scan d_states[t] = dh[t] + alpha[t+1] * d_states[t+1],
//       one thread per (row, channel), in place over dh.
//   C1' per (row, tile): recompute xb, the conv and the gates from x,
//       take d_states and h[t-1] to the gate, lambda and conv grads and
//       du, written in place over d_states.
//   C2' per (row, tile): dxb from du (the conv's right halo t+1..t+K-1
//       read from that scratch), the W_in grad, dx = dv1 + [dxb, dz] @
//       W_in^T, and the prologue LN backward.
// Every matrix product of A', C1' and C2' runs on the tensor cores at
// fp32 accuracy (mma_tile.cuh mm_tc: mma.sync m16n8k8, 3xTF32, a fresh
// accumulator per 8-deep k-tile), the data-grad products with the weights read from device
// memory, the weight grads with the item's rows as the depth.  The LN, the
// gate and decay math, SiLU, the conv and the dropout replay stay fp32 on
// the CUDA cores.  Shared-memory rows are ld_of(width) floats apart, so a
// warp's fragment loads of a row-major operand hit 32 distinct banks.
// Weight grads are summed without atomics: a fixed grid of blocks walks
// the items in a fixed order, each block adding into its own fp32 slice
// of `partial` [G, P]; reduce_partials_kernel then sums the G slices in
// order, so two runs give the same bits.
#pragma once

#include "common.cuh"
#include "gemm_tile.cuh"  // ld_of
#include "mma_tile.cuh"

namespace recblr {

// Threads a block of A' and C1': 16 warps, the one block an SM their shared
// memory allows.  C2', with a third of their shared memory, runs two blocks
// of THREADS an SM.
constexpr int BWD_THREADS = 512;

// Transposed weights (the wrapper passes them after LayerParams), so
// that the backward's products with W^T read weights row-wise.
struct LayerParamsT {
  const float *w_inT, *w_outT, *w1T, *w2T, *wgT;  // [2C,D] [D,C] [F,D] [D,F] [2C,C]
};
constexpr int N_PARAMS_T = 5;

inline LayerParamsT unpack_params_t(const void* const* p) {
  LayerParamsT q;
  const float** dst = reinterpret_cast<const float**>(&q);
  for (int i = 0; i < N_PARAMS_T; ++i) dst[i] = static_cast<const float*>(p[N_PARAMS + i]);
  return q;
}

// Offsets of each parameter's gradient in a flat row of P floats, in
// LayerParams order (F = 0 without the FFN).
enum GradIdx {
  G_W_IN, G_WC, G_BC, G_WG, G_BG, G_LAM, G_W_OUT, G_LN1_S, G_LN1_B,
  G_W1, G_B1, G_W2, G_B2, G_LN2_S, G_LN2_B, G_PL_S, G_PL_B
};

struct GradLayout {
  int off[N_PARAMS];
  int total;
};

inline GradLayout grad_layout(int D, int C, int K, int F) {
  const int sizes[N_PARAMS] = {D * 2 * C, K * C, C, C * 2 * C, 2 * C, C, C * D, D, D,
                               D * F,     F,     F * D, D, D, D, D, D};
  GradLayout g;
  int o = 0;
  for (int i = 0; i < N_PARAMS; ++i) {
    g.off[i] = o;
    o += sizes[i];
  }
  g.total = o;
  return g;
}

// g[k * ldg + n] += sum_{m < M} a[m * lda + k] * b[m * ldb + n] for
// k < K, n < N: a weight grad over the item's rows, a / b rounded to bf16
// as they are read when RA / RB (the transformer layers' bf16 backward).
// a and b live in shared memory; g is the block's own slice of the
// partials, or memory only this block writes.
template <bool RA = false, bool RB = false>
__device__ void block_grad_matmul(const float* __restrict__ a, int lda,
                                  const float* __restrict__ b, int ldb, int M, int K, int N,
                                  float* __restrict__ g, int ldg) {
  for (int idx = threadIdx.x; idx < K * N; idx += blockDim.x) {
    const int k = idx / N, n = idx % N;
    float acc = 0.f;
    for (int m = 0; m < M; ++m)
      acc = fmaf(mm_op<RA>(a[m * lda + k]), mm_op<RB>(b[m * ldb + n]), acc);
    g[(size_t)k * ldg + n] += acc;
  }
}

// f(r, ch, mask) for r < rows, ch < W, with mask the scaled keep-mask of
// mask id at (row(r), pos(r), ch): one Philox call per four channels
// (drop_mask4), the same bits as drop_mask draws channel by channel.
template <typename Row, typename Pos, typename F>
__device__ __forceinline__ void masked_rows(const Dropout& dr, int id, int rows, int W, Row row,
                                            Pos pos, F f) {
  const int W4 = (W + 3) / 4;
#pragma unroll 2
  for (int i = threadIdx.x; i < rows * W4; i += blockDim.x) {
    const int r = i / W4, c = (i % W4) * 4;
    const float4 m = drop_mask4(dr, id, row(r), pos(r), c / 4);
    f(r, c, m.x);
    if (c + 1 < W) f(r, c + 1, m.y);
    if (c + 2 < W) f(r, c + 2, m.z);
    if (c + 3 < W) f(r, c + 3, m.w);
  }
}

// g[n] += sum_{m < M} a[m, n] (times b[m, n] when b is given).
__device__ void block_colsum(const float* __restrict__ a, int lda,
                             const float* __restrict__ b, int ldb, int M, int N,
                             float* __restrict__ g) {
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float s = 0.f;
    for (int m = 0; m < M; ++m) s += b ? a[m * lda + n] * b[m * ldb + n] : a[m * lda + n];
    g[n] += s;
  }
}

// v[m, :D] <- vhat = (v - mean) * inv with inv[m] = rsqrt(var + eps),
// one warp per row; with `out`, also out[m, :D] = vhat * s + b.
__device__ void block_layernorm_save(float* v, int ld, int M, int D, float* inv,
                                     const float* __restrict__ s,
                                     const float* __restrict__ b, float* out, int ldo) {
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
    const float iv = rsqrtf(warp_sum(sq) / D + LN_EPS);
    if (lane == 0) inv[m] = iv;
    for (int d = lane; d < D; d += 32) {
      const float vh = (row[d] - mu) * iv;
      row[d] = vh;
      if (out) out[m * ldo + d] = vh * s[d] + b[d];
    }
  }
}

// dy[m, :D] <- inv * (dvhat - mean(dvhat) - vhat * mean(dvhat * vhat))
// with dvhat = dy * s, one warp per row (the LN backward of the TPU
// kernel's _ln_bwd).
__device__ void block_layernorm_bwd(float* dy, int ld, const float* vhat, int ldv,
                                    const float* inv, int M, int D,
                                    const float* __restrict__ s) {
  const int lane = threadIdx.x % 32;
  for (int m = threadIdx.x / 32; m < M; m += blockDim.x / 32) {
    float* row = dy + m * ld;
    const float* vh = vhat + m * ldv;
    float s1 = 0.f, s2 = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float dv = row[d] * s[d];
      s1 += dv;
      s2 += dv * vh[d];
    }
    const float m1 = warp_sum(s1) / D;
    const float m2 = warp_sum(s2) / D;
    const float iv = inv[m];
    for (int d = lane; d < D; d += 32) row[d] = iv * (row[d] * s[d] - m1 - vh[d] * m2);
  }
}

// ---------------------------------------------------------------------------
// A': tail backward
// ---------------------------------------------------------------------------

inline size_t tail_bwd_smem_bytes(int rt, int D, int C, int F) {
  const int lD = ld_of(D), lC = ld_of(C), lF = ld_of(F), lFC = ld_of(F > C ? F : C);
  return sizeof(float) * ((size_t)rt * (6 * lD + 3 * lC + lFC + lF) + 2 * (size_t)rt);
}

// LAST = false: item w is (row b, positions t0 .. t0+rt-1); dxr, dh, dz
// are [B, T, .].  LAST = true: item w is batch rows t0 .. t0+rt-1, each
// at its last valid position (x_last = h_last = 0 where none is
// selected); dxr [B, D] (dv1 plus the z half of dx), dh [B, C]; dz is
// contracted here with W_in[:, C:].  Products on the tensor cores
// (mm_tc): the forward's four (z, W_out, W1, W2), the three data grads
// (W2^T, W1^T, W_out^T) and the three weight grads (W2, W1, W_out); with
// LAST also dz's W_in grad and dz W_in[:, C:]^T.
template <typename Tin, bool LAST>
__global__ void __launch_bounds__(BWD_THREADS)
tail_bwd_mma_kernel(const Tin* __restrict__ x, const int* __restrict__ lens,
                    const Tin* __restrict__ dout, const float* __restrict__ h, LayerParams p,
                    LayerParamsT q, Dropout dr, float* __restrict__ dxr, float* __restrict__ dh,
                    float* __restrict__ dz, float* __restrict__ partial, GradLayout gl, int rt,
                    int B, int T, int D, int C, int F, int use_ffn, int prologue) {
  extern __shared__ float smem[];
  const int lD = ld_of(D), lC = ld_of(C), lF = ld_of(F), lFC = ld_of(F > C ? F : C);
  float* xs = smem;             // [rt, lD]  layer input (post-prologue)
  float* zs = xs + rt * lD;     // [rt, lC]  z (LAST: later dz)
  float* hs = zs + rt * lC;     // [rt, lC]  h
  float* yin = hs + rt * lC;    // [rt, lC]  silu(z) * h
  float* v1 = yin + rt * lC;    // [rt, lD]  LN1 input, then vhat1
  float* r1 = v1 + rt * lD;     // [rt, lD]  LN1 output
  float* f1 = r1 + rt * lD;     // [rt, lFC] f1; later dyin [rt, C]
  float* a1 = f1 + rt * lFC;    // [rt, lF]  a1 * m2; later da1 -> df1
  float* v2 = a1 + rt * lF;     // [rt, lD]  LN2 input -> vhat2; later df2
  float* g = v2 + rt * lD;      // [rt, lD]  dout -> dv2 (LAST: later dx_z)
  float* dr1 = g + rt * lD;     // [rt, lD]  dr1 -> dv1 -> dy
  float* inv1 = dr1 + rt * lD;  // [rt]
  float* inv2 = inv1 + rt;      // [rt]
  float* gp = partial + (size_t)blockIdx.x * gl.total;
  const int tiles = LAST ? (B + rt - 1) / rt : (T + rt - 1) / rt;
  const int work = LAST ? tiles : B * tiles;
  for (int w = blockIdx.x; w < work; w += gridDim.x) {
    int b = 0, t0, rows;
    if (LAST) {
      t0 = w * rt;
      rows = min(rt, B - t0);
    } else {
      b = w / tiles;
      t0 = (w % tiles) * rt;
      rows = min(rt, T - t0);
    }
    // mask coordinates of row r: (b, t0 + r), or (t0 + r, 0) when LAST
    auto mrow = [&](int r) { return LAST ? t0 + r : b; };
    auto mpos = [&](int r) { return LAST ? 0 : t0 + r; };
    __syncthreads();  // the previous item's reads of shared memory are done
    if (LAST) {
      for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
        const int r = i / D, d = i % D;
        const int n = valid_len(lens[t0 + r], T);
        xs[r * lD + d] = n > 0 ? load_act(x, ((size_t)(t0 + r) * T + n - 1) * D + d) : 0.f;
        g[r * lD + d] = load_act(dout, (size_t)(t0 + r) * D + d);
      }
    } else {
      masked_rows(prologue ? dr : Dropout{}, M0, rows, D, mrow, mpos, [&](int r, int d, float m) {
        const size_t o = ((size_t)b * T + t0 + r) * D + d;
        xs[r * lD + d] = load_act(x, o) * m;
        g[r * lD + d] = load_act(dout, o);
      });
    }
#pragma unroll 4
    for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
      const int r = i / C, c = i % C;
      float hv;
      if (LAST) {
        const int n = valid_len(lens[t0 + r], T);
        hv = n > 0 ? h[((size_t)(t0 + r) * T + n - 1) * C + c] : 0.f;
      } else {
        hv = h[((size_t)b * T + t0 + r) * C + c];
      }
      hs[r * lC + c] = hv;
    }
    __syncthreads();
    if (prologue) {
      block_layernorm(xs, lD, rows, D, p.pl_s, p.pl_b);
      __syncthreads();
    }

    // --- the tail forward, with the replayed masks ---------------------
    mm_tc<2, 1>(xs, lD, p.w_in + C, 2 * C, rows, C, D,
                [&](int m, int n, float v) { zs[m * lC + n] = v; });
    __syncthreads();
    for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
      const int o = (i / C) * lC + i % C;
      yin[o] = silu_t(zs[o]) * hs[o];
    }
    __syncthreads();
    mm_tc<1, 1>(yin, lC, p.w_out, D, rows, D, C,
                [&](int m, int n, float v) { v1[m * lD + n] = v; });
    __syncthreads();
    masked_rows(dr, M1, rows, D, mrow, mpos, [&](int r, int d, float m) {
      const int o = r * lD + d;
      v1[o] = v1[o] * m + xs[o];
    });
    __syncthreads();
    block_layernorm_save(v1, lD, rows, D, inv1, p.ln1_s, p.ln1_b, r1, lD);
    __syncthreads();

    if (use_ffn) {
      mm_tc<2, 2>(r1, lD, p.w1, F, rows, F, D, [&](int m, int n, float v) {
        f1[m * lFC + n] = v + __ldg(p.b1 + n);
      });
      __syncthreads();
      masked_rows(dr, M2, rows, F, mrow, mpos, [&](int r, int f, float m) {
        a1[r * lF + f] = silu_t(f1[r * lFC + f]) * m;
      });
      __syncthreads();
      mm_tc<1, 1>(a1, lF, p.w2, D, rows, D, F, [&](int m, int n, float v) {
        v2[m * lD + n] = v + __ldg(p.b2 + n);
      });
      __syncthreads();
      masked_rows(dr, M3, rows, D, mrow, mpos, [&](int r, int d, float m) {
        const int o = r * lD + d;
        v2[o] = v2[o] * m + r1[o];
      });
      __syncthreads();
      block_layernorm_save(v2, lD, rows, D, inv2, nullptr, nullptr, nullptr, 0);
      __syncthreads();

      // --- LN2 and FFN backward ---------------------------------------
      block_colsum(g, lD, v2, lD, rows, D, gp + gl.off[G_LN2_S]);
      block_colsum(g, lD, nullptr, 0, rows, D, gp + gl.off[G_LN2_B]);
      __syncthreads();
      block_layernorm_bwd(g, lD, v2, lD, inv2, rows, D, p.ln2_s);  // g = dv2
      __syncthreads();
      masked_rows(dr, M3, rows, D, mrow, mpos, [&](int r, int d, float m) {
        v2[r * lD + d] = g[r * lD + d] * m;  // df2
      });
      __syncthreads();
      mm_tc_add<2, 2>(a1, lF, v2, lD, F, D, rows, gp + gl.off[G_W2], D);
      block_colsum(v2, lD, nullptr, 0, rows, D, gp + gl.off[G_B2]);
      __syncthreads();
      mm_tc<2, 2>(v2, lD, q.w2T, F, rows, F, D,  // da1 (before m2)
                  [&](int m, int n, float v) { a1[m * lF + n] = v; });
      __syncthreads();
      masked_rows(dr, M2, rows, F, mrow, mpos, [&](int r, int f, float m) {
        const float fv = f1[r * lFC + f], sf = sigmoid_t(fv);
        a1[r * lF + f] *= m * sf * (1.f + fv * (1.f - sf));
      });
      __syncthreads();
      mm_tc_add<2, 2>(r1, lD, a1, lF, D, F, rows, gp + gl.off[G_W1], F);
      block_colsum(a1, lF, nullptr, 0, rows, F, gp + gl.off[G_B1]);
      mm_tc<1, 1>(a1, lF, q.w1T, D, rows, D, F,
                  [&](int m, int n, float v) { dr1[m * lD + n] = v; });
      __syncthreads();
      for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
        const int o = (i / D) * lD + i % D;
        dr1[o] += g[o];
      }
    } else {
      for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
        const int o = (i / D) * lD + i % D;
        dr1[o] = g[o];
      }
    }
    __syncthreads();

    // --- LN1, W_out and the z / h split --------------------------------
    block_colsum(dr1, lD, v1, lD, rows, D, gp + gl.off[G_LN1_S]);
    block_colsum(dr1, lD, nullptr, 0, rows, D, gp + gl.off[G_LN1_B]);
    __syncthreads();
    block_layernorm_bwd(dr1, lD, v1, lD, inv1, rows, D, p.ln1_s);  // dr1 = dv1
    __syncthreads();
    masked_rows(dr, M1, rows, D, mrow, mpos, [&](int r, int d, float m) {
      const int o = r * lD + d;
      const float dv = dr1[o];
      dxr[LAST ? (size_t)(t0 + r) * D + d : ((size_t)b * T + t0 + r) * D + d] = dv;
      dr1[o] = dv * m;  // dy
    });
    __syncthreads();
    mm_tc_add<2, 2>(yin, lC, dr1, lD, C, D, rows, gp + gl.off[G_W_OUT], D);
    mm_tc<2, 1>(dr1, lD, q.w_outT, C, rows, C, D,  // dyin
                [&](int m, int n, float v) { f1[m * lFC + n] = v; });
    __syncthreads();
    for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
      const int r = i / C, c = i % C, o = r * lC + c;
      const float z = zs[o], sz = sigmoid_t(z);
      const float dyv = f1[r * lFC + c];
      const float dgate = dyv * hs[o];
      const float dhv = dyv * (z * sz);
      const float dzv = dgate * sz * (1.f + z * (1.f - sz));
      if (LAST) {
        dh[(size_t)(t0 + r) * C + c] = dhv;
        zs[o] = dzv;
      } else {
        const size_t og = ((size_t)b * T + t0 + r) * C + c;
        dh[og] = dhv;
        dz[og] = dzv;
      }
    }
    if (LAST) {
      // dz lives at the last position only: its W_in grad and dx here
      __syncthreads();
      mm_tc_add<2, 2>(xs, lD, zs, lC, D, C, rows, gp + gl.off[G_W_IN] + C, 2 * C);
      mm_tc<1, 1>(zs, lC, q.w_inT + (size_t)C * D, D, rows, D, C,
                  [&](int m, int n, float v) { g[m * lD + n] = v; });
      __syncthreads();
      for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
        const int r = i / D, d = i % D;
        dxr[(size_t)(t0 + r) * D + d] += g[r * lD + d];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// B': reverse scan
// ---------------------------------------------------------------------------

// The full layer's reverse scan is linear_scan_kernel<true> with `shift`
// (common.cuh), dh into d_states in place.  The last-position layer's:
// d_states[n-1] = dhl[b], d_states[t] = alpha[t+1] * d_states[t+1] below
// it; positions at or beyond the length are not touched.
__global__ void __launch_bounds__(SCAN_THREADS)
rev_scan_last_kernel(const float* __restrict__ alpha, float* __restrict__ ds,
                     const int* __restrict__ lens, const float* __restrict__ dhl, int B, int T,
                     int C) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * C) return;
  const int b = i / C, c = i % C;
  const int n = valid_len(lens[b], T);
  if (n == 0) return;
  size_t o = ((size_t)b * T + n - 1) * C + c;
  float acc = dhl[i];
  ds[o] = acc;
  for (int t = n - 2; t >= 0; --t) {
    o -= C;
    acc = alpha[o + C] * acc;
    ds[o] = acc;
  }
}

// The chunked layer's reverse scan, in two passes of one thread per (row,
// chunk, channel), T = nc * chunk.  With cin the carry entering a chunk
// from its right (alpha[t+1] * d_states[t+1] at its last position t, 0
// for the last chunk), d_states[t] = dh[t] + cin within the chunk.
// Pass 1: the chunk's walk from cin = 0 gives aend = the carry it passes
// left (alpha[s] * d_states[s] at its first position s) and mend = the
// product of its gates, so the carry it passes is aend + mend * cin.
__global__ void __launch_bounds__(SCAN_THREADS)
rev_chunk_state_kernel(const float* __restrict__ alpha, const float* __restrict__ ds,
                       float* __restrict__ aend, float* __restrict__ mend, int B, int T, int C,
                       int chunk) {
  const int nc = T / chunk;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * nc * C) return;
  const int c = i % C, j = (i / C) % nc, b = i / (C * nc);
  size_t o = ((size_t)b * T + (size_t)j * chunk + chunk - 1) * C + c;
  float cin = 0.f, pr = 1.f;
  for (int t = chunk - 1; t >= 0; --t, o -= C) {
    const float a = alpha[o];
    cin = a * (ds[o] + cin);
    pr *= a;
  }
  aend[i] = cin;
  mend[i] = pr;
}

// Pass 2: the carry entering chunk j, composed from the later chunks'
// (aend, mend), then the chunk's reverse walk: ds holds dh on entry and
// d_states on exit.
__global__ void __launch_bounds__(SCAN_THREADS)
rev_chunk_scan_kernel(const float* __restrict__ alpha, float* __restrict__ ds,
                      const float* __restrict__ aend, const float* __restrict__ mend, int B,
                      int T, int C, int chunk) {
  const int nc = T / chunk;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * nc * C) return;
  const int c = i % C, j = (i / C) % nc, b = i / (C * nc);
  float cin = 0.f;
  for (int jj = nc - 1; jj > j; --jj) {
    const size_t k = ((size_t)b * nc + jj) * C + c;
    cin = aend[k] + mend[k] * cin;
  }
  size_t o = ((size_t)b * T + (size_t)j * chunk + chunk - 1) * C + c;
  for (int t = chunk - 1; t >= 0; --t, o -= C) {
    const float d = ds[o] + cin;
    ds[o] = d;
    cin = alpha[o] * d;
  }
}

// ---------------------------------------------------------------------------
// C1': gate, lambda and conv backward
// ---------------------------------------------------------------------------

inline size_t gate_bwd_smem_bytes(int D, int C, int K) {
  const int lD = ld_of(D), lC = ld_of(C), lG = ld_of(2 * C);
  return sizeof(float) * ((size_t)xb_rows(K) * lD + (size_t)xb_rows(K) * lC +
                          (size_t)TT * (5 * lC + lG));
}

// Item (b, tile); with lens, positions at or beyond row b's length are
// skipped (their d_states are zero).  ds_du holds d_states on entry and
// du (dxc without the conv) on exit, at the positions processed.  XB:
// x is xb itself, [B, T, C] (fused_bdlru_bwd.cu; D = 0, no prologue).
// Products on the tensor cores (mm_tc): xb = LN(x) W_in[:, :C] over the
// tile and its conv halo, the gates xc W_g, dxc = dg W_g^T and the weight
// grad xc^T dg.
template <typename Tin, bool XB = false>
__global__ void __launch_bounds__(BWD_THREADS)
gate_bwd_mma_kernel(const Tin* __restrict__ x, const int* __restrict__ lens,
                    const float* __restrict__ h, float* __restrict__ ds_du, LayerParams p,
                    LayerParamsT q, Dropout dr, float* __restrict__ partial, GradLayout gl,
                    int B, int T, int D, int C, int K, int use_conv, int prologue) {
  extern __shared__ float smem[];
  const int lD = ld_of(D), lC = ld_of(C), lG = ld_of(2 * C);
  float* xs = smem;                  // [xb_rows(K), lD]  x rows t0-H .. t_end-1
  float* xb = xs + xb_rows(K) * lD;  // [xb_rows(K), lC]  x @ W_in[:, :C]
  float* u = xb + xb_rows(K) * lC;   // [TT, lC]  conv output
  float* xc = u + TT * lC;           // [TT, lC]  silu(u)
  float* g = xc + TT * lC;           // [TT, lG]  gates pre-activation -> dg
  float* dsb = g + TT * lG;          // [TT, lC]  d_states -> dxc -> du
  float* lt = dsb + TT * lC;         // [TT, lC]  per-position lambda terms
  float* hp = lt + TT * lC;          // [TT, lC]  h[t - 1]
  float* gp = partial + (size_t)blockIdx.x * gl.total;
  const int tiles = (T + TT - 1) / TT;
  const int H = use_conv ? K - 1 : 0;
  for (int w = blockIdx.x; w < B * tiles; w += gridDim.x) {
    const int b = w / tiles, t0 = (w % tiles) * TT;
    int t_end = min(t0 + TT, T);
    if (lens != nullptr) t_end = min(t_end, valid_len(lens[b], T));
    if (t0 >= t_end) continue;
    const int rows = t_end - t0, rows_h = rows + H;
    __syncthreads();
    // d_states and h[t - 1] of the tile land while xb and the gates are
    // computed
    const float* hrow = h + ((size_t)b * T + t0) * C;
    stage<false>(dsb, lC, ds_du + ((size_t)b * T + t0) * C, C, rows, C, rows, C, false);
    if (t0 > 0) {
      stage<false>(hp, lC, hrow - C, C, rows, C, rows, C, false);
    } else {
      for (int c = threadIdx.x; c < C; c += blockDim.x) hp[c] = 0.f;
      stage<false>(hp + lC, lC, hrow, C, rows - 1, C, rows - 1, C, false);
    }
    if (XB) {
      for (int i = threadIdx.x; i < rows_h * C; i += blockDim.x) {
        const int r = i / C, c = i % C, t = t0 - H + r;
        xb[r * lC + c] = t >= 0 ? load_act(x, ((size_t)b * T + t) * C + c) : 0.f;
      }
    } else {
      masked_rows(prologue ? dr : Dropout{}, M0, rows_h, D, [&](int) { return b; },
                  [&](int r) { return t0 - H + r; }, [&](int r, int d, float m) {
                    const int t = t0 - H + r;
                    xs[r * lD + d] = t >= 0 ? load_act(x, ((size_t)b * T + t) * D + d) * m : 0.f;
                  });
      __syncthreads();
      if (prologue) {
        block_layernorm(xs, lD, rows_h, D, p.pl_s, p.pl_b);
        __syncthreads();
      }
      mm_tc<2, 2>(xs, lD, p.w_in, 2 * C, rows_h, C, D,
                  [&](int m, int n, float v) { xb[m * lC + n] = v; });
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
      const int r = i / C, c = i % C, o = r * lC + c;
      if (use_conv) {
        const int rr = r + H;
        float uv = xb[rr * lC + c] * p.wc[(K - 1) * C + c] + p.bc[c];
        for (int j = 1; j < K; ++j) {
          const float xv = (t0 + r - j >= 0) ? xb[(rr - j) * lC + c] : 0.f;
          uv += xv * p.wc[(K - 1 - j) * C + c];
        }
        u[o] = uv;
        xc[o] = silu_t(uv);
      } else {
        xc[o] = xb[o];
      }
    }
    __syncthreads();
    mm_tc<2, 2>(xc, lC, p.wg, 2 * C, rows, 2 * C, C, [&](int m, int n, float v) {
      g[m * lG + n] = v + __ldg(p.bg + n);
    });
    cp_async_wait_all();
    __syncthreads();
    for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
      const int r = i / C, c = i % C, o = r * lC + c;
      const float sr = sigmoid_t(g[r * lG + c]);
      const float si = sigmoid_t(g[r * lG + C + c]);
      const float spl = softplus_t(p.lam[c]);
      const float a = exp_t(-spl * sr);
      const float s = sqrtf(1.f - a * a + GATE_EPS);
      const float beta = s * si;
      const float d = dsb[o];
      const float d_beta = d * xc[o];
      const float d_a = hp[o] * d - d_beta * si * a / s;
      const float d_r = -d_a * a * spl * sr * (1.f - sr);
      g[r * lG + c] = d_r;
      g[r * lG + C + c] = d_beta * s * si * (1.f - si);
      lt[o] = -d_a * a * sr * sigmoid_t(p.lam[c]);
      dsb[o] = d * beta;
    }
    __syncthreads();
    // the weight grads read dg; dxc = dg W_g^T is added to d * beta in dsb
    block_colsum(lt, lC, nullptr, 0, rows, C, gp + gl.off[G_LAM]);
    block_colsum(g, lG, nullptr, 0, rows, 2 * C, gp + gl.off[G_BG]);
    mm_tc_add<2, 2>(xc, lC, g, lG, C, 2 * C, rows, gp + gl.off[G_WG], 2 * C);
    mm_tc<2, 1>(g, lG, q.wgT, C, rows, C, 2 * C,
                [&](int m, int n, float v) { dsb[m * lC + n] += v; });
    __syncthreads();
    if (use_conv) {
      for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
        const int o = (i / C) * lC + i % C;
        const float su = sigmoid_t(u[o]);
        dsb[o] *= su * (1.f + u[o] * (1.f - su));  // du
      }
      __syncthreads();
      block_colsum(dsb, lC, nullptr, 0, rows, C, gp + gl.off[G_BC]);
      for (int idx = threadIdx.x; idx < K * C; idx += blockDim.x) {
        const int k = idx / C, c = idx % C;
        const int j = K - 1 - k;  // tap k multiplies xb[t - j]
        float s = 0.f;
        for (int r = 0; r < rows; ++r)
          if (t0 + r - j >= 0) s += xb[(r + H - j) * lC + c] * dsb[r * lC + c];
        gp[gl.off[G_WC] + idx] += s;
      }
    }
    for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
      const int r = i / C, c = i % C;
      ds_du[((size_t)b * T + t0 + r) * C + c] = dsb[r * lC + c];
    }
  }
}

// ---------------------------------------------------------------------------
// C2': in-projection and prologue backward, dx
// ---------------------------------------------------------------------------

inline size_t inproj_bwd_smem_bytes(int D, int C) {
  const int lD = ld_of(D), lZ = ld_of(2 * C);
  return sizeof(float) * ((size_t)TT * (3 * lD + lZ) + TT);
}

// Item (b, tile).  Without lens: dxz = [dxb, dz] over 2C channels and
// dx = dxr + dxz @ W_in^T.  With lens: dxz = dxb over C channels, dx =
// dxb @ W_in[:, :C]^T plus dxr[b] at position n-1, and dx = 0 at and
// beyond the row's length.  Both products (the W_in grad x^T dxz and dx)
// on the tensor cores (mm_tc).
template <typename Tin>
__global__ void __launch_bounds__(THREADS, 2)
inproj_bwd_mma_kernel(const Tin* __restrict__ x, const int* __restrict__ lens,
                      const float* __restrict__ du, const float* __restrict__ dz,
                      const float* __restrict__ dxr, Tin* __restrict__ dx, LayerParams p,
                      LayerParamsT q, Dropout dr, float* __restrict__ partial, GradLayout gl,
                      int B, int T, int D, int C, int K, int use_conv, int prologue) {
  extern __shared__ float smem[];
  const int NW = dz ? 2 * C : C;
  const int lD = ld_of(D), lZ = ld_of(2 * C);
  float* xs = smem;            // [TT, lD]  layer input (post-prologue)
  float* v0 = xs + TT * lD;    // [TT, lD]  prologue vhat
  float* dxs = v0 + TT * lD;   // [TT, lD]  dx
  float* dxz = dxs + TT * lD;  // [TT, lZ]  [dxb, dz]
  float* inv0 = dxz + TT * lZ;
  float* gp = partial + (size_t)blockIdx.x * gl.total;
  const int tiles = (T + TT - 1) / TT;
  for (int w = blockIdx.x; w < B * tiles; w += gridDim.x) {
    const int b = w / tiles, t0 = (w % tiles) * TT;
    const int rows = min(TT, T - t0);
    const int n = lens != nullptr ? valid_len(lens[b], T) : T;
    const int rv = max(0, min(rows, n - t0));
    __syncthreads();
    for (int i = threadIdx.x + rv * D; i < rows * D; i += blockDim.x) {
      const int r = i / D, d = i % D;
      store_act(dx, ((size_t)b * T + t0 + r) * D + d, 0.f);
    }
    if (rv == 0) continue;
    auto row_b = [&](int) { return b; };
    auto pos_t = [&](int r) { return t0 + r; };
    masked_rows(prologue ? dr : Dropout{}, M0, rv, D, row_b, pos_t, [&](int r, int d, float m) {
      (prologue ? v0 : xs)[r * lD + d] = load_act(x, ((size_t)b * T + t0 + r) * D + d) * m;
    });
#pragma unroll 2
    for (int i = threadIdx.x; i < rv * C; i += blockDim.x) {
      const int r = i / C, c = i % C;
      const int t = t0 + r;
      const size_t o = ((size_t)b * T + t) * C + c;
      float s;
      if (use_conv) {
        // dxb[t] = sum_j du[t + j] * wc[K-1-j]: the halo t+1 .. t+K-1
        s = du[o] * p.wc[(K - 1) * C + c];
        for (int j = 1; j < K; ++j)
          if (t + j < n) s += du[o + (size_t)j * C] * p.wc[(K - 1 - j) * C + c];
      } else {
        s = du[o];
      }
      dxz[r * lZ + c] = s;
      if (dz) dxz[r * lZ + C + c] = dz[o];
    }
    __syncthreads();
    if (prologue) {
      block_layernorm_save(v0, lD, rv, D, inv0, p.pl_s, p.pl_b, xs, lD);
      __syncthreads();
    }
    mm_tc_add<2, 2>(xs, lD, dxz, lZ, D, NW, rv, gp + gl.off[G_W_IN], 2 * C);
    mm_tc<2, 1>(dxz, lZ, q.w_inT, D, rv, D, NW,
                [&](int m, int n, float v) { dxs[m * lD + n] = v; });
    __syncthreads();
    for (int i = threadIdx.x; i < rv * D; i += blockDim.x) {
      const int r = i / D, d = i % D;
      const int t = t0 + r;
      if (lens == nullptr)
        dxs[r * lD + d] += dxr[((size_t)b * T + t) * D + d];
      else if (t == n - 1)
        dxs[r * lD + d] += dxr[(size_t)b * D + d];
    }
    __syncthreads();
    if (prologue) {
      block_colsum(dxs, lD, v0, lD, rv, D, gp + gl.off[G_PL_S]);
      block_colsum(dxs, lD, nullptr, 0, rv, D, gp + gl.off[G_PL_B]);
      __syncthreads();
      block_layernorm_bwd(dxs, lD, v0, lD, inv0, rv, D, p.pl_s);
      __syncthreads();
    }
    masked_rows(prologue ? dr : Dropout{}, M0, rv, D, row_b, pos_t, [&](int r, int d, float m) {
      store_act(dx, ((size_t)b * T + t0 + r) * D + d, dxs[r * lD + d] * m);
    });
  }
}

// out[p] = sum over g = 0 .. G-1, in order, of partial[g, p].
__global__ void reduce_partials_kernel(const float* __restrict__ partial, int G, int P,
                                       float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P) return;
  float s = 0.f;
  for (int g = 0; g < G; ++g) s += partial[(size_t)g * P + i];
  out[i] = s;
}

// Rows per A' item: 32 where its shared memory fits a block, else 16.
inline int tail_bwd_rows(int D, int C, int F, int max_smem) {
  return tail_bwd_smem_bytes(TT, D, C, F) <= (size_t)max_smem ? TT : TT / 2;
}

template <typename K>
inline cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace recblr
