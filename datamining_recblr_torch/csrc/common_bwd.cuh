// Shared device code of the RecBLR recurrent-layer backward kernels
// (fused_layer_bwd.cu, fused_layer_last_bwd.cu).
//
// The backward reads the forward's alpha and h (kept by a training
// forward, or recomputed by phase A and the scan of common.cuh), replays
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
// Weight grads are summed without atomics: a fixed grid of blocks walks
// the items in a fixed order, each block adding into its own fp32 slice
// of `partial` [G, P]; reduce_partials_kernel then sums the G slices in
// order, so two runs give the same bits.
#pragma once

#include "common.cuh"

namespace recblr {

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
  const int fc = F > C ? F : C;
  return sizeof(float) * ((size_t)rt * (6 * D + 3 * C + fc + F) + 2 * (size_t)rt);
}

// LAST = false: item w is (row b, positions t0 .. t0+rt-1); dxr, dh, dz
// are [B, T, .].  LAST = true: item w is batch rows t0 .. t0+rt-1, each
// at its last valid position (x_last = h_last = 0 where none is
// selected); dxr [B, D] (dv1 plus the z half of dx), dh [B, C]; dz is
// contracted here with W_in[:, C:].
template <typename Tin, bool LAST>
__global__ void __launch_bounds__(THREADS)
tail_bwd_kernel(const Tin* __restrict__ x, const int* __restrict__ lens,
                const Tin* __restrict__ dout, const float* __restrict__ h, LayerParams p,
                LayerParamsT q, Dropout dr, float* __restrict__ dxr, float* __restrict__ dh,
                float* __restrict__ dz, float* __restrict__ partial, GradLayout gl, int rt,
                int B, int T, int D, int C, int F, int use_ffn, int prologue) {
  extern __shared__ float smem[];
  const int FC = F > C ? F : C;
  float* xs = smem;            // [rt, D]  layer input (post-prologue)
  float* zs = xs + rt * D;     // [rt, C]  z (LAST: later dz)
  float* hs = zs + rt * C;     // [rt, C]  h
  float* yin = hs + rt * C;    // [rt, C]  silu(z) * h
  float* v1 = yin + rt * C;    // [rt, D]  LN1 input, then vhat1
  float* r1 = v1 + rt * D;     // [rt, D]  LN1 output
  float* f1 = r1 + rt * D;     // [rt, F]  f1; later dyin [rt, C]
  float* a1 = f1 + rt * FC;    // [rt, F]  a1 * m2; later da1 -> df1
  float* v2 = a1 + rt * F;     // [rt, D]  LN2 input -> vhat2; later df2
  float* g = v2 + rt * D;      // [rt, D]  dout -> dv2 (LAST: later dx_z)
  float* dr1 = g + rt * D;     // [rt, D]  dr1 -> dv1 -> dy
  float* inv1 = dr1 + rt * D;  // [rt]
  float* inv2 = inv1 + rt;     // [rt]
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
    for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
      const int r = i / D, d = i % D;
      float v, gv;
      if (LAST) {
        const int n = valid_len(lens[t0 + r], T);
        v = n > 0 ? load_act(x, ((size_t)(t0 + r) * T + n - 1) * D + d) : 0.f;
        gv = load_act(dout, (size_t)(t0 + r) * D + d);
      } else {
        const size_t o = ((size_t)b * T + t0 + r) * D + d;
        v = load_act(x, o);
        if (prologue) v *= drop_mask(dr, M0, b, t0 + r, d);
        gv = load_act(dout, o);
      }
      xs[i] = v;
      g[i] = gv;
    }
    for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
      const int r = i / C, c = i % C;
      float hv;
      if (LAST) {
        const int n = valid_len(lens[t0 + r], T);
        hv = n > 0 ? h[((size_t)(t0 + r) * T + n - 1) * C + c] : 0.f;
      } else {
        hv = h[((size_t)b * T + t0 + r) * C + c];
      }
      hs[i] = hv;
    }
    __syncthreads();
    if (prologue) {
      block_layernorm(xs, D, rows, D, p.pl_s, p.pl_b);
      __syncthreads();
    }

    // --- the tail forward, with the replayed masks ---------------------
    block_matmul(xs, D, rows, D, p.w_in + C, 2 * C, C, nullptr, zs, C);
    __syncthreads();
    for (int i = threadIdx.x; i < rows * C; i += blockDim.x) yin[i] = silu_t(zs[i]) * hs[i];
    __syncthreads();
    block_matmul(yin, C, rows, C, p.w_out, D, D, nullptr, v1, D);
    __syncthreads();
    for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
      const int r = i / D, d = i % D;
      v1[i] = v1[i] * drop_mask(dr, M1, mrow(r), mpos(r), d) + xs[i];
    }
    __syncthreads();
    block_layernorm_save(v1, D, rows, D, inv1, p.ln1_s, p.ln1_b, r1, D);
    __syncthreads();

    if (use_ffn) {
      block_matmul(r1, D, rows, D, p.w1, F, F, p.b1, f1, F);
      __syncthreads();
      for (int i = threadIdx.x; i < rows * F; i += blockDim.x) {
        const int r = i / F, f = i % F;
        a1[i] = silu_t(f1[i]) * drop_mask(dr, M2, mrow(r), mpos(r), f);
      }
      __syncthreads();
      block_matmul(a1, F, rows, F, p.w2, D, D, p.b2, v2, D);
      __syncthreads();
      for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
        const int r = i / D, d = i % D;
        v2[i] = v2[i] * drop_mask(dr, M3, mrow(r), mpos(r), d) + r1[i];
      }
      __syncthreads();
      block_layernorm_save(v2, D, rows, D, inv2, nullptr, nullptr, nullptr, 0);
      __syncthreads();

      // --- LN2 and FFN backward ---------------------------------------
      block_colsum(g, D, v2, D, rows, D, gp + gl.off[G_LN2_S]);
      block_colsum(g, D, nullptr, 0, rows, D, gp + gl.off[G_LN2_B]);
      __syncthreads();
      block_layernorm_bwd(g, D, v2, D, inv2, rows, D, p.ln2_s);  // g = dv2
      __syncthreads();
      for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
        const int r = i / D, d = i % D;
        v2[i] = g[i] * drop_mask(dr, M3, mrow(r), mpos(r), d);  // df2
      }
      __syncthreads();
      block_grad_matmul(a1, F, v2, D, rows, F, D, gp + gl.off[G_W2], D);
      block_colsum(v2, D, nullptr, 0, rows, D, gp + gl.off[G_B2]);
      __syncthreads();
      block_matmul(v2, D, rows, D, q.w2T, F, F, nullptr, a1, F);  // da1 (before m2)
      __syncthreads();
      for (int i = threadIdx.x; i < rows * F; i += blockDim.x) {
        const int r = i / F, f = i % F;
        const float sf = sigmoid_t(f1[i]);
        a1[i] = a1[i] * drop_mask(dr, M2, mrow(r), mpos(r), f) * sf * (1.f + f1[i] * (1.f - sf));
      }
      __syncthreads();
      block_grad_matmul(r1, D, a1, F, rows, D, F, gp + gl.off[G_W1], F);
      block_colsum(a1, F, nullptr, 0, rows, F, gp + gl.off[G_B1]);
      __syncthreads();
      block_matmul(a1, F, rows, F, q.w1T, D, D, nullptr, dr1, D);
      __syncthreads();
      for (int i = threadIdx.x; i < rows * D; i += blockDim.x) dr1[i] += g[i];
    } else {
      for (int i = threadIdx.x; i < rows * D; i += blockDim.x) dr1[i] = g[i];
    }
    __syncthreads();

    // --- LN1, W_out and the z / h split --------------------------------
    block_colsum(dr1, D, v1, D, rows, D, gp + gl.off[G_LN1_S]);
    block_colsum(dr1, D, nullptr, 0, rows, D, gp + gl.off[G_LN1_B]);
    __syncthreads();
    block_layernorm_bwd(dr1, D, v1, D, inv1, rows, D, p.ln1_s);  // dr1 = dv1
    __syncthreads();
    for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
      const int r = i / D, d = i % D;
      const float dv = dr1[i];
      dxr[LAST ? (size_t)(t0 + r) * D + d : ((size_t)b * T + t0 + r) * D + d] = dv;
      dr1[i] = dv * drop_mask(dr, M1, mrow(r), mpos(r), d);  // dy
    }
    __syncthreads();
    block_grad_matmul(yin, C, dr1, D, rows, C, D, gp + gl.off[G_W_OUT], D);
    __syncthreads();
    block_matmul(dr1, D, rows, D, q.w_outT, C, C, nullptr, f1, C);  // dyin
    __syncthreads();
    for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
      const int r = i / C, c = i % C;
      const float z = zs[i], sz = sigmoid_t(z);
      const float dyv = f1[i];
      const float dgate = dyv * hs[i];
      const float dhv = dyv * (z * sz);
      const float dzv = dgate * sz * (1.f + z * (1.f - sz));
      if (LAST) {
        dh[(size_t)(t0 + r) * C + c] = dhv;
        zs[i] = dzv;
      } else {
        const size_t o = ((size_t)b * T + t0 + r) * C + c;
        dh[o] = dhv;
        dz[o] = dzv;
      }
    }
    if (LAST) {
      // dz lives at the last position only: its W_in grad and dx here
      __syncthreads();
      block_grad_matmul(xs, D, zs, C, rows, D, C, gp + gl.off[G_W_IN] + C, 2 * C);
      block_matmul(zs, C, rows, C, q.w_inT + (size_t)C * D, D, D, nullptr, g, D);
      __syncthreads();
      for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
        const int r = i / D, d = i % D;
        dxr[(size_t)(t0 + r) * D + d] += g[i];
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
  return sizeof(float) * ((size_t)xs_rows(K) * D + (size_t)xb_rows(K) * C + (size_t)TT * 6 * C);
}

// Item (b, tile); with lens, positions at or beyond row b's length are
// skipped (their d_states are zero).  ds_du holds d_states on entry and
// du (dxc without the conv) on exit, at the positions processed.  XB:
// x is xb itself, [B, T, C] (fused_bdlru_bwd.cu; D = 0, no prologue).
template <typename Tin, bool XB = false>
__global__ void __launch_bounds__(THREADS)
gate_bwd_kernel(const Tin* __restrict__ x, const int* __restrict__ lens,
                const float* __restrict__ h, float* __restrict__ ds_du, LayerParams p,
                LayerParamsT q, Dropout dr, float* __restrict__ partial, GradLayout gl,
                int B, int T, int D, int C, int K, int use_conv, int prologue) {
  extern __shared__ float smem[];
  float* xs = smem;                 // [xs_rows(K), D]  x rows t0-H .. t_end-1
  float* xb = xs + xs_rows(K) * D;  // [xb_rows(K), C]  x @ W_in[:, :C]
  float* u = xb + xb_rows(K) * C;   // [TT, C]   conv output
  float* xc = u + TT * C;        // [TT, C]   silu(u)
  float* g = xc + TT * C;        // [TT, 2C]  gates pre-activation -> dg
  float* dsb = g + TT * 2 * C;   // [TT, C]   d_states -> dxc -> du
  float* lt = dsb + TT * C;      // [TT, C]   per-position lambda terms
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
    if (XB) {
      for (int i = threadIdx.x; i < rows_h * C; i += blockDim.x) {
        const int t = t0 - H + i / C;
        xb[i] = t >= 0 ? load_act(x, ((size_t)b * T + t) * C + i % C) : 0.f;
      }
    } else {
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
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
      const int r = i / C, c = i % C;
      if (use_conv) {
        const int rr = r + H;
        float uv = xb[rr * C + c] * p.wc[(K - 1) * C + c] + p.bc[c];
        for (int j = 1; j < K; ++j) {
          const float xv = (t0 + r - j >= 0) ? xb[(rr - j) * C + c] : 0.f;
          uv += xv * p.wc[(K - 1 - j) * C + c];
        }
        u[i] = uv;
        xc[i] = silu_t(uv);
      } else {
        xc[i] = xb[r * C + c];
      }
    }
    __syncthreads();
    block_matmul(xc, C, rows, C, p.wg, 2 * C, 2 * C, p.bg, g, 2 * C);
    for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
      const int r = i / C, c = i % C;
      dsb[i] = ds_du[((size_t)b * T + t0 + r) * C + c];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
      const int r = i / C, c = i % C;
      const int t = t0 + r;
      const float sr = sigmoid_t(g[r * 2 * C + c]);
      const float si = sigmoid_t(g[r * 2 * C + C + c]);
      const float spl = softplus_t(p.lam[c]);
      const float a = exp_t(-spl * sr);
      const float s = sqrtf(1.f - a * a + GATE_EPS);
      const float beta = s * si;
      const float hp = t > 0 ? h[((size_t)b * T + t - 1) * C + c] : 0.f;
      const float d = dsb[i];
      const float d_beta = d * xc[i];
      const float d_a = hp * d - d_beta * si * a / s;
      const float d_r = -d_a * a * spl * sr * (1.f - sr);
      g[r * 2 * C + c] = d_r;
      g[r * 2 * C + C + c] = d_beta * s * si * (1.f - si);
      lt[i] = -d_a * a * sr * sigmoid_t(p.lam[c]);
      dsb[i] = d * beta;
    }
    __syncthreads();
    block_colsum(lt, C, nullptr, 0, rows, C, gp + gl.off[G_LAM]);
    block_grad_matmul(xc, C, g, 2 * C, rows, C, 2 * C, gp + gl.off[G_WG], 2 * C);
    block_colsum(g, 2 * C, nullptr, 0, rows, 2 * C, gp + gl.off[G_BG]);
    __syncthreads();
    block_matmul<true>(g, 2 * C, rows, 2 * C, q.wgT, C, C, nullptr, dsb, C);  // dxc
    __syncthreads();
    if (use_conv) {
      for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
        const float su = sigmoid_t(u[i]);
        dsb[i] *= su * (1.f + u[i] * (1.f - su));  // du
      }
      __syncthreads();
      block_colsum(dsb, C, nullptr, 0, rows, C, gp + gl.off[G_BC]);
      for (int idx = threadIdx.x; idx < K * C; idx += blockDim.x) {
        const int k = idx / C, c = idx % C;
        const int j = K - 1 - k;  // tap k multiplies xb[t - j]
        float s = 0.f;
        for (int r = 0; r < rows; ++r)
          if (t0 + r - j >= 0) s += xb[(r + H - j) * C + c] * dsb[r * C + c];
        gp[gl.off[G_WC] + idx] += s;
      }
    }
    for (int i = threadIdx.x; i < rows * C; i += blockDim.x) {
      const int r = i / C, c = i % C;
      ds_du[((size_t)b * T + t0 + r) * C + c] = dsb[i];
    }
  }
}

// ---------------------------------------------------------------------------
// C2': in-projection and prologue backward, dx
// ---------------------------------------------------------------------------

inline size_t inproj_bwd_smem_bytes(int D, int C) {
  return sizeof(float) * ((size_t)TT * (3 * D + 2 * C) + TT);
}

// Item (b, tile).  Without lens: dxz = [dxb, dz] over 2C channels and
// dx = dxr + dxz @ W_in^T.  With lens: dxz = dxb over C channels, dx =
// dxb @ W_in[:, :C]^T plus dxr[b] at position n-1, and dx = 0 at and
// beyond the row's length.
template <typename Tin>
__global__ void __launch_bounds__(THREADS)
inproj_bwd_kernel(const Tin* __restrict__ x, const int* __restrict__ lens,
                  const float* __restrict__ du, const float* __restrict__ dz,
                  const float* __restrict__ dxr, Tin* __restrict__ dx, LayerParams p,
                  LayerParamsT q, Dropout dr, float* __restrict__ partial, GradLayout gl,
                  int B, int T, int D, int C, int K, int use_conv, int prologue) {
  extern __shared__ float smem[];
  const int NW = dz ? 2 * C : C;
  float* xs = smem;            // [TT, D]   layer input (post-prologue)
  float* v0 = xs + TT * D;     // [TT, D]   prologue vhat
  float* dxs = v0 + TT * D;    // [TT, D]   dx
  float* dxz = dxs + TT * D;   // [TT, NW]  [dxb, dz]
  float* inv0 = dxz + TT * 2 * C;
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
    for (int i = threadIdx.x; i < rv * D; i += blockDim.x) {
      const int r = i / D, d = i % D;
      float v = load_act(x, ((size_t)b * T + t0 + r) * D + d);
      if (prologue) {
        v0[i] = v * drop_mask(dr, M0, b, t0 + r, d);
      } else {
        xs[i] = v;
      }
    }
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
      dxz[r * NW + c] = s;
      if (dz) dxz[r * NW + C + c] = dz[o];
    }
    __syncthreads();
    if (prologue) {
      block_layernorm_save(v0, D, rv, D, inv0, p.pl_s, p.pl_b, xs, D);
      __syncthreads();
    }
    block_grad_matmul(xs, D, dxz, NW, rv, D, NW, gp + gl.off[G_W_IN], 2 * C);
    block_matmul(dxz, NW, rv, NW, q.w_inT, D, D, nullptr, dxs, D);
    __syncthreads();
    for (int i = threadIdx.x; i < rv * D; i += blockDim.x) {
      const int r = i / D, d = i % D;
      const int t = t0 + r;
      if (lens == nullptr)
        dxs[i] += dxr[((size_t)b * T + t) * D + d];
      else if (t == n - 1)
        dxs[i] += dxr[(size_t)b * D + d];
    }
    __syncthreads();
    if (prologue) {
      block_colsum(dxs, D, v0, D, rv, D, gp + gl.off[G_PL_S]);
      block_colsum(dxs, D, nullptr, 0, rv, D, gp + gl.off[G_PL_B]);
      __syncthreads();
      block_layernorm_bwd(dxs, D, v0, D, inv0, rv, D, p.pl_s);
      __syncthreads();
    }
    for (int i = threadIdx.x; i < rv * D; i += blockDim.x) {
      const int r = i / D, d = i % D;
      const float m = prologue ? drop_mask(dr, M0, b, t0 + r, d) : 1.f;
      store_act(dx, ((size_t)b * T + t0 + r) * D + d, dxs[i] * m);
    }
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
