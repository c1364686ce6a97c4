// Whole post-LN transformer encoder layer forward for Hopper, causal or
// bidirectional.
//
// Replaces the TPU kernel datamining_recblr_tpu/ops/fused_block.py:
// _fwd_kernel (_block_fwd_core; reached through _block_fwd /
// fused_transformer_layer), dropout included.  At the training shape (B
// 2,048, D 64, 2 heads of 32, FFN 256, T 200) one row is 2T(4D^2 + 2DI)
// ~ 19.7 MFLOP of dense products and 4D per kept (query, key) pair, against
// 2TD x 4 bytes of activations: bound by operations.  Every product runs on
// the tensor cores (mma.sync: 3xTF32 in fp32, bf16 operands and fp32 sums
// for bf16 x, each k-tile of a 3xTF32 sum in a fresh accumulator), in
// three phases:
//   A  per 128 positions of [B * T]: x @ [W_q | W_k | W_v] + b into a
//      [B, T, 3D] fp32 scratch the wrapper allocates (attn_common.cuh
//      proj_kernel);
//   B  per (row, query tile of 32 positions): for each head the scores
//      q_h k_h^T, the masked softmax and P.V over the keys below key_end
//      only (attention.cuh: with lens >= 1 every key beyond it is masked
//      for the whole tile and its exp underflows to exactly 0; a row with
//      lens 0 visits all T, its fp32 scores FMA sums: see attn_kernel),
//      from shared memory (mma_smem.cuh mma_mm), K_h and V_h staged by
//      cp.async (attn_kernel).  It writes the [B, T, D] fp32 context: a
//      training call's ctx, else the scratch's q columns, which no block
//      reads once its own queries are staged.  ~72 KB of shared memory at
//      the training shape: three blocks an SM;
//   C  per 128 rows of [B * T], 16 a warp: W_o, the LN1 residual, the FFN
//      and the LN2 residual (tail_kernel), each warp's values in registers
//      from one product to the next (the FFN's activation is the A operand
//      of its W2 product, W2's sum over the FFN's chunks is kept there);
//      the warps share only the weights in shared memory, W_o staged once
//      and the FFN's chunks of 32 columns double-buffered.
// The tiles of one row are neighbours in phase B's grid, so a row's K and
// V come from L2 after the first.  In fp32 each A operand that several
// warps read (the queries) is split into its TF32 terms once.  V's first
// chunk and the next head's queries are copied while the softmax runs.  The
// softmax rounds as the plain version does (softmax_row: multiply and add
// apart, exp2, one division per key), two passes over the keys that can
// weigh.  One call is one launch of the wrapper (three kernels).
// Dropout: each head's probabilities are masked after the softmax, before
// P.V, four keys per Philox call; the tail masks the W_o and the FFN
// outputs (common.cuh drop_mask's bits).  A training call (ctx != null)
// writes the context for fused_block_bwd.cu, which reads it and the q/k/v
// scratch.
//
// C interface (loaded with ctypes): returns a cudaError_t, 0 on success.
#include "attn_common.cuh"

using namespace recblr;

namespace {

// ---------------------------------------------------------------------------
// phase B: attention
// ---------------------------------------------------------------------------

constexpr int ATT_QT = 32;  // query rows a block of attn_kernel

// The shared memory of attn_kernel, in floats: qh [ATT_QT][lq] (one head's
// queries; in fp32 their tf32_split hi terms, then the lo terms in a second
// [ATT_QT][lq]), ss [ATT_QT][ls] (the scores, then the probabilities) and ws
// [kc] rows, where a chunk of kc keys of K or V is staged.
struct AttnSmem {
  int lq, ls, lk, lv;
  size_t floats;
};

template <bool RB>
__host__ __device__ inline AttnSmem attn_smem(int kc, int T, int D, int H) {
  AttnSmem s;
  const int dh16 = pad16(D / H);
  s.lq = s.lk = ld_k<RB>(dh16);
  s.lv = ld_n<RB>(dh16);
  s.ls = ld_k<RB>(pad16(T));
  s.floats = (size_t)ATT_QT * ((RB ? 1 : 2) * s.lq + s.ls) +
             (size_t)kc * (s.lk > s.lv ? s.lk : s.lv);
  return s;
}

// The key chunk of attn_kernel: all keys up to 256, halved until a block's
// shared memory is within 200 KB.  Every shape fused_block.supports passes
// fits with at least 64 keys (D 128, one head, T 1,024); at the training
// shape (T 200, dh 32) a block holds ~72 KB and three share an SM.
template <bool RB>
inline int attn_chunk(int T, int D, int H) {
  int kc = pad16(T) < 256 ? pad16(T) : 256;
  while (kc > 16 && sizeof(float) * attn_smem<RB>(kc, T, D, H).floats > 200 * 1024)
    kc = pad16(kc / 2);
  return kc;
}

// softmax_row (attn_common.cuh) over keys j < kd of one row, one warp, with
// its head's dropout: four keys a lane at a time (16-byte accesses, one
// Philox call for their four masks, attention.cuh prob_mask_words).  Key j
// is kept iff j < klim (below the length and, when causal, not after the
// query).  kd is the visited keys' end, or klim where that is less on a row
// that keeps a key: the keys from there to kpad get probability 0 without an
// exp, since theirs underflows to exactly 0.
__device__ void softmax_drop_row4(float* row, int kpad, int klim, int kd, float scale,
                                  const Dropout& dra, int h, int b, int qpos) {
  const int lane = threadIdx.x % 32, G = (kd + 3) / 4;
  float4* r4 = reinterpret_cast<float4*>(row);
  auto unpack = [](const float4& t, float (&v)[4]) {
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  };
  float v[4];
  float mx = -INFINITY;
  for (int g = lane; g < G; g += 32) {
    unpack(r4[g], v);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = 4 * g + q;
      v[q] = j < kd ? __fadd_rn(__fmul_rn(v[q], scale), j < klim ? 0.f : MASK_VALUE) : -INFINITY;
      mx = fmaxf(mx, v[q]);
    }
    r4[g] = make_float4(v[0], v[1], v[2], v[3]);
  }
  mx = warp_max(mx);
  float sum = 0.f;
  for (int g = lane; g < G; g += 32) {
    unpack(r4[g], v);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[q] = 4 * g + q < kd ? exp_t(__fsub_rn(v[q], mx)) : 0.f;
      sum += v[q];
    }
    r4[g] = make_float4(v[0], v[1], v[2], v[3]);
  }
  sum = warp_sum(sum);
  for (int g = lane; g < G; g += 32) {
    unpack(r4[g], v);
    float m[4] = {1.f, 1.f, 1.f, 1.f};
    if (dra.on) {
      const uint4 w = attn::prob_mask_words(dra, h, b, qpos, g);
#pragma unroll
      for (int q = 0; q < 4; ++q) m[q] = attn::mask_of(dra, w, q);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = 4 * g + q < kd ? __fdiv_rn(v[q], sum) * m[q] : 0.f;
    r4[g] = make_float4(v[0], v[1], v[2], v[3]);
  }
  for (int j = 4 * G + lane; j < kpad; j += 32) row[j] = 0.f;
}

// Block (tile, b0): query tile blockIdx.x of rows b0, b0 + gridDim.y, ...
// (the tiles of one row run side by side and share its K and V in L2).
// Writes the context of the tile's rows into c [b, t, 0 : D] (row stride
// ldc): the training context, or, when serving, the q columns of the
// scratch, which no block reads once its own queries are staged.
template <typename Tin>
__global__ void __launch_bounds__(ATT_THREADS, 3)
attn_kernel(const int* __restrict__ lens, const float* qkv, float* c, int ldc, Dropout dra,
            int B, int T, int D, int H, int kcm, int causal, float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool RB = IS_BF16<Tin>, AS = !RB;
  constexpr int QT = ATT_QT;
  const AttnSmem L = attn_smem<RB>(kcm, T, D, H);
  const int t0 = blockIdx.x * QT;
  const int rows = min(QT, T - t0);
  const int dh = D / H, dh16 = pad16(dh), ld3 = 3 * D;
  float* qh = smem;                       // [QT][lq]  head h's queries (fp32: hi terms)
  float* ql = qh + (AS ? QT * L.lq : 0);  // [QT][lq]  fp32: their lo terms
  float* ss = ql + QT * L.lq;             // [QT][ls]  head h's scores, then probabilities
  float* ws = ss + QT * L.ls;             // [kcm][.]  a chunk of K or V
  const int warp = threadIdx.x / 32, nwarps = blockDim.x / 32;

  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const int n = lens[b];
    const float* qkv_b = qkv + (size_t)b * T * ld3;
    float* c_b = c + ((size_t)b * T + t0) * ldc;
    const attn::RowKeys rk = attn::row_keys(n, T);
    const int kend = attn::key_end(rk, causal, t0 + rows);
    const int kpad = pad16(kend);
    // A row that keeps no key scores every key at -10000, where an fp32 ulp
    // is 2^-10: a last-bit difference in a score moves its probability by
    // 0.1%, which 3xTF32's error (several times an fp32 FMA sum's) would
    // carry to the output.  Such a row's fp32 scores are FMA sums in depth
    // order, as the FMA kernels compute them.
    const bool fma_scores = AS && !rk.any;
    __syncthreads();  // the previous row's tile is done
    stage<false>(qh, L.lq, qkv_b + (size_t)t0 * ld3, ld3, rows, dh, QT, dh16);
    for (int h = 0; h < H; ++h) {
      if (AS && !fma_scores) {
        __syncthreads();  // head h's queries landed
        split_tf32(qh, qh, ql, L.lq, QT, dh16);
      }
      // scores q_h k_h^T of the visited keys, kcm keys at a time
      for (int c0 = 0; c0 < kend; c0 += kcm) {
        const int kc = min(kcm, kend - c0);
        __syncthreads();  // ws free, qh staged
        stage<false>(ws, L.lk, qkv_b + (size_t)c0 * ld3 + D + h * dh, ld3, kc, dh, pad16(kc),
                     dh16);
        __syncthreads();
        if (fma_scores) {
          for (int i = threadIdx.x; i < rows * kc; i += blockDim.x) {
            const float* q = qh + (i / kc) * L.lq;
            const float* k = ws + (i % kc) * L.lk;
            float acc = 0.f;
            for (int d = 0; d < dh; ++d) acc = fmaf(q[d], k[d], acc);
            ss[(i / kc) * L.ls + c0 + i % kc] = acc;
          }
        } else {
          mma_mm<RB, true, 2, 2, AS>(qh, L.lq, ws, L.lk, rows, kc, dh16,
                                     [&](int m, int j, float v) { ss[m * L.ls + c0 + j] = v; },
                                     ql);
        }
      }
      __syncthreads();
      // V's first chunk and the next head's queries land during the softmax
      const int kc0 = min(kcm, kend);
      stage<false>(ws, L.lv, qkv_b + 2 * D + h * dh, ld3, kc0, dh, pad16(kc0), pad8(dh), false);
      if (h + 1 < H)
        stage<false>(qh, L.lq, qkv_b + (size_t)t0 * ld3 + (h + 1) * dh, ld3, rows, dh, QT, dh16,
                     false);
      // the masked softmax of each row over keys < kend (one warp a row),
      // head h's dropout mask on the keys whose probability is not exactly
      // 0 (below the length and, when causal, up to the query), zeros up to
      // kpad (P.V's depth padding)
      for (int i = warp; i < rows; i += nwarps) {
        const int q = t0 + i, klim = causal ? min(n, q + 1) : n;
        softmax_drop_row4(ss + i * L.ls, kpad, klim, rk.any ? min(kend, klim) : kend, scale,
                          dra, h, b, q);
      }
      // context p_h v_h, kcm keys at a time, summed in c
      for (int c0 = 0; c0 < kend; c0 += kcm) {
        const int kc = min(kcm, kend - c0);
        if (c0 > 0) {
          __syncthreads();  // ws free
          stage<false>(ws, L.lv, qkv_b + (size_t)c0 * ld3 + 2 * D + h * dh, ld3, kc, dh,
                       pad16(kc), pad8(dh));
        } else {
          cp_async_wait_all();
        }
        __syncthreads();  // the chunk landed, the probabilities complete
        mma_mm<RB, false, 1, 1>(ss + c0, L.ls, ws, L.lv, rows, dh, pad16(kc),
                                [&](int m, int j, float v) {
                                  float* o = c_b + (size_t)m * ldc + h * dh + j;
                                  *o = c0 == 0 ? v : *o + v;
                                });
      }
      __syncthreads();  // qh and ss free for the next head
    }
  }
}

// ---------------------------------------------------------------------------
// phase C: the layer's tail
// ---------------------------------------------------------------------------

constexpr int TAIL_ROWS = 128;  // rows of [B * T] a block: 16 a warp
constexpr int TFC = 32;         // FFN columns a chunk

// The shared memory of tail_kernel, in floats: W_o [D16][lo]; two buffers
// of an FFN chunk, W1's columns [D16][l1] and W2's rows [TFC][lo]; the
// block's rows [TAIL_ROWS][lr] (the context, then r1).
template <bool RB>
struct TailSmem {
  int lo, l1, lr, chunk;
  __host__ __device__ explicit TailSmem(int D)
      : lo(ld_n<RB>(pad16(D))), l1(ld_n<RB>(TFC)), lr(ld_k<RB>(pad16(D))),
        chunk(pad16(D) * ld_n<RB>(TFC) + TFC * ld_n<RB>(pad16(D))) {}
  __host__ __device__ size_t floats(int D) const {
    return (size_t)pad16(D) * lo + 2 * (size_t)chunk + (size_t)TAIL_ROWS * lr;
  }
};

// The A fragment of the depth step at k0 of a warp's 16 rows a (row stride
// lda): bf16 m16n8k16 in hi, or the two TF32 terms of m16n8k8 in hi and
// lo, each value split as it is read.
template <bool RB>
__device__ __forceinline__ void row_frag(const float* a, int lda, int k0, uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  const int gid = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const float* p = a + gid * lda + k0;
  if constexpr (RB) {
    const float2 v0 = *reinterpret_cast<const float2*>(p + 2 * t);
    const float2 v1 = *reinterpret_cast<const float2*>(p + 8 * lda + 2 * t);
    const float2 v2 = *reinterpret_cast<const float2*>(p + 2 * t + 8);
    const float2 v3 = *reinterpret_cast<const float2*>(p + 8 * lda + 2 * t + 8);
    hi[0] = pack_bf16(v0.x, v0.y);
    hi[1] = pack_bf16(v1.x, v1.y);
    hi[2] = pack_bf16(v2.x, v2.y);
    hi[3] = pack_bf16(v3.x, v3.y);
  } else {
    tf32_split(p[t], hi[0], lo[0]);
    tf32_split(p[8 * lda + t], hi[1], lo[1]);
    tf32_split(p[t + 4], hi[2], lo[2]);
    tf32_split(p[8 * lda + t + 4], hi[3], lo[3]);
  }
}

// acc += A B for one 16 x 8 output tile at B's column n.  B's depth rows
// are ra and rb of b (row stride ldb); bf16 reads ra, ra + 1 and rb, rb + 1
// (the fragment's b0 and b1).  fp32: 3xTF32 in a fresh accumulator, added
// in fp32 (add_tile).
template <bool RB>
__device__ __forceinline__ void tile_mma(float (&acc)[4], const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4], const float* b, int ldb,
                                         int ra, int rb, int n) {
  if constexpr (RB) {
    mma_bf16_16816(acc, ah, pack_bf16(b[ra * ldb + n], b[(ra + 1) * ldb + n]),
                   pack_bf16(b[rb * ldb + n], b[(rb + 1) * ldb + n]));
  } else {
    uint32_t h0, l0, h1, l1;
    tf32_split(b[ra * ldb + n], h0, l0);
    tf32_split(b[rb * ldb + n], h1, l1);
    float cc[4] = {0.f, 0.f, 0.f, 0.f};
    mma_3xtf32(cc, ah, al, __uint_as_float(h0), __uint_as_float(h1), __uint_as_float(l0),
               __uint_as_float(l1));
    add_tile(acc, cc);
  }
}

// acc = A W for a warp's 16 rows a (row stride lda, the D16-deep depth)
// against w [D16][ldw], the 8-column tiles j < nt of acc.
template <bool RB, int NT>
__device__ __forceinline__ void rows_mm(float (&acc)[NT][4], const float* a, int lda,
                                        const float* w, int ldw, int D16, int nt) {
  const int gid = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  uint32_t ah[4], al[4];
  for (int k0 = 0; k0 < D16; k0 += RB ? 16 : 8) {
    row_frag<RB>(a, lda, k0, ah, al);
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (j < nt)
        tile_mma<RB>(acc[j], ah, al, w, ldw, k0 + (RB ? 2 * t : t), k0 + (RB ? 2 * t + 8 : t + 4),
                     8 * j + gid);
  }
}

// A warp's 16 rows after W_o or the FFN, from their C tiles in registers:
// v = (acc + bias) * mask(id) + res, then LayerNorm (lns, lnb) over the D
// columns (a row's values sit in the four lanes of a quad).  The result
// goes to the rows' shared-memory copy r (row stride lr; zero from D to
// pad16(D)) and, with out, to the layer's output.  res: the layer input x
// (after W_o) or r itself (after the FFN).  Global rows from g0 on, below
// nrows; mask coordinates (row / T, row % T), one Philox call per four
// channels.
template <int NT, typename Tin>
__device__ __forceinline__ void tail_rows(const float (&acc)[NT][4], const float* bias,
                                          const Dropout& drh, int id, const Tin* x, float* r,
                                          int lr, const float* lns, const float* lnb, Tin* out,
                                          long long g0, long long nrows, int T, int D) {
  const int gid = threadIdx.x % 32 / 4, t = threadIdx.x % 4, D16 = pad16(D);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int lrow = gid + 8 * half;
    const long long g = g0 + lrow;
    const bool live = g < nrows;
    const int bb = live ? (int)(g / T) : 0, tt = live ? (int)(g % T) : 0;
    float v[NT][2];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = 8 * j + 2 * t;
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (drh.on && live && col < D)
        w = philox4x32_10(make_uint4((unsigned)(col / 4), (unsigned)tt, (unsigned)bb,
                                     (unsigned)id), drh.k0, drh.k1);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cc = col + e;
        float z = 0.f;
        if (live && cc < D) {
          const unsigned bits = (cc & 2) ? ((cc & 1) ? w.w : w.z) : ((cc & 1) ? w.y : w.x);
          const float mk = drh.on ? (bits < drh.thresh ? drh.scale : 0.f) : 1.f;
          const float rv = x != nullptr ? load_act(x, (size_t)g * D + cc) : r[lrow * lr + cc];
          z = (acc[j][2 * half + e] + __ldg(bias + cc)) * mk + rv;
        }
        v[j][e] = z;
        sum += z;
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float mu = sum / D;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (8 * j + 2 * t + e < D) {
          const float d = v[j][e] - mu;
          sq += d * d;
        }
    sq += __shfl_xor_sync(0xffffffffu, sq, 1);
    sq += __shfl_xor_sync(0xffffffffu, sq, 2);
    const float inv = rsqrtf(sq / D + LN_EPS);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cc = 8 * j + 2 * t + e;
        if (cc >= D16) continue;
        const float y = cc < D ? (v[j][e] - mu) * inv * __ldg(lns + cc) + __ldg(lnb + cc) : 0.f;
        r[lrow * lr + cc] = y;
        if (out != nullptr && live && cc < D) store_act(out, (size_t)g * D + cc, y);
      }
  }
}

// Block i: rows i TAIL_ROWS .. of [B * T], warp w the 16 from 16 w.  Per
// warp, in registers: r1 = LN1(m1 * (c W_o + b_o) + x), then the FFN in
// chunks of TFC columns: each chunk's act(r1 W1 + b1) stays in registers as
// the A operand of its W2 product (mma_tile.cuh split_c_as_a, pack_c_as_a),
// and W2's sum over the chunks stays there too; then out = LN2(m3 * (that +
// b2) + r1).  The warps share only the weights: W_o staged once, the chunks
// in two buffers, the next copied while the current one is used.  NT: the
// 8-column tiles of D (8 up to D 64, 16 up to 128).
template <typename Tin, int NT>
__global__ void __launch_bounds__(ATT_THREADS, 2)
tail_kernel(const Tin* __restrict__ x, const float* c, int ldc, Tin* __restrict__ out,
            BlockParams p, Dropout drh, long long nrows, int T, int D, int I, int act) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool RB = IS_BF16<Tin>;
  const TailSmem<RB> L(D);
  const int D16 = pad16(D), nt = D16 / 8, nchunks = (I + TFC - 1) / TFC;
  const int warp = threadIdx.x / 32, t = threadIdx.x % 4;
  const long long r0 = (long long)blockIdx.x * TAIL_ROWS;
  const int rows = (int)min((long long)TAIL_ROWS, nrows - r0);
  float* wo = smem;                      // [D16][lo]
  float* wc = wo + D16 * L.lo;           // 2 x (W1 chunk [D16][l1], W2 chunk [TFC][lo])
  float* rw = wc + 2 * L.chunk + 16 * warp * L.lr;  // the warp's 16 rows
  const long long g0 = r0 + 16 * warp;
  auto stage_chunk = [&](int k, bool wait) {
    const int c0 = k * TFC, fc = min(TFC, I - c0);
    float* w1 = wc + (k & 1) * L.chunk;
    stage<false>(w1, L.l1, p.w1 + c0, I, D, fc, D16, TFC, false);
    stage<false>(w1 + D16 * L.l1, L.lo, p.w2 + (size_t)c0 * D, D, fc, D, TFC, D16, wait);
  };
  stage<false>(wo, L.lo, p.w_o, D, D, D, D16, D16, false);
  stage<false>(wc + 2 * L.chunk, L.lr, c + (size_t)r0 * ldc, ldc, rows, D, TAIL_ROWS, D16,
               false);
  stage_chunk(0, true);
  __syncthreads();

  // r1 = LN1(m1 * (c W_o + b_o) + x)
  float acc[NT][4];
  rows_mm<RB, NT>(acc, rw, L.lr, wo, L.lo, D16, nt);
  __syncwarp();  // the warp's rows are read
  tail_rows<NT>(acc, p.b_o, drh, M1, x, rw, L.lr, p.ln1_s, p.ln1_b, (Tin*)nullptr, g0, nrows,
                T, D);
  __syncwarp();  // r1 is written

  // the FFN, chunk by chunk; acc sums W2's products
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int k = 0; k < nchunks; ++k) {
    if (k + 1 < nchunks) stage_chunk(k + 1, false);  // lands during this chunk
    const float* w1 = wc + (k & 1) * L.chunk;
    const float* w2 = w1 + D16 * L.l1;
    const int c0 = k * TFC, fc = min(TFC, I - c0);
    float a1[TFC / 8][4];  // act(r1 W1 + b1), chunk columns 8 j ..
    rows_mm<RB, TFC / 8>(a1, rw, L.lr, w1, L.l1, D16, TFC / 8);
#pragma unroll
    for (int j = 0; j < TFC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);
        a1[j][e] = col < fc ? act_fwd(act, a1[j][e] + __ldg(p.b1 + c0 + col)) : 0.f;
      }
    const int gid = threadIdx.x % 32 / 4;
    if constexpr (RB) {
#pragma unroll
      for (int j = 0; j < TFC / 8; j += 2) {
        uint32_t a[4];
        pack_c_as_a(a1[j], a1[j + 1], a);  // depth 16: columns 8 j .. 8 j + 15
#pragma unroll
        for (int jn = 0; jn < NT; ++jn)
          if (jn < nt)
            tile_mma<RB>(acc[jn], a, a, w2, L.lo, 8 * j + 2 * t, 8 * j + 2 * t + 8, 8 * jn + gid);
      }
    } else {
#pragma unroll
      for (int j = 0; j < TFC / 8; ++j) {
        uint32_t hi[4], lo[4];
        split_c_as_a(a1[j], hi, lo);  // depth t: column 2 t, depth t + 4: column 2 t + 1
#pragma unroll
        for (int jn = 0; jn < NT; ++jn)
          if (jn < nt)
            tile_mma<RB>(acc[jn], hi, lo, w2, L.lo, 8 * j + 2 * t, 8 * j + 2 * t + 1,
                         8 * jn + gid);
      }
    }
    cp_async_wait_all();
    __syncthreads();  // the next chunk landed; every warp is done with this one
  }
  tail_rows<NT>(acc, p.b2, drh, M3, (const Tin*)nullptr, rw, L.lr, p.ln2_s, p.ln2_b, out, g0,
                nrows, T, D);
}

template <typename Tin, int NT>
cudaError_t launch_tail(const Tin* x, const float* c, int ldc, Tin* out, const BlockParams& p,
                        const Dropout& drh, long long nrows, int T, int D, int I, int act,
                        cudaStream_t stream) {
  const size_t sb = sizeof(float) * TailSmem<IS_BF16<Tin>>(D).floats(D);
  cudaError_t e = cudaFuncSetAttribute(tail_kernel<Tin, NT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sb);
  if (e != cudaSuccess) return e;
  tail_kernel<Tin, NT><<<(unsigned)((nrows + TAIL_ROWS - 1) / TAIL_ROWS), ATT_THREADS, sb,
                         stream>>>(x, c, ldc, out, p, drh, nrows, T, D, I, act);
  return cudaGetLastError();
}

template <typename Tin>
cudaError_t block_fwd(const Tin* x, const int* lens, Tin* out, BlockParams p, float* qkv,
                      float* ctx, Dropout drh, Dropout dra, int B, int T, int D, int H, int I,
                      int causal, int act, float scale, cudaStream_t stream) {
  constexpr bool RB = IS_BF16<Tin>;
  const long long nrows = (long long)B * T;
  ProjParams pp = {{p.w_q, p.w_k, p.w_v}, {p.b_q, p.b_k, p.b_v}};
  cudaError_t e = launch_proj(x, lens, pp, 3, qkv, nrows, T, D, stream);
  if (e != cudaSuccess) return e;

  const int kc = attn_chunk<RB>(T, D, H);
  const size_t sb = sizeof(float) * attn_smem<RB>(kc, T, D, H).floats;
  e = cudaFuncSetAttribute(attn_kernel<Tin>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)sb);
  if (e != cudaSuccess) return e;
  // the context: the training output, or the scratch's q columns
  float* c = ctx != nullptr ? ctx : qkv;
  const int ldc = ctx != nullptr ? D : 3 * D;
  const dim3 grid((T + ATT_QT - 1) / ATT_QT, B < 65535 ? B : 65535);
  attn_kernel<Tin><<<grid, ATT_THREADS, sb, stream>>>(lens, qkv, c, ldc, dra, B, T, D, H, kc,
                                                      causal, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (pad16(D) <= 64)
    return launch_tail<Tin, 8>(x, c, ldc, out, p, drh, nrows, T, D, I, act, stream);
  return launch_tail<Tin, 16>(x, c, ldc, out, p, drh, nrows, T, D, I, act, stream);
}

}  // namespace

extern "C" {

// x, out: [B, T, D] fp32 (bf16 == 0) or bf16; lens: [B] int32 non-PAD
// counts; params: 16 device pointers (BlockParams order); qkv: [B, T, 3D]
// fp32 scratch; ctx: [B, T, D] fp32 context out, or null (serving); act:
// attn_common.cuh act_fwd id; scale: 1 / sqrt(D / H); then the hidden
// and the attention dropout (on, seed, thresh, scale: common.cuh
// Dropout); device: the card that holds them.
int recblr_block_fwd(const void* x, const void* lens, void* out, const void* const* params,
                     void* qkv, void* ctx, int B, int T, int D, int H, int I, int causal,
                     int act, float scale, int bf16, int drop_h, unsigned long long seed_h,
                     unsigned thresh_h, float scale_h, int drop_a, unsigned long long seed_a,
                     unsigned thresh_a, float scale_a, int device, void* stream) {
  // this library has its own (static) CUDA runtime: select the tensors' card
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const BlockParams p = unpack_block_params(params);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* l = static_cast<const int*>(lens);
  float* q = static_cast<float*>(qkv);
  float* c = static_cast<float*>(ctx);
  const Dropout drh = make_dropout(drop_h, seed_h, thresh_h, scale_h);
  const Dropout dra = make_dropout(drop_a, seed_a, thresh_a, scale_a);
  if (bf16)
    return block_fwd(static_cast<const __nv_bfloat16*>(x), l, static_cast<__nv_bfloat16*>(out),
                     p, q, c, drh, dra, B, T, D, H, I, causal, act, scale, s);
  return block_fwd(static_cast<const float*>(x), l, static_cast<float*>(out), p, q, c, drh, dra,
                   B, T, D, H, I, causal, act, scale, s);
}

const char* recblr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
