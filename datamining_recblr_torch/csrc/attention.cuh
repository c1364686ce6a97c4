// Shared device code of the masked-softmax attention kernels
// (attention.cu, attention_bwd.cu): the key range a row visits, the
// score of one (query, key) pair under the additive mask, the dropout
// words, and the pieces of the tensor-core kernels (dh <= MMA_MAX_DH):
// staging, the two products of a warp's 16 rows, the lens-0 scores.
//
// The mask of the TPU kernel (datamining_recblr_tpu/ops/attention.py
// _attn_mask) adds -10000, never -inf: keys at col >= lens, and with
// causal at col > row.  Two cases follow, and the kernels use both:
//   * a row of a sequence with lens >= 1 keeps key 0 under either mask,
//     so every masked key's exp(s - 10000 - max) underflows to exactly 0
//     in fp32: the kernels drop masked keys (score -inf, probability 0)
//     and never visit a key tile that the mask removes entirely;
//   * a row with lens <= 0 keeps no key, so all T keys carry the same
//     -10000 and the softmax averages over all of them.  The kernels use
//     the scores as the reference rounds them, (s - 10000) + 10000, which
//     is exact after the first rounding, so that the log-sum-exp stays in
//     the scores' own range and the backward recomputes the
//     probabilities to fp32 rounding.  There an fp32 ulp is 2^-10 and a
//     score's last bit moves its probability by 0.1%, so the forward and
//     both backward kernels compute such a row's raw scores alike, bit
//     for bit: FMA sums in depth order (fma_rows_t), never on the tensor
//     cores.
#pragma once

#include <math.h>

#include <type_traits>

#include "common.cuh"
#include "mma_smem.cuh"

namespace recblr {
namespace attn {

// The FMA kernels' threads: 16 x 16, tx = threadIdx.x % 16, ty = threadIdx.x / 16.
constexpr int ATTN_THREADS = 256;
constexpr float MASK_VALUE = -10000.f;

// The keys of batch row b: `any` iff lens >= 1, then keys < n are kept
// (n = min(lens, T)); without `any` every key takes the mask.
struct RowKeys {
  int any;
  int n;
};

__device__ __forceinline__ RowKeys row_keys(int len, int T) {
  RowKeys r;
  r.any = len >= 1;
  r.n = r.any ? min(len, T) : T;
  return r;
}

// End of the keys a query tile [q0, q1) visits.
__device__ __forceinline__ int key_end(const RowKeys& rk, int causal, int q1) {
  return rk.any && causal ? min(rk.n, q1) : rk.n;
}

// The masked score of query i and key j from raw = q.k * scale: -inf
// where the key drops out (a key beyond T, or a masked key of a row that
// keeps one); the rounded (raw - 10000) + 10000 on a row that keeps none.
__device__ __forceinline__ float masked_score(float raw, int i, int j, const RowKeys& rk,
                                              int causal, int T) {
  if (j >= T) return -INFINITY;
  if (!rk.any) return __fsub_rn(__fadd_rn(raw, MASK_VALUE), MASK_VALUE);
  return (j < rk.n && (!causal || j <= i)) ? raw : -INFINITY;
}

// The dropout keep-mask words of head h's probabilities at query i and
// keys 4g .. 4g+3 (mask id ATTN_PROB + h, the key as the channel and the
// query as the position: common.cuh drop_mask's counter).
__device__ __forceinline__ uint4 prob_mask_words(const Dropout& dr, int h, int b, int i, int g) {
  return philox4x32_10(make_uint4((unsigned)g, (unsigned)i, (unsigned)b, (unsigned)(ATTN_PROB + h)),
                       dr.k0, dr.k1);
}

__device__ __forceinline__ float mask_of(const Dropout& dr, const uint4& w, int q) {
  const unsigned bits = q == 0 ? w.x : q == 1 ? w.y : q == 2 ? w.z : w.w;
  return bits < dr.thresh ? dr.scale : 0.f;
}

// dst[r, c] (row stride ld) for r < nrows, c < W: row r0 + r, column c of
// the [*, dh] matrix src where r < rows and c < dh, else 0 (so that a
// ragged tile and the columns beyond dh add nothing to a product).
template <typename Tin, int W>
__device__ __forceinline__ void load_rows(const Tin* __restrict__ src, int r0, int rows,
                                          int nrows, int dh, int ld, float* __restrict__ dst) {
  for (int idx = threadIdx.x; idx < nrows * W; idx += blockDim.x) {
    const int r = idx / W, c = idx % W;
    dst[r * ld + c] = (r < rows && c < dh) ? load_act(src, (size_t)(r0 + r) * dh + c) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// the tensor-core kernels: attn_fwd_mma_kernel (attention.cu), dkdv_mma_kernel
// and dq_mma_kernel (attention_bwd.cu)
//
// A block owns 64 rows of one (row, head) for the whole walk (queries, or
// keys in dkdv; 16 a warp in the forward, 16 a warp pair in the backward),
// staged once as they are in device memory: the A operand of its warps'
// products, split into TF32 terms as it is read (no other warp reads those
// rows).  It walks chunks of the other side's rows (the B operands, read by
// every warp), copied by cp.async into one of two buffers while the
// previous chunk is used and, in fp32, split into their TF32 terms once by
// the block.  Every product runs on mma.sync with its C fragments in
// registers:
//   * rows x chunk^T (scores, dP): fp32 3xTF32 per 8-deep k-tile in a
//     fresh accumulator added in fp32 (mma_tile.cuh add_tile); bf16 q
//     m16n8k16 with bf16 operands, whose products are exact;
//   * C fragments x chunk (P V, dS K, P^T dO, dS^T Q): the fp32 P or dS
//     split in two TF32 terms (split_c_i), so it is never rounded; the
//     chunk's fp32 values in two terms too (3 products), a bf16 value is
//     exact in TF32 (2 products); each k-tile in a fresh accumulator.
// ---------------------------------------------------------------------------

constexpr int MMA_MAX_DH = 128;  // widest head the tensor-core kernels take
constexpr int MMA_THREADS = 128;  // the forward's four warps
constexpr int MMA_ROWS = 64;      // a block's own rows

template <typename Tin>
constexpr bool BF16_IN = std::is_same<Tin, __nv_bfloat16>::value;

__device__ __forceinline__ float act_f(float v) { return v; }
__device__ __forceinline__ float act_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ uint32_t word_at(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The row stride, in elements, of a staged [rows, dh16] Tin array: at least
// dh16, a multiple of 16 bytes and 4 modulo 32 in 32-bit words, so that a
// warp's fragment loads hit 32 banks (8 rows of 4 words; or rows 2t, 2t + 1
// of 8 columns, split_c_as_a's depth order: words 8t + gid).
template <typename Tin>
__host__ __device__ inline int row_ld(int dh16) {
  constexpr int per = 4 / sizeof(Tin);
  const int w = dh16 / per;
  return (w + ((4 - w % 32) % 32 + 32) % 32) * per;
}

// Bytes of one staged chunk of `rows` walked rows: fp32 its hi and lo terms,
// bf16 its values.
template <typename Tin>
__host__ __device__ inline size_t chunk_bytes(int rows, int ld) {
  return (size_t)rows * ld * sizeof(Tin) * (BF16_IN<Tin> ? 1 : 2);
}

// One staged chunk: v where the copy lands (fp32: then the hi terms), lo the
// fp32 lo terms.
template <typename Tin>
struct Chunk {
  Tin* v;
  float* lo;
};

template <typename Tin>
__device__ __forceinline__ Chunk<Tin> chunk_at(unsigned char* p, int rows, int ld) {
  Chunk<Tin> c;
  c.v = reinterpret_cast<Tin*>(p);
  c.lo = reinterpret_cast<float*>(p + (size_t)rows * ld * sizeof(Tin));
  return c;
}

// dst[r * ld + c] = src[r * dh + c] for r < rows, c < dh; zero for r <
// rows_pad, c < dh16 beyond that (so padding adds nothing to a product).
// cp.async, 16 bytes a copy, where rows are 16-byte aligned (the caller
// commits and waits); plain copies otherwise (an odd dh).
template <typename Tin>
__device__ __forceinline__ void copy_rows(Tin* dst, int ld, const Tin* src, int rows, int rows_pad,
                                          int dh, int dh16) {
  constexpr int V = 16 / sizeof(Tin);
  if (dh % V == 0 && (reinterpret_cast<size_t>(src) & 15) == 0) {
    const int cw = dh16 / V;
    for (int i = threadIdx.x; i < rows_pad * cw; i += blockDim.x) {
      const int r = i / cw, c = (i % cw) * V;
      Tin* d = dst + r * ld + c;
      if (r < rows && c < dh)
        cp_async16(d, src + (size_t)r * dh + c, 16);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int i = threadIdx.x; i < rows_pad * dh16; i += blockDim.x) {
      const int r = i / dh16, c = i % dh16;
      if (r < rows && c < dh)
        dst[r * ld + c] = src[(size_t)r * dh + c];
      else
        store_act(dst, (size_t)r * ld + c, 0.f);
    }
  }
}

// mma_tile.cuh split_c_as_a with split_i.
__device__ __forceinline__ void split_c_i(const float (&c)[4], uint32_t (&hi)[4],
                                          uint32_t (&lo)[4]) {
  split_i(c[0], hi[0], lo[0]);
  split_i(c[2], hi[1], lo[1]);
  split_i(c[1], hi[2], lo[2]);
  split_i(c[3], hi[3], lo[3]);
}

// A landed fp32 chunk split into its TF32 terms in place (v the hi terms);
// bf16 values stay as they are.
template <typename Tin>
__device__ __forceinline__ void split_chunk(const Chunk<Tin>& c, int ld, int rows, int dh16) {
  if constexpr (!BF16_IN<Tin>) {
    for (int i = threadIdx.x; i < rows * dh16; i += blockDim.x) {
      const int o = (i / dh16) * ld + i % dh16;
      uint32_t h, l;
      split_i(c.v[o], h, l);
      c.v[o] = __uint_as_float(h);
      c.lo[o] = __uint_as_float(l);
    }
  }
}

// Bytes of a block's owned rows (n arrays of 64) and its two buffers of two
// walked chunks of `rows` rows.
template <typename Tin>
__host__ __device__ inline size_t walk_bytes(int n, int rows, int ld) {
  return n * sizeof(Tin) * (size_t)ld * MMA_ROWS + 4 * chunk_bytes<Tin>(rows, ld);
}

// The walk of a block (shared memory sm, walk_bytes): its own rows own0 ..
// of ga (and gb, unless b is null; [own_n, dh]) staged once into a (and b),
// and chunks of C rows of two walked [wn, dh] matrices x and y (rows w0 +
// C c below wend) in two buffers, chunk c + 1 copied while body(c0, xc, yc)
// reads chunk c (c0 its first walked row), each split once it landed.
// own_n and wn differ on a query chunk: the queries of one seq rank
// against the keys of the whole sequence.
template <typename Tin, int C, typename Body>
__device__ __forceinline__ void walk(unsigned char* sm, Tin* a, Tin* b, const Tin* ga,
                                     const Tin* gb, int own0, const Tin* x, const Tin* y,
                                     int w0, int wend, int own_n, int wn, int dh, Body body) {
  const int dh16 = pad16(dh), ld = row_ld<Tin>(dh16);
  const size_t cb = chunk_bytes<Tin>(C, ld);
  unsigned char* bufs = sm + (b ? 2 : 1) * sizeof(Tin) * (size_t)ld * MMA_ROWS;
  auto chunk = [&](int c, int o) { return chunk_at<Tin>(bufs + ((c & 1) * 2 + o) * cb, C, ld); };
  auto fetch = [&](int c) {
    const int c0 = w0 + c * C, rows = min(C, wn - c0);
    copy_rows(chunk(c, 0).v, ld, x + (size_t)c0 * dh, rows, C, dh, dh16);
    copy_rows(chunk(c, 1).v, ld, y + (size_t)c0 * dh, rows, C, dh, dh16);
    cp_async_commit();
  };
  auto split = [&](int c) {
    split_chunk(chunk(c, 0), ld, C, dh16);
    split_chunk(chunk(c, 1), ld, C, dh16);
  };
  const int own = min(MMA_ROWS, own_n - own0), nch = (wend - w0 + C - 1) / C;
  copy_rows(a, ld, ga + (size_t)own0 * dh, own, MMA_ROWS, dh, dh16);
  if (b) copy_rows(b, ld, gb + (size_t)own0 * dh, own, MMA_ROWS, dh, dh16);
  fetch(0);
  cp_async_wait_all();
  __syncthreads();
  split(0);
  __syncthreads();
  for (int c = 0; c < nch; ++c) {
    if (c + 1 < nch) fetch(c + 1);
    body(w0 + c * C, chunk(c, 0), chunk(c, 1));
    if (c + 1 < nch) cp_async_wait_all();
    __syncthreads();  // chunk c is read, chunk c + 1 landed
    if (c + 1 < nch) split(c + 1);
    __syncthreads();
  }
}

// acc[j] = A W_j^T over depth dh16 for a warp's 16 rows a (row stride lda)
// and the chunk's rows 8j .. 8j + 7 (wh, wl, row stride ldw): fp32 3xTF32,
// each 8-deep k-tile in a fresh accumulator added in fp32, A split
// (split_i) as it is read.  A k-tile's three dependent products are a chain
// of tensor-core latency; the k-tiles, unrolled in pairs, are independent.
template <int NC>
__device__ __forceinline__ void mm_rows_t(const float* a, int lda, const float* wh,
                                          const float* wl, int ldw, int dh16,
                                          float (&acc)[NC][4]) {
  const int gid = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll 2
  for (int kk = 0; kk < dh16; kk += 8) {
    uint32_t ah[4], al[4];
    const float* q = a + gid * lda + kk + t;
    split_i(q[0], ah[0], al[0]);
    split_i(q[8 * lda], ah[1], al[1]);
    split_i(q[4], ah[2], al[2]);
    split_i(q[8 * lda + 4], ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int o = (8 * j + gid) * ldw + kk + t;
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      mma_3xtf32(c, ah, al, wh[o], wh[o + 4], wl[o], wl[o + 4]);
      add_tile(acc[j], c);
    }
  }
}

// The same for bf16 rows and chunk: m16n8k16, exact products summed in
// fp32, the even and the odd k-tiles in two accumulators (two chains)
// added at the end.
template <int NC>
__device__ __forceinline__ void mm_rows_t(const __nv_bfloat16* a, int lda,
                                          const __nv_bfloat16* w, const float*, int ldw,
                                          int dh16, float (&acc)[NC][4]) {
  const int gid = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  float odd[NC][4];
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) odd[j][e] = 0.f;
  auto step = [&](int k0, float(&sum)[NC][4]) {
    uint32_t af[4];
    const __nv_bfloat16* q = a + gid * lda + k0 + 2 * t;
    af[0] = word_at(q);
    af[1] = word_at(q + 8 * lda);
    af[2] = word_at(q + 8);
    af[3] = word_at(q + 8 * lda + 8);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const __nv_bfloat16* r = w + (8 * j + gid) * ldw + k0 + 2 * t;
      mma_bf16_16816(sum[j], af, word_at(r), word_at(r + 8));
    }
  };
  for (int k0 = 0; k0 < dh16; k0 += 32) {
    step(k0, acc);
    if (k0 + 16 < dh16) step(k0 + 16, odd);
  }
#pragma unroll
  for (int j = 0; j < NC; ++j) add_tile(acc[j], odd[j]);
}

// acc[n] += X W for a warp's 16 rows, n < nt (8-column tiles of dh): X the
// fp32 C fragments x[j] whose columns are the chunk's rows 8j .. 8j + 7 (the
// depth), split in two TF32 terms (split_c_i, as split_c_as_a: depth t is
// column 2t, t + 4 is 2t + 1, so W's rows are read in that order); W the
// chunk, fp32 in two terms (wh, wl: 3 products) or bf16, exact in TF32 (2
// products); each k-tile in a fresh accumulator.
template <int NC, int NT, typename Tin>
__device__ __forceinline__ void mm_c_w(const float (&x)[NC][4], const Tin* wh, const float* wl,
                                       int ldw, int nt, float (&acc)[NT][4]) {
  const int gid = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    uint32_t ah[4], al[4];
    split_c_i(x[j], ah, al);
    const int o = (8 * j + 2 * t) * ldw + gid;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n >= nt) break;
      const int r0 = o + 8 * n, r1 = r0 + ldw;
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (BF16_IN<Tin>)
        mma_3xtf32(c, ah, al, act_f(wh[r0]), act_f(wh[r1]), 0.f, 0.f, false);
      else
        mma_3xtf32(c, ah, al, wh[r0], wh[r1], wl[r0], wl[r1]);
      add_tile(acc[n], c);
    }
  }
}

// The raw scores of a row that keeps no key, in the C-fragment layout of
// mm_rows_t: acc[j][e] = sum_d a[r, d] w[c, d] as an FMA chain in depth
// order (r = gid, + 8 for e >= 2; c = 8j + 2t, + 1 for odd e), w the chunk's
// wrows rows in device memory, 0 beyond them.  A product's operands commute,
// so the forward (a = q), dkdv (a = k) and dq (a = q) compute the same bits.
template <typename Tin, int NC>
__device__ __forceinline__ void fma_rows_t(const Tin* a, int lda, const Tin* __restrict__ w,
                                           int wrows, int dh, float (&acc)[NC][4]) {
  const int gid = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const Tin* ar = a + (gid + (e & 2 ? 8 : 0)) * lda;
      const int c = 8 * j + 2 * t + (e & 1);
      float x = 0.f;
      if (c < wrows)
        for (int d = 0; d < dh; ++d) x = fmaf(act_f(ar[d]), load_act(w, (size_t)c * dh + d), x);
      acc[j][e] = x;
    }
}

__device__ __forceinline__ float keep_of(const Dropout& dr, unsigned bits) {
  return bits < dr.thresh ? dr.scale : 0.f;
}

// Head h's keep masks m[e] of a C fragment whose rows are queries (i0 =
// row gid, i0 + 8 for e >= 2) and columns keys (col0 + 2t, + 1 for odd e;
// col0 a multiple of 8).  One Philox call a lane: the four keys of group
// (col0 + 2t) / 4 at query i0 (t even) or i0 + 8 (t odd), its partner lane
// (t ^ 1) holding the group's other two keys; each passes the partner the
// two words it needs.
__device__ __forceinline__ void masks_q_rows(const Dropout& dr, int h, int b, int i0, int col0,
                                             float (&m)[4]) {
  const int t = threadIdx.x & 3;
  const bool odd = t & 1;
  const uint4 w = prob_mask_words(dr, h, b, i0 + (odd ? 8 : 0), (col0 + 2 * t) >> 2);
  const unsigned s0 = __shfl_xor_sync(0xffffffffu, odd ? w.x : w.z, 1);
  const unsigned s1 = __shfl_xor_sync(0xffffffffu, odd ? w.y : w.w, 1);
  m[0] = keep_of(dr, odd ? s0 : w.x);
  m[1] = keep_of(dr, odd ? s1 : w.y);
  m[2] = keep_of(dr, odd ? w.z : s0);
  m[3] = keep_of(dr, odd ? w.w : s1);
}

// The same for a C fragment whose rows are keys (j0 + gid, + 8 for e >= 2;
// j0 a multiple of 16) and columns queries (i0 + 2t, + 1 for odd e).  Element
// e is key offset r = gid % 4 of pair e = (query i0 + 2t + e % 2, group
// (j0 + gid) / 4 + 2 (e / 2)), and the four lanes that differ in r alone
// hold the four pairs' other keys: lane r draws pair r, and in round u each
// lane reads pair (r + u) % 4 from its drawer, which sends word (its r - u)
// % 4.
__device__ __forceinline__ void masks_k_rows(const Dropout& dr, int h, int b, int j0, int i0,
                                             float (&m)[4]) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, t = lane & 3, r = gid & 3;
  const uint4 w = prob_mask_words(dr, h, b, i0 + 2 * t + (r & 1),
                                  (j0 >> 2) + (gid >> 2) + 2 * (r >> 1));
  unsigned bits[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int send = (r - u) & 3, p = (r + u) & 3;
    const unsigned v = send == 0 ? w.x : send == 1 ? w.y : send == 2 ? w.z : w.w;
    const unsigned got = __shfl_sync(0xffffffffu, v, (lane & ~12) | (p << 2));
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e == p) bits[e] = got;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) m[e] = keep_of(dr, bits[e]);
}

}  // namespace attn
}  // namespace recblr
