// Shared device code of the masked-softmax attention kernels
// (attention.cu, attention_bwd.cu): the key range a row visits, the
// score of one (query, key) pair under the additive mask, tile loads.
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
//     probabilities to fp32 rounding.
#pragma once

#include <math.h>

#include "common.cuh"

namespace recblr {
namespace attn {

constexpr int ATTN_THREADS = 256;  // 16 x 16: tx = threadIdx.x % 16, ty = threadIdx.x / 16
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

}  // namespace attn
}  // namespace recblr
