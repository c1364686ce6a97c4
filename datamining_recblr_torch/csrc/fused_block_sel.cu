// Top bidirectional transformer encoder layer forward for Hopper, output at
// S selected positions of each row only ([B, S, D]): BERT4Rec's cloze
// positions.
//
// Replaces the TPU kernel datamining_recblr_tpu/ops/fused_block.py:
// _sel_fwd_kernel (_block_sel_fwd_core; reached through _block_sel_fwd /
// fused_transformer_layer_sel), dropout included.  Queries exist only at
// the positions sel[b, s] (repeats allowed: a repeated position computes
// the same row twice); keys and values span all T, masked by padding alone
// (`col < lens`, -10000), which is the bidirectional mask of any query.
// The TPU kernel selects with one-hot matmuls (Mosaic has no in-kernel
// gather); here a block reads its query rows by index.  At the training
// shape (D 64, 2 heads, FFN 256, T 200, S 40) the K and V projections over
// every position are about half the work (4TD^2 per row) and the S-query
// attention, W_o and FFN the rest, so the kernel is bound by operations.
// The design follows fused_block.cu:
//   A  per 128 positions of [B * T]: x @ [W_k | W_v] + b into a [B, T, 2D]
//      fp32 scratch the wrapper allocates (attn_common.cuh proj_kernel, on
//      the tensor cores);
//   B  per (row, tile of QT selected queries): the gathered input rows and
//      their queries (W_q on the tensor cores), per head the [QT, T] scores
//      against every key, the masked softmax and P.V (fp32 FMA, the keys
//      read from the scratch), then W_o, LN1, the FFN and LN2
//      (attn_common.cuh block_tail, on the tensor cores).  QT splits S into
//      the fewest tiles of at most 32 rows (S 40: two tiles of 24 and 16).
// Dropout masks are keyed by the selected position (attn_common.cuh
// sel_pos): the bits the full layer draws there, so this layer followed by
// nothing equals the full layer followed by a gather.  A training call
// (q, ctx != null) also writes the [B, S, D] fp32 queries and context for
// fused_block_sel_bwd.cu.  One call is one launch of the wrapper.
//
// C interface (loaded with ctypes): returns a cudaError_t, 0 on success.
#include "attn_common.cuh"

using namespace recblr;

namespace {

// Shared memory of phase B in floats for QT queries (Q16 = pad16(QT)
// rows for the tensor-core tiles): xs, qs, cs, ys [Q16][ld]; ss [QT][T],
// which the tail's as [Q16][la] (with al in fp32) reuses; fs in qs's place;
// ws, where the weights are staged.
template <bool RB>
inline size_t sel_smem_floats(int QT, int T, int D) {
  const size_t q16 = pad16(QT), as = (RB ? 1 : 2) * q16 * ld_k<RB>(FC), ss = (size_t)QT * T;
  return q16 * 4 * ld_k<RB>(pad16(D)) + (as > ss ? as : ss) + tail_ws_floats<RB>(D);
}

template <typename Tin>
__global__ void __launch_bounds__(ATT_THREADS)
sel_attn_tail_kernel(const Tin* __restrict__ x, const int* __restrict__ lens,
                     const int* __restrict__ sel, const float* __restrict__ kv,
                     Tin* __restrict__ out, float* __restrict__ q_out, float* __restrict__ ctx,
                     BlockParams p, Dropout drh, Dropout dra, int T, int D, int S, int H, int I,
                     int QT, int act, float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool RB = IS_BF16<Tin>;
  const int b = blockIdx.x;
  const int s0 = blockIdx.y * QT;
  const int rows = min(QT, S - s0);
  const int dh = D / H, D16 = pad16(D), Q16 = pad16(QT);
  const int n = lens[b];
  const int ld2 = 2 * D, ld = ld_k<RB>(D16), la = ld_k<RB>(FC);
  const float* kv_b = kv + (size_t)b * T * ld2;
  const int* sel_b = sel + (size_t)b * S + s0;
  const size_t o0 = ((size_t)b * S + s0) * D;  // the tile's first [B, S, D] element
  const int sa = max((RB ? 1 : 2) * Q16 * la, QT * T);
  float* xs = smem;           // [Q16][ld]  selected input rows
  float* qs = xs + Q16 * ld;  // [Q16][ld]  queries; then fs, the FFN output and layer output
  float* cs = qs + Q16 * ld;  // [Q16][ld]  attention context, all heads
  float* ys = cs + Q16 * ld;  // [Q16][ld]  W_o output, then r1
  float* ss = ys + Q16 * ld;  // [QT][T]    one head's scores, then probabilities
  float* as = ss;             // [Q16][la]  FFN chunk (the tail; fp32: hi terms)
  float* al = as + (RB ? 0 : Q16 * la);  // [Q16][la] fp32: its lo terms
  float* ws = ss + sa;        // the staged weights
  float* fs = qs;
  auto coord = [&](int r, int& rb, int& rt) {
    rb = b;
    rt = sel_pos(sel_b[r], T);
  };

  for (int i = threadIdx.x; i < ws - smem; i += blockDim.x) smem[i] = 0.f;
  __syncthreads();
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    xs[r * ld + d] = load_act(x, ((size_t)b * T + sel_pos(sel_b[r], T)) * D + d);
  }
  stage<false>(ws, ld_n<RB>(D16), p.w_q, D, D, D, D16, pad8(D));
  __syncthreads();
  mma_mm<RB, false, 2, 1>(xs, ld, ws, ld_n<RB>(D16), rows, D, D16, [&](int m, int j, float v) {
    qs[m * ld + j] = v + __ldg(p.b_q + j);
  });
  __syncthreads();
  if (q_out != nullptr)
    for (int i = threadIdx.x; i < rows * D; i += blockDim.x) q_out[o0 + i] = qs[(i / D) * ld + i % D];
  for (int h = 0; h < H; ++h) {
    // scores: q_h k_h^T over all T keys
    tile_mm<8, true, RB, false>(qs + h * dh, ld, rows, dh, kv_b + h * dh, ld2, T, nullptr, ss, T);
    __syncthreads();
    masked_softmax_rows(ss, T, rows, T, n, 0, 0, scale);
    __syncthreads();
    drop_probs(ss, T, rows, T, dra, h, coord);
    __syncthreads();
    // context: p_h v_h
    tile_mm<8, false, RB, false>(ss, T, rows, T, kv_b + D + h * dh, ld2, dh, nullptr,
                                 cs + h * dh, ld);
    __syncthreads();
  }
  if (ctx != nullptr)
    for (int i = threadIdx.x; i < rows * D; i += blockDim.x) ctx[o0 + i] = cs[(i / D) * ld + i % D];
  block_tail<RB>(TailBufs{xs, cs, ys, fs, as, al, ws, ld, la}, rows, D, I, act, p, drh, coord);
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x)
    store_act(out, o0 + i, fs[(i / D) * ld + i % D]);
}

template <typename Tin>
cudaError_t block_sel_fwd(const Tin* x, const int* lens, const int* sel, Tin* out,
                          BlockParams p, float* kv, float* q, float* ctx, Dropout drh,
                          Dropout dra, int B, int T, int D, int S, int H, int I, int act,
                          float scale, cudaStream_t stream) {
  constexpr bool RB = IS_BF16<Tin>;
  ProjParams pp = {{p.w_k, p.w_v, nullptr}, {p.b_k, p.b_v, nullptr}};
  cudaError_t e = launch_proj(x, lens, pp, 2, kv, (long long)B * T, T, D, stream);
  if (e != cudaSuccess) return e;

  int QT = sel_tile(S);
  while (QT > 8 && sizeof(float) * sel_smem_floats<RB>(QT, T, D) > 200 * 1024) QT -= 8;
  const size_t sb = sizeof(float) * sel_smem_floats<RB>(QT, T, D);
  e = cudaFuncSetAttribute(sel_attn_tail_kernel<Tin>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sb);
  if (e != cudaSuccess) return e;
  sel_attn_tail_kernel<Tin><<<dim3(B, (S + QT - 1) / QT), ATT_THREADS, sb, stream>>>(
      x, lens, sel, kv, out, q, ctx, p, drh, dra, T, D, S, H, I, QT, act, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: [B, T, D] fp32 (bf16 == 0) or bf16; lens: [B] int32 non-PAD counts;
// sel: [B, S] int32 selected positions (clamped into [0, T - 1]); out:
// [B, S, D] in x's type; params: 16 device pointers (BlockParams order);
// kv: [B, T, 2D] fp32 scratch; q, ctx: [B, S, D] fp32 out, or null
// (inference); act: attn_common.cuh act_fwd id; scale: 1 / sqrt(D / H);
// then the hidden and the attention dropout (common.cuh Dropout); device:
// the card that holds them.
int recblr_block_sel_fwd(const void* x, const void* lens, const void* sel, void* out,
                         const void* const* params, void* kv, void* q, void* ctx, int B, int T,
                         int D, int S, int H, int I, int act, float scale, int bf16, int drop_h,
                         unsigned long long seed_h, unsigned thresh_h, float scale_h, int drop_a,
                         unsigned long long seed_a, unsigned thresh_a, float scale_a, int device,
                         void* stream) {
  // this library has its own (static) CUDA runtime: select the tensors' card
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const BlockParams p = unpack_block_params(params);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* l = static_cast<const int*>(lens);
  const int* sl = static_cast<const int*>(sel);
  float* k = static_cast<float*>(kv);
  float* qo = static_cast<float*>(q);
  float* c = static_cast<float*>(ctx);
  const Dropout drh = make_dropout(drop_h, seed_h, thresh_h, scale_h);
  const Dropout dra = make_dropout(drop_a, seed_a, thresh_a, scale_a);
  if (bf16)
    return block_sel_fwd(static_cast<const __nv_bfloat16*>(x), l, sl,
                         static_cast<__nv_bfloat16*>(out), p, k, qo, c, drh, dra, B, T, D, S, H,
                         I, act, scale, s);
  return block_sel_fwd(static_cast<const float*>(x), l, sl, static_cast<float*>(out), p, k, qo,
                       c, drh, dra, B, T, D, S, H, I, act, scale, s);
}

const char* recblr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
