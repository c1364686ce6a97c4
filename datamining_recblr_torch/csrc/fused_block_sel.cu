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
// attention, W_o and FFN the rest, all fp32 FMA, so the kernel is bound by
// fp32 operations.  The design follows fused_block.cu:
//   A  per (row, 32 positions): x @ [W_k | W_v] + b into a [B, T, 2D] fp32
//      scratch the wrapper allocates (proj_kernel);
//   B  per (row, tile of QT selected queries): the gathered input rows and
//      their queries, per head the [QT, T] scores against every key, the
//      masked softmax and P.V, then W_o, LN1, the FFN in 256-column chunks
//      and LN2 (block_tail).  QT splits S into the fewest tiles of at most
//      32 rows (S 40: two tiles of 24 and 16).
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

inline size_t sel_smem_bytes(int QT, int T, int D) {
  return sizeof(float) * (size_t)QT * (5 * D + T + FC);
}

template <typename Tin>
__global__ void __launch_bounds__(ATT_THREADS)
sel_attn_tail_kernel(const Tin* __restrict__ x, const int* __restrict__ lens,
                     const int* __restrict__ sel, const float* __restrict__ kv,
                     Tin* __restrict__ out, float* __restrict__ q_out, float* __restrict__ ctx,
                     BlockParams p, Dropout drh, Dropout dra, int T, int D, int S, int H, int I,
                     int QT, int act, float scale) {
  extern __shared__ float smem[];
  constexpr bool RB = IS_BF16<Tin>;
  const int b = blockIdx.x;
  const int s0 = blockIdx.y * QT;
  const int rows = min(QT, S - s0);
  const int dh = D / H;
  const int n = lens[b];
  const int ld = 2 * D;
  const float* kv_b = kv + (size_t)b * T * ld;
  const int* sel_b = sel + (size_t)b * S + s0;
  const size_t o0 = ((size_t)b * S + s0) * D;  // the tile's first [B, S, D] element
  float* xs = smem;           // [QT, D]  selected input rows
  float* qs = xs + QT * D;    // [QT, D]  queries
  float* cs = qs + QT * D;    // [QT, D]  attention context, all heads
  float* ys = cs + QT * D;    // [QT, D]  W_o output, then r1
  float* fs = ys + QT * D;    // [QT, D]  FFN output, then the layer output
  float* ss = fs + QT * D;    // [QT, T]  one head's scores, then probabilities
  float* as = ss + QT * T;    // [QT, FC] FFN chunk
  auto coord = [&](int r, int& rb, int& rt) {
    rb = b;
    rt = sel_pos(sel_b[r], T);
  };

  for (int i = threadIdx.x; i < QT * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    xs[i] = r < rows ? load_act(x, ((size_t)b * T + sel_pos(sel_b[r], T)) * D + d) : 0.f;
  }
  __syncthreads();
  tile_mm<8, false, RB, false>(xs, D, rows, D, p.w_q, D, D, p.b_q, qs, D);
  __syncthreads();
  if (q_out != nullptr)
    for (int i = threadIdx.x; i < rows * D; i += blockDim.x) q_out[o0 + i] = qs[i];
  for (int h = 0; h < H; ++h) {
    // scores: q_h k_h^T over all T keys
    tile_mm<8, true, RB, false>(qs + h * dh, D, rows, dh, kv_b + h * dh, ld, T, nullptr, ss, T);
    __syncthreads();
    masked_softmax_rows(ss, T, rows, T, n, 0, 0, scale);
    __syncthreads();
    drop_probs(ss, T, rows, T, dra, h, coord);
    __syncthreads();
    // context: p_h v_h
    tile_mm<8, false, RB, false>(ss, T, rows, T, kv_b + D + h * dh, ld, dh, nullptr,
                                 cs + h * dh, D);
    __syncthreads();
  }
  if (ctx != nullptr)
    for (int i = threadIdx.x; i < rows * D; i += blockDim.x) ctx[o0 + i] = cs[i];
  block_tail<8, RB>(cs, xs, ys, as, fs, rows, D, I, act, p, drh, coord);
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) store_act(out, o0 + i, fs[i]);
}

template <typename Tin>
cudaError_t block_sel_fwd(const Tin* x, const int* lens, const int* sel, Tin* out,
                          BlockParams p, float* kv, float* q, float* ctx, Dropout drh,
                          Dropout dra, int B, int T, int D, int S, int H, int I, int act,
                          float scale, cudaStream_t stream) {
  const size_t sa = proj_smem_bytes(D);
  ProjParams pp = {{p.w_k, p.w_v, nullptr}, {p.b_k, p.b_v, nullptr}};
  proj_kernel<Tin><<<dim3(B, (T + PROJ_ROWS - 1) / PROJ_ROWS), ATT_THREADS, sa, stream>>>(
      x, pp, 2, kv, T, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  int QT = sel_tile(S);
  while (QT > 8 && sel_smem_bytes(QT, T, D) > 200 * 1024) QT -= 8;
  const size_t sb = sel_smem_bytes(QT, T, D);
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
