// Top transformer encoder layer forward for Hopper, output at each row's
// last valid position only ([B, D]).
//
// Replaces the TPU kernel datamining_recblr_tpu/ops/fused_block.py:
// _last_fwd_kernel (_block_last_fwd_core; reached through
// _block_last_fwd / fused_transformer_layer_last), dropout included.  The
// query is one row per batch row, chosen by the one-hot `pos == lens-1`
// (lens 0 or above T selects nothing: the query and the residual come
// from zeros), and the keys are masked by padding alone (`col < lens`),
// which on the last row is also the causal mask.  The K and V
// projections over all T positions are most of the work (2 x 2TD^2 of
// ~3.4 MFLOP per row at the serving shape), so the kernel is bound by
// fp32 operations.  The design:
//   A  per (row, 32 positions): x @ [W_k | W_v] + b into a [B, T, 2D]
//      fp32 scratch the wrapper allocates (proj_kernel);
//   B  per LR = 4 batch rows: the selected input row, its query, per
//      head the [1, T] scores against the row's keys, the masked softmax
//      and P.V, then W_o, LN1, the FFN in 256-column chunks and LN2 on
//      the LR rows together, so each weight read serves LR rows.
// Matmuls are fp32 FMA (no tensor cores), so the kernel agrees with the
// plain fp32 version to rounding.  One call is one launch of the wrapper.
// Dropout masks are keyed by each row's query position lens - 1 (0 where
// nothing is selected: attn_common.cuh last_pos), so they are the bits the
// full layer draws at that position.  A training call (ctx != null) also
// writes the [B, D] fp32 context for fused_block_last_bwd.cu.
//
// C interface (loaded with ctypes): returns a cudaError_t, 0 on success.
#include "attn_common.cuh"

using namespace recblr;

namespace {

constexpr int LR = 4;  // batch rows per block of phase B
constexpr int LR16 = 16;  // the rows of the tensor-core tiles, LR padded

// Shared memory of phase B in floats: xs, qs, cs, ys, fs [LR16][ld]; ss
// [LR][T]; as [LR16][la] and, in fp32, al [LR16][la]; ws, where the weights
// are staged.
template <bool RB>
inline size_t last_smem_floats(int T, int D) {
  return (size_t)LR16 * (5 * ld_k<RB>(pad16(D)) + (RB ? 1 : 2) * ld_k<RB>(FC)) +
         (size_t)LR * T + tail_ws_floats<RB>(D);
}

template <typename Tin>
__global__ void __launch_bounds__(ATT_THREADS)
last_attn_tail_kernel(const Tin* __restrict__ x, const int* __restrict__ lens,
                      const float* __restrict__ kv, Tin* __restrict__ out,
                      float* __restrict__ ctx, BlockParams p, Dropout drh, Dropout dra, int B,
                      int T, int D, int H, int I, int act, float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool RB = IS_BF16<Tin>;
  const int b0 = blockIdx.x * LR;
  const int rows = min(LR, B - b0);
  const int dh = D / H, D16 = pad16(D);
  const int ld2 = 2 * D, ld = ld_k<RB>(D16), la = ld_k<RB>(FC);
  float* xs = smem;            // [LR16][ld]  selected input rows (0 where none)
  float* qs = xs + LR16 * ld;  // [LR16][ld]  queries
  float* cs = qs + LR16 * ld;  // [LR16][ld]  attention context, all heads
  float* ys = cs + LR16 * ld;  // [LR16][ld]  W_o output, then r1
  float* fs = ys + LR16 * ld;  // [LR16][ld]  FFN output, then the layer output
  float* ss = fs + LR16 * ld;  // [LR][T]     one head's scores, then probabilities
  float* as = ss + LR * T;     // [LR16][la]  FFN chunk (fp32: hi terms)
  float* al = as + (RB ? 0 : LR16 * la);  // [LR16][la] fp32: its lo terms
  float* ws = al + LR16 * la;  // the staged weights
  auto coord = [&](int r, int& rb, int& rt) {
    rb = b0 + r;
    rt = last_pos(lens[b0 + r], T);
  };

  for (int i = threadIdx.x; i < ws - smem; i += blockDim.x) smem[i] = 0.f;
  __syncthreads();
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    const int n = valid_len(lens[b0 + r], T);
    if (n > 0) xs[r * ld + d] = load_act(x, ((size_t)(b0 + r) * T + n - 1) * D + d);
  }
  stage<false>(ws, ld_n<RB>(D16), p.w_q, D, D, D, D16, pad8(D));
  __syncthreads();
  mma_mm<RB, false, 1, 2>(xs, ld, ws, ld_n<RB>(D16), rows, D, D16, [&](int m, int n, float v) {
    qs[m * ld + n] = v + __ldg(p.b_q + n);
  });
  __syncthreads();
  for (int h = 0; h < H; ++h) {
    // scores of row r: q_r,h . k_j,h of the row's own keys
    for (int i = threadIdx.x; i < rows * T; i += blockDim.x) {
      const int r = i / T, j = i % T;
      const float* k = kv + ((size_t)(b0 + r) * T + j) * ld2 + h * dh;
      const float* q = qs + r * ld + h * dh;
      float acc = 0.f;
      for (int d = 0; d < dh; ++d) acc = fmaf(mm_op<RB>(q[d]), mm_op<RB>(__ldg(k + d)), acc);
      ss[i] = acc;
    }
    __syncthreads();
    {
      const int r = threadIdx.x / 32;  // one warp per row (LR <= the block's warps)
      if (r < rows) softmax_row(ss + r * T, T, lens[b0 + r], 0, 0, scale);
    }
    __syncthreads();
    drop_probs(ss, T, rows, T, dra, h, coord);
    __syncthreads();
    for (int i = threadIdx.x; i < rows * dh; i += blockDim.x) {
      const int r = i / dh, d = i % dh;
      const float* v = kv + (size_t)(b0 + r) * T * ld2 + D + h * dh + d;
      const float* pr = ss + r * T;
      float acc = 0.f;
      for (int j = 0; j < T; ++j) acc = fmaf(mm_op<RB>(pr[j]), mm_op<RB>(__ldg(v + (size_t)j * ld2)), acc);
      cs[r * ld + h * dh + d] = acc;
    }
    __syncthreads();
  }
  if (ctx != nullptr)
    for (int i = threadIdx.x; i < rows * D; i += blockDim.x)
      ctx[(size_t)b0 * D + i] = cs[(i / D) * ld + i % D];
  block_tail<RB>(TailBufs{xs, cs, ys, fs, as, al, ws, ld, la}, rows, D, I, act, p, drh, coord);
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x)
    store_act(out, (size_t)b0 * D + i, fs[(i / D) * ld + i % D]);
}

template <typename Tin>
cudaError_t block_last_fwd(const Tin* x, const int* lens, Tin* out, BlockParams p, float* kv,
                           float* ctx, Dropout drh, Dropout dra, int B, int T, int D, int H,
                           int I, int act, float scale, cudaStream_t stream) {
  ProjParams pp = {{p.w_k, p.w_v, nullptr}, {p.b_k, p.b_v, nullptr}};
  cudaError_t e = launch_proj(x, lens, pp, 2, kv, (long long)B * T, T, D, stream);
  if (e != cudaSuccess) return e;

  const size_t sb = sizeof(float) * last_smem_floats<IS_BF16<Tin>>(T, D);
  e = cudaFuncSetAttribute(last_attn_tail_kernel<Tin>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sb);
  if (e != cudaSuccess) return e;
  last_attn_tail_kernel<Tin><<<(B + LR - 1) / LR, ATT_THREADS, sb, stream>>>(
      x, lens, kv, out, ctx, p, drh, dra, B, T, D, H, I, act, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: [B, T, D] fp32 (bf16 == 0) or bf16; lens: [B] int32 non-PAD counts;
// out: [B, D] in x's type; params: 16 device pointers (BlockParams
// order); kv: [B, T, 2D] fp32 scratch; ctx: [B, D] fp32 context out, or
// null (serving); act: attn_common.cuh act_fwd id; scale: 1 / sqrt(D / H);
// then the hidden and the attention dropout (common.cuh Dropout);
// device: the card that holds them.
int recblr_block_last_fwd(const void* x, const void* lens, void* out,
                          const void* const* params, void* kv, void* ctx, int B, int T, int D,
                          int H, int I, int act, float scale, int bf16, int drop_h,
                          unsigned long long seed_h, unsigned thresh_h, float scale_h,
                          int drop_a, unsigned long long seed_a, unsigned thresh_a,
                          float scale_a, int device, void* stream) {
  // this library has its own (static) CUDA runtime: select the tensors' card
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const BlockParams p = unpack_block_params(params);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* l = static_cast<const int*>(lens);
  float* k = static_cast<float*>(kv);
  float* c = static_cast<float*>(ctx);
  const Dropout drh = make_dropout(drop_h, seed_h, thresh_h, scale_h);
  const Dropout dra = make_dropout(drop_a, seed_a, thresh_a, scale_a);
  if (bf16)
    return block_last_fwd(static_cast<const __nv_bfloat16*>(x), l,
                          static_cast<__nv_bfloat16*>(out), p, k, c, drh, dra, B, T, D, H, I,
                          act, scale, s);
  return block_last_fwd(static_cast<const float*>(x), l, static_cast<float*>(out), p, k, c, drh,
                        dra, B, T, D, H, I, act, scale, s);
}

const char* recblr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
