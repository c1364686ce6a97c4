// Whole post-LN transformer encoder layer forward for Hopper, causal or
// bidirectional.
//
// Replaces the TPU kernel datamining_recblr_tpu/ops/fused_block.py:
// _fwd_kernel (_block_fwd_core; reached through _block_fwd /
// fused_transformer_layer), dropout included.  At the serving shape (D 64,
// 2 heads of 32, FFN 256, T 200) one row costs 2T(4D^2 + 2TD + 2DI)
// ~ 29.9 MFLOP of fp32 matmul against 2TD x 4 bytes of activation
// traffic, so the layer is bound by fp32 operations.  The TPU kernel
// keeps a 16-row block's [T, T] scores per head and every weight in
// VMEM; on Hopper one head's [200, 200] fp32 scores (160 KB) and the
// fp32 weights (192 KB) do not fit in 227 KB of shared memory together.
// So the design runs in two phases:
//   A  per (row, 32 positions): x @ [W_q | W_k | W_v] + b into a
//      [B, T, 3D] fp32 scratch the wrapper allocates (proj_kernel);
//   B  per (row, query tile of QT positions): for each head the [QT, T]
//      scores against all T keys, read from the scratch, the masked
//      softmax and P.V into a [QT, D] context; then W_o, the LN1
//      residual, the FFN with W1 / W2 streamed in chunks of 256 columns,
//      and the LN2 residual.  QT is 32 (16 or 8 when T is long) so that
//      a block's shared memory, QT (5D + T + 256) floats, stays below
//      200 KB and at T = 200 two blocks fit on an SM.
// Matmuls are fp32 FMA from shared memory with the weights through the
// read-only cache (no tensor cores), so the kernel agrees with the plain
// fp32 version to rounding.  One call is one launch of the wrapper.
// Dropout (attn_common.cuh): each head's probabilities are masked after
// the softmax, before P.V; the tail masks the W_o and the FFN outputs.
// A training call (ctx != null) also writes the [B, T, D] fp32 context
// for fused_block_bwd.cu, which reads it and the q/k/v scratch.
//
// C interface (loaded with ctypes): returns a cudaError_t, 0 on success.
#include "attn_common.cuh"

using namespace recblr;

namespace {

inline size_t attn_smem_bytes(int QT, int T, int D) {
  return sizeof(float) * (size_t)QT * (5 * D + T + FC);
}

template <typename Tin>
__global__ void __launch_bounds__(ATT_THREADS)
attn_tail_kernel(const Tin* __restrict__ x, const int* __restrict__ lens,
                 const float* __restrict__ qkv, Tin* __restrict__ out, float* __restrict__ ctx,
                 BlockParams p, Dropout drh, Dropout dra, int T, int D, int H, int I, int QT,
                 int causal, int act, float scale) {
  extern __shared__ float smem[];
  constexpr bool RB = IS_BF16<Tin>;
  const int b = blockIdx.x;
  const int t0 = blockIdx.y * QT;
  const int rows = min(QT, T - t0);
  const int dh = D / H;
  const int n = lens[b];
  const int ld = 3 * D;
  const float* qkv_b = qkv + (size_t)b * T * ld;
  float* xs = smem;           // [QT, D]  layer input rows t0..
  float* qs = xs + QT * D;    // [QT, D]  queries
  float* cs = qs + QT * D;    // [QT, D]  attention context, all heads
  float* ys = cs + QT * D;    // [QT, D]  W_o output, then r1
  float* fs = ys + QT * D;    // [QT, D]  FFN output, then the layer output
  float* ss = fs + QT * D;    // [QT, T]  one head's scores, then probabilities
  float* as = ss + QT * T;    // [QT, FC] FFN chunk
  auto coord = [&](int r, int& rb, int& rt) {
    rb = b;
    rt = t0 + r;
  };

  for (int i = threadIdx.x; i < QT * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    const bool in = r < rows;
    xs[i] = in ? load_act(x, ((size_t)b * T + t0) * D + i) : 0.f;
    qs[i] = in ? qkv_b[(size_t)(t0 + r) * ld + d] : 0.f;
  }
  __syncthreads();
  for (int h = 0; h < H; ++h) {
    // scores: q_h k_h^T over all T keys
    tile_mm<8, true, RB, false>(qs + h * dh, D, rows, dh, qkv_b + D + h * dh, ld, T, nullptr,
                                ss, T);
    __syncthreads();
    masked_softmax_rows(ss, T, rows, T, n, causal, t0, scale);
    __syncthreads();
    drop_probs(ss, T, rows, T, dra, h, coord);
    __syncthreads();
    // context: p_h v_h
    tile_mm<8, false, RB, false>(ss, T, rows, T, qkv_b + 2 * D + h * dh, ld, dh, nullptr,
                                 cs + h * dh, D);
    __syncthreads();
  }
  if (ctx != nullptr)
    for (int i = threadIdx.x; i < rows * D; i += blockDim.x)
      ctx[((size_t)b * T + t0) * D + i] = cs[i];
  block_tail<8, RB>(cs, xs, ys, as, fs, rows, D, I, act, p, drh, coord);
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x)
    store_act(out, ((size_t)b * T + t0) * D + i, fs[i]);
}

template <typename Tin>
cudaError_t block_fwd(const Tin* x, const int* lens, Tin* out, BlockParams p, float* qkv,
                      float* ctx, Dropout drh, Dropout dra, int B, int T, int D, int H, int I,
                      int causal, int act, float scale, cudaStream_t stream) {
  const size_t sa = proj_smem_bytes(D);
  ProjParams pp = {{p.w_q, p.w_k, p.w_v}, {p.b_q, p.b_k, p.b_v}};
  proj_kernel<Tin><<<dim3(B, (T + PROJ_ROWS - 1) / PROJ_ROWS), ATT_THREADS, sa, stream>>>(
      x, pp, 3, qkv, T, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  int QT = 32;
  while (QT > 8 && attn_smem_bytes(QT, T, D) > 200 * 1024) QT /= 2;
  const size_t sb = attn_smem_bytes(QT, T, D);
  e = cudaFuncSetAttribute(attn_tail_kernel<Tin>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)sb);
  if (e != cudaSuccess) return e;
  attn_tail_kernel<Tin><<<dim3(B, (T + QT - 1) / QT), ATT_THREADS, sb, stream>>>(
      x, lens, qkv, out, ctx, p, drh, dra, T, D, H, I, QT, causal, act, scale);
  return cudaGetLastError();
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
