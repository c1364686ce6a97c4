// Top transformer encoder layer backward for Hopper, the layer computed
// at each row's last valid position only: dx [B, T, D] and every weight
// grad.
//
// Replaces the TPU kernel datamining_recblr_tpu/ops/fused_block.py:
// _last_bwd_kernel (reached through _block_last_bwd from the custom VJP
// of fused_transformer_layer_last).  dx is dense: K and V reach every
// position, the query and the residual only the selected one.  A row of
// lens 0 (or above T) selects nothing: its query and residual come from
// zeros, yet it attends uniformly over all T keys at -10000, so its K/V
// gradient is not zero.  It reads the k/v projections and the [B, D]
// context a training forward (fused_block_last.cu) kept, replays the
// Philox masks at each row's query position, and runs
//   T'  the tail backward on the B selected rows (attn_bwd.cuh) -> dxr
//       (the residual part of dx at the query), dctx, the tail grads;
//   A'  per batch row: the query recomputed, per head the [T] scores and
//       probabilities, dpd = dctx_h v_j, ds = p (dp - sum dp p), dq = ds K,
//       dk_j = ds_j q and dv_j = p_j m_j dctx_h written to a [B, T, 2D]
//       scratch; the W_q and b_q grads, and dxr += dq W_q^T;
//   P'  the K/V projection backward over every position (attn_bwd.cuh),
//       with dxr added at lens - 1 -> dx;
// then the reduction of the weight-grad partials in a fixed order.
//
// What bounds it: the K/V projection gradients over all B*T positions
// (4 x 2TD^2 per row: the dk, dv products with W_k, W_v and the two
// weight-grad products) are most of the work, so at the training shape it
// is bound by fp32 operations; the tail and the attention are per row.
// Left for later PRs: tensor cores, and A' with more than one row per
// block sharing each K/V read.
//
// C interface (loaded with ctypes): returns a cudaError_t, 0 on success.
#include "attn_bwd.cuh"

using namespace recblr;

namespace {

inline size_t last_attn_bwd_smem_bytes(int T, int D) {
  return sizeof(float) * (4 * (size_t)D + 2 * (size_t)T);
}

// Item: batch row b (grid-stride).  kv, dkv: [B, T, 2D] fp32; dctx, dxr:
// [B, D] fp32.
template <typename Tin>
__global__ void __launch_bounds__(ATT_THREADS)
last_attn_bwd_kernel(const Tin* __restrict__ x, const int* __restrict__ lens,
                     const float* __restrict__ kv, const float* __restrict__ dctx,
                     BlockParams p, Dropout dra, float* __restrict__ dkv,
                     float* __restrict__ dxr, float* __restrict__ partial, BlockGradLayout gl,
                     int B, int T, int D, int H, float scale) {
  extern __shared__ float smem[];
  constexpr bool RB = IS_BF16<Tin>;
  const int dh = D / H;
  const int ld = 2 * D;
  const int lane = threadIdx.x % 32;
  float* xs = smem;         // [D] the selected input row (0 where none)
  float* qs = xs + D;       // [D] its query
  float* dcs = qs + D;      // [D] dctx
  float* dqs = dcs + D;     // [D] dq
  float* ps = dqs + D;      // [T] one head's probabilities -> p * m
  float* gs = ps + T;       // [T] dpd -> dp -> ds
  float* gp = partial + (size_t)blockIdx.x * gl.total;
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const int n = valid_len(lens[b], T);
    const int qpos = last_pos(lens[b], T);
    const float* kv_b = kv + (size_t)b * T * ld;
    float* dkv_b = dkv + (size_t)b * T * ld;
    __syncthreads();
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
      xs[d] = n > 0 ? load_act(x, ((size_t)b * T + n - 1) * D + d) : 0.f;
      dcs[d] = dctx[(size_t)b * D + d];
    }
    __syncthreads();
    tile_mm<1, false, RB, false>(xs, D, 1, D, p.w_q, D, D, p.b_q, qs, D);
    __syncthreads();
    for (int h = 0; h < H; ++h) {
      // scores and dpd of the row's keys, as the forward computes them
      for (int j = threadIdx.x; j < T; j += blockDim.x) {
        const float* k = kv_b + (size_t)j * ld + h * dh;
        const float* v = k + D;
        float s = 0.f, g = 0.f;
        for (int c = 0; c < dh; ++c) {
          s = fmaf(mm_op<RB>(qs[h * dh + c]), mm_op<RB>(__ldg(k + c)), s);
          g = fmaf(dcs[h * dh + c], mm_op<RB>(__ldg(v + c)), g);
        }
        ps[j] = s;
        gs[j] = g;
      }
      __syncthreads();
      if (threadIdx.x < 32) {
        softmax_row(ps, T, lens[b], 0, 0, scale);
        __syncwarp();
        float acc = 0.f;
        for (int j = lane; j < T; j += 32) {
          const float dp = gs[j] * drop_mask(dra, ATTN_PROB + h, b, qpos, j);
          gs[j] = dp;
          acc += dp * ps[j];
        }
        acc = warp_sum(acc);
        for (int j = lane; j < T; j += 32) {
          gs[j] = ps[j] * (gs[j] - acc) * scale;
          ps[j] *= drop_mask(dra, ATTN_PROB + h, b, qpos, j);
        }
      }
      __syncthreads();
      // dq_h = ds K_h
      for (int c = threadIdx.x; c < dh; c += blockDim.x) {
        float acc = 0.f;
        for (int j = 0; j < T; ++j)
          acc = fmaf(gs[j], mm_op<RB>(__ldg(kv_b + (size_t)j * ld + h * dh + c)), acc);
        dqs[h * dh + c] = acc;
      }
      // dk_j = ds_j q_h, dv_j = (p_j m_j) dctx_h
      for (int i = threadIdx.x; i < T * dh; i += blockDim.x) {
        const int j = i / dh, c = i % dh;
        dkv_b[(size_t)j * ld + h * dh + c] = gs[j] * mm_op<RB>(qs[h * dh + c]);
        dkv_b[(size_t)j * ld + D + h * dh + c] = mm_op<RB>(ps[j]) * dcs[h * dh + c];
      }
      __syncthreads();
    }
    // the query's weight grads and its part of dx at the selected row
    block_grad_matmul<RB, false>(xs, D, dqs, D, 1, D, D, gp + gl.off[BG_W_Q], D);
    block_colsum(dqs, D, nullptr, 0, 1, D, gp + gl.off[BG_B_Q]);
    tile_mm_r<1, true, false, RB, true>(dqs, D, 1, D, p.w_q, D, D, nullptr, dxr + (size_t)b * D,
                                        D);
  }
}

template <typename Tin>
cudaError_t block_last_bwd(const Tin* x, const int* lens, const Tin* dout, BlockParams p,
                           const float* kv, const float* ctx, float* dctx, float* dxr,
                           float* dkv, float* partial, int G, float* grads, Tin* dx, Dropout drh,
                           Dropout dra, int B, int T, int D, int H, int I, int act, float scale,
                           cudaStream_t stream) {
  cudaError_t e;
  const BlockGradLayout gl = block_grad_layout(D, I);

  if ((e = launch_tail_bwd<Tin, ROWS_LAST>(x, lens, ctx, dout, p, drh, dxr, dctx, partial, G, gl,
                                           B, T, D, I, act, nullptr, 0, stream)) != cudaSuccess)
    return e;

  const size_t s2 = last_attn_bwd_smem_bytes(T, D);
  if ((e = set_smem(last_attn_bwd_kernel<Tin>, s2)) != cudaSuccess) return e;
  last_attn_bwd_kernel<Tin><<<min(G, B), ATT_THREADS, s2, stream>>>(
      x, lens, kv, dctx, p, dra, dkv, dxr, partial, gl, B, T, D, H, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  if ((e = launch_proj_bwd<Tin, ROWS_LAST>(x, lens, dkv, dxr, dx, p, partial, G, gl, B * T, T, D,
                                           nullptr, 0, stream)) != cudaSuccess)
    return e;

  reduce_partials_kernel<<<(gl.total + 255) / 256, 256, 0, stream>>>(partial, G, gl.total,
                                                                      grads);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, dx: [B, T, D] fp32 (bf16 == 0) or bf16; dout: [B, D] in x's type;
// lens: [B] int32 non-PAD counts; params: 16 device pointers
// (BlockParams order); kv: [B, T, 2D] and ctx: [B, D] fp32 kept by the
// training forward; dctx, dxr: [B, D] and dkv: [B, T, 2D] fp32 scratch;
// partial: [G, P] fp32 zeros; grads: [P] fp32 out, in BlockParams order;
// act, scale, the two dropouts: the forward's.
int recblr_block_last_bwd(const void* x, const void* lens, const void* dout,
                          const void* const* params, const void* kv, const void* ctx,
                          void* dctx, void* dxr, void* dkv, void* partial, int G, void* grads,
                          void* dx, int B, int T, int D, int H, int I, int act, float scale,
                          int bf16, int drop_h, unsigned long long seed_h, unsigned thresh_h,
                          float scale_h, int drop_a, unsigned long long seed_a,
                          unsigned thresh_a, float scale_a, int device, void* stream) {
  // this library has its own (static) CUDA runtime: select the tensors' card
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const BlockParams p = unpack_block_params(params);
  const Dropout drh = make_dropout(drop_h, seed_h, thresh_h, scale_h);
  const Dropout dra = make_dropout(drop_a, seed_a, thresh_a, scale_a);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* l = static_cast<const int*>(lens);
  const float* k = static_cast<const float*>(kv);
  const float* c = static_cast<const float*>(ctx);
  float* dc = static_cast<float*>(dctx);
  float* dr = static_cast<float*>(dxr);
  float* dk = static_cast<float*>(dkv);
  float* pt = static_cast<float*>(partial);
  float* gr = static_cast<float*>(grads);
  if (bf16)
    return block_last_bwd(static_cast<const __nv_bfloat16*>(x), l,
                          static_cast<const __nv_bfloat16*>(dout), p, k, c, dc, dr, dk, pt, G,
                          gr, static_cast<__nv_bfloat16*>(dx), drh, dra, B, T, D, H, I, act,
                          scale, s);
  return block_last_bwd(static_cast<const float*>(x), l, static_cast<const float*>(dout), p, k,
                        c, dc, dr, dk, pt, G, gr, static_cast<float*>(dx), drh, dra, B, T, D, H,
                        I, act, scale, s);
}

const char* recblr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
