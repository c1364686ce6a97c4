// Whole post-LN transformer encoder layer backward for Hopper, causal or
// bidirectional: dx and every weight grad.
//
// Replaces the TPU kernel datamining_recblr_tpu/ops/fused_block.py:
// _bwd_kernel (reached through _block_bwd from the custom VJP of
// fused_transformer_layer), with its math: the softmax backward uses the
// undropped probabilities, ds = p (dp - sum_j dp p) with dp = dpd * m.
// It reads the q/k/v projections and the context that a training forward
// (fused_block.cu) kept, replays the Philox masks, and runs
//   T'  the tail backward (attn_bwd.cuh) -> dxr, dctx and the tail grads;
//   A'  per (row, head): for each tile of QT queries, the [QT, T] scores
//       against every key recomputed and softmaxed as the forward does,
//       dpd = dctx_h v_h^T, ds, then dq = ds k (written), dk += ds^T q and
//       dv += (p m)^T dctx_h, summed over the query tiles in shared memory
//       (in the block's own slice of device memory when T dh does not fit)
//       and written once: every element has one writer, no atomics;
//   P'  the projection backward (attn_bwd.cuh) -> dx and the Q/K/V grads;
// then the reduction of the weight-grad partials in a fixed order.
//
// What bounds it: the backward recomputes the tail forward and has two
// gradient products for every forward product, about twice the forward's
// fp32 FMA work (QK^T and P.V three times), so at the training shape
// (B 2,048, T 200, D 64, 2 heads, FFN 256) it is bound by fp32 operations.
// The design keeps every product's operands in shared memory or the
// read-only cache and moves only dctx, dxr and dq/dk/dv [B, T, .] fp32
// through device memory between phases.  Left for later PRs: tensor cores
// (wgmma) for the products, K and V staged in shared memory (A' reads
// them with a stride of 3D floats), and one fused pass over T' and A'.
//
// C interface (loaded with ctypes): returns a cudaError_t, 0 on success.
#include "attn_bwd.cuh"

using namespace recblr;

namespace {

inline size_t attn_bwd_smem_bytes(int QT, int T, int dh, bool kv_smem) {
  return sizeof(float) *
         ((size_t)QT * (2 * dh + 2 * T + 1) + (kv_smem ? 2 * (size_t)T * dh : 0));
}

// Block (b, h).  qkv, dqkv: [B, T, 3D] fp32; dctx: [B, T, D] fp32.
template <bool RB>
__global__ void __launch_bounds__(ATT_THREADS)
attn_bwd_kernel(const float* __restrict__ qkv, const int* __restrict__ lens,
                const float* __restrict__ dctx, Dropout dra, float* __restrict__ dqkv, int T,
                int D, int H, int QT, int causal, float scale, int kv_smem) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int dh = D / H;
  const int n = lens[b];
  const int ld = 3 * D;
  const int lane = threadIdx.x % 32;
  const float* qkv_b = qkv + (size_t)b * T * ld;
  float* dqkv_b = dqkv + (size_t)b * T * ld;
  float* qs = smem;            // [QT, dh] queries of the tile
  float* dcs = qs + QT * dh;   // [QT, dh] their dctx
  float* ps = dcs + QT * dh;   // [QT, T]  probabilities -> p * m
  float* gs = ps + QT * T;     // [QT, T]  dpd -> dp -> ds
  float* dk;                   // [T, dh]  dk, dv accumulators (row stride ldk)
  float* dv;
  int ldk;
  if (kv_smem) {
    dk = gs + QT * T;
    dv = dk + T * dh;
    ldk = dh;
  } else {
    dk = dqkv_b + D + h * dh;
    dv = dqkv_b + 2 * D + h * dh;
    ldk = ld;
  }
  for (int i = threadIdx.x; i < T * dh; i += blockDim.x) {
    const int j = i / dh, c = i % dh;
    dk[(size_t)j * ldk + c] = 0.f;
    dv[(size_t)j * ldk + c] = 0.f;
  }
  for (int i0 = 0; i0 < T; i0 += QT) {
    const int rows = min(QT, T - i0);
    __syncthreads();  // the previous tile's reads are done, the zeros written
    for (int i = threadIdx.x; i < QT * dh; i += blockDim.x) {
      const int r = i / dh, c = i % dh;
      const bool in = r < rows;
      qs[i] = in ? qkv_b[(size_t)(i0 + r) * ld + h * dh + c] : 0.f;
      dcs[i] = in ? dctx[((size_t)b * T + i0 + r) * D + h * dh + c] : 0.f;
    }
    __syncthreads();
    // the forward's scores and probabilities
    tile_mm<8, true, RB, false>(qs, dh, rows, dh, qkv_b + D + h * dh, ld, T, nullptr, ps, T);
    // dpd = dctx_h v_h^T
    tile_mm_r<8, true, false, RB, false>(dcs, dh, rows, dh, qkv_b + 2 * D + h * dh, ld, T,
                                         nullptr, gs, T);
    __syncthreads();
    masked_softmax_rows(ps, T, rows, T, n, causal, i0, scale);
    __syncthreads();
    // ds = p (dp - sum_j dp p) * scale with dp = dpd * m; ps becomes p * m
    for (int r = threadIdx.x / 32; r < rows; r += blockDim.x / 32) {
      float* pr = ps + (size_t)r * T;
      float* gr = gs + (size_t)r * T;
      float acc = 0.f;
      for (int j = lane; j < T; j += 32) {
        const float dp = gr[j] * drop_mask(dra, ATTN_PROB + h, b, i0 + r, j);
        gr[j] = dp;
        acc += dp * pr[j];
      }
      acc = warp_sum(acc);
      for (int j = lane; j < T; j += 32) {
        gr[j] = pr[j] * (gr[j] - acc) * scale;
        pr[j] *= drop_mask(dra, ATTN_PROB + h, b, i0 + r, j);
      }
    }
    __syncthreads();
    // dq = ds k_h
    tile_mm_r<8, false, false, RB, false>(gs, T, rows, T, qkv_b + D + h * dh, ld, dh, nullptr,
                                          dqkv_b + (size_t)i0 * ld + h * dh, ld);
    // dk += ds^T q_h; dv += (p m)^T dctx_h
    block_grad_matmul<false, RB>(gs, T, qs, dh, rows, T, dh, dk, ldk);
    block_grad_matmul<RB, false>(ps, T, dcs, dh, rows, T, dh, dv, ldk);
  }
  if (kv_smem) {
    __syncthreads();
    for (int i = threadIdx.x; i < T * dh; i += blockDim.x) {
      const int j = i / dh, c = i % dh;
      dqkv_b[(size_t)j * ld + D + h * dh + c] = dk[i];
      dqkv_b[(size_t)j * ld + 2 * D + h * dh + c] = dv[i];
    }
  }
}

template <typename Tin>
cudaError_t block_bwd(const Tin* x, const int* lens, const Tin* dout, BlockParams p,
                      const float* qkv, const float* ctx, float* dctx, float* dxr, float* dqkv,
                      float* partial, int G, float* grads, Tin* dx, Dropout drh, Dropout dra,
                      int B, int T, int D, int H, int I, int causal, int act, float scale,
                      cudaStream_t stream) {
  constexpr bool RB = IS_BF16<Tin>;
  cudaError_t e;
  const BlockGradLayout gl = block_grad_layout(D, I);
  const int N = B * T;

  const size_t s1 = attn_tail_bwd_smem_bytes(D);
  if ((e = set_smem(attn_tail_bwd_kernel<Tin, ROWS_ALL>, s1)) != cudaSuccess) return e;
  attn_tail_bwd_kernel<Tin, ROWS_ALL><<<min(G, (N + TR - 1) / TR), ATT_THREADS, s1, stream>>>(
      x, nullptr, ctx, dout, p, drh, dxr, dctx, partial, gl, N, T, D, I, act, nullptr, 0);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  // the query tile: dk and dv in shared memory while two blocks fit an
  // SM (the training shape), else in device memory with a tile that fits
  const int dh = D / H;
  int QT = 32;
  const int kv_smem = attn_bwd_smem_bytes(QT, T, dh, true) <= 110 * 1024;
  while (QT > 8 && attn_bwd_smem_bytes(QT, T, dh, kv_smem) > 200 * 1024) QT /= 2;
  const size_t s2 = attn_bwd_smem_bytes(QT, T, dh, kv_smem);
  if ((e = set_smem(attn_bwd_kernel<RB>, s2)) != cudaSuccess) return e;
  attn_bwd_kernel<RB><<<B * H, ATT_THREADS, s2, stream>>>(qkv, lens, dctx, dra, dqkv, T, D, H,
                                                          QT, causal, scale, kv_smem);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const size_t s3 = proj_bwd_smem_bytes(D, 3);
  if ((e = set_smem(proj_bwd_kernel<Tin, ROWS_ALL>, s3)) != cudaSuccess) return e;
  proj_bwd_kernel<Tin, ROWS_ALL><<<min(G, (N + PR - 1) / PR), ATT_THREADS, s3, stream>>>(
      x, nullptr, dqkv, dxr, dx, p, partial, gl, N, T, D, nullptr, 0);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  reduce_partials_kernel<<<(gl.total + 255) / 256, 256, 0, stream>>>(partial, G, gl.total,
                                                                      grads);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, dout, dx: [B, T, D] fp32 (bf16 == 0) or bf16; lens: [B] int32
// non-PAD counts; params: 16 device pointers (BlockParams order); qkv:
// [B, T, 3D] and ctx: [B, T, D] fp32 kept by the training forward; dctx,
// dxr: [B, T, D] and dqkv: [B, T, 3D] fp32 scratch; partial: [G, P] fp32
// zeros (P floats of BlockGradLayout); grads: [P] fp32 out, in
// BlockParams order; act, scale, the two dropouts: the forward's.
int recblr_block_bwd(const void* x, const void* lens, const void* dout,
                     const void* const* params, const void* qkv, const void* ctx, void* dctx,
                     void* dxr, void* dqkv, void* partial, int G, void* grads, void* dx, int B,
                     int T, int D, int H, int I, int causal, int act, float scale, int bf16,
                     int drop_h, unsigned long long seed_h, unsigned thresh_h, float scale_h,
                     int drop_a, unsigned long long seed_a, unsigned thresh_a, float scale_a,
                     int device, void* stream) {
  // this library has its own (static) CUDA runtime: select the tensors' card
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const BlockParams p = unpack_block_params(params);
  const Dropout drh = make_dropout(drop_h, seed_h, thresh_h, scale_h);
  const Dropout dra = make_dropout(drop_a, seed_a, thresh_a, scale_a);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* l = static_cast<const int*>(lens);
  const float* q = static_cast<const float*>(qkv);
  const float* c = static_cast<const float*>(ctx);
  float* dc = static_cast<float*>(dctx);
  float* dr = static_cast<float*>(dxr);
  float* dq = static_cast<float*>(dqkv);
  float* pt = static_cast<float*>(partial);
  float* gr = static_cast<float*>(grads);
  if (bf16)
    return block_bwd(static_cast<const __nv_bfloat16*>(x), l,
                     static_cast<const __nv_bfloat16*>(dout), p, q, c, dc, dr, dq, pt, G, gr,
                     static_cast<__nv_bfloat16*>(dx), drh, dra, B, T, D, H, I, causal, act,
                     scale, s);
  return block_bwd(static_cast<const float*>(x), l, static_cast<const float*>(dout), p, q, c, dc,
                   dr, dq, pt, G, gr, static_cast<float*>(dx), drh, dra, B, T, D, H, I, causal,
                   act, scale, s);
}

const char* recblr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
