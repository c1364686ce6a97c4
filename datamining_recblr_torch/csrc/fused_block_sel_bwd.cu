// Top bidirectional transformer encoder layer backward for Hopper, the
// layer computed at S selected positions of each row only: dx [B, T, D]
// and every weight grad.
//
// Replaces the TPU kernel datamining_recblr_tpu/ops/fused_block.py:
// _sel_bwd_kernel (reached through _block_sel_bwd from the custom VJP of
// fused_transformer_layer_sel).  dx is dense: K and V reach every position,
// the query and the residual only the selected ones, and where a position
// is selected more than once (BERT4Rec's padded cloze slots all select
// position 0) their cotangents add up.  It reads the k/v projections and
// the [B, S, D] queries and context a training forward (fused_block_sel.cu)
// kept, replays the Philox masks at each selected position, and runs
//   T'  the tail backward on the B*S selected rows (attn_bwd.cuh, ROWS_SEL)
//       -> dxr (the residual part of dx at each selected row), dctx and the
//       tail grads;
//   A'  per (row, head): for each tile of QT selected queries, the [QT, T]
//       scores against every key recomputed and softmaxed as the forward
//       does, dpd = dctx_h v_h^T, ds = p (dp - sum dp p) with dp = dpd m,
//       dq = ds k_h (written), dk += ds^T q_h and dv += (p m)^T dctx_h,
//       summed over the query tiles in shared memory (in the block's own
//       slice of device memory when T dh does not fit) and written once;
//   Q'  per tile of selected rows: the W_q and b_q grads and dxr += dq W_q^T;
//   P'  the K/V projection backward over every position (attn_bwd.cuh,
//       ROWS_SEL): dx = [dk dv] @ [W_k W_v]^T plus, at each position, the
//       sum over s in order of the dxr rows that select it (one writer per
//       element, no atomics);
// then the reduction of the weight-grad partials in a fixed order, so two
// runs give the same bits.
//
// What bounds it: the K/V projection gradients over all B*T positions
// (4 x 2TD^2 per row) and the S-row tail and attention backward (about
// twice their forward's products), all fp32 FMA: at the training shape it
// is bound by fp32 operations.  Left for later PRs: tensor cores, K and V
// staged in shared memory (A' reads them with a stride of 2D floats).
//
// C interface (loaded with ctypes): returns a cudaError_t, 0 on success.
#include "attn_bwd.cuh"

using namespace recblr;

namespace {

inline size_t sel_attn_bwd_smem_bytes(int QT, int T, int dh, bool kv_smem) {
  return sizeof(float) *
         ((size_t)QT * (2 * dh + 2 * T) + (kv_smem ? 2 * (size_t)T * dh : 0));
}

// Block (b, h).  kv, dkv: [B, T, 2D] fp32; q, dctx, dq: [B, S, D] fp32.
template <bool RB>
__global__ void __launch_bounds__(ATT_THREADS)
sel_attn_bwd_kernel(const float* __restrict__ kv, const float* __restrict__ q,
                    const int* __restrict__ lens, const int* __restrict__ sel,
                    const float* __restrict__ dctx, Dropout dra, float* __restrict__ dq,
                    float* __restrict__ dkv, int T, int D, int S, int H, int QT, float scale,
                    int kv_smem) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int dh = D / H;
  const int n = lens[b];
  const int ld = 2 * D;
  const int lane = threadIdx.x % 32;
  const float* kv_b = kv + (size_t)b * T * ld;
  float* dkv_b = dkv + (size_t)b * T * ld;
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
    dk = dkv_b + h * dh;
    dv = dkv_b + D + h * dh;
    ldk = ld;
  }
  for (int i = threadIdx.x; i < T * dh; i += blockDim.x) {
    const int j = i / dh, c = i % dh;
    dk[(size_t)j * ldk + c] = 0.f;
    dv[(size_t)j * ldk + c] = 0.f;
  }
  for (int s0 = 0; s0 < S; s0 += QT) {
    const int rows = min(QT, S - s0);
    const size_t o0 = ((size_t)b * S + s0) * D + h * dh;
    __syncthreads();  // the previous tile's reads are done, the zeros written
    for (int i = threadIdx.x; i < QT * dh; i += blockDim.x) {
      const int r = i / dh, c = i % dh;
      const bool in = r < rows;
      qs[i] = in ? q[o0 + (size_t)r * D + c] : 0.f;
      dcs[i] = in ? dctx[o0 + (size_t)r * D + c] : 0.f;
    }
    __syncthreads();
    // the forward's scores and probabilities
    tile_mm<8, true, RB, false>(qs, dh, rows, dh, kv_b + h * dh, ld, T, nullptr, ps, T);
    // dpd = dctx_h v_h^T
    tile_mm_r<8, true, false, RB, false>(dcs, dh, rows, dh, kv_b + D + h * dh, ld, T, nullptr,
                                         gs, T);
    __syncthreads();
    masked_softmax_rows(ps, T, rows, T, n, 0, 0, scale);
    __syncthreads();
    // ds = p (dp - sum_j dp p) * scale with dp = dpd * m; ps becomes p * m
    for (int r = threadIdx.x / 32; r < rows; r += blockDim.x / 32) {
      const int qpos = sel_pos(sel[(size_t)b * S + s0 + r], T);
      float* pr = ps + (size_t)r * T;
      float* gr = gs + (size_t)r * T;
      float acc = 0.f;
      for (int j = lane; j < T; j += 32) {
        const float dp = gr[j] * drop_mask(dra, ATTN_PROB + h, b, qpos, j);
        gr[j] = dp;
        acc += dp * pr[j];
      }
      acc = warp_sum(acc);
      for (int j = lane; j < T; j += 32) {
        gr[j] = pr[j] * (gr[j] - acc) * scale;
        pr[j] *= drop_mask(dra, ATTN_PROB + h, b, qpos, j);
      }
    }
    __syncthreads();
    // dq = ds k_h
    tile_mm_r<8, false, false, RB, false>(gs, T, rows, T, kv_b + h * dh, ld, dh, nullptr,
                                          dq + o0, D);
    // dk += ds^T q_h; dv += (p m)^T dctx_h
    block_grad_matmul<false, RB>(gs, T, qs, dh, rows, T, dh, dk, ldk);
    block_grad_matmul<RB, false>(ps, T, dcs, dh, rows, T, dh, dv, ldk);
  }
  if (kv_smem) {
    __syncthreads();
    for (int i = threadIdx.x; i < T * dh; i += blockDim.x) {
      const int j = i / dh, c = i % dh;
      dkv_b[(size_t)j * ld + h * dh + c] = dk[i];
      dkv_b[(size_t)j * ld + D + h * dh + c] = dv[i];
    }
  }
}

inline size_t sel_q_bwd_smem_bytes(int D) { return sizeof(float) * 2 * (size_t)TR * D; }

// Q': items of TR of the B*S selected rows.  W_q grad += xq^T dq, b_q grad
// += sum dq, and dxr += dq W_q^T (dxr, dq: [B*S, D] fp32).
template <typename Tin>
__global__ void __launch_bounds__(ATT_THREADS)
sel_q_bwd_kernel(const Tin* __restrict__ x, const int* __restrict__ sel,
                 const float* __restrict__ dq, BlockParams p, float* __restrict__ dxr,
                 float* __restrict__ partial, BlockGradLayout gl, int N, int T, int D, int S) {
  extern __shared__ float smem[];
  constexpr bool RB = IS_BF16<Tin>;
  float* xs = smem;          // [TR, D] the selected input rows
  float* dqs = xs + TR * D;  // [TR, D] their dq
  float* gp = partial + (size_t)blockIdx.x * gl.total;
  for (int n0 = blockIdx.x * TR; n0 < N; n0 += gridDim.x * TR) {
    const int M = min(TR, N - n0);
    __syncthreads();
    for (int i = threadIdx.x; i < TR * D; i += blockDim.x) {
      const int r = i / D, d = i % D;
      float xv = 0.f, gv = 0.f;
      if (r < M) {
        const int bb = (n0 + r) / S;
        xv = load_act(x, ((size_t)bb * T + sel_pos(sel[n0 + r], T)) * D + d);
        gv = dq[(size_t)(n0 + r) * D + d];
      }
      xs[i] = xv;
      dqs[i] = gv;
    }
    __syncthreads();
    block_grad_matmul<RB, false>(xs, D, dqs, D, M, D, D, gp + gl.off[BG_W_Q], D);
    block_colsum(dqs, D, nullptr, 0, M, D, gp + gl.off[BG_B_Q]);
    tile_mm_r<8, true, false, RB, true>(dqs, D, M, D, p.w_q, D, D, nullptr,
                                        dxr + (size_t)n0 * D, D);
  }
}

template <typename Tin>
cudaError_t block_sel_bwd(const Tin* x, const int* lens, const int* sel, const Tin* dout,
                          BlockParams p, const float* kv, const float* q, const float* ctx,
                          float* dctx, float* dxr, float* dq, float* dkv, float* partial, int G,
                          float* grads, Tin* dx, Dropout drh, Dropout dra, int B, int T, int D,
                          int S, int H, int I, int act, float scale, cudaStream_t stream) {
  constexpr bool RB = IS_BF16<Tin>;
  cudaError_t e;
  const BlockGradLayout gl = block_grad_layout(D, I);
  const int NS = B * S;

  const size_t s1 = attn_tail_bwd_smem_bytes(D);
  if ((e = set_smem(attn_tail_bwd_kernel<Tin, ROWS_SEL>, s1)) != cudaSuccess) return e;
  attn_tail_bwd_kernel<Tin, ROWS_SEL><<<min(G, (NS + TR - 1) / TR), ATT_THREADS, s1, stream>>>(
      x, lens, ctx, dout, p, drh, dxr, dctx, partial, gl, NS, T, D, I, act, sel, S);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  // dk and dv in shared memory while two blocks fit an SM (the training
  // shape), else in device memory with a tile that fits
  const int dh = D / H;
  int QT = sel_tile(S);
  const int kv_smem = sel_attn_bwd_smem_bytes(QT, T, dh, true) <= 110 * 1024;
  while (QT > 8 && sel_attn_bwd_smem_bytes(QT, T, dh, kv_smem) > 200 * 1024) QT -= 8;
  const size_t s2 = sel_attn_bwd_smem_bytes(QT, T, dh, kv_smem);
  if ((e = set_smem(sel_attn_bwd_kernel<RB>, s2)) != cudaSuccess) return e;
  sel_attn_bwd_kernel<RB><<<B * H, ATT_THREADS, s2, stream>>>(kv, q, lens, sel, dctx, dra, dq,
                                                              dkv, T, D, S, H, QT, scale,
                                                              kv_smem);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const size_t s3 = sel_q_bwd_smem_bytes(D);
  if ((e = set_smem(sel_q_bwd_kernel<Tin>, s3)) != cudaSuccess) return e;
  sel_q_bwd_kernel<Tin><<<min(G, (NS + TR - 1) / TR), ATT_THREADS, s3, stream>>>(
      x, sel, dq, p, dxr, partial, gl, NS, T, D, S);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const int N = B * T;
  const size_t s4 = proj_bwd_smem_bytes(D, 2);
  if ((e = set_smem(proj_bwd_kernel<Tin, ROWS_SEL>, s4)) != cudaSuccess) return e;
  proj_bwd_kernel<Tin, ROWS_SEL><<<min(G, (N + PR - 1) / PR), ATT_THREADS, s4, stream>>>(
      x, lens, dkv, dxr, dx, p, partial, gl, N, T, D, sel, S);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  reduce_partials_kernel<<<(gl.total + 255) / 256, 256, 0, stream>>>(partial, G, gl.total,
                                                                      grads);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, dx: [B, T, D] fp32 (bf16 == 0) or bf16; lens: [B] int32 non-PAD
// counts; sel: [B, S] int32 selected positions; dout: [B, S, D] in x's
// type; params: 16 device pointers (BlockParams order); kv: [B, T, 2D] and
// q, ctx: [B, S, D] fp32 kept by the training forward; dctx, dxr, dq:
// [B, S, D] and dkv: [B, T, 2D] fp32 scratch; partial: [G, P] fp32 zeros;
// grads: [P] fp32 out, in BlockParams order; act, scale, the two dropouts:
// the forward's.
int recblr_block_sel_bwd(const void* x, const void* lens, const void* sel, const void* dout,
                         const void* const* params, const void* kv, const void* q,
                         const void* ctx, void* dctx, void* dxr, void* dq, void* dkv,
                         void* partial, int G, void* grads, void* dx, int B, int T, int D, int S,
                         int H, int I, int act, float scale, int bf16, int drop_h,
                         unsigned long long seed_h, unsigned thresh_h, float scale_h, int drop_a,
                         unsigned long long seed_a, unsigned thresh_a, float scale_a, int device,
                         void* stream) {
  // this library has its own (static) CUDA runtime: select the tensors' card
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const BlockParams p = unpack_block_params(params);
  const Dropout drh = make_dropout(drop_h, seed_h, thresh_h, scale_h);
  const Dropout dra = make_dropout(drop_a, seed_a, thresh_a, scale_a);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* l = static_cast<const int*>(lens);
  const int* sl = static_cast<const int*>(sel);
  const float* k = static_cast<const float*>(kv);
  const float* qi = static_cast<const float*>(q);
  const float* c = static_cast<const float*>(ctx);
  float* dc = static_cast<float*>(dctx);
  float* dr = static_cast<float*>(dxr);
  float* dqo = static_cast<float*>(dq);
  float* dk = static_cast<float*>(dkv);
  float* pt = static_cast<float*>(partial);
  float* gr = static_cast<float*>(grads);
  if (bf16)
    return block_sel_bwd(static_cast<const __nv_bfloat16*>(x), l, sl,
                         static_cast<const __nv_bfloat16*>(dout), p, k, qi, c, dc, dr, dqo, dk,
                         pt, G, gr, static_cast<__nv_bfloat16*>(dx), drh, dra, B, T, D, S, H, I,
                         act, scale, s);
  return block_sel_bwd(static_cast<const float*>(x), l, sl, static_cast<const float*>(dout), p,
                       k, qi, c, dc, dr, dqo, dk, pt, G, gr, static_cast<float*>(dx), drh, dra,
                       B, T, D, S, H, I, act, scale, s);
}

const char* recblr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
