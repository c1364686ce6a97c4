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
//   A'  per (row, head): for each tile of 32 queries, the scores and dpd
//       against the keys the tile can weigh, the softmax as the forward
//       computes it, ds, then dq = ds k (written), dk += ds^T q and
//       dv += (p m)^T dctx_h, summed over the query tiles in shared memory
//       (in the block's own rows of dqkv when T dh does not fit) and
//       written once: every element has one writer, no atomics;
//   P'  the projection backward (attn_bwd.cuh) -> dx and the Q/K/V grads;
// then the reduction of the weight-grad partials in a fixed order.
//
// What bounds it: the backward recomputes the tail forward and has two
// gradient products for every forward product, about twice the forward's
// fp32 FMA work, so at the training shape (B 2,048, T 200, D 64, 2 heads,
// FFN 256) it is bound by fp32 operations (no tensor cores: TF32 would
// round operands the plain version keeps, and bf16 gradients stay fp32).
// What the design does about it: every product of T', A' and P' is the
// register-tiled smem_mm (gemm_tile.cuh) over operands staged once in
// shared memory; T' and P' take 64 rows an item, so the weight-grad
// partials go through device memory half as often (attn_bwd.cuh gives
// the traffic).  A' walks only the keys the data lets a query tile weigh
// (below min(lens, last query + 1) causal, below lens bidirectional, all
// T at lens 0): ~34% of the query-key pairs at lengths 2..200 causal,
// ~50% bidirectional.  It stages each head's K and V with 16-byte loads
// (all keys at once where they fit, T 200 at dh 32; key tiles of 64
// otherwise), and draws one Philox call per four keys, in the pass that
// forms dp and p m.  Left for later PRs: tensor cores (a bf16 wgmma path
// has to settle the bf16 rounding policy first), cp.async staging, and T'
// with two blocks an SM.
//
// C interface (loaded with ctypes): returns a cudaError_t, 0 on success.
#include "attn_bwd.cuh"

using namespace recblr;

namespace {

// A' tiles: QT queries a step; KT keys a key tile (KT >= T: all keys of
// the row staged once); dk and dv summed in shared memory (kv_smem) or in
// the block's own rows of dqkv.
constexpr int ATTN_BWD_THREADS = 512;  // A' threads: 16 warps, the one block of an SM

struct AttnBwdTiles {
  int QT, KT, kv_smem;
};

inline size_t attn_bwd_smem_bytes(int T, int dh, const AttnBwdTiles& c) {
  const size_t LDH = ld_of(dh), LS = pad8(T) + 4;
  return sizeof(float) * (3 * c.QT * LDH + 2 * (size_t)c.KT * LDH + 2 * c.QT * LS +
                          (c.kv_smem ? 2 * (size_t)pad8(T) * LDH : 0)) +
         (size_t)c.QT * LS;  // keep bytes
}

// The largest query tile (32, 16, 8) that fits, all keys resident and dk,
// dv in shared memory where they fit, then key tiles of 64, then dk, dv in
// device memory.
inline AttnBwdTiles attn_bwd_tiles(int T, int dh) {
  for (int QT = 32; QT >= 8; QT /= 2) {
    const AttnBwdTiles opts[3] = {{QT, pad8(T), 1}, {QT, 64, 1}, {QT, 64, 0}};
    for (const AttnBwdTiles& c : opts)
      if (attn_bwd_smem_bytes(T, dh, c) <= (size_t)MAX_SMEM_BYTES) return c;
  }
  return {8, 64, 0};
}

// Block (b, h).  qkv, dqkv: [B, T, 3D] fp32; dctx: [B, T, D] fp32.  For
// each tile of QT queries: S = q k^T and dpd = dctx_h v^T against the keys
// the tile can weigh (below min(n, last query + 1) when causal, below n
// bidirectional; all T where n is 0, whose row averages every key at
// -10000), in key tiles of KT with k and v staged by 16-byte loads; the
// softmax and ds = p (dp - sum_j dp p) scale, dp = dpd m, a row a warp,
// one Philox call per four keys; then dq = ds k (written), dk += ds^T q,
// dv += (p m)^T dctx_h in the same key tiles.  Keys past those a tile
// weighs have p = 0 exactly, so skipping them changes no sum.
template <bool RB>
__global__ void __launch_bounds__(ATTN_BWD_THREADS, 1)
attn_bwd_kernel(const float* __restrict__ qkv, const int* __restrict__ lens,
                const float* __restrict__ dctx, Dropout dra, float* __restrict__ dqkv, int T,
                int D, int H, AttnBwdTiles tl, int causal, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int QT = tl.QT, KT = tl.KT;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int dh = D / H, dhp = pad8(dh), LDH = ld_of(dh), LS = pad8(T) + 4;
  const bool resident = KT >= T;
  const int n = lens[b];
  const int kall = n <= 0 ? T : min(n, T);  // keys a query of the row can weigh
  const int ld = 3 * D;
  const int lane = threadIdx.x % 32;
  const float* qkv_b = qkv + (size_t)b * T * ld;
  float* dqkv_b = dqkv + (size_t)b * T * ld;
  float* qs = smem;                // [QT, LDH] queries of the tile (rounded)
  float* dos = qs + QT * LDH;      // [QT, LDH] their dctx
  float* dqs = dos + QT * LDH;     // [QT, LDH] their dq
  float* ks = dqs + QT * LDH;      // [KT, LDH] keys (rounded)
  float* vs = ks + KT * LDH;       // [KT, LDH] values (rounded)
  float* ps = vs + KT * LDH;       // [QT, LS]  scores -> p -> p m (rounded)
  float* gs = ps + QT * LS;        // [QT, LS]  dpd -> dp -> ds
  float* dk;                       // dk, dv accumulators (row stride ldk)
  float* dv;
  int ldk;
  unsigned char* mk;               // [QT, LS]  keep bytes of the tile
  if (tl.kv_smem) {
    dk = gs + QT * LS;
    dv = dk + pad8(T) * LDH;
    ldk = LDH;
    mk = reinterpret_cast<unsigned char*>(dv + pad8(T) * LDH);
  } else {
    dk = dqkv_b + D + h * dh;
    dv = dqkv_b + 2 * D + h * dh;
    ldk = ld;
    mk = reinterpret_cast<unsigned char*>(gs + QT * LS);
  }
  // rows k0 .. k0 + rows - 1 of k (and v) into ks (vs), zero up to a
  // multiple of 8 rows and dhp columns
  auto stage_kv = [&](int k0, int rows, bool with_v) {
    const float* kp = qkv_b + (size_t)k0 * ld + D + h * dh;
    stage<RB>(ks, LDH, kp, ld, rows, dh, pad8(rows), dhp);
    if (with_v) stage<RB>(vs, LDH, kp + D, ld, rows, dh, pad8(rows), dhp);
  };
  for (int i = threadIdx.x; i < T * dh; i += blockDim.x) {
    const int j = i / dh, c = i % dh;
    dk[(size_t)j * ldk + c] = 0.f;
    dv[(size_t)j * ldk + c] = 0.f;
  }
  if (resident) stage_kv(0, kall, true);
  for (int i0 = 0; i0 < T; i0 += QT) {
    const int rows = min(QT, T - i0);
    const int nk = causal && n > 0 ? min(kall, i0 + rows) : kall;  // keys the tile weighs
    const int nkp = pad8(nk);
    __syncthreads();  // the previous tile's reads are done, the zeros written
    stage<RB>(qs, LDH, qkv_b + (size_t)i0 * ld + h * dh, ld, rows, dh, QT, dhp);
    stage<false>(dos, LDH, dctx + ((size_t)b * T + i0) * D + h * dh, D, rows, dh, QT, dhp);
    for (int i = threadIdx.x; i < QT * dhp; i += blockDim.x) dqs[(i / dhp) * LDH + i % dhp] = 0.f;
    // scores and dpd, key tile by key tile
    for (int k0 = 0; k0 < nk; k0 += KT) {
      const int kn = min(KT, nk - k0);
      if (!resident) {
        __syncthreads();
        stage_kv(k0, kn, true);
      }
      __syncthreads();
      const float* kp = resident ? ks + k0 * LDH : ks;
      const float* vp = resident ? vs + k0 * LDH : vs;
      smem_mm<2, 4, false, true>(qs, LDH, kp, LDH, QT, pad8(kn), dhp,
                                 [&](int m, int j, float v) { ps[m * LS + k0 + j] = v; });
      smem_mm<2, 4, false, true>(dos, LDH, vp, LDH, QT, pad8(kn), dhp,
                                 [&](int m, int j, float v) { gs[m * LS + k0 + j] = v; });
    }
    __syncthreads();
    // softmax(dot scale + mask), as softmax_row (attn_common.cuh) computes
    // it; then dp = dpd m, ds = p (dp - sum_j dp p) scale and p m, with the
    // mask of four keys from one Philox call
    for (int r = threadIdx.x / 32; r < QT; r += blockDim.x / 32) {
      float* pr = ps + (size_t)r * LS;
      float* gr = gs + (size_t)r * LS;
      unsigned char* mr = mk + (size_t)r * LS;
      if (r >= rows) {  // no query: zeros
        for (int j = lane; j < nkp; j += 32) pr[j] = gr[j] = 0.f;
        continue;
      }
      const int qpos = i0 + r;
      float mx = __int_as_float(0xff800000);  // -inf
      for (int j = lane; j < nk; j += 32) {
        const bool keep = j < n && (!causal || j <= qpos);
        const float v = __fadd_rn(__fmul_rn(pr[j], scale), keep ? 0.f : MASK_VALUE);
        pr[j] = v;
        mx = fmaxf(mx, v);
      }
      mx = warp_max(mx);
      float sum = 0.f;
      for (int j = lane; j < nk; j += 32) {
        const float e = exp_t(__fsub_rn(pr[j], mx));
        pr[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      float acc = 0.f;
      for (int g4 = lane; 4 * g4 < nk; g4 += 32) {
        const float4 m4 = drop_mask4(dra, ATTN_PROB + h, b, qpos, g4);
        const float mv[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = 4 * g4 + q;
          if (j >= nk) break;
          const float p = __fdiv_rn(pr[j], sum);
          const float dp = gr[j] * mv[q];
          pr[j] = p;
          gr[j] = dp;
          mr[j] = mv[q] != 0.f;
          acc += dp * p;
        }
      }
      acc = warp_sum(acc);
      const float mscale = dra.on ? dra.scale : 1.f;
      for (int j = lane; j < nkp; j += 32) {
        if (j < nk) {
          const float p = pr[j];
          gr[j] = p * (gr[j] - acc) * scale;
          pr[j] = mm_op<RB>(mr[j] ? p * mscale : 0.f);
        } else {
          pr[j] = gr[j] = 0.f;
        }
      }
    }
    // dq = ds k; dk += ds^T q; dv += (p m)^T dctx_h, key tile by key tile
    for (int k0 = 0; k0 < nk; k0 += KT) {
      const int kn = min(KT, nk - k0), knp = pad8(kn);
      if (!resident) {
        __syncthreads();
        stage_kv(k0, kn, false);
      }
      __syncthreads();
      const float* kp = resident ? ks + k0 * LDH : ks;
      smem_mm<1, 4, false, false>(gs + k0, LS, kp, LDH, QT, dhp, knp,
                                  [&](int m, int c, float v) { dqs[m * LDH + c] += v; });
      smem_mm<4, 4, true, false>(gs + k0, LS, qs, LDH, knp, dhp, QT, [&](int j, int c, float v) {
        if (j < kn && c < dh) dk[(size_t)(k0 + j) * ldk + c] += v;
      });
      smem_mm<4, 4, true, false>(ps + k0, LS, dos, LDH, knp, dhp, QT, [&](int j, int c, float v) {
        if (j < kn && c < dh) dv[(size_t)(k0 + j) * ldk + c] += v;
      });
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rows * dh; i += blockDim.x) {
      const int r = i / dh, c = i % dh;
      dqkv_b[(size_t)(i0 + r) * ld + h * dh + c] = dqs[r * LDH + c];
    }
  }
  if (tl.kv_smem) {
    __syncthreads();
    for (int i = threadIdx.x; i < T * dh; i += blockDim.x) {
      const int j = i / dh, c = i % dh;
      dqkv_b[(size_t)j * ld + D + h * dh + c] = dk[j * LDH + c];
      dqkv_b[(size_t)j * ld + 2 * D + h * dh + c] = dv[j * LDH + c];
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

  if ((e = launch_tail_bwd<Tin, ROWS_ALL>(x, nullptr, ctx, dout, p, drh, dxr, dctx, partial, G,
                                          gl, N, T, D, I, act, nullptr, 0, stream)) !=
      cudaSuccess)
    return e;

  const AttnBwdTiles tl = attn_bwd_tiles(T, D / H);
  const size_t s2 = attn_bwd_smem_bytes(T, D / H, tl);
  if ((e = set_smem(attn_bwd_kernel<RB>, s2)) != cudaSuccess) return e;
  attn_bwd_kernel<RB><<<B * H, ATTN_BWD_THREADS, s2, stream>>>(qkv, lens, dctx, dra, dqkv, T, D,
                                                               H, tl, causal, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  if ((e = launch_proj_bwd<Tin, ROWS_ALL>(x, nullptr, dqkv, dxr, dx, p, partial, G, gl, N, T, D,
                                          nullptr, 0, stream)) != cudaSuccess)
    return e;

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
