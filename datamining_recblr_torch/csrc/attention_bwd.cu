// Masked softmax attention with probability dropout, backward, for Hopper.
//
// Replaces the TPU kernel datamining_recblr_tpu/ops/attention.py:
// _bwd_kernel (reached through _attn_bwd, the VJP of fused_attention):
//     dV = (P m)^T dO;  dP = (dO V^T) m;  dS = P (dP - rowsum(dP P))
//     dQ = dS K / sqrt(dh);  dK = dS^T Q / sqrt(dh)
// The TPU kernel recomputes P from q and k over a whole [T, T] tile and
// draws the dropout mask again.  This one recomputes each tile of P from
// the log2-sum-exp rows that the training forward (attention.cu) keeps,
// exp2(s log2(e) - lse), draws the same Philox bits, and takes the
// row sums rowsum(dP P) as rowsum(dO O): O is the dropped P V, so
// sum_j dP_ij P_ij = sum_j m_ij P_ij (dO_i . v_j) = dO_i . O_i.  Both
// compute the same gradients.  Three launches, no atomics (every sum in a
// fixed order):
//   1  delta_kernel: rowsum(dO O) per query, one warp a row, with the
//      forward's fp32 O
//   2  dkdv_kernel: one block per (row, head, tile of keys), which walks
//      the query tiles that can attend to it and accumulates dK and dV in
//      registers
//   3  dq_kernel: one block per (row, head, tile of queries), which walks
//      the key tiles the forward visited and accumulates dQ
// Key tiles the mask removes entirely get dK = dV = 0 and are not
// visited; a row whose lens is 0 attends to all T keys (attention.cuh).
//
// What bounds it: 10 dh FLOP per kept (query, key) pair (S again, dP,
// dV, dQ, dK), so fp32 operations at the baselines' shapes; the products
// run as fp32 FMA from shared memory, as in the forward.  dq, dk, dv come
// out in q's dtype.
//
// C interface (loaded with ctypes): returns a cudaError_t, 0 on success.
#include "attention.cuh"

using namespace recblr;
using namespace recblr::attn;

namespace {

// delta[r] = sum_d dout[r, d] o32[r, d] over the rows r of [B*H*T, dh].
template <typename Tin>
__global__ void delta_kernel(const Tin* __restrict__ dout, const float* __restrict__ o32,
                             float* __restrict__ delta, int rows, int dh) {
  const int r = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) / 32);
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const size_t o = (size_t)r * dh;
  float s = 0.f;
  for (int d = lane; d < dh; d += 32) s += load_act(dout, o + d) * o32[o + d];
  s = warp_sum(s);
  if (lane == 0) delta[r] = s;
}

// The [KT, QT] tiles S^T = K Q^T and dP^T = V dO^T of one thread: keys
// ty * RA + a, queries tx + 16 c.
template <int RA, int CB, int LD>
__device__ __forceinline__ void transposed_scores(const float* ks, const float* vs,
                                                  const float* qs, const float* dos, int dh,
                                                  float (&st)[RA][CB], float (&dpt)[RA][CB]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int c = 0; c < CB; ++c) st[a][c] = dpt[a][c] = 0.f;
  for (int d = 0; d < dh; ++d) {
    float kk[RA], vv[RA], qq[CB], oo[CB];
#pragma unroll
    for (int a = 0; a < RA; ++a) {
      kk[a] = ks[(ty * RA + a) * LD + d];
      vv[a] = vs[(ty * RA + a) * LD + d];
    }
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      qq[c] = qs[(tx + 16 * c) * LD + d];
      oo[c] = dos[(tx + 16 * c) * LD + d];
    }
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int c = 0; c < CB; ++c) {
        st[a][c] = fmaf(kk[a], qq[c], st[a][c]);
        dpt[a][c] = fmaf(vv[a], oo[c], dpt[a][c]);
      }
  }
}

// P (dropped) and dS of query i and the thread's keys j0 .. j0 + RA - 1,
// from their raw products st, dpt; ls, dl the query's lse and delta.
template <int RA>
__device__ __forceinline__ void probs_and_ds(const float* st, const float* dpt, int i, int j0,
                                             float ls, float dl, const RowKeys& rk, int causal,
                                             int T, float scale, const Dropout& dr, int b,
                                             int h, float* pd, float* ds) {
  uint4 w = make_uint4(0u, 0u, 0u, 0u);
  if (dr.on && i < T) w = prob_mask_words(dr, h, b, i, j0 >> 2);
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int j = j0 + a;
    pd[a] = ds[a] = 0.f;
    if (i >= T) continue;
    const float sc = masked_score(__fmul_rn(st[a], scale), i, j, rk, causal, T);
    if (sc == -INFINITY) continue;
    const float p = exp2f(sc * LOG2E - ls);
    const float mk = dr.on ? mask_of(dr, w, j & 3) : 1.f;
    pd[a] = p * mk;
    ds[a] = p * (dpt[a] * mk - dl);
  }
}

template <typename Tin, int QT, int NJ>
__global__ void __launch_bounds__(ATTN_THREADS)
dkdv_kernel(const Tin* __restrict__ q, const Tin* __restrict__ k, const Tin* __restrict__ v,
            const int* __restrict__ lens, const Tin* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta, Tin* __restrict__ dk,
            Tin* __restrict__ dv, int H, int T, int dh, int causal, float scale, Dropout dr) {
  constexpr int KT = QT;
  constexpr int RA = KT / 16;  // keys of a thread: ty * RA + a
  constexpr int CB = QT / 16;  // queries of a thread in a tile: tx + 16 c
  constexpr int W = NJ * 16;
  constexpr int LD = W + 1;
  constexpr int PL = QT + 1;
  extern __shared__ float smem[];
  float* ks = smem;           // [KT, LD]  the key tile
  float* vs = ks + KT * LD;   // [KT, LD]  its values
  float* qs = vs + KT * LD;   // [QT, LD]  a query tile
  float* dos = qs + QT * LD;  // [QT, LD]  its output gradient
  float* pt = dos + QT * LD;  // [KT, PL]  P^T (dropped)
  float* dst = pt + KT * PL;  // [KT, PL]  dS^T
  float* ls = dst + KT * PL;  // [QT]      the queries' lse
  float* dl = ls + QT;        // [QT]      and delta
  const int tiles = (T + KT - 1) / KT;
  const int bh = blockIdx.x / tiles;
  const int k0 = (blockIdx.x % tiles) * KT;
  const int kn = min(KT, T - k0);
  const int b = bh / H, h = bh % H;
  const size_t base = (size_t)bh * T * dh;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const RowKeys rk = row_keys(lens[b], T);
  if (rk.any && k0 >= rk.n) {  // keys no query attends to
    for (int idx = threadIdx.x; idx < kn * dh; idx += blockDim.x) {
      store_act(dk, base + (size_t)k0 * dh + idx, 0.f);
      store_act(dv, base + (size_t)k0 * dh + idx, 0.f);
    }
    return;
  }
  load_rows<Tin, W>(k + base, k0, kn, KT, dh, LD, ks);
  load_rows<Tin, W>(v + base, k0, kn, KT, dh, LD, vs);
  float adk[RA][NJ], adv[RA][NJ];
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int j = 0; j < NJ; ++j) adk[a][j] = adv[a][j] = 0.f;

  // a causal row of lens >= 1 reaches key j from queries i >= j only
  for (int q0 = rk.any && causal ? k0 : 0; q0 < T; q0 += QT) {
    const int qn = min(QT, T - q0);
    __syncthreads();  // the previous query tile is read
    load_rows<Tin, W>(q + base, q0, qn, QT, dh, LD, qs);
    load_rows<Tin, W>(dout + base, q0, qn, QT, dh, LD, dos);
    for (int r = threadIdx.x; r < QT; r += blockDim.x) {
      ls[r] = r < qn ? lse[(size_t)bh * T + q0 + r] : 0.f;
      dl[r] = r < qn ? delta[(size_t)bh * T + q0 + r] : 0.f;
    }
    __syncthreads();
    float st[RA][CB], dpt[RA][CB];
    transposed_scores<RA, CB, LD>(ks, vs, qs, dos, dh, st, dpt);
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      const int r = tx + 16 * c;
      float sa[RA], da[RA], pd[RA], ds[RA];
#pragma unroll
      for (int a = 0; a < RA; ++a) {
        sa[a] = st[a][c];
        da[a] = dpt[a][c];
      }
      probs_and_ds<RA>(sa, da, q0 + r, k0 + ty * RA, ls[r], dl[r], rk, causal, T, scale, dr, b,
                       h, pd, ds);
#pragma unroll
      for (int a = 0; a < RA; ++a) {
        pt[(ty * RA + a) * PL + r] = pd[a];
        dst[(ty * RA + a) * PL + r] = ds[a];
      }
    }
    __syncthreads();
    for (int ii = 0; ii < qn; ++ii) {
      float pa[RA], sa[RA];
#pragma unroll
      for (int a = 0; a < RA; ++a) {
        pa[a] = pt[(ty * RA + a) * PL + ii];
        sa[a] = dst[(ty * RA + a) * PL + ii];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float o = dos[ii * LD + tx + 16 * j];
        const float qv = qs[ii * LD + tx + 16 * j];
#pragma unroll
        for (int a = 0; a < RA; ++a) {
          adv[a][j] = fmaf(pa[a], o, adv[a][j]);
          adk[a][j] = fmaf(sa[a], qv, adk[a][j]);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int j = k0 + ty * RA + a;
    if (j >= T) continue;
    const size_t row = base + (size_t)j * dh;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int dd = tx + 16 * jj;
      if (dd >= dh) continue;
      store_act(dk, row + dd, adk[a][jj] * scale);
      store_act(dv, row + dd, adv[a][jj]);
    }
  }
}

template <typename Tin, int QT, int NJ>
__global__ void __launch_bounds__(ATTN_THREADS)
dq_kernel(const Tin* __restrict__ q, const Tin* __restrict__ k, const Tin* __restrict__ v,
          const int* __restrict__ lens, const Tin* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta, Tin* __restrict__ dq,
          int H, int T, int dh, int causal, float scale, Dropout dr) {
  constexpr int KT = QT;
  constexpr int RA = QT / 16;  // rows of a thread: keys ty * RA + a in the tiles, then
                               // queries ty * RA + a in the dQ sum
  constexpr int CB = KT / 16;  // queries tx + 16 c in the tiles
  constexpr int W = NJ * 16;
  constexpr int LD = W + 1;
  constexpr int PL = KT + 1;
  extern __shared__ float smem[];
  float* qs = smem;           // [QT, LD]  the query tile
  float* dos = qs + QT * LD;  // [QT, LD]  its output gradient
  float* ks = dos + QT * LD;  // [KT, LD]  a key tile
  float* vs = ks + KT * LD;   // [KT, LD]  its values
  float* dss = vs + KT * LD;  // [QT, PL]  dS
  float* ls = dss + QT * PL;  // [QT]
  float* dl = ls + QT;        // [QT]
  const int tiles = (T + QT - 1) / QT;
  const int bh = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * QT;
  const int qn = min(QT, T - q0);
  const int b = bh / H, h = bh % H;
  const size_t base = (size_t)bh * T * dh;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const RowKeys rk = row_keys(lens[b], T);
  const int kend = key_end(rk, causal, q0 + qn);

  load_rows<Tin, W>(q + base, q0, qn, QT, dh, LD, qs);
  load_rows<Tin, W>(dout + base, q0, qn, QT, dh, LD, dos);
  for (int r = threadIdx.x; r < QT; r += blockDim.x) {
    ls[r] = r < qn ? lse[(size_t)bh * T + q0 + r] : 0.f;
    dl[r] = r < qn ? delta[(size_t)bh * T + q0 + r] : 0.f;
  }
  float acc[RA][NJ];
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[a][j] = 0.f;

  for (int k0 = 0; k0 < kend; k0 += KT) {
    const int kn = min(KT, kend - k0);
    __syncthreads();  // the previous key tile and dS are read
    load_rows<Tin, W>(k + base, k0, min(KT, T - k0), KT, dh, LD, ks);
    load_rows<Tin, W>(v + base, k0, min(KT, T - k0), KT, dh, LD, vs);
    __syncthreads();
    float st[RA][CB], dpt[RA][CB];
    transposed_scores<RA, CB, LD>(ks, vs, qs, dos, dh, st, dpt);
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      const int r = tx + 16 * c;
      float sa[RA], da[RA], pd[RA], ds[RA];
#pragma unroll
      for (int a = 0; a < RA; ++a) {
        sa[a] = st[a][c];
        da[a] = dpt[a][c];
      }
      probs_and_ds<RA>(sa, da, q0 + r, k0 + ty * RA, ls[r], dl[r], rk, causal, T, scale, dr, b,
                       h, pd, ds);
#pragma unroll
      for (int a = 0; a < RA; ++a) dss[r * PL + ty * RA + a] = ds[a];
    }
    __syncthreads();
    for (int jj = 0; jj < kn; ++jj) {
      float sv[RA];
#pragma unroll
      for (int a = 0; a < RA; ++a) sv[a] = dss[(ty * RA + a) * PL + jj];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float kv = ks[jj * LD + tx + 16 * j];
#pragma unroll
        for (int a = 0; a < RA; ++a) acc[a][j] = fmaf(sv[a], kv, acc[a][j]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int i = q0 + ty * RA + a;
    if (i >= T) continue;
    const size_t row = base + (size_t)i * dh;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int dd = tx + 16 * j;
      if (dd < dh) store_act(dq, row + dd, acc[a][j] * scale);
    }
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename Tin, int QT, int NJ>
cudaError_t launch(const Tin* q, const Tin* k, const Tin* v, const int* lens, const float* o32,
                   const float* lse, const Tin* dout, float* delta, Tin* dq, Tin* dk, Tin* dv,
                   int B, int H, int T, int dh, int causal, float scale, Dropout dr,
                   cudaStream_t stream) {
  constexpr int LD = NJ * 16 + 1;
  const int rows = B * H * T;
  delta_kernel<Tin><<<(unsigned)(((size_t)rows * 32 + 255) / 256), 256, 0, stream>>>(
      dout, o32, delta, rows, dh);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const unsigned blocks = (unsigned)B * H * ((T + QT - 1) / QT);
  const size_t s_kv = sizeof(float) * ((size_t)4 * QT * LD + (size_t)2 * QT * (QT + 1) + 2 * QT);
  if ((e = set_smem(dkdv_kernel<Tin, QT, NJ>, s_kv)) != cudaSuccess) return e;
  dkdv_kernel<Tin, QT, NJ><<<blocks, ATTN_THREADS, s_kv, stream>>>(
      q, k, v, lens, dout, lse, delta, dk, dv, H, T, dh, causal, scale, dr);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const size_t s_q = sizeof(float) * ((size_t)4 * QT * LD + (size_t)QT * (QT + 1) + 2 * QT);
  if ((e = set_smem(dq_kernel<Tin, QT, NJ>, s_q)) != cudaSuccess) return e;
  dq_kernel<Tin, QT, NJ><<<blocks, ATTN_THREADS, s_q, stream>>>(
      q, k, v, lens, dout, lse, delta, dq, H, T, dh, causal, scale, dr);
  return cudaGetLastError();
}

// Tiles by head width, as the forward's.
template <typename Tin>
cudaError_t attn_bwd(const Tin* q, const Tin* k, const Tin* v, const int* lens, const float* o32,
                     const float* lse, const Tin* dout, float* delta, Tin* dq, Tin* dk, Tin* dv,
                     int B, int H, int T, int dh, int causal, float scale, Dropout dr,
                     cudaStream_t s) {
  if (dh <= 64)
    return launch<Tin, 64, 4>(q, k, v, lens, o32, lse, dout, delta, dq, dk, dv, B, H, T, dh,
                              causal, scale, dr, s);
  if (dh <= 128)
    return launch<Tin, 64, 8>(q, k, v, lens, o32, lse, dout, delta, dq, dk, dv, B, H, T, dh,
                              causal, scale, dr, s);
  return launch<Tin, 32, 16>(q, k, v, lens, o32, lse, dout, delta, dq, dk, dv, B, H, T, dh,
                             causal, scale, dr, s);
}

}  // namespace

extern "C" {

// q, k, v, dout, dq, dk, dv: [B, H, T, dh] fp32 (bf16 == 0) or bf16,
// contiguous, dh <= 256; lens: [B] int32; o32: [B, H, T, dh] fp32, the
// forward's output; lse: [B, H, T] fp32, the forward's log2-sum-exp;
// delta: [B, H, T] fp32 scratch; scale, drop, seed, thresh, dscale: as
// the forward's; device: the card that holds them.
int recblr_attn_bwd(const void* q, const void* k, const void* v, const void* lens,
                    const void* o32, const void* lse, const void* dout, void* delta, void* dq,
                    void* dk, void* dv, int B, int H, int T, int dh, int causal, float scale,
                    int bf16, int drop, unsigned long long seed, unsigned thresh, float dscale,
                    int device, void* stream) {
  // this library has its own (static) CUDA runtime: select the tensors' card
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const Dropout dr = make_dropout(drop, seed, thresh, dscale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ln = static_cast<const int*>(lens);
  const float* o = static_cast<const float*>(o32);
  const float* ls = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (bf16) {
    using T16 = __nv_bfloat16;
    return attn_bwd(static_cast<const T16*>(q), static_cast<const T16*>(k),
                    static_cast<const T16*>(v), ln, o, ls, static_cast<const T16*>(dout), dl,
                    static_cast<T16*>(dq), static_cast<T16*>(dk), static_cast<T16*>(dv), B, H, T,
                    dh, causal, scale, dr, s);
  }
  return attn_bwd(static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), ln, o, ls, static_cast<const float*>(dout), dl,
                  static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv), B, H,
                  T, dh, causal, scale, dr, s);
}

const char* recblr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
