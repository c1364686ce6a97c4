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
// fixed order, so dq, dk and dv are the same bits from run to run):
//   1  delta_kernel: rowsum(dO O) per query, one warp a row, with the
//      forward's fp32 O
//   2  dkdv_mma_kernel: one block per (row, head, tile of 64 keys), which
//      walks the chunks of 8 queries that can attend to them and keeps dK
//      and dV in registers
//   3  dq_mma_kernel: one block per (row, head, tile of 64 queries), which
//      walks the chunks of 8 keys the forward visited and keeps dQ in
//      registers
// Key tiles the mask removes entirely get dK = dV = 0 and are not
// visited; a row whose lens is 0 attends to all T keys, its raw scores
// the forward's FMA sums (attention.cuh).
//
// What bounds it: 10 dh FLOP per kept (query, key) pair (S again, dP,
// dV, dQ, dK).  Up to dh 128 every product runs on the tensor cores
// (attention.cuh's scheme): the S and dP (or S^T and dP^T) tiles are C
// fragments in registers, and P and dS (or their transposes) go from there
// as the A fragments of the next products (split_c_i), never through
// shared memory.  The block's own K and V (or Q and dO) are staged once;
// the walked chunks are copied by cp.async a chunk ahead and split into
// TF32 terms once by the block.  fp32: 3xTF32 products; bf16: bf16 products
// for S and dP, the fp32 P and dS against bf16 operands in two TF32 terms.
// Two warps own each 16 rows (PAIR_THREADS below): one computes S, the
// other dP and the dropout masks, they swap them, and each accumulates half
// of dh's columns, so dK and dV take 64 floats a thread at dh 128, not 128:
// 128 registers, and two blocks of eight warps (~103 KB each in fp32) share
// an SM.  At the d256 shape the bound is the bytes (1.0 ms fp32), and the
// kernels wait on latency at 11-13% of it.  Beyond dh 128 (dkdv_kernel,
// dq_kernel) the products run as fp32 FMA from shared memory, each thread
// a 2 x 4 block of a tile, with P^T and dS^T in shared memory.  dq, dk, dv
// come out in q's dtype.
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

// Beyond MMA_MAX_DH: the FMA kernels, block (row, head, tile of QT keys or
// queries) of 16 x 16 threads.
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
  extern __shared__ __align__(16) float smem[];
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
  extern __shared__ __align__(16) float smem[];
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

// ---------------------------------------------------------------------------
// the tensor-core kernels (dh <= MMA_MAX_DH)
// ---------------------------------------------------------------------------

constexpr int BWD_C = 8;  // walked rows (queries or keys) a chunk

// The warp pairs of the tensor-core backward kernels: a block of eight warps
// owns 64 rows, the two warps of pair p the 16 rows 16p .. 16p + 15.  Per
// chunk warp 0 of the pair computes the raw scores (S, or S^T in dkdv),
// warp 1 dP (or dP^T) and the dropout masks; they swap those C fragments
// through shared memory (Swap) and each computes P and dS, then the
// gradient products for its half of dh's 8-column tiles.  So a thread keeps
// the accumulators of half the columns (dK and dV: 64 floats at dh 128, not
// 128), and two blocks of eight warps share an SM.
constexpr int PAIR_THREADS = 256;

// One pair's exchange slots: warp 0's scores, warp 1's dP (dropped) and
// masks, four floats a lane each.
struct Swap {
  float4 s[32], dp[32], m[32];
};

template <typename Tin>
__host__ __device__ inline size_t bwd_mma_smem(int dh16) {
  const int ld = row_ld<Tin>(dh16);
  return walk_bytes<Tin>(2, BWD_C, ld) + PAIR_THREADS / 64 * sizeof(Swap);
}

// Both warps of pair p (block-local barrier p + 1; 0 is __syncthreads).
__device__ __forceinline__ void pair_sync(int p) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(p + 1) : "memory");
}

// The scores and dP of one chunk, in both warps of a pair: warp 0 (half 0)
// the raw scores of its rows a against chunk x (FMA chains on a row that
// keeps no key, attention.cuh fma_rows_t; x's rows also at xg in device
// memory, xrows of them), warp 1 dP = b y^T and, with dropout, the masks
// mask(m) draws; the two swap them through sw.  Returns in s the raw
// scores, in dp dP m, in m the masks (1 without dropout).
template <typename Tin, typename Mask>
__device__ __forceinline__ void pair_products(Swap& sw, int pr, int half, const Tin* a,
                                              const Tin* b, const Chunk<Tin>& x,
                                              const Chunk<Tin>& y, const Tin* xg, int xrows,
                                              int dh, bool keeps_key, bool drop, Mask mask,
                                              float (&s)[4], float (&dp)[4], float (&m)[4]) {
  const int dh16 = pad16(dh), ld = row_ld<Tin>(dh16), lane = threadIdx.x & 31;
  float acc[1][4] = {{0.f, 0.f, 0.f, 0.f}};
  if (half == 0) {
    if (keeps_key)
      mm_rows_t<1>(a, ld, x.v, x.lo, ld, dh16, acc);
    else
      fma_rows_t<Tin, 1>(a, ld, xg, xrows, dh, acc);
    sw.s[lane] = make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
  } else {
    mm_rows_t<1>(b, ld, y.v, y.lo, ld, dh16, acc);
#pragma unroll
    for (int e = 0; e < 4; ++e) m[e] = 1.f;
    if (drop) mask(m);
    sw.dp[lane] = make_float4(acc[0][0] * m[0], acc[0][1] * m[1], acc[0][2] * m[2],
                              acc[0][3] * m[3]);
    sw.m[lane] = make_float4(m[0], m[1], m[2], m[3]);
  }
  pair_sync(pr);
  const float4 sv = sw.s[lane], dv = sw.dp[lane], mv = sw.m[lane];
  s[0] = sv.x, s[1] = sv.y, s[2] = sv.z, s[3] = sv.w;
  dp[0] = dv.x, dp[1] = dv.y, dp[2] = dv.z, dp[3] = dv.w;
  m[0] = mv.x, m[1] = mv.y, m[2] = mv.z, m[3] = mv.w;
}

// Block (row, head, tile of 64 keys); pair p its keys 16p .. 16p + 15.
// Per chunk of 8 queries the pair's S^T = K Q^T and dP^T = V dO^T (16 x 8 C
// fragments), P^T and dS^T from them, then each warp's half of dV += (P
// m)^T dO and dK += dS^T Q with P^T, dS^T as A fragments.  NT: dh's
// 8-column tiles (a warp accumulates NT / 2 of them).
template <typename Tin, int NT>
__global__ void __launch_bounds__(PAIR_THREADS, 2)
dkdv_mma_kernel(const Tin* __restrict__ q, const Tin* __restrict__ k, const Tin* __restrict__ v,
                const int* __restrict__ lens, const Tin* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                Tin* __restrict__ dk, Tin* __restrict__ dv, int H, int T, int dh, int causal,
                float scale, Dropout dr) {
  constexpr int NH = NT / 2;
  extern __shared__ __align__(16) float smem[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem);
  const int dh16 = pad16(dh), ld = row_ld<Tin>(dh16);
  Tin* ks = reinterpret_cast<Tin*>(sm);  // [64][ld]  the block's keys
  Tin* vs = ks + (size_t)ld * MMA_ROWS;  // [64][ld]  their values
  const int tiles = (T + MMA_ROWS - 1) / MMA_ROWS;
  const int bh = blockIdx.x / tiles, k0 = (blockIdx.x % tiles) * MMA_ROWS;
  const int b = bh / H, h = bh % H;
  const size_t base = (size_t)bh * T * dh;
  const int lane = threadIdx.x & 31, gid = lane >> 2, t = lane & 3;
  const int pr = threadIdx.x >> 6, half = (threadIdx.x >> 5) & 1, w16 = pr * 16;
  const int n0 = half * NH, nt = (dh + 7) / 8 - n0;  // this warp's column tiles
  Swap& sw = reinterpret_cast<Swap*>(sm + bwd_mma_smem<Tin>(dh16))[-PAIR_THREADS / 64 + pr];
  const RowKeys rk = row_keys(lens[b], T);
  if (rk.any && k0 >= rk.n) {  // keys no query attends to
    const int kn = min(MMA_ROWS, T - k0);
    for (int idx = threadIdx.x; idx < kn * dh; idx += blockDim.x) {
      store_act(dk, base + (size_t)k0 * dh + idx, 0.f);
      store_act(dv, base + (size_t)k0 * dh + idx, 0.f);
    }
    return;
  }
  const Tin* kw = ks + w16 * ld;
  const Tin* vw = vs + w16 * ld;
  const int j0 = k0 + w16;  // the pair's first key
  float adk[NH][4], adv[NH][4];
#pragma unroll
  for (int n = 0; n < NH; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;
  // a causal row of lens >= 1 reaches key j from queries i >= j only
  walk<Tin, BWD_C>(sm, ks, vs, k + base, v + base, k0, q + base, dout + base,
                   rk.any && causal ? k0 : 0, T, T, dh,
       [&](int c0, const Chunk<Tin>& qc, const Chunk<Tin>& oc) {
         float st[4], dpm[4], m[4];
         pair_products(sw, pr, half, kw, vw, qc, oc, q + base + (size_t)c0 * dh,
                       min(BWD_C, T - c0), dh, rk.any, dr.on,
                       [&](float(&mk)[4]) { masks_k_rows(dr, h, b, j0, c0, mk); }, st, dpm, m);
         float ls[2], dl[2];
#pragma unroll
         for (int e = 0; e < 2; ++e) {
           const int i = c0 + 2 * t + e;
           ls[e] = i < T ? lse[(size_t)bh * T + i] : 0.f;
           dl[e] = i < T ? delta[(size_t)bh * T + i] : 0.f;
         }
         float pd[1][4], ds[1][4];
#pragma unroll
         for (int e = 0; e < 4; ++e) {
           const int i = c0 + 2 * t + (e & 1), j = j0 + gid + (e & 2 ? 8 : 0);
           const float sc = masked_score(__fmul_rn(st[e], scale), i, j, rk, causal, T);
           pd[0][e] = ds[0][e] = 0.f;
           if (i < T && sc != -INFINITY) {
             const float p = exp2f(sc * LOG2E - ls[e & 1]);
             pd[0][e] = p * m[e];
             ds[0][e] = p * (dpm[e] - dl[e & 1]);
           }
         }
         mm_c_w<1, NH>(pd, oc.v + 8 * n0, oc.lo + 8 * n0, ld, nt, adv);
         mm_c_w<1, NH>(ds, qc.v + 8 * n0, qc.lo + 8 * n0, ld, nt, adk);
       });
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = j0 + gid + 8 * r;
    if (j >= T) continue;
    const size_t row = base + (size_t)j * dh;
#pragma unroll
    for (int n = 0; n < NH; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * (n0 + n) + 2 * t + e;
        if (d >= dh) continue;
        store_act(dk, row + d, adk[n][2 * r + e] * scale);
        store_act(dv, row + d, adv[n][2 * r + e]);
      }
  }
}

// Block (row, head, tile of 64 queries); pair p its queries 16p .. 16p +
// 15.  Per chunk of 8 keys below key_end the pair's S = Q K^T and dP = dO
// V^T, dS from them, then each warp's half of dQ += dS K with dS as the A
// fragments.
template <typename Tin, int NT>
__global__ void __launch_bounds__(PAIR_THREADS, 2)
dq_mma_kernel(const Tin* __restrict__ q, const Tin* __restrict__ k, const Tin* __restrict__ v,
              const int* __restrict__ lens, const Tin* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              Tin* __restrict__ dq, int H, int T, int dh, int causal, float scale, Dropout dr) {
  constexpr int NH = NT / 2;
  extern __shared__ __align__(16) float smem[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem);
  const int dh16 = pad16(dh), ld = row_ld<Tin>(dh16);
  Tin* qs = reinterpret_cast<Tin*>(sm);  // [64][ld]  the block's queries
  Tin* dos = qs + (size_t)ld * MMA_ROWS;  // [64][ld]  their output gradient
  const int tiles = (T + MMA_ROWS - 1) / MMA_ROWS;
  const int bh = blockIdx.x / tiles, q0 = (blockIdx.x % tiles) * MMA_ROWS;
  const int b = bh / H, h = bh % H;
  const size_t base = (size_t)bh * T * dh;
  const int lane = threadIdx.x & 31, gid = lane >> 2, t = lane & 3;
  const int pr = threadIdx.x >> 6, half = (threadIdx.x >> 5) & 1, w16 = pr * 16;
  const int n0 = half * NH, nt = (dh + 7) / 8 - n0;
  Swap& sw = reinterpret_cast<Swap*>(sm + bwd_mma_smem<Tin>(dh16))[-PAIR_THREADS / 64 + pr];
  const int i0 = q0 + w16 + gid;  // the query of row gid
  const RowKeys rk = row_keys(lens[b], T);
  const int kend = key_end(rk, causal, min(q0 + MMA_ROWS, T));
  const Tin* qw = qs + w16 * ld;
  const Tin* dow = dos + w16 * ld;
  float ls[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + 8 * r;
    ls[r] = i < T ? lse[(size_t)bh * T + i] : 0.f;
    dl[r] = i < T ? delta[(size_t)bh * T + i] : 0.f;
  }
  float acc[NH][4];
#pragma unroll
  for (int n = 0; n < NH; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  walk<Tin, BWD_C>(sm, qs, dos, q + base, dout + base, q0, k + base, v + base, 0, kend, T,
                   dh,
       [&](int c0, const Chunk<Tin>& kc, const Chunk<Tin>& vc) {
         float s[4], dpm[4], m[4];
         pair_products(sw, pr, half, qw, dow, kc, vc, k + base + (size_t)c0 * dh,
                       min(BWD_C, T - c0), dh, rk.any, dr.on,
                       [&](float(&mk)[4]) { masks_q_rows(dr, h, b, i0, c0, mk); }, s, dpm, m);
         float ds[1][4];
#pragma unroll
         for (int e = 0; e < 4; ++e) {
           const int i = i0 + (e & 2 ? 8 : 0), j = c0 + 2 * t + (e & 1);
           const float sc = masked_score(__fmul_rn(s[e], scale), i, j, rk, causal, T);
           ds[0][e] = 0.f;
           if (i < T && sc != -INFINITY) {
             const float p = exp2f(sc * LOG2E - ls[e >> 1]);
             ds[0][e] = p * (dpm[e] - dl[e >> 1]);
           }
         }
         mm_c_w<1, NH>(ds, kc.v + 8 * n0, kc.lo + 8 * n0, ld, nt, acc);
       });
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + 8 * r;
    if (i >= T) continue;
    const size_t row = base + (size_t)i * dh;
#pragma unroll
    for (int n = 0; n < NH; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * (n0 + n) + 2 * t + e;
        if (d < dh) store_act(dq, row + d, acc[n][2 * r + e] * scale);
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

template <typename Tin, int NT>
cudaError_t launch_mma(const Tin* q, const Tin* k, const Tin* v, const int* lens,
                       const float* o32, const float* lse, const Tin* dout, float* delta, Tin* dq,
                       Tin* dk, Tin* dv, int B, int H, int T, int dh, int causal, float scale,
                       Dropout dr, cudaStream_t stream) {
  const int rows = B * H * T;
  delta_kernel<Tin><<<(unsigned)(((size_t)rows * 32 + 255) / 256), 256, 0, stream>>>(
      dout, o32, delta, rows, dh);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const unsigned blocks = (unsigned)B * H * ((T + MMA_ROWS - 1) / MMA_ROWS);
  const size_t smem = bwd_mma_smem<Tin>(pad16(dh));
  if ((e = set_smem(dkdv_mma_kernel<Tin, NT>, smem)) != cudaSuccess) return e;
  dkdv_mma_kernel<Tin, NT><<<blocks, PAIR_THREADS, smem, stream>>>(
      q, k, v, lens, dout, lse, delta, dk, dv, H, T, dh, causal, scale, dr);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if ((e = set_smem(dq_mma_kernel<Tin, NT>, smem)) != cudaSuccess) return e;
  dq_mma_kernel<Tin, NT><<<blocks, PAIR_THREADS, smem, stream>>>(
      q, k, v, lens, dout, lse, delta, dq, H, T, dh, causal, scale, dr);
  return cudaGetLastError();
}

// The tensor-core kernels up to dh 128 (by the 8-column tiles of dh), the
// FMA kernels (32 keys and queries a tile) beyond.
template <typename Tin>
cudaError_t attn_bwd(const Tin* q, const Tin* k, const Tin* v, const int* lens, const float* o32,
                     const float* lse, const Tin* dout, float* delta, Tin* dq, Tin* dk, Tin* dv,
                     int B, int H, int T, int dh, int causal, float scale, Dropout dr,
                     cudaStream_t s) {
  if (dh <= 32)
    return launch_mma<Tin, 4>(q, k, v, lens, o32, lse, dout, delta, dq, dk, dv, B, H, T, dh,
                              causal, scale, dr, s);
  if (dh <= 64)
    return launch_mma<Tin, 8>(q, k, v, lens, o32, lse, dout, delta, dq, dk, dv, B, H, T, dh,
                              causal, scale, dr, s);
  if (dh <= MMA_MAX_DH)
    return launch_mma<Tin, 16>(q, k, v, lens, o32, lse, dout, delta, dq, dk, dv, B, H, T, dh,
                               causal, scale, dr, s);
  return launch<Tin, 32, 16>(q, k, v, lens, o32, lse, dout, delta, dq, dk, dv, B, H, T, dh,
                             causal, scale, dr, s);
}

// Blocks of the tensor-core dK/dV kernel (which == 0) or dQ kernel (1) at
// dh <= 128 that fit on one SM.
template <typename Tin>
int bwd_blocks_per_sm(int dh, int which) {
  const size_t smem = bwd_mma_smem<Tin>(pad16(dh));
  auto count = [&](auto kern) {
    int n = 0;
    cudaError_t e = set_smem(kern, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, PAIR_THREADS, smem);
    return e == cudaSuccess ? n : -(int)e;
  };
  if (which == 0)
    return count(dh <= 32   ? dkdv_mma_kernel<Tin, 4>
                 : dh <= 64 ? dkdv_mma_kernel<Tin, 8>
                            : dkdv_mma_kernel<Tin, 16>);
  return count(dh <= 32   ? dq_mma_kernel<Tin, 4>
               : dh <= 64 ? dq_mma_kernel<Tin, 8>
                          : dq_mma_kernel<Tin, 16>);
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

// Blocks an SM holds of the backward's tensor-core dK/dV kernel (which ==
// 0) or dQ kernel (1) at head width dh <= 128 (fp32 or bf16), or minus a
// cudaError_t.
int recblr_attn_bwd_blocks_per_sm(int dh, int bf16, int which, int device) {
  if (dh < 1 || dh > MMA_MAX_DH) return -(int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return -(int)e;
  return bf16 ? bwd_blocks_per_sm<__nv_bfloat16>(dh, which) : bwd_blocks_per_sm<float>(dh, which);
}

const char* recblr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
