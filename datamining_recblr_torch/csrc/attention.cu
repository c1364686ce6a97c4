// Masked softmax attention with probability dropout, forward, for Hopper.
//
// Replaces the TPU kernel datamining_recblr_tpu/ops/attention.py:
// _fwd_kernel (reached through _attn_fwd / fused_attention), which the
// attention baselines' per-op composition runs in every layer that the
// whole-layer kernels (fused_block.cu) do not take:
//     s = q k^T / sqrt(dh) + mask;  p = softmax(s);  out = (p * m_h) v
// q, k, v, out: [B, H, T, dh]; m_h the dropout mask of head h.
//
// The TPU kernel holds a whole [T, T] score tile of a (row block, head) in
// VMEM.  A Hopper block has 227 KB, 16 MB short of that tile at T 2,048,
// so this kernel takes one block per (row, head, tile of queries) and
// walks the key tiles with an online softmax in fp32 (running max and
// sum per query), which takes any T.  The mask multiplies the normalised
// probability, so each key's unnormalised weight takes its scaled keep
// bit and the row divides by the undropped sum at the end.  Key tiles
// that the mask removes entirely are not visited (attention.cuh says
// when that is exact).
//
// What bounds it: 4 dh FLOP per kept (query, key) pair against 4 dh
// values of traffic per query.  Up to dh 128 the products run on the
// tensor cores (attn_fwd_mma_kernel, attention.cuh's scheme): a block of
// four warps owns 64 queries, 16 a warp, and walks chunks of 8 keys (16 in
// bf16), K and V copied by cp.async a chunk ahead and split into TF32 terms
// once by the block.  A warp's scores stay in registers as C fragments: the
// online softmax reduces each row over a quad of lanes, and the
// probabilities' C fragments are the A fragments of P V, whose sum O stays
// in registers.  fp32: 3xTF32 products; bf16 q: bf16 products for q k^T,
// the fp32 P against bf16 V in two TF32 terms.  At the d256 shape the
// bound is the bytes (0.5 ms fp32), and the kernel runs at ~15% of it:
// waiting on the tensor cores' and shared memory's latency, with 12 warps
// an SM (three blocks of ~68 KB in fp32; 8-key chunks, where 16 kept two
// blocks and ran 15% slower).  Beyond dh 128 (attn_fwd_kernel) the products
// run as fp32 FMA from shared memory, each thread a 2 x 4 block of scores
// and of the output.  A training call also writes the log2-sum-exp of each
// query row [B, H, T] and, for bf16 q, the fp32 output [B, H, T, dh], which
// the backward (attention_bwd.cu) reads.
//
// C interface (loaded with ctypes): returns a cudaError_t, 0 on success.
#include "attention.cuh"

using namespace recblr;
using namespace recblr::attn;

namespace {

// Keys a chunk of attn_fwd_mma_kernel: 8 in fp32, so that three blocks of
// ~68 KB share an SM (with 16, two of ~101 KB: the fp32 kernel waits on
// latency, and more warps an SM hide more of it); 16 in bf16, where three
// blocks fit either way and the query rows are read half as often.
template <typename Tin>
constexpr int FWD_KC = BF16_IN<Tin> ? 16 : 8;

template <typename Tin>
__host__ __device__ inline size_t fwd_mma_smem(int dh16) {
  const int ld = row_ld<Tin>(dh16);
  return walk_bytes<Tin>(1, FWD_KC<Tin>, ld);
}

// Block (row, head, tile of 64 queries); warp w its queries 16 w .. 16 w +
// 15; NT: dh's 8-column tiles the output holds (4, 8 or 16).
template <typename Tin, int NT>
__global__ void __launch_bounds__(MMA_THREADS, 3)
attn_fwd_mma_kernel(const Tin* __restrict__ q, const Tin* __restrict__ k,
                    const Tin* __restrict__ v, const int* __restrict__ lens,
                    Tin* __restrict__ out, float* __restrict__ o32, float* __restrict__ lse,
                    int H, int T, int dh, int causal, float scale, Dropout dr) {
  constexpr int KC = FWD_KC<Tin>, NC = KC / 8;
  extern __shared__ __align__(16) float smem[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem);
  const int dh16 = pad16(dh), ld = row_ld<Tin>(dh16), nt = (dh + 7) / 8;
  Tin* qs = reinterpret_cast<Tin*>(sm);  // [64][ld]  the block's queries
  const int tiles = (T + MMA_ROWS - 1) / MMA_ROWS;
  const int bh = blockIdx.x / tiles, q0 = (blockIdx.x % tiles) * MMA_ROWS;
  const int b = bh / H, h = bh % H;
  const size_t base = (size_t)bh * T * dh;
  const int lane = threadIdx.x & 31, gid = lane >> 2, t = lane & 3;
  const int i0 = q0 + (threadIdx.x >> 5) * 16 + gid;  // the query of row gid
  const RowKeys rk = row_keys(lens[b], T);
  const Tin* qw = qs + (threadIdx.x >> 5) * 16 * ld;
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f}, acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  walk<Tin, KC>(sm, qs, nullptr, q + base, nullptr, q0, k + base, v + base, 0,
                key_end(rk, causal, min(q0 + MMA_ROWS, T)), T, dh,
                [&](int c0, const Chunk<Tin>& kc, const Chunk<Tin>& vc) {
    float s[NC][4];
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    if (!rk.any)
      fma_rows_t<Tin, NC>(qw, ld, k + base + (size_t)c0 * dh, min(KC, T - c0), dh, s);
    else
      mm_rows_t<NC>(qw, ld, kc.v, kc.lo, ld, dh16, s);
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = masked_score(__fmul_rn(s[j][e], scale), i0 + (e & 2 ? 8 : 0),
                               c0 + 8 * j + 2 * t + (e & 1), rk, causal, T);
    // online softmax of rows gid (r = 0) and gid + 8 (r = 1), each over
    // the quad of lanes that holds it
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NC; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(mrow[r], mx);
      const float alpha = mrow[r] == -INFINITY ? 0.f : exp2f((mrow[r] - mn) * LOG2E);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[j][e] = s[j][e] == -INFINITY ? 0.f : exp2f((s[j][e] - mn) * LOG2E);
          sum += s[j][e];
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      lrow[r] = lrow[r] * alpha + sum;
      mrow[r] = mn;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }
    if (dr.on) {
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        float m[4];
        masks_q_rows(dr, h, b, i0, c0 + 8 * j, m);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= m[e];
      }
    }
    mm_c_w<NC, NT>(s, vc.v, vc.lo, ld, nt, acc);
  });

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + 8 * r;
    if (i >= T) continue;
    const float inv = 1.f / lrow[r];
    const size_t row = base + (size_t)i * dh;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * n + 2 * t + e;
        if (d >= dh) continue;
        const float o = acc[n][2 * r + e] * inv;
        store_act(out, row + d, o);
        if (o32 != nullptr) o32[row + d] = o;
      }
    if (lse != nullptr && t == 0) lse[(size_t)bh * T + i] = mrow[r] * LOG2E + log2f(lrow[r]);
  }
}

template <typename Tin, int NT>
cudaError_t launch_mma(const Tin* q, const Tin* k, const Tin* v, const int* lens, Tin* out,
                       float* o32, float* lse, int B, int H, int T, int dh, int causal,
                       float scale, Dropout dr, cudaStream_t stream) {
  const size_t smem = fwd_mma_smem<Tin>(pad16(dh));
  cudaError_t e = cudaFuncSetAttribute(attn_fwd_mma_kernel<Tin, NT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const unsigned blocks = (unsigned)B * H * ((T + MMA_ROWS - 1) / MMA_ROWS);
  attn_fwd_mma_kernel<Tin, NT><<<blocks, MMA_THREADS, smem, stream>>>(
      q, k, v, lens, out, o32, lse, H, T, dh, causal, scale, dr);
  return cudaGetLastError();
}

// Beyond MMA_MAX_DH: block (row, head, tile of QT queries) of 16 x 16
// threads, keys in tiles of QT, fp32 FMA from shared memory.
template <typename Tin, int QT, int NJ>
__global__ void __launch_bounds__(ATTN_THREADS)
attn_fwd_kernel(const Tin* __restrict__ q, const Tin* __restrict__ k, const Tin* __restrict__ v,
                const int* __restrict__ lens, Tin* __restrict__ out, float* __restrict__ o32,
                float* __restrict__ lse, int H, int T, int dh, int causal, float scale,
                Dropout dr) {
  constexpr int KT = QT;
  constexpr int RA = QT / 16;  // query rows of a thread: ty * RA + a
  constexpr int CB = KT / 16;  // keys of a thread in a tile: tx + 16 c
  constexpr int W = NJ * 16;   // dh padded with zero columns
  constexpr int LD = W + 1;    // row stride in shared memory
  constexpr int PL = KT + 1;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;          // [QT, LD]  the query tile
  float* kv = qs + QT * LD;  // [KT, LD]  a key tile, then its value tile
  float* ps = kv + KT * LD;  // [QT, PL]  the tile's weights (dropped)
  const int tiles = (T + QT - 1) / QT;
  const int bh = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * QT;
  const int q1 = min(q0 + QT, T);
  const int b = bh / H, h = bh % H;
  const size_t base = (size_t)bh * T * dh;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const RowKeys rk = row_keys(lens[b], T);
  const int kend = key_end(rk, causal, q1);

  load_rows<Tin, W>(q + base, q0, q1 - q0, QT, dh, LD, qs);
  float m[RA], l[RA], acc[RA][NJ];
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[a][j] = 0.f;
  }

  for (int k0 = 0; k0 < kend; k0 += KT) {
    const int kn = min(KT, kend - k0);
    __syncthreads();  // the previous tile's values are read
    load_rows<Tin, W>(k + base, k0, min(KT, T - k0), KT, dh, LD, kv);
    __syncthreads();
    float s[RA][CB];
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int c = 0; c < CB; ++c) s[a][c] = 0.f;
    for (int d = 0; d < dh; ++d) {
      float qv[RA], kk[CB];
#pragma unroll
      for (int a = 0; a < RA; ++a) qv[a] = qs[(ty * RA + a) * LD + d];
#pragma unroll
      for (int c = 0; c < CB; ++c) kk[c] = kv[(tx + 16 * c) * LD + d];
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int c = 0; c < CB; ++c) s[a][c] = fmaf(qv[a], kk[c], s[a][c]);
    }
    // online softmax: the tile's max and sum of each row over the 16
    // threads that hold it (one half-warp)
#pragma unroll
    for (int a = 0; a < RA; ++a) {
      const int i = q0 + ty * RA + a;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < CB; ++c) {
        const int j = k0 + tx + 16 * c;
        s[a][c] = j < k0 + kn ? masked_score(__fmul_rn(s[a][c], scale), i, j, rk, causal, T)
                              : -INFINITY;
        mx = fmaxf(mx, s[a][c]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(m[a], mx);
      const float alpha = m[a] == -INFINITY ? 0.f : exp2f((m[a] - mn) * LOG2E);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < CB; ++c) {
        const float e = s[a][c] == -INFINITY ? 0.f : exp2f((s[a][c] - mn) * LOG2E);
        ps[(ty * RA + a) * PL + tx + 16 * c] = e;
        sum += e;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[a] = l[a] * alpha + sum;
      m[a] = mn;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[a][j] *= alpha;
    }
    __syncthreads();  // the scores are read, the weights written
    if (dr.on) {
      for (int g = threadIdx.x; g < QT * (KT / 4); g += blockDim.x) {
        const int r = g / (KT / 4), c4 = (g % (KT / 4)) * 4;
        const uint4 w = prob_mask_words(dr, h, b, q0 + r, (k0 + c4) >> 2);
        float* row = ps + r * PL + c4;
#pragma unroll
        for (int u = 0; u < 4; ++u) row[u] *= mask_of(dr, w, u);
      }
    }
    load_rows<Tin, W>(v + base, k0, min(KT, T - k0), KT, dh, LD, kv);
    __syncthreads();
    for (int kk = 0; kk < kn; ++kk) {
      float pv[RA];
#pragma unroll
      for (int a = 0; a < RA; ++a) pv[a] = ps[(ty * RA + a) * PL + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = kv[kk * LD + tx + 16 * j];
#pragma unroll
        for (int a = 0; a < RA; ++a) acc[a][j] = fmaf(pv[a], vv, acc[a][j]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int i = q0 + ty * RA + a;
    if (i >= T) continue;
    const float inv = 1.f / l[a];
    const size_t row = base + (size_t)i * dh;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int dd = tx + 16 * j;
      if (dd >= dh) continue;
      const float o = acc[a][j] * inv;
      store_act(out, row + dd, o);
      if (o32 != nullptr) o32[row + dd] = o;
    }
    if (lse != nullptr && tx == 0) lse[(size_t)bh * T + i] = m[a] * LOG2E + log2f(l[a]);
  }
}

template <typename Tin, int QT, int NJ>
cudaError_t launch(const Tin* q, const Tin* k, const Tin* v, const int* lens, Tin* out,
                   float* o32, float* lse, int B, int H, int T, int dh, int causal, float scale,
                   Dropout dr, cudaStream_t stream) {
  constexpr int LD = NJ * 16 + 1;
  const size_t smem = sizeof(float) * ((size_t)2 * QT * LD + (size_t)QT * (QT + 1));
  cudaError_t e = cudaFuncSetAttribute(attn_fwd_kernel<Tin, QT, NJ>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const unsigned blocks = (unsigned)B * H * ((T + QT - 1) / QT);
  attn_fwd_kernel<Tin, QT, NJ><<<blocks, ATTN_THREADS, smem, stream>>>(
      q, k, v, lens, out, o32, lse, H, T, dh, causal, scale, dr);
  return cudaGetLastError();
}

// The tensor-core kernel up to dh 128 (by the 8-column tiles of dh), the
// FMA kernel (32 queries and keys a tile) beyond.
template <typename Tin>
cudaError_t attn_fwd(const Tin* q, const Tin* k, const Tin* v, const int* lens, Tin* out,
                     float* o32, float* lse, int B, int H, int T, int dh, int causal, float scale,
                     Dropout dr, cudaStream_t s) {
  if (dh <= 32)
    return launch_mma<Tin, 4>(q, k, v, lens, out, o32, lse, B, H, T, dh, causal, scale, dr, s);
  if (dh <= 64)
    return launch_mma<Tin, 8>(q, k, v, lens, out, o32, lse, B, H, T, dh, causal, scale, dr, s);
  if (dh <= MMA_MAX_DH)
    return launch_mma<Tin, 16>(q, k, v, lens, out, o32, lse, B, H, T, dh, causal, scale, dr, s);
  return launch<Tin, 32, 16>(q, k, v, lens, out, o32, lse, B, H, T, dh, causal, scale, dr, s);
}

// Blocks of the tensor-core kernel (dh <= 128) that fit on one SM.
template <typename Tin>
int fwd_blocks_per_sm(int dh) {
  const size_t smem = fwd_mma_smem<Tin>(pad16(dh));
  auto kern = dh <= 32 ? attn_fwd_mma_kernel<Tin, 4>
                       : dh <= 64 ? attn_fwd_mma_kernel<Tin, 8> : attn_fwd_mma_kernel<Tin, 16>;
  int n = 0;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, MMA_THREADS, smem);
  return e == cudaSuccess ? n : -(int)e;
}

}  // namespace

extern "C" {

// q, k, v, out: [B, H, T, dh] fp32 (bf16 == 0) or bf16, contiguous, dh <=
// 256; lens: [B] int32; o32: [B, H, T, dh] fp32 or null (the fp32 output
// a bf16 training call keeps); lse: [B, H, T] fp32 or null (a training
// call's log2-sum-exp); scale: 1 / sqrt(dh) in fp32; drop, seed, thresh,
// dscale: the probabilities' dropout (common.cuh Dropout); device: the
// card that holds them.
int recblr_attn_fwd(const void* q, const void* k, const void* v, const void* lens, void* out,
                    void* o32, void* lse, int B, int H, int T, int dh, int causal, float scale,
                    int bf16, int drop, unsigned long long seed, unsigned thresh, float dscale,
                    int device, void* stream) {
  // this library has its own (static) CUDA runtime: select the tensors' card
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const Dropout dr = make_dropout(drop, seed, thresh, dscale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ln = static_cast<const int*>(lens);
  float* o = static_cast<float*>(o32);
  float* ls = static_cast<float*>(lse);
  if (bf16) {
    using T16 = __nv_bfloat16;
    return attn_fwd(static_cast<const T16*>(q), static_cast<const T16*>(k),
                    static_cast<const T16*>(v), ln, static_cast<T16*>(out), o, ls, B, H, T, dh,
                    causal, scale, dr, s);
  }
  return attn_fwd(static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), ln, static_cast<float*>(out), o, ls, B, H, T, dh,
                  causal, scale, dr, s);
}

// Blocks an SM holds of the forward's tensor-core kernel at head width dh
// <= 128 (fp32 or bf16), or minus a cudaError_t.
int recblr_attn_fwd_blocks_per_sm(int dh, int bf16, int device) {
  if (dh < 1 || dh > MMA_MAX_DH) return -(int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return -(int)e;
  return bf16 ? fwd_blocks_per_sm<__nv_bfloat16>(dh) : fwd_blocks_per_sm<float>(dh);
}

const char* recblr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
