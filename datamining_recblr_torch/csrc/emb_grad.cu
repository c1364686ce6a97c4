// Embedding-table gradient for Hopper: out[v] = sum of g[n] over the n with
// ids[n] == v, an fp32 [V, D] sum, in a fixed order.
//
// Replaces the TPU kernel datamining_recblr_tpu/ops/embedding.py:
// _emb_grad_kernel (reached through _bwd_pallas), and serves both regimes
// of that module's _bwd (one-hot matmuls below V = 9,000, a scatter-add
// from there on): the VJP of embedding_lookup, which every single-device
// bf16 training step takes.
//
// What bounds it: at the XLong step (N = 524,288 ids, V = 329,728, D = 64,
// bf16 g) it reads 67 MB of g and writes the 84 MB table gradient, with
// one add per element of g: bound by bytes.  The trouble is the id
// distribution: PAD (id 0) fills about half of a step's ids, so one writer
// per id would serialize half of the work, and fp32 atomics would make the
// sum's order (and bits) change from run to run.  The design:
//   sort    a stable LSD radix sort of (id, n) by id, 8 bits a pass (three
//           passes for V < 2^24): per block of 2,048 ids a digit histogram,
//           one exclusive scan over (digit, block), and a stable scatter
//           that ranks equal digits with __match_any_sync within a warp
//           and per-warp counts across warps.  Each id's rows then lie
//           together, in increasing n.
//   bounds  each id's segment [start, end) by binary search.
//   pieces  one warp per piece of 128 sorted entries sums its runs in
//           order (lanes over D, four rows loaded ahead): a run whose
//           segment lies in the piece is written to out, the piece's first
//           and last runs otherwise to its partials.
//   rows    one warp per id: an empty segment writes zeros, a segment over
//           several pieces adds its partials in a fixed order (16
//           interleaved sums).
//   slices  above 512 columns the pieces and rows walk D in slices of at
//           most 512 (one sort serves them all); each column's sum is the
//           same as in a single pass.
// Every row of out is written exactly once and every sum runs in a fixed
// order, so a rerun gives the same bits.  The sums are compensated (Kahan):
// PAD's row adds some 262,000 cotangents, where a plain fp32 sum in any
// order drifts by about 1e-5 of the result.  Ids outside [0, V) are left
// out.
//
// C interface (loaded with ctypes): returns a cudaError_t, 0 on success.
#include "common.cuh"

using namespace recblr;

namespace {

constexpr int RADIX_BITS = 8;
constexpr int RADIX = 1 << RADIX_BITS;
constexpr int SORT_THREADS = 256;                      // = RADIX
constexpr int SORT_WARPS = SORT_THREADS / 32;
constexpr int ROUNDS = 8;                              // rounds of 256 ids per block
constexpr int CH = SORT_THREADS * ROUNDS;              // ids per sort block
constexpr int SCAN_T = 1024;
constexpr int PIECE = 128;                             // sorted entries per piece
constexpr int PIECE_THREADS = 256;                     // 8 pieces per block
constexpr int BATCH = 4;                               // rows loaded ahead in a piece
constexpr int CHAINS = 16;                             // partial sums in flight per row
constexpr int MAX_SLICE = 512;                         // columns a lane set holds (DPL <= 16)

// acc += v, compensated: c carries the low-order bits acc lost (Kahan).
__device__ __forceinline__ void kahan_add(float& acc, float& c, float v) {
  const float y = v - c;
  const float t = acc + y;
  c = (t - acc) - y;
  acc = t;
}

// An id outside [0, V) becomes V, which sorts after every valid id.
__device__ __forceinline__ int sort_key(int id, int V) {
  return (unsigned)id > (unsigned)V ? V : id;
}

__global__ void __launch_bounds__(SORT_THREADS)
radix_hist_kernel(const int* __restrict__ keys, int N, int V, int shift, int* __restrict__ hist,
                  int NB) {
  __shared__ int h[RADIX];
  h[threadIdx.x] = 0;
  __syncthreads();
  const int base = blockIdx.x * CH;
  for (int i = threadIdx.x; i < CH; i += SORT_THREADS) {
    const int n = base + i;
    if (n < N) atomicAdd(&h[(sort_key(keys[n], V) >> shift) & (RADIX - 1)], 1);
  }
  __syncthreads();
  hist[threadIdx.x * NB + blockIdx.x] = h[threadIdx.x];  // digit-major
}

// In-place exclusive prefix sum of a[0 .. n-1], one block: each thread
// sums a contiguous segment, the segment sums are scanned in shared
// memory, then each thread rewrites its segment.
__global__ void __launch_bounds__(SCAN_T) exclusive_scan_kernel(int* __restrict__ a, int n) {
  __shared__ int sums[SCAN_T];
  const int per = (n + SCAN_T - 1) / SCAN_T;
  const int lo = min(n, threadIdx.x * per), hi = min(n, lo + per);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += a[i];
  sums[threadIdx.x] = s;
  __syncthreads();
  for (int o = 1; o < SCAN_T; o <<= 1) {  // Hillis-Steele, inclusive
    const int v = threadIdx.x >= o ? sums[threadIdx.x - o] : 0;
    __syncthreads();
    sums[threadIdx.x] += v;
    __syncthreads();
  }
  int run = sums[threadIdx.x] - s;
  for (int i = lo; i < hi; ++i) {
    const int v = a[i];
    a[i] = run;
    run += v;
  }
}

// Stable scatter of one pass.  The block's ids go in ROUNDS rounds of 256
// in index order; within a round, a warp ranks equal digits with
// __match_any_sync and the warps before it add their counts, so an id's
// slot keeps the order of n.  vals_in == null: the value is n itself.
__global__ void __launch_bounds__(SORT_THREADS)
radix_scatter_kernel(const int* __restrict__ keys_in, const int* __restrict__ vals_in, int N,
                     int V, int shift, const int* __restrict__ offsets, int NB,
                     int* __restrict__ keys_out, int* __restrict__ vals_out) {
  __shared__ int base[RADIX];
  __shared__ int wcnt[SORT_WARPS][RADIX];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  base[threadIdx.x] = offsets[threadIdx.x * NB + blockIdx.x];
  for (int r = 0; r < ROUNDS; ++r) {
    for (int w = 0; w < SORT_WARPS; ++w) wcnt[w][threadIdx.x] = 0;
    __syncthreads();
    const int n = blockIdx.x * CH + r * SORT_THREADS + threadIdx.x;
    const bool valid = n < N;
    const int key = valid ? sort_key(keys_in[n], V) : 0;
    const int digit = valid ? (key >> shift) & (RADIX - 1) : RADIX;  // RADIX: no id
    const unsigned peers = __match_any_sync(0xffffffffu, digit);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (valid && lane == __ffs(peers) - 1) wcnt[warp][digit] = __popc(peers);
    __syncthreads();
    if (valid) {
      int slot = base[digit] + rank;
      for (int w = 0; w < warp; ++w) slot += wcnt[w][digit];
      keys_out[slot] = key;
      vals_out[slot] = vals_in ? vals_in[n] : n;
    }
    __syncthreads();
    int tot = 0;
    for (int w = 0; w < SORT_WARPS; ++w) tot += wcnt[w][threadIdx.x];
    base[threadIdx.x] += tot;
    __syncthreads();
  }
}

// seg[v] = the first sorted position whose key is >= v, for v in [0, V].
__global__ void seg_bounds_kernel(const int* __restrict__ keys, int N, int* __restrict__ seg,
                                  int V) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v > V) return;
  int lo = 0, hi = N;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (keys[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  seg[v] = lo;
}

// One warp per piece of PIECE sorted entries: sums each run of one id in
// order; writes a run whose segment lies inside the piece to out, and the
// piece's first and last runs otherwise to part_first / part_last [NP, D].
// g and out have rows of ld elements, of which this call sums D columns.
// The piece's keys and rows are staged in shared memory, and the cotangent
// rows are loaded BATCH entries ahead of their adds, so that a warp waits
// on memory once per batch, not once per entry.  Lane l holds dims l + 32 j,
// j < DPL.
template <typename Tg, int DPL>
__global__ void __launch_bounds__(PIECE_THREADS)
piece_sum_kernel(const int* __restrict__ keys, const int* __restrict__ vals,
                 const Tg* __restrict__ g, const int* __restrict__ seg,
                 float* __restrict__ part_first, float* __restrict__ part_last,
                 float* __restrict__ out, int NP, int V, int D, int ld) {
  __shared__ int sk[PIECE_THREADS / 32][PIECE], sv[PIECE_THREADS / 32][PIECE];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int p = blockIdx.x * (PIECE_THREADS / 32) + w;
  if (p >= NP) return;
  const int M = seg[V];  // the valid ids
  const int k0 = p * PIECE, n = min(PIECE, M - k0);
  if (n <= 0) return;
  for (int i = lane; i < n; i += 32) {
    sk[w][i] = keys[k0 + i];
    sv[w][i] = vals[k0 + i];
  }
  __syncwarp();
  float acc[DPL], comp[DPL];
  auto flush = [&](int v, bool first_run, bool last_run) {
    const int s = seg[v], e = seg[v + 1];
    const bool inside = s >= k0 && e <= k0 + n;
    float* dst = inside ? out + (size_t)v * ld
                        : first_run ? part_first + (size_t)p * D : nullptr;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = j * 32 + lane;
      if (d >= D) continue;
      if (dst != nullptr) dst[d] = acc[j];
      if (last_run && !inside) part_last[(size_t)p * D + d] = acc[j];
    }
  };
#pragma unroll
  for (int j = 0; j < DPL; ++j) acc[j] = comp[j] = 0.f;
  int cur = sk[w][0];
  bool first = true;
  for (int kb = 0; kb < n; kb += BATCH) {
    float buf[BATCH][DPL];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const size_t row = (size_t)sv[w][kb + u < n ? kb + u : kb] * ld;
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int d = j * 32 + lane;
        buf[u][j] = d < D ? load_act(g, row + d) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      if (kb + u >= n) break;
      const int key = sk[w][kb + u];
      if (key != cur) {
        flush(cur, first, false);
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[j] = comp[j] = 0.f;
        cur = key;
        first = false;
      }
#pragma unroll
      for (int j = 0; j < DPL; ++j) kahan_add(acc[j], comp[j], buf[u][j]);
    }
  }
  flush(cur, first, true);
}

// One warp per id v: zeros for an empty segment; for a segment over
// several pieces, the last run's partial of its first piece plus the first
// runs' partials of the following pieces.  Those partials are split
// round-robin over CHAINS compensated sums, which are then added in chain
// order: a fixed order, with CHAINS loads in flight (PAD's segment spans
// some 2,000 pieces).
__global__ void row_fix_kernel(const int* __restrict__ seg, const float* __restrict__ part_first,
                               const float* __restrict__ part_last, float* __restrict__ out,
                               int V, int D, int ld) {
  const int lane = threadIdx.x % 32;
  const int v = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (v >= V) return;
  const int s = seg[v], e = seg[v + 1];
  float* dst = out + (size_t)v * ld;
  if (s == e) {
    for (int d = lane; d < D; d += 32) dst[d] = 0.f;
    return;
  }
  const int p0 = s / PIECE, p1 = (e - 1) / PIECE;
  if (p0 == p1) return;  // written by piece_sum_kernel
  for (int d = lane; d < D; d += 32) {
    float acc[CHAINS], comp[CHAINS];
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) acc[c] = comp[c] = 0.f;
    for (int q = p0 + 1; q <= p1; q += CHAINS) {
      float x[CHAINS];
#pragma unroll
      for (int c = 0; c < CHAINS; ++c)
        x[c] = q + c <= p1 ? part_first[(size_t)(q + c) * D + d] : 0.f;
#pragma unroll
      for (int c = 0; c < CHAINS; ++c) kahan_add(acc[c], comp[c], x[c]);
    }
    float tot = part_last[(size_t)p0 * D + d], tc = 0.f;
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) kahan_add(tot, tc, acc[c]);
    dst[d] = tot;
  }
}

template <typename Tg>
cudaError_t emb_grad(const int* ids, const Tg* g, float* out, int* keys_a, int* vals_a,
                     int* keys_b, int* vals_b, int* hist, int* seg, float* part, int N, int V,
                     int D, cudaStream_t stream) {
  cudaError_t e;
  const int NB = (N + CH - 1) / CH;
  int bits = 0;
  while ((V >> bits) > 0) ++bits;  // the keys are in [0, V]
  const int passes = bits > RADIX_BITS ? (bits + RADIX_BITS - 1) / RADIX_BITS : 1;
  const int* kin = ids;
  const int* vin = nullptr;
  for (int p = 0; p < passes; ++p) {
    int* kout = p % 2 == 0 ? keys_a : keys_b;
    int* vout = p % 2 == 0 ? vals_a : vals_b;
    const int shift = p * RADIX_BITS;
    radix_hist_kernel<<<NB, SORT_THREADS, 0, stream>>>(kin, N, V, shift, hist, NB);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    exclusive_scan_kernel<<<1, SCAN_T, 0, stream>>>(hist, RADIX * NB);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    radix_scatter_kernel<<<NB, SORT_THREADS, 0, stream>>>(kin, vin, N, V, shift, hist, NB, kout,
                                                          vout);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    kin = kout;
    vin = vout;
  }
  seg_bounds_kernel<<<(V + 1 + 255) / 256, 256, 0, stream>>>(kin, N, seg, V);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int NP = (N + PIECE - 1) / PIECE;
  const dim3 pg((NP + PIECE_THREADS / 32 - 1) / (PIECE_THREADS / 32));
  // one slice of at most MAX_SLICE columns at a time; the partials are
  // reused, in stream order
  for (int d0 = 0; d0 < D; d0 += MAX_SLICE) {
    const int W = min(MAX_SLICE, D - d0);
    float* part_first = part;
    float* part_last = part + (size_t)NP * W;
    const Tg* gs = g + d0;
    float* os = out + d0;
    const int dpl = (W + 31) / 32;
    if (dpl <= 1)
      piece_sum_kernel<Tg, 1><<<pg, PIECE_THREADS, 0, stream>>>(kin, vin, gs, seg, part_first,
                                                                part_last, os, NP, V, W, D);
    else if (dpl <= 2)
      piece_sum_kernel<Tg, 2><<<pg, PIECE_THREADS, 0, stream>>>(kin, vin, gs, seg, part_first,
                                                                part_last, os, NP, V, W, D);
    else if (dpl <= 4)
      piece_sum_kernel<Tg, 4><<<pg, PIECE_THREADS, 0, stream>>>(kin, vin, gs, seg, part_first,
                                                                part_last, os, NP, V, W, D);
    else if (dpl <= 8)
      piece_sum_kernel<Tg, 8><<<pg, PIECE_THREADS, 0, stream>>>(kin, vin, gs, seg, part_first,
                                                                part_last, os, NP, V, W, D);
    else
      piece_sum_kernel<Tg, 16><<<pg, PIECE_THREADS, 0, stream>>>(kin, vin, gs, seg, part_first,
                                                                 part_last, os, NP, V, W, D);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    row_fix_kernel<<<(V + 7) / 8, 256, 0, stream>>>(seg, part_first, part_last, os, V, W, D);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// ids: [N] int32; g: [N, D] fp32 (bf16 == 0) or bf16; out: [V, D] fp32,
// every row written; keys_a, vals_a, keys_b, vals_b: [N] int32 scratch;
// hist: [256 * ceil(N / 2048)] int32 scratch; seg: [V + 1] int32 scratch;
// part: [2, ceil(N / 128), min(D, 512)] fp32 scratch; device: the card.
int recblr_emb_grad(const void* ids, const void* g, void* out, void* keys_a, void* vals_a,
                    void* keys_b, void* vals_b, void* hist, void* seg, void* part, int N, int V,
                    int D, int bf16, int device, void* stream) {
  // this library has its own (static) CUDA runtime: select the tensors' card
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* i = static_cast<const int*>(ids);
  float* o = static_cast<float*>(out);
  int* ka = static_cast<int*>(keys_a);
  int* va = static_cast<int*>(vals_a);
  int* kb = static_cast<int*>(keys_b);
  int* vb = static_cast<int*>(vals_b);
  int* h = static_cast<int*>(hist);
  int* sg = static_cast<int*>(seg);
  float* pt = static_cast<float*>(part);
  if (bf16)
    return emb_grad(i, static_cast<const __nv_bfloat16*>(g), o, ka, va, kb, vb, h, sg, pt, N, V,
                    D, s);
  return emb_grad(i, static_cast<const float*>(g), o, ka, va, kb, vb, h, sg, pt, N, V, D, s);
}

const char* recblr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
