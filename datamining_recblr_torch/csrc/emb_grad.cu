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
// sum's order (and bits) change from run to run.  The design, one launch
// of each kernel below (the last three once per slice of columns):
//   sort    a stable LSD radix sort of (id, n) by id with the fewest passes
//           of at most 10 bits (two for V < 2^20: XLong and the bench
//           shape).  radix_hist_kernel reads the ids once (int32 or int64)
//           for the first pass's digit counts per tile of 2,048 ids and
//           the count of ids outside [0, V); radix_scan_kernel turns a
//           pass's counts into per-tile offsets, one warp per digit, and
//           clears the next pass's counts; radix_scatter_kernel has each
//           warp count the digits of its 256 contiguous ids, turns the
//           counts into per-warp slot bases, then places the ids, ranking
//           equal digits with __match_any_sync, and counts the next pass's
//           digits per tile as it places them (aggregated a warp: PAD's
//           keys would queue on a few counters).  Each id's rows then lie
//           together, in increasing n.
//   pieces  one row segment of L lanes per piece of 32 sorted entries
//           sums its runs in order from 16-byte loads of g, eight rows
//           ahead (L = 8 lanes a 64-wide bf16 row, so a warp loads four
//           rows an instruction): a run whose segment lies in the piece is
//           written to out, a first run that continues an earlier piece's
//           segment to part_first, a last run that starts a segment going
//           on to part_last.  The neighbours' keys decide; each segment's
//           first and last run also write its bounds, so no search is
//           needed anywhere.
//   groups  one warp per group of 64 pieces finds, with ballots over the
//           pieces' first keys, the pieces at the group's start that
//           continue the segment entering it and those at its end that
//           continue the segment leaving it, and sums each run of partials
//           in piece order (gpre, gsuf).
//   rows    one row segment per id, up to L ids a segment in turn (their
//           bounds loaded at once): no segment writes zeros, one inside a
//           piece was written, one over several pieces adds, in order, its
//           first piece's last run, then either the pieces' first runs
//           (inside one group) or one group sum a group it crosses.  PAD's
//           segment (~8,200 pieces at XLong) is so summed by ~130 warps in
//           parallel and ~130 adds in one, where one warp used to add
//           every piece.
//   slices  above 512 columns the pieces, groups and rows walk D in
//           slices of at most 512 (one sort serves them all); each
//           column's sum is the same as in a single pass.
// Every row of out is written exactly once and every sum runs in a fixed
// order that depends only on the ids, so a rerun gives the same bits.  The
// sums are compensated (Kahan) at each level, and each level hands on its
// compensated value (acc - c): PAD's row adds some 262,000 cotangents,
// where a plain fp32 sum drifts by about 1e-5 of the result.  Ids outside
// [0, V) are left out.  Scratch is one buffer, sized by
// ops/embedding.py:scratch_bytes (the same plan as make_plan below).
//
// C interface (loaded with ctypes): returns a cudaError_t, 0 on success.
#include <limits.h>
#include <stdint.h>

#include "common.cuh"

using namespace recblr;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_DIGIT_BITS = 10;
constexpr int MAX_RADIX = 1 << MAX_DIGIT_BITS;
constexpr int SORT_THREADS = 256;
constexpr int SORT_WARPS = SORT_THREADS / 32;
constexpr int TILE = 2048;                    // ids per sort block
constexpr int ROUNDS = TILE / SORT_THREADS;   // rounds a thread takes
constexpr int WARP_IDS = TILE / SORT_WARPS;   // ids a warp of the scatter owns
constexpr int PIECE = 32;                     // sorted entries per piece
constexpr int GROUP = 64;                     // pieces per group
constexpr int SUM_THREADS = 256;
constexpr int MAX_SLICE = 512;                // columns summed at a time

// The sort passes, digit width, tiles, pieces, groups and the scratch
// layout of one call (mirrored by ops/embedding.py:sort_plan and
// scratch_bytes), and the card's SMs (which size the row sums' blocks).
struct Plan {
  int passes, width, radix, tiles, pieces, groups, slice, sms;
  size_t ints, words;  // int words before the fp32 partials; all words
};

inline Plan make_plan(int N, int V, int D) {
  Plan p;
  int bits = 0;
  while ((V >> bits) > 0) ++bits;  // the keys are in [0, V]
  p.passes = (bits + MAX_DIGIT_BITS - 1) / MAX_DIGIT_BITS;
  p.width = (bits + p.passes - 1) / p.passes;
  p.radix = 1 << p.width;
  p.tiles = (N + TILE - 1) / TILE;
  p.pieces = (N + PIECE - 1) / PIECE;
  p.groups = (p.pieces + GROUP - 1) / GROUP;
  p.slice = D < MAX_SLICE ? D : MAX_SLICE;
  // keys and vals twice; per pass the tile counts and the digit totals;
  // per tile the ids outside [0, V), and their total; each id's segment
  // start and end
  const size_t ints = 4 * (size_t)N + (size_t)p.passes * p.radix * p.tiles +
                      (size_t)p.passes * p.radix + p.tiles + 1 + 2 * (size_t)V;
  p.ints = (ints + 3) / 4 * 4;  // the fp32 partials start 16-byte aligned
  p.words = p.ints + (2 * (size_t)p.pieces + 2 * (size_t)p.groups) * p.slice;
  return p;
}

// The sorted keys and values, the count of ids outside [0, V) and each
// id's segment [seg_start, seg_end) (seg_start -1: no id), and the fp32
// partial rows of one slice.
struct Sorted {
  const int *keys, *vals, *invalid;
  int *seg_start, *seg_end;
};
struct Partials {
  float *first, *last, *gpre, *gsuf;
};

// An id outside [0, V) becomes V, which sorts after every valid id.
__device__ __forceinline__ int sort_key(int id, int V) {
  return (unsigned)id > (unsigned)V ? V : id;
}
__device__ __forceinline__ int sort_key(long long id, int V) {
  return (unsigned long long)id > (unsigned long long)V ? V : (int)id;
}

// Exclusive prefix sums of a[0 .. n) (n <= 4 * SORT_THREADS) into s, by the
// whole block; wsum: SORT_WARPS ints of shared scratch.
__device__ void block_exclusive_scan(const int* __restrict__ a, int* s, int n, int* wsum) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int lo = threadIdx.x * 4;
  int v[4], sum = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = lo + i < n ? a[lo + i] : 0;
    sum += v[i];
  }
  int inc = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) wsum[warp] = inc;
  __syncthreads();
  int run = inc - sum;
  for (int w = 0; w < warp; ++w) run += wsum[w];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (lo + i < n) s[lo + i] = run;
    run += v[i];
  }
  __syncthreads();
}

// Block t < tiles: the first pass's digit counts of its TILE ids
// (hist[d * tiles + t]) and how many of them lie outside [0, V) (bad[t]).
// Every block also marks a share of the ids' segment starts as empty (-1),
// for piece_sum_kernel to fill.
template <typename TI>
__global__ void __launch_bounds__(SORT_THREADS)
radix_hist_kernel(const TI* __restrict__ ids, int N, int V, int radix, int tiles,
                  int* __restrict__ hist, int* __restrict__ bad, int* __restrict__ seg_start) {
  __shared__ int h[MAX_RADIX];
  __shared__ int nbad;
  const int lane = threadIdx.x % 32;
  for (size_t v = (size_t)blockIdx.x * SORT_THREADS + threadIdx.x; v < (size_t)V;
       v += (size_t)gridDim.x * SORT_THREADS)
    seg_start[v] = -1;
  if (blockIdx.x >= tiles) return;
  for (int d = threadIdx.x; d < radix; d += SORT_THREADS) h[d] = 0;
  if (threadIdx.x == 0) nbad = 0;
  __syncthreads();
  int mine = 0;
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const long long n = (long long)blockIdx.x * TILE + r * SORT_THREADS + threadIdx.x;
    const int key = n < N ? sort_key(ids[n], V) : -1;
    mine += key == V;
    if (key >= 0) atomicAdd(&h[key & (radix - 1)], 1);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mine += __shfl_xor_sync(FULL, mine, o);
  if (lane == 0 && mine) atomicAdd(&nbad, mine);
  __syncthreads();
  for (int d = threadIdx.x; d < radix; d += SORT_THREADS)
    hist[(size_t)d * tiles + blockIdx.x] = h[d];
  if (threadIdx.x == 0) bad[blockIdx.x] = nbad;
}

// One warp per digit d of a pass: its counts over the tiles become
// exclusive offsets within the digit (in place) and its total goes to
// totals[d]; the next pass's counts of d are cleared (next != null).  The
// warp of digit 0 also adds the tiles' counts of ids outside [0, V)
// (bad != null: the first pass) into *invalid.
__global__ void __launch_bounds__(SORT_THREADS)
radix_scan_kernel(int* __restrict__ hist, int* __restrict__ totals, int radix, int tiles,
                  int* __restrict__ next, const int* __restrict__ bad,
                  int* __restrict__ invalid) {
  const int lane = threadIdx.x % 32;
  const int d = blockIdx.x * SORT_WARPS + threadIdx.x / 32;
  if (d >= radix) return;
  int* row = hist + (size_t)d * tiles;
  int run = 0;
  for (int t0 = 0; t0 < tiles; t0 += 32) {
    const int t = t0 + lane;
    const int c = t < tiles ? row[t] : 0;
    int inc = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, inc, o);
      if (lane >= o) inc += y;
    }
    if (t < tiles) {
      row[t] = run + inc - c;
      if (next != nullptr) next[(size_t)d * tiles + t] = 0;
    }
    run += __shfl_sync(FULL, inc, 31);
  }
  if (lane == 0) totals[d] = run;
  if (bad != nullptr && d == 0) {
    int s = 0;
    for (int t = lane; t < tiles; t += 32) s += bad[t];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
    if (lane == 0) *invalid = s;
  }
}

// Stable scatter of one pass, block t over its TILE ids: warp w owns the
// WARP_IDS ids from t * TILE + w * WARP_IDS on, ROUNDS rounds of 32 in
// index order.  Each warp first counts its digits (equal digits of a round
// add once, __match_any_sync); then, per digit, the warps' counts become
// their slot bases in warp order after the digit's base (the exclusive sum
// of the totals of the digits below it plus this tile's offset); then each
// warp walks its ids again and places them, ranking equal digits of a
// round by lane (one __match_any_sync a round serves both walks).  So an
// id's slot keeps the order of n, with five block barriers a tile.
// keys_in are the ids (TI, first pass: the value is n itself, vals_in ==
// null) or the previous pass's keys.  next != null: each placed key's next
// digit is counted for the tile its slot falls in (equal (digit, tile)
// pairs of a warp add once).
template <typename TI>
__global__ void __launch_bounds__(SORT_THREADS)
radix_scatter_kernel(const TI* __restrict__ keys_in, const int* __restrict__ vals_in, int N,
                     int V, int shift, int radix, int tiles, const int* __restrict__ offsets,
                     const int* __restrict__ totals, int* __restrict__ keys_out,
                     int* __restrict__ vals_out, int* __restrict__ next, int next_shift) {
  __shared__ int base[MAX_RADIX];
  __shared__ int cnt[SORT_WARPS][MAX_RADIX];  // the warps' counts, then their slot bases
  __shared__ int wsum[SORT_WARPS];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long n0 = (long long)blockIdx.x * TILE + warp * WARP_IDS + lane;
  int key[ROUNDS], val[ROUNDS], digit[ROUNDS];
  unsigned peers[ROUNDS];
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const long long n = n0 + r * 32;
    key[r] = n < N ? sort_key(keys_in[n], V) : -1;
    val[r] = n < N ? (vals_in != nullptr ? vals_in[n] : (int)n) : 0;
    digit[r] = key[r] >= 0 ? (key[r] >> shift) & (radix - 1) : -1;
  }
  int off[MAX_RADIX / SORT_THREADS];  // this tile's offsets of digits tid + k * 256
#pragma unroll
  for (int k = 0; k < MAX_RADIX / SORT_THREADS; ++k) {
    const int d = threadIdx.x + k * SORT_THREADS;
    off[k] = d < radix ? offsets[(size_t)d * tiles + blockIdx.x] : 0;
  }
  for (int i = threadIdx.x; i < SORT_WARPS * radix; i += SORT_THREADS)
    cnt[i / radix][i % radix] = 0;
  block_exclusive_scan(totals, base, radix, wsum);  // also orders the clearing
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    peers[r] = __match_any_sync(FULL, digit[r]);
    if (digit[r] >= 0 && lane == __ffs(peers[r]) - 1) cnt[warp][digit[r]] += __popc(peers[r]);
    __syncwarp();
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < MAX_RADIX / SORT_THREADS; ++k) {
    const int d = threadIdx.x + k * SORT_THREADS;
    if (d >= radix) break;
    int run = base[d] + off[k];
    for (int w = 0; w < SORT_WARPS; ++w) {
      const int c = cnt[w][d];
      cnt[w][d] = run;
      run += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const int d = digit[r];
    int cell = -1;
    if (d >= 0) {
      const int slot = cnt[warp][d] + __popc(peers[r] & ((1u << lane) - 1u));
      keys_out[slot] = key[r];
      vals_out[slot] = val[r];
      if (next != nullptr) cell = ((key[r] >> next_shift) & (radix - 1)) * tiles + slot / TILE;
    }
    if (next != nullptr) {  // PAD's keys would otherwise queue on a few counters
      const unsigned same = __match_any_sync(FULL, cell);
      if (cell >= 0 && lane == __ffs(same) - 1) atomicAdd(&next[cell], __popc(same));
    }
    __syncwarp();
    if (d >= 0 && lane == __ffs(peers[r]) - 1) cnt[warp][d] += __popc(peers[r]);
    __syncwarp();
  }
}

// VEC consecutive fp32 values p[c .. c+VEC) of a row, zero at or past W;
// 16-byte accesses where `vec` (the row is 16-byte aligned) and the chunk
// lies inside W.
template <int VEC>
__device__ __forceinline__ void load_f(const float* p, int c, int W, bool vec, float (&v)[VEC]) {
  if (vec && c + VEC <= W) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + c + i);
      v[i] = q.x, v[i + 1] = q.y, v[i + 2] = q.z, v[i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = c + i < W ? p[c + i] : 0.f;
  }
}
template <int VEC>
__device__ __forceinline__ void store_f(float* p, int c, int W, bool vec, const float (&v)[VEC]) {
  if (vec && c + VEC <= W) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      *reinterpret_cast<float4*>(p + c + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      if (c + i < W) p[c + i] = v[i];
  }
}
// A 16-byte chunk of a cotangent row as raw bits (four fp32 or eight bf16
// values from column c on, zero at or past W), and its values.
__device__ __forceinline__ uint4 load_raw(const float* p, int c, int W, bool vec) {
  if (vec && c + 4 <= W) return *reinterpret_cast<const uint4*>(p + c);
  unsigned u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) u[i] = c + i < W ? __float_as_uint(p[c + i]) : 0u;
  return make_uint4(u[0], u[1], u[2], u[3]);
}
__device__ __forceinline__ uint4 load_raw(const __nv_bfloat16* p, int c, int W, bool vec) {
  if (vec && c + 8 <= W) return *reinterpret_cast<const uint4*>(p + c);
  const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
  unsigned u[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) u[i] = c + i < W ? h[c + i] : 0u;
  return make_uint4(u[0] | u[1] << 16, u[2] | u[3] << 16, u[4] | u[5] << 16, u[6] | u[7] << 16);
}
__device__ __forceinline__ void unpack(uint4 q, float (&v)[4]) {
  v[0] = __uint_as_float(q.x), v[1] = __uint_as_float(q.y);
  v[2] = __uint_as_float(q.z), v[3] = __uint_as_float(q.w);
}
__device__ __forceinline__ void unpack(uint4 q, float (&v)[8]) {
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// acc += v, compensated: c carries the low-order bits acc lost (Kahan);
// the sum is acc - c.
__device__ __forceinline__ void kahan_add(float& acc, float& c, float v) {
  const float y = v - c;
  const float t = acc + y;
  c = (t - acc) - y;
  acc = t;
}

// One row segment of L lanes per piece of PIECE sorted entries; lane sl
// holds the slice's chunks sl + k * L (k < NG) of VEC columns.  The
// piece's keys and rows are loaded at once (entry j * L + sl in slot j)
// and handed round with shuffles; the cotangent rows are loaded R entries
// ahead of their adds, as raw 16-byte chunks.  A run is written where its
// segment ends: to out when the segment lies in the piece, to part_first
// when it is the first run and continues an earlier piece's segment, to
// part_last when it is the last run and starts a segment that goes on.  A
// run that starts its segment writes the segment's start to seg_start, one
// that ends it the end to seg_end.  g, out: rows of ld elements, this call
// sums W columns; part_*: rows of W.
template <typename Tg, int L, int NG>
__global__ void __launch_bounds__(SUM_THREADS)
piece_sum_kernel(const int* __restrict__ keys, const int* __restrict__ vals,
                 const Tg* __restrict__ g, const int* __restrict__ invalid,
                 float* __restrict__ part_first, float* __restrict__ part_last,
                 float* __restrict__ out, int* __restrict__ seg_start, int* __restrict__ seg_end,
                 int N, int W, int ld, bool vg, bool vo, bool vp) {
  constexpr int VEC = 16 / sizeof(Tg);
  constexpr int PER = PIECE / L;
  constexpr int R = 8 / NG;
  const int sl = threadIdx.x % L;
  const long long p = ((long long)blockIdx.x * SUM_THREADS + threadIdx.x) / L;
  const long long k0 = p * PIECE;
  const int M = N - *invalid;
  const int n = (int)max(0LL, min((long long)PIECE, M - k0));
  int kk[PER], vv[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = j * L + sl;
    kk[j] = i < n ? keys[k0 + i] : -1;
    vv[j] = i < n ? vals[k0 + i] : 0;
  }
  const int prev = n > 0 && k0 > 0 ? keys[k0 - 1] : -2;
  const int next = n > 0 && k0 + n < M ? keys[k0 + n] : -2;
  float acc[NG][VEC], comp[NG][VEC];
#pragma unroll
  for (int k = 0; k < NG; ++k)
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[k][i] = comp[k][i] = 0.f;
  int cur = __shfl_sync(FULL, kk[0], 0, L), run = 0;
  // the run [run, end) of key cur ends; last: at the piece's end
  auto flush = [&](int end, bool last) {
    const bool before = run == 0 && prev == cur;
    const bool goes_on = last && next == cur;
    if (sl == 0) {
      if (!before) seg_start[cur] = (int)k0 + run;
      if (!goes_on) seg_end[cur] = (int)k0 + end;
    }
    float* dst = before    ? part_first + (size_t)p * W
                 : goes_on ? part_last + (size_t)p * W
                           : out + (size_t)cur * ld;
    const bool vec = before || goes_on ? vp : vo;
#pragma unroll
    for (int k = 0; k < NG; ++k) {
      const int c = (sl + k * L) * VEC;
      if (c >= W) continue;
      float r[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) r[i] = acc[k][i] - comp[k][i];
      store_f<VEC>(dst, c, W, vec, r);
    }
  };
#pragma unroll
  for (int b = 0; b < PIECE; b += R) {
    uint4 buf[R][NG];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int i = b + u;
      const int row = __shfl_sync(FULL, vv[i / L], i % L, L);
#pragma unroll
      for (int k = 0; k < NG; ++k) {
        const int c = (sl + k * L) * VEC;
        buf[u][k] = i < n && c < W ? load_raw(g + (size_t)row * ld, c, W, vg)
                                   : make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int i = b + u;
      const int key = __shfl_sync(FULL, kk[i / L], i % L, L);
      if (i >= n) continue;
      if (key != cur) {
        flush(i, false);
#pragma unroll
        for (int k = 0; k < NG; ++k)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[k][e] = comp[k][e] = 0.f;
        cur = key;
        run = i;
      }
#pragma unroll
      for (int k = 0; k < NG; ++k) {
        float x[VEC];
        unpack(buf[u][k], x);
#pragma unroll
        for (int e = 0; e < VEC; ++e) kahan_add(acc[k][e], comp[k][e], x[e]);
      }
    }
  }
  if (n > 0) flush(n, true);
}

// Rows src(0) .. src(count - 1) of W fp32 columns summed in that order
// (compensated), U rows loaded ahead; lane sl of a segment of L holds
// chunks sl + k * L of four columns.
template <int L, int NG, typename Src>
__device__ __forceinline__ void sum_rows(Src src, int count, int sl, int W, bool vp,
                                         float (&res)[NG][4]) {
  constexpr int U = NG >= 8 ? 1 : 8 / NG;
  float acc[NG][4], comp[NG][4];
#pragma unroll
  for (int k = 0; k < NG; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[k][i] = comp[k][i] = 0.f;
  for (int i0 = 0; i0 < count; i0 += U) {
    float buf[U][NG][4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int k = 0; k < NG; ++k) {
        const int c = (sl + k * L) * 4;
        if (i0 + u < count && c < W) {
          load_f<4>(src(i0 + u), c, W, vp, buf[u][k]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) buf[u][k][e] = 0.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (i0 + u >= count) break;
#pragma unroll
      for (int k = 0; k < NG; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) kahan_add(acc[k][e], comp[k][e], buf[u][k][e]);
    }
  }
#pragma unroll
  for (int k = 0; k < NG; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) res[k][i] = acc[k][i] - comp[k][i];
}

template <int L, int NG>
__device__ __forceinline__ void store_row(float* p, int sl, int W, bool vec,
                                          const float (&res)[NG][4]) {
#pragma unroll
  for (int k = 0; k < NG; ++k) {
    const int c = (sl + k * L) * 4;
    if (c < W) store_f<4>(p, c, W, vec, res[k]);
  }
}

// One warp per group j of GROUP pieces [q_lo, q_hi]: gpre[j] sums, in
// piece order, the first runs of the pieces from q_lo on that continue the
// segment entering the group; gsuf[j] those of the pieces up to q_hi that
// continue the segment of q_hi's first entry.  The warp reads the first
// key of each piece (two a lane) and finds both ranges with ballots; then
// row segments of L lanes sum them (the prefix and the suffix side by side
// where L <= 16).  Either is left unwritten where no piece continues; a
// group inside one segment writes the same sum to both.
template <int L, int NG>
__global__ void __launch_bounds__(SUM_THREADS)
group_sum_kernel(const int* __restrict__ keys, const int* __restrict__ invalid,
                 const float* __restrict__ part_first, float* __restrict__ gpre,
                 float* __restrict__ gsuf, int N, int W, bool vp) {
  static_assert(GROUP == 64, "two pieces a lane");
  const int lane = threadIdx.x % 32;
  const long long j = ((long long)blockIdx.x * SUM_THREADS + threadIdx.x) / 32;
  const int M = N - *invalid;
  const int np = (M + PIECE - 1) / PIECE;  // the pieces holding valid ids
  if (j * GROUP >= np) return;
  const int q_lo = (int)(j * GROUP), q_hi = min(np, q_lo + GROUP) - 1;
  int fk[2];
  bool cont[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = q_lo + lane + 32 * h;
    fk[h] = q <= q_hi ? keys[(size_t)q * PIECE] : INT_MAX;  // past the group: no id
    cont[h] = q <= q_hi && q > 0 && keys[(size_t)q * PIECE - 1] == fk[h];
  }
  const int v = __shfl_sync(FULL, fk[0], 0);
  const int last = q_hi - q_lo;
  const int w = __shfl_sync(FULL, last < 32 ? fk[0] : fk[1], last % 32);
  const unsigned ne0 = __ballot_sync(FULL, fk[0] != v), ne1 = __ballot_sync(FULL, fk[1] != v);
  const unsigned eq0 = __ballot_sync(FULL, fk[0] == w), eq1 = __ballot_sync(FULL, fk[1] == w);
  const int pre_end = !__shfl_sync(FULL, cont[0], 0) ? q_lo
                      : q_lo + (ne0 ? __ffs(ne0) - 1 : ne1 ? 32 + __ffs(ne1) - 1 : GROUP);
  const int first_w = eq0 ? __ffs(eq0) - 1 : 32 + __ffs(eq1) - 1;
  const bool w_cont = __shfl_sync(FULL, first_w < 32 ? cont[0] : cont[1], first_w % 32);
  const int suf = q_lo + first_w + (w_cont ? 0 : 1);  // w's segment starts at suf otherwise
  const bool both = pre_end > q_lo && suf == q_lo;     // the whole group continues one segment
  const int sl = lane % L;
  auto row = [&](int q) { return part_first + (size_t)q * W; };
  float res[NG][4];
  for (int task = lane / L; task < 2; task += 32 / L) {
    if (task == 0 && pre_end > q_lo) {
      sum_rows<L, NG>([&](int i) { return row(q_lo + i); }, pre_end - q_lo, sl, W, vp, res);
      store_row<L, NG>(gpre + (size_t)j * W, sl, W, vp, res);
      if (both) store_row<L, NG>(gsuf + (size_t)j * W, sl, W, vp, res);
    }
    if (task == 1 && !both && suf <= q_hi) {
      sum_rows<L, NG>([&](int i) { return row(suf + i); }, q_hi + 1 - suf, sl, W, vp, res);
      store_row<L, NG>(gsuf + (size_t)j * W, sl, W, vp, res);
    }
  }
}

// Block b: SUBS * iters ids from v0 = b * SUBS * iters, one row segment of
// L lanes for ids v0 + k * SUBS + sub (k < iters <= L); lane k of the
// segment loads the k-th id's segment [s, e) from seg_start and seg_end
// (s = -1: empty, zeros), so a segment waits on memory once for all its
// ids.  A segment inside a piece was written by piece_sum_kernel; one over
// the pieces p0 < p1 adds, in this order, p0's last run and then, with
// a = p0 + 1 in group ga and p1 in group gz:
//   ga == gz: gpre[ga] if a starts the group, gsuf[ga] if p1 ends it, else
//             the first runs of pieces a .. p1;
//   ga <  gz: gpre[ga] or gsuf[ga] (a starts the group or not), gpre of
//             each group between, gpre[gz].
template <int L, int NG>
__global__ void __launch_bounds__(SUM_THREADS)
row_sum_kernel(const int* __restrict__ seg_start, const int* __restrict__ seg_end,
               const int* __restrict__ invalid, const float* __restrict__ part_first,
               const float* __restrict__ part_last, const float* __restrict__ gpre,
               const float* __restrict__ gsuf, float* __restrict__ out, int N, int V, int W,
               int ld, bool vo, bool vp, int iters) {
  constexpr int SUBS = SUM_THREADS / L;
  const int sl = threadIdx.x % L, sub = threadIdx.x / L;
  const int np = (N - *invalid + PIECE - 1) / PIECE;
  const long long v0 = (long long)blockIdx.x * SUBS * iters + sub;
  const long long mine = v0 + (long long)sl * SUBS;
  const bool has = sl < iters && mine < V;
  const int s_k = has ? seg_start[mine] : -1;
  const int e_k = has && s_k >= 0 ? seg_end[mine] : 0;
  for (int k = 0; k < iters; ++k) {
    const long long v = v0 + (long long)k * SUBS;
    const int s = __shfl_sync(FULL, s_k, k, L), e = __shfl_sync(FULL, e_k, k, L);
    if (v >= V) continue;
    float* dst = out + (size_t)v * ld;
    float res[NG][4];
    if (s < 0) {
#pragma unroll
      for (int q = 0; q < NG; ++q)
#pragma unroll
        for (int c = 0; c < 4; ++c) res[q][c] = 0.f;
      store_row<L, NG>(dst, sl, W, vo, res);
      continue;
    }
    const int p0 = s / PIECE, p1 = (e - 1) / PIECE;
    if (p0 == p1) continue;
    const int a = p0 + 1, ga = a / GROUP, gz = p1 / GROUP;
    const float* last = part_last + (size_t)p0 * W;
    const float* head = (a % GROUP == 0 ? gpre : gsuf) + (size_t)ga * W;
    if (ga < gz || a % GROUP == 0 || p1 == min(np, (ga + 1) * GROUP) - 1)
      sum_rows<L, NG>([&](int q) {
        return q == 0 ? last : q == 1 ? head : gpre + (size_t)(ga + q - 1) * W;
      }, gz - ga + 2, sl, W, vp, res);
    else
      sum_rows<L, NG>([&](int q) {
        return q == 0 ? last : part_first + (size_t)(a + q - 1) * W;
      }, p1 - a + 2, sl, W, vp, res);
    store_row<L, NG>(dst, sl, W, vo, res);
  }
}

// The pieces, groups and rows of one slice of W columns, with segments of L
// lanes and NG chunks a lane (VEC columns a chunk in the pieces, four in
// the groups and rows).
template <typename Tg, int L, int NG, int L4, int NG4>
cudaError_t sum_slice(const Sorted& st, const Tg* g, const Partials& pa, float* out,
                      const Plan& pl, int N, int V, int W, int ld, bool vg, bool vo,
                      cudaStream_t stream) {
  const bool vp = W % 4 == 0;
  auto blocks = [](size_t threads) { return (unsigned)((threads + SUM_THREADS - 1) / SUM_THREADS); };
  piece_sum_kernel<Tg, L, NG><<<blocks((size_t)pl.pieces * L), SUM_THREADS, 0, stream>>>(
      st.keys, st.vals, g, st.invalid, pa.first, pa.last, out, st.seg_start, st.seg_end, N, W,
      ld, vg, vo, vp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  group_sum_kernel<L4, NG4><<<blocks((size_t)pl.groups * 32), SUM_THREADS, 0, stream>>>(
      st.keys, st.invalid, pa.first, pa.gpre, pa.gsuf, N, W, vp);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  // ids a row segment takes in turn: up to L, as long as four blocks an SM
  // stay busy
  constexpr int SUBS = SUM_THREADS / L4;
  const long long fill = (long long)SUBS * 4 * pl.sms;
  const int iters = (int)min((long long)L4, max(1LL, (V + fill - 1) / fill));
  const long long per_block = (long long)SUBS * iters;
  row_sum_kernel<L4, NG4><<<(unsigned)((V + per_block - 1) / per_block), SUM_THREADS, 0,
                            stream>>>(st.seg_start, st.seg_end, st.invalid, pa.first, pa.last,
                                      pa.gpre, pa.gsuf, out, N, V, W, ld, vo, vp, iters);
  return cudaGetLastError();
}

// The fewest lanes (a power of two, at most 32) whose chunks of `per`
// columns cover w columns, one chunk a lane where 32 lanes do not suffice
// for that (then two or four).
inline int lanes_for(int w, int per) {
  const int chunks = (w + per - 1) / per;
  int l = 1;
  while (l < chunks && l < 32) l *= 2;
  return l;
}

template <typename Tg, int L, int NG>
cudaError_t sum_slice_l4(const Sorted& st, const Tg* g, const Partials& pa, float* out,
                         const Plan& pl, int N, int V, int W, int ld, bool vg, bool vo,
                         cudaStream_t s) {
#define RECBLR_SLICE(L4, NG4) \
  return sum_slice<Tg, L, NG, L4, NG4>(st, g, pa, out, pl, N, V, W, ld, vg, vo, s)
  const int l4 = lanes_for(W, 4);
  const int ng4 = ((W + 3) / 4 + l4 - 1) / l4;
  if (ng4 > 2) RECBLR_SLICE(32, 4);
  if (ng4 == 2) RECBLR_SLICE(32, 2);
  switch (l4) {
    case 1: RECBLR_SLICE(1, 1);
    case 2: RECBLR_SLICE(2, 1);
    case 4: RECBLR_SLICE(4, 1);
    case 8: RECBLR_SLICE(8, 1);
    case 16: RECBLR_SLICE(16, 1);
    default: RECBLR_SLICE(32, 1);
  }
#undef RECBLR_SLICE
}

template <typename Tg>
cudaError_t sum_columns(const Sorted& st, const Tg* g, const Partials& pa, float* out,
                        const Plan& pl, int N, int V, int W, int ld, bool vg, bool vo,
                        cudaStream_t s) {
#define RECBLR_COLS(L, NG) return sum_slice_l4<Tg, L, NG>(st, g, pa, out, pl, N, V, W, ld, vg, vo, s)
  constexpr int VEC = 16 / sizeof(Tg);
  const int l = lanes_for(W, VEC);
  const int ng = ((W + VEC - 1) / VEC + l - 1) / l;
  if (ng > 2) RECBLR_COLS(32, 4);
  if (ng == 2) RECBLR_COLS(32, 2);
  switch (l) {
    case 1: RECBLR_COLS(1, 1);
    case 2: RECBLR_COLS(2, 1);
    case 4: RECBLR_COLS(4, 1);
    case 8: RECBLR_COLS(8, 1);
    case 16: RECBLR_COLS(16, 1);
    default: RECBLR_COLS(32, 1);
  }
#undef RECBLR_COLS
}

template <typename TI, typename Tg>
cudaError_t emb_grad(const TI* ids, const Tg* g, float* out, int* scratch, long long bytes,
                     int N, int V, int D, cudaStream_t stream) {
  Plan pl = make_plan(N, V, D);
  if (bytes < (long long)(pl.words * 4)) return cudaErrorInvalidValue;
  cudaError_t e;
  int device;
  if ((e = cudaGetDevice(&device)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&pl.sms, cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess)
    return e;
  int* keys[2] = {scratch, scratch + 2 * (size_t)N};
  int* vals[2] = {scratch + (size_t)N, scratch + 3 * (size_t)N};
  int* hist = scratch + 4 * (size_t)N;  // [passes][radix][tiles]
  const size_t per_pass = (size_t)pl.radix * pl.tiles;
  int* totals = hist + pl.passes * per_pass;         // [passes][radix]
  int* bad = totals + (size_t)pl.passes * pl.radix;  // [tiles]
  int* invalid = bad + pl.tiles;
  int* seg_start = invalid + 1;  // [V]
  int* seg_end = seg_start + V;  // [V]
  Partials pa;
  pa.first = reinterpret_cast<float*>(scratch + pl.ints);
  pa.last = pa.first + (size_t)pl.pieces * pl.slice;
  pa.gpre = pa.last + (size_t)pl.pieces * pl.slice;
  pa.gsuf = pa.gpre + (size_t)pl.groups * pl.slice;

  // enough blocks beyond the tiles that each marks at most 16 segment starts
  const int hist_blocks = max(pl.tiles, (int)(((long long)V + 16 * SORT_THREADS - 1) /
                                              (16 * SORT_THREADS)));
  radix_hist_kernel<TI><<<hist_blocks, SORT_THREADS, 0, stream>>>(ids, N, V, pl.radix, pl.tiles,
                                                                  hist, bad, seg_start);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const dim3 scan_grid((pl.radix + SORT_WARPS - 1) / SORT_WARPS);
  for (int p = 0; p < pl.passes; ++p) {
    int* h = hist + p * per_pass;
    int* next = p + 1 < pl.passes ? h + per_pass : nullptr;
    int* tot = totals + (size_t)p * pl.radix;
    radix_scan_kernel<<<scan_grid, SORT_THREADS, 0, stream>>>(
        h, tot, pl.radix, pl.tiles, next, p == 0 ? bad : nullptr, invalid);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    const int shift = p * pl.width, next_shift = (p + 1) * pl.width;
    if (p == 0)
      radix_scatter_kernel<TI><<<pl.tiles, SORT_THREADS, 0, stream>>>(
          ids, nullptr, N, V, shift, pl.radix, pl.tiles, h, tot, keys[0], vals[0], next,
          next_shift);
    else
      radix_scatter_kernel<int><<<pl.tiles, SORT_THREADS, 0, stream>>>(
          keys[(p - 1) % 2], vals[(p - 1) % 2], N, V, shift, pl.radix, pl.tiles, h, tot,
          keys[p % 2], vals[p % 2], next, next_shift);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  const Sorted st = {keys[(pl.passes - 1) % 2], vals[(pl.passes - 1) % 2], invalid, seg_start,
                     seg_end};
  const bool vo = D % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const bool vg = ((size_t)D * sizeof(Tg)) % 16 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  // one slice of at most MAX_SLICE columns at a time; the partials are
  // reused, in stream order
  for (int d0 = 0; d0 < D; d0 += MAX_SLICE) {
    e = sum_columns<Tg>(st, g + d0, pa, out + d0, pl, N, V, min(MAX_SLICE, D - d0), D, vg, vo,
                        stream);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// ids: [N] int32 (ids64 == 0) or int64; g: [N, D] fp32 (bf16 == 0) or
// bf16; out: [V, D] fp32, every row written; scratch: `bytes` bytes of
// device memory, at least ops/embedding.py:scratch_bytes(N, V, D) (else
// cudaErrorInvalidValue); device: the card.
int recblr_emb_grad(const void* ids, int ids64, const void* g, int bf16, void* out,
                    void* scratch, long long bytes, int N, int V, int D, int device,
                    void* stream) {
  // this library has its own (static) CUDA runtime: select the tensors' card
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  int* sc = static_cast<int*>(scratch);
  const __nv_bfloat16* gb = static_cast<const __nv_bfloat16*>(g);
  const float* gf = static_cast<const float*>(g);
  if (ids64) {
    const long long* i = static_cast<const long long*>(ids);
    return bf16 ? emb_grad(i, gb, o, sc, bytes, N, V, D, s)
                : emb_grad(i, gf, o, sc, bytes, N, V, D, s);
  }
  const int* i = static_cast<const int*>(ids);
  return bf16 ? emb_grad(i, gb, o, sc, bytes, N, V, D, s)
              : emb_grad(i, gf, o, sc, bytes, N, V, D, s);
}

const char* recblr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
