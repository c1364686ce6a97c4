// Probe: an embedding gather, out[i, :] = tab[ids[i], :], with the table
// read through L2.
//
// Replaces the TPU kernel benchmarks/emb_gather.py: pallas_gather's
// _gather_kernel (its pallas_call at :39), which held the whole [V, D]
// table in VMEM in every grid step and gathered a block of bn ids with a
// per-lane take_along_axis.
//
// At the probe's shape (N 409,600 int32 ids, a [3,417, 64] bf16 table) the
// table takes 437,376 bytes, beyond the 227 KB of shared memory a block can
// use, so it is not staged: it stays in L2 (50 MB), where every block's
// reads hit after the first.  What bounds the gather is then device memory:
// the ids read once and the rows written once, 54.5 MB, about 16 us at
// 3.35 TB/s.  The design keeps enough bytes in flight for that: a group of
// lanes (a power of two, at most 32) takes one row, each lane moving
// 16-byte vectors where the row's bytes and both pointers allow (8, 4 or 2
// bytes otherwise), so a bf16 row of 64 is 8 lanes and a warp moves 4 rows
// an instruction; each thread loads UNROLL rows' vectors before it stores
// any.  Block b takes rows [b bn, (b + 1) bn), the TPU kernel's grid, and
// any N (the last block ragged).  Stores are streaming (__stcs), so the
// output does not push the table out of L2.
//
// Ids follow Python's indexing: -V <= id < V, a negative id counting from
// the end; any other id gives a zero row and no read outside the table.
//
// C interface (loaded with ctypes): returns a cudaError_t, 0 on success.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int EG_THREADS = 512;
constexpr int UNROLL = 4;

template <typename Vec, typename Id>
__global__ void __launch_bounds__(EG_THREADS)
gather_kernel(const Id* __restrict__ ids, const Vec* __restrict__ tab, Vec* __restrict__ out,
              long long n, int v, int nvec, int tpr_log2, int bn) {
  const int tpr = 1 << tpr_log2;
  const int sub = threadIdx.x & (tpr - 1);  // lane within the row's group
  const int groups = EG_THREADS >> tpr_log2;
  const long long r0 = (long long)blockIdx.x * bn;
  const long long r1 = min(r0 + bn, n);
  for (long long r = r0 + (threadIdx.x >> tpr_log2); r < r1; r += (long long)groups * UNROLL) {
    long long src[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long ri = r + (long long)u * groups;
      long long id = -1;
      if (ri < r1) {
        id = (long long)__ldg(ids + ri);
        if (id < 0) id += v;
        if (id >= v) id = -1;
      }
      src[u] = id;
    }
    for (int j = sub; j < nvec; j += tpr) {
      Vec val[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        val[u] = Vec{};
        if (src[u] >= 0) val[u] = __ldg(tab + src[u] * nvec + j);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long ri = r + (long long)u * groups;
        if (ri < r1) __stcs(out + ri * nvec + j, val[u]);
      }
    }
  }
}

template <typename Vec>
cudaError_t launch(const void* ids, int ids64, const void* tab, void* out, long long n, int v,
                   int row_bytes, int bn, cudaStream_t st) {
  const int nvec = row_bytes / (int)sizeof(Vec);
  int tpr_log2 = 0;
  while ((1 << tpr_log2) < nvec && tpr_log2 < 5) ++tpr_log2;
  const long long blocks = (n + bn - 1) / bn;
  const Vec* t = static_cast<const Vec*>(tab);
  Vec* o = static_cast<Vec*>(out);
  if (ids64)
    gather_kernel<Vec, long long><<<(unsigned)blocks, EG_THREADS, 0, st>>>(
        static_cast<const long long*>(ids), t, o, n, v, nvec, tpr_log2, bn);
  else
    gather_kernel<Vec, int><<<(unsigned)blocks, EG_THREADS, 0, st>>>(
        static_cast<const int*>(ids), t, o, n, v, nvec, tpr_log2, bn);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// ids: n int32 (ids64 = 0) or int64 values; tab: v rows of row_bytes bytes
// (any element type: the rows' bits are copied); out: n rows; bn: rows a
// block.
int recblr_probe_emb_gather(const void* ids, int ids64, const void* tab, void* out, long long n,
                            int v, int row_bytes, int bn, int device, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (n < 1 || v < 1 || row_bytes < 2 || row_bytes % 2 || bn < 1 ||
      (n + bn - 1) / bn >= (1ll << 31))
    return cudaErrorInvalidValue;
  const uintptr_t align = reinterpret_cast<uintptr_t>(tab) | reinterpret_cast<uintptr_t>(out) |
                          (uintptr_t)row_bytes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (align % 16 == 0) return launch<uint4>(ids, ids64, tab, out, n, v, row_bytes, bn, st);
  if (align % 8 == 0) return launch<uint2>(ids, ids64, tab, out, n, v, row_bytes, bn, st);
  if (align % 4 == 0) return launch<unsigned int>(ids, ids64, tab, out, n, v, row_bytes, bn, st);
  return launch<unsigned short>(ids, ids64, tab, out, n, v, row_bytes, bn, st);
}

const char* recblr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
