// Probe: the sequence-chunked layer's dropout masks drawn in data order
// and again in the reverse chunk order its backward walks, to be compared
// bit for bit.
//
// Replaces the TPU kernels benchmarks/mask_replay_check.py: fwd_kernel and
// bwd_kernel (call's pallas_call at :62).  On the TPU a block reseeded the
// hardware PRNG with seed + i nc + j and drew its four masks in a fixed
// order, so the backward replayed a chunk's masks only if it reseeded with
// the data chunk's index.  Here a mask element is a pure function of
// (seed, mask id, row, position, channel) (common.cuh, drop_mask /
// drop_mask4; ops/philox.py is the plain version), so the two orders agree
// by construction; the probe holds the two device functions that the
// layer kernels call to the same bits:
//
//   masks_forward_kernel   one block per (row block i, data chunk j): the
//                          four masks m0..m3 (mask ids M0..M3, widths d, d,
//                          ff, d) of rows i bt.., positions j tc.., one
//                          Philox call (drop_mask4) per 4 channels, written
//                          as 16-byte stores
//   masks_reversed_kernel  one block per row block, walking the data
//                          chunks serially, jd = nc - 1 .. 0, as the TPU
//                          kernel's grid did; each element drawn alone
//                          with drop_mask, channel by channel (four times
//                          the Philox calls)
//
// Output: fp32 [nb bt, nc tc, width] each, 1/keep where kept, else 0.
// What bounds it: the masks' bytes (1.8 MB at the probe's defaults, a few
// launch latencies; 940 MB at the XLong layer's B 512, T 1,024, 0.28 ms at
// 3.35 TB/s).  The draw's integer work runs on two pipes of 64 lanes an
// SM: per 4 elements one Philox call, ten rounds of two wide multiplies
// (IMAD.WIDE, the FMA-heavy pipe) and two three-input xors (LOP3, the ALU
// pipe), then a compare and a select an element (the ALU pipe), so 7 ALU
// operations an element, 0.10 ms at XLong.  The forward kernel's index
// math adds to that; the reversed kernel's Philox call an element
// (drop_mask) adds four times the rounds.
//
// C interface (loaded with ctypes): returns a cudaError_t, 0 on success.
#include "common.cuh"

using namespace recblr;

namespace {

constexpr int MF_THREADS = 512;
constexpr int MR_THREADS = 1024;

struct Masks {
  float* out[4];
  int width[4];
};

__constant__ int MASK_IDS[4] = {M0, M1, M2, M3};

__global__ void __launch_bounds__(MF_THREADS)
masks_forward_kernel(Dropout dr, Masks m, int bt, int tc, int t_all) {
  const int i = blockIdx.x, j = blockIdx.y;
#pragma unroll 1
  for (int k = 0; k < 4; ++k) {
    const int g4 = m.width[k] >> 2;
    const int items = bt * tc * g4;
    float4* out = reinterpret_cast<float4*>(m.out[k]);
    for (int e = threadIdx.x; e < items; e += MF_THREADS) {
      const int g = e % g4, rt = e / g4;
      const int b = i * bt + rt / tc, t = j * tc + rt % tc;
      out[((size_t)b * t_all + t) * g4 + g] = drop_mask4(dr, MASK_IDS[k], b, t, g);
    }
  }
}

__global__ void __launch_bounds__(MR_THREADS)
masks_reversed_kernel(Dropout dr, Masks m, int bt, int tc, int nc) {
  const int i = blockIdx.x, t_all = nc * tc;
#pragma unroll 1
  for (int j = 0; j < nc; ++j) {
    const int jd = nc - 1 - j;  // the data chunk (the backward's flipped index map)
#pragma unroll 1
    for (int k = 0; k < 4; ++k) {
      const int w = m.width[k];
      const int items = bt * tc * w;
      for (int e = threadIdx.x; e < items; e += MR_THREADS) {
        const int ch = e % w, rt = e / w;
        const int b = i * bt + rt / tc, t = jd * tc + rt % tc;
        m.out[k][((size_t)b * t_all + t) * w + ch] = drop_mask(dr, MASK_IDS[k], b, t, ch);
      }
    }
  }
}

}  // namespace

extern "C" {

// reversed: 0 the forward-order kernel, 1 the reversed one; m0..m3: fp32
// [nb bt, nc tc, width] for widths d, d, ff, d (multiples of 4); seed,
// thresh, scale: the 64-bit Philox key, keep iff bits < thresh, 1/keep.
int recblr_probe_masks(int reversed, void* m0, void* m1, void* m2, void* m3, int nb, int nc,
                       int bt, int tc, int d, int ff, unsigned long long seed, unsigned thresh,
                       float scale, int device, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (nb < 1 || nc < 1 || bt < 1 || tc < 1 || d < 4 || ff < 4 || d % 4 || ff % 4 ||
      (long long)bt * tc * ff >= (1ll << 31) || (long long)nb * bt * nc * tc >= (1ll << 31) ||
      nc >= 65536)
    return cudaErrorInvalidValue;
  Masks m;
  void* outs[4] = {m0, m1, m2, m3};
  const int widths[4] = {d, d, ff, d};
  for (int k = 0; k < 4; ++k) {
    m.out[k] = static_cast<float*>(outs[k]);
    m.width[k] = widths[k];
  }
  const Dropout dr = make_dropout(1, seed, thresh, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (reversed)
    masks_reversed_kernel<<<nb, MR_THREADS, 0, st>>>(dr, m, bt, tc, nc);
  else
    masks_forward_kernel<<<dim3(nb, nc), MF_THREADS, 0, st>>>(dr, m, bt, tc, nc * tc);
  return cudaGetLastError();
}

const char* recblr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
