// dropout(LN(x + pos)) and LN(dropout(x)) over D for Hopper, forward and
// backward: the embedding prologue of SASRec and BERT4Rec, and the input
// dropout and LN of a one-layer RecBLR.
//
// Replaces the TPU kernels datamining_recblr_tpu/ops/fused_layer.py:
// _ln_dropout_fwd_kernel (reached through _ln_dropout_fwd /
// fused_ln_dropout) and _ln_dropout_bwd_kernel (through _ln_dropout_bwd);
// with PRE (the dropout before the LN, no pos), _dropout_ln_fwd_kernel
// (through _dropout_ln_fwd / fused_dropout_ln) and _dropout_ln_bwd_kernel
// (through _dropout_ln_bwd).  pos [T, D] is added in fp32 before the LN,
// as the TPU kernel does; the dropout is the Philox mask M0 of the call's
// seed (common.cuh), which under PRE keys the input element (row,
// position, channel), the bits of the plain dropout of x.
//
// Forward: a few operations per element against a read of x and a write
// of out (2 B T D x 4 bytes in fp32, 210 MB at B 2,048, T 200, D 64):
// bound by bytes.  A row is a segment of the fewest lanes (a power of
// two) whose groups of four channels cover D (16 lanes at D 64, so a warp
// holds two rows; 32 lanes of up to four groups at D 512), each segment
// two rows in flight (one at D > 256).  A lane loads its four channels
// with one 16-byte load (8 bytes in bf16) and takes their mask from one
// Philox call, the four words of which are the per-channel draws' bits;
// mean and centred variance over the segment with shuffles, one store a
// group.  pos, scale and bias stay in L1/L2.  No shared memory.
//
// Backward: x, dout and dx once each (3 B T D x 4 bytes, 315 MB at
// B 2,048 in fp32), also bound by bytes.  The LN statistics are
// recomputed from x (no stash), the mask is drawn again.  dpos [T, D] is
// the batch sum of the LN input's gradient and dscale, dbias [D] sums
// over every (row, position), all without atomics.  A row is a segment of
// the fewest lanes (a power of two) whose groups of four channels cover D
// (the forward's segment), so no register slot idles where D fills the
// groups.  Each lane loads its four channels with one 16-byte load and
// takes their mask from one Philox call; a warp holds 32 / lanes rows,
// each segment walks its position over a chunk of batch rows with two
// rows in flight.  dpos, dscale and dbias are summed in the same pass into
// fixed-order partials (per chunk and position; per chunk and tile of
// positions), which one small launch adds up in order with coalesced
// reads, so two runs give the same bits (PRE has no dpos).
//
// C interface (loaded with ctypes): returns a cudaError_t, 0 on success.
#include "common.cuh"

using namespace recblr;

namespace {

constexpr int LN_THREADS = 256;

// Four consecutive channels d .. d+3 of a row (16-byte loads in fp32,
// 8-byte in bf16, where D % 4 == 0 makes them aligned), zero beyond D.
__device__ __forceinline__ void load4(const float* p, size_t o, int d, int D, float (&v)[4]) {
  if (D % 4 == 0 && d < D) {
    const float4 q = *reinterpret_cast<const float4*>(p + o + d);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = d + i < D ? p[o + d + i] : 0.f;
  }
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, size_t o, int d, int D,
                                      float (&v)[4]) {
  if (D % 4 == 0 && d < D) {
    const uint2 q = *reinterpret_cast<const uint2*>(p + o + d);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = d + i < D ? __bfloat162float(p[o + d + i]) : 0.f;
  }
}
__device__ __forceinline__ void store4(float* p, size_t o, int d, int D, const float (&v)[4]) {
  if (D % 4 == 0 && d < D) {
    *reinterpret_cast<float4*>(p + o + d) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (d + i < D) p[o + d + i] = v[i];
  }
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, size_t o, int d, int D,
                                       const float (&v)[4]) {
  if (D % 4 == 0 && d < D) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 q;
    q.x = *reinterpret_cast<const unsigned*>(&a);
    q.y = *reinterpret_cast<const unsigned*>(&b);
    *reinterpret_cast<uint2*>(p + o + d) = q;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (d + i < D) p[o + d + i] = __float2bfloat16(v[i]);
  }
}

// The sum over the `lpr` lanes of a row's segment (a power of two).
__device__ __forceinline__ float seg_sum(float v, int lpr) {
  for (int o = lpr / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The row segment of both passes: `lpr` lanes (a power of two, at most
// 32) cover a row's D channels in NG groups of four a lane (group
// g = lane + k * lpr holds channels 4g .. 4g+3), so no register slot is
// idle where D fills the groups.
inline int ln_groups(int D) { return D <= 128 ? 1 : D <= 256 ? 2 : 4; }
inline int ln_lanes(int D) {
  const int groups = (D + 3) / 4;
  int l = 1;
  while (l < groups && l < 32) l *= 2;
  return l;
}

// Forward, one row segment per R consecutive (row, position) pairs (R = 2
// rows in flight, one at D > 256): x (and pos) by groups of four channels,
// one Philox call a group for the M0 mask (before the LN under PRE, after
// it otherwise), mean and centred variance over the segment, one store a
// group.  scale and bias stay in registers for the segment's rows.
template <typename Tin, bool PRE, int NG>
__global__ void __launch_bounds__(LN_THREADS)
ln_pos_kernel(const Tin* __restrict__ x, const float* __restrict__ pos,
              const float* __restrict__ s, const float* __restrict__ bias, Dropout dr,
              Tin* __restrict__ out, int rows, int T, int D, int lpr) {
  constexpr int R = NG >= 4 ? 1 : 2;
  const int segs = LN_THREADS / lpr;
  const int sl = threadIdx.x % lpr;
  const int r0 = (blockIdx.x * segs + threadIdx.x / lpr) * R;
  int bt[R][2];  // (row, position) of each row, one 32-bit division each
#pragma unroll
  for (int r = 0; r < R; ++r) bt[r][0] = (r0 + r) / T, bt[r][1] = (r0 + r) - bt[r][0] * T;
  float sc[NG][4], bi[NG][4], v[R][NG][4];
#pragma unroll
  for (int k = 0; k < NG; ++k) {
    const int d = 4 * (sl + k * lpr);
    load4(s, 0, d, D, sc[k]);
    load4(bias, 0, d, D, bi[k]);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = r0 + r, b = bt[r][0], t = bt[r][1];
#pragma unroll
    for (int k = 0; k < NG; ++k) {
      const int g = sl + k * lpr;
      if (row < rows && 4 * g < D) {
        load4(x, (size_t)row * D, 4 * g, D, v[r][k]);
        if (PRE) {
          const float4 m = drop_mask4(dr, M0, b, t, g);
          v[r][k][0] *= m.x, v[r][k][1] *= m.y, v[r][k][2] *= m.z, v[r][k][3] *= m.w;
        } else {
          float p[4];
          load4(pos, (size_t)t * D, 4 * g, D, p);
#pragma unroll
          for (int i = 0; i < 4; ++i) v[r][k][i] += p[i];
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) v[r][k][i] = 0.f;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = r0 + r, b = bt[r][0], t = bt[r][1];
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < NG; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i) sum += v[r][k][i];
    const float mu = seg_sum(sum, lpr) / D;
    float sq = 0.f;
#pragma unroll
    for (int k = 0; k < NG; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[r][k][i] = 4 * (sl + k * lpr) + i < D ? v[r][k][i] - mu : 0.f;
        sq += v[r][k][i] * v[r][k][i];
      }
    const float inv = rsqrtf(seg_sum(sq, lpr) / D + LN_EPS);
#pragma unroll
    for (int k = 0; k < NG; ++k) {
      const int g = sl + k * lpr;
      if (row >= rows || 4 * g >= D) continue;
      float y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) y[i] = v[r][k][i] * inv * sc[k][i] + bi[k][i];
      if (!PRE) {
        const float4 m = drop_mask4(dr, M0, b, t, g);
        y[0] *= m.x, y[1] *= m.y, y[2] *= m.z, y[3] *= m.w;
      }
      store4(out, (size_t)row * D, 4 * g, D, y);
    }
  }
}

// Block (tile, c): positions tile * P .. tile * P + P - 1 (P = LN_THREADS
// / lpr, one row segment each) over the batch rows of chunk c, b = c * bc
// .. c * bc + bc - 1, two rows in flight a segment (one at D > 256).  Writes dx, and in the
// same pass the chunk's sums for each position of dv (pos_part[c, t, :],
// not under PRE) and the block's sums over its positions of dy * vhat and
// dy (sb_part[c * tiles + tile, :], segments added in order): one fixed
// order, no atomics.
template <typename Tin, bool PRE, int NG>
__global__ void __launch_bounds__(LN_THREADS)
ln_pos_bwd_kernel(const Tin* __restrict__ x, const float* __restrict__ pos,
                  const Tin* __restrict__ dout, const float* __restrict__ s, Dropout dr,
                  Tin* __restrict__ dx, float* __restrict__ pos_part,
                  float* __restrict__ sb_part, int B, int T, int D, int bc, int lpr) {
  __shared__ __align__(16) float red[8 * 2 * 4 * 32 * 4];  // [segments, 2D]
  const int segs = LN_THREADS / lpr;
  const int seg = threadIdx.x / lpr, sl = threadIdx.x % lpr;
  const int t = blockIdx.x * segs + seg;
  const bool on_t = t < T;
  const int c = blockIdx.y;
  const int b0 = c * bc, b1 = min(B, b0 + bc);
  float sc[NG][4], ps[NG][4], dp[NG][4], ds[NG][4], db[NG][4];
#pragma unroll
  for (int k = 0; k < NG; ++k) {
    const int d = 4 * (sl + k * lpr);
    load4(s, 0, d, D, sc[k]);
    if (PRE || !on_t) {
#pragma unroll
      for (int i = 0; i < 4; ++i) ps[k][i] = 0.f;
    } else {
      load4(pos, (size_t)t * D, d, D, ps[k]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) dp[k][i] = ds[k][i] = db[k][i] = 0.f;
  }
  constexpr int R = NG >= 4 ? 1 : 2;  // rows in flight
  for (int bb = b0; bb < b1; bb += R) {
    float v[R][NG][4], dy[R][NG][4], m[R][NG][4];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int b = bb + r;
      const bool live = on_t && b < b1;
      const size_t o = ((size_t)b * T + t) * D;
#pragma unroll
      for (int k = 0; k < NG; ++k) {
        const int g = sl + k * lpr;
        const int d = 4 * g;
        if (live && d < D) {
          load4(x, o, d, D, v[r][k]);
          load4(dout, o, d, D, dy[r][k]);
          const float4 mk = drop_mask4(dr, M0, b, t, g);
          m[r][k][0] = mk.x, m[r][k][1] = mk.y, m[r][k][2] = mk.z, m[r][k][3] = mk.w;
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) v[r][k][i] = dy[r][k][i] = m[r][k][i] = 0.f;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int b = bb + r;
      const bool live = on_t && b < b1;
      // the mask multiplies the LN input under PRE, the output otherwise
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < NG; ++k)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (PRE) {
            v[r][k][i] *= m[r][k][i];
          } else {
            v[r][k][i] += ps[k][i];
            dy[r][k][i] *= m[r][k][i];
          }
          sum += v[r][k][i];
        }
      const float mu = seg_sum(sum, lpr) / D;
      float sq = 0.f;
#pragma unroll
      for (int k = 0; k < NG; ++k)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool in = 4 * (sl + k * lpr) + i < D;
          v[r][k][i] = in ? v[r][k][i] - mu : 0.f;
          sq += v[r][k][i] * v[r][k][i];
        }
      const float inv = rsqrtf(seg_sum(sq, lpr) / D + LN_EPS);
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int k = 0; k < NG; ++k)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          v[r][k][i] *= inv;  // vhat
          const float g = dy[r][k][i] * sc[k][i];
          ds[k][i] += dy[r][k][i] * v[r][k][i];
          db[k][i] += dy[r][k][i];
          s1 += g;
          s2 += g * v[r][k][i];
        }
      const float m1 = seg_sum(s1, lpr) / D;
      const float m2 = seg_sum(s2, lpr) / D;
      const size_t o = ((size_t)b * T + t) * D;
#pragma unroll
      for (int k = 0; k < NG; ++k) {
        float out[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float dv = inv * (dy[r][k][i] * sc[k][i] - m1 - v[r][k][i] * m2);
          dp[k][i] += live ? dv : 0.f;
          out[i] = PRE ? dv * m[r][k][i] : dv;
        }
        const int d = 4 * (sl + k * lpr);
        if (live && d < D) store4(dx, o, d, D, out);
      }
    }
  }
  // dpos of this chunk at position t; dscale, dbias summed over the
  // block's positions in segment order
  const int D2 = 2 * D;
#pragma unroll
  for (int k = 0; k < NG; ++k) {
    const int d = 4 * (sl + k * lpr);
    if (!PRE && on_t) store4(pos_part, ((size_t)c * T + t) * D, d, D, dp[k]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (d + i < D) {
        red[seg * D2 + d + i] = on_t ? ds[k][i] : 0.f;
        red[seg * D2 + D + d + i] = on_t ? db[k][i] : 0.f;
      }
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < D2; j += blockDim.x) {
    float acc = 0.f;
    for (int q = 0; q < segs; ++q) acc += red[q * D2 + j];
    sb_part[((size_t)c * gridDim.x + blockIdx.x) * D2 + j] = acc;
  }
}

// out[j] = sum over r < R, in order, of a[r * C + j] for j < C: 32
// columns a block, eight row lanes each summing every eighth row, then
// the eight added in order.  Blocks [0, nb1) take (a1, R1, C1, o1), the
// rest (a2, R2, C2, o2): the backward's dpos and its dscale, dbias in one
// launch.
__global__ void __launch_bounds__(256)
sum_rows_kernel(const float* __restrict__ a1, int R1, int C1, float* __restrict__ o1, int nb1,
                const float* __restrict__ a2, int R2, int C2, float* __restrict__ o2) {
  __shared__ float sh[8][32];
  const bool first = (int)blockIdx.x < nb1;
  const float* a = first ? a1 : a2;
  const int R = first ? R1 : R2, C = first ? C1 : C2;
  float* o = first ? o1 : o2;
  const int col = (first ? blockIdx.x : blockIdx.x - nb1) * 32 + threadIdx.x % 32;
  const int rl = threadIdx.x / 32;
  float acc = 0.f;
  if (col < C)
    for (int r = rl; r < R; r += 8) acc += a[(size_t)r * C + col];
  sh[rl][threadIdx.x % 32] = acc;
  __syncthreads();
  if (rl == 0 && col < C) {
    float t = 0.f;
    for (int k = 0; k < 8; ++k) t += sh[k][threadIdx.x];
    o[col] = t;
  }
}

template <bool PRE, int NG, typename Tin>
cudaError_t ln_pos_fwd_ng(const Tin* x, const float* pos, const float* s, const float* b,
                          Dropout dr, Tin* out, int B, int T, int D, cudaStream_t stream) {
  const int rows = B * T, lpr = ln_lanes(D);
  const int per_block = LN_THREADS / lpr * (NG >= 4 ? 1 : 2);
  ln_pos_kernel<Tin, PRE, NG><<<(rows + per_block - 1) / per_block, LN_THREADS, 0, stream>>>(
      x, pos, s, b, dr, out, rows, T, D, lpr);
  return cudaGetLastError();
}

template <bool PRE, typename Tin>
cudaError_t ln_pos_fwd(const Tin* x, const float* pos, const float* s, const float* b, Dropout dr,
                       Tin* out, int B, int T, int D, cudaStream_t stream) {
  switch (ln_groups(D)) {
    case 1:
      return ln_pos_fwd_ng<PRE, 1>(x, pos, s, b, dr, out, B, T, D, stream);
    case 2:
      return ln_pos_fwd_ng<PRE, 2>(x, pos, s, b, dr, out, B, T, D, stream);
    default:
      return ln_pos_fwd_ng<PRE, 4>(x, pos, s, b, dr, out, B, T, D, stream);
  }
}

// PRE: no pos, pos_part or dpos.  chunks: the batch chunks of the grid
// (pos_part [chunks, T, D]; sb_part at least [chunks * T, 2D]).
template <bool PRE, int NG, typename Tin>
cudaError_t ln_pos_bwd_ng(const Tin* x, const float* pos, const Tin* dout, const float* s,
                          Dropout dr, Tin* dx, float* pos_part, float* sb_part, float* dpos,
                          float* dsb, int B, int T, int D, int chunks, cudaStream_t stream) {
  const int lpr = ln_lanes(D);
  const int tiles = (T + LN_THREADS / lpr - 1) / (LN_THREADS / lpr);
  const int bc = (B + chunks - 1) / chunks;
  ln_pos_bwd_kernel<Tin, PRE, NG><<<dim3(tiles, chunks), LN_THREADS, 0, stream>>>(
      x, pos, dout, s, dr, dx, pos_part, sb_part, B, T, D, bc, lpr);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int nb1 = PRE ? 0 : (T * D + 31) / 32;
  sum_rows_kernel<<<nb1 + (2 * D + 31) / 32, 256, 0, stream>>>(
      pos_part, chunks, T * D, dpos, nb1, sb_part, chunks * tiles, 2 * D, dsb);
  return cudaGetLastError();
}

template <bool PRE, typename Tin>
cudaError_t ln_pos_bwd(const Tin* x, const float* pos, const Tin* dout, const float* s,
                       Dropout dr, Tin* dx, float* pos_part, float* sb_part, float* dpos,
                       float* dsb, int B, int T, int D, int chunks, cudaStream_t stream) {
  switch (ln_groups(D)) {
    case 1:
      return ln_pos_bwd_ng<PRE, 1>(x, pos, dout, s, dr, dx, pos_part, sb_part, dpos, dsb, B, T,
                                   D, chunks, stream);
    case 2:
      return ln_pos_bwd_ng<PRE, 2>(x, pos, dout, s, dr, dx, pos_part, sb_part, dpos, dsb, B, T,
                                   D, chunks, stream);
    default:
      return ln_pos_bwd_ng<PRE, 4>(x, pos, dout, s, dr, dx, pos_part, sb_part, dpos, dsb, B, T,
                                   D, chunks, stream);
  }
}

}  // namespace

extern "C" {

// x, out: [B, T, D] fp32 (bf16 == 0) or bf16, D <= 512; pos: [T, D],
// scale, bias: [D] fp32; drop, seed, thresh, drop_scale: the dropout
// (common.cuh Dropout); device: the card that holds them.
int recblr_ln_pos_fwd(const void* x, const void* pos, const void* scale, const void* bias,
                      void* out, int B, int T, int D, int bf16, int drop,
                      unsigned long long seed, unsigned thresh, float drop_scale, int device,
                      void* stream) {
  // this library has its own (static) CUDA runtime: select the tensors' card
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout dr = make_dropout(drop, seed, thresh, drop_scale);
  const float* p = static_cast<const float*>(pos);
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  if (bf16)
    return ln_pos_fwd<false>(static_cast<const __nv_bfloat16*>(x), p, s, b, dr,
                             static_cast<__nv_bfloat16*>(out), B, T, D, st);
  return ln_pos_fwd<false>(static_cast<const float*>(x), p, s, b, dr, static_cast<float*>(out),
                           B, T, D, st);
}

// x, dout, dx: [B, T, D] fp32 (bf16 == 0) or bf16; pos [T, D], scale [D]
// fp32 (bias is not read); pos_part: [chunks, T, D] and sb_part:
// [chunks * T, 2D] fp32 scratch; dpos: [T, D] and dsb: [2D] (dscale then
// dbias) fp32 out; the forward's dropout; device: the card.
int recblr_ln_pos_bwd(const void* x, const void* pos, const void* dout, const void* scale,
                      const void* bias, void* dx, void* pos_part, void* sb_part, void* dpos,
                      void* dsb, int B, int T, int D, int chunks, int bf16, int drop,
                      unsigned long long seed, unsigned thresh, float drop_scale, int device,
                      void* stream) {
  (void)bias;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout dr = make_dropout(drop, seed, thresh, drop_scale);
  const float* p = static_cast<const float*>(pos);
  const float* s = static_cast<const float*>(scale);
  float* pp = static_cast<float*>(pos_part);
  float* sp = static_cast<float*>(sb_part);
  float* dp = static_cast<float*>(dpos);
  float* dsbp = static_cast<float*>(dsb);
  if (bf16)
    return ln_pos_bwd<false>(static_cast<const __nv_bfloat16*>(x), p,
                             static_cast<const __nv_bfloat16*>(dout), s, dr,
                             static_cast<__nv_bfloat16*>(dx), pp, sp, dp, dsbp, B, T, D, chunks,
                             st);
  return ln_pos_bwd<false>(static_cast<const float*>(x), p, static_cast<const float*>(dout), s,
                           dr, static_cast<float*>(dx), pp, sp, dp, dsbp, B, T, D, chunks, st);
}

// LN(dropout(x)): x, out: [B, T, D] fp32 (bf16 == 0) or bf16, D <= 512;
// scale, bias: [D] fp32; the dropout of x (common.cuh Dropout, mask M0);
// device: the card that holds them.
int recblr_dropout_ln_fwd(const void* x, const void* scale, const void* bias, void* out, int B,
                          int T, int D, int bf16, int drop, unsigned long long seed,
                          unsigned thresh, float drop_scale, int device, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout dr = make_dropout(drop, seed, thresh, drop_scale);
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  if (bf16)
    return ln_pos_fwd<true>(static_cast<const __nv_bfloat16*>(x), nullptr, s, b, dr,
                            static_cast<__nv_bfloat16*>(out), B, T, D, st);
  return ln_pos_fwd<true>(static_cast<const float*>(x), nullptr, s, b, dr,
                          static_cast<float*>(out), B, T, D, st);
}

// Its backward: x, dout, dx: [B, T, D] fp32 (bf16 == 0) or bf16; scale
// [D] fp32; sb_part: [chunks * T, 2D] fp32 scratch; dsb: [2D] (dscale then
// dbias) fp32 out; the forward's dropout; device: the card.
int recblr_dropout_ln_bwd(const void* x, const void* dout, const void* scale, void* dx,
                          void* sb_part, void* dsb, int B, int T, int D, int chunks, int bf16,
                          int drop, unsigned long long seed, unsigned thresh, float drop_scale,
                          int device, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout dr = make_dropout(drop, seed, thresh, drop_scale);
  const float* s = static_cast<const float*>(scale);
  float* sp = static_cast<float*>(sb_part);
  float* dsbp = static_cast<float*>(dsb);
  if (bf16)
    return ln_pos_bwd<true>(static_cast<const __nv_bfloat16*>(x), nullptr,
                            static_cast<const __nv_bfloat16*>(dout), s, dr,
                            static_cast<__nv_bfloat16*>(dx), nullptr, sp, nullptr, dsbp, B, T, D,
                            chunks, st);
  return ln_pos_bwd<true>(static_cast<const float*>(x), nullptr,
                          static_cast<const float*>(dout), s, dr, static_cast<float*>(dx),
                          nullptr, sp, nullptr, dsbp, B, T, D, chunks, st);
}

const char* recblr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
