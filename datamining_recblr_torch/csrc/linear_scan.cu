// The first-order linear recurrence h_t = g_t h_{t-1} + x_t (h_{-1} = 0)
// for Hopper, forward and reverse: the scan of RecBLR's unfused
// composition (C > 128, where the whole-layer kernels do not run).
//
// Replaces the TPU kernel datamining_recblr_tpu/ops/pallas_scan.py:
// _scan_kernel / _scan_kernel_rev (reached through _scan_fwd_pallas with
// reverse False / True, from linear_scan_pallas and its VJP).  The TPU
// kernel pads C to 128 lanes and runs a Hillis-Steele scan over T in
// registers; here linear_scan_kernel (common.cuh) runs one thread per
// (row, channel), serial over T, with no padding: the serial order of
// the layer kernels' scan, so the two packages agree to rounding, not
// bit for bit.  The reverse mode takes the gates as given: the VJP
// hands it shift_left(gates) with the last position 1.
//
// What bounds it: one multiply-add per element against a read of the
// gates and the tokens and a write of h (3 B T C x 4 bytes, 1.26 GB at
// B 2,048, T 200, C 256): bytes.  Neighbouring threads take neighbouring
// channels, so every step of a warp reads and writes whole 128-byte
// lines; the loads do not depend on the running sum, so each group of
// SCAN_GROUP steps issues all its loads before its first multiply-add.
// At B 2,048 and C 256 there are 524,288 threads, enough to fill the card.
//
// C interface (loaded with ctypes): returns a cudaError_t, 0 on success.
#include "common.cuh"

using namespace recblr;

extern "C" {

// gates, tokens, out: [B, T, C] fp32; reverse: scan from t = T-1 down;
// device: the card that holds them.
int recblr_linear_scan(const void* gates, const void* tokens, void* out, int B, int T, int C,
                       int reverse, int device, void* stream) {
  // this library has its own (static) CUDA runtime: select the tensors' card
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gates);
  const float* x = static_cast<const float*>(tokens);
  float* h = static_cast<float*>(out);
  const int blocks = (B * C + SCAN_THREADS - 1) / SCAN_THREADS;
  if (reverse)
    linear_scan_kernel<true, float, float><<<blocks, SCAN_THREADS, 0, st>>>(g, x, h, B, T, C, 0);
  else
    linear_scan_kernel<false, float, float><<<blocks, SCAN_THREADS, 0, st>>>(g, x, h, B, T, C, 0);
  return cudaGetLastError();
}

const char* recblr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
