// In-place 4-qubit gate on bits >= 7 of the split-complex state container,
// with the gate size fixed at compile time.
//
// Replaces the Pallas TPU probe mk (scripts/probe_fused_k4.py:24), the
// TPU's experiment with a k_hi = 4 variant of fused_kernel (split dot,
// fewer buffers).  It computes exactly what fused_apply computes at k = 4;
// it is a probe, not routed by the engine.
//
// Container: re[0..2^n) and im[0..2^n); indexing is 64-bit throughout.
//
// Bound on this card: the state read and written once, 2 * 2^(n+1) * 4
// bytes, and 8 * 2^(n+4) fp32 flops: bound by bytes (5.13 ms at n = 30
// against 2.05 ms of operations, H100 SXM).
//
// Design, for the case the general kernel pays for:
//   * U (16 x 16 complex, 2 KB) is loaded once per block into shared
//     memory; every read of it is a warp-wide broadcast;
//   * each thread owns whole 16-amplitude columns (one rest index each) in
//     registers, loaded straight from device memory and stored straight
//     back: no shared-memory staging of the state and no __syncthreads
//     between load and store;
//   * consecutive threads take consecutive rest indices; gate bits are
//     >= 7, so the low 7 bits of a rest index are those of its address and
//     each warp's load or store is 128 contiguous bytes;
//   * one column per thread, 2^(n-4) / 256 blocks.  A grid-stride loop over
//     columns lets the compiler hoist all 256 loads of U out of the loop
//     into registers, which spill (4.5 KB a thread on sm_90a).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kK = 4;
constexpr int kM = 1 << kK;

struct K4Args {
  int bits[kK];                     // gate bits, MSB of U first
  int sorted[kK];                   // ascending
};

__global__ void __launch_bounds__(kThreads)
fused_k4_kernel(float* __restrict__ re, float* __restrict__ im,
                const float2* __restrict__ U, K4Args a, int64_t ncols) {
  __shared__ __align__(16) float2 us[kM * kM];
  for (int i = threadIdx.x; i < kM * kM; i += kThreads) us[i] = U[i];
  __syncthreads();
  const int64_t c = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (c >= ncols) return;

  int64_t off[kM];
#pragma unroll
  for (int j = 0; j < kM; ++j) {
    int64_t o = 0;
#pragma unroll
    for (int b = 0; b < kK; ++b)
      if ((j >> (kK - 1 - b)) & 1) o |= int64_t(1) << a.bits[b];
    off[j] = o;
  }

  int64_t base = c;
#pragma unroll
  for (int g = 0; g < kK; ++g) {
    const int b = a.sorted[g];
    base = ((base >> b) << (b + 1)) | (base & ((int64_t(1) << b) - 1));
  }
  float xr[kM], xi[kM];
#pragma unroll
  for (int j = 0; j < kM; ++j) {
    xr[j] = re[base + off[j]];
    xi[j] = im[base + off[j]];
  }
#pragma unroll
  for (int i = 0; i < kM; ++i) {
    float yr = 0.f, yi = 0.f;
    const float4* urow = reinterpret_cast<const float4*>(us + i * kM);
#pragma unroll
    for (int j = 0; j < kM; j += 2) {
      const float4 u = urow[j / 2];    // U[i][j], U[i][j + 1]
      yr = fmaf(u.x, xr[j], yr);
      yr = fmaf(-u.y, xi[j], yr);
      yi = fmaf(u.x, xi[j], yi);
      yi = fmaf(u.y, xr[j], yi);
      yr = fmaf(u.z, xr[j + 1], yr);
      yr = fmaf(-u.w, xi[j + 1], yr);
      yi = fmaf(u.z, xi[j + 1], yi);
      yi = fmaf(u.w, xr[j + 1], yi);
    }
    re[base + off[i]] = yr;
    im[base + off[i]] = yi;
  }
}

}  // namespace

// Apply the complex64 16 x 16 row-major matrix U (device pointer) to gate
// bits bits[0..4) (>= 7, MSB first) of the n-qubit state re[0..2^n),
// im[0..2^n), in place.  Returns a cudaError_t (0 on success); the caller
// checks positions (distinct, in range).
extern "C" int hq_fused_k4_apply(float* re, float* im, const void* U, int n,
                                 const int* bits, void* stream) {
  if (n < 11 || n > kK + 8 + 31) return (int)cudaErrorInvalidValue;
  K4Args a;
  for (int i = 0; i < kK; ++i) {
    if (bits[i] < 7 || bits[i] >= n) return (int)cudaErrorInvalidValue;
    a.bits[i] = a.sorted[i] = bits[i];
  }
  for (int i = 1; i < kK; ++i)
    for (int j = i; j > 0 && a.sorted[j - 1] > a.sorted[j]; --j) {
      const int t = a.sorted[j];
      a.sorted[j] = a.sorted[j - 1];
      a.sorted[j - 1] = t;
    }
  const int64_t ncols = int64_t(1) << (n - kK);
  const unsigned grid = (unsigned)((ncols + kThreads - 1) / kThreads);
  fused_k4_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      re, im, static_cast<const float2*>(U), a, ncols);
  return (int)cudaGetLastError();
}
