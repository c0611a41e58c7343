// In-place k-qubit gate kernels on the split-complex state container.
//
// Replaces two Pallas TPU kernels of hybridq_tpu/simulation/pallas_fused.py:
//   * fused_apply  <- fused_kernel (pallas_fused.py:175): a gate on physical
//     bits >= 7, applied in place;
//   * swap_apply   <- swap_kernel  (pallas_fused.py:446): a gate that touches
//     1-2 lane bits (< 7), applied while each lane bit a_j trades places with
//     a victim bit v_j (>= 12); amplitude p is stored at sigma(p), sigma
//     swapping bit a_j with bit v_j.
// Both are one kernel here: fused_apply is swap_apply with no victims.
//
// It also replaces a third, on another container:
//   * apply_gate_rows <- apply_gate_rows (hybridq_tpu/simulation/
//     pallas_kernels.py:201): a gate on bits of the row index (>= L), on
//     separate flat re and im arrays.
//
// Containers: the engine's holds 2^(n+1) floats, the real part of physical
// amplitude p at p and its imaginary part at p + 2^n; apply_gate_rows keeps
// two separate arrays of 2^n floats.  hq_group_apply takes an `re` and an
// `im` pointer and serves both.  Indexing is 64-bit throughout: at n = 30
// the container's p + 2^n already reaches INT_MAX.
//
// Bound on this card: every call reads and writes the whole state once,
// 2 * 2^(n+1) * 4 bytes, and does 8 * 2^(n+k) fp32 flops.  With 3.35 TB/s
// and 67 TFLOP/s (H100 SXM) the classes up to k = 5 are bound by bytes and
// k >= 6 by operations on the CUDA cores.
//
// Design.  The TPU kernel blows U up to W = block2(kron(U, I)) so that the
// MXU can do everything as one matmul (up to 32x the multiply-adds).  Here
// the gate is the 2^k x 2^k complex matrix itself:
//   * a "group" is the 2^(k+kv) amplitudes that differ only in the gate and
//     victim bits; a "column" is one (rest index, victim combination) pair,
//     i.e. the 2^k amplitudes that U mixes;
//   * each block owns TILE = min(8192, 2^n) complex amplitudes: M = 2^k rows
//     times BN = TILE / M columns, and always whole groups (all victim
//     combinations of its rest indices), so the sigma of every address it
//     writes is an address it has read: blocks never touch each other's
//     data.  Below n = 13 the tile is the whole state; threads beyond its
//     BN columns redo the last column (the same reads before the sync,
//     the same values written after it);
//   * the block stages its tile's re/im in shared memory (64 KB), syncs, then
//     each thread computes TM contiguous rows for TN = 32 / TM columns in
//     fp32 FMAs and writes straight back to device memory;
//   * consecutive threads walk consecutive rest indices, so loads and stores
//     are coalesced whenever the low bits are not gate bits;
//   * U (up to 256 x 256 complex = 512 KB, more than a block's shared
//     memory) is read through the read-only path: every lane of a warp reads
//     the same element, so each load is a broadcast served by L1/L2;
//   * gate and victim positions are kernel arguments, never template
//     parameters: one build serves every position.  The only template
//     parameter is TM, the rows per thread, fixed by k.
// The exchange sigma costs nothing extra: it is folded into the store
// address of each output element.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 8192;          // complex amplitudes of a full tile
constexpr int kLogTile = 13;
constexpr int kMaxK = 8;             // gate bits
constexpr int kMaxV = 2;             // victim bits

struct GateArgs {
  int n;                             // amplitude bits (stack bit excluded)
  int k;                             // gate bits
  int kv;                            // victim bits (0: fused_apply)
  int ng;                            // k + kv
  int gbits[kMaxK];                  // gate bits, MSB of the U index first
  int abits[kMaxV];                  // lane bit paired with ...
  int vbits[kMaxV];                  // ... this victim bit
  int group[kMaxK + kMaxV];          // gate and victim bits, ascending
  int log_tile;                      // min(kLogTile, n)
};

// Physical index of the first amplitude of local column `col` of block
// `blk`: the rest index deposited around the group bits, plus the victim
// combination.
__device__ __forceinline__ int64_t column_base(const GateArgs& a, int blk,
                                               int col, int log_br) {
  const int br_mask = (1 << log_br) - 1;
  int64_t r = ((int64_t)blk << log_br) + (col & br_mask);
  for (int g = 0; g < a.ng; ++g) {
    const int b = a.group[g];
    const int64_t lo = r & ((int64_t(1) << b) - 1);
    r = ((r >> b) << (b + 1)) | lo;
  }
  const int vc = col >> log_br;
  for (int v = 0; v < a.kv; ++v)
    if ((vc >> (a.kv - 1 - v)) & 1) r |= int64_t(1) << a.vbits[v];
  return r;
}

__device__ __forceinline__ int64_t exchange(const GateArgs& a, int64_t p) {
  for (int v = 0; v < a.kv; ++v) {
    const int64_t d = ((p >> a.abits[v]) ^ (p >> a.vbits[v])) & 1;
    p ^= (d << a.abits[v]) | (d << a.vbits[v]);
  }
  return p;
}

// im[p] is addressed as re[p + im_off] (im_off = im - re, in floats), as
// the container's im[p] is re[p + 2^n]: one 64-bit add per access, where
// a second base costs a shift and two (3% of the k = 4 kernel on the
// H100).
template <int TM>
__global__ void __launch_bounds__(kThreads)
group_apply_kernel(float* __restrict__ re, int64_t im_off,
                   const float2* __restrict__ U, GateArgs a) {
  constexpr int TN = 32 / TM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // xi at a constant offset from xr: the block takes a full tile's
  // shared memory even when its tile is smaller.
  float* xr = reinterpret_cast<float*>(smem_raw);   // [M][BN]
  float* xi = xr + kTile;                           // [M][BN]
  int64_t* goff = reinterpret_cast<int64_t*>(xi + kTile);  // [M]

  const int M = 1 << a.k;
  const int log_bn = a.log_tile - a.k;
  const int BN = 1 << log_bn;
  const int log_br = log_bn - a.kv;
  const int TR = M / TM;                 // row threads
  const int TC = kThreads / TR;          // column threads
  const int tr = threadIdx.x / TC;
  const int tc = threadIdx.x % TC;
  const int blk = blockIdx.x;

  for (int j = threadIdx.x; j < M; j += kThreads) {
    int64_t o = 0;
    for (int b = 0; b < a.k; ++b)
      if ((j >> (a.k - 1 - b)) & 1) o |= int64_t(1) << a.gbits[b];
    goff[j] = o;
  }
  __syncthreads();

  // Stage the tile: thread (tr, tc) loads rows tr*TM.. of its columns.
  for (int tn = 0; tn < TN; ++tn) {
    const int col = min(tc + TC * tn, BN - 1);
    const int64_t base = column_base(a, blk, col, log_br);
#pragma unroll
    for (int m = 0; m < TM; ++m) {
      const int j = tr * TM + m;
      const float* r = re + (base + goff[j]);
      xr[j * BN + col] = r[0];
      xi[j * BN + col] = r[im_off];
    }
  }
  __syncthreads();

  const float2* Urows = U + (int64_t)(tr * TM) * M;
  for (int tn = 0; tn < TN; ++tn) {
    const int col = min(tc + TC * tn, BN - 1);
    float ar[TM], ai[TM];
#pragma unroll
    for (int m = 0; m < TM; ++m) ar[m] = ai[m] = 0.f;
    for (int j = 0; j < M; ++j) {
      const float x_r = xr[j * BN + col];
      const float x_i = xi[j * BN + col];
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        const float2 u = __ldg(&Urows[m * M + j]);
        ar[m] = fmaf(u.x, x_r, ar[m]);
        ar[m] = fmaf(-u.y, x_i, ar[m]);
        ai[m] = fmaf(u.x, x_i, ai[m]);
        ai[m] = fmaf(u.y, x_r, ai[m]);
      }
    }
    const int64_t base = column_base(a, blk, col, log_br);
#pragma unroll
    for (int m = 0; m < TM; ++m) {
      float* r = re + exchange(a, base + goff[tr * TM + m]);
      r[0] = ar[m];
      r[im_off] = ai[m];
    }
  }
}

template <int TM>
cudaError_t launch(float* re, int64_t im_off, const float2* U,
                   const GateArgs& a, cudaStream_t stream) {
  const size_t smem = 2 * kTile * sizeof(float) +
                      (size_t(1) << a.k) * sizeof(int64_t);
  cudaError_t err = cudaFuncSetAttribute(
      group_apply_kernel<TM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)(uint64_t(1) << (a.n - a.log_tile));
  group_apply_kernel<TM><<<grid, kThreads, smem, stream>>>(re, im_off, U,
                                                           a);
  return cudaGetLastError();
}

}  // namespace

// Apply the complex64 2^k x 2^k row-major matrix U (device pointer) to
// gate bits gbits[0..k) (MSB first) of the n-qubit state whose real parts
// are re[0..2^n) and imaginary parts im[0..2^n), in place; with kv > 0,
// also exchange lane bit abits[j] with victim bit vbits[j].  Returns a
// cudaError_t (0 on success); the caller checks positions (distinct, in
// range, victims disjoint from the gate).
extern "C" int hq_group_apply(float* re, float* im, const void* U, int n,
                              int k, const int* gbits, int kv,
                              const int* abits, const int* vbits,
                              void* stream) {
  if (k < 1 || k > kMaxK || kv < 0 || kv > kMaxV || n < k + kv ||
      n > kLogTile + 30)                // grid.x < 2^31
    return (int)cudaErrorInvalidValue;
  const int64_t im_bytes = (int64_t)reinterpret_cast<uintptr_t>(im) -
                           (int64_t)reinterpret_cast<uintptr_t>(re);
  if (im_bytes % (int64_t)sizeof(float)) return (int)cudaErrorInvalidValue;
  const int64_t im_off = im_bytes / (int64_t)sizeof(float);
  GateArgs a;
  a.n = n;
  a.log_tile = n < kLogTile ? n : kLogTile;
  a.k = k;
  a.kv = kv;
  a.ng = k + kv;
  for (int i = 0; i < k; ++i) a.gbits[i] = a.group[i] = gbits[i];
  for (int i = 0; i < kv; ++i) {
    a.abits[i] = abits[i];
    a.vbits[i] = a.group[k + i] = vbits[i];
  }
  for (int i = 1; i < a.ng; ++i)       // insertion sort, ascending
    for (int j = i; j > 0 && a.group[j - 1] > a.group[j]; --j) {
      const int t = a.group[j];
      a.group[j] = a.group[j - 1];
      a.group[j - 1] = t;
    }
  const float2* u = static_cast<const float2*>(U);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (k) {
    case 1: case 2: case 3: err = launch<1>(re, im_off, u, a, st); break;
    case 4: err = launch<2>(re, im_off, u, a, st); break;
    case 5: err = launch<4>(re, im_off, u, a, st); break;
    case 6: err = launch<8>(re, im_off, u, a, st); break;
    case 7: err = launch<16>(re, im_off, u, a, st); break;
    default: err = launch<32>(re, im_off, u, a, st); break;
  }
  return (int)err;
}
