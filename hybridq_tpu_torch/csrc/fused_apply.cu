// In-place k-qubit gate kernels on the split-complex state container.
//
// Replaces three Pallas TPU kernels:
//   * fused_apply  <- fused_kernel (hybridq_tpu/simulation/pallas_fused.py:
//     175): a gate on physical bits >= 7, applied in place;
//   * swap_apply   <- swap_kernel  (pallas_fused.py:446): a gate that touches
//     1-2 lane bits (< 7), applied while each lane bit a_j trades places with
//     a victim bit v_j (>= 12); amplitude p is stored at sigma(p), sigma
//     swapping bit a_j with bit v_j;
//   * apply_gate_rows <- apply_gate_rows (hybridq_tpu/simulation/
//     pallas_kernels.py:201): a gate on bits of the row index (>= L), on
//     separate flat re and im arrays.
// All three are hq_group_apply here: fused_apply and apply_gate_rows are
// swap_apply with no victims.
//
// Containers: the engine's holds 2^(n+1) floats, the real part of physical
// amplitude p at p and its imaginary part at p + 2^n; apply_gate_rows keeps
// two separate arrays of 2^n floats.  hq_group_apply takes an `re` and an
// `im` pointer and serves both.  Indexing is 64-bit throughout: at n = 30
// the container's p + 2^n already reaches INT_MAX.
//
// Words: a "group" is the 2^(k+kv) amplitudes that differ only in the gate
// and victim bits; a "column" is one (rest index, victim combination) pair,
// the 2^k amplitudes that U mixes.  The TPU kernels blow U up to
// W = block2(kron(U, I)) so that the MXU does everything as one matmul (up
// to 32x the multiply-adds); both kernels here take the 2^k x 2^k complex
// U itself, with gate and victim positions as kernel arguments, never
// template parameters: one build serves every position.  The exchange sigma
// only flips bit pairs (a_j, v_j) of the group bits, so it stays inside the
// group and is folded into the store addresses.
//
// Bound on this card: every call reads and writes the whole state once,
// 2 * 2^(n+1) * 4 bytes, and does 8 * 2^(n+k) fp32 flops.  With 3.35 TB/s
// and 67 TFLOP/s (H100 SXM) k <= 5 is bound by bytes (at k = 5 the flops
// come to 80% of the bytes' time) and k >= 6 by operations on the CUDA
// cores.  Hence two designs:
//
// column_apply_kernel<K>, k = 1..5, bound by bytes: move each byte once
// and keep every load in flight.
//   * One column a thread, in registers: the thread loads its 2^K re/im
//     straight from device memory, computes U x in fp32 FMAs and stores
//     straight back.  No shared-memory staging of the state; K is a
//     template parameter, so every loop over rows and columns unrolls.
//   * The loads go out first.  U (at most 32 x 32 complex, 8 KB) is then
//     copied into shared memory while they are in flight, and read as
//     float4s (two entries of a row) that the whole warp shares as a
//     broadcast.
//   * Address arithmetic once a thread: the rest index is deposited
//     around the sorted group bits once, the K gate-bit masks sit in
//     registers, and a row's address is the base ORed with the masks of
//     its set bits (known at compile time).
//   * Consecutive threadIdx.x take consecutive rest indices, so a warp's
//     load or store is 128 contiguous bytes when the lowest group bit is
//     >= 5, whole 32-byte sectors when it is >= 3.
//   * Ownership: a block of 256 threads holds (256 >> kv) rest indices
//     times all 2^kv victim combinations, i.e. whole groups, so every
//     address it writes is one it has read.  The block's one barrier
//     (after U's copy) comes after every load, so with victims no thread
//     stores at sigma(p) before all have read; no thread returns before
//     it.  Threads past the last column (n < K + 8) are masked.
//
// group_apply_kernel<TM>, k = 6..8, bound by operations: reuse each U
// element across many columns.
//   * Each block owns TILE = min(8192, 2^n) complex amplitudes: M = 2^k
//     rows times BN = TILE / M columns, always whole groups.  Below n = 13
//     the tile is the whole state; threads beyond its BN columns redo the
//     last column (the same reads before the sync, the same values written
//     after it);
//   * the block stages its tile's re/im in shared memory (64 KB), syncs,
//     then each thread computes TM contiguous rows for TN = 32 / TM
//     columns and writes straight back to device memory;
//   * U (up to 256 x 256 complex = 512 KB, more than a block's shared
//     memory) is read through the read-only path: every lane of a warp
//     reads the same element, a broadcast served by L1/L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLogThreads = 8;
constexpr int kTile = 8192;          // complex amplitudes of a full tile
constexpr int kLogTile = 13;
constexpr int kMaxK = 8;             // gate bits
constexpr int kMaxV = 2;             // victim bits
constexpr int kMaxColumnK = 5;       // largest k of column_apply_kernel

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

// The loops over GateArgs' arrays run to a compile-time bound with a
// guard: a runtime index into a kernel argument makes the compiler copy
// the whole struct to local memory (112 bytes of stack a thread).

// r with a zero inserted at each group bit: the physical index of the
// first amplitude of rest index r.
__device__ __forceinline__ int64_t deposit(const GateArgs& a, int64_t r) {
#pragma unroll
  for (int g = 0; g < kMaxK + kMaxV; ++g)
    if (g < a.ng) {
      const int b = a.group[g];
      r = ((r >> b) << (b + 1)) | (r & ((int64_t(1) << b) - 1));
    }
  return r;
}

__device__ __forceinline__ int64_t exchange(const GateArgs& a, int64_t p) {
#pragma unroll
  for (int v = 0; v < kMaxV; ++v)
    if (v < a.kv) {
      const int64_t d = ((p >> a.abits[v]) ^ (p >> a.vbits[v])) & 1;
      p ^= (d << a.abits[v]) | (d << a.vbits[v]);
    }
  return p;
}

// The victim bits set in victim combination vc (MSB of vc = vbits[0]).
__device__ __forceinline__ int64_t victim_offset(const GateArgs& a, int vc) {
  int64_t o = 0;
#pragma unroll
  for (int v = 0; v < kMaxV; ++v)
    if (v < a.kv && ((vc >> (a.kv - 1 - v)) & 1))
      o |= int64_t(1) << a.vbits[v];
  return o;
}

// im[p] is addressed as re[p + im_off] (im_off = im - re, in floats), as
// the container's im[p] is re[p + 2^n].
template <int K>
__global__ void __launch_bounds__(kThreads)
column_apply_kernel(float* __restrict__ re, int64_t im_off,
                    const float2* __restrict__ U, GateArgs a) {
  constexpr int M = 1 << K;
  __shared__ __align__(16) float2 us[M * M];

  // thread = (victim combination vc, rest index r); a warp shares vc
  const int log_rows = kLogThreads - a.kv;
  const int vc = threadIdx.x >> log_rows;
  const int64_t r = ((int64_t)blockIdx.x << log_rows) +
                    (threadIdx.x & ((1 << log_rows) - 1));
  const bool live = r < (int64_t(1) << (a.n - K - a.kv));
  const int64_t base = deposit(a, r) | victim_offset(a, vc);
  int64_t g[K];                        // gate bit b of U's index, MSB first
#pragma unroll
  for (int b = 0; b < K; ++b) g[b] = int64_t(1) << a.gbits[b];
  // the physical index of gate row j of this column (j known at compile
  // time: a few ORs)
  auto row = [&](int j) {
    int64_t p = base;
#pragma unroll
    for (int b = 0; b < K; ++b)
      if ((j >> (K - 1 - b)) & 1) p |= g[b];
    return p;
  };

  float xr[M], xi[M];
  if (live) {
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const int64_t q = row(j);
      xr[j] = re[q];
      xi[j] = re[q + im_off];
    }
  }
  // U into shared memory while those loads are in flight.  The barrier
  // also puts every read of the block before any write, which the
  // victims' exchange needs.
  for (int i = threadIdx.x; i < M * M; i += kThreads) us[i] = U[i];
  __syncthreads();
  if (!live) return;

#pragma unroll
  for (int i = 0; i < M; ++i) {
    float yr = 0.f, yi = 0.f;
    const float4* urow = reinterpret_cast<const float4*>(us + i * M);
#pragma unroll
    for (int j = 0; j < M; j += 2) {
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
    const int64_t q = exchange(a, row(i));
    re[q] = yr;
    re[q + im_off] = yi;
  }
}

template <int K>
cudaError_t launch_column(float* re, int64_t im_off, const float2* U,
                          const GateArgs& a, cudaStream_t stream) {
  const int log_grid = a.n - K - kLogThreads;
  const unsigned grid = log_grid > 0 ? 1u << log_grid : 1u;
  column_apply_kernel<K><<<grid, kThreads, 0, stream>>>(re, im_off, U, a);
  return cudaGetLastError();
}

// Physical index of the first amplitude of local column `col` of block
// `blk`: the rest index deposited around the group bits, plus the victim
// combination.
__device__ __forceinline__ int64_t column_base(const GateArgs& a, int blk,
                                               int col, int log_br) {
  const int br_mask = (1 << log_br) - 1;
  return deposit(a, ((int64_t)blk << log_br) + (col & br_mask)) |
         victim_offset(a, col >> log_br);
}

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
#pragma unroll
    for (int b = 0; b < kMaxK; ++b)
      if (b < a.k && ((j >> (a.k - 1 - b)) & 1))
        o |= int64_t(1) << a.gbits[b];
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
cudaError_t launch_group(float* re, int64_t im_off, const float2* U,
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
  // grid.x < 2^31: 2^(n - k - 8) column blocks, 2^(n - 13) tiles
  const int log_grid = k <= kMaxColumnK ? n - k - kLogThreads
                                        : n - kLogTile;
  if (k < 1 || k > kMaxK || kv < 0 || kv > kMaxV || n < k + kv ||
      log_grid > 30)
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
    case 1: err = launch_column<1>(re, im_off, u, a, st); break;
    case 2: err = launch_column<2>(re, im_off, u, a, st); break;
    case 3: err = launch_column<3>(re, im_off, u, a, st); break;
    case 4: err = launch_column<4>(re, im_off, u, a, st); break;
    case 5: err = launch_column<5>(re, im_off, u, a, st); break;
    case 6: err = launch_group<8>(re, im_off, u, a, st); break;
    case 7: err = launch_group<16>(re, im_off, u, a, st); break;
    default: err = launch_group<32>(re, im_off, u, a, st); break;
  }
  return (int)err;
}
