// In-place U_row (x) U_lane on the split-complex state container.
//
// Replaces the Pallas TPU kernel factored_kernel
// (hybridq_tpu/simulation/pallas_fused.py:633, operators from
// build_w_factored, :596): a gate that is the tensor product of a factor
// U_row on bits >= 7 (possibly none) and a factor U_lane on 1-7 lane bits
// (< 7), at a cost that does not grow with the product's size.
//
// Container: re[0..2^n) and im[0..2^n) (the engine passes its container's
// two halves).  A "row" is 128 consecutive amplitudes (bits 0-6, the
// lanes); indexing is 64-bit throughout.
//
// Bound on this card: one pass reads and writes the state once,
// 2 * 2^(n+1) * 4 bytes, and the two factors cost 8 * 2^n * (2^kl + 2^kr)
// fp32 flops (the kron product would cost 8 * 2^(n+kr+kl)).  With
// 3.35 TB/s and 67 TFLOP/s (H100 SXM) that is bound by bytes while
// 2^kl + 2^kr <= 40 and by operations on the CUDA cores beyond (the
// largest case, kr = 9 and kl = 7, needs 8 * 2^n * 640 flops).
//
// Design.  The TPU kernel multiplies each stack half by a 128x128 lane
// operator (Br, Bi) and then by the kron-expanded row operator W.  Here
// both factors are their own 2^k x 2^k complex matrices:
//   * a block stages a tile of 2^rb rows x 2^lb lanes (at most 2^13
//     amplitudes, 64 KB) in shared memory with 16-byte loads, consecutive
//     threads on consecutive addresses of one row;
//   * the tile holds whole joint groups: every combination of the row gate
//     bits (the tile's top bits) and, when the lane factor is applied,
//     all 128 lanes (lb = 7);
//   * it applies U_lane along the lane gate bits, then U_row along the row
//     gate bits, each step in shared memory: each thread computes TM rows
//     of U for TN = 32 / TM columns in registers (U read through the
//     read-only path, a warp-wide broadcast), syncs, writes them back;
//   * it stores the tile with 16-byte stores: every amplitude crosses
//     device memory once each way.
// A joint group of kr + kl bits is 2^(kr+kl) amplitudes: with kr <= 6 a
// 2^13 tile holds it (rb = 6, lb = 7), one launch.  With kr = 7..9 (up to
// 512 KB a group, more than a block's shared memory) the same kernel runs
// twice: the lane factor alone (kr = 0), then the row factor alone on
// tiles of 2^kr rows x 2^(13-kr) lanes (kl = 0); that case moves the
// state twice.
// Gate positions are kernel arguments; the template parameters are the
// rows per thread of each step, TM = min(2^k, 8).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLogTile = 13;        // log2 of the largest tile
constexpr int kLaneBits = 7;        // 128 lanes per row
constexpr int kMaxKr = 9;           // row factor bits
constexpr int kMaxKl = 7;           // lane factor bits
constexpr int kMaxStep = 9;

// One factor as seen inside the tile: its bits as tile-index bits.
struct Step {
  int k;                            // 0: the factor is not applied
  int sb[kMaxStep];                 // tile bits, MSB of U first
  int sorted[kMaxStep];             // the same, ascending
};

struct FactArgs {
  int n;
  int rb;                           // log2 of the tile's rows
  int lb;                           // log2 of the tile's lanes
  int kr;                           // row gate bits of this launch
  int rrow[kMaxKr];                 // row gate bits as row-index bits
                                    // (flat - 7), MSB of U_row first
  int rrow_sorted[kMaxKr];
  Step lane, row;
};

template <typename T>
__device__ __forceinline__ T deposit(T r, const int* sorted, int k) {
  for (int g = 0; g < k; ++g) {
    const int b = sorted[g];
    const T lo = r & ((T(1) << b) - 1);
    r = ((r >> b) << (b + 1)) | lo;
  }
  return r;
}

// Apply the 2^k x 2^k complex matrix U along tile bits s.sb, in place on
// the tile (xr, xi) of 2^log_tile amplitudes.  soff: 2^k ints of scratch.
template <int TM>
__device__ __forceinline__ void tile_step(float* xr, float* xi, int* soff,
                                          const float2* __restrict__ U,
                                          const Step& s, int log_tile) {
  constexpr int TN = 32 / TM;
  const int k = s.k;
  const int M = 1 << k;
  const int TR = M / TM;
  const int TC = kThreads / TR;
  const int BN = 1 << (log_tile - k);
  const int tr = threadIdx.x / TC;
  const int tc = threadIdx.x % TC;

  for (int j = threadIdx.x; j < M; j += kThreads) {
    int o = 0;
    for (int b = 0; b < k; ++b)
      if ((j >> (k - 1 - b)) & 1) o |= 1 << s.sb[b];
    soff[j] = o;
  }
  __syncthreads();

  int base[TN];
  float ar[TN][TM], ai[TN][TM];
#pragma unroll
  for (int tn = 0; tn < TN; ++tn) {
    base[tn] = deposit(tc + TC * tn, s.sorted, k);
#pragma unroll
    for (int m = 0; m < TM; ++m) ar[tn][m] = ai[tn][m] = 0.f;
  }
  const float2* Urows = U + (int64_t)(tr * TM) * M;
  for (int j = 0; j < M; ++j) {
    const int o = soff[j];
    float2 u[TM];
#pragma unroll
    for (int m = 0; m < TM; ++m) u[m] = __ldg(&Urows[(int64_t)m * M + j]);
#pragma unroll
    for (int tn = 0; tn < TN; ++tn) {
      if (tc + TC * tn < BN) {
        const float x_r = xr[base[tn] + o];
        const float x_i = xi[base[tn] + o];
#pragma unroll
        for (int m = 0; m < TM; ++m) {
          ar[tn][m] = fmaf(u[m].x, x_r, ar[tn][m]);
          ar[tn][m] = fmaf(-u[m].y, x_i, ar[tn][m]);
          ai[tn][m] = fmaf(u[m].x, x_i, ai[tn][m]);
          ai[tn][m] = fmaf(u[m].y, x_r, ai[tn][m]);
        }
      }
    }
  }
  __syncthreads();                  // every input read before any write
#pragma unroll
  for (int tn = 0; tn < TN; ++tn) {
    if (tc + TC * tn < BN) {
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        const int p = base[tn] + soff[tr * TM + m];
        xr[p] = ar[tn][m];
        xi[p] = ai[tn][m];
      }
    }
  }
  __syncthreads();
}

template <int TMR, int TML>
__global__ void __launch_bounds__(kThreads)
factored_kernel(float* __restrict__ re, float* __restrict__ im,
                const float2* __restrict__ Ur,
                const float2* __restrict__ Ul, FactArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int log_tile = a.rb + a.lb;
  const int tile = 1 << log_tile;
  float* xr = reinterpret_cast<float*>(smem_raw);           // [2^rb][2^lb]
  float* xi = xr + tile;
  int64_t* rowoff = reinterpret_cast<int64_t*>(xi + tile);  // [2^rb]
  int* soff = reinterpret_cast<int*>(rowoff + (1 << a.rb));  // [<= 512]

  // Block -> (rest-row block, lane chunk); tile row t = (g, rr), g the
  // row gate combination (MSB of U_row first), rr the rest row.
  const int log_chunks = kLaneBits - a.lb;
  const int64_t chunk = blockIdx.x & ((1 << log_chunks) - 1);
  const int64_t rowblk = (int64_t)blockIdx.x >> log_chunks;
  const int log_rr = a.rb - a.kr;
  for (int t = threadIdx.x; t < (1 << a.rb); t += kThreads) {
    const int g = t >> log_rr;
    int64_t r = (rowblk << log_rr) | (t & ((1 << log_rr) - 1));
    r = deposit(r, a.rrow_sorted, a.kr);
    for (int i = 0; i < a.kr; ++i)
      if ((g >> (a.kr - 1 - i)) & 1) r |= int64_t(1) << a.rrow[i];
    rowoff[t] = (r << kLaneBits) | (chunk << a.lb);
  }
  __syncthreads();

  const int log_q = a.lb - 2;       // float4 per tile row
  float4* xr4 = reinterpret_cast<float4*>(xr);
  float4* xi4 = reinterpret_cast<float4*>(xi);
  for (int i = threadIdx.x; i < (tile >> 2); i += kThreads) {
    const int64_t p = rowoff[i >> log_q] + 4 * (i & ((1 << log_q) - 1));
    xr4[i] = *reinterpret_cast<const float4*>(re + p);
    xi4[i] = *reinterpret_cast<const float4*>(im + p);
  }
  __syncthreads();

  if (a.lane.k) tile_step<TML>(xr, xi, soff, Ul, a.lane, log_tile);
  if (a.row.k) tile_step<TMR>(xr, xi, soff, Ur, a.row, log_tile);

  for (int i = threadIdx.x; i < (tile >> 2); i += kThreads) {
    const int64_t p = rowoff[i >> log_q] + 4 * (i & ((1 << log_q) - 1));
    *reinterpret_cast<float4*>(re + p) = xr4[i];
    *reinterpret_cast<float4*>(im + p) = xi4[i];
  }
}

void sort_ascending(int* v, int k) {
  for (int i = 1; i < k; ++i)
    for (int j = i; j > 0 && v[j - 1] > v[j]; --j) {
      const int t = v[j];
      v[j] = v[j - 1];
      v[j - 1] = t;
    }
}

int rows_per_thread(int k) { return k >= 3 ? 8 : (1 << k); }

template <int TMR, int TML>
cudaError_t launch_tm(float* re, float* im, const float2* Ur,
                      const float2* Ul, const FactArgs& a,
                      cudaStream_t stream) {
  const size_t smem = 2 * (size_t(1) << (a.rb + a.lb)) * sizeof(float) +
                      (size_t(1) << a.rb) * sizeof(int64_t) +
                      (size_t(1) << kMaxStep) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      factored_kernel<TMR, TML>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)(uint64_t(1) << (a.n - a.rb - a.lb));
  factored_kernel<TMR, TML><<<grid, kThreads, smem, stream>>>(re, im, Ur,
                                                               Ul, a);
  return cudaGetLastError();
}

template <int TMR>
cudaError_t launch_l(float* re, float* im, const float2* Ur,
                     const float2* Ul, const FactArgs& a, cudaStream_t st) {
  switch (rows_per_thread(a.lane.k)) {
    case 1: return launch_tm<TMR, 1>(re, im, Ur, Ul, a, st);
    case 2: return launch_tm<TMR, 2>(re, im, Ur, Ul, a, st);
    case 4: return launch_tm<TMR, 4>(re, im, Ur, Ul, a, st);
    default: return launch_tm<TMR, 8>(re, im, Ur, Ul, a, st);
  }
}

// One launch: the lane factor on lbits (kl = 0: none) and the row factor
// on rbits (kr = 0: none), on tiles of 2^rb rows x 2^lb lanes.
cudaError_t launch(float* re, float* im, int n, const float2* Ur, int kr,
                   const int* rbits, const float2* Ul, int kl,
                   const int* lbits, int rb, int lb, cudaStream_t st) {
  FactArgs a = {};
  a.n = n;
  a.rb = rb;
  a.lb = lb;
  a.kr = kr;
  for (int i = 0; i < kr; ++i) a.rrow[i] = a.rrow_sorted[i] = rbits[i] - 7;
  sort_ascending(a.rrow_sorted, kr);
  a.lane.k = kl;
  for (int i = 0; i < kl; ++i) a.lane.sb[i] = a.lane.sorted[i] = lbits[i];
  sort_ascending(a.lane.sorted, kl);
  a.row.k = kr;
  for (int i = 0; i < kr; ++i) {
    a.row.sb[i] = rb + lb - 1 - i;  // g: the tile's top kr bits
    a.row.sorted[i] = rb + lb - kr + i;
  }
  switch (rows_per_thread(kr)) {
    case 1: return launch_l<1>(re, im, Ur, Ul, a, st);
    case 2: return launch_l<2>(re, im, Ur, Ul, a, st);
    case 4: return launch_l<4>(re, im, Ur, Ul, a, st);
    default: return launch_l<8>(re, im, Ur, Ul, a, st);
  }
}

}  // namespace

// Apply U_row (x) U_lane in place to the n-qubit state re[0..2^n),
// im[0..2^n): U_row (complex64 2^kr x 2^kr, row-major, device pointer) on
// flat bits rbits[0..kr) (>= 7, MSB first), U_lane (2^kl x 2^kl) on flat
// bits lbits[0..kl) (< 7, MSB first).  re and im must be 16-byte aligned.
// Returns a cudaError_t (0 on success); the caller checks positions
// (distinct, in range).
extern "C" int hq_factored_apply(float* re, float* im, int n, const void* Ur,
                                 int kr, const int* rbits, const void* Ul,
                                 int kl, const int* lbits, void* stream) {
  if (n < kLaneBits || n > kLogTile + 30 || kr < 0 || kr > kMaxKr ||
      kl < 1 || kl > kMaxKl || kr > n - kLaneBits)
    return (int)cudaErrorInvalidValue;
  const float2* ur = static_cast<const float2*>(Ur);
  const float2* ul = static_cast<const float2*>(Ul);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = n - kLaneBits;               // row bits of the state
  const int rb = rows < kLogTile - kLaneBits ? rows : kLogTile - kLaneBits;
  if (kr <= rb)                                 // joint groups fit a tile
    return (int)launch(re, im, n, ur, kr, rbits, ul, kl, lbits, rb,
                       kLaneBits, st);
  cudaError_t err = launch(re, im, n, ur, 0, rbits, ul, kl, lbits, rb,
                           kLaneBits, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch(re, im, n, ur, kr, rbits, ul, 0, lbits, kr,
                     kLogTile - kr, st);
}
