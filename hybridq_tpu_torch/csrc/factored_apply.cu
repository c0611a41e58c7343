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
// flops (the kron product would cost 8 * 2^(n+kr+kl)).  With 3.35 TB/s and
// 67 TFLOP/s of fp32 on the CUDA cores (H100 SXM) that is bound by bytes
// while 2^kl + 2^kr <= 40.  Factors of k >= 5 run on the tensor cores in
// 3xTF32, 3 * 8 * 2^(n+k) flops at 495 TFLOP/s: the largest case, kr = 9
// and kl = 7, is bound by those operations (33.3 ms at n = 30, against
// 82.1 ms of fp32 on the CUDA cores).
//
// Three routes behind hq_factored_apply.  The first design (one tile of
// 2^13 amplitudes a block in plain row-major shared memory, loaded,
// computed and stored in turn) ran at 2.0-3.2x its bound: 4- to 16-way
// bank conflicts when the lane gate bits were 3-6 or all 7, one or two
// blocks an SM at 128-212 registers, nothing in flight while a block
// computed.
//
// kr + kl <= 4 (every bit set but one that the callers use), bound by
// bytes: every byte crosses once, and each route keeps the loads of other
// blocks in flight while one computes (blocks of 256 threads in the order
// of the state, no persistent blocks).  Each thread applies U_lane to each
// of the 2^kr row combinations of its joint group (the 2^(kr+kl)
// amplitudes that differ in the gate bits), then U_row to each of the
// 2^kl lane combinations, in registers; the factors (at most 16 x 16
// complex) are copied into shared memory while the loads are in flight
// and read as broadcasts.
//   * column_kernel<KR, KL>: one joint group a thread, loaded straight
//     from device memory and stored straight back; consecutive threads
//     take consecutive rest indices.  Where the
//     gate bits leave the 128-byte line whole (every lane gate bit >= 5)
//     each warp access is whole lines.
//   * warp_tile_kernel<KR, KL>, kr <= 2, where a lane gate bit < 5 cuts
//     the line (a warp access straight from device memory would then touch
//     32 bytes of each of four lines): each warp takes 4 whole rows (the
//     row combinations times rest rows), loads them with 16-byte vectors,
//     turns them into joint groups through its own 4 KiB of shared memory
//     (tile_phys order: the chip's lane bits 6-3 read conflict-free), and
//     writes the rows back the same way.
//
// tile_kernel<CT>, kr + kl >= 5:
//   * A tile of 2^rb rows x 2^lb lanes (2^13 amplitudes, 64 KiB of re and
//     im) holds whole joint groups: every combination of the row gate bits
//     (the tile's top bits) and, when the lane factor is applied, all 128
//     lanes (lb = 7).  It sits in shared memory in tile_phys order, an XOR
//     swizzle of its 16-byte chunks by bits 5-9 of the tile index, so that
//     the tensor-core steps below and the 16-byte copies hit 32 distinct
//     banks for every warp access at the callers' bit sets.
//   * Persistent blocks, one an SM (the steps need 240-250 registers),
//     walk the tiles; cp.async brings the next tile into a second stage
//     while the current one is computed (16-byte copies, consecutive
//     threads on consecutive addresses of one row).  Tiles are disjoint,
//     so the next tile's loads may go out before this tile's stores.
//   * A factor of k >= 5 is a step of 3xTF32 mma.sync (csrc/tf32_mma.cuh)
//     on the tile viewed as X[2^k gate combinations][2^(13-k) columns]:
//     eight warps, each RT x CT m16n8 fragments (32 x 32 outputs, or
//     64 x 16 for the 512-row factor), U's A fragments from L1/L2, X's B
//     fragments from the tile through two offset tables kept in tile_phys
//     order (XORed: no swizzle arithmetic a load); both TF32 words of each
//     split rounded to nearest; each k step's six products of an output
//     go into a fresh sum (the first with a zero accumulator), which f32
//     adds then round to nearest, as group_apply_kernel does.  Every read
//     of the step comes before the barrier that precedes its first write.
//     Bound by instruction issue: for each k step's 96 mma.sync a warp
//     issues about 300 other instructions (splits, sums, addresses).
//   * A factor of k <= 4 is a step on the CUDA cores: one column (2^k
//     amplitudes) a thread in registers, read whole before it is written.
//   * A joint group of kr + kl bits is 2^(kr+kl) amplitudes: with kr <= 6 a
//     2^13 tile holds it (rb = 6, lb = 7), one launch that moves the state
//     once.  With kr = 7..9 (up to 512 KB a group, more than a block's
//     shared memory) two launches each move the state once: the lane
//     factor alone on tiles of 2^6 rows x 128 lanes, then the row factor
//     alone on tiles of 2^kr rows x 2^(13-kr) lanes.
// Gate positions are kernel arguments; the template parameters are the
// factor sizes of the small routes and the warp shape of the tile route.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLogThreads = 8;
constexpr int kLogTile = 13;        // log2 of the largest tile
constexpr int kTile = 1 << kLogTile;
constexpr int kLaneBits = 7;        // 128 lanes per row
constexpr int kMaxKr = 9;           // row factor bits
constexpr int kMaxKl = 7;           // lane factor bits
constexpr int kMaxStep = 9;
constexpr int kMaxColumnK = 4;      // column route: kr + kl <= 4
constexpr int kMinMmaK = 5;         // tile steps on the tensor cores
constexpr int kMaxRows = 1 << kMaxKr;          // rows of a tile
constexpr int kMaxCols = kTile >> kMinMmaK;    // columns of an mma step
// dynamic shared memory of tile_kernel: two stages of re and im, the row
// offsets of each, and the offset tables of the two steps
constexpr size_t kTileSmem = 2 * 2 * kTile * sizeof(float) +
                             2 * kMaxRows * sizeof(int64_t) +
                             2 * (kMaxRows + kMaxCols) * sizeof(int);

}  // namespace

// Position (in floats) of tile index i in shared memory: bits 2-4 (the
// 16-byte chunk within a 128-byte line) XORed with bits 9, 5 ^ 7 ^ 9 and
// 6 ^ 8, an involution that keeps every 16-byte chunk whole.  A warp
// access of the tile route varies five tile bits; it is free of bank
// conflicts when their images under i -> tile_phys(i) % 32 are linearly
// independent over GF(2): bits 0 and 1 map to banks bits 0 and 1, bits
// 2-4 to bank bits 2-4, and bits 5, 6, 7, 8, 9 to bank bits 3, 4, 3, 4 and
// 2 ^ 3.  That holds for the 16-byte copies (bits 2-4 in each quarter
// warp), for the lane step on all 7 lane bits (B fragments vary bits 0, 1,
// 7, 8, 9; C stores 0, 1, 2, 8, 9) and for the row steps of k = 5..9 on
// the tile's top bits (their B fragments and float2 C stores).  The map is
// linear over GF(2), tile_phys(a ^ b) = tile_phys(a) ^ tile_phys(b), so the
// steps keep their offset tables in tile_phys order and XOR them.
__host__ __device__ __forceinline__ int tile_phys(int i) {
  const int s = ((i >> 9) & 1) | (((i >> 5) ^ (i >> 7) ^ (i >> 9)) & 1) << 1 |
                (((i >> 6) ^ (i >> 8)) & 1) << 2;
  return i ^ (s << 2);
}

namespace {

// The loops over the argument structs' arrays run to a compile-time bound
// with a guard: a runtime index into a kernel argument makes the compiler
// copy the whole struct to local memory.

// ---- column route ----------------------------------------------------

void sort_ascending(int* v, int k) {
  for (int i = 1; i < k; ++i)
    for (int j = i; j > 0 && v[j - 1] > v[j]; --j) {
      const int t = v[j];
      v[j] = v[j - 1];
      v[j - 1] = t;
    }
}


struct ColumnArgs {
  int n;
  int bits[kMaxColumnK];            // U_row's bits MSB first, then U_lane's
  int sorted[kMaxColumnK];          // all of them ascending
};

// Both factors into shared memory.
template <int KR, int KL>
__device__ __forceinline__ void factors_to_shared(
    float2* ul, float2* ur, const float2* __restrict__ Ul,
    const float2* __restrict__ Ur) {
  for (int i = threadIdx.x; i < (1 << (2 * KL)); i += kThreads) ul[i] = Ul[i];
  if (KR)
    for (int i = threadIdx.x; i < (1 << (2 * KR)); i += kThreads)
      ur[i] = Ur[i];
}

// U_lane, then U_row, on a joint group in registers: x[j] is row
// combination j >> KL and lane combination j % 2^KL.
template <int KR, int KL>
__device__ __forceinline__ void apply_factors(float* xr, float* xi,
                                              const float2* ul,
                                              const float2* ur) {
  constexpr int MR = 1 << KR, ML = 1 << KL;
  constexpr int MX = ML > MR ? ML : MR;
  // y = U x over the Mf amplitudes x[first + stride * j]
  auto apply = [&](const float2* u, int Mf, int first, int stride) {
    float yr[MX], yi[MX];
#pragma unroll
    for (int i = 0; i < MX; ++i) {
      if (i >= Mf) break;
      float sr = 0.f, si = 0.f;
#pragma unroll
      for (int j = 0; j < MX; ++j) {
        if (j >= Mf) break;
        const float2 w = u[i * Mf + j];
        const float x_r = xr[first + stride * j];
        const float x_i = xi[first + stride * j];
        sr = fmaf(w.x, x_r, sr);
        sr = fmaf(-w.y, x_i, sr);
        si = fmaf(w.x, x_i, si);
        si = fmaf(w.y, x_r, si);
      }
      yr[i] = sr;
      yi[i] = si;
    }
#pragma unroll
    for (int i = 0; i < MX; ++i) {
      if (i >= Mf) break;
      xr[first + stride * i] = yr[i];
      xi[first + stride * i] = yi[i];
    }
  };
#pragma unroll
  for (int jr = 0; jr < MR; ++jr) apply(ul, ML, jr * ML, 1);
  if (KR) {
#pragma unroll
    for (int jl = 0; jl < ML; ++jl) apply(ur, MR, jl, ML);
  }
}

template <int KR, int KL>
__global__ void __launch_bounds__(kThreads)
column_kernel(float* __restrict__ re, float* __restrict__ im,
              const float2* __restrict__ Ur, const float2* __restrict__ Ul,
              ColumnArgs a) {
  constexpr int K = KR + KL;
  constexpr int MR = 1 << KR, ML = 1 << KL, M = 1 << K;
  __shared__ __align__(16) float2 ul[ML * ML];
  __shared__ __align__(16) float2 ur[MR * MR];

  const int64_t r = ((int64_t)blockIdx.x << kLogThreads) + threadIdx.x;
  const bool live = r < (int64_t(1) << (a.n - K));
  int64_t base = r;                 // r with a zero at each gate bit
#pragma unroll
  for (int g = 0; g < K; ++g) {
    const int b = a.sorted[g];
    base = ((base >> b) << (b + 1)) | (base & ((int64_t(1) << b) - 1));
  }
  int64_t gm[K];
#pragma unroll
  for (int b = 0; b < K; ++b) gm[b] = int64_t(1) << a.bits[b];
  // amplitude (row combination j >> KL, lane combination j % ML)
  auto at = [&](int j) {
    int64_t p = base;
#pragma unroll
    for (int b = 0; b < K; ++b)
      if ((j >> (K - 1 - b)) & 1) p |= gm[b];
    return p;
  };

  float xr[M], xi[M];
  if (live) {
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const int64_t p = at(j);
      xr[j] = re[p];
      xi[j] = im[p];
    }
  }
  factors_to_shared<KR, KL>(ul, ur, Ul, Ur);
  __syncthreads();
  if (!live) return;
  apply_factors<KR, KL>(xr, xi, ul, ur);

#pragma unroll
  for (int j = 0; j < M; ++j) {
    const int64_t p = at(j);
    re[p] = xr[j];
    im[p] = xi[j];
  }
}

// ---- warp-tile route -------------------------------------------------

constexpr int kWarpTileBits = 9;     // 4 rows of 128 lanes a warp
constexpr int kWarpTile = 1 << kWarpTileBits;
constexpr int kWarps = kThreads / 32;

// Warp w of block b takes warp tile 8 b + w: 4 rows, the 2^KR combinations
// of the row gate bits (the tile row's top bits) times 2^(2-KR) rest rows,
// all 128 lanes.  It loads them with 16-byte vectors (each instruction four
// whole 128-byte lines), puts them into its own part of shared memory in
// tile_phys order, applies both factors to 2^(4-KR-KL) joint groups a
// lane in registers, and writes the rows back the same way.  Only the
// warp's own threads touch its part: __syncwarp orders them.
template <int KR, int KL>
__global__ void __launch_bounds__(kThreads)
warp_tile_kernel(float* __restrict__ re, float* __restrict__ im,
                 const float2* __restrict__ Ur,
                 const float2* __restrict__ Ul, ColumnArgs a) {
  constexpr int K = KR + KL, M = 1 << K;
  constexpr int MR = 1 << KR, ML = 1 << KL;
  constexpr int RR = 2 - KR;        // rest-row bits of a warp tile
  __shared__ __align__(16) float xs[kWarps][2][kWarpTile];
  __shared__ __align__(16) float2 ul[ML * ML];
  __shared__ __align__(16) float2 ur[MR * MR];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t wt = (int64_t)blockIdx.x * kWarps + warp;
  const bool live = wt < (int64_t(1) << (a.n - kWarpTileBits));

  // rows t = (g, rr): g the row combination (MSB of U_row first)
  int64_t rowoff[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    int64_t r = (wt << RR) | (t & ((1 << RR) - 1));
#pragma unroll
    for (int m = 0; m < KR; ++m) {  // the row bits ascending
      const int b = a.sorted[KL + m] - kLaneBits;
      r = ((r >> b) << (b + 1)) | (r & ((int64_t(1) << b) - 1));
    }
#pragma unroll
    for (int i = 0; i < KR; ++i)
      if (((t >> RR) >> (KR - 1 - i)) & 1)
        r |= int64_t(1) << (a.bits[i] - kLaneBits);
    rowoff[t] = r << kLaneBits;
  }
  float4 vr[4], vi[4];
  if (live) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      vr[t] = *reinterpret_cast<const float4*>(re + rowoff[t] + 4 * lane);
      vi[t] = *reinterpret_cast<const float4*>(im + rowoff[t] + 4 * lane);
    }
  }
  factors_to_shared<KR, KL>(ul, ur, Ul, Ur);
  __syncthreads();
  if (!live) return;

  float* tr = xs[warp][0];
  float* ti = xs[warp][1];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int d = tile_phys(t * 128 + 4 * lane);
    *reinterpret_cast<float4*>(tr + d) = vr[t];
    *reinterpret_cast<float4*>(ti + d) = vi[t];
  }
  __syncwarp();

  // gate bit b (MSB of U first) as a bit of the warp tile's index: the
  // row bits are the tile row's top KR bits, the lane bits themselves
  int go[K];
#pragma unroll
  for (int b = 0; b < K; ++b)
    go[b] = tile_phys(b < KR ? 1 << (kWarpTileBits - 1 - b) : 1 << a.bits[b]);
#pragma unroll
  for (int s = 0; s < (1 << (4 - K)); ++s) {
    int c = s * 32 + lane;          // the joint group: c with a zero at
#pragma unroll                      // each gate bit of the tile, ascending
    for (int m = 0; m < K; ++m) {
      const int b = m < KL ? a.sorted[m] : kWarpTileBits - KR + (m - KL);
      c = ((c >> b) << (b + 1)) | (c & ((1 << b) - 1));
    }
    const int base = tile_phys(c);
    auto at = [&](int j) {
      int p = base;
#pragma unroll
      for (int b = 0; b < K; ++b)
        if ((j >> (K - 1 - b)) & 1) p ^= go[b];
      return p;
    };
    float xr[M], xi[M];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      xr[j] = tr[at(j)];
      xi[j] = ti[at(j)];
    }
    apply_factors<KR, KL>(xr, xi, ul, ur);
#pragma unroll
    for (int j = 0; j < M; ++j) {
      tr[at(j)] = xr[j];
      ti[at(j)] = xi[j];
    }
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int d = tile_phys(t * 128 + 4 * lane);
    *reinterpret_cast<float4*>(re + rowoff[t] + 4 * lane) =
        *reinterpret_cast<const float4*>(tr + d);
    *reinterpret_cast<float4*>(im + rowoff[t] + 4 * lane) =
        *reinterpret_cast<const float4*>(ti + d);
  }
}

// kr + kl <= 4: the warp tiles where a lane gate bit cuts the 128-byte
// line (bit < 5) and they fit (kr <= 2, n >= 9), else one joint group a
// thread.
template <int KR, int KL>
cudaError_t launch_column(float* re, float* im, int n, const float2* Ur,
                          const int* rbits, const float2* Ul,
                          const int* lbits, cudaStream_t st) {
  ColumnArgs a = {};
  a.n = n;
  for (int i = 0; i < KR; ++i) a.bits[i] = rbits[i];
  for (int i = 0; i < KL; ++i) a.bits[KR + i] = lbits[i];
  for (int i = 0; i < KR + KL; ++i) a.sorted[i] = a.bits[i];
  sort_ascending(a.sorted, KR + KL);
  const bool cut = a.sorted[0] < 5;  // the lowest gate bit is a lane bit
  const bool tiled = cut && KR <= 2 && n >= kWarpTileBits;
  const int log_grid = tiled ? n - kWarpTileBits - 3  // 8 warps a block
                             : n - KR - KL - kLogThreads;
  const unsigned grid = log_grid > 0 ? 1u << log_grid : 1u;
  void (*kern)(float*, float*, const float2*, const float2*, ColumnArgs) =
      column_kernel<KR, KL>;
  if constexpr (KR <= 2)
    if (tiled) kern = warp_tile_kernel<KR, KL>;
  kern<<<grid, kThreads, 0, st>>>(re, im, Ur, Ul, a);
  return cudaGetLastError();
}

cudaError_t column_route(float* re, float* im, int n, const float2* Ur,
                         int kr, const int* rbits, const float2* Ul, int kl,
                         const int* lbits, cudaStream_t st) {
  switch (kr * 8 + kl) {
    case 1: return launch_column<0, 1>(re, im, n, Ur, rbits, Ul, lbits, st);
    case 2: return launch_column<0, 2>(re, im, n, Ur, rbits, Ul, lbits, st);
    case 3: return launch_column<0, 3>(re, im, n, Ur, rbits, Ul, lbits, st);
    case 4: return launch_column<0, 4>(re, im, n, Ur, rbits, Ul, lbits, st);
    case 9: return launch_column<1, 1>(re, im, n, Ur, rbits, Ul, lbits, st);
    case 10: return launch_column<1, 2>(re, im, n, Ur, rbits, Ul, lbits, st);
    case 11: return launch_column<1, 3>(re, im, n, Ur, rbits, Ul, lbits, st);
    case 17: return launch_column<2, 1>(re, im, n, Ur, rbits, Ul, lbits, st);
    case 18: return launch_column<2, 2>(re, im, n, Ur, rbits, Ul, lbits, st);
    case 25: return launch_column<3, 1>(re, im, n, Ur, rbits, Ul, lbits, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---- tile route ------------------------------------------------------

// One factor as seen inside the tile: its bits as tile-index bits.
struct Step {
  int k;                            // 0: the factor is not applied
  int sb[kMaxStep];                 // tile bits, MSB of U first
  int sorted[kMaxStep];             // the same, ascending
};

struct TileArgs {
  int n;
  int rb;                           // log2 of the tile's rows
  int lb;                           // log2 of the tile's lanes
  int kr;                           // row gate bits of this launch
  int rrow[kMaxKr];                 // row gate bits as row-index bits
                                    // (flat - 7), MSB of U_row first
  int rrow_sorted[kMaxKr];
  Step lane, row;
};

// r with a zero inserted at each of the k tile bits s.sorted
__device__ __forceinline__ int deposit(int r, const Step& s) {
#pragma unroll
  for (int g = 0; g < kMaxStep; ++g)
    if (g < s.k) {
      const int b = s.sorted[g];
      r = ((r >> b) << (b + 1)) | (r & ((1 << b) - 1));
    }
  return r;
}

// Tile offset of gate combination j (MSB of U first) of step s.
__device__ __forceinline__ int gate_offset(int j, const Step& s) {
  int o = 0;
#pragma unroll
  for (int b = 0; b < kMaxStep; ++b)
    if (b < s.k && ((j >> (s.k - 1 - b)) & 1)) o |= 1 << s.sb[b];
  return o;
}

// Float offset in re (and im) of row t of tile `tile`: tile row t =
// (g, rr), g the row gate combination (MSB of U_row first), rr the rest
// row; the tile's lanes are chunk `tile % 2^(7 - lb)` of the row.
__device__ __forceinline__ int64_t row_offset(const TileArgs& a, int tile,
                                              int t) {
  const int log_chunks = kLaneBits - a.lb;
  const int64_t chunk = tile & ((1 << log_chunks) - 1);
  const int64_t rowblk = (int64_t)tile >> log_chunks;
  const int log_rr = a.rb - a.kr;
  const int g = t >> log_rr;
  int64_t r = (rowblk << log_rr) | (t & ((1 << log_rr) - 1));
#pragma unroll
  for (int i = 0; i < kMaxKr; ++i)
    if (i < a.kr) {
      const int b = a.rrow_sorted[i];
      r = ((r >> b) << (b + 1)) | (r & ((int64_t(1) << b) - 1));
    }
#pragma unroll
  for (int i = 0; i < kMaxKr; ++i)
    if (i < a.kr && ((g >> (a.kr - 1 - i)) & 1)) r |= int64_t(1) << a.rrow[i];
  return (r << kLaneBits) | (chunk << a.lb);
}

// A factor of k <= 4 on the CUDA cores: one column (the 2^k amplitudes
// that differ in the step's bits) a thread, read whole into registers,
// multiplied by U (uniform loads through the read-only path) and written
// back; no other thread touches the column.
__device__ __forceinline__ void fma_step(float* xr, float* xi,
                                         const float2* __restrict__ U,
                                         const Step& s, int log_tile) {
  constexpr int kMax = 1 << kMaxColumnK;
  const int M = 1 << s.k;
  int so[kMax];                     // gate offsets, in tile_phys order
#pragma unroll
  for (int j = 0; j < kMax; ++j)
    so[j] = j < M ? tile_phys(gate_offset(j, s)) : 0;
  const int N = 1 << (log_tile - s.k);
  for (int c = threadIdx.x; c < N; c += kThreads) {
    const int base = tile_phys(deposit(c, s));
    float x_r[kMax], x_i[kMax];
#pragma unroll
    for (int j = 0; j < kMax; ++j)
      if (j < M) {
        const int p = base ^ so[j];
        x_r[j] = xr[p];
        x_i[j] = xi[p];
      }
#pragma unroll
    for (int i = 0; i < kMax; ++i)
      if (i < M) {
        float yr = 0.f, yi = 0.f;
#pragma unroll
        for (int j = 0; j < kMax; ++j)
          if (j < M) {
            const float2 u = __ldg(U + i * M + j);
            yr = fmaf(u.x, x_r[j], yr);
            yr = fmaf(-u.y, x_i[j], yr);
            yi = fmaf(u.x, x_i[j], yi);
            yi = fmaf(u.y, x_r[j], yi);
          }
        const int p = base ^ so[i];
        xr[p] = yr;
        xi[p] = yi;
      }
  }
  __syncthreads();
}

#ifdef __CUDACC__  // a host build of this source brings its own
// d = A B (tf32_mma.cuh's mma_tf32 with a zero accumulator): the first
// product of a fresh sum, with no registers to clear first.
__device__ __forceinline__ void mma_tf32_zero(float* d, const uint32_t* a,
                                              const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}
#endif

// The 3xTF32 split with both words rounded to nearest in TF32 (ties away):
// big = tf32(x), small = tf32(x - big), each in two integer operations for
// a finite x.  tf32_mma.cuh's split_finite leaves small for the tensor
// cores to truncate, which costs this kernel's two steps of up to 2^9
// terms a factor of about 2 in max|d|/rms.
__device__ __forceinline__ void split_round(float x, uint32_t& big,
                                            uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = (__float_as_uint(x - __uint_as_float(big)) + 0x1000u) & 0xffffe000u;
}

// The six 3xTF32 products of Yr = Ur Xr - Ui Xi (row 0) and Yi = Ur Xi +
// Ui Xr (row 1), small ones first: A operand kProdA[p] (Ur big, Ur small,
// Ui big, Ui small) times B operand kProdB[.][p] (Xr big, Xr small, Xi
// big, Xi small, -Xi big, -Xi small).  An mma.sync does not round its f32
// sum to nearest, so each k step's six go into a fresh sum first.
__device__ constexpr int kProdA[6] = {1, 0, 3, 2, 0, 2};
__device__ constexpr int kProdB[2][6] = {{0, 1, 4, 5, 0, 4},
                                         {2, 3, 0, 1, 2, 0}};

// A factor of k >= 5 on the tensor cores: Y = U X with X[j][c] the tile at
// qoff[j] ^ coff[c] (j: gate combination, MSB of U first; c: column; both
// tables in tile_phys order).
// Warp w owns rows [row0, row0 + 16 RT) and columns [col0, col0 + 8 CT);
// columns past the tile's last (2^(log_tile - k) < 8 CT) are masked.
template <int CT>
__device__ __forceinline__ void mma_step(float* xr, float* xi,
                                         const int* qoff, const int* coff,
                                         const float2* __restrict__ U,
                                         const Step& s, int log_tile) {
  constexpr int RT = 8 / CT;
  constexpr int WR = 16 * RT, WC = 8 * CT;
  constexpr uint32_t kSign = 0x80000000u;
  const int M = 1 << s.k;
  const int N = 1 << (log_tile - s.k);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;   // fragment row group, column
  const int nwc = N > WC ? N / WC : 1;
  const int row0 = (warp / nwc) * WR;
  const int col0 = (warp % nwc) * WC;
  const bool busy = row0 < M;
  // float2 stores of columns c, c + 1 when tile bit 0 is not a gate bit
  const bool pair = s.sorted[0] != 0 && N >= 2;

  float accr[RT][CT][4], acci[RT][CT][4];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int ct = 0; ct < CT; ++ct)
#pragma unroll
      for (int q = 0; q < 4; ++q) accr[rt][ct][q] = acci[rt][ct][q] = 0.f;
  int cb[CT];                       // tile offset of B column col0+8ct+g
#pragma unroll
  for (int ct = 0; ct < CT; ++ct) {
    const int c = col0 + 8 * ct + g;
    cb[ct] = c < N ? coff[c] : -1;
  }

  if (busy) {
    // A fragment element (g, t) of this warp's first m16 tile
    const float2* Uw = U + (int64_t)(row0 + g) * M + t;
#pragma unroll 1
    for (int j0 = 0; j0 < M; j0 += 8) {
      // A (16 x 8, row-major): (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
      uint32_t af[4][RT][4];        // Ur big, Ur small, Ui big, Ui small
#pragma unroll
      for (int rt = 0; rt < RT; ++rt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 u =
              __ldg(Uw + (int64_t)(16 * rt + 8 * (q & 1)) * M + j0 +
                    4 * (q >> 1));
          split_round(u.x, af[0][rt][q], af[1][rt][q]);
          split_round(u.y, af[2][rt][q], af[3][rt][q]);
        }
      const int q0 = qoff[j0 + t], q1 = qoff[j0 + t + 4];
#pragma unroll
      for (int ct = 0; ct < CT; ++ct) {
        // B (8 x 8, column-major): rows j0 + t and j0 + t + 4, column g
        uint32_t bf[6][2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float vr = 0.f, vi = 0.f;
          if (cb[ct] >= 0) {
            const int p = (h ? q1 : q0) ^ cb[ct];
            vr = xr[p];
            vi = xi[p];
          }
          split_round(vr, bf[0][h], bf[1][h]);
          split_round(vi, bf[2][h], bf[3][h]);
          bf[4][h] = bf[2][h] ^ kSign;
          bf[5][h] = bf[3][h] ^ kSign;
        }
        float part[RT][2][4];
#pragma unroll
        for (int p = 0; p < 6; ++p)
#pragma unroll
          for (int rt = 0; rt < RT; ++rt)
#pragma unroll
            for (int ri = 0; ri < 2; ++ri)
              if (p == 0)
                mma_tf32_zero(part[rt][ri], af[kProdA[p]][rt],
                              bf[kProdB[ri][p]]);
              else
                mma_tf32(part[rt][ri], af[kProdA[p]][rt], bf[kProdB[ri][p]]);
#pragma unroll
        for (int rt = 0; rt < RT; ++rt)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            accr[rt][ct][q] += part[rt][0][q];
            acci[rt][ct][q] += part[rt][1][q];
          }
      }
    }
  }
  __syncthreads();                  // every read of the tile before a write

  if (busy) {
    // C (16 x 8): (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int qi = qoff[row0 + 16 * rt + 8 * h + g];
#pragma unroll
        for (int ct = 0; ct < CT; ++ct) {
          const int c = col0 + 8 * ct + 2 * t;
          if (c >= N) continue;
          const float* yr = accr[rt][ct] + 2 * h;
          const float* yi = acci[rt][ct] + 2 * h;
          if (pair) {               // c even: coff[c + 1] = coff[c] ^ 1
            const int p = qi ^ coff[c];
            *reinterpret_cast<float2*>(xr + p) = make_float2(yr[0], yr[1]);
            *reinterpret_cast<float2*>(xi + p) = make_float2(yi[0], yi[1]);
          } else {
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (c + e < N) {
                const int p = qi ^ coff[c + e];
                xr[p] = yr[e];
                xi[p] = yi[e];
              }
          }
        }
      }
  }
  __syncthreads();
}

template <int CT>
__device__ __forceinline__ void tile_step(float* xr, float* xi,
                                          const int* qoff, const int* coff,
                                          const float2* __restrict__ U,
                                          const Step& s, int log_tile) {
  if (s.k >= kMinMmaK)
    mma_step<CT>(xr, xi, qoff, coff, U, s, log_tile);
  else
    fma_step(xr, xi, U, s, log_tile);
}

// The offset tables of an mma step, in tile_phys order: qoff[j] for every
// gate combination j, coff[c] for every column c.
__device__ __forceinline__ void step_tables(int* qoff, int* coff,
                                            const Step& s, int log_tile) {
  if (s.k < kMinMmaK) return;
  for (int j = threadIdx.x; j < (1 << s.k); j += kThreads)
    qoff[j] = tile_phys(gate_offset(j, s));
  for (int c = threadIdx.x; c < (1 << (log_tile - s.k)); c += kThreads)
    coff[c] = tile_phys(deposit(c, s));
}

template <int CT>
__global__ void __launch_bounds__(kThreads, 1)
tile_kernel(float* __restrict__ re, float* __restrict__ im,
            const float2* __restrict__ Ur, const float2* __restrict__ Ul,
            TileArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);      // [2][re, im][kTile]
  int64_t* ro = reinterpret_cast<int64_t*>(xs + 2 * 2 * kTile);  // [2][rows]
  int* qoff = reinterpret_cast<int*>(ro + 2 * kMaxRows);   // lane, row
  int* coff = qoff + 2 * kMaxRows;                         // lane, row
  const int log_tile = a.rb + a.lb;
  const int n4 = 1 << (log_tile - 2);       // 16-byte chunks of a tile
  const int lane_mask = (1 << a.lb) - 1;
  const int tiles = 1 << (a.n - log_tile);

  step_tables(qoff, coff, a.lane, log_tile);
  step_tables(qoff + kMaxRows, coff + kMaxCols, a.row, log_tile);
  auto rows = [&](int tile, int64_t* r) {
    for (int t = threadIdx.x; t < (1 << a.rb); t += kThreads)
      r[t] = row_offset(a, tile, t);
  };
  auto issue = [&](int st) {
    float* xr = xs + st * 2 * kTile;
    const int64_t* r = ro + st * kMaxRows;
    for (int q = threadIdx.x; q < n4; q += kThreads) {
      const int i = q << 2;
      const int64_t p = r[i >> a.lb] + (i & lane_mask);
      const int d = tile_phys(i);
      cp_async<16>(xr + d, re + p);
      cp_async<16>(xr + kTile + d, im + p);
    }
  };

  int tile = blockIdx.x;
  rows(tile, ro);
  __syncthreads();
  issue(0);
  cp_async_commit();
  for (int it = 0; tile < tiles; ++it, tile += gridDim.x) {
    const int st = it & 1;
    const int next = tile + gridDim.x;
    __syncthreads();                // stage st ^ 1 is free: its stores ran
    if (next < tiles) rows(next, ro + (st ^ 1) * kMaxRows);
    __syncthreads();
    if (next < tiles) issue(st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();             // this tile's copies have landed
    __syncthreads();

    float* xr = xs + st * 2 * kTile;
    float* xi = xr + kTile;
    if (a.lane.k) tile_step<CT>(xr, xi, qoff, coff, Ul, a.lane, log_tile);
    if (a.row.k)
      tile_step<CT>(xr, xi, qoff + kMaxRows, coff + kMaxCols, Ur, a.row,
                    log_tile);

    const int64_t* r = ro + st * kMaxRows;
    for (int q = threadIdx.x; q < n4; q += kThreads) {
      const int i = q << 2;
      const int64_t p = r[i >> a.lb] + (i & lane_mask);
      const int d = tile_phys(i);
      *reinterpret_cast<float4*>(re + p) =
          *reinterpret_cast<const float4*>(xr + d);
      *reinterpret_cast<float4*>(im + p) =
          *reinterpret_cast<const float4*>(xi + d);
    }
  }
}

// One launch of the tile route: the lane factor on lbits (kl = 0: none)
// and the row factor on rbits (kr = 0: none), on tiles of 2^rb rows x 2^lb
// lanes; walks the tiles with at most one block an SM.
cudaError_t launch_tiles(float* re, float* im, int n, const float2* Ur,
                         int kr, const int* rbits, const float2* Ul, int kl,
                         const int* lbits, int rb, int lb, cudaStream_t st) {
  TileArgs a = {};
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
  // the 512-row factor: warps of 64 x 16 outputs, else 32 x 32
  auto* kern = kr == kMaxKr ? tile_kernel<2> : tile_kernel<4>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kTileSmem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t tiles = int64_t(1) << (n - rb - lb);
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  kern<<<grid, kThreads, kTileSmem, st>>>(re, im, Ur, Ul, a);
  return cudaGetLastError();
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
  if (kr + kl <= kMaxColumnK && n - kr - kl - kLogThreads <= 30)
    return (int)column_route(re, im, n, ur, kr, rbits, ul, kl, lbits, st);
  const int rows = n - kLaneBits;               // row bits of the state
  const int rb = rows < kLogTile - kLaneBits ? rows : kLogTile - kLaneBits;
  if (kr <= rb)                                 // joint groups fit a tile
    return (int)launch_tiles(re, im, n, ur, kr, rbits, ul, kl, lbits, rb,
                             kLaneBits, st);
  cudaError_t err = launch_tiles(re, im, n, ur, 0, rbits, ul, kl, lbits, rb,
                                 kLaneBits, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_tiles(re, im, n, ur, kr, rbits, ul, 0, lbits, kr,
                           kLogTile - kr, st);
}
