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
// 2 * 2^(n+1) * 4 bytes, and does 8 * 2^(n+k) flops.  With 3.35 TB/s and
// 67 TFLOP/s of fp32 on the CUDA cores (H100 SXM) k <= 5 is bound by bytes
// (at k = 5 the flops come to 80% of the bytes' time).  From k = 6 the
// product goes to the tensor cores in 3xTF32, 3 * 8 * 2^(n+k) flops at
// 495 TFLOP/s: k = 6 is still bound by bytes (1.28 against 0.83 ms at
// n = 28), k = 7 and 8 by operations (1.67 and 3.33 ms).  Hence two
// designs:
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
// group_apply_kernel<K>, k = 6..8, on the tensor cores: the TPU kernel's
// own arithmetic (the MXU at Precision.HIGHEST), as 3xTF32 mma.sync.
//   * Real form: Yr = Ur Xr - Ui Xi, Yi = Ui Xr + Ur Xi, four real
//     products on mma.sync.aligned.m16n8k8 (TF32 in, f32 accumulate), each
//     in 3xTF32: small.big + big.small + big.big, the small products of a
//     k step first.  Both operands are split in registers as their
//     fragments are loaded (split_finite: big rounded as cvt.rna rounds,
//     in 2 integer operations; the residual left for the tensor cores to
//     truncate); -Xi is Xi with its sign bits flipped.
//   * Tiles: a tile is M = 2^K rows times BN = 2^13 / M columns (BN = 128,
//     64, 32), always whole groups: BN / 2^kv rest indices times all 2^kv
//     victim combinations.  Its re and im sit in dynamic shared memory,
//     rows padded to BN + 8 floats so that a B fragment's 8 columns times
//     4 rows hit 32 banks.  Columns past the state's last (n < K + kv +
//     log BN) are zeros and are never stored.
//   * Persistent blocks, at most one an SM (the two stages take 139-165
//     KiB), walk the tiles.  While the tensor cores work on one tile,
//     cp.async brings the next into the other stage: the groups of two
//     tiles are disjoint, so its loads may go out before this tile's
//     stores.  Each cp.async moves V = 4, 2 or 1 floats, the longest run
//     that the lowest group bit, the rest count and the alignment of re
//     and im - re allow (TMA tensor maps do not fit: a tile's rows are
//     gathered through up to 10 arbitrary bits, a tensor map has 5
//     dimensions).  Every read of a tile lands before the barrier that
//     precedes its first store, so the store may go to sigma(p) in place.
//   * Eight warps a block, each 32 rows times 32 columns (two m16 by four
//     n8 fragments, 64 accumulators a thread).  A k step's six products of
//     an output go into a fresh sum, pass by pass over the eight sums of
//     two n8 fragments, so that consecutive mma.sync do not wait on each
//     other's accumulator; the sums are then added to the accumulators in
//     f32, rounded to nearest (kProdA).  U (32-512 KB, more than a block's
//     shared memory at K = 8) streams from L1/L2 as A fragments, one k step
//     ahead (across tiles too); every tile reads all of it once per block
//     column of warps: (2^(n-K) / BN) 2^(2K) 8 bytes a launch, 16 GiB at
//     n = 28, K = 8, against the state's 4 GiB.
//   * Stores go from the accumulators to sigma(base | goff) = sigma(base) |
//     sigma(goff) (sigma permutes bits), from two tables in shared memory:
//     float2 stores of two neighbouring columns when V >= 2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLogThreads = 8;
constexpr int kLogTile = 13;         // 2^13 amplitudes a group tile
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

// Rows of U and columns of a tile that one warp owns, and the padding of a
// shared-memory row (floats).
constexpr int kWarpRows = 32;
constexpr int kWarpCols = 32;
constexpr int kPad = 8;

template <int K>
struct GroupTile {
  static constexpr int M = 1 << K;                 // gate rows
  static constexpr int LOG_BN = kLogTile - K;
  static constexpr int BN = 1 << LOG_BN;           // columns of a tile
  static constexpr int S = BN + kPad;              // shared row stride
  static constexpr int WC = BN / kWarpCols;        // warps across columns
  static constexpr int STAGE = 2 * M * S;          // floats: re, then im
  // two stages, the store bases of each, the gate offsets and their sigma
  static constexpr size_t SMEM = 2 * STAGE * sizeof(float) +
                                 (2 * BN + 2 * M) * sizeof(int64_t);
  static_assert((M / kWarpRows) * WC * 32 == kThreads, "8 warps a tile");
};

// Issue the copies of tile `tile` into one stage: thread (j0, cv) copies
// vector column cv (V floats) of rows j0, j0 + kThreads / NV, ..., re and
// im; the threads of row 0 record sigma of their columns' bases.  Dead
// columns (rest index past the state's last) become zeros.
template <int K, int V>
__device__ __forceinline__ void issue_tile(
    const float* __restrict__ re, int64_t im_off, const GateArgs& a,
    int tile, float* stage, int64_t* cst, const int64_t* goff, int log_br,
    int log_rest) {
  using T = GroupTile<K>;
  constexpr int NV = T::BN / V;
  constexpr int RSTEP = kThreads / NV;
  const int cv = threadIdx.x % NV;
  const int j0 = threadIdx.x / NV;
  const int col = cv * V;
  const int rl = col & ((1 << log_br) - 1);
  float* dst = stage + col;
  if (log_rest >= log_br || rl < (1 << log_rest)) {
    const int64_t cb = deposit(a, ((int64_t)tile << log_br) + rl) |
                       victim_offset(a, col >> log_br);
    if (j0 == 0) {
      const int64_t cs = exchange(a, cb);
#pragma unroll
      for (int v = 0; v < V; ++v) cst[col + v] = cs + v;
    }
    for (int j = j0; j < T::M; j += RSTEP) {
      const float* src = re + (cb + goff[j]);
      cp_async<4 * V>(dst + j * T::S, src);
      cp_async<4 * V>(dst + (T::M + j) * T::S, src + im_off);
    }
  } else {
    for (int j = j0; j < T::M; j += RSTEP)
#pragma unroll
      for (int v = 0; v < V; ++v)
        dst[j * T::S + v] = dst[(T::M + j) * T::S + v] = 0.f;
  }
}

// The six 3xTF32 products of Yr = Ur Xr - Ui Xi (row 0) and Yi = Ur Xi +
// Ui Xr (row 1), small ones first: A operand kProdA[p] (Ur big, Ur small,
// Ui big, Ui small) times B operand kProdB[.][p] (Xr big, Xr small, Xi
// big, Xi small, -Xi big, -Xi small).  An mma.sync adds to its f32
// accumulator with a rounding that is not to nearest (on an H100, with
// all 6 * 2^k / 8 products of a k loop in one accumulator, max|d|/rms
// grew with k past 1e-5 at k = 7 and 8), so each k step's six go into a
// fresh sum first, which f32 adds then round to nearest.
__device__ constexpr int kProdA[6] = {1, 0, 3, 2, 0, 2};
__device__ constexpr int kProdB[2][6] = {{0, 1, 4, 5, 0, 4},
                                         {2, 3, 0, 1, 2, 0}};

template <int K>
__global__ void __launch_bounds__(kThreads, 1)
group_apply_kernel(float* __restrict__ re, int64_t im_off,
                   const float2* __restrict__ U, GateArgs a) {
  using T = GroupTile<K>;
  constexpr int M = T::M, BN = T::BN, S = T::S;
  constexpr int RT = kWarpRows / 16;     // m16 fragments a warp
  constexpr int CT = kWarpCols / 8;      // n8 fragments a warp
  constexpr int CB = 2;                  // n8 fragments a batch
  constexpr uint32_t kSign = 0x80000000u;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);       // [2][2][M][S]
  int64_t* cst = reinterpret_cast<int64_t*>(xs + 2 * T::STAGE);  // [2][BN]
  int64_t* goff = cst + 2 * BN;                         // [M]
  int64_t* gst = goff + M;                              // [M]

  for (int j = threadIdx.x; j < M; j += kThreads) {
    int64_t o = 0;
#pragma unroll
    for (int b = 0; b < K; ++b)
      if ((j >> (K - 1 - b)) & 1) o |= int64_t(1) << a.gbits[b];
    goff[j] = o;
    gst[j] = exchange(a, o);
  }
  __syncthreads();

  // V = 2^log_vec floats a copy: within a run of the lowest group bit,
  // within the rest count, and aligned in re and in im = re + im_off.
  const int log_br = T::LOG_BN - a.kv;         // rest indices a tile
  const int log_rest = a.n - K - a.kv;         // rest indices in all
  const uintptr_t align = reinterpret_cast<uintptr_t>(re) |
                          static_cast<uintptr_t>(im_off * 4);
  int log_vec = 2;
  while (log_vec > 0 && (a.group[0] < log_vec || log_rest < log_vec ||
                         (align & ((uintptr_t(4) << log_vec) - 1))))
    --log_vec;
  auto issue = [&](int tile, int st) {
    float* stage = xs + st * T::STAGE;
    int64_t* c = cst + st * BN;
    if (log_vec == 2)
      issue_tile<K, 4>(re, im_off, a, tile, stage, c, goff, log_br,
                       log_rest);
    else if (log_vec == 1)
      issue_tile<K, 2>(re, im_off, a, tile, stage, c, goff, log_br,
                       log_rest);
    else
      issue_tile<K, 1>(re, im_off, a, tile, stage, c, goff, log_br,
                       log_rest);
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, column
  const int row0 = (warp / T::WC) * kWarpRows;
  const int col0 = (warp % T::WC) * kWarpCols;
  // A fragment element (g, t) of this warp's first m16 tile at k step 0
  const float2* Uw = U + (int64_t)(row0 + g) * M + t;
  float2 un[RT][4];                      // U's next A fragments, raw
  auto load_u = [&](int j0) {
#pragma unroll
    for (int rt = 0; rt < RT; ++rt) {
      const float2* u = Uw + (int64_t)(16 * rt) * M + j0;
      un[rt][0] = __ldg(u);
      un[rt][1] = __ldg(u + 8 * M);
      un[rt][2] = __ldg(u + 4);
      un[rt][3] = __ldg(u + 8 * M + 4);
    }
  };

  const int tiles = 1 << (a.n - a.log_tile);
  int tile = blockIdx.x;
  issue(tile, 0);
  cp_async_commit();
  load_u(0);
  for (int it = 0; tile < tiles; ++it, tile += gridDim.x) {
    const int st = it & 1;
    if (tile + (int)gridDim.x < tiles) issue(tile + gridDim.x, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                  // this tile's copies have landed
    __syncthreads();

    const float* xr = xs + st * T::STAGE;
    const float* xi = xr + M * S;
    float accr[RT][CT][4], acci[RT][CT][4];
#pragma unroll
    for (int rt = 0; rt < RT; ++rt)
#pragma unroll
      for (int ct = 0; ct < CT; ++ct)
#pragma unroll
        for (int q = 0; q < 4; ++q) accr[rt][ct][q] = acci[rt][ct][q] = 0.f;
#pragma unroll 1
    for (int j0 = 0; j0 < M; j0 += 8) {
      uint32_t af[4][RT][4];             // Ur big, Ur small, Ui big, Ui small
#pragma unroll
      for (int rt = 0; rt < RT; ++rt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          split_finite(un[rt][q].x, af[0][rt][q], af[1][rt][q]);
          split_finite(un[rt][q].y, af[2][rt][q], af[3][rt][q]);
        }
      load_u(j0 + 8 < M ? j0 + 8 : 0);   // the next tile starts at 0
#pragma unroll
      for (int c0 = 0; c0 < CT; c0 += CB) {
        // B fragments (8 x 8, column-major): rows j0 + t and j0 + t + 4;
        // Xr big, Xr small, Xi big, Xi small, -Xi big, -Xi small
        uint32_t bf[CB][6][2];
#pragma unroll
        for (int cb = 0; cb < CB; ++cb) {
          const int x0 = (j0 + t) * S + col0 + (c0 + cb) * 8 + g;
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            split_finite(xr[x0 + 4 * q * S], bf[cb][0][q], bf[cb][1][q]);
            split_finite(xi[x0 + 4 * q * S], bf[cb][2][q], bf[cb][3][q]);
            bf[cb][4][q] = bf[cb][2][q] ^ kSign;
            bf[cb][5][q] = bf[cb][3][q] ^ kSign;
          }
        }
        // This k step's six products of each output into a fresh sum, pass
        // by pass over 4 * CB independent sums, then added to the
        // accumulators in f32 (see kProdA).
        float part[CB][RT][2][4];
#pragma unroll
        for (int cb = 0; cb < CB; ++cb)
#pragma unroll
          for (int rt = 0; rt < RT; ++rt)
#pragma unroll
            for (int q = 0; q < 8; ++q) part[cb][rt][q / 4][q % 4] = 0.f;
#pragma unroll
        for (int p = 0; p < 6; ++p)
#pragma unroll
          for (int cb = 0; cb < CB; ++cb)
#pragma unroll
            for (int rt = 0; rt < RT; ++rt)
#pragma unroll
              for (int ri = 0; ri < 2; ++ri)
                mma_tf32(part[cb][rt][ri], af[kProdA[p]][rt],
                         bf[cb][kProdB[ri][p]]);
#pragma unroll
        for (int cb = 0; cb < CB; ++cb)
#pragma unroll
          for (int rt = 0; rt < RT; ++rt)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              accr[rt][c0 + cb][q] += part[cb][rt][0][q];
              acci[rt][c0 + cb][q] += part[cb][rt][1][q];
            }
      }
    }

    // C fragment (16 x 8): (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
    const int64_t* cs = cst + st * BN;
    const int br_mask = (1 << log_br) - 1;
#pragma unroll
    for (int ct = 0; ct < CT; ++ct) {
      const int c = col0 + ct * 8 + 2 * t;
      const bool live0 =
          log_rest >= log_br || (c & br_mask) < (1 << log_rest);
      const bool live1 =
          log_rest >= log_br || ((c + 1) & br_mask) < (1 << log_rest);
#pragma unroll
      for (int rt = 0; rt < RT; ++rt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int64_t go = gst[row0 + 16 * rt + 8 * h + g];
          const float* yr = accr[rt][ct] + 2 * h;
          const float* yi = acci[rt][ct] + 2 * h;
          if (log_vec > 0) {             // c, c + 1 adjacent and aligned
            if (live0) {
              float* p = re + (cs[c] | go);
              *reinterpret_cast<float2*>(p) = make_float2(yr[0], yr[1]);
              *reinterpret_cast<float2*>(p + im_off) =
                  make_float2(yi[0], yi[1]);
            }
          } else {
            if (live0) {
              float* p = re + (cs[c] | go);
              p[0] = yr[0];
              p[im_off] = yi[0];
            }
            if (live1) {
              float* p = re + (cs[c + 1] | go);
              p[0] = yr[1];
              p[im_off] = yi[1];
            }
          }
        }
    }
    __syncthreads();                     // the stage is free for reuse
  }
}

template <int K>
cudaError_t launch_group(float* re, int64_t im_off, const float2* U,
                         const GateArgs& a, cudaStream_t stream) {
  using T = GroupTile<K>;
  cudaError_t err = cudaFuncSetAttribute(
      group_apply_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)T::SMEM);
  if (err != cudaSuccess) return err;
  int dev, sms;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int tiles = 1 << (a.n - a.log_tile);
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  group_apply_kernel<K><<<grid, kThreads, T::SMEM, stream>>>(re, im_off, U,
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
  // grid.x < 2^31: 2^(n - k - 8) column blocks; tile indices < 2^31:
  // 2^(n - 13) tiles of 2^13 amplitudes, walked by at most one block an SM
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
    case 6: err = launch_group<6>(re, im_off, u, a, st); break;
    case 7: err = launch_group<7>(re, im_off, u, a, st); break;
    default: err = launch_group<8>(re, im_off, u, a, st); break;
  }
  return (int)err;
}
