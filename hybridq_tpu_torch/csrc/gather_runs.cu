// In-place gathered-run copy x = 2 * x (or x = bf16(x) through the tensor
// cores) over a [rows, 128] f32 array: the card's bandwidth by run length.
//
// Replaces the Pallas TPU kernel mk_gather (scripts/probe_pallas_gather.py
// l.32): each step gathers blk_sub rows as runs of run_sub rows (512 B a
// row) from scrambled sources (src_of, l.44-50), scales them, or with
// matmul = True multiplies each 128-row chunk by eye(128) in bf16 with f32
// accumulation, and writes every run back where it came from.
//
// Bound on this card: the array read once and written once, 2 * rows * 512
// bytes over 3.35 TB/s (1.28 ms at the probe's 2 GiB, H100 SXM); the
// matmul variant's 2 * 128 flops a float at 989 TFLOP/s (bf16) stay below
// it.
//
// Design:
//   * Rows are taken in the gathered ("virtual") order; unit u is virtual
//     rows [u * stage_rows, (u + 1) * stage_rows).  Virtual row v lies in
//     run r = v / run_rows at offset v % run_rows, and its source is
//     row src(r) * run_rows + v % run_rows with src the probe's scramble
//     (swap the low `half` bits of r with the rest).  Every run keeps its
//     byte size: a stage holds stage_rows / run_rows whole runs, or a run
//     longer than a stage streams over several stages.
//   * One persistent block per SM walks its units through an nbuf-stage
//     ring in shared memory (the TPU kernel's step).  Warp 0 moves each run
//     piece with one 1-D TMA bulk copy, its 32 lanes issuing the pieces of a
//     stage in turn; a stage's loads complete on its mbarrier, which
//     expects the whole stage's bytes.  A one-row run is four 128-byte
//     segments at a scrambled address: each copy is coalesced within its
//     run, never across runs.
//   * The stage is computed in place and written back with bulk copies
//     shared -> global to the same source rows; a stage is refilled once
//     its stores have read it (cp.async.bulk.wait_group.read; bulk groups
//     are per thread, so every lane of warp 0 waits on its own).
//   * matmul: warp w of 16 owns columns [8 w, 8 w + 8) of each 128-row
//     chunk and computes eye(128) . bf16(chunk) with
//     mma.sync.aligned.m16n8k16 (bf16 in, f32 accumulate): 16 row tiles
//     times 8 k-steps, the zero blocks of the identity included, as the
//     TPU's MXU did.  The result is exactly bf16(x).  Warps touch only
//     their own columns, so the chunk is overwritten without a barrier.
//
// Indexing is 64-bit: the probe's array is 2^31 bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma_ring.cuh"

namespace {

constexpr int kCols = 128;               // floats a row
constexpr int kRowBytes = kCols * 4;
constexpr int kThreads = 512;            // 16 warps: one per 8 columns
constexpr int kMaxBuf = 8;
constexpr int kMaxRingBytes = 227 * 1024;
constexpr int kChunk = 128;              // rows of one identity product

struct GatherArgs {
  int64_t rows;
  int64_t n_runs;
  int run_rows;
  int stage_rows;
  int half;  // low bits of the run index that the scramble moves up
  int nbuf;
};

__device__ __forceinline__ int64_t source_run(int64_t r, const GatherArgs& a) {
  const int64_t lo = r & ((int64_t(1) << a.half) - 1);
  return lo * (a.n_runs >> a.half) + (r >> a.half);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// chunk = eye(128) . bf16(chunk) on a 128 x 128 f32 chunk in shared memory;
// warp w computes columns [8 w, 8 w + 8).
__device__ __forceinline__ void identity_product(float* chunk) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int col = warp * 8 + g;
  // A fragments (16 x 16, row-major) of the identity: a diagonal block has
  // ones at (g, 2t + e) and (g + 8, 2t + 8 + e) where g == 2t + e.
  const float one0 = g == 2 * t ? 1.f : 0.f, one1 = g == 2 * t + 1 ? 1.f : 0.f;
  const uint32_t diag[4] = {pack_bf16(one0, one1), 0u, 0u,
                            pack_bf16(one0, one1)};
  const uint32_t zero[4] = {0u, 0u, 0u, 0u};
  float acc[kChunk / 16][4];
#pragma unroll
  for (int m = 0; m < kChunk / 16; ++m)
    acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kChunk / 16; ++ks) {
    // B fragment (16 x 8, column-major): rows 2t, 2t + 1, 2t + 8, 2t + 9
    const float* xk = chunk + (ks * 16 + 2 * t) * kCols + col;
    const uint32_t b[2] = {pack_bf16(xk[0], xk[kCols]),
                           pack_bf16(xk[8 * kCols], xk[9 * kCols])};
#pragma unroll
    for (int m = 0; m < kChunk / 16; ++m)
      mma_bf16(acc[m], m == ks ? diag : zero, b);
  }
  // C fragment (16 x 8): (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
  const int c = warp * 8 + 2 * t;
#pragma unroll
  for (int m = 0; m < kChunk / 16; ++m) {
    float* r = chunk + (m * 16 + g) * kCols + c;
    r[0] = acc[m][0];
    r[1] = acc[m][1];
    r[8 * kCols] = acc[m][2];
    r[8 * kCols + 1] = acc[m][3];
  }
}

template <bool kMatmul>
__global__ void __launch_bounds__(kThreads)
gather_ring_kernel(float* x, GatherArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[kMaxBuf];
  float* ring = reinterpret_cast<float*>(smem);
  const int lane = threadIdx.x % 32;
  const bool warp0 = threadIdx.x < 32;
  const int64_t stage = (int64_t)a.stage_rows * kCols;   // floats
  const int copy_rows = a.run_rows < a.stage_rows ? a.run_rows : a.stage_rows;
  const int copies = a.stage_rows / copy_rows;
  const uint32_t copy_bytes = (uint32_t)copy_rows * kRowBytes;
  const int64_t n_units = a.rows / a.stage_rows;
  const int64_t m = (int64_t)blockIdx.x < n_units
                        ? (n_units - 1 - blockIdx.x) / gridDim.x + 1
                        : 0;
  auto unit_of = [&](int64_t i) { return blockIdx.x + i * gridDim.x; };
  // source row of copy c of unit u
  auto src_row = [&](int64_t u, int c) {
    const int64_t v = u * a.stage_rows + (int64_t)c * copy_rows;
    return source_run(v / a.run_rows, a) * a.run_rows + v % a.run_rows;
  };
  auto fill = [&](int64_t i) {  // warp 0: load the block's i-th unit
    const int s = (int)(i % a.nbuf);
    const int64_t u = unit_of(i);
    if (lane == 0) tma::bar_expect(&bars[s], (uint32_t)(stage * 4));
    __syncwarp();
    for (int c = lane; c < copies; c += 32)
      tma::load(ring + s * stage + (int64_t)c * copy_rows * kCols,
                x + src_row(u, c) * kCols, copy_bytes, &bars[s]);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.nbuf; ++s) tma::bar_init(&bars[s], 1);
    tma::fence_bar_init();
  }
  __syncthreads();
  if (warp0)
    for (int64_t i = 0; i < a.nbuf && i < m; ++i) fill(i);

  for (int64_t i = 0; i < m; ++i) {
    const int s = (int)(i % a.nbuf);
    const int64_t u = unit_of(i);
    float* st = ring + s * stage;
    tma::bar_wait(&bars[s], (uint32_t)((i / a.nbuf) & 1));
    if (kMatmul) {
      for (int c = 0; c < a.stage_rows / kChunk; ++c)
        identity_product(st + (int64_t)c * kChunk * kCols);
    } else {
      float4* v = reinterpret_cast<float4*>(st);
      for (int64_t j = threadIdx.x; j < stage / 4; j += kThreads) {
        const float4 q = v[j];
        v[j] = make_float4(2.f * q.x, 2.f * q.y, 2.f * q.z, 2.f * q.w);
      }
    }
    tma::fence_async_smem();
    __syncthreads();
    if (warp0) {
      for (int c = lane; c < copies; c += 32)
        tma::store(x + src_row(u, c) * kCols,
                   st + (int64_t)c * copy_rows * kCols, copy_bytes);
      tma::commit();
      // the previous stage is free once every lane's stores have read it
      if (i >= 1 && i - 1 + a.nbuf < m) {
        tma::wait_read<1>();
        __syncwarp();
        fill(i - 1 + a.nbuf);
      }
    }
  }
  if (warp0) tma::wait_all();
}

bool pow2(int64_t v) { return v > 0 && (v & (v - 1)) == 0; }

template <bool kMatmul>
int launch(float* x, const GatherArgs& a, int64_t ring_bytes,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gather_ring_kernel<kMatmul>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ring_bytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t n_units = a.rows / a.stage_rows;
  const unsigned grid = (unsigned)(n_units < sms ? n_units : sms);
  gather_ring_kernel<kMatmul><<<grid, kThreads, (size_t)ring_bytes, stream>>>(
      x, a);
  return (int)cudaGetLastError();
}

}  // namespace

// In place on x[rows][128] (16-byte aligned): gather runs of run_rows rows
// in the scrambled order (source run of run r: the low `half` bits of r
// moved above the rest), through an nbuf-stage ring of stage_rows-row
// stages, and write each run back where it came from, doubled or, with
// matmul != 0, rounded to bf16 by an identity product on the tensor cores.
// run_rows, stage_rows and rows / run_rows are powers of two dividing rows;
// 2 <= nbuf <= 8 and nbuf * stage_rows * 512 <= 227 KB; matmul needs stage_rows % 128 == 0.
// Returns a cudaError_t (0 on success).
extern "C" int hq_gather_scale(float* x, int64_t rows, int run_rows,
                               int stage_rows, int half, int nbuf,
                               int matmul, void* stream) {
  GatherArgs a{rows, 0, run_rows, stage_rows, half, nbuf};
  if (!pow2(run_rows) || !pow2(stage_rows) || rows <= 0 ||
      rows % run_rows || rows % stage_rows || nbuf < 2 || nbuf > kMaxBuf ||
      (matmul && stage_rows % kChunk))
    return (int)cudaErrorInvalidValue;
  a.n_runs = rows / run_rows;
  if (!pow2(a.n_runs) || half < 0 || (int64_t(1) << half) > a.n_runs)
    return (int)cudaErrorInvalidValue;
  const int64_t ring_bytes = (int64_t)nbuf * stage_rows * kRowBytes;
  if (ring_bytes > kMaxRingBytes) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return matmul ? launch<true>(x, a, ring_bytes, s)
                : launch<false>(x, a, ring_bytes, s);
}
