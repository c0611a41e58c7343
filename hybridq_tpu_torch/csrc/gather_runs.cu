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
// Rows are taken in the gathered ("virtual") order: virtual row v lies in
// run r = v / run_rows at offset v % run_rows, and its source is row
// src(r) * run_rows + v % run_rows, with src the probe's scramble (swap the
// low `half` bits of r with the rest).  Each row is read from its source
// and written back there; the order in which blocks take virtual rows is
// the probe's access pattern.  What decides the rate on an H100 is that
// order and how much is in flight: blocks that the hardware starts in
// order keep the data in flight in a narrow band, persistent blocks that
// walk their own units drift apart and read slower (stream_scale.cu).
// Hence two designs, both with blocks in the order of the virtual rows:
//   * gather_rows_kernel (x2): the register path of stream_scale.cu's
//     tiles.  A block of 8 warps takes 32 consecutive virtual rows
//     (16 KiB), a warp 4 of them (a 2 KB piece of one run where runs are
//     that long), one 16-byte vector a thread a row, all four loads before
//     the stores, with the streaming hints (ld.global.cs / st.global.cs);
//     the scramble only changes which rows a warp reads, never the
//     coalescing.  No shared memory, no TMA; `stage_rows` and `nbuf` do
//     not shape the launch.  (Of the shapes tried on an H100, 1-16 rows a
//     warp and 8 or 16 warps a block, this one read fastest from 2 KB
//     runs up; in the order of the array any of them streams at the
//     library's rate, and the scramble costs the rest.)
//   * gather_chunks_kernel (matmul): block b takes `nbuf` stages of
//     `stage_rows` virtual rows (whole 128-row chunks) into shared memory,
//     each filled once: warp 0 moves each run piece (a run, or the part of
//     a longer run that falls in the stage) with one 1-D TMA bulk copy,
//     its 32 lanes issuing a stage's pieces in turn, every load of the
//     block at once; a stage's loads complete on its mbarrier.  Each stage
//     is multiplied in place by eye(128) as it lands, then written back
//     with bulk copies shared -> global to the same source rows.  A stage
//     is at least 64 KiB and a block at least two, so an SM holds one
//     block, its loads of 128 KiB or more in flight at once.
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
constexpr int kWarpRows = 4;             // register path: rows a warp
constexpr int kRowWarps = 8;
constexpr int kBlockRows = kWarpRows * kRowWarps;
constexpr int kRowThreads = 32 * kRowWarps;
constexpr int kThreads = 512;            // matmul: one warp per 8 columns
constexpr int kMaxBuf = 8;
constexpr int kMaxRingBytes = 227 * 1024;
constexpr int kChunk = 128;              // rows of one identity product

struct GatherArgs {
  int64_t rows;
  int64_t n_runs;
  int log_run;                           // log2 of run_rows
  int stage_rows;
  int half;  // low bits of the run index that the scramble moves up
  int nbuf;
};

__device__ __forceinline__ int64_t source_run(int64_t r, const GatherArgs& a) {
  const int64_t lo = r & ((int64_t(1) << a.half) - 1);
  return lo * (a.n_runs >> a.half) + (r >> a.half);
}

// The row that virtual row v reads and writes.
__device__ __forceinline__ int64_t source_row(int64_t v, const GatherArgs& a) {
  return (source_run(v >> a.log_run, a) << a.log_run) |
         (v & ((int64_t(1) << a.log_run) - 1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

#ifdef __CUDACC__  // a host build of this source brings its own
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
#endif

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

// Block b doubles virtual rows [32 b, 32 b + 32), warp w rows 32 b + 4 w
// to 32 b + 4 w + 3.
__global__ void __launch_bounds__(kRowThreads)
gather_rows_kernel(float4* x, GatherArgs a) {
  const int64_t v0 =
      (int64_t)blockIdx.x * kBlockRows + (threadIdx.x / 32) * kWarpRows;
  float4* p[kWarpRows];
  float4 q[kWarpRows];
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i)
    if (v0 + i < a.rows) {
      p[i] = x + source_row(v0 + i, a) * (kCols / 4) + threadIdx.x % 32;
      q[i] = __ldcs(p[i]);
    }
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i)
    if (v0 + i < a.rows)
      __stcs(p[i], make_float4(2.f * q[i].x, 2.f * q[i].y, 2.f * q[i].z,
                               2.f * q[i].w));
}

// Block b takes units b * nbuf + s (stage_rows virtual rows each) into its
// stages s, each filled once, multiplies each by eye(128) and writes it
// back.
__global__ void __launch_bounds__(kThreads)
gather_chunks_kernel(float* x, GatherArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kMaxBuf];
  float* ring = reinterpret_cast<float*>(smem);
  const int lane = threadIdx.x % 32;
  const bool warp0 = threadIdx.x < 32;
  const int64_t stage = (int64_t)a.stage_rows * kCols;   // floats
  const int run_rows = 1 << a.log_run;
  const int copy_rows = run_rows < a.stage_rows ? run_rows : a.stage_rows;
  const int copies = a.stage_rows / copy_rows;
  const uint32_t copy_bytes = (uint32_t)copy_rows * kRowBytes;
  const int64_t first = (int64_t)blockIdx.x * a.nbuf;
  const int64_t left = a.rows / a.stage_rows - first;
  const int n = left < a.nbuf ? (int)left : a.nbuf;    // stages it fills
  // source row of copy c of unit u
  auto src_row = [&](int64_t u, int c) {
    return source_row(u * a.stage_rows + (int64_t)c * copy_rows, a);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < n; ++s) tma::bar_init(&full[s], 1);
    tma::fence_bar_init();
  }
  __syncthreads();
  if (warp0)
    for (int s = 0; s < n; ++s) {
      if (lane == 0) tma::bar_expect(&full[s], (uint32_t)(stage * 4));
      __syncwarp();
      for (int c = lane; c < copies; c += 32)
        tma::load(ring + s * stage + (int64_t)c * copy_rows * kCols,
                  x + src_row(first + s, c) * kCols, copy_bytes, &full[s]);
    }

  for (int s = 0; s < n; ++s) {
    float* st = ring + s * stage;
    tma::bar_wait(&full[s], 0);
    for (int c = 0; c < a.stage_rows / kChunk; ++c)
      identity_product(st + (int64_t)c * kChunk * kCols);
    tma::fence_async_smem();
    __syncthreads();
    if (warp0) {
      for (int c = lane; c < copies; c += 32)
        tma::store(x + src_row(first + s, c) * kCols,
                   st + (int64_t)c * copy_rows * kCols, copy_bytes);
      tma::commit();
    }
  }
  // shared memory lives until every lane's stores have read it
  if (warp0) tma::wait_read<0>();
}

bool pow2(int64_t v) { return v > 0 && (v & (v - 1)) == 0; }

int log2_of(int64_t v) {
  int l = 0;
  while ((int64_t(1) << l) < v) ++l;
  return l;
}

int launch_rows(float* x, const GatherArgs& a, cudaStream_t stream) {
  const int64_t blocks = (a.rows + kBlockRows - 1) / kBlockRows;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  auto* kern = gather_rows_kernel;
  kern<<<(unsigned)blocks, kRowThreads, 0, stream>>>(
      reinterpret_cast<float4*>(x), a);
  return (int)cudaGetLastError();
}

int launch_chunks(float* x, const GatherArgs& a, cudaStream_t stream) {
  const int64_t ring_bytes = (int64_t)a.nbuf * a.stage_rows * kRowBytes;
  const int64_t units = a.rows / a.stage_rows;
  const int64_t blocks = (units + a.nbuf - 1) / a.nbuf;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  auto* kern = gather_chunks_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ring_bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)blocks, kThreads, (size_t)ring_bytes, stream>>>(x, a);
  return (int)cudaGetLastError();
}

}  // namespace

// In place on x[rows][128] (16-byte aligned): take runs of run_rows rows in
// the scrambled order (source run of run r: the low `half` bits of r moved
// above the rest) and write each row back where it came from, doubled or,
// with matmul != 0, rounded to bf16 by an identity product on the tensor
// cores through nbuf stages of stage_rows rows a block.  run_rows,
// stage_rows and rows / run_rows are powers of two dividing rows;
// 2 <= nbuf <= 8 and nbuf * stage_rows * 512 <= 227 KB (checked for every
// variant; only the matmul launch uses stages); matmul needs stage_rows %
// 128 == 0.  Returns a cudaError_t (0 on success).
extern "C" int hq_gather_scale(float* x, int64_t rows, int run_rows,
                               int stage_rows, int half, int nbuf,
                               int matmul, void* stream) {
  GatherArgs a{rows, 0, 0, stage_rows, half, nbuf};
  if (!pow2(run_rows) || !pow2(stage_rows) || rows <= 0 ||
      rows % run_rows || rows % stage_rows || nbuf < 2 || nbuf > kMaxBuf ||
      (matmul && stage_rows % kChunk))
    return (int)cudaErrorInvalidValue;
  a.n_runs = rows / run_rows;
  a.log_run = log2_of(run_rows);
  if (!pow2(a.n_runs) || half < 0 || (int64_t(1) << half) > a.n_runs)
    return (int)cudaErrorInvalidValue;
  if ((int64_t)nbuf * stage_rows * kRowBytes > kMaxRingBytes)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return matmul ? launch_chunks(x, a, s) : launch_rows(x, a, s);
}
