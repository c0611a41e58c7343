// Streaming out = 2 * x over a [rows, cols] f32 array: the card's
// bandwidth probes.
//
// Replaces the Pallas TPU kernels of scripts/probe_pallas_bw.py:
//   * mk_auto (l.42): a grid of (S, 1024) blocks, auto-pipelined, out of
//     place -> hq_scale;
//   * mk_auto_aliased (l.60): the same in place -> hq_scale_inplace;
//   * mk_manual (l.79): the same copy streamed by hand, async DMA
//     HBM -> VMEM -> HBM with nbuf stages and DMA semaphores, out of
//     place -> hq_scale_pipelined.
//
// Bound on this card: every byte read once and written once,
// 2 * rows * cols * 4 bytes over 3.35 TB/s (1.28 ms at the probes' 2 GiB,
// H100 SXM); one multiply per float is nothing beside it.
//
// Design:
//   * hq_scale / hq_scale_inplace: the Pallas grid runs in order on one
//     core; here a block loops over whole tiles of tile_rows rows (tile t,
//     t + gridDim.x, ...), each thread moving 16-byte vectors, four loads
//     in flight before their four stores.  Input and output pointers carry
//     no __restrict__: the in-place entry point passes one pointer as both.
//   * hq_scale_pipelined: one persistent block per SM with an nbuf-stage
//     ring in shared memory.  Thread 0 fills a stage with one TMA bulk copy
//     (cp.async.bulk global -> shared, completing on the stage's mbarrier),
//     all threads scale the stage in place (the TPU kernel's separate in
//     and out buffers would double the shared memory), and thread 0 writes
//     it back with a bulk copy shared -> global.  A stage is refilled once
//     its store has read it (cp.async.bulk.wait_group.read), so nbuf - 1
//     loads and one store are in flight while a stage is scaled.  The ring
//     holds nbuf * chunk_rows * cols * 4 bytes, at most 227 KB.
//
// Indexing is 64-bit: the probes' array is 2^31 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tma_ring.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kBlocksPerSm = 8;
constexpr int kRingThreads = 256;
constexpr int kMaxBuf = 8;
constexpr int kMaxRingBytes = 227 * 1024;

__device__ __forceinline__ float4 twice(float4 v) {
  return make_float4(2.f * v.x, 2.f * v.y, 2.f * v.z, 2.f * v.w);
}

// out[i] = 2 * in[i] over n4 vectors, in tiles of tile4 vectors; `in` and
// `out` may be the same array.
__global__ void __launch_bounds__(kThreads)
scale_tiles_kernel(const float4* in, float4* out, int64_t n4, int64_t tile4,
                   int64_t n_tiles) {
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int64_t lo = t * tile4;
    const int64_t hi = lo + tile4 < n4 ? lo + tile4 : n4;
    for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads * kUnroll) {
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t j = i + u * kThreads;
        if (j < hi) v[u] = in[j];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t j = i + u * kThreads;
        if (j < hi) out[j] = twice(v[u]);
      }
    }
  }
}

// The ring: unit u is rows [u * chunk_rows, (u + 1) * chunk_rows); block b
// takes units b, b + gridDim.x, ...
__global__ void __launch_bounds__(kRingThreads)
scale_ring_kernel(const float* __restrict__ x, float* __restrict__ out,
                  int64_t total, int64_t chunk, int nbuf) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[kMaxBuf];
  float* ring = reinterpret_cast<float*>(smem);
  const int64_t n_units = (total + chunk - 1) / chunk;
  const int64_t m = (int64_t)blockIdx.x < n_units
                        ? (n_units - 1 - blockIdx.x) / gridDim.x + 1
                        : 0;
  const bool issuer = threadIdx.x == 0;
  auto unit_of = [&](int64_t i) { return blockIdx.x + i * gridDim.x; };
  auto floats_of = [&](int64_t u) {
    return total - u * chunk < chunk ? total - u * chunk : chunk;
  };
  auto fill = [&](int64_t i) {  // load the block's i-th unit
    const int s = (int)(i % nbuf);
    const int64_t u = unit_of(i);
    const uint32_t bytes = (uint32_t)(floats_of(u) * 4);
    tma::bar_expect(&bars[s], bytes);
    tma::load(ring + s * chunk, x + u * chunk, bytes, &bars[s]);
  };

  if (issuer) {
    for (int s = 0; s < nbuf; ++s) tma::bar_init(&bars[s], 1);
    tma::fence_bar_init();
  }
  __syncthreads();
  if (issuer)
    for (int64_t i = 0; i < nbuf && i < m; ++i) fill(i);

  for (int64_t i = 0; i < m; ++i) {
    const int s = (int)(i % nbuf);
    const int64_t u = unit_of(i);
    const int64_t nf = floats_of(u);
    tma::bar_wait(&bars[s], (uint32_t)((i / nbuf) & 1));
    float4* st = reinterpret_cast<float4*>(ring + s * chunk);
    for (int64_t j = threadIdx.x; j < nf / 4; j += kRingThreads)
      st[j] = twice(st[j]);
    tma::fence_async_smem();
    __syncthreads();
    if (issuer) {
      tma::store(out + u * chunk, st, (uint32_t)(nf * 4));
      tma::commit();
      // the previous stage is free once its store has read it
      if (i >= 1 && i - 1 + nbuf < m) {
        tma::wait_read<1>();
        fill(i - 1 + nbuf);
      }
    }
  }
  if (issuer) tma::wait_all();
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

int launch_tiles(const float* in, float* out, int64_t rows, int cols,
                 int tile_rows, void* stream) {
  if (rows < 0 || cols <= 0 || cols % 4 || tile_rows <= 0)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const int64_t n4 = rows * cols / 4;
  const int64_t tile4 = (int64_t)tile_rows * cols / 4;
  const int64_t n_tiles = (rows + tile_rows - 1) / tile_rows;
  const int64_t cap = (int64_t)sm_count() * kBlocksPerSm;
  const unsigned grid = (unsigned)(n_tiles < cap ? n_tiles : cap);
  scale_tiles_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(in), reinterpret_cast<float4*>(out),
      n4, tile4, n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// out = 2 * x over rows x cols f32 (cols % 4 == 0, 16-byte aligned, distinct
// arrays), tile_rows rows a tile.  Returns a cudaError_t (0 on success).
extern "C" int hq_scale(const float* x, float* out, int64_t rows, int cols,
                        int tile_rows, void* stream) {
  return launch_tiles(x, out, rows, cols, tile_rows, stream);
}

// x = 2 * x in place, as hq_scale.
extern "C" int hq_scale_inplace(float* x, int64_t rows, int cols,
                                int tile_rows, void* stream) {
  return launch_tiles(x, x, rows, cols, tile_rows, stream);
}

// out = 2 * x through an nbuf-stage ring of chunk_rows-row stages in
// shared memory (2 <= nbuf <= 8, nbuf * chunk_rows * cols * 4 <= 227 KB).
extern "C" int hq_scale_pipelined(const float* x, float* out, int64_t rows,
                                  int cols, int chunk_rows, int nbuf,
                                  void* stream) {
  if (rows < 0 || cols <= 0 || cols % 4 || chunk_rows <= 0 || nbuf < 2 ||
      nbuf > kMaxBuf)
    return (int)cudaErrorInvalidValue;
  const int64_t chunk = (int64_t)chunk_rows * cols;
  const int64_t ring_bytes = chunk * 4 * nbuf;
  if (ring_bytes > kMaxRingBytes) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      scale_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)ring_bytes);
  if (err != cudaSuccess) return (int)err;
  const int64_t n_units = (rows + chunk_rows - 1) / chunk_rows;
  const int64_t sms = sm_count();
  const unsigned grid = (unsigned)(n_units < sms ? n_units : sms);
  scale_ring_kernel<<<grid, kRingThreads, (size_t)ring_bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      x, out, rows * cols, chunk, nbuf);
  return (int)cudaGetLastError();
}
