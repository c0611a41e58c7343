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
// What decides the rate on an H100 is the order in which the card walks
// the array and how much of it is in flight at once.  Blocks that the
// hardware starts in the order of the array keep the data in flight in a
// narrow band that sweeps front to back; persistent blocks that each walk
// their own units (b, b + grid, ...) drift apart, widen the band and read
// slower, however many loads each keeps in flight.  A band much wider than
// some 64 KiB an SM (8 MiB on the card) costs a little too.
//
// Design:
//   * hq_scale / hq_scale_inplace: the Pallas grid walks its tiles in
//     order, and so does the card's.  Tile t (tile_rows rows) is cut into
//     chunks of kTileThreads 16-byte vectors (8 KiB), one vector a thread;
//     block (c, t) of the two-dimensional grid takes chunk c of tile t, so
//     blocks start in the order of the array (x fastest), as PyTorch's
//     elementwise kernels do; no index is divided.  Every byte is touched
//     once, so loads and stores carry the streaming hint (ld.global.cs /
//     st.global.cs, evict first).  The in-place entry point passes one
//     pointer as both arrays: the pointers carry no __restrict__ and the
//     loads stay coherent (ld.global.cs, never the read-only ld.global.nc
//     path of __ldg).
//   * hq_scale_pipelined: block b takes the nbuf units (chunk_rows rows
//     each) b * nbuf, ..., b * nbuf + nbuf - 1 into its nbuf stages in
//     shared memory, so blocks start in the order of the array.  Thread 0
//     issues the nbuf TMA bulk loads at once (cp.async.bulk global ->
//     shared, each completing on its stage's `full` mbarrier); kConsumers
//     threads scale each stage in place as it lands and arrive on its
//     `done` mbarrier, one arrival a warp; thread 0 then writes the stage
//     back with a bulk copy shared -> global.  Each stage is filled once,
//     so no load waits for a store.  The dynamic shared memory is padded so
//     that an SM holds only as many blocks as keep about kInFlightBytes of
//     loads in flight (at least one).
//
// Indexing is 64-bit: the probes' array is 2^31 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tma_ring.cuh"

namespace {

constexpr int kTileThreads = 512;               // a chunk: 8 KiB
constexpr int64_t kMaxGridY = 65535;
constexpr int kConsumers = 256;
constexpr int kRingThreads = kConsumers + 32;   // and one producer warp
constexpr int kUnroll = 4;
constexpr int kMaxBuf = 8;
constexpr int kMaxRingBytes = 227 * 1024;
constexpr int kInFlightBytes = 64 * 1024;       // loads in flight an SM
constexpr int kStaticSmem = 2 * kMaxBuf * 8;    // the stages' mbarriers

__device__ __forceinline__ float4 twice(float4 v) {
  return make_float4(2.f * v.x, 2.f * v.y, 2.f * v.z, 2.f * v.w);
}

// out[i] = 2 * in[i] over n4 vectors in tiles of tile4 vectors: block
// (c, t) takes chunk c of tile t, then of tiles t + gridDim.y, ...; `in`
// and `out` may be the same array.
__global__ void __launch_bounds__(kTileThreads)
scale_tiles_kernel(const float4* in, float4* out, int64_t n4, int64_t tile4,
                   int64_t n_tiles) {
  for (int64_t t = blockIdx.y; t < n_tiles; t += gridDim.y) {
    const int64_t j =
        t * tile4 + (int64_t)blockIdx.x * kTileThreads + threadIdx.x;
    const int64_t end = t * tile4 + tile4 < n4 ? t * tile4 + tile4 : n4;
    if (j < end) __stcs(out + j, twice(__ldcs(in + j)));
  }
}

// The stages: unit u is floats [u * chunk, (u + 1) * chunk) of `total`;
// block b takes unit b * nbuf + s into stage s.
__global__ void __launch_bounds__(kRingThreads)
scale_ring_kernel(const float* __restrict__ x, float* __restrict__ out,
                  int64_t total, int64_t chunk, int nbuf) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[2 * kMaxBuf];
  uint64_t* full = bars;             // stage loaded
  uint64_t* done = bars + kMaxBuf;   // stage scaled
  float* ring = reinterpret_cast<float*>(smem);
  const int64_t first = (int64_t)blockIdx.x * nbuf * chunk;
  const int64_t left = total - first;
  const int n = left < nbuf * chunk ? (int)((left + chunk - 1) / chunk)
                                    : nbuf;  // stages this block fills
  auto floats_of = [&](int s) {
    return left - s * chunk < chunk ? left - s * chunk : chunk;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < n; ++s) {
      tma::bar_init(&full[s], 1);
      tma::bar_init(&done[s], kConsumers / 32);
    }
    tma::fence_bar_init();
    for (int s = 0; s < n; ++s) {
      const uint32_t bytes = (uint32_t)(floats_of(s) * 4);
      tma::bar_expect(&full[s], bytes);
      tma::load(ring + s * chunk, x + first + s * chunk, bytes, &full[s]);
    }
  }
  __syncthreads();

  if (threadIdx.x < 32) {  // the producer warp: thread 0 stores each stage
    if (threadIdx.x != 0) return;
    for (int s = 0; s < n; ++s) {
      tma::bar_wait(&done[s], 0);
      tma::store(out + first + s * chunk, ring + s * chunk,
                 (uint32_t)(floats_of(s) * 4));
      tma::commit();
    }
    tma::wait_read<0>();  // shared memory lives until the stores read it
    return;
  }

  const int t = threadIdx.x - 32;
  for (int s = 0; s < n; ++s) {
    const int n4 = (int)(floats_of(s) / 4);
    float4* st = reinterpret_cast<float4*>(ring + s * chunk);
    tma::bar_wait(&full[s], 0);
    // kUnroll loads from shared memory in flight, then their stores
    for (int j = t; j < n4; j += kConsumers * kUnroll) {
      float4 v[kUnroll];
#pragma unroll
      for (int q = 0; q < kUnroll; ++q)
        if (j + q * kConsumers < n4) v[q] = st[j + q * kConsumers];
#pragma unroll
      for (int q = 0; q < kUnroll; ++q)
        if (j + q * kConsumers < n4) st[j + q * kConsumers] = twice(v[q]);
    }
    tma::fence_async_smem();
    __syncwarp();
    if ((t & 31) == 0) tma::bar_arrive(&done[s]);
  }
}

int device_attribute(cudaDeviceAttr what) {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, what, dev);
  return v;
}

int launch_tiles(const float* in, float* out, int64_t rows, int cols,
                 int tile_rows, void* stream) {
  if (rows < 0 || cols <= 0 || cols % 4 || tile_rows <= 0)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const int64_t n4 = rows * cols / 4;
  const int64_t tile4 = (int64_t)(tile_rows < rows ? tile_rows : rows) *
                        cols / 4;
  const int64_t n_tiles = (n4 + tile4 - 1) / tile4;
  const int64_t per_tile = (tile4 + kTileThreads - 1) / kTileThreads;
  if (per_tile > 0x7fffffff) return (int)cudaErrorInvalidValue;
  // grid.x: the chunks of a tile; grid.y: tiles, looped past its limit
  const dim3 grid((unsigned)per_tile,
                  (unsigned)(n_tiles < kMaxGridY ? n_tiles : kMaxGridY));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  scale_tiles_kernel<<<grid, kTileThreads, 0, s>>>(
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

// out = 2 * x through nbuf stages of chunk_rows rows in shared memory a
// block (2 <= nbuf <= 8, nbuf * chunk_rows * cols * 4 <= 227 KB).
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
  const int64_t units = (rows + chunk_rows - 1) / chunk_rows;
  const int64_t n_blocks = (units + nbuf - 1) / nbuf;
  if (n_blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  // pad the shared memory so that an SM holds at most per_sm blocks
  const int64_t per_sm =
      ring_bytes < kInFlightBytes ? kInFlightBytes / ring_bytes : 1;
  int64_t smem =
      device_attribute(cudaDevAttrMaxSharedMemoryPerMultiprocessor) /
          per_sm -
      device_attribute(cudaDevAttrReservedSharedMemoryPerBlock) -
      kStaticSmem;
  if (smem > kMaxRingBytes) smem = kMaxRingBytes;
  if (smem < ring_bytes) smem = ring_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      scale_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  scale_ring_kernel<<<(unsigned)n_blocks, kRingThreads, (size_t)smem, s>>>(
      x, out, rows * cols, chunk, nbuf);
  return (int)cudaGetLastError();
}
