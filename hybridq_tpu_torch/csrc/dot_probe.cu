// C = A B for one 128 x 128 x 128 f32 product on the tensor cores: the
// card's dot-accuracy probe.
//
// Replaces the Pallas TPU kernels
//   * dk in main of scripts/probe_pallas_bw.py (l.202): jnp.dot of two
//     [128, 128] f32 blocks at default precision, one reduced-precision MXU
//     pass -> passes = 1, one TF32 pass;
//   * dk in main of scripts/probe_pallas_gather.py (l.233): the same dot at
//     Precision.HIGHEST, multi-pass and f32-accurate -> passes = 3, the
//     3xTF32 split.
//
// Bound on this card: 2 * 128^3 flops at 495 TFLOP/s (TF32) against three
// 64 KiB arrays at 3.35 TB/s: bytes, 0.06 us (H100 SXM), below the
// latency of any launch.  What costs time at this size is latency: the
// launch, the first loads from L2, and the chain of dependent steps a
// warp walks.  The design keeps that chain short:
//
//   * 128 blocks of eight warps, one 16 x 8 output tile a block
//     (blockIdx.x = 16 * tile row + tile column); warp w sums k in
//     [16 w, 16 w + 16): two steps of mma.sync.aligned.m16n8k8 (TF32 in,
//     f32 accumulate), six dependent products in 3xTF32;
//   * each thread loads 16-byte chunks of the block's 16 rows of A and 8
//     columns of B, neighbouring threads on neighbouring chunks (a warp
//     reads one 512-byte row of A, or sixteen 32-byte rows of B), all
//     before it uses any;
//   * it splits each element once, in registers, and stores the TF32 big
//     word (cvt.rna.tf32.f32, to_tf32 of tf32_mma.cuh) and, for 3xTF32,
//     the small word (split) into shared memory: the words must pass
//     through registers to be split, so an asynchronous copy into shared
//     memory would only add a round trip.  Rows are padded (A to 132
//     words; B's 8 words need none) so that fragment reads are free of
//     bank conflicts;
//   * the eight partial tiles meet in shared memory and each output is
//     their sum in warp order, written once: no atomics, so two calls
//     give the same bits.
//
// The three products of a step are accumulated small_a big_b, big_a
// small_b, big_a big_b, smallest first.
//
// wgmma is not used: it buys tensor-core throughput that 2^21
// multiply-adds cannot use, and its TF32 form needs both operands K-major
// in shared memory, which row-major B is not (a transpose on the way in
// would add to the latency this design cuts).

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kN = 128;
constexpr int kTileM = 16, kTileN = 8;            // a block's output tile
constexpr int kTilesPerRow = kN / kTileN;         // 16
constexpr int kBlocks = kN / kTileM * kTilesPerRow;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSpan = kN / kWarps;                // k a warp sums
constexpr int kAStride = kN + 4;                  // g * 4 + t: 32 banks
constexpr int kBStride = kTileN;                  // t * 8 + g: 32 banks
constexpr int kRowChunks = kN / 4;                // 16-byte chunks, A row
constexpr int kColChunks = kTileN / 4;            // 16-byte chunks, B row
constexpr int kAPer = kTileM * kRowChunks / kThreads;  // chunks a thread
constexpr int kBPer = kN * kColChunks / kThreads;
static_assert(kAPer * kThreads == kTileM * kRowChunks &&
                  kBPer * kThreads == kN * kColChunks,
              "every thread loads whole chunks");

// x as TF32 big words at big and, for 3xTF32, small words at small.
template <bool kSplit>
__device__ __forceinline__ void store_split(const float4 x, uint32_t* big,
                                            uint32_t* small) {
  const float v[4] = {x.x, x.y, x.z, x.w};
  uint32_t b[4], s[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (kSplit)
      split(v[j], b[j], s[j]);
    else
      b[j] = to_tf32(v[j]);
  }
  *reinterpret_cast<float4*>(big) =
      float4{__uint_as_float(b[0]), __uint_as_float(b[1]),
             __uint_as_float(b[2]), __uint_as_float(b[3])};
  if (kSplit)
    *reinterpret_cast<float4*>(small) =
        float4{__uint_as_float(s[0]), __uint_as_float(s[1]),
               __uint_as_float(s[2]), __uint_as_float(s[3])};
}

template <bool kSplit>
__global__ void __launch_bounds__(kThreads)
dot_kernel(const float* __restrict__ A, const float* __restrict__ B,
           float* __restrict__ C) {
  __shared__ __align__(16) uint32_t a_big[kTileM * kAStride];
  __shared__ __align__(16) uint32_t a_small[kSplit ? kTileM * kAStride : 4];
  __shared__ __align__(16) uint32_t b_big[kN * kBStride];
  __shared__ __align__(16) uint32_t b_small[kSplit ? kN * kBStride : 4];
  __shared__ __align__(16) float part[kWarps * kTileM * kTileN];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = blockIdx.x / kTilesPerRow * kTileM;
  const int col0 = blockIdx.x % kTilesPerRow * kTileN;

  // A's rows [row0, row0 + 16) and B's columns [col0, col0 + 8): every
  // load in flight before the first is used
  float4 xa[kAPer], xb[kBPer];
#pragma unroll
  for (int j = 0; j < kAPer; ++j) {
    const int i = tid + j * kThreads;
    xa[j] = __ldg(reinterpret_cast<const float4*>(
        &A[(row0 + i / kRowChunks) * kN + i % kRowChunks * 4]));
  }
#pragma unroll
  for (int j = 0; j < kBPer; ++j) {
    const int i = tid + j * kThreads;
    xb[j] = __ldg(reinterpret_cast<const float4*>(
        &B[i / kColChunks * kN + col0 + i % kColChunks * 4]));
  }
#pragma unroll
  for (int j = 0; j < kAPer; ++j) {
    const int i = tid + j * kThreads;
    const int at = i / kRowChunks * kAStride + i % kRowChunks * 4;
    store_split<kSplit>(xa[j], &a_big[at], &a_small[kSplit ? at : 0]);
  }
#pragma unroll
  for (int j = 0; j < kBPer; ++j) {
    const int i = tid + j * kThreads;
    const int at = i / kColChunks * kBStride + i % kColChunks * 4;
    store_split<kSplit>(xb[j], &b_big[at], &b_small[kSplit ? at : 0]);
  }
  __syncthreads();

  const int g = lane >> 2, t = lane & 3;  // fragment row group, column
  float acc[4] = {};
#pragma unroll
  for (int step = 0; step < kSpan / 8; ++step) {
    const int k0 = warp * kSpan + step * 8;
    // A fragment (16 x 8, row-major): (g, t), (g + 8, t), (g, t + 4),
    // (g + 8, t + 4)
    const int ia[4] = {g * kAStride + k0 + t, (g + 8) * kAStride + k0 + t,
                       g * kAStride + k0 + t + 4,
                       (g + 8) * kAStride + k0 + t + 4};
    // B fragment (8 x 8, column-major): (t, g), (t + 4, g)
    const int ib[2] = {(k0 + t) * kBStride + g, (k0 + t + 4) * kBStride + g};
    const uint32_t ab[4] = {a_big[ia[0]], a_big[ia[1]], a_big[ia[2]],
                            a_big[ia[3]]};
    const uint32_t bb[2] = {b_big[ib[0]], b_big[ib[1]]};
    if (kSplit) {
      const uint32_t as[4] = {a_small[ia[0]], a_small[ia[1]],
                              a_small[ia[2]], a_small[ia[3]]};
      const uint32_t bs[2] = {b_small[ib[0]], b_small[ib[1]]};
      mma_tf32(acc, as, bb);
      mma_tf32(acc, ab, bs);
    }
    mma_tf32(acc, ab, bb);
  }

  // C fragment (16 x 8): (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
  float* mine = &part[warp * kTileM * kTileN];
  mine[g * kTileN + 2 * t] = acc[0];
  mine[g * kTileN + 2 * t + 1] = acc[1];
  mine[(g + 8) * kTileN + 2 * t] = acc[2];
  mine[(g + 8) * kTileN + 2 * t + 1] = acc[3];
  __syncthreads();
  // each output the sum of the eight partials in warp order
  if (tid < kTileM * kTileN) {
    float s = part[tid];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += part[w * kTileM * kTileN + tid];
    C[(row0 + tid / kTileN) * kN + col0 + tid % kTileN] = s;
  }
}

}  // namespace

// C = A B for row-major 128 x 128 f32 device arrays, each 16-byte aligned;
// passes = 1 (TF32) or 3 (3xTF32).  Returns a cudaError_t (0 on success).
extern "C" int hq_dot128(const float* A, const float* B, float* C,
                         int passes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (passes == 1)
    dot_kernel<false><<<kBlocks, kThreads, 0, s>>>(A, B, C);
  else if (passes == 3)
    dot_kernel<true><<<kBlocks, kThreads, 0, s>>>(A, B, C);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
