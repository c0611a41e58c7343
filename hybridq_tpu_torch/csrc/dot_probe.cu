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
// 64 KiB arrays at 3.35 TB/s: bytes, 0.06 us (H100 SXM).  One block; the
// launch itself dominates.
//
// Design: one block of eight warps; warp w owns output rows
// [16 w, 16 w + 16) and all 16 column tiles of 8, 64 accumulators a thread,
// and walks k in steps of 8 through mma.sync.aligned.m16n8k8 (TF32 in,
// f32 accumulate).  Operands are read straight from global memory (192 KB
// in all, L2-resident).  Every operand goes through cvt.rna.tf32.f32: the
// tensor cores otherwise truncate the low 13 mantissa bits, and the
// 3xTF32 residual small = tf32(a - big) would not be the rounding error of
// big.  The three products are accumulated small_a big_b, big_a small_b,
// big_a big_b, smallest first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN = 128;
constexpr int kWarps = kN / 16;

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// big = tf32(x), small = tf32(x - big)
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool kSplit>
__global__ void __launch_bounds__(kWarps * 32)
dot_kernel(const float* __restrict__ A, const float* __restrict__ B,
           float* __restrict__ C) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, column
  const int r0 = warp * 16;
  float acc[kN / 8][4];
#pragma unroll
  for (int n = 0; n < kN / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int k0 = 0; k0 < kN; k0 += 8) {
    // A fragment (16 x 8, row-major): (g, t), (g + 8, t), (g, t + 4),
    // (g + 8, t + 4)
    const float a[4] = {A[(r0 + g) * kN + k0 + t],
                        A[(r0 + g + 8) * kN + k0 + t],
                        A[(r0 + g) * kN + k0 + t + 4],
                        A[(r0 + g + 8) * kN + k0 + t + 4]};
    uint32_t ab[4], as[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split(a[i], ab[i], as[i]);
#pragma unroll
    for (int n = 0; n < kN / 8; ++n) {
      // B fragment (8 x 8, column-major): (t, g), (t + 4, g)
      const float b[2] = {B[(k0 + t) * kN + n * 8 + g],
                          B[(k0 + t + 4) * kN + n * 8 + g]};
      uint32_t bb[2], bs[2];
      split(b[0], bb[0], bs[0]);
      split(b[1], bb[1], bs[1]);
      if (kSplit) {
        mma_tf32(acc[n], as, bb);
        mma_tf32(acc[n], ab, bs);
      }
      mma_tf32(acc[n], ab, bb);
    }
  }
  // C fragment (16 x 8): (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
#pragma unroll
  for (int n = 0; n < kN / 8; ++n) {
    const int c = n * 8 + 2 * t;
    C[(r0 + g) * kN + c] = acc[n][0];
    C[(r0 + g) * kN + c + 1] = acc[n][1];
    C[(r0 + g + 8) * kN + c] = acc[n][2];
    C[(r0 + g + 8) * kN + c + 1] = acc[n][3];
  }
}

}  // namespace

// C = A B for row-major 128 x 128 f32 device arrays; passes = 1 (TF32) or
// 3 (3xTF32).  Returns a cudaError_t (0 on success).
extern "C" int hq_dot128(const float* A, const float* B, float* C,
                         int passes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (passes == 1)
    dot_kernel<false><<<1, kWarps * 32, 0, s>>>(A, B, C);
  else if (passes == 3)
    dot_kernel<true><<<1, kWarps * 32, 0, s>>>(A, B, C);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
