// TF32 tensor-core and asynchronous-copy helpers shared by dot_probe.cu and
// fused_apply.cu.
//
// Each PTX instruction sits in a small __device__ function of its own, and
// only when nvcc compiles (__CUDACC__).  A host build of a source (g++ with
// a stand-in cuda_runtime.h that defines the same functions) gets the rest
// of this header unchanged.
//
//   * to_tf32(x): cvt.rna.tf32.f32, x rounded to TF32 (10 mantissa bits,
//     ties away from zero), as the bits of an f32.  The tensor cores
//     otherwise truncate the low 13 mantissa bits, and the 3xTF32 residual
//     small = tf32(x - big) would not be the rounding error of big.
//   * split(x, big, small): the 3xTF32 split, big = tf32(x) and
//     small = tf32(x - big); x = big + small to about 2^-22 relative.
//   * split_finite(x, big, small): the same big for a finite x in two
//     integer operations (the SASS of cvt.rna.tf32.f32 adds an inf/NaN
//     guard: four), and small = x - big, exact, left for the tensor cores
//     to truncate to TF32, again about 2^-22 of x: three operations a
//     value where split takes nine.
//   * mma_tf32(c, a, b): mma.sync.aligned.m16n8k8.row.col, TF32 in, f32
//     accumulate, c += A B for one warp.  With g = lane / 4, t = lane % 4:
//     A (16 x 8, row-major) a[0] = (g, t), a[1] = (g + 8, t),
//     a[2] = (g, t + 4), a[3] = (g + 8, t + 4); B (8 x 8, column-major)
//     b[0] = (t, g), b[1] = (t + 4, g); C (16 x 8) c[0] = (g, 2t),
//     c[1] = (g, 2t + 1), c[2] = (g + 8, 2t), c[3] = (g + 8, 2t + 1).
//   * cp_async<BYTES>(dst, src): cp.async of 4, 8 or 16 bytes from global
//     to shared memory (16 bytes bypass L1: .cg); cp_async_commit() closes
//     a group, cp_async_wait<N>() waits until at most N groups of this
//     thread are in flight.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  static_assert(BYTES == 4 || BYTES == 8 || BYTES == 16, "cp.async size");
  const unsigned s =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(s),
                 "l"(src), "n"(BYTES)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

#endif  // __CUDACC__

// big = tf32(x), small = tf32(x - big)
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void split_finite(float x, uint32_t& big,
                                             uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}
