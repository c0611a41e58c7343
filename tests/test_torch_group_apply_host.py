"""``csrc/fused_apply.cu`` itself, compiled for the host and checked there.

The kernel source is compiled with ``g++ -std=c++20`` against a small
stand-in for ``cuda_runtime.h`` (``SHIM`` below): every CUDA thread is a
``std::thread``, ``__syncthreads`` is a ``std::barrier`` (a thread that
leaves the kernel calls ``arrive_and_drop``, so an early exit cannot hang
the test), ``__shared__`` is ``static`` and the blocks of a launch run one
after another.  The PTX helpers of ``csrc/tf32_mma.cuh`` get host
versions: ``cvt.rna.tf32.f32`` as bit arithmetic (round half away from
zero at 10 mantissa bits); ``mma.sync`` m16n8k8 as a warp collective
(each lane puts its fragments into a per-warp scratch buffer, a
``std::barrier`` of the warp's 32 threads computes C from the PTX fragment
layout in its completion step, reading TF32 operands as the tensor cores
do, low 13 bits dropped); ``cp.async`` as a plain copy and its wait as a
no-op.  The SM count that sizes the persistent grid is the shim's, set
per case.  Before compiling, the test turns each ``<<<...>>>`` launch into
a plain call and gives the dynamic shared memory a fixed size.

``hq_group_apply`` is called through ctypes on numpy arrays and held
against the plain PyTorch versions on the CPU (``apply_fused_plain``,
``apply_swap_plain``'s gather/matmul/scatter, ``apply_gate_rows_plain``):
max|d|/rms <= 1e-5, f32 sums taken in another order (and, from k = 6,
3xTF32 products).  Since blocks run in order, a block that wrote an
address that a later block reads would show up as a wrong amplitude: the
cases check the ownership rule (a block writes only addresses it has
read) as well as the indexing.  Skipped where ``g++`` is missing.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from hybridq_tpu_torch.simulation import fused_kernels as fk
from hybridq_tpu_torch.simulation import row_kernels as rk

CSRC = Path(__file__).resolve().parents[1] / 'hybridq_tpu_torch' / 'csrc'
SRC = CSRC / 'fused_apply.cu'
TOL = 1e-5
MAX_COLUMN_K = 5           # column_apply_kernel serves k <= 5
LOG_TILE = 13              # group_apply_kernel: 2^13 amplitudes a tile

SHIM = r'''
#pragma once
#include <algorithm>
#include <barrier>
#include <cstddef>
#include <cstring>
#include <math.h>
#include <memory>
#include <stdint.h>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))

struct __attribute__((aligned(8))) float2 { float x, y; };
struct __attribute__((aligned(16))) float4 { float x, y, z, w; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
typedef struct CUstream_st* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
enum cudaDeviceAttr {
  cudaDevAttrMultiProcessorCount,
  cudaDevAttrMaxSharedMemoryPerMultiprocessor,
  cudaDevAttrReservedSharedMemoryPerBlock
};

inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
inline thread_local std::barrier<>* hq_block_barrier = nullptr;

inline void __syncthreads() { hq_block_barrier->arrive_and_wait(); }
template <class T> inline T __ldg(const T* p) { return *p; }
using std::min;
inline float2 make_float2(float x, float y) { return {x, y}; }
inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline int hq_sms = 2;      // the SM count the persistent grid is sized by
extern "C" void hq_host_set_sms(int sms) { hq_sms = sms; }
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
// an H100's shared memory: 228 KiB an SM, 1 KiB of it reserved a block
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr what, int) {
  *v = what == cudaDevAttrMultiProcessorCount ? hq_sms
       : what == cudaDevAttrMaxSharedMemoryPerMultiprocessor ? 233472
                                                             : 1024;
  return cudaSuccess;
}

// tf32_mma.cuh's PTX helpers.  cvt.rna.tf32.f32: round half away from zero
// at 10 mantissa bits (carry into the exponent as the hardware does).
inline uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
template <int BYTES> inline void cp_async(void* dst, const void* src) {
  static_assert(BYTES == 4 || BYTES == 8 || BYTES == 16, "cp.async size");
  std::memcpy(dst, src, BYTES);
}
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}

// mma.sync.aligned.m16n8k8 TF32 for one warp: each lane deposits its
// fragments, the warp's barrier computes every lane's C in its completion
// step (run once, by the last thread to arrive), each lane takes its own.
// A lane's inputs of its next call cannot overwrite anything the
// completion still reads: it runs only once all 32 have arrived.
struct hq_warp;
struct hq_warp_done {
  hq_warp* w;
  void operator()() noexcept;
};
struct hq_warp {
  uint32_t a[32][4] = {}, b[32][2] = {};
  float c[32][4] = {};
  std::barrier<hq_warp_done> bar{32, hq_warp_done{this}};
  static float tf(uint32_t x) { return __uint_as_float(x & 0xffffe000u); }
  // A (16 x 8, row-major): (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
  float A(int r, int k) const {
    return tf(a[(r % 8) * 4 + k % 4][(r >= 8) + 2 * (k >= 4)]);
  }
  // B (8 x 8, column-major): (t, g), (t + 4, g)
  float B(int k, int n) const { return tf(b[n * 4 + k % 4][k >= 4]); }
  void compute() {
    for (int lane = 0; lane < 32; ++lane) {
      const int g = lane >> 2, t = lane & 3;
      // C (16 x 8): (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
      for (int q = 0; q < 4; ++q) {
        const int r = g + 8 * (q >> 1), n = 2 * t + (q & 1);
        float s = c[lane][q];
        for (int k = 0; k < 8; ++k) s += A(r, k) * B(k, n);
        c[lane][q] = s;
      }
    }
  }
};
inline void hq_warp_done::operator()() noexcept { w->compute(); }
inline thread_local hq_warp* hq_my_warp = nullptr;

inline void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  hq_warp& w = *hq_my_warp;
  const int lane = threadIdx.x % 32;
  for (int i = 0; i < 4; ++i) w.a[lane][i] = a[i];
  for (int i = 0; i < 2; ++i) w.b[lane][i] = b[i];
  for (int i = 0; i < 4; ++i) w.c[lane][i] = c[i];
  w.bar.arrive_and_wait();
  for (int i = 0; i < 4; ++i) c[i] = w.c[lane][i];
}

struct hq_config { dim3 grid, block; size_t smem; };
inline hq_config hq_cfg(dim3 grid, dim3 block, size_t smem = 0,
                        cudaStream_t = nullptr) {
  return {grid, block, smem};
}
inline hq_config hq_last;   // the configuration of the last launch

// Blocks one after another (x fastest); each CUDA thread of a block a
// std::thread.
template <class F, class... A>
void hq_launch(F kernel, hq_config c, A... args) {
  hq_last = c;
  const unsigned nt = c.block.x;
  for (unsigned by = 0; by < c.grid.y; ++by)
  for (unsigned b = 0; b < c.grid.x; ++b) {
    std::barrier<> bar(nt);
    std::unique_ptr<hq_warp[]> warps(new hq_warp[nt / 32]);
    std::vector<std::thread> threads;
    threads.reserve(nt);
    for (unsigned t = 0; t < nt; ++t)
      threads.emplace_back([&, t] {
        threadIdx = dim3(t);
        blockIdx = dim3(b, by);
        blockDim = c.block;
        gridDim = c.grid;
        hq_block_barrier = &bar;
        hq_my_warp = &warps[t / 32];
        kernel(args...);
        bar.arrive_and_drop();
        hq_my_warp->bar.arrive_and_drop();
      });
    for (auto& th : threads) th.join();
  }
}

// grid.x, block.x, dynamic shared bytes and grid.y of the last launch
extern "C" long long hq_host_last_launch(int what) {
  return what == 0   ? hq_last.grid.x
         : what == 1 ? hq_last.block.x
         : what == 2 ? (long long)hq_last.smem
                     : hq_last.grid.y;
}
'''


def host_source(text, launches, dyn_arrays):
    """The CUDA source as host C++: launches become calls, the dynamic
    shared memory a static buffer of 256 KiB (group_apply_kernel's two
    stages and tables take 139-165 KiB).  ``launches`` and
    ``dyn_arrays`` are the counts of ``<<<...>>>`` launches and of
    ``extern __shared__`` arrays the source must have."""
    text, n_launch = re.subn(r'(\w+(?:<\w+>)?)<<<(.*?)>>>\(',
                             r'hq_launch(\1, hq_cfg(\2), ', text)
    text, n_dyn = re.subn(r'extern\s+__shared__(.*?)\[\];',
                          r'__shared__\1[1 << 18];', text)
    assert (n_launch, n_dyn) == (launches, dyn_arrays), (n_launch, n_dyn)
    return text


@pytest.fixture(scope='module')
def group_apply(tmp_path_factory):
    """``hq_group_apply`` of ``csrc/fused_apply.cu`` built for the host,
    and the shim's record of the last launch."""
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip("needs g++ to compile csrc/fused_apply.cu for the host")
    d = tmp_path_factory.mktemp('group_apply_host')
    (d / 'cuda_runtime.h').write_text(SHIM)
    (d / 'fused_apply.cc').write_text(
        host_source(SRC.read_text(), launches=2, dyn_arrays=1))
    so = d / 'libfused_apply_host.so'
    subprocess.run([gxx, '-std=c++20', '-O1', '-shared', '-fPIC', '-pthread',
                    '-fno-strict-aliasing', '-I', str(d), '-I', str(CSRC),
                    '-o', str(so), str(d / 'fused_apply.cc')], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(so))
    fn = lib.hq_group_apply
    P, I, IP = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    fn.argtypes = [P, P, P, I, I, IP, I, IP, IP, P]
    fn.restype = ctypes.c_int
    last = lib.hq_host_last_launch
    last.argtypes, last.restype = [I], ctypes.c_longlong
    lib.hq_host_set_sms.argtypes = [I]
    return fn, last, lib.hq_host_set_sms


def _rand_u(k, rng):
    m = rng.standard_normal((2**k, 2**k)) + \
        1j * rng.standard_normal((2**k, 2**k))
    return np.linalg.qr(m)[0].astype(np.complex64)


def _call(group_apply, re_ptr, im_ptr, U, n, bits, lane=(), victims=(),
          sms=2):
    fn, last, set_sms = group_apply
    set_sms(sms)
    ints = lambda v, size: (ctypes.c_int * size)(*v)  # noqa: E731
    err = fn(re_ptr, im_ptr, U.ctypes.data, n, len(bits), ints(bits, 8),
             len(victims), ints(lane, 2), ints(victims, 2), None)
    assert err == 0
    return {'grid': last(0), 'block': last(1), 'smem': last(2)}


def _expect_launch(launch, n, k, sms=2):
    """k <= 5: column_apply_kernel (256 columns a block, no dynamic shared
    memory); k >= 6: group_apply_kernel, persistent blocks (at most one an
    SM) over 2^(n - 13) tiles of 2^k rows x 2^(13 - k) columns, with two
    stages of padded rows and four tables in dynamic shared memory."""
    if k <= MAX_COLUMN_K:
        assert launch == {'grid': 2 ** max(0, n - k - 8), 'block': 256,
                          'smem': 0}
    else:
        m, bn = 2 ** k, 2 ** (LOG_TILE - k)
        smem = 2 * 2 * m * (bn + 8) * 4 + (2 * bn + 2 * m) * 8
        assert launch == {'grid': min(2 ** max(0, n - LOG_TILE), sms),
                          'block': 256, 'smem': smem}


def _rel_err(got, want):
    want = np.asarray(want, dtype=np.float64)
    rms = np.sqrt(np.mean(want ** 2))
    return np.abs(np.asarray(got, dtype=np.float64) - want).max() / rms


def _container_case(group_apply, n, bits, lane, victims, seed, sms=2):
    """``hq_group_apply`` on the engine's container against
    ``fused_kernels._plain``, the gather/matmul/scatter that
    ``apply_fused_plain`` and ``apply_swap_plain`` run."""
    rng = np.random.default_rng(seed)
    k = len(bits)
    U = _rand_u(k, rng)
    st = rng.standard_normal(2 ** (n + 1)).astype(np.float32)
    st /= np.linalg.norm(st)
    want = torch.from_numpy(st.copy())
    fk._plain(want[:2 ** n], want[2 ** n:], n, U, bits, lane, victims)
    launch = _call(group_apply, st.ctypes.data, st.ctypes.data + 4 * 2 ** n,
                   U, n, bits, lane, victims, sms)
    _expect_launch(launch, n, k, sms)
    assert _rel_err(st, want.numpy()) <= TOL


def _pick(rng, k, kv, n):
    """Random distinct gate bits, ``kv`` of them paired with victims (any
    positions, bits 0-2 included)."""
    allb = [int(b) for b in rng.permutation(n)[:k + kv]]
    bits, victims = allb[:k], allb[k:]
    lane = sorted((int(b) for b in rng.choice(bits, kv, replace=False)),
                  reverse=True)
    return bits, lane, victims


COLUMN_CASES = sorted({(k, kv, n) for k in range(1, MAX_COLUMN_K + 1)
                       for kv in range(min(k, 2) + 1)
                       for n in (k + kv, 8, 9, 10, 11) if n >= k + kv})


@pytest.mark.parametrize('k, kv, n', COLUMN_CASES)
def test_column_kernel_matches_plain(group_apply, k, kv, n):
    """Every k <= 5 with 0-2 victims, n from k + kv (one column, all but
    one thread masked) to 2^(n - k - 8) = 8 blocks."""
    rng = np.random.default_rng(100 * k + 10 * kv + n)
    bits, lane, victims = _pick(rng, k, kv, n)
    _container_case(group_apply, n, bits, lane, victims, seed=n + k)


# (k, kv, n, SMs): two tiles at n = 14 (on two blocks, or walked by one),
# four at n = 15 walked by one block (each stage refilled),
# one below a tile's 2^13 amplitudes, and one column (n = k + kv) with the
# other 31 of its fragment's columns zero
GROUP_CASES = [(6, 0, 14, 2), (7, 1, 11, 2), (8, 2, 10, 2), (6, 0, 14, 1),
               (6, 1, 15, 1), (7, 2, 14, 1)] + \
    [(k, kv, k + kv, 2) for k in range(6, 9) for kv in range(3)]


@pytest.mark.parametrize('k, kv, n, sms', GROUP_CASES)
def test_group_kernel_matches_plain(group_apply, k, kv, n, sms):
    """The tensor-core kernel of k = 6..8 at random gate and victim bits
    (bits 0-2 included)."""
    rng = np.random.default_rng([k, kv, n, sms])
    bits, lane, victims = _pick(rng, k, kv, n)
    _container_case(group_apply, n, bits, lane, victims, seed=k, sms=sms)


# (bits, lane, victims, n): the lowest group bit 0, 1 and >= 2 (copies of
# 1, 2 and 4 floats), lane bits 0-2 exchanged with victims
LOW_BIT_CASES = [
    ([0, 5, 9, 3, 7, 11], [], [], 12),
    ([8, 1, 4, 6, 10, 2, 12], [], [], 13),
    ([3, 9, 5, 7, 11, 4, 6, 10], [], [], 12),
    ([2, 8, 5, 11, 3, 9], [2], [0], 12),
    ([10, 0, 6, 1, 12, 4, 8], [1, 0], [5, 3], 13),
    ([6, 9, 2, 11, 4, 7, 10, 3], [3, 2], [12, 13], 14),
]


@pytest.mark.parametrize('bits, lane, victims, n', LOW_BIT_CASES)
def test_group_kernel_low_bits(group_apply, bits, lane, victims, n):
    _container_case(group_apply, n, bits, lane, victims, seed=n + len(bits))


@pytest.mark.parametrize('k, low', [(k, low) for k in range(1, MAX_COLUMN_K + 1)
                                    for low in range(3)])
def test_column_kernel_low_bits(group_apply, k, low):
    """``column_apply_kernel`` with the lowest gate bit at 0, 1 or 2 (a
    warp's loads then touch a half or a quarter of each sector): the
    straight route's ``apply_bits`` on a DM-like register, at n = 12."""
    n = 12
    rng = np.random.default_rng([k, low])
    bits = [low] + [int(b) for b in rng.choice(range(low + 1, n), k - 1,
                                               replace=False)]
    rng.shuffle(bits)
    _container_case(group_apply, n, bits, [], [], seed=k + 10 * low)


@pytest.mark.parametrize('k, kl', [(1, 1), (3, 1), (4, 2), (5, 2)])
def test_column_kernel_matches_swap_plain(group_apply, k, kl):
    """The engine's swap shape, through ``apply_swap_plain`` itself: lane
    bits (< 7) exchanged with victims (>= 12), sublane and high gate bits,
    at n = 14 (2^(9 - k) blocks)."""
    n = 14
    rng = np.random.default_rng(k + 10 * kl)
    victims = [int(v) for v in rng.choice([12, 13], kl, replace=False)]
    bits = [int(b) for b in rng.choice(7, kl, replace=False)] + \
        [int(b) for b in rng.choice([b for b in range(7, n)
                                     if b not in victims], k - kl,
                                    replace=False)]
    rng.shuffle(bits)
    U = _rand_u(k, rng)
    st = rng.standard_normal(2 ** (n + 1)).astype(np.float32)
    st /= np.linalg.norm(st)
    want = fk.apply_swap_plain(torch.from_numpy(st.copy()), U, bits, victims)
    lane, victims = fk._swap_pairs(bits, victims)
    launch = _call(group_apply, st.ctypes.data, st.ctypes.data + 4 * 2 ** n,
                   U, n, bits, lane, victims)
    _expect_launch(launch, n, k)
    assert _rel_err(st, want.numpy()) <= TOL


@pytest.mark.parametrize('n, L, positions', [
    (9, 0, (0, 2, 1)), (10, 0, (4, 0, 3, 1, 2)), (11, 3, (0, 5)),
    (12, 10, (1, 0)), (8, 0, (7,)), (6, 1, (4, 2, 0, 3, 1)),
])
def test_column_kernel_matches_gate_rows_plain(group_apply, n, L, positions):
    """``apply_gate_rows``'s shape: separate re and im arrays, gate bits
    from L up (L = 0: flat bits 0-2 are gate bits)."""
    rng = np.random.default_rng(n + L)
    k = len(positions)
    U = _rand_u(k, rng)
    re_ = rng.standard_normal(2 ** n).astype(np.float32)
    im_ = rng.standard_normal(2 ** n).astype(np.float32)
    want = rk.apply_gate_rows_plain(torch.from_numpy(re_.copy()),
                                    torch.from_numpy(im_.copy()), U.real,
                                    U.imag, positions, n, L)
    launch = _call(group_apply, re_.ctypes.data, im_.ctypes.data, U, n,
                   [p + L for p in positions])
    _expect_launch(launch, n, k)
    got = np.concatenate([re_, im_])
    assert _rel_err(got, torch.cat(want).numpy()) <= TOL


@pytest.mark.parametrize('n, L, positions, shift', [
    (12, 3, (0, 5, 2, 7, 1, 4), 0), (11, 0, (4, 0, 3, 1, 2, 9, 6), 1),
    (13, 2, (9, 0, 7, 2, 5, 1, 8, 3), 1), (14, 4, (8, 9, 7, 6, 5, 4), 0),
])
def test_group_kernel_matches_gate_rows_plain(group_apply, n, L, positions,
                                              shift):
    """``apply_gate_rows``'s shape at k = 6..8: separate re and im arrays;
    ``shift`` = 1 puts im one float past re's alignment (copies of one
    float)."""
    rng = np.random.default_rng([n, L, shift])
    k = len(positions)
    U = _rand_u(k, rng)
    re_ = rng.standard_normal(2 ** n).astype(np.float32)
    buf = np.zeros(2 ** n + 1, dtype=np.float32)
    im_ = buf[shift:shift + 2 ** n]
    im_[:] = rng.standard_normal(2 ** n)
    want = rk.apply_gate_rows_plain(torch.from_numpy(re_.copy()),
                                    torch.from_numpy(im_.copy()), U.real,
                                    U.imag, positions, n, L)
    launch = _call(group_apply, re_.ctypes.data, im_.ctypes.data, U, n,
                   [p + L for p in positions])
    _expect_launch(launch, n, k)
    got = np.concatenate([re_, im_])
    assert _rel_err(got, torch.cat(want).numpy()) <= TOL


def test_rejects_out_of_range(group_apply):
    """k outside 1..8, more than 2 victims or n < k + kv: an error code,
    no launch."""
    fn = group_apply[0]
    st = np.zeros(2 ** 5, dtype=np.float32)
    U = np.eye(2 ** 4, dtype=np.complex64)
    ints = lambda v: (ctypes.c_int * 8)(*v)  # noqa: E731
    base = st.ctypes.data
    for n, k, kv in [(4, 0, 0), (12, 9, 0), (12, 1, 3), (4, 4, 1)]:
        assert fn(base, base + 64, U.ctypes.data, n, k, ints(range(8)), kv,
                  ints([0, 1]), ints([5, 6]), None) != 0
