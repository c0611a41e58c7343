"""``csrc/fused_apply.cu`` itself, compiled for the host and checked there.

The kernel source is compiled with ``g++ -std=c++20`` against a small
stand-in for ``cuda_runtime.h`` (``SHIM`` below): every CUDA thread is a
``std::thread``, ``__syncthreads`` is a ``std::barrier`` (a thread that
leaves the kernel calls ``arrive_and_drop``, so an early exit cannot hang
the test), ``__shared__`` is ``static`` and the blocks of a launch run one
after another.  Before compiling, the test turns each ``<<<...>>>``
launch into a plain call and gives the dynamic shared memory a fixed size.

``hq_group_apply`` is called through ctypes on numpy arrays and held
against the plain PyTorch versions on the CPU (``apply_fused_plain``,
``apply_swap_plain``'s gather/matmul/scatter, ``apply_gate_rows_plain``):
max|d|/rms <= 1e-5, f32 sums taken in another order.  Since blocks run in
order, a block that wrote an address that a later block reads would show
up as a wrong amplitude: the cases check the ownership rule (a block
writes only addresses it has read) as well as the indexing.  Skipped
where ``g++`` is missing.
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

SRC = Path(__file__).resolve().parents[1] / 'hybridq_tpu_torch' / 'csrc' / \
    'fused_apply.cu'
TOL = 1e-5
MAX_COLUMN_K = 5           # column_apply_kernel serves k <= 5

SHIM = r'''
#pragma once
#include <algorithm>
#include <barrier>
#include <cstddef>
#include <math.h>
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

inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
inline thread_local std::barrier<>* hq_block_barrier = nullptr;

inline void __syncthreads() { hq_block_barrier->arrive_and_wait(); }
template <class T> inline T __ldg(const T* p) { return *p; }
using std::min;
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}

struct hq_config { dim3 grid, block; size_t smem; };
inline hq_config hq_cfg(dim3 grid, dim3 block, size_t smem = 0,
                        cudaStream_t = nullptr) {
  return {grid, block, smem};
}
inline hq_config hq_last;   // the configuration of the last launch

// Blocks one after another; each CUDA thread of a block a std::thread.
template <class F, class... A>
void hq_launch(F kernel, hq_config c, A... args) {
  hq_last = c;
  const unsigned nt = c.block.x;
  for (unsigned b = 0; b < c.grid.x; ++b) {
    std::barrier<> bar(nt);
    std::vector<std::thread> threads;
    threads.reserve(nt);
    for (unsigned t = 0; t < nt; ++t)
      threads.emplace_back([&, t] {
        threadIdx = dim3(t);
        blockIdx = dim3(b);
        blockDim = c.block;
        gridDim = c.grid;
        hq_block_barrier = &bar;
        kernel(args...);
        bar.arrive_and_drop();
      });
    for (auto& th : threads) th.join();
  }
}

// grid.x, block.x and dynamic shared bytes of the last launch
extern "C" long long hq_host_last_launch(int what) {
  return what == 0 ? hq_last.grid.x
                   : what == 1 ? hq_last.block.x : (long long)hq_last.smem;
}
'''


def host_source(text):
    """The CUDA source as host C++: launches become calls, the dynamic
    shared memory a static buffer of 128 KiB (a full tile takes 66 KiB)."""
    text, n_launch = re.subn(r'(\w+(?:<\w+>)?)<<<(.*?)>>>\(',
                             r'hq_launch(\1, hq_cfg(\2), ', text)
    text, n_dyn = re.subn(r'extern\s+__shared__(.*?)\[\];',
                          r'__shared__\1[1 << 17];', text)
    assert n_launch == 2 and n_dyn == 1, (n_launch, n_dyn)
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
    (d / 'fused_apply.cc').write_text(host_source(SRC.read_text()))
    so = d / 'libfused_apply_host.so'
    subprocess.run([gxx, '-std=c++20', '-O1', '-shared', '-fPIC', '-pthread',
                    '-fno-strict-aliasing', '-I', str(d), '-o', str(so),
                    str(d / 'fused_apply.cc')], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(so))
    fn = lib.hq_group_apply
    P, I, IP = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    fn.argtypes = [P, P, P, I, I, IP, I, IP, IP, P]
    fn.restype = ctypes.c_int
    last = lib.hq_host_last_launch
    last.argtypes, last.restype = [I], ctypes.c_longlong
    return fn, last


def _rand_u(k, rng):
    m = rng.standard_normal((2**k, 2**k)) + \
        1j * rng.standard_normal((2**k, 2**k))
    return np.linalg.qr(m)[0].astype(np.complex64)


def _call(group_apply, re_ptr, im_ptr, U, n, bits, lane=(), victims=()):
    fn, last = group_apply
    ints = lambda v, size: (ctypes.c_int * size)(*v)  # noqa: E731
    err = fn(re_ptr, im_ptr, U.ctypes.data, n, len(bits), ints(bits, 8),
             len(victims), ints(lane, 2), ints(victims, 2), None)
    assert err == 0
    return {'grid': last(0), 'block': last(1), 'smem': last(2)}


def _expect_launch(launch, n, k):
    """k <= 5: column_apply_kernel (256 columns a block, no dynamic shared
    memory); k >= 6: group_apply_kernel (2^13-amplitude tiles)."""
    if k <= MAX_COLUMN_K:
        assert launch == {'grid': 2 ** max(0, n - k - 8), 'block': 256,
                          'smem': 0}
    else:
        assert launch['grid'] == 2 ** (n - min(n, 13))
        assert launch['smem'] > 0


def _rel_err(got, want):
    want = np.asarray(want, dtype=np.float64)
    rms = np.sqrt(np.mean(want ** 2))
    return np.abs(np.asarray(got, dtype=np.float64) - want).max() / rms


def _container_case(group_apply, n, bits, lane, victims, seed):
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
                   U, n, bits, lane, victims)
    _expect_launch(launch, n, k)
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


@pytest.mark.parametrize('k, kv, n', [(6, 0, 14), (7, 1, 11), (8, 2, 10)])
def test_group_kernel_matches_plain(group_apply, k, kv, n):
    """The staged kernel that k = 6..8 keep: two tiles at n = 14, one
    below a tile's 2^13 amplitudes."""
    rng = np.random.default_rng(k)
    bits, lane, victims = _pick(rng, k, kv, n)
    _container_case(group_apply, n, bits, lane, victims, seed=k)


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


def test_rejects_out_of_range(group_apply):
    """k outside 1..8, more than 2 victims or n < k + kv: an error code,
    no launch."""
    fn, _ = group_apply
    st = np.zeros(2 ** 5, dtype=np.float32)
    U = np.eye(2 ** 4, dtype=np.complex64)
    ints = lambda v: (ctypes.c_int * 8)(*v)  # noqa: E731
    base = st.ctypes.data
    for n, k, kv in [(4, 0, 0), (12, 9, 0), (12, 1, 3), (4, 4, 1)]:
        assert fn(base, base + 64, U.ctypes.data, n, k, ints(range(8)), kv,
                  ints([0, 1]), ints([5, 6]), None) != 0
