"""``csrc/gather_runs.cu`` itself, compiled for the host and checked there.

The source is compiled with ``g++ -std=c++20`` against the stand-ins of
``test_torch_stream_host`` (``cuda_runtime.h``: a ``std::thread`` per CUDA
thread, blocks one after another, an H100's shared memory per SM, the
streaming loads and stores; ``tma_ring.cuh``: an mbarrier as a phase bit
with its pending arrivals and bytes, a bulk copy as a ``memcpy``, a wait
of more than 5 s marking the launch stuck and failing the case), with
three additions (``LOGGED``): a stand-in ``cuda_bf16.h`` (round to
nearest even), ``mma.sync`` m16n8k16 bf16 as a warp collective (each lane
deposits its fragments, the warp's barrier computes C from the PTX
fragment layout), and a log of every global access of the two kernels
(the register path's ``__ldcs`` / ``__stcs``, the bulk copies) with the
block and thread that made it.

``hq_gather_scale`` is called through ctypes on numpy arrays, for every
``gather.VARIANTS`` mapping at a small row count (and more runs and
stages), and each result is held to ``2 * x`` or ``bf16(x)`` exactly.  The
log shows the probe's access pattern: block b of the register path reads
and writes, warp w, the source rows of virtual rows 32 b + 4 w to
32 b + 4 w + 3, each row's loads before its stores; block b of the
matmul path loads into stage s the source rows of unit b * nbuf + s, in
the order of its virtual rows, and writes each stage back to the rows it
came from.  Skipped where ``g++`` is missing.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest

from hybridq_tpu_torch.probes import gather
from tests.test_torch_group_apply_host import CSRC, SHIM, host_source
from tests.test_torch_stream_host import EXTRA, TMA_HOST

SRC = CSRC / 'gather_runs.cu'
BLOCK_ROWS = 32            # register path: 32 virtual rows a block,
WARP_ROWS = 4              # 4 consecutive ones a warp
ROW_THREADS = 256
CHUNK_THREADS = 512

BF16_HOST = r'''
#pragma once
#include <cstring>
#include <stdint.h>
struct __nv_bfloat162 { uint16_t x, y; };
inline uint16_t hq_bf16_rn(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return (uint16_t)((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}
inline __nv_bfloat162 __floats2bfloat162_rn(float lo, float hi) {
  return {hq_bf16_rn(lo), hq_bf16_rn(hi)};
}
'''

LOGGED = r'''
#include <array>
#include <mutex>
#include <vector>

// (kind, block, thread, global address, shared address, bytes): kind 0 a
// load, 1 a store of the register path; 2 a bulk load, 3 a bulk store
inline std::mutex hq_log_mu;
inline std::vector<std::array<int64_t, 6>> hq_log;
inline void hq_record(int kind, const void* g, const void* s, int64_t bytes) {
  std::lock_guard<std::mutex> lk(hq_log_mu);
  hq_log.push_back({kind, (int64_t)blockIdx.x, (int64_t)threadIdx.x,
                    (int64_t)(uintptr_t)g, (int64_t)(uintptr_t)s, bytes});
}
extern "C" int64_t hq_host_log(int64_t* out, int64_t cap) {
  std::lock_guard<std::mutex> lk(hq_log_mu);
  const int64_t n = (int64_t)hq_log.size();
  if (!out) return n;                     // the count alone
  for (int64_t i = 0; i < n && i < cap; ++i)
    for (int f = 0; f < 6; ++f) out[6 * i + f] = hq_log[i][f];
  hq_log.clear();
  return n;
}
inline float4 hq_ldcs(const float4* p) {
  hq_record(0, p, nullptr, 16);
  return *p;
}
inline void hq_stcs(float4* p, float4 v) {
  hq_record(1, p, nullptr, 16);
  *p = v;
}

// mma.sync.aligned.m16n8k16 bf16 for one warp: A (16 x 16, row-major)
// a[0] = (g, 2t..2t+1), a[1] = (g + 8, 2t..), a[2] = (g, 2t + 8..),
// a[3] = (g + 8, 2t + 8..); B (16 x 8, column-major) b[0] = (2t..2t+1, g),
// b[1] = (2t + 8.., g); the low half of a word the lower index.
struct hq_bf16_warp;
struct hq_bf16_done {
  hq_bf16_warp* w;
  void operator()() noexcept;
};
struct hq_bf16_warp {
  uint32_t a[32][4] = {}, b[32][2] = {};
  float c[32][4] = {};
  std::barrier<hq_bf16_done> bar{32, hq_bf16_done{this}};
  static float bf(uint32_t word, int hi) {
    return __uint_as_float((hi ? word >> 16 : word & 0xffffu) << 16);
  }
  float A(int r, int k) const {
    return bf(a[(r % 8) * 4 + (k % 8) / 2][(r >= 8) + 2 * (k >= 8)], k & 1);
  }
  float B(int k, int n) const {
    return bf(b[n * 4 + (k % 8) / 2][k >= 8], k & 1);
  }
  void compute() {
    for (int lane = 0; lane < 32; ++lane) {
      const int g = lane >> 2, t = lane & 3;
      for (int q = 0; q < 4; ++q) {
        const int r = g + 8 * (q >> 1), n = 2 * t + (q & 1);
        float s = c[lane][q];
        for (int k = 0; k < 16; ++k) s += A(r, k) * B(k, n);
        c[lane][q] = s;
      }
    }
  }
};
inline void hq_bf16_done::operator()() noexcept { w->compute(); }
inline hq_bf16_warp hq_bf16_warps[32];   // blocks run one after another

inline void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  hq_bf16_warp& w = hq_bf16_warps[threadIdx.x / 32];
  const int lane = threadIdx.x % 32;
  for (int i = 0; i < 4; ++i) w.a[lane][i] = a[i];
  for (int i = 0; i < 2; ++i) w.b[lane][i] = b[i];
  for (int i = 0; i < 4; ++i) w.c[lane][i] = c[i];
  w.bar.arrive_and_wait();
  for (int i = 0; i < 4; ++i) c[i] = w.c[lane][i];
}
'''


def _logged_tma():
    """``TMA_HOST`` with every bulk load and store recorded."""
    load = ('inline void load(void* dst, const void* src, uint32_t bytes, '
            'uint64_t* bar) {\n')
    store = ('inline void store(void* dst, const void* src, '
             'uint32_t bytes) {\n')
    assert load in TMA_HOST and store in TMA_HOST
    return (TMA_HOST.replace(load, load + '  hq_record(2, src, dst, bytes);\n')
            .replace(store, store + '  hq_record(3, dst, src, bytes);\n'))


@pytest.fixture(scope='module')
def lib(tmp_path_factory):
    """``csrc/gather_runs.cu`` built for the host."""
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip("needs g++ to compile csrc/gather_runs.cu for the host")
    d = tmp_path_factory.mktemp('gather_host')
    runtime = SHIM + EXTRA + LOGGED
    runtime = runtime.replace('template <class T> inline T __ldcs(const T* p) '
                              '{ return *p; }', '')
    runtime = runtime.replace('template <class T> inline void __stcs(T* p, '
                              'T v) { *p = v; }', '')
    runtime += ('\n#define __ldcs hq_ldcs\n#define __stcs hq_stcs\n')
    assert '__ldcs(const T' not in runtime
    (d / 'cuda_runtime.h').write_text(runtime)
    (d / 'cuda_bf16.h').write_text(BF16_HOST)
    (d / 'tma_ring.cuh').write_text(_logged_tma())
    (d / 'gather_runs.cc').write_text(
        host_source(SRC.read_text(), launches=2, dyn_arrays=1))
    so = d / 'libgather_runs_host.so'
    subprocess.run([gxx, '-std=c++20', '-O1', '-shared', '-fPIC', '-pthread',
                    '-fno-strict-aliasing', '-I', str(d), '-I', str(CSRC),
                    '-o', str(so), str(d / 'gather_runs.cc')], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(so))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.hq_gather_scale.argtypes = [P, L, I, I, I, I, I, P]
    lib.hq_gather_scale.restype = I
    lib.hq_host_last_launch.argtypes = [I]
    lib.hq_host_last_launch.restype = ctypes.c_longlong
    lib.hq_host_log.argtypes = [P, L]
    lib.hq_host_log.restype = L
    return lib


@pytest.fixture(autouse=True)
def not_stuck(request):
    yield
    if 'lib' in request.fixturenames:
        stuck = request.getfixturevalue('lib').hq_host_stuck()
        assert not stuck, "an mbarrier wait never completed"


def _log(lib):
    n = lib.hq_host_log(None, 0)
    out = np.zeros((n, 6), dtype=np.int64)
    got = lib.hq_host_log(out.ctypes.data, n)
    assert got == n
    return out


def _bf16(x):
    u = x.view(np.uint32).astype(np.uint64)
    r = ((u + 0x7fff + ((u >> 16) & 1)) >> 16) << 16
    return r.astype(np.uint32).view(np.float32)


def _source_rows(rows, run_rows):
    """Source row of every virtual row (``gather.run_source`` on runs)."""
    v = np.arange(rows)
    return gather.run_source(v // run_rows, rows // run_rows) * run_rows + \
        v % run_rows


def _call(lib, x, run_rows, stage, nbuf, matmul):
    rows = x.shape[0]
    half = (rows // run_rows).bit_length() // 2
    _log(lib)                                    # drop older entries
    err = lib.hq_gather_scale(x.ctypes.data, rows, run_rows, stage, half,
                              nbuf, int(matmul), None)
    launch = tuple(lib.hq_host_last_launch(w) for w in range(3))
    return err, launch, _log(lib)


def _check_rows(log, base, rows, run_rows):
    """Register path: block b, warp w reads then writes the rows src(32 b +
    4 w + i), i = 0..3 in turn, lane l its 16 bytes at 16 l; each thread's
    loads all come before its stores."""
    src = _source_rows(rows, run_rows)
    assert len(log) == 2 * rows * 32
    for kind in (0, 1):
        e = log[log[:, 0] == kind]
        off = e[:, 3] - base
        # the thread's i-th access of this kind, in the order it made them
        key = e[:, 1] * ROW_THREADS + e[:, 2]
        order = np.argsort(key, kind='stable')
        i = np.empty(len(e), dtype=np.int64)
        i[order] = np.arange(len(e)) - np.searchsorted(key[order],
                                                       key[order])
        v = e[:, 1] * BLOCK_ROWS + (e[:, 2] // 32) * WARP_ROWS + i
        np.testing.assert_array_equal(off // 512, src[v])
        np.testing.assert_array_equal(off % 512, 16 * (e[:, 2] % 32))
    thread = log[:, 1] * ROW_THREADS + log[:, 2]
    for t in np.unique(thread):
        kinds = log[thread == t, 0]
        assert (np.diff(kinds) >= 0).all(), "a store before a load"


def _check_chunks(log, base, rows, run_rows, stage, nbuf):
    """Matmul path: block b fills stage s with unit b * nbuf + s, copy c
    of a stage (c * copy_rows rows in) from the source rows of its virtual
    rows, and stores each copy back to the same rows."""
    src = _source_rows(rows, run_rows)
    copy_rows = min(run_rows, stage)
    loads, stores = log[log[:, 0] == 2], log[log[:, 0] == 3]
    assert len(loads) == len(stores) == rows // copy_rows
    assert (loads[:, 5] == copy_rows * 512).all()
    ring = loads[:, 4].min()
    for e in loads:
        pos = (e[4] - ring) // 512                # row of the block's ring
        unit = e[1] * nbuf + pos // stage
        v = unit * stage + pos % stage
        assert (e[3] - base) // 512 == src[v]
    got = sorted((e[1], e[4], e[3]) for e in loads)
    back = sorted((e[1], e[4], e[3]) for e in stores)
    assert got == back                            # each copy back in place


# (rows, variant): every mapping of gather.VARIANTS, and more runs and
# stages than there are SMs' worth at the probe's size
CASES = [(1024, v) for v in gather.VARIANTS] + [
    (2048, gather.GVariant('run 512B, more runs', 1, 1024)),
    (512, gather.GVariant('one run', 512, 1024)),
    (2048, gather.GVariant('matmul, runs of one row', 1, 1024, True)),
    (1024, gather.GVariant('matmul, runs over stages', 512, 1024, True)),
    (128, gather.GVariant('matmul, one stage of two', 32, 128, True)),
]
# the matmul path with stages that gather.stage_rows would cut: two of a
# block's three stages of 128 rows filled (192 KiB, one block an SM)
STAGED = [(256, gather.GVariant('matmul, two stages of three', 8, 128, True,
                                3), 128)]


@pytest.mark.parametrize('rows, v, stage',
                         [(r, v, None) for r, v in CASES] + STAGED,
                         ids=lambda c: getattr(c, 'name', str(c)))
def test_variant_matches_plain_and_pattern(lib, rows, v, stage):
    x = np.random.default_rng(rows + v.run_rows).standard_normal(
        (rows, 128)).astype(np.float32)
    want = _bf16(x) if v.matmul else 2 * x
    stage = stage or gather.stage_rows(v.blk_rows, v.nbuf)
    err, launch, log = _call(lib, x, v.run_rows, stage, v.nbuf, v.matmul)
    assert err == 0
    np.testing.assert_array_equal(x, want)
    base = x.ctypes.data
    if v.matmul:
        units = rows // stage
        blocks = -(-units // v.nbuf)
        assert launch == (blocks, CHUNK_THREADS,
                          v.nbuf * stage * 512)
        _check_chunks(log, base, rows, v.run_rows, stage, v.nbuf)
    else:
        assert launch == (-(-rows // BLOCK_ROWS), ROW_THREADS, 0)
        _check_rows(log, base, rows, v.run_rows)


def test_matmul_rounds_half_way_to_even(lib):
    """bf16 rounding ties: values half way between two bf16 go to the even
    one, as the tensor cores and PyTorch's ``to(torch.bfloat16)`` do."""
    x = np.full((128, 128), 1 + 2 ** -8, dtype=np.float32)
    x[1::2] = 1 + 3 * 2 ** -8
    err, _, _ = _call(lib, x, 128, 128, 2, True)
    assert err == 0
    assert (x[0::2] == 1).all() and (x[1::2] == 1 + 2 ** -6).all()


@pytest.mark.parametrize('args', [
    (1024, 3, 128, 5, 2, 0),      # run not a power of two
    (1024, 4, 96, 4, 2, 0),       # stage not a power of two
    (1024, 4, 128, 4, 1, 0),      # nbuf < 2
    (1024, 4, 128, 4, 9, 0),      # nbuf > 8
    (1024, 4, 64, 4, 2, 1),       # matmul stage not whole chunks
    (1024, 4, 512, 4, 2, 0),      # 2 x 256 KiB ring
    (1024, 4, 128, 9, 2, 0),      # half past the run count's bits
    (0, 1, 128, 0, 2, 0),         # no rows
    (768, 4, 128, 4, 2, 0),       # rows / run_rows not a power of two
])
def test_rejects_bad_arguments(lib, args):
    """An error code, no launch's access, and nothing written."""
    rows, run, stage, half, nbuf, matmul = args
    x = np.full((max(rows, 1), 128), np.nan, dtype=np.float32)
    _log(lib)
    assert lib.hq_gather_scale(x.ctypes.data, rows, run, stage, half, nbuf,
                               matmul, None) != 0
    assert len(_log(lib)) == 0
    assert np.isnan(x).all()
