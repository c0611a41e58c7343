"""``csrc/stream_scale.cu`` itself, compiled for the host and checked there.

The source is compiled with ``g++ -std=c++20`` against the stand-in for
``cuda_runtime.h`` of ``test_torch_group_apply_host`` (``SHIM``: a
``std::thread`` per CUDA thread, blocks one after another, an H100's
shared memory per SM), with ``make_float4``, ``__syncwarp`` and the
streaming loads and stores added (``EXTRA``), and against a host stand-in
for ``csrc/tma_ring.cuh`` (``TMA_HOST``) that the build finds ahead of
``csrc/``: an mbarrier is a phase bit with its pending arrivals and
bytes, a bulk load is a ``memcpy`` that then completes its bytes on the
mbarrier, a bulk store is a ``memcpy``, the bulk-group waits and proxy
fences return at once, and ``bar_wait`` spins on the phase (a wait of
more than 5 s, a deadlock on the card, marks the launch stuck and fails
the case).

``hq_scale``, ``hq_scale_inplace`` and ``hq_scale_pipelined`` are called
through ctypes on numpy arrays, the output prefilled with NaN, and each
result is held to ``2 * x`` exactly, with the launch's grid, block and
shared memory: partial last chunks, tiles, stages and blocks, ``nbuf``
from 2 to 8, stages of 16 bytes to 72 KiB, and the tiles in place.  This
is the only check of the stages' indexing and mbarrier phases off the
card.  Skipped where ``g++`` is missing.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest

from tests.test_torch_group_apply_host import CSRC, SHIM, host_source

SRC = CSRC / 'stream_scale.cu'
CHUNK4 = 512               # 16-byte vectors (and threads) a tile block
RING_THREADS = 288         # 256 consumers and the producer warp
MAX_RING_BYTES = 227 * 1024
IN_FLIGHT = 64 * 1024      # loads in flight an SM that the ring aims at

EXTRA = r'''
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
template <class T> inline T __ldcs(const T* p) { return *p; }
template <class T> inline void __stcs(T* p, T v) { *p = v; }
inline void __syncwarp(unsigned = 0xffffffffu) {
  hq_my_warp->bar.arrive_and_wait();
}
'''

TMA_HOST = r'''
#pragma once
#include <cuda_runtime.h>
#include <atomic>
#include <chrono>
#include <cstring>
#include <memory>
#include <mutex>
#include <stdint.h>
#include <thread>
#include <unordered_map>

namespace tma {

struct HostBar {
  std::mutex mu;
  uint32_t count = 0, pending = 0;  // arrivals expected, still to come
  int64_t tx = 0;                   // bytes still to come this phase
  std::atomic<uint32_t> phase{0};   // parity of the current phase
  void step() {                     // with mu held
    if (pending == 0 && tx == 0) {
      pending = count;
      phase.fetch_xor(1);
    }
  }
};

inline HostBar& host_bar(uint64_t* bar) {
  static std::mutex mu;
  static std::unordered_map<uint64_t*, std::unique_ptr<HostBar>> bars;
  std::lock_guard<std::mutex> g(mu);
  auto& b = bars[bar];
  if (!b) b.reset(new HostBar);
  return *b;
}

inline void bar_init(uint64_t* bar, uint32_t count) {
  HostBar& b = host_bar(bar);
  std::lock_guard<std::mutex> g(b.mu);
  b.count = b.pending = count;
  b.tx = 0;
  b.phase = 0;
}
inline void fence_bar_init() {}
inline void arrive(uint64_t* bar, int64_t bytes, uint32_t arrivals) {
  HostBar& b = host_bar(bar);
  std::lock_guard<std::mutex> g(b.mu);
  b.tx += bytes;
  b.pending -= arrivals;
  b.step();
}
inline void bar_expect(uint64_t* bar, uint32_t bytes) {
  arrive(bar, bytes, 1);
}
inline void bar_arrive(uint64_t* bar) { arrive(bar, 0, 1); }
// A wait that outlasts kStuck marks the run stuck (a deadlock on the
// card); every wait then returns, so the launch ends and the case fails.
inline std::atomic<bool> stuck{false};
extern "C" int hq_host_stuck() { return stuck.exchange(false); }
inline void bar_wait(uint64_t* bar, uint32_t parity) {
  constexpr auto kStuck = std::chrono::seconds(5);
  HostBar& b = host_bar(bar);
  const auto t0 = std::chrono::steady_clock::now();
  while (b.phase.load() == parity && !stuck) {
    std::this_thread::yield();
    if (std::chrono::steady_clock::now() - t0 > kStuck) stuck = true;
  }
}
inline void load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  std::memcpy(dst, src, bytes);
  arrive(bar, -(int64_t)bytes, 0);
}
inline void store(void* dst, const void* src, uint32_t bytes) {
  std::memcpy(dst, src, bytes);
}
inline void commit() {}
template <int N> inline void wait_read() {}
inline void wait_all() {}
inline void fence_async_smem() {}

}  // namespace tma
'''


@pytest.fixture(scope='module')
def lib(tmp_path_factory):
    """``csrc/stream_scale.cu`` built for the host."""
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip("needs g++ to compile csrc/stream_scale.cu for the host")
    d = tmp_path_factory.mktemp('stream_host')
    (d / 'cuda_runtime.h').write_text(SHIM + EXTRA)
    (d / 'tma_ring.cuh').write_text(TMA_HOST)
    (d / 'stream_scale.cc').write_text(
        host_source(SRC.read_text(), launches=2, dyn_arrays=1))
    so = d / 'libstream_scale_host.so'
    subprocess.run([gxx, '-std=c++20', '-O1', '-shared', '-fPIC', '-pthread',
                    '-fno-strict-aliasing', '-I', str(d), '-I', str(CSRC),
                    '-o', str(so), str(d / 'stream_scale.cc')], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(so))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for name, args in (('hq_scale', [P, P, L, I, I, P]),
                       ('hq_scale_inplace', [P, L, I, I, P]),
                       ('hq_scale_pipelined', [P, P, L, I, I, I, P])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, I
    lib.hq_host_last_launch.argtypes = [I]
    lib.hq_host_last_launch.restype = ctypes.c_longlong
    return lib


@pytest.fixture(autouse=True)
def not_stuck(request):
    yield
    if 'lib' in request.fixturenames:
        stuck = request.getfixturevalue('lib').hq_host_stuck()
        assert not stuck, "an mbarrier wait never completed"


def test_stand_in_covers_tma_ring():
    """Every helper of ``csrc/tma_ring.cuh`` has a host version."""
    names = set(re.findall(r'__forceinline__\s+\w+\s+(\w+)\(',
                           (CSRC / 'tma_ring.cuh').read_text()))
    assert 'load' in names and 'bar_wait' in names
    for name in names - {'smem_addr'}:
        assert re.search(rf'\b{name}\(', TMA_HOST), name


def _inputs(rows, cols, seed):
    x = np.random.default_rng(seed).standard_normal(
        (rows, cols)).astype(np.float32)
    return x, np.full_like(x, np.nan)


def _launch(lib):
    """grid.x, block.x, dynamic shared bytes and grid.y of the last
    launch."""
    return tuple(lib.hq_host_last_launch(w) for w in range(4))


# (rows, cols, tile_rows): chunks of 512 vectors cut at tile ends; the
# grid is chunks of a tile by tiles
TILE_CASES = [
    (250, 64, 100),    # 1600 vectors a tile: three full chunks and a part
    (24, 1024, 8),     # tiles of exactly four chunks
    (5, 4, 1),         # one vector a tile
    (7, 32, 50),       # a tile longer than the array
    (300, 56, 300),    # one tile, the last chunk partial
]


@pytest.mark.parametrize('rows, cols, tile_rows', TILE_CASES)
@pytest.mark.parametrize('inplace', [False, True], ids=['out', 'inplace'])
def test_tiles_match_twice(lib, rows, cols, tile_rows, inplace):
    x, out = _inputs(rows, cols, rows + cols)
    want = 2 * x
    if inplace:
        assert lib.hq_scale_inplace(x.ctypes.data, rows, cols, tile_rows,
                                    None) == 0
        got = x
    else:
        assert lib.hq_scale(x.ctypes.data, out.ctypes.data, rows, cols,
                            tile_rows, None) == 0
        got = out
    np.testing.assert_array_equal(got, want)
    tile4 = min(tile_rows, rows) * cols // 4
    n_tiles = -(-rows * cols // 4 // tile4)
    assert _launch(lib) == (-(-tile4 // CHUNK4), CHUNK4, 0, n_tiles)


def _ring_smem(ring):
    """Dynamic shared memory of a ring launch: the stages, padded so that
    an SM (228 KiB, 1 KiB reserved a block, 128 B of mbarriers) holds only
    the blocks that keep 64 KiB of loads in flight."""
    per_sm = IN_FLIGHT // ring if ring < IN_FLIGHT else 1
    return max(ring, min(233472 // per_sm - 1024 - 128, MAX_RING_BYTES))


# (rows, cols, chunk_rows, nbuf): each block fills its nbuf stages once
RING_CASES = [
    *[(100, 64, 3, nbuf) for nbuf in range(2, 9)],  # 34 units, the last
                                                    # partial
    (64, 1024, 4, 2),      # 16 KiB stages, 8 blocks, 2 an SM
    (33, 256, 8, 4),       # a last block of one partial stage
    (83, 1024, 16, 2),     # 64 KiB stages, one block an SM
    (131, 1024, 18, 3),    # 72 KiB stages, 216 KiB a block
    (5, 4, 1, 8),          # 16 bytes a stage, five of eight stages
]


@pytest.mark.parametrize('rows, cols, chunk_rows, nbuf', RING_CASES)
def test_ring_matches_twice(lib, rows, cols, chunk_rows, nbuf):
    x, out = _inputs(rows, cols, rows * nbuf)
    assert lib.hq_scale_pipelined(x.ctypes.data, out.ctypes.data, rows, cols,
                                  chunk_rows, nbuf, None) == 0
    np.testing.assert_array_equal(out, 2 * x)
    blocks = -(-(-(-rows // chunk_rows)) // nbuf)
    smem = _ring_smem(nbuf * chunk_rows * cols * 4)
    assert _launch(lib) == (blocks, RING_THREADS, smem, 1)


@pytest.mark.parametrize('call', [
    lambda lib, x, o: lib.hq_scale(x, o, 8, 6, 1, None),
    lambda lib, x, o: lib.hq_scale(x, o, 8, 8, 0, None),
    lambda lib, x, o: lib.hq_scale_inplace(x, -1, 8, 1, None),
    lambda lib, x, o: lib.hq_scale_pipelined(x, o, 8, 8, 1, 1, None),
    lambda lib, x, o: lib.hq_scale_pipelined(x, o, 8, 8, 1, 9, None),
    lambda lib, x, o: lib.hq_scale_pipelined(x, o, 8, 8, 0, 2, None),
    lambda lib, x, o: lib.hq_scale_pipelined(x, o, 64, 1024, 32, 2, None),
], ids=['cols', 'tile', 'rows', 'nbuf1', 'nbuf9', 'chunk', 'ring'])
def test_rejects_bad_arguments(lib, call):
    """An error code, and nothing written."""
    x, out = _inputs(64, 1024, 0)
    assert call(lib, x.ctypes.data, out.ctypes.data) != 0
    assert np.isnan(out).all()
