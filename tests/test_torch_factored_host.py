"""``csrc/factored_apply.cu`` itself, compiled for the host and checked there.

The source is compiled with ``g++ -std=c++20`` against the stand-in for
``cuda_runtime.h`` of ``test_torch_group_apply_host`` (``SHIM``: a
``std::thread`` per CUDA thread, ``std::barrier`` for ``__syncthreads``,
blocks one after another, ``mma.sync`` m16n8k8 TF32 as a warp collective,
``cp.async`` as a plain copy, the SM count that sizes the persistent grid
set per case), with a count of launches added.  ``hq_factored_apply`` is
called through ctypes on numpy arrays: re and im lie in one buffer
between guards of NaN, so a read outside them poisons the result and a
write outside them shows in the guards.  Each result is held against
``fused_kernels.apply_factored_plain`` (max|d|/rms <= 1e-5: f32 sums in
another order and, for factors of k >= 5, 3xTF32 products), with the
route's launches, grid and shared memory:

  * ``column_kernel<KR, KL>`` (kr + kl <= 4) on every factor pair, and
    ``warp_tile_kernel<KR, KL>`` (the same where a lane gate bit cuts the
    128-byte line) on every pair of kr <= 2, both on the chip's bit sets
    (``chip_smoke.FACTORED_CASES``, its row bits moved below n = 14-16)
    but the largest;
  * ``tile_kernel`` on the largest (kr = 9, kl = 7: two launches), on one
    launch with row steps of k = 5, 6 and lane steps of k = 5..7 (the
    tensor cores) or k <= 4 (the CUDA cores), on the two-launch route at
    kr = 7, 8, and on states smaller than a tile (masked columns).

``tile_phys``, the swizzle of the tile in shared memory, is called through
an exported wrapper and checked on a model of the warp accesses the tile
route makes (``_warp_accesses``): every one hits 32 distinct banks (a
float2 access: 16 distinct bank pairs a half warp; a 16-byte one: 8
distinct chunks a quarter warp), at the largest chip bit set and at every
row step of k = 5..9, and so do the warp tiles' column reads at the chip's
lane bits 6-3 (``_warp_tile_reads``).  The column kernel keeps the state
in registers and touches no shared memory for it.  Skipped where ``g++``
is missing.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from hybridq_tpu_torch.simulation import fused_kernels as fk
from tests.test_torch_group_apply_host import CSRC, SHIM, host_source

SRC = CSRC / 'factored_apply.cu'
TOL = 1e-5
THREADS = 256
LOG_TILE = 13
TILE_SMEM = 2 * 2 * 2 ** LOG_TILE * 4 + 2 * 512 * 8 + 2 * (512 + 256) * 4

COUNTED_SHIM = SHIM.replace('  hq_last = c;\n',
                            '  hq_last = c;\n  ++hq_launches;\n')
COUNTED_SHIM = COUNTED_SHIM.replace(
    'inline hq_config hq_last;',
    'inline hq_config hq_last;\ninline int hq_launches = 0;\n'
    'extern "C" int hq_host_launches() { return hq_launches; }')
EXPORT = '\nextern "C" int hq_host_tile_phys(int i) { return tile_phys(i); }\n'
# the source's zero-accumulator mma.sync, from the shim's warp collective,
# and __syncwarp as the warp's barrier
ZERO_MMA = r'''
inline void mma_tf32_zero(float* d, const uint32_t* a, const uint32_t* b) {
  for (int i = 0; i < 4; ++i) d[i] = 0.f;
  mma_tf32(d, a, b);
}
inline void __syncwarp(unsigned = 0xffffffffu) {
  hq_my_warp->bar.arrive_and_wait();
}
'''


@pytest.fixture(scope='module')
def lib(tmp_path_factory):
    """``csrc/factored_apply.cu`` built for the host."""
    assert COUNTED_SHIM.count('++hq_launches') == 1
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip("needs g++ to compile csrc/factored_apply.cu for the "
                    "host")
    d = tmp_path_factory.mktemp('factored_host')
    (d / 'cuda_runtime.h').write_text(COUNTED_SHIM + ZERO_MMA)
    (d / 'factored_apply.cc').write_text(
        host_source(SRC.read_text(), launches=2, dyn_arrays=1) + EXPORT)
    so = d / 'libfactored_apply_host.so'
    subprocess.run([gxx, '-std=c++20', '-O1', '-shared', '-fPIC', '-pthread',
                    '-fno-strict-aliasing', '-I', str(d), '-I', str(CSRC),
                    '-o', str(so), str(d / 'factored_apply.cc')], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(so))
    P, I, IP = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    lib.hq_factored_apply.argtypes = [P, P, I, P, I, IP, P, I, IP, P]
    lib.hq_factored_apply.restype = I
    lib.hq_host_last_launch.argtypes = [I]
    lib.hq_host_last_launch.restype = ctypes.c_longlong
    lib.hq_host_set_sms.argtypes = [I]
    lib.hq_host_tile_phys.argtypes = [I]
    lib.hq_host_tile_phys.restype = I
    return lib


def _rand_u(k, rng):
    m = rng.standard_normal((2**k, 2**k)) + \
        1j * rng.standard_normal((2**k, 2**k))
    return np.linalg.qr(m)[0].astype(np.complex64)


GUARD = 64                 # NaN floats before re, between re and im, after


def _ints(v, size):
    return (ctypes.c_int * size)(*v)


def _apply(lib, n, row_bits, lane_bits, seed, sms=2):
    """``hq_factored_apply`` on a random unit-norm state; returns (got,
    want, launches, last launch)."""
    rng = np.random.default_rng(seed)
    kr, kl = len(row_bits), len(lane_bits)
    Ur = _rand_u(kr, rng) if kr else np.ones((1, 1), np.complex64)
    Ul = _rand_u(kl, rng)
    st = rng.standard_normal(2 ** (n + 1)).astype(np.float32)
    st /= np.linalg.norm(st)
    want = fk.apply_factored_plain(torch.from_numpy(st.copy()), Ur, row_bits,
                                   Ul, lane_bits).numpy()
    N = 2 ** n
    buf = np.full(3 * GUARD + 2 * N, np.nan, dtype=np.float32)
    re = buf[GUARD:GUARD + N]
    im = buf[2 * GUARD + N:2 * GUARD + 2 * N]
    re[:], im[:] = st[:N], st[N:]
    lib.hq_host_set_sms(sms)
    before = lib.hq_host_launches()
    err = lib.hq_factored_apply(re.ctypes.data, im.ctypes.data, n,
                                Ur.ctypes.data, kr, _ints(row_bits, 9),
                                Ul.ctypes.data, kl, _ints(lane_bits, 7), None)
    assert err == 0
    guards = np.concatenate([buf[:GUARD], buf[GUARD + N:2 * GUARD + N],
                             buf[2 * GUARD + 2 * N:]])
    assert np.isnan(guards).all(), "a write outside re and im"
    launch = {'grid': lib.hq_host_last_launch(0),
              'block': lib.hq_host_last_launch(1),
              'smem': lib.hq_host_last_launch(2)}
    return (np.concatenate([re, im]), want, lib.hq_host_launches() - before,
            launch)


def _rel_err(got, want):
    rms = np.sqrt(np.mean(want.astype(np.float64) ** 2))
    return np.abs(got.astype(np.float64) - want).max() / rms


def _expect(n, row_bits, lane_bits, launches, launch, sms=2):
    """kr + kl <= 4: one launch, no dynamic shared memory; warp tiles (8 a
    block of 2^(n - 12), at least one) where a lane gate bit is below 5,
    kr <= 2 and n >= 9, else one joint group a thread (2^(n - k - 8)
    blocks, at least one).  Tile route: one launch (two for kr >= 7) of
    min(tiles, SMs) persistent blocks with the fixed dynamic shared memory
    of two stages and their tables."""
    kr, kl = len(row_bits), len(lane_bits)
    if kr + kl <= 4:
        tiled = min(lane_bits) < 5 and kr <= 2 and n >= 9
        grid = n - 12 if tiled else n - kr - kl - 8
        assert launches == 1
        assert launch == {'grid': 2 ** max(0, grid), 'block': THREADS,
                          'smem': 0}
    else:
        assert launches == (2 if kr > min(n - 7, 6) else 1)
        tiles = 2 ** max(0, n - LOG_TILE)
        assert launch == {'grid': min(tiles, sms), 'block': THREADS,
                          'smem': TILE_SMEM}


# chip_smoke.FACTORED_CASES with the row bits moved below n: the same
# factor sizes, lane bits and order of row bits
CHIP_CASES = [
    (14, (), (6, 5, 4, 3)), (14, (13, 9), (6, 5)), (16, (15, 12), (6, 5)),
    (16, (15, 9), (4, 2)), (14, (), (6, 3, 0)), (15, (14, 13), (5,)),
    (16, (9, 15), (2, 4)),
    (16, (15, 14, 13, 12, 11, 10, 9, 8, 7), (6, 5, 4, 3, 2, 1, 0)),
]


@pytest.mark.parametrize('n, row_bits, lane_bits', CHIP_CASES)
def test_chip_bit_sets_match_plain(lib, n, row_bits, lane_bits):
    got, want, launches, launch = _apply(lib, n, row_bits, lane_bits,
                                         seed=n + len(row_bits))
    _expect(n, row_bits, lane_bits, launches, launch)
    assert _rel_err(got, want) <= TOL


# every (kr, kl) with kr + kl <= 4, at random row bits, with n from below
# one block (n = k + 1: all but two threads masked) to four blocks; lane
# bits 6, 5 where kl <= 2 (one joint group a thread), else at random
COLUMN_PAIRS = [(kr, kl) for kl in range(1, 5) for kr in range(0, 5 - kl)]


@pytest.mark.parametrize('kr, kl', COLUMN_PAIRS)
@pytest.mark.parametrize('extra', [1, 10])
def test_column_route_every_pair(lib, kr, kl, extra):
    n = max(7 + kr, kr + kl + extra)
    rng = np.random.default_rng([kr, kl, extra])
    row_bits = [int(b) for b in rng.choice(range(7, n), kr, replace=False)]
    lane_bits = [6, 5][:kl] if kl <= 2 else \
        [int(b) for b in rng.choice(7, kl, replace=False)]
    got, want, launches, launch = _apply(lib, n, row_bits, lane_bits,
                                         seed=extra)
    _expect(n, row_bits, lane_bits, launches, launch)
    assert _rel_err(got, want) <= TOL


# every (kr <= 2, kl) of the warp tiles, a lane gate bit below 5, at
# n = 9 (one block, half its warps masked) and 13 (two blocks)
WARP_PAIRS = [(kr, kl) for kr, kl in COLUMN_PAIRS if kr <= 2]


@pytest.mark.parametrize('kr, kl', WARP_PAIRS)
@pytest.mark.parametrize('n', [9, 13])
def test_warp_tiles_every_pair(lib, kr, kl, n):
    rng = np.random.default_rng([kr, kl, n])
    row_bits = [int(b) for b in rng.choice(range(7, n), kr, replace=False)]
    low = int(rng.integers(0, 5))
    lane_bits = [low] + [int(b) for b in rng.choice(
        [b for b in range(7) if b != low], kl - 1, replace=False)]
    rng.shuffle(lane_bits)
    got, want, launches, launch = _apply(lib, n, row_bits, lane_bits,
                                         seed=n + kl)
    _expect(n, row_bits, lane_bits, launches, launch)
    assert launch['grid'] == 2 ** max(0, n - 12)
    assert _rel_err(got, want) <= TOL


# (n, row_bits, lane_bits, SMs) of the tile route: one launch with a row
# step on the tensor cores (kr = 5, 6) and lane steps on either, lane bits
# in any order; the CUDA cores for both (kr + kl >= 5, both <= 4); two
# launches at kr = 7, 8; one persistent block walking four tiles; states
# smaller than a tile (columns of a step masked)
TILE_CASES = [
    (15, (14, 8, 12, 10, 9), (3, 1), 2),
    (14, (7, 13, 9, 11, 8, 10), (0, 6, 2), 2),
    (15, (9, 12), (2, 5, 0, 6, 3), 2),
    (14, (), (1, 4, 6, 0, 3, 5), 2),
    (14, (10, 7, 13), (6, 5, 4, 3, 2, 1, 0), 1),
    (15, (12, 8, 10), (5, 2), 2),
    (14, (11, 9, 13, 8), (6, 1, 3, 0), 2),
    (15, (14, 13, 12, 11, 10, 9, 8), (4,), 2),
    (15, (8, 14, 9, 13, 10, 12, 11, 7), (6, 0, 3), 2),
    (15, (9, 10, 11, 12, 13), (0,), 1),
    (9, (8, 7), (6, 5, 4, 3, 2, 1, 0), 2),
    (8, (), (0, 1, 2, 3, 4, 5, 6), 2),
    (12, (11, 7, 9, 8, 10), (2, 6), 2),
    (10, (9, 8), (4, 2, 0), 2),
]


@pytest.mark.parametrize('n, row_bits, lane_bits, sms', TILE_CASES)
def test_tile_route_matches_plain(lib, n, row_bits, lane_bits, sms):
    got, want, launches, launch = _apply(lib, n, row_bits, lane_bits,
                                         seed=n * 7 + len(lane_bits), sms=sms)
    _expect(n, row_bits, lane_bits, launches, launch, sms)
    assert _rel_err(got, want) <= TOL


@pytest.mark.parametrize('n, kr, kl', [
    (6, 0, 1), (44, 0, 1), (16, 10, 1), (16, 0, 0), (16, 0, 8), (16, -1, 1),
    (10, 4, 1),
])
def test_rejects_bad_arguments(lib, n, kr, kl):
    """n outside 7..43, kr outside 0..min(9, n - 7), kl outside 1..7: an
    error code, and nothing written."""
    st = np.full(2 ** 12, np.nan, dtype=np.float32)
    U = np.eye(2 ** 10, dtype=np.complex64)
    before = lib.hq_host_launches()
    assert lib.hq_factored_apply(st.ctypes.data, st.ctypes.data + 8192, n,
                                 U.ctypes.data, kr, _ints(range(7, 16), 9),
                                 U.ctypes.data, kl, _ints(range(7), 7),
                                 None) != 0
    assert lib.hq_host_launches() == before
    assert np.isnan(st).all()


# -- the swizzle -----------------------------------------------------------

def _deposit(r, sorted_bits):
    for b in sorted_bits:
        r = ((r >> b) << (b + 1)) | (r & ((1 << b) - 1))
    return r


def _gate_offset(j, sb):
    k = len(sb)
    return sum(1 << b for i, b in enumerate(sb) if (j >> (k - 1 - i)) & 1)


def _warp_accesses(log_tile, sb):
    """The shared-memory accesses of ``mma_step`` on a tile of 2^log_tile
    amplitudes for a step on tile bits ``sb`` (MSB of U first): yields
    (kind, [tile index of each lane]) for every B-fragment load and C-
    fragment store of every warp (kind 'b32', 'c32' or 'c64')."""
    k = len(sb)
    M, N = 2 ** k, 2 ** (log_tile - k)
    ct_n = 2 if k == 9 else 4
    rt_n = 8 // ct_n
    WR, WC = 16 * rt_n, 8 * ct_n
    qoff = [_gate_offset(j, sb) for j in range(M)]
    srt = sorted(sb)
    coff = [_deposit(c, srt) for c in range(N)]
    pair = srt[0] != 0 and N >= 2
    nwc = max(1, N // WC)
    for warp in range(8):
        row0, col0 = (warp // nwc) * WR, (warp % nwc) * WC
        if row0 >= M:
            continue
        for j0 in range(0, M, 8):
            for ct in range(ct_n):
                for h in range(2):
                    idx = [qoff[j0 + (ln & 3) + 4 * h] |
                           coff[col0 + 8 * ct + (ln >> 2)]
                           for ln in range(32)
                           if col0 + 8 * ct + (ln >> 2) < N]
                    yield 'b32', idx
        for rt in range(rt_n):
            for h in range(2):
                for ct in range(ct_n):
                    cols = [(ln, col0 + 8 * ct + 2 * (ln & 3))
                            for ln in range(32)]
                    rows = [qoff[row0 + 16 * rt + 8 * h + (ln >> 2)]
                            for ln in range(32)]
                    if pair:
                        yield 'c64', [rows[ln] | coff[c] for ln, c in cols
                                      if c < N]
                    else:
                        for e in range(2):
                            yield 'c32', [rows[ln] | coff[c + e]
                                          for ln, c in cols if c + e < N]


def _conflict_free(phys, kind, idx):
    addr = [phys[i] for i in idx]
    if kind == 'c64':       # 8-byte accesses: two phases of 16 lanes
        halves = [addr[:16], addr[16:]]
        return all(len({a // 2 % 16 for a in h}) == len(h) for h in halves)
    return len({a % 32 for a in addr}) == len(addr)


# (log_tile, step bits): the largest chip case's two launches (the lane
# step on all 7 lane bits of a [64, 128] tile, the row step of k = 9 on a
# [512, 16] tile), and the row steps of k = 5..8 on the tile's top bits
SWIZZLE_STEPS = [
    (13, (6, 5, 4, 3, 2, 1, 0)),
    (13, tuple(range(12, 3, -1))),
    (13, tuple(range(12, 4, -1))),
    (13, tuple(range(12, 5, -1))),
    (13, tuple(range(12, 6, -1))),
    (13, tuple(range(12, 7, -1))),
]


def _warp_tile_reads(row_bits_tile, lane_bits):
    """The warp tile's column reads: for each joint-group round s and gate
    combination j, the 9-bit tile index each lane reads."""
    gate = sorted(lane_bits) + sorted(row_bits_tile)
    k = len(gate)
    for s in range(2 ** (4 - k)):
        for j in range(2 ** k):
            off = sum(1 << b for i, b in enumerate(gate) if (j >> i) & 1)
            yield [_deposit(s * 32 + ln, gate) | off for ln in range(32)]


@pytest.mark.parametrize('lane_bits', [(6, 5, 4, 3), (5, 4, 3), (4, 3)])
def test_warp_tile_reads_conflict_free(lib, lane_bits):
    """Lane gate bits 3-6 (the lane-only chip case), 3-5 and 3-4: the warp
    varies tile bits 0-2 and two of bits 5-8."""
    phys = [lib.hq_host_tile_phys(i) for i in range(512)]
    for idx in _warp_tile_reads((), lane_bits):
        assert _conflict_free(phys, 'b32', idx), idx


@pytest.mark.parametrize('log_tile, sb', SWIZZLE_STEPS,
                         ids=lambda v: str(v))
def test_swizzle_conflict_free(lib, log_tile, sb):
    phys = [lib.hq_host_tile_phys(i) for i in range(2 ** log_tile)]
    n = 0
    for kind, idx in _warp_accesses(log_tile, sb):
        assert _conflict_free(phys, kind, idx), (kind, idx)
        n += 1
    assert n > 0


def test_swizzle_keeps_chunks_and_copies_conflict_free(lib):
    """``tile_phys`` is a permutation of the tile that keeps every 16-byte
    chunk whole, and each quarter warp of the 16-byte copies (8 consecutive
    chunks of the tile, whatever its rows' width) lands on 8 distinct
    chunk positions of the banks."""
    phys = np.array([lib.hq_host_tile_phys(i) for i in range(2 ** 13)])
    assert sorted(phys) == list(range(2 ** 13))
    assert (phys[1::4] == phys[0::4] + 1).all()
    assert (phys[0::4] % 4 == 0).all()
    for q0 in range(0, 2 ** 11, 8):
        chunks = phys[4 * np.arange(q0, q0 + 8)] // 4
        assert len(set(chunks % 8)) == 8
