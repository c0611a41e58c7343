"""``csrc/tn_apply.cu`` itself, compiled for the host and checked there.

The source is compiled with ``g++ -std=c++20`` against the stand-in
``cuda_runtime.h`` of ``test_torch_group_apply_host`` (``SHIM``: a
``std::thread`` for every CUDA thread, a ``std::barrier`` for
``__syncthreads``, ``__shared__`` as ``static``, the blocks of a launch one
after another; here also for blocks of fewer than 32 threads) and a
``double2`` beside its ``float2``; each
``<<<...>>>`` launch becomes a plain call and the dynamic shared memory a
static buffer.  ``hq_tn_apply`` is called through ctypes on numpy arrays
and held against ``tn_kernels.tn_apply_plain`` on the CPU, max|d|/rms <=
1e-5 in complex64 (f32 sums in another order) and 1e-12 in complex128,
for every s = 0..7 and f = 0..7 with the summed legs anywhere (bits 0-2
included), the operator's legs in any order, either operand batched or
both, and the square steps in place; each case also checks the launch
(blocks of one batch entry where the operator is batched, 32-column tiles
from s = 6).  Since blocks run in order, a block that wrote where a later
block reads would show up as a wrong value.  Skipped where ``g++`` is
missing.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from hybridq_tpu_torch.simulation.tn import tn_kernels as tk
from tests.test_torch_group_apply_host import CSRC, SHIM, host_source

SRC = CSRC / 'tn_apply.cu'
TOL = {np.complex64: 1e-5, np.complex128: 1e-12}
COLUMN_S = 5               # tn_column_kernel takes s <= 5
TILE_COLS = 32             # tn_tile_kernel: 32 columns a tile
EXTRA = r'''
struct __attribute__((aligned(16))) double2 { double x, y; };
'''


@pytest.fixture(scope='module')
def tn_host(tmp_path_factory):
    """``hq_tn_apply`` built for the host, and the shim's record of the
    last launch."""
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip("needs g++ to compile csrc/tn_apply.cu for the host")
    d = tmp_path_factory.mktemp('tn_apply_host')
    # blocks of fewer than 32 threads (one batch entry's columns) still
    # get the warp scratch that every shim thread leaves through
    shim = SHIM.replace('new hq_warp[nt / 32]', 'new hq_warp[(nt + 31) / 32]')
    assert shim != SHIM
    (d / 'cuda_runtime.h').write_text(shim + EXTRA)
    (d / 'tn_apply.cc').write_text(
        host_source(SRC.read_text(), launches=2, dyn_arrays=2))
    so = d / 'libtn_apply_host.so'
    subprocess.run([gxx, '-std=c++20', '-O1', '-shared', '-fPIC', '-pthread',
                    '-fno-strict-aliasing', '-I', str(d), '-I', str(CSRC),
                    '-o', str(so), str(d / 'tn_apply.cc')], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(so))
    fn = lib.hq_tn_apply
    P = ctypes.c_void_p
    fn.argtypes = [P, P, P, ctypes.c_longlong, P, ctypes.c_int, P]
    fn.restype = ctypes.c_int
    last = lib.hq_host_last_launch
    last.argtypes, last.restype = [ctypes.c_int], ctypes.c_longlong
    return fn, last


def _case(rng, s, f, nx, xb, ob, dtype, batch=2):
    xbits = [int(b) for b in rng.permutation(nx)[:s]]
    perm = [int(b) for b in rng.permutation(s + f)]
    step = tk.TnStep(nx, xbits, f, perm[:f], perm[f:], xb, ob)

    def rand(shape):
        return np.asarray(rng.standard_normal(shape) +
                          1j * rng.standard_normal(shape), dtype=dtype)

    x = rand((batch,) * xb + (2,) * nx)
    op = rand((batch,) * ob + (2,) * (s + f))
    return step, x, op


def _expect_launch(launch, step, batch):
    """s <= 5: blocks of 256 columns, or of one batch entry's columns
    where the operator is batched and has fewer; s = 6, 7: one block of
    256 threads a 32-column tile."""
    cols = 2 ** (step.nx - step.s)
    b = batch if step.batched else 1
    if step.s <= COLUMN_S:
        threads = cols if step.op_batched and cols < 256 else 256
        assert launch['block'] == threads
        assert launch['grid'] == -(-b * cols // threads)
    else:
        assert launch['block'] == 256
        assert launch['grid'] == b * -(-cols // TILE_COLS)


def _run(tn_host, step, x, op, inplace, batch=2):
    fn, last = tn_host
    shape = ((batch,) if step.batched else ()) + (2,) * step.ny
    y = x if inplace else np.full(shape, np.nan, dtype=x.dtype)
    err = fn(x.ctypes.data, y.ctypes.data, op.ctypes.data,
             batch if step.batched else 1, step._desc_ptr,
             int(x.dtype == np.complex128), None)
    assert err == 0
    _expect_launch({'grid': last(0), 'block': last(1)}, step, batch)
    return y


def _rel(got, want):
    want = np.asarray(want)
    rms = np.sqrt(np.mean(np.abs(want) ** 2))
    return np.abs(got - want).max() / rms


# (s, f, nx): every s and f, nx from s (no untouched leg) to 10
CASES = [(s, f, nx) for s in range(8) for f in range(8)
         for nx in sorted({s, min(s + 3, 10)})
         if (s + f) % 3 == 0 or nx == s or s >= 6 or f >= 6]


@pytest.mark.parametrize('dtype', [np.complex64, np.complex128])
@pytest.mark.parametrize('s, f, nx', CASES)
def test_tn_apply_host_against_plain(tn_host, s, f, nx, dtype):
    rng = np.random.default_rng(100 * s + 10 * f + nx)
    for xb, ob in ((1, 0), (0, 1), (1, 1), (0, 0)):
        step, x, op = _case(rng, s, f, nx, xb, ob, dtype)
        want = tk.tn_apply_plain(torch.from_numpy(x), torch.from_numpy(op),
                                 step).numpy()
        got = _run(tn_host, step, x, op, inplace=False)
        assert got.shape == want.shape
        assert _rel(got, want) <= TOL[dtype], (xb, ob)
        if f == s and xb:
            got = _run(tn_host, step, x.copy(), op, inplace=True)
            assert _rel(got, want) <= TOL[dtype], ('in place', ob)


def test_tn_apply_host_wide_columns(tn_host):
    """Columns past one block (and past one tile, the last tile partial
    nowhere): 2^9 columns of s = 2 and s = 6 steps, legs 0-2 summed."""
    rng = np.random.default_rng(7)
    for s, f in ((2, 2), (2, 3), (6, 6), (6, 7)):
        nx = s + 9
        step = tk.TnStep(nx, [0, 2] + list(range(5, 5 + s - 2)), f,
                         x_batched=True)
        x = (rng.standard_normal((2,) + (2,) * nx) +
             1j * rng.standard_normal((2,) + (2,) * nx)).astype(np.complex64)
        op = (rng.standard_normal((2,) * (s + f)) +
              1j * rng.standard_normal((2,) * (s + f))).astype(np.complex64)
        want = tk.tn_apply_plain(torch.from_numpy(x), torch.from_numpy(op),
                                 step).numpy()
        got = _run(tn_host, step, x, op, inplace=False)
        assert _rel(got, want) <= TOL[np.complex64], (s, f)


def test_tn_apply_host_refuses_bad_steps(tn_host):
    """Bits out of range, repeated or shared by the operator's two sides:
    cudaErrorInvalidValue, nothing launched."""
    fn, _ = tn_host
    x = np.zeros(2 ** 4, dtype=np.complex64)
    step = tk.TnStep(4, [1, 0], 2)
    for field, value in (('xbits', (1, 1)), ('xbits', (4, 0)),
                         ('ocol', (3, 0)), ('ybits', (0, 0))):
        desc = tk._Desc.from_buffer_copy(step.desc)
        setattr(desc, field, (ctypes.c_int * tk.MAX_LEGS)(*value))
        assert fn(x.ctypes.data, x.ctypes.data, x.ctypes.data, 1,
                  ctypes.addressof(desc), 0, None) == 1, field
