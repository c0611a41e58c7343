"""``csrc/dot_probe.cu`` itself, compiled for the host and checked there.

The source is compiled with ``g++ -std=c++20`` against the stand-in for
``cuda_runtime.h`` of ``test_torch_group_apply_host`` (``SHIM``: a
``std::thread`` per CUDA thread, ``__syncthreads`` a barrier, ``mma.sync``
m16n8k8 as a warp collective on TF32 operands) and ``hq_dot128`` is
called through ctypes on numpy arrays, for both precisions, on the
probe scripts' operands (``bw.dot_inputs()``) and two other seeds.

Bands, all as max|d| / max|a b| against the product in float64:
3xTF32 within 1e-5, and within 1e-5 of ``dot_plain`` too; one TF32 pass
in [1e-5, 1e-2] (f32 accuracy would mean the operands were not rounded to
TF32), and within 1e-5 of the float64 product of the operands rounded to
TF32 as ``cvt.rna.tf32.f32`` rounds them (truncated operands miss it by
about 1e-4).  C starts as NaN, so an entry the kernel did not write
fails.  Skipped where ``g++`` is missing.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from hybridq_tpu_torch.probes import bw
from tests.test_torch_group_apply_host import CSRC, SHIM, host_source

SRC = CSRC / 'dot_probe.cu'
BANDS = {1: (1e-5, 1e-2), 3: (0.0, 1e-5)}
SEEDS = [(0, 1), (2, 3), (4, 5)]      # (0, 1): the scripts' operands


@pytest.fixture(scope='module')
def dot128(tmp_path_factory):
    """``hq_dot128`` of ``csrc/dot_probe.cu`` built for the host, and the
    shim's record of the last launch."""
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip("needs g++ to compile csrc/dot_probe.cu for the host")
    d = tmp_path_factory.mktemp('dot_host')
    (d / 'cuda_runtime.h').write_text(SHIM)
    (d / 'dot_probe.cc').write_text(
        host_source(SRC.read_text(), launches=2, dyn_arrays=0))
    so = d / 'libdot_probe_host.so'
    subprocess.run([gxx, '-std=c++20', '-O1', '-shared', '-fPIC', '-pthread',
                    '-fno-strict-aliasing', '-I', str(d), '-I', str(CSRC),
                    '-o', str(so), str(d / 'dot_probe.cc')], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(so))
    fn = lib.hq_dot128
    P = ctypes.c_void_p
    fn.argtypes = [P, P, P, ctypes.c_int, P]
    fn.restype = ctypes.c_int
    last = lib.hq_host_last_launch
    last.argtypes, last.restype = [ctypes.c_int], ctypes.c_longlong
    return fn, last


def tf32_round(x):
    """``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds: 10 mantissa
    bits, ties away from zero."""
    bits = (x.view(np.uint32) + np.uint32(0x1000)) & np.uint32(0xffffe000)
    return bits.view(np.float32)


def _nan_out():
    return np.full((bw.DOT_N, bw.DOT_N), np.nan, dtype=np.float32)


@pytest.mark.parametrize('seeds', SEEDS, ids=lambda s: f'seeds{s[0]}{s[1]}')
@pytest.mark.parametrize('passes', sorted(BANDS))
def test_dot_matches_float64(dot128, passes, seeds):
    fn, last = dot128
    a, b = bw.dot_inputs(seeds)
    c = _nan_out()
    assert fn(a.ctypes.data, b.ctypes.data, c.ctypes.data, passes, None) == 0
    assert last(0) > 1, "the product must be spread over many blocks"
    assert np.isfinite(c).all(), "an entry of C was not written"
    lo, hi = BANDS[passes]
    assert lo <= bw.rel_err(c, a, b) <= hi
    if passes == 1:
        assert bw.rel_err(c, tf32_round(a), tf32_round(b)) <= BANDS[3][1]
    else:
        plain = bw.dot_plain(torch.from_numpy(a), torch.from_numpy(b))
        want = np.abs(plain.numpy()).max()
        assert np.abs(c - plain.numpy()).max() / want <= BANDS[3][1]


@pytest.mark.parametrize('passes', [0, 2, 4])
def test_dot_rejects_other_passes(dot128, passes):
    """Any ``passes`` but 1 and 3: an error code and no launch."""
    fn, _ = dot128
    a, b = bw.dot_inputs()
    c = _nan_out()
    assert fn(a.ctypes.data, b.ctypes.data, c.ctypes.data, passes, None) != 0
    assert np.isnan(c).all()
