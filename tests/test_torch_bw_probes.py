"""``hybridq_tpu_torch.probes.bw`` against ``scripts/probe_pallas_bw.py``.

The script is imported by path; its module globals are cut from
``[2^19, 1024]`` to ``[R, C]`` and every variant is rebuilt from its
factory with the block rows ``S`` cut by ``SHRINK`` (``mk_manual`` reads
``R`` when it is built).  The Pallas kernels run in TPU interpret mode on
the CPU, where the port's wrappers run their plain versions.  Tolerance:
exact for the copies (doubling is exact); the dot within 1e-5 of
``dot_plain`` and of float64 (interpret mode computes it in f32).  The CUDA
kernels are held against the plain versions in ``test_torch_cuda.py``.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from hybridq_tpu_torch.probes import bw

ROOT = Path(__file__).resolve().parents[1]
R, C = 128, 256
SHRINK = 16
DOT_TOL = 1e-5


def load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / 'scripts' / f'{name}.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope='module')
def script():
    mod = load_script('probe_pallas_bw')
    mod.R, mod.C = R, C
    mod.NBYTES = R * C * 4
    return mod


def pallas_variant(script, v):
    """The script's factory for variant ``v``, at the cut size."""
    s = v.S // SHRINK
    return {'library': lambda: script.mk_xla_copy(),
            'auto': lambda: script.mk_auto(s),
            'aliased': lambda: script.mk_auto_aliased(s),
            'manual': lambda: script.mk_manual(s, nbuf=v.nbuf)}[v.kind]()


@pytest.mark.parametrize('i', range(len(bw.VARIANTS)))
def test_variant_matches_pallas(i, script):
    v = bw.VARIANTS[i]
    assert v.name == script.VARIANTS[i][0]
    x = np.random.default_rng(i).standard_normal((R, C)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pallas_variant(script, v)(jnp.asarray(x)))
    bw.reset_counts()
    got = bw.run_variant(v, torch.from_numpy(x.copy()))
    assert not any(bw.counts().values())
    np.testing.assert_array_equal(got.numpy(), want)


def test_card_mapping_fits_shared_memory():
    for v in bw.VARIANTS:
        if v.kind == 'manual':
            assert v.nbuf * v.rows * bw.C * 4 <= bw.MAX_RING_BYTES
            assert v.S // v.rows == 64
            assert f'{v.rows} rows' in bw.describe(v)
        elif v.kind in ('auto', 'aliased'):
            assert v.rows == v.S


def test_default_dot_matches_pallas():
    """The script's ``dk`` (l.202-204) rebuilt as its ``pallas_call``
    (l.210-215), on its seeded inputs."""
    def dk(a_ref, b_ref, o_ref):
        o_ref[:] = jnp.dot(a_ref[:], b_ref[:],
                           preferred_element_type=jnp.float32)

    a, b = bw.dot_inputs()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pl.pallas_call(
            dk, out_shape=jax.ShapeDtypeStruct((128, 128), jnp.float32),
            in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        )(jnp.asarray(a), jnp.asarray(b)))
    plain = bw.dot_plain(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    got = bw.dot(torch.from_numpy(a), torch.from_numpy(b), 'tf32').numpy()
    np.testing.assert_array_equal(got, plain)
    assert np.abs(want - plain).max() / np.abs(plain).max() <= DOT_TOL
    assert bw.rel_err(want, a, b) <= DOT_TOL
    assert bw.rel_err(plain, a, b) <= DOT_TOL


def test_scale_writes_into_out():
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    out = torch.empty_like(x)
    assert bw.scale(x, 3, out=out) is out
    assert torch.equal(out, 2 * x)
    out = torch.empty_like(x)
    assert bw.scale_pipelined(x, 2, 4, out=out) is out
    assert torch.equal(out, 2 * x)
    y = x.clone()
    assert bw.scale_(y, 3) is y
    assert torch.equal(y, 2 * x)
    for v in bw.VARIANTS:
        if v.kind != 'aliased':
            out = torch.empty_like(x)
            assert bw.run_variant(v, x, out=out) is out
            assert torch.equal(out, 2 * x)


@pytest.mark.parametrize('call, match', [
    (lambda: bw.scale(torch.zeros(8, 8, dtype=torch.float64), 1), 'float32'),
    (lambda: bw.scale(torch.zeros(8, 16).t(), 1), 'contiguous'),
    (lambda: bw.scale(torch.zeros(8, 6), 1), 'multiple of 4'),
    (lambda: bw.scale(torch.zeros(8, 8), 0), 'tile_rows'),
    (lambda: bw.scale_(torch.zeros(8, 8), 1.5), 'tile_rows'),
    (lambda: bw.scale(torch.zeros(8, 8), 1, out=torch.zeros(4, 8)),
     'like x'),
    (lambda: (lambda x: bw.scale(x, 1, out=x))(torch.zeros(8, 8)),
     'overlap'),
    (lambda: bw.scale_pipelined(torch.zeros(8, 8), 0), 'chunk_rows'),
    (lambda: bw.scale_pipelined(torch.zeros(8, 8), 1, nbuf=1), 'nbuf'),
    (lambda: bw.scale_pipelined(torch.zeros(8, 8), 1, nbuf=9), 'nbuf'),
    (lambda: bw.scale_pipelined(torch.zeros(64, 1024), 32, nbuf=2),
     'shared memory'),
    (lambda: (lambda x: bw.scale_pipelined(x, 1, out=x[2:6]))(
        torch.zeros(8, 8)), 'like x'),
    (lambda: (lambda x: bw.scale_pipelined(x[:4], 1, out=x[2:6]))(
        torch.zeros(8, 8)), 'overlap'),
    (lambda: bw.run_variant(bw.VARIANTS[4], torch.zeros(8, 8),
                            out=torch.zeros(8, 8)), 'in place'),
    (lambda: bw.dot(torch.zeros(64, 128), torch.zeros(128, 128)), '128x128'),
    (lambda: bw.dot(torch.zeros(128, 128), torch.zeros(128, 128),
                    'bf16'), 'precision'),
])
def test_rejects_bad_arguments(call, match):
    with pytest.raises(ValueError, match=match):
        call()


def test_main_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert bw.main() != 0
    assert capsys.readouterr().out == ''
