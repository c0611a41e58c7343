"""``hybridq_tpu_torch.probes.gather`` against
``scripts/probe_pallas_gather.py``.

The script is imported by path; its module globals are cut from
``[2^22, 128]`` to ``[SUB, 128]``, and every variant is rebuilt with its
step ``blk_sub`` cut by ``SHRINK`` and its run capped at the step (the
512 KB run of the script is its whole step).  The Pallas kernel runs in
TPU interpret mode on the CPU, where the port's wrapper runs its plain
version.  Tolerance: exact (doubling and bf16 rounding are exact; the
identity product in bf16 with f32 accumulation is bf16(x)); the
``Precision.HIGHEST`` dot within 1e-5 of ``dot_plain`` and of float64.
"""

import ast
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from hybridq_tpu_torch.probes import bw, gather

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / 'scripts' / 'probe_pallas_gather.py'
SUB = 512
SHRINK = 8
DOT_TOL = 1e-5


@pytest.fixture(scope='module')
def script():
    spec = importlib.util.spec_from_file_location('probe_pallas_gather',
                                                  SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.SUB = SUB
    mod.NBYTES = SUB * mod.LANE * 4
    return mod


def cut(v):
    blk = v.blk_rows // SHRINK
    return min(v.run_rows, blk), blk


@pytest.mark.parametrize('i', range(len(gather.VARIANTS)))
def test_variant_matches_pallas(i, script):
    v = gather.VARIANTS[i]
    name, _ = script.VARIANTS[i]
    assert v.name == name
    run, blk = cut(v)
    x = np.random.default_rng(i).standard_normal(
        (SUB, gather.LANE)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(script.mk_gather(run, blk, matmul=v.matmul,
                                           nbuf=v.nbuf)(jnp.asarray(x)))
    gather.reset_counts()
    t = torch.from_numpy(x.copy())
    assert gather.gather_scale_(t, run, blk, v.matmul, v.nbuf) is t
    assert gather.counts() == {'gather_scale': 0}
    np.testing.assert_array_equal(t.numpy(), want)


def script_src_of(nrt, runs_per_blk, run_sub):
    """``src_of`` of ``mk_gather`` (l.44-50), taken from the script's text
    and bound to the given sizes."""
    text = SCRIPT.read_text()
    fn = next(n for n in ast.walk(ast.parse(text))
              if isinstance(n, ast.FunctionDef) and n.name == 'src_of')
    env = {'jax': SimpleNamespace(lax=SimpleNamespace(rem=np.remainder)),
           'nrt': nrt, 'runs_per_blk': runs_per_blk, 'run_sub': run_sub}
    exec(ast.unparse(fn), env)
    return env['src_of']


@pytest.mark.parametrize('run', sorted({v.run_rows
                                        for v in gather.VARIANTS}))
def test_run_source_is_src_of(run):
    nrt = gather.SUB // run
    runs_per_blk = 1024 // run if run <= 1024 else 1
    src_of = script_src_of(nrt, runs_per_blk, run)
    r = np.arange(nrt, dtype=np.int64)
    want = src_of(r // runs_per_blk, r % runs_per_blk)
    got = gather.run_source(r, nrt)
    np.testing.assert_array_equal(got * run, want)
    np.testing.assert_array_equal(np.sort(got), r)
    assert gather.run_source(3, nrt) == got[3]


def test_card_mapping_fits_shared_memory():
    """Every variant's stages fit the ring's shared memory (the C entry
    point checks it for all); only the matmul variant runs on stages, of
    whole 128-row chunks, and ``describe`` names them."""
    for v in gather.VARIANTS:
        stage = gather.stage_rows(v.blk_rows, v.nbuf)
        assert v.nbuf * stage * gather.ROW_BYTES <= gather.RING_BYTES
        assert v.blk_rows % stage == 0
        if v.matmul:
            assert stage % gather.MATMUL_CHUNK == 0
            assert f'{v.nbuf} stages of {stage} rows' in gather.describe(v)
        else:
            assert f'blocks of {gather.BLOCK_ROWS} virtual rows' in \
                gather.describe(v)


def test_mapping_names_variants_that_launch_alike():
    """The doubling variants launch by run length alone, so the script's
    blk 2048 step runs the launch of its blk 1024 one and the x4buf ring
    that of its 4 KB one; ``describe`` says so of those four and of no
    other variant."""
    names = {v.name: v for v in gather.VARIANTS}
    pairs = [('run 16KB  (32 sub) blk 1024', 'run 16KB  blk 2048'),
             ('run 4KB   (8 sub)  blk 1024', 'run 4KB   blk 1024 x4buf')]
    for a, b in pairs:
        assert f'the same launch as {b}' in gather.describe(names[a])
        assert f'the same launch as {a}' in gather.describe(names[b])
    twins = {names[n] for pair in pairs for n in pair}
    for v in gather.VARIANTS:
        if v not in twins:
            assert 'the same launch' not in gather.describe(v)


def test_split3_bf16_matches_script():
    """The script's bf16x3 lines (l.220-229) on its seeded input."""
    x = np.random.default_rng(0).standard_normal(4096).astype('float32')
    xj = jnp.asarray(x)
    a0 = xj.astype(jnp.bfloat16).astype(jnp.float32)
    r1 = xj - a0
    a1 = r1.astype(jnp.bfloat16).astype(jnp.float32)
    r2 = r1 - a1
    a2 = r2.astype(jnp.bfloat16).astype(jnp.float32)
    want_err = float(jnp.max(jnp.abs(a0 + a1 + a2 - xj)))
    got = gather.split3_bf16(torch.from_numpy(x))
    for g, w in zip(got, (a0, a1, a2)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    err = (got[0] + got[1] + got[2] - torch.from_numpy(x)).abs().max()
    assert err.item() == want_err


def test_highest_dot_matches_pallas():
    """The script's ``dk`` (l.233-237) rebuilt as its ``pallas_call``
    (l.244-249), on its seeded inputs."""
    def dk(a_ref, b_ref, o_ref):
        o_ref[:] = jax.lax.dot_general(
            a_ref[:], b_ref[:], (((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32)

    a, b = bw.dot_inputs()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pl.pallas_call(
            dk, out_shape=jax.ShapeDtypeStruct((128, 128), jnp.float32),
            in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        )(jnp.asarray(a), jnp.asarray(b)))
    plain = bw.dot_plain(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    got = bw.dot(torch.from_numpy(a), torch.from_numpy(b), '3xtf32').numpy()
    np.testing.assert_array_equal(got, plain)
    assert np.abs(want - plain).max() / np.abs(plain).max() <= DOT_TOL
    assert bw.rel_err(want, a, b) <= DOT_TOL


@pytest.mark.parametrize('shape, args, match', [
    ((64, 64), (1, 64), r'\[rows, 128\]'),
    ((64, 128), (3, 64), 'powers of two'),
    ((64, 128), (8, 4), 'divide'),
    ((96, 128), (8, 64), 'divide'),
    ((384, 128), (128, 128), 'power of two'),
    ((256, 128), (8, 128, False, 1), 'nbuf'),
    ((256, 128), (8, 128, False, 9), 'nbuf'),
    ((256, 128), (8, 256, True, 4), 'matmul'),
])
def test_rejects_bad_arguments(shape, args, match):
    with pytest.raises(ValueError, match=match):
        gather.gather_scale_(torch.zeros(shape), *args)


def test_main_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert gather.main() != 0
    assert capsys.readouterr().out == ''
