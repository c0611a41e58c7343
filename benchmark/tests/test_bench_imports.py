"""Nothing under benchmark/ imports JAX or the JAX package, and the plain
reference imports nothing of the program: top-level module names compared
as whole names."""

import ast
import os
import subprocess
import sys

import pytest

import _small

FORBIDDEN = {'jax', 'jaxlib', 'flax', 'hybridq_tpu'}
REFERENCE = os.path.join(_small.HERE, 'reference')


def sources():
    for d, _, files in os.walk(_small.HERE):
        for f in files:
            if f.endswith('.py'):
                yield os.path.join(d, f)


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split('.')[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split('.')[0])
    return names


@pytest.mark.parametrize('path', sorted(sources()),
                         ids=lambda p: os.path.relpath(p, _small.HERE))
def test_no_jax_in_sources(path):
    names = top_level_imports(path)
    assert not names & FORBIDDEN
    if path.startswith(REFERENCE + os.sep):
        assert 'hybridq_tpu_torch' not in names
        assert names <= {'__future__', 'contextlib', 'dataclasses', 'numpy',
                         'pickle', 'torch', 'reference'}


def run_python(code):
    out = subprocess.run([sys.executable, '-c', code], cwd=_small.ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=''))
    assert out.returncode == 0, out.stderr
    return out.stdout.split()


def test_a_run_loads_no_jax():
    code = (
        "import sys; sys.path[:0] = ['benchmark/tests', 'benchmark', '.']\n"
        "import _small, run\n"
        "_small.run(_small.SV_CELL, *_small.small_sv(6, 3), trace=True)\n"
        "assert 'hybridq_tpu_torch' in sys.modules\n"
        "print(*run.forbidden_modules())\n")
    assert run_python(code) == []


def test_the_reference_loads_nothing_of_the_program():
    code = (
        "import sys; sys.path[:0] = ['benchmark']\n"
        "from reference import statevector, tensornet\n"
        "tensornet.load_plan('benchmark/data/syc53_d12_s0_t26.pkl')\n"
        "print(*sorted({m.split('.')[0] for m in sys.modules}\n"
        "              & {'jax', 'jaxlib', 'flax', 'hybridq_tpu',\n"
        "                 'hybridq_tpu_torch'}))\n")
    assert run_python(code) == []


def test_names_are_compared_whole(monkeypatch):
    import run

    for name in ('hybridq_tpu_torch', 'jaxtyping', 'flaxen'):
        monkeypatch.setitem(sys.modules, name, sys)
    assert not set(run.forbidden_modules()) & {'jaxtyping', 'flaxen'}
    monkeypatch.setitem(sys.modules, 'jax.numpy', sys)
    assert 'jax' in run.forbidden_modules()
