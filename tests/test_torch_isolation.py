"""The port stands alone: ``hybridq_tpu_torch`` imports neither ``jax`` nor
``hybridq_tpu``, its entry point runs on the card unless the caller asks
for the CPU, and an installed copy ships every CUDA file its build reads."""

import ast
import fnmatch
import os
import re
import subprocess
import sys
import tomllib
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / 'hybridq_tpu_torch'
FORBIDDEN = ('jax', 'jaxlib', 'hybridq_tpu')


def _forbidden(module):
    return any(module == f or module.startswith(f + '.') for f in FORBIDDEN)


def test_no_forbidden_imports_in_source():
    """AST scan of every module of the package and of ``chip_smoke.py``,
    lazy imports included."""
    offenders = []
    files = sorted(PKG.rglob('*.py')) + [ROOT / 'chip_smoke.py']
    for name in ('fused_k4', 'bw', 'gather'):
        assert PKG / 'probes' / f'{name}.py' in files
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            offenders += [(path.name, m) for m in names if _forbidden(m)]
    assert not offenders, offenders


def test_import_leaves_jax_unloaded():
    code = ("import sys, hybridq_tpu_torch, hybridq_tpu_torch.convert, "
            "hybridq_tpu_torch.extras.random, "
            "hybridq_tpu_torch.simulation.fused_evolver, "
            "hybridq_tpu_torch.simulation.row_kernels, "
            "hybridq_tpu_torch.probes.fused_k4, "
            "hybridq_tpu_torch.probes.bw, hybridq_tpu_torch.probes.gather, "
            "hybridq_tpu_torch.simulation._build; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}); print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, '-c', code], cwd=str(ROOT),
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, (r.stdout, r.stderr)


def test_package_data_ships_every_cuda_source_and_header():
    """An installed copy builds from what ``package-data`` ships: every
    ``csrc`` file and every ``#include "..."`` of a source must match one
    of its globs, or nvcc fails there though it passes in the checkout."""
    with open(ROOT / 'pyproject.toml', 'rb') as f:
        globs = tomllib.load(f)['tool']['setuptools']['package-data'][
            'hybridq_tpu_torch']
    csrc = PKG / 'csrc'
    files = sorted(p for p in csrc.iterdir() if p.suffix in ('.cu', '.cuh'))
    assert {p.suffix for p in files} == {'.cu', '.cuh'}
    for path in files:
        rel = path.relative_to(PKG).as_posix()
        assert any(fnmatch.fnmatch(rel, g) for g in globs), (rel, globs)
        for inc in re.findall(r'^\s*#\s*include\s+"([^"]+)"',
                              path.read_text(), re.M):
            target = (csrc / inc).resolve()
            assert target.exists(), (path.name, inc)
            rel = target.relative_to(PKG).as_posix()
            assert any(fnmatch.fnmatch(rel, g) for g in globs), \
                (path.name, inc, globs)


def test_simulate_needs_a_card_unless_told(monkeypatch):
    from hybridq_tpu_torch import Gate
    from hybridq_tpu_torch.simulation import simulate

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    c = [Gate('H', qubits=[0]), Gate('CX', qubits=[0, 1])]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulate(c, initial_state='00')
    psi = simulate(c, initial_state='00', device='cpu')
    np.testing.assert_allclose(psi.reshape(-1),
                               np.array([1, 0, 0, 1]) / np.sqrt(2),
                               atol=1e-6)


@pytest.mark.parametrize('optimize, complex_type, item', [
    ('evolution-indexed', 'complex64', 'item 6'),
    ('evolution-einsum', 'complex64', 'item 4a'),
    ('evolution-sharded', 'complex64', 'item 11'),
    ('tn', 'complex64', 'item 10'),
    ('evolution', 'complex128', 'item 2a'),
])
def test_unported_engines_name_their_roadmap_item(optimize, complex_type,
                                                  item):
    from hybridq_tpu_torch import Gate
    from hybridq_tpu_torch.simulation import simulate

    c = [Gate('H', qubits=[0])]
    with pytest.raises(NotImplementedError, match=item):
        simulate(c, initial_state='0', optimize=optimize,
                 complex_type=complex_type, device='cpu')
