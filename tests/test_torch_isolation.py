"""The port stands alone: ``hybridq_tpu_torch`` imports neither ``jax`` nor
``hybridq_tpu`` (nor ``opt_einsum``, which the card machine lacks), its
entry points run on the card unless the caller asks for the CPU, and an
installed copy ships every CUDA and C++ file its builds read."""

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
# not on the card machine; torch imports it when present, so the source
# scan and a run with it blocked stand for "unloaded"
NOT_NEEDED = ('opt_einsum',)


def _forbidden(module):
    return any(module == f or module.startswith(f + '.')
               for f in FORBIDDEN + NOT_NEEDED)


def test_no_forbidden_imports_in_source():
    """AST scan of every module of the package and of ``chip_smoke.py``,
    lazy imports included."""
    offenders = []
    files = sorted(PKG.rglob('*.py')) + [ROOT / 'chip_smoke.py']
    for name in ('fused_k4', 'bw', 'gather'):
        assert PKG / 'probes' / f'{name}.py' in files
    for name in ('parallel/__init__.py', 'parallel/mesh.py',
                 'simulation/sharded.py'):
        assert PKG / name in files
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
            "hybridq_tpu_torch.simulation.kernels, hybridq_tpu_torch.dm, "
            "hybridq_tpu_torch.noise, hybridq_tpu_torch.noise.channel, "
            "hybridq_tpu_torch.simulation.row_kernels, "
            "hybridq_tpu_torch.probes.fused_k4, "
            "hybridq_tpu_torch.probes.bw, hybridq_tpu_torch.probes.gather, "
            "hybridq_tpu_torch.simulation._build, "
            "hybridq_tpu_torch.simulation.tn, hybridq_tpu_torch.native, "
            "hybridq_tpu_torch.simulation.trajectories, "
            "hybridq_tpu_torch.simulation.clifford, hybridq_tpu_torch.cli, "
            "hybridq_tpu_torch.extras.io, hybridq_tpu_torch.extras.otoc, "
            "hybridq_tpu_torch.extras.gate, hybridq_tpu_torch.architecture, "
            "hybridq_tpu_torch.architecture.plot, "
            "hybridq_tpu_torch.parallel, hybridq_tpu_torch.parallel.mesh, "
            "hybridq_tpu_torch.simulation.sharded; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}); print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, '-c', code], cwd=str(ROOT),
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, (r.stdout, r.stderr)


def test_tn_and_einsum_run_without_opt_einsum_or_networkx():
    """With ``opt_einsum`` unimportable (as on the card machine), the TN
    engine (path search, slicing, the torch executor) and
    ``'evolution-einsum'`` run, ``load_reference_plan`` reads every
    committed plan, and ``jax``, ``hybridq_tpu`` and, with the native
    library built, ``networkx`` stay unloaded."""
    code = (
        "import sys; sys.modules['opt_einsum'] = None\n"
        "import numpy as np\n"
        "from hybridq_tpu_torch import Gate\n"
        "from hybridq_tpu_torch import native\n"
        "from hybridq_tpu_torch.simulation import simulate\n"
        "c = [Gate('H', qubits=[0]), Gate('CX', qubits=[0, 1])]\n"
        "bell = np.array([1, 0, 0, 1]) / np.sqrt(2)\n"
        "for kw in (dict(optimize='tn', final_state='..', max_time=1),\n"
        "           dict(optimize='evolution-einsum')):\n"
        "    psi = simulate(c, initial_state='00', device='cpu', **kw)\n"
        "    assert np.abs(psi.reshape(-1) - bell).max() < 1e-6, kw\n"
        "assert native.hgp_available()\n"
        "from hybridq_tpu_torch.convert import load_reference_plan\n"
        "for name in ('d12_s0_t26', 'd20_s0_t22', 'd20_s0_t24',\n"
        "             'd20_s0_t26'):\n"
        "    plan = load_reference_plan(\n"
        "        f'scripts/_plan_cache/syc53_{name}.pkl')\n"
        "    assert type(plan[2]).__module__.startswith(\n"
        "        'hybridq_tpu_torch.'), type(plan[2])\n"
        "bad = sorted(m for m in sys.modules if sys.modules[m] is not None\n"
        f"             and m.split('.')[0] in {FORBIDDEN + NOT_NEEDED!r}\n"
        "             + ('networkx',))\n"
        "print(bad); sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, '-c', code], cwd=str(ROOT),
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, (r.stdout, r.stderr)


def test_package_data_ships_every_cuda_source_and_header():
    """An installed copy builds from what ``package-data`` ships: every
    ``csrc`` file and every ``#include "..."`` of a source must match one
    of its globs, or nvcc fails there though it passes in the checkout;
    so must the native path search's C++ sources (``native/*.cpp``),
    which g++ builds at first use."""
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
    native = sorted((PKG / 'native').glob('*.cpp'))
    assert [p.name for p in native] == ['hgpart.cpp', 'tnopt.cpp',
                                        'tree_anneal.cpp']
    for path in native:
        rel = path.relative_to(PKG).as_posix()
        assert any(fnmatch.fnmatch(rel, g) for g in globs), (rel, globs)


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


@pytest.mark.parametrize('optimize, kwargs', [
    ('evolution-sharded', {}),
    ('tn', {'final_state': '..0', 'max_time': 1}),
])
def test_multi_device_engines_run_on_cpu_devices(optimize, kwargs):
    """The sharded engines, and a TN contraction over several devices,
    once named by their ROADMAP item as not ported, run on a list of CPU
    devices (no ``device=``) and give the Bell state."""
    from hybridq_tpu_torch import Gate
    from hybridq_tpu_torch.simulation import simulate

    c = [Gate('H', qubits=[0]), Gate('CX', qubits=[0, 1]),
         Gate('I', qubits=[2])]
    psi, info = simulate(c, initial_state='000', optimize=optimize,
                         devices=['cpu', 'cpu'], return_info=True,
                         remove_id_gates=False, simplify=False, **kwargs)
    assert info.get('engine') == ('sharded' if 'sharded' in optimize
                                  else None)
    if psi.ndim == 3:            # evolution: qubit 2 stays |0>
        psi = psi[..., 0]
    np.testing.assert_allclose(psi.reshape(-1),
                               np.array([1, 0, 0, 1]) / np.sqrt(2),
                               atol=1e-7)


@pytest.mark.parametrize('optimize, complex_type, engine', [
    ('evolution-indexed', 'complex64', 'indexed'),
    ('evolution', 'complex128', 'torch'),
    ('evolution-einsum', 'complex64', 'einsum'),
    ('tn', 'complex64', None),
])
def test_ported_engines_run_on_the_host(optimize, complex_type, engine):
    """The straight engine, complex128 evolution, ``'evolution-einsum'``
    and the TN engine, once named by the test above as not ported, now
    run on the host and give the Bell state."""
    from hybridq_tpu_torch import Gate
    from hybridq_tpu_torch.simulation import simulate

    c = [Gate('H', qubits=[0]), Gate('CX', qubits=[0, 1])]
    kw = {} if engine else {'final_state': '..', 'max_time': 1}
    psi, info = simulate(c, initial_state='00', optimize=optimize,
                         complex_type=complex_type, device='cpu',
                         return_info=True, **kw)
    assert info.get('engine') == engine
    assert psi.dtype == np.dtype(complex_type)
    np.testing.assert_allclose(psi.reshape(-1),
                               np.array([1, 0, 0, 1]) / np.sqrt(2),
                               atol=1e-7 if engine != 'torch' else 1e-15)


@pytest.mark.parametrize('optimize', ['tn', 'evolution-einsum'])
def test_tn_and_einsum_need_a_card_unless_told(optimize, monkeypatch):
    """``simulate(optimize='tn')`` and ``'evolution-einsum'`` run on the
    card by default: without one they raise, naming ``device='cpu'``;
    the TN engine's plain numpy executor (``backend='numpy'``) is the
    host path that needs no card."""
    from hybridq_tpu_torch import Gate
    from hybridq_tpu_torch.simulation import simulate

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    c = [Gate('H', qubits=[0]), Gate('CX', qubits=[0, 1])]
    kw = {'final_state': '..', 'max_time': 1} if optimize == 'tn' else {}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulate(c, initial_state='00', optimize=optimize, **kw)
    bell = np.array([1, 0, 0, 1]) / np.sqrt(2)
    runs = [dict(device='cpu')] + ([dict(backend='numpy')]
                                   if optimize == 'tn' else [])
    for run in runs:
        psi = simulate(c, initial_state='00', optimize=optimize, **kw,
                       **run)
        np.testing.assert_allclose(psi.reshape(-1), bell, atol=1e-6)


ENTRY_POINTS = ['state_from_reference', 'IndexedEvolver',
                'sample_trajectories', 'update_pauli_string', 'cli.main',
                'ShardedIndexedEvolver', 'ShardedEvolver',
                'simulate-sharded']


@pytest.mark.parametrize('entry', ENTRY_POINTS)
def test_entry_points_need_a_card_unless_told(entry, monkeypatch, tmp_path):
    """``state_from_reference``, ``IndexedEvolver``,
    ``sample_trajectories``, ``clifford.update_pauli_string``, the
    command line, both sharded evolvers and
    ``simulate(optimize='evolution-sharded')`` default to the card like
    ``simulate``: without one they raise, naming ``device='cpu'`` (the
    evolvers: ``devices=['cpu']``); told the CPU (``--device cpu``, CPU
    ``devices``), they run there."""
    from hybridq_tpu_torch import Circuit, Gate
    from hybridq_tpu_torch import cli
    from hybridq_tpu_torch.convert import state_from_reference
    from hybridq_tpu_torch.extras.io.qasm import to_qasm
    from hybridq_tpu_torch.simulation import clifford, simulate, trajectories
    from hybridq_tpu_torch.simulation.kernels import IndexedEvolver
    from hybridq_tpu_torch.simulation.sharded import (ShardedEvolver,
                                                      ShardedIndexedEvolver)

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    pair = np.zeros((2, 2 ** 3), dtype=np.float32)
    pair[0, 0] = 1
    bell = Circuit([Gate('H', qubits=[0]), Gate('CX', qubits=[0, 1])])
    qasm = tmp_path / 'bell.qasm'
    qasm.write_text(to_qasm(bell))
    out = tmp_path / 'out.pk'

    def run_cli(**kw):
        import pickle

        cli.main([str(qasm), str(out)] +
                 (['--device', kw['device']] if kw else []))
        with open(out, 'rb') as f:
            return pickle.load(f)['simulate']

    def run_sharded(cls, device=None):
        ev = cls(3, devices=None if device is None else [device] * 2)
        return ev.gather(ev.evolve(ev.prepare_state('000'), bell))[..., 0]
    make = {'state_from_reference': lambda **kw: state_from_reference(
                pair, **kw)[0],
            'IndexedEvolver': lambda **kw: IndexedEvolver(
                3, **kw).prepare_state('000'),
            'sample_trajectories': lambda **kw:
                trajectories.sample_trajectories(bell, 2, **kw),
            'update_pauli_string': lambda **kw:
                clifford.update_pauli_string(bell, 'ZI', **kw),
            'cli.main': run_cli,
            'ShardedIndexedEvolver': lambda **kw: run_sharded(
                ShardedIndexedEvolver, **kw),
            'ShardedEvolver': lambda **kw: run_sharded(ShardedEvolver, **kw),
            'simulate-sharded': lambda **kw: simulate(
                bell, initial_state='00', optimize='evolution-sharded',
                **kw)}[entry]
    told = r"devices=\['cpu'\]" if entry.startswith('Sharded') \
        else "device='cpu'"
    with pytest.raises(RuntimeError, match=told):
        make()
    got = make(device='cpu')
    if entry in ('state_from_reference', 'IndexedEvolver'):
        assert got.device.type == 'cpu'
        np.testing.assert_array_equal(got.numpy(), pair.reshape(-1))
    elif entry == 'update_pauli_string':
        assert set(got) == {'XI'}          # H^dagger CX Z0 CX H = X0
    else:
        bell_state = np.array([1, 0, 0, 1]) / np.sqrt(2)
        assert isinstance(got, np.ndarray)
        for psi in np.reshape(got, (-1, 4)):
            np.testing.assert_allclose(psi, bell_state, atol=1e-6)
