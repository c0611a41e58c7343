"""The port's QASM IO and command lines against the JAX package's.

``tests/test_qasm.py``'s round trips run on the port's gates, and the
dialect crosses between the packages both ways (the same matrices to
1e-5, ``test_qasm.py``'s bar).  ``main`` runs with ``--device cpu`` on the
in-repo ``examples/circuit_simple.qasm`` (22 qubits): its pickle holds a
numpy array, equal to the port's ``simulate`` of the same file (the same
engine on the same input: max|d|/rms <= 1e-6) and within 1e-5 max|d|/rms
of JAX's ``cli.main`` (f32 sums in another order).  ``main_dm`` runs on a
Clifford+T file written with the port's ``to_qasm``: its JSON against
the port's numpy backend and JAX's ``main_dm`` (1e-5 of max|v|, float32).
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from hybridq_tpu import cli as jcli
from hybridq_tpu.circuit import utils as jutils
from hybridq_tpu.extras.io import qasm as jqasm
from hybridq_tpu_torch import Circuit, Gate
from hybridq_tpu_torch import cli
from hybridq_tpu_torch.circuit import utils
from hybridq_tpu_torch.extras.io.qasm import from_qasm, to_qasm
from hybridq_tpu_torch.extras.random import get_rqc
from hybridq_tpu_torch.simulation import clifford, simulate

ROOT = os.path.join(os.path.dirname(__file__), '..')
SIMPLE = os.path.join(ROOT, 'examples', 'circuit_simple.qasm')
ATOL = 1e-5
RMS_SAME = 1e-6
RMS_F32 = 1e-5


def _matrix(c, u=utils):
    return u.matrix(c, complex_type='complex128')


def _rel(a, b):
    a, b = np.ravel(a), np.ravel(b)
    return np.abs(a - b).max() / np.sqrt(np.mean(np.abs(b) ** 2))


def test_roundtrip_simple():
    c = Circuit([Gate('H', [0]), Gate('CX', [0, 1]),
                 Gate('RX', [1], params=[0.3])])
    c2 = from_qasm(to_qasm(c))
    assert [g.name for g in c2] == ['H', 'CX', 'RX']
    np.testing.assert_allclose(_matrix(c2), _matrix(c), atol=ATOL)


def _rich(G, C):
    return C([
        G('X', [0], tags={'a': 1})**0.75,
        G('ISWAP', [0, 1]).conj(),
        G('T', [1]).T(),
        G('MATRIX', qubits=[0, 1], U=np.kron(G('H').matrix(),
                                             G('X').matrix())),
    ])


def test_roundtrip_power_conj_T_tags_matrix():
    c = _rich(Gate, Circuit)
    c2 = from_qasm(to_qasm(c))
    assert c2[0].power == 0.75
    assert c2[0].tags == {'a': 1}
    assert c2[1].is_conjugated()
    assert c2[2].is_transposed()
    np.testing.assert_allclose(_matrix(c2), _matrix(c), atol=ATOL)


def test_roundtrip_random_circuit():
    c = get_rqc(4, 20)
    c2 = from_qasm(to_qasm(c))
    np.testing.assert_allclose(_matrix(c2), _matrix(c), atol=1e-4)


def test_dialect_crosses_between_packages():
    """The port writes what JAX reads and reads what JAX writes: the same
    text both ways, and the same matrix."""
    from hybridq_tpu import Circuit as JCircuit, Gate as JGate
    c, cj = _rich(Gate, Circuit), _rich(JGate, JCircuit)
    assert to_qasm(c) == jqasm.to_qasm(cj)
    np.testing.assert_allclose(_matrix(jqasm.from_qasm(to_qasm(c)), jutils),
                               _matrix(c), atol=ATOL)
    np.testing.assert_allclose(_matrix(from_qasm(jqasm.to_qasm(cj))),
                               _matrix(c), atol=ATOL)
    with open(SIMPLE) as f:
        text = f.read()
    mine, theirs = from_qasm(text), jqasm.from_qasm(text)
    assert [(g.name, tuple(g.qubits)) for g in mine] == \
        [(g.name, tuple(g.qubits)) for g in theirs]


def _pickle(path):
    with open(path, 'rb') as f:
        return pickle.load(f)


def test_main_on_the_shipped_example(tmp_path):
    """``main --device cpu`` on ``examples/circuit_simple.qasm``: a numpy
    state of unit norm, the port's ``simulate`` of the same file, and
    JAX's ``cli.main`` on it in complex128, to complex64 rounding (JAX's
    complex64 state is itself 1.0e-5 of the rms off it at its widest)."""
    out = tmp_path / 'out.pk'
    cli.main([SIMPLE, str(out), '--device', 'cpu'])
    results = _pickle(out)
    psi = results['simulate']
    assert isinstance(psi, np.ndarray) and psi.dtype == np.complex64
    assert 'runtime (s)' in results
    np.testing.assert_allclose(np.linalg.norm(psi.ravel()), 1, atol=1e-4)
    with open(SIMPLE) as f:
        c = from_qasm(f.read())
    assert _rel(psi, simulate(c, initial_state='0', device='cpu')) <= \
        RMS_SAME
    ref = tmp_path / 'ref.pk'
    jcli.main([SIMPLE, str(ref), '--complex-type', 'complex128'])
    assert _rel(psi, np.asarray(_pickle(ref)['simulate'])) <= RMS_F32


def _small_qasm(tmp_path, n=6, depth=30):
    np.random.seed(2)
    c = get_rqc(n, depth, indexes=list(range(n)))
    path = tmp_path / 'small.qasm'
    path.write_text(to_qasm(c))
    return c, str(path)


def test_main_params_json_and_return_info(tmp_path):
    """``--params`` as inline JSON and ``--return-info``: the pickle
    holds ``(psi, info)`` with psi a numpy array, in the asked type."""
    c, path = _small_qasm(tmp_path)
    out = tmp_path / 'out.pk'
    cli.main([path, str(out), '--device', 'cpu', '--return-info',
              '--params', '{"complex-type": "complex128", "compress": 2}'])
    psi, info = _pickle(out)['simulate']
    assert isinstance(psi, np.ndarray) and psi.dtype == np.complex128
    assert info['engine'] == 'torch'
    want = _matrix(c)[:, 0]
    assert _rel(psi, want) <= 1e-10


def test_main_bad_args():
    with pytest.raises(SystemExit):
        cli.main(['--no-such-flag'])


def test_module_entry_point(tmp_path):
    """``python -m hybridq_tpu_torch.cli`` runs ``main``."""
    c, path = _small_qasm(tmp_path)
    out = tmp_path / 'out.pk'
    env = dict(os.environ, PYTHONPATH=os.path.abspath(ROOT))
    r = subprocess.run([sys.executable, '-m', 'hybridq_tpu_torch.cli',
                        path, str(out), '--device', 'cpu'],
                       cwd=str(tmp_path), env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert _rel(_pickle(out)['simulate'], _matrix(c)[:, 0]) <= RMS_F32


def _clifford_t(tmp_path, n=5):
    """A Clifford+T circuit written with the port's ``to_qasm``."""
    np.random.seed(4)
    c = get_rqc(n, 30, indexes=list(range(n)), use_clifford_only=True,
                randomize_power=False)
    c = Circuit(list(c) + [Gate('T', [q]) for q in range(n)] +
                list(get_rqc(n, 10, indexes=list(range(n)),
                             use_clifford_only=True,
                             randomize_power=False)))
    path = tmp_path / 'clifford_t.qasm'
    path.write_text(to_qasm(c))
    return c, str(path)


def _strings(path):
    with open(path) as f:
        payload = json.load(f)
    assert set(payload) == {'pauli_strings', 'runtime (s)', 'info'}
    return {k: v[0] for k, v in payload['pauli_strings'].items()}, payload


def test_main_dm(tmp_path):
    """``main_dm --device cpu``: JSON strings against the numpy backend
    and JAX's ``main_dm`` on the same file."""
    c, path = _clifford_t(tmp_path)
    pauli = 'IIZII'
    out, ref = tmp_path / 'out.json', tmp_path / 'ref.json'
    cli.main_dm([path, str(out), '--initial-pauli-string', pauli,
                 '--device', 'cpu', '--return-info'])
    jcli.main_dm([path, str(ref), '--initial-pauli-string', pauli])
    got, payload = _strings(out)
    assert payload['info']['n_strings'] == len(got) > 1
    want = clifford.update_pauli_string(c, pauli, backend='numpy')
    scale = max(abs(v) for v in want.values())
    for strings in (want, _strings(ref)[0]):
        assert {k for k, v in got.items() if abs(v) > 1e-6} == \
            {k for k, v in strings.items() if abs(v) > 1e-6}
        for k in set(got) | set(strings):
            assert abs(got.get(k, 0) - strings.get(k, 0)) <= 1e-5 * scale


def test_main_dm_parallel_takes_the_numpy_backend(tmp_path, monkeypatch):
    """``--parallel`` keeps its meaning (worker processes of the numpy
    backend); without it the torch backend runs on ``--device``."""
    _, path = _clifford_t(tmp_path)
    seen = []
    real = clifford.update_pauli_string

    def spy(*args, **kw):
        seen.append({k: kw[k] for k in ('backend', 'parallel', 'device')})
        return real(*args, **{**kw, 'parallel': False})
    monkeypatch.setattr(clifford, 'update_pauli_string', spy)
    out = tmp_path / 'out.json'
    cli.main_dm([path, str(out), '--initial-pauli-string', 'ZIIII',
                 '--parallel'])
    cli.main_dm([path, str(out), '--initial-pauli-string', 'ZIIII',
                 '--device', 'cpu'])
    assert seen == [{'backend': 'numpy', 'parallel': True, 'device': None},
                    {'backend': 'torch', 'parallel': False,
                     'device': 'cpu'}]
    with pytest.raises(ValueError, match='length'):
        cli.main_dm([path, str(out), '--initial-pauli-string', 'ZI',
                     '--device', 'cpu'])
