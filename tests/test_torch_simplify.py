"""The port's insertion scan (``circuit.utils``: ``simplify``, ``popright``,
``popleft``, ``pop``, ``isclose``) against the JAX package's, gate for gate.

Each case builds the same circuit in both packages from one numpy seed and
compares the outputs by kind, name, qubits, power, params, conj/T flags,
matrix and order: random circuits of ``extras.random`` (mixed qubit labels
too), a Sycamore-pattern circuit (sqrt gates and fSim couplers, as the
benchmark's), inverse pairs that must cancel (an fSim among them with its
qubits reversed) and pairs that must not, identity gates, a 3-qubit gate, a
gate wider than ``max_n_qubits_matrix``, and lightcone pruning against
pinned qubits.  The counters show that the scan tests few positions with
numpy.
"""

import numpy as np
import pytest

import hybridq_tpu as J
import hybridq_tpu_torch as T
from hybridq_tpu.circuit import utils as jutils
from hybridq_tpu.extras.random import get_rqc as j_rqc
from hybridq_tpu_torch.circuit import utils as tutils
from hybridq_tpu_torch.extras.random import get_rqc as t_rqc

FSIM = (np.pi / 2, np.pi / 6)
ONE_QUBIT = (('SQRT_X', None), ('SQRT_Y', None), ('R_PI_2', (np.pi / 4,)))


def _rqc(pkg, n, m, seed, **kw):
    np.random.seed(seed)
    return (j_rqc if pkg is J else t_rqc)(n, m, **kw)


def _grid(rows, cols):
    """Couplers of a rows x cols grid in four layers, Sycamore's A-D."""
    q = lambda r, c: r * cols + c
    h = [(q(r, c), q(r, c + 1)) for r in range(rows) for c in range(cols - 1)]
    v = [(q(r, c), q(r + 1, c)) for r in range(rows - 1) for c in range(cols)]
    return {'A': [p for p in h if p[0] % 2 == 0],
            'B': [p for p in h if p[0] % 2],
            'C': [p for p in v if (p[0] // cols) % 2],
            'D': [p for p in v if (p[0] // cols) % 2 == 0]}


def _sycamore(pkg, rows, cols, cycles, seed):
    """One-qubit sqrt gates on every qubit, then a layer of fSim couplers,
    the layers in the order ABCDCDAB."""
    rng = np.random.default_rng(seed)
    layers = _grid(rows, cols)
    gates = []
    for c in range(cycles):
        for q in range(rows * cols):
            name, params = ONE_QUBIT[int(rng.integers(3))]
            gates.append(pkg.Gate(name, [q], params=params))
        for pair in layers['ABCDCDAB'[c % 8]]:
            gates.append(pkg.Gate('FSIM', list(pair), params=FSIM))
    return pkg.Circuit(gates)


def _random_unitary(k, rng):
    z = rng.normal(size=(2**k, 2**k)) + 1j * rng.normal(size=(2**k, 2**k))
    return np.linalg.qr(z)[0]


def _with_pairs(pkg):
    """A Sycamore circuit with inverse pairs that cancel through commuting
    gates, an fSim undone on its reversed qubits, and pairs that must stay
    (CX against CX on the reversed qubits, a rotation against another
    angle)."""
    G = pkg.Gate
    gates = list(_sycamore(pkg, 2, 4, 4, 11))
    rng = np.random.default_rng(12)
    inserts = [
        (G('RX', [1], params=[0.3]), G('RX', [1], params=[0.3])**-1),
        (G('FSIM', [2, 3], params=FSIM), G('FSIM', [3, 2], params=FSIM)**-1),
        (G('CX', [4, 5]), G('CX', [5, 4])**-1),
        (G('X', [6])**0.37, G('X', [6])**-0.37),
        (G('RZ', [0], params=[0.2]), G('RZ', [0], params=[0.25])**-1),
        (G('SQRT_Y', [7]).conj(), G('SQRT_Y', [7]).conj().inv()),
        (G('MATRIX', [1, 6], U=_random_unitary(2, rng)), None),
    ]
    for a, b in inserts:
        if b is None:
            b = a.inv()
        at = int(rng.integers(len(gates)))
        # on other qubits in between, so that the pair meets in the scan
        gap = [G('H', [q]) for q in range(8) if q not in a.qubits][:2]
        gates[at:at] = [a] + gap + [b]
    return pkg.Circuit(gates)


def _identities(pkg):
    """Identity gates of every kind, between Sycamore gates."""
    G = pkg.Gate
    gates = list(_sycamore(pkg, 2, 3, 3, 21))
    ids = [G('I', [0]), G('X', [1])**2, G('RZ', [2], params=[0.0]),
           G('MATRIX', [3, 4], U=np.eye(4)), G('MATRIX', [0, 2, 5],
                                               U=np.eye(8)),
           G('Z', [5])**2, G('FSIM', [1, 2], params=[0.0, 0.0])]
    for i, g in enumerate(ids):
        gates.insert(5 * i + 3, g)
    return pkg.Circuit(gates)


def _three_qubit(pkg):
    """A 3-qubit gate and its inverse on the qubits in another order,
    between Sycamore gates on other qubits."""
    G = pkg.Gate
    rng = np.random.default_rng(31)
    U = _random_unitary(3, rng)
    # the same matrix with its qubits in the order (2, 0, 1)
    V = np.reshape(np.transpose(np.reshape(U.conj().T, (2,) * 6),
                                (2, 0, 1, 5, 3, 4)), (8, 8))
    gates = list(_sycamore(pkg, 2, 4, 3, 32))
    gates[10:10] = [G('MATRIX', [0, 1, 2], U=U), G('H', [5]),
                    G('MATRIX', [2, 0, 1], U=V),
                    G('MATRIX', [3, 4, 7], U=_random_unitary(3, rng))]
    return pkg.Circuit(gates)


def _simplify(**kw):
    return lambda u, c: u.simplify(c, **kw)


def _pop(fn, pinned, **kw):
    return lambda u, c: getattr(u, fn)(c, pinned_qubits=pinned, **kw)


def _isclose(edit):
    """``isclose`` of the circuit against ``edit(utils, circuit)``."""
    return lambda u, c: u.isclose(c, edit(u, c))


def _changed_power(u, c):
    d = type(c)(g.copy() for g in c)
    d[len(d) // 2] = d[len(d) // 2]**0.5
    return d


# name -> (build(pkg) -> circuit, call(utils, circuit) -> result)
CASES = {
    'random-6': (lambda p: _rqc(p, 6, 60, 1), _simplify()),
    'random-8-labels': (lambda p: _rqc(p, 8, 60, 2, use_random_indexes=True),
                        _simplify()),
    'random-10-nonunitary': (lambda p: _rqc(p, 10, 60, 3,
                                            use_unitary_only=False),
                             _simplify()),
    'random-12-clifford': (lambda p: _rqc(p, 12, 80, 4,
                                          use_clifford_only=True,
                                          randomize_power=False),
                           _simplify()),
    'random-6-undone': (lambda p: (lambda c: c + c.inv())(_rqc(p, 6, 30, 5)),
                        _simplify()),
    'random-8-no-commutation': (lambda p: _rqc(p, 8, 50, 6),
                                _simplify(use_matrix_commutation=False)),
    'sycamore-12': (lambda p: _sycamore(p, 3, 4, 8, 7), _simplify()),
    'inverse-pairs': (_with_pairs, _simplify()),
    'identities': (_identities, _simplify()),
    'identities-kept': (_identities, _simplify(remove_id_gates=False)),
    'three-qubit': (_three_qubit, _simplify()),
    'wider-than-matrix-limit': (_three_qubit,
                                _simplify(max_n_qubits_matrix=2)),
    'identities-wider-than-matrix-limit': (_identities, _simplify(
        max_n_qubits_matrix=2)),
    'insert_from_left': (lambda p: _sycamore(p, 2, 3, 2, 13),
                         lambda u, c: u.insert_from_left(c, c[0].inv())),
    'popright': (lambda p: _sycamore(p, 2, 4, 6, 8), _pop('popright',
                                                          [0, 5])),
    'popright-no-cancel': (_with_pairs, _pop('popright', [1, 2],
                                             simplify=False)),
    'popleft': (lambda p: _rqc(p, 8, 50, 9), _pop('popleft', [3])),
    'pop-both': (_with_pairs, lambda u, c: u.pop(c, 'both', [2, 7])),
    'isclose-simplified': (_with_pairs, _isclose(lambda u, c: u.simplify(c))),
    'isclose-changed': (lambda p: _sycamore(p, 2, 3, 3, 10),
                        _isclose(_changed_power)),
}


def _describe(gate):
    d = [type(gate).__name__, gate.name, gate.qubits,
         getattr(gate, 'power', None), getattr(gate, 'params', None)]
    for flag in ('is_conjugated', 'is_transposed'):
        d.append(getattr(gate, flag)() if hasattr(gate, flag) else None)
    if d[0] == 'MatrixGate':
        d.append(gate.Matrix.tobytes())
    return tuple(d)


@pytest.mark.parametrize('case', list(CASES))
def test_insertion_scan_matches_jax(case):
    build, call = CASES[case]
    want = call(jutils, build(J))
    c = build(T)
    got = call(tutils, c)
    if isinstance(want, bool):
        assert got is want
        return
    assert [_describe(g) for g in got] == [_describe(g) for g in want]
    # the output holds copies, never the caller's gates
    ids = {id(g) for g in c}
    assert not any(id(g) in ids for g in got)


def test_inverse_pairs_cancel():
    """The pairs of ``_with_pairs`` that are inverses cancel and the others
    stay, whatever JAX does."""
    base = [g.name for g in _sycamore(T, 2, 4, 4, 11)]
    names = [g.name for g in tutils.simplify(_with_pairs(T))]
    for name in ('RX', 'FSIM', 'X', 'SQRT_Y', 'MATRIX'):
        assert names.count(name) == base.count(name), name
    assert names.count('CX') == 2 and names.count('RZ') == 2


def test_counters_show_the_scan_engaged():
    c = _sycamore(T, 4, 4, 14, 0)
    tutils.reset_counts()
    s = tutils.simplify(c)
    n = tutils.counts()
    assert len(s) == len(c)
    assert n['simplify_gates'] == len(c)
    assert n['scanned'] >= n['simplify_gates']
    assert n['matrix_tests'] <= n['scanned']
    assert n['matrix_tests'] <= 4 * len(c)
    tutils.reset_counts()
    assert tutils.counts() == {'simplify_gates': 0, 'scanned': 0,
                               'matrix_tests': 0, 'compress_tests': 0,
                               'block_matrices_reused': 0,
                               'block_matrices_built': 0}
