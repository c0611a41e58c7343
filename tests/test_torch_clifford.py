"""The port's Clifford / Pauli-string engine against the JAX package's.

Each case of ``tests/test_clifford.py`` runs on both packages, the inputs
built twice from one fixed seed: JAX's numpy backend (the reference),
JAX's ``'jax'`` backend, and the port with ``backend='numpy'`` and with
``backend='torch'`` on ``device='cpu'``.  Dicts are compared by key,
never as ordered lists (``torch.unique`` sorts rows otherwise than
``np.unique``, so sums run in another order): the strings above 1e-6 must
be the same, and every value must agree within 1e-9 of max|v| against
JAX's numpy backend in float64, and within 1e-5 of max|v| against JAX's
``'jax'`` backend, which runs in float32 (the tests never enable x64).
Each case also keeps the original's own check (dense reconstruction,
reference values) on the port's result.
"""

import numpy as np
import pytest

import hybridq_tpu as J
import hybridq_tpu_torch as T
from hybridq_tpu import dm as jdm
from hybridq_tpu.extras.random import get_rqc as j_rqc
from hybridq_tpu.simulation import clifford as jcl
from hybridq_tpu_torch import dm as tdm
from hybridq_tpu_torch.circuit import utils as tutils
from hybridq_tpu_torch.extras.random import get_rqc as t_rqc
from hybridq_tpu_torch.simulation import clifford as tcl

F64 = 1e-9                  # against JAX's numpy backend, of max|v|
F32 = 1e-5                  # against float32 arithmetic, of max|v|
KEY_FLOOR = 1e-6            # strings above this must agree
BACKENDS = ['numpy', 'torch']


def _kw(backend):
    return {'backend': backend,
            **({'device': 'cpu'} if backend == 'torch' else {})}


def _same(got, want, tol):
    """``got`` and ``want`` (Pauli-string dicts) agree: the same strings
    above ``KEY_FLOOR``, every value within ``tol`` of max|v|."""
    assert {k for k, v in got.items() if abs(v) > KEY_FLOOR} == \
        {k for k, v in want.items() if abs(v) > KEY_FLOOR}
    scale = max(abs(v) for v in want.values())
    for k in set(got) | set(want):
        assert abs(got.get(k, 0.0) - want.get(k, 0.0)) <= tol * scale, k


def _reconstruct(pkg, db, n):
    U = np.zeros((2**n, 2**n), dtype=complex)
    for key, ph in db.items():
        M = np.array([[1.0]])
        for c in key:
            M = np.kron(M, pkg.Gate(c).matrix())
        U = U + ph * M
    return U


def _oracle(utils, circuit, pauli):
    return utils.matrix(circuit + pauli + circuit.inv(),
                        complex_type='complex128')


def _ids(n):
    return lambda pkg: pkg.Circuit(pkg.Gate('I', [q]) for q in range(n))


def _rqc(pkg, *args, **kw):
    return (j_rqc if pkg is J else t_rqc)(*args, **kw)


# Each case: (build(pkg) -> (circuit, pauli), update_pauli_string kwargs).
def _docstring(pkg):
    return (pkg.Circuit([pkg.Gate('X', qubits=[0])**1.2,
                         pkg.Gate('ISWAP', qubits=[0, 1])**2.3]),
            pkg.Circuit([pkg.Gate('Z', qubits=[1])]))


def _random(n, m):
    def build(pkg):
        np.random.seed(100 + n)
        c = _rqc(pkg, n, m, indexes=list(range(n))) + _ids(n)(pkg)
        return c, pkg.Circuit([pkg.Gate('Z', [0]), pkg.Gate('X', [n - 1])])
    return build


def _clifford_only(pkg):
    np.random.seed(7)
    c = _rqc(pkg, 5, 40, indexes=list(range(5)), use_clifford_only=True,
             randomize_power=False) + _ids(5)(pkg)
    return c, pkg.Circuit([pkg.Gate('Z', [2])])


def _t_gates(pkg):
    G = pkg.Gate
    return (pkg.Circuit([G('T', [0]), G('H', [0]), G('T', [0])]),
            pkg.Circuit([G('Z', [0])]))


def _dict_input(pkg):
    return (pkg.Circuit([pkg.Gate('H', [0]), pkg.Gate('CX', [0, 1])]),
            {'ZI': 0.5, 'IZ': 0.5})


def _splitting(pkg):
    G = pkg.Gate
    return (pkg.Circuit([G('T', [q % 3]) for q in range(6)] +
                        [G('H', [q % 3]) for q in range(6)]),
            pkg.Circuit([G('Z', [0])]))


def _reference_parity(pkg):
    G = pkg.Gate
    return (pkg.Circuit([G('H', [0]), G('T', [0]), G('CX', [0, 1]),
                         G('T', [1]), G('H', [1])]),
            pkg.Circuit([G('Z', [0])]))


CASES = {
    'reference_docstring_example': (_docstring, {}),
    'random_circuit_reconstruction-3-10': (_random(3, 10),
                                           {'remove_id_gates': False}),
    'random_circuit_reconstruction-4-15': (_random(4, 15),
                                           {'remove_id_gates': False}),
    'clifford_only_does_not_branch': (_clifford_only, {
        'compress': 0, 'simplify': False, 'remove_id_gates': False}),
    't_gates_branch': (_t_gates, {}),
    'dict_pauli_string_input': (_dict_input, {}),
    'max_branches_splitting': (_splitting,
                               {'max_breadth_first_branches': 2}),
    'reference_clifford_parity': (_reference_parity, {}),
}
_JAX = {}


def _jax(case):
    """JAX's numpy and 'jax' backends on a case (cached: each runs once
    for both port backends)."""
    if case not in _JAX:
        build, kw = CASES[case]
        c, p = build(J)
        _JAX[case] = tuple(jcl.update_pauli_string(
            c, p, float_type='float64', backend=b, **kw)
            for b in ('numpy', 'jax'))
    return _JAX[case]


def _port(case, backend, float_type='float64', **extra):
    build, kw = CASES[case]
    c, p = build(T)
    return tcl.update_pauli_string(c, p, float_type=float_type,
                                   **_kw(backend), **{**kw, **extra})


@pytest.mark.parametrize('backend', BACKENDS)
@pytest.mark.parametrize('case', list(CASES))
def test_update_pauli_string_matches_jax(case, backend):
    """Every ``update_pauli_string`` case of ``tests/test_clifford.py``,
    float64, against both JAX backends."""
    want, want_jax = _jax(case)
    got = _port(case, backend)
    _same(got, want, F64)
    _same(got, want_jax, F32)


@pytest.mark.parametrize('backend', BACKENDS)
def test_float32_matches_jax(backend):
    """The default float32 on the random 4-qubit case: within 1e-5 of
    max|v| of JAX's float64 numpy result."""
    want, _ = _jax('random_circuit_reconstruction-4-15')
    _same(_port('random_circuit_reconstruction-4-15', backend,
                float_type='float32'), want, F32)


@pytest.mark.parametrize('backend', BACKENDS)
def test_original_checks_hold_on_the_port(backend):
    """The original tests' own checks, on the port's results: reference
    values, the dense reconstruction ``matrix(C + P + C^-1)``, one string
    for a Clifford circuit, branching for T gates, the same dict with a
    batch cap of 2 (the depth-first split) as without one."""
    db = _port('reference_docstring_example', backend)
    np.testing.assert_allclose(db['IZ'], 0.7938926261462365, atol=1e-6)
    np.testing.assert_allclose(db['XY'], -0.40450849718747345, atol=1e-6)
    for case, n in (('reference_docstring_example', 2),
                    ('random_circuit_reconstruction-3-10', 3),
                    ('random_circuit_reconstruction-4-15', 4),
                    ('t_gates_branch', 1)):
        c, p = CASES[case][0](T)
        np.testing.assert_allclose(
            _reconstruct(T, _port(case, backend), n),
            _oracle(tutils, c, p), atol=1e-5)
    c, _ = _dict_input(T)
    G = T.Gate
    expected = 0.5 * _oracle(tutils, c, T.Circuit([G('Z', [0]),
                                                   G('I', [1])])) + \
        0.5 * _oracle(tutils, c, T.Circuit([G('I', [0]), G('Z', [1])]))
    np.testing.assert_allclose(
        _reconstruct(T, _port('dict_pauli_string_input', backend), 2),
        expected, atol=1e-6)
    (ph,) = _port('clifford_only_does_not_branch', backend).values()
    np.testing.assert_allclose(abs(ph), 1, atol=1e-6)
    assert len(_port('t_gates_branch', backend)) > 1
    _same(_port('max_branches_splitting', backend),
          _port('max_branches_splitting', backend,
                max_breadth_first_branches=2**18), F64)
    # a frontier that does outgrow the cap of 2
    small, info = _port('random_circuit_reconstruction-4-15', backend,
                        max_breadth_first_branches=2, return_info=True)
    _same(small, _port('random_circuit_reconstruction-4-15', backend), F64)
    assert info['largest_batch'] > 2


@pytest.mark.parametrize('backend', BACKENDS)
def test_expectation_value_reference_example(backend):
    def build(pkg):
        return (pkg.Circuit([pkg.Gate('X', qubits=[0])**1.2,
                             pkg.Gate('ISWAP', qubits=[0, 1])**2.3]),
                pkg.Circuit([pkg.Gate('Z', qubits=[1])]))
    want = jcl.expectation_value(*build(J), initial_state='11',
                                 float_type='float64')
    got = tcl.expectation_value(*build(T), initial_state='11',
                                float_type='float64', **_kw(backend))
    assert abs(got - want) <= F64
    np.testing.assert_allclose(got, -0.6271482580325515, atol=1e-6)


@pytest.mark.parametrize('backend', BACKENDS)
@pytest.mark.parametrize('initial', ['00', '1+', '-0'])
def test_expectation_value_vs_dense(initial, backend):
    """``tests/test_clifford.py``'s dense cross-check: against JAX's
    expectation value and the complex128 state vector of the port."""
    from hybridq_tpu_torch.simulation import simulate

    def build(pkg):
        np.random.seed(11)
        c = _rqc(pkg, 2, 10, indexes=[0, 1]) + _ids(2)(pkg)
        return c, pkg.Circuit([pkg.Gate('Z', [0]), pkg.Gate('X', [1])])
    want = jcl.expectation_value(*build(J), initial_state=initial,
                                 float_type='float64',
                                 remove_id_gates=False)
    c, op = build(T)
    got = tcl.expectation_value(c, op, initial_state=initial,
                                float_type='float64', remove_id_gates=False,
                                **_kw(backend))
    assert abs(got - want) <= F64
    psi = np.asarray(simulate(c, initial_state=initial,
                              complex_type='complex128',
                              remove_id_gates=False, device='cpu')).ravel()
    O = np.kron(T.Gate('Z').matrix(), T.Gate('X').matrix())
    np.testing.assert_allclose(got, np.real(psi.conj() @ O @ psi),
                               atol=1e-5)


@pytest.mark.parametrize('backend', BACKENDS)
def test_dm_simulate_clifford(backend):
    """``dm.simulate(optimize='clifford')`` delegates to the engine, in
    both packages alike."""
    def build(pkg):
        np.random.seed(3)
        return _rqc(pkg, 3, 12, indexes=[0, 1, 2])
    want = jdm.simulate(build(J), initial_state='ZIX', optimize='clifford',
                        float_type='float64')
    got = tdm.simulate(build(T), initial_state='ZIX', optimize='clifford',
                       float_type='float64', **_kw(backend))
    _same(got, want, F64)
    with pytest.raises(ValueError, match='final_state'):
        tdm.simulate(build(T), initial_state='ZIX', final_state='ZZZ',
                     optimize='clifford', **_kw(backend))


def test_parallel_workers_match_serial():
    """``parallel=2`` (two worker processes, numpy backend) gives the
    serial dict, and the torch backend ignores it."""
    want, _ = _jax('random_circuit_reconstruction-4-15')
    db, info = _port('random_circuit_reconstruction-4-15', 'numpy',
                     parallel=2, return_info=True)
    _same(db, want, F64)
    assert info['n_explored_branches'] > 0
    _same(_port('random_circuit_reconstruction-4-15', 'torch', parallel=2),
          want, F64)


def test_use_mpi_runs_and_foreign_options_raise():
    """``use_mpi=True`` on one process runs JAX's frontier split and
    merge, and gives JAX's dict for both backends; ``backend='jax'``
    names the port's ``'torch'``."""
    build, kw = CASES['random_circuit_reconstruction-4-15']
    c, p = build(J)
    want = jcl.update_pauli_string(c, p, float_type='float64',
                                   use_mpi=True, **kw)
    for backend in BACKENDS:
        _same(_port('random_circuit_reconstruction-4-15', backend,
                    use_mpi=True), want, F64)
    c, p = _t_gates(T)
    with pytest.raises(ValueError, match="'torch'"):
        tcl.update_pauli_string(c, p, backend='jax')
    with pytest.raises(ValueError, match='backend'):
        tcl.update_pauli_string(c, p, backend='cupy')


def test_torch_merge_and_expand_against_numpy():
    """The torch backend's steps on one batch: the expansion gives the
    numpy backend's branches (as a set, with their phases) and the merge
    its unique rows and summed phases."""
    import torch

    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=(300, 5)).astype(np.uint8)
    phases = rng.standard_normal(300)
    U = np.asarray(T.Gate('T').matrix(), dtype=complex)
    U = np.kron(U, np.asarray(T.Gate('H').matrix()))
    rows, k = tcl._pauli_rows(U, 1e-8)
    gate = ((3, 1), rows, k)
    want = tcl._merge_batch(*tcl._apply_gate_batch(codes, phases, gate,
                                                   1e-12))
    tg = tcl._torch_gate(gate, torch.float64, 'cpu')
    got = tcl._merge_batch_torch(*tcl._apply_gate_batch_torch(
        torch.as_tensor(codes), torch.as_tensor(phases), tg, 1e-12))
    assert got[0].dtype == torch.uint8
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_allclose(got[1].numpy(), want[1], atol=1e-12)
