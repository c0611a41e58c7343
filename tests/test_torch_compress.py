"""The port's ``circuit.utils.compress`` against the JAX package's, block for
block, and the block matrices that ``_compress`` keeps for the engines.

Each case builds the same circuit in both packages from one numpy seed and
compares the blocks by the positions of their gates in the input circuit
and by each gate's kind, name and qubits: Sycamore-pattern circuits at 12
qubits and 14 cycles, with and without ``simplify``, random circuits of
``extras.random`` with mixed qubit labels, the density-matrix cell's
doubled circuit at 4 qubits with its depolarizing channels, blocks of at
most 2 and 4 qubits, a projection kept apart by ``skip_compression``,
``exclude_qubits``, ``skip_commutation``, matrix commutation off and a gate
wider than ``max_n_qubits_matrix``.  Each matrix ``_compress`` returns is
its block's ``to_matrix_gate`` in complex128 to 1e-12 and in complex64 to
1e-6, and it is ``None`` exactly where a block has no matrix to keep.  On
the cells' kind of circuit the engines build no block matrix themselves.
"""

import numpy as np
import pytest

import hybridq_tpu as J
import hybridq_tpu_torch as T
from hybridq_tpu.circuit import utils as jutils
from hybridq_tpu.dm import simulation as jdm_simulation
from hybridq_tpu.dm.circuit import Circuit as JSuperCircuit
from hybridq_tpu.gate import FunctionalGate as JFunctional
from hybridq_tpu_torch.circuit import utils as tutils
from hybridq_tpu_torch.dm import simulation as tdm_simulation
from hybridq_tpu_torch.dm.circuit import Circuit as TSuperCircuit
from hybridq_tpu_torch.gate import FunctionalGate as TFunctional
from hybridq_tpu_torch.simulation import simulate
from hybridq_tpu_torch.simulation.simulation import _block_items
from tests.test_torch_dm_noisy import _case, _jax_case
from tests.test_torch_simplify import _random_unitary, _rqc, _sycamore


def _simplified(pkg, rows, cols, cycles, seed):
    u = jutils if pkg is J else tutils
    return u.simplify(_sycamore(pkg, rows, cols, cycles, seed))


def _doubled(pkg, key):
    """The density-matrix cell's circuit ``key`` at 4 qubits, lowered to
    the doubled pure-state circuit."""
    if pkg is J:
        return jdm_simulation._convert(JSuperCircuit(_jax_case(4, key)))
    return tdm_simulation._convert(TSuperCircuit(_case(4, key)[1]))


def _with_projections(pkg):
    """A Sycamore circuit with a projection on one qubit and one on two."""
    gates = list(_sycamore(pkg, 2, 4, 6, 41))
    gates[20:20] = [pkg.Projection('0', qubits=[2])]
    gates[50:50] = [pkg.Projection('01', qubits=[5, 6])]
    return pkg.Circuit(gates)


def _with_wide_gate(pkg):
    """A Sycamore circuit with a 3-qubit gate, wider than a matrix limit of
    2, and a 2-qubit one."""
    rng = np.random.default_rng(51)
    gates = list(_sycamore(pkg, 2, 4, 4, 52))
    gates[12:12] = [pkg.Gate('MATRIX', [1, 2, 5], U=_random_unitary(3, rng))]
    gates[30:30] = [pkg.Gate('MATRIX', [0, 4], U=_random_unitary(2, rng))]
    return pkg.Circuit(gates)


def _skip_functional(pkg):
    return dict(skip_compression=[JFunctional if pkg is J else TFunctional])


# name -> (build(pkg) -> circuit, kwargs(pkg) -> dict)
CASES = {
    'sycamore-12-k4': (lambda p: _sycamore(p, 3, 4, 14, 1),
                       lambda p: dict(max_n_qubits=4)),
    'sycamore-12-k2': (lambda p: _sycamore(p, 3, 4, 14, 2),
                       lambda p: dict(max_n_qubits=2)),
    'sycamore-12-simplified-k4': (lambda p: _simplified(p, 3, 4, 14, 3),
                                  lambda p: dict(max_n_qubits=4)),
    'sycamore-12-simplified-k2': (lambda p: _simplified(p, 3, 4, 14, 4),
                                  lambda p: dict(max_n_qubits=2)),
    'random-labels-k4': (lambda p: _rqc(p, 8, 80, 5,
                                        use_random_indexes=True),
                         lambda p: dict(max_n_qubits=4)),
    'random-labels-k2': (lambda p: _rqc(p, 10, 80, 6,
                                        use_random_indexes=True),
                         lambda p: dict(max_n_qubits=2)),
    'random-nonunitary-k3': (lambda p: _rqc(p, 8, 60, 7,
                                            use_unitary_only=False),
                             lambda p: dict(max_n_qubits=3)),
    'dm-doubled-4-k4': (lambda p: _doubled(p, [0, 1, 0]),
                        lambda p: dict(max_n_qubits=4)),
    'dm-doubled-4-k2': (lambda p: _doubled(p, [3, 1, 0]),
                        lambda p: dict(max_n_qubits=2)),
    'projections-skipped': (_with_projections,
                            lambda p: dict(max_n_qubits=4,
                                           **_skip_functional(p))),
    'projections-not-skipped': (_with_projections,
                                lambda p: dict(max_n_qubits=3)),
    'exclude-qubits': (lambda p: _sycamore(p, 3, 4, 8, 8),
                       lambda p: dict(max_n_qubits=4,
                                      exclude_qubits=[0, 5])),
    'skip-commutation': (lambda p: _sycamore(p, 3, 4, 8, 9),
                         lambda p: dict(max_n_qubits=4,
                                        skip_commutation=['FSIM'])),
    'no-matrix-commutation': (lambda p: _sycamore(p, 3, 4, 8, 10),
                              lambda p: dict(max_n_qubits=4,
                                             use_matrix_commutation=False)),
    'wider-than-matrix-limit': (_with_wide_gate,
                                lambda p: dict(max_n_qubits=3,
                                               max_n_qubits_matrix=2)),
    'no-compression': (lambda p: _sycamore(p, 2, 3, 3, 11),
                       lambda p: dict(max_n_qubits=0)),
}


def _positions(blocks, circuit):
    """Each block as the positions of its gates in ``circuit`` (compress
    returns the caller's gates, not copies)."""
    at = {id(g): i for i, g in enumerate(circuit)}
    return [[at[id(g)] for g in b] for b in blocks]


def _describe(blocks):
    return [[(type(g).__name__, g.name, g.qubits) for g in b]
            for b in blocks]


def _has_matrix(block, kw) -> bool:
    """Whether ``_compress`` keeps a matrix for ``block``: matrix
    commutation on, every gate with a matrix, and the block no wider than
    ``max_n_qubits_matrix``."""
    if kw.get('max_n_qubits', 2) <= 0 or \
            not kw.get('use_matrix_commutation', True):
        return False
    if len(block.all_qubits) > kw.get('max_n_qubits_matrix', 10):
        return False
    try:
        for g in block:
            g.matrix()
    except Exception:
        return False
    return True


@pytest.mark.parametrize('case', list(CASES))
def test_compress_matches_jax(case):
    build, kwargs = CASES[case]
    jc = build(J)
    want = jutils.compress(jc, **kwargs(J))
    tc = build(T)
    kw = kwargs(T)
    got = tutils.compress(tc, **kw)
    blocks, matrices = tutils._compress(tc, **kw)
    assert _positions(got, tc) == _positions(want, jc)
    assert _describe(got) == _describe(want)
    assert _positions(blocks, tc) == _positions(got, tc)
    assert len(matrices) == len(blocks)
    for b, M in zip(blocks, matrices):
        if not _has_matrix(b, kw):
            assert M is None
            continue
        U, qubits = M
        assert U.dtype == np.complex128
        assert list(qubits) == b.all_qubits
        want128 = tutils.to_matrix_gate(b, complex_type='complex128')
        np.testing.assert_allclose(U, want128.matrix(), rtol=0, atol=1e-12)
        want64 = tutils.to_matrix_gate(b, complex_type='complex64')
        assert np.abs(U.astype(np.complex64) -
                      want64.matrix()).max() <= 1e-6


@pytest.mark.parametrize('build', [
    lambda: _sycamore(T, 3, 4, 14, 12),
    lambda: _simplified(T, 3, 4, 14, 13),
    lambda: tutils.simplify(_doubled(T, [5, 1, 0])),
], ids=['sycamore-12', 'sycamore-12-simplified', 'dm-doubled-4'])
def test_engines_launch_the_compressed_matrices(build):
    """On the cells' kind of circuit every block of more than one gate is
    launched with the matrix ``compress`` built: the items are the parent
    engine's (``to_matrix_gate`` a block) to 1e-6, and no block matrix is
    built again."""
    c = build()
    qubit_index = {q: i for i, q in enumerate(c.all_qubits)}
    tutils.reset_counts()
    blocks, matrices = tutils._compress(c, 4, skip_compression=[TFunctional])
    n = tutils.counts()
    assert n['compress_tests'] > 0
    assert n['block_matrices_reused'] == n['block_matrices_built'] == 0
    c64 = np.dtype('complex64')
    items = _block_items(blocks, c64, qubit_index, matrices)
    n = tutils.counts()
    multi = sum(len(b) > 1 for b in blocks)
    assert multi > 0
    assert n['block_matrices_built'] == 0
    assert n['block_matrices_reused'] == multi
    built = _block_items(blocks, c64, qubit_index)
    assert tutils.counts()['block_matrices_built'] == multi
    assert len(items) == len(built)
    for (U, qs), (V, ws) in zip(items, built):
        assert qs == ws
        assert np.abs(U - V).max() <= 1e-6


def test_simulate_builds_no_block_matrix():
    """``simulate``'s straight engine on a 12-qubit Sycamore circuit launches
    every multi-gate block with ``compress``'s matrix, and its state is the
    one the blocks' ``to_matrix_gate`` matrices give to complex64
    rounding."""
    c = _sycamore(T, 3, 4, 14, 14)
    tutils.reset_counts()
    got = simulate(c, initial_state='0', optimize='evolution-indexed',
                     simplify=False, device='cpu')
    n = tutils.counts()
    assert n['block_matrices_built'] == 0 and n['block_matrices_reused'] > 0
    want = simulate(c, initial_state='0', optimize='evolution-einsum',
                      simplify=False, complex_type='complex128',
                      device='cpu')
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
