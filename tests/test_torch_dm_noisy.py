"""The port's ``dm.simulate`` on the benchmark's noisy Sycamore circuits.

The circuits are the configuration ``sycamore-dm16-m14``'s
(``benchmark/``, read only): Arute et al.'s m = 14 circuits on small
patches of the layout, with a ``GlobalDepolarizingChannel`` after every
gate at the configuration's Pauli errors.  The port runs them on the host
(``device='cpu'``) against the benchmark's plain density-matrix reference
(``benchmark/reference/densitymatrix.py``: gates as U rho U^dagger,
channels by their definition, no superoperator) and against the JAX
package's ``dm.simulate``; the reference's channel is held to the Kraus
sum of its Paulis; and the lowering's spans and counters are read.
"""

import json
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import hybridq_tpu as J
from hybridq_tpu import dm as jdm
from hybridq_tpu import noise as jnoise
from hybridq_tpu_torch import dm as tdm
from hybridq_tpu_torch import noise as tnoise
from hybridq_tpu_torch.dm import simulation as tdm_simulation
from hybridq_tpu_torch.dm.circuit import Circuit as SuperCircuit

BENCH = Path(__file__).resolve().parents[1] / 'benchmark'
CONFIG = json.loads((BENCH / 'configs' / 'sycamore-dm16-m14.json').read_text())
# Both sides exact complex128 products in another order: 1e-10 of the
# rms leaves room over the 4e-13 they read at 8 qubits.
ATOL_C128 = 1e-10
# Both sides round to float32 over some 900 doubled operations (the
# port's lowered superoperators and 4- to 6-qubit blocks; the reference's
# products and channel passes): up to 7.5e-6 of the rms at 8 qubits over
# circuits [s, 1, 0], s = 0..5, on either engine.
ATOL_C64 = 1e-5
PAULIS = (np.eye(2), np.array([[0, 1], [1, 0]]),
          np.array([[0, -1j], [1j, 0]]), np.diag([1.0, -1.0]))


def _bench():
    """``(circuits, system, reference)`` of ``benchmark/``."""
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    from hqbench import circuits, system
    from reference import densitymatrix

    return circuits, system, densitymatrix


def _noise():
    _, _, reference = _bench()
    e = CONFIG['noise']
    return {1: reference.depolarizing_p(e['one_qubit_pauli_error'], 1),
            2: reference.depolarizing_p(e['two_qubit_pauli_error'], 2)}


def _case(n, key):
    """The generator's gates of circuit ``key`` on the ``n``-qubit patch,
    and the port's noisy circuit of them."""
    circuits, system, _ = _bench()
    gates = circuits.rqc(n, CONFIG['cycles'], key, CONFIG['pattern'])
    noise = _noise()
    noisy = []
    for g in system.circuit(gates):
        noisy += [g, tnoise.GlobalDepolarizingChannel(g.qubits,
                                                      noise[len(g.qubits)])]
    return gates, noisy


def _gap(got, want):
    """max |got - want| over the rms of ``want``."""
    got, want = np.ravel(got), np.ravel(want)
    return np.abs(got - want).max() / np.sqrt(np.mean(np.abs(want) ** 2))


@pytest.mark.parametrize('key', [[0, 1, 0], [1, 1, 0]])
@pytest.mark.parametrize('simplify', [True, False])
@pytest.mark.parametrize('n', [4, 6, 8])
def test_complex128_matches_reference(n, simplify, key):
    _, _, reference = _bench()
    gates, noisy = _case(n, key)
    want = reference.evolve(gates, n, _noise(), 'cpu',
                            dtype=torch.complex128).numpy()
    got = tdm.simulate(noisy, initial_state='0', device='cpu',
                       complex_type='complex128', simplify=simplify)
    assert _gap(got, want) < ATOL_C128
    assert abs(np.trace(np.reshape(got, (2 ** n, 2 ** n))) - 1) < 1e-12


@pytest.mark.parametrize('key', [[0, 1, 0], [1, 1, 0]])
@pytest.mark.parametrize('simplify', [True, False])
@pytest.mark.parametrize('n', [4, 6, 8])
def test_complex64_straight_engine_matches_reference(n, simplify, key):
    """complex64 through ``'evolution-indexed'``, the card's route of
    ``'evolution'`` with the plain version of its kernel, against the
    reference in complex64, as the cell's check compares them."""
    _, _, reference = _bench()
    gates, noisy = _case(n, key)
    want = reference.evolve(gates, n, _noise(), 'cpu').numpy()
    got, info = tdm.simulate(noisy, initial_state='0', device='cpu',
                             optimize='evolution-indexed',
                             simplify=simplify, return_info=True,
                             return_numpy_array=False)
    assert info['engine'] == 'indexed' and got.dtype == torch.complex64
    assert _gap(got.reshape(-1).numpy(), want) < ATOL_C64


def _jax_case(n, key):
    circuits, _, _ = _bench()
    noise = _noise()
    gates = circuits.rqc(n, CONFIG['cycles'], key, CONFIG['pattern'])
    out = []
    for name, qubits, params in gates:
        g = J.Gate(name, qubits=list(qubits), params=list(params)) \
            if params else J.Gate(name, qubits=list(qubits))
        out += [g, jnoise.GlobalDepolarizingChannel(list(qubits),
                                                    noise[len(qubits)])]
    return out


@pytest.mark.parametrize('simplify', [True, False])
def test_matches_jax(simplify):
    n, key = 6, [2, 1, 0]
    want = jdm.simulate(_jax_case(n, key), initial_state='0',
                        complex_type='complex128', simplify=simplify)
    got = tdm.simulate(_case(n, key)[1], initial_state='0', device='cpu',
                       complex_type='complex128', simplify=simplify)
    assert _gap(got, want) < ATOL_C128


def _full(m, qubits, n):
    """``m`` on ``qubits`` as a 2^n x 2^n matrix, qubit 0 the most
    significant bit."""
    k = len(qubits)
    op = np.tensordot(m.reshape((2,) * 2 * k),
                      np.eye(2 ** n).reshape((2,) * 2 * n),
                      (list(range(k, 2 * k)), list(qubits)))
    return np.moveaxis(op, list(range(k)), list(qubits)).reshape(
        2 ** n, 2 ** n)


def _kraus(rho, qubits, p, n):
    """Sum over the Paulis P on ``qubits`` of s_P P rho P, with s_I =
    1 - p + p/d^2 and s_P = p/d^2 otherwise."""
    k = len(qubits)
    out = np.zeros_like(rho)
    for x in range(4 ** k):
        m = np.ones((1, 1))
        for j in range(k):
            m = np.kron(m, PAULIS[x >> 2 * (k - 1 - j) & 3])
        op = _full(m, qubits, n)
        out += ((1 - p if x == 0 else 0) + p / 4 ** k) * op @ rho @ op.T.conj()
    return out


@pytest.mark.parametrize('p', [0.0066133, 0.3])
@pytest.mark.parametrize('qubits', [(1,), (0, 2)])
def test_reference_channel_is_the_kraus_sum(qubits, p):
    """At n = 3 on a random density matrix (no symmetry to hide a wrong
    axis): the reference's channel against the Kraus sum of its Paulis,
    and the port's channel's own weights and Kraus operators against the
    same sum."""
    _, _, reference = _bench()
    n = 3
    rng = np.random.default_rng(len(qubits) + int(100 * p))
    a = rng.normal(size=(8, 8)) + 1j * rng.normal(size=(8, 8))
    rho = a @ a.conj().T
    rho /= np.trace(rho)
    want = _kraus(rho, qubits, p, n)
    got = torch.as_tensor(rho.reshape(-1).copy())
    reference.depolarize(got, n, qubits, p)
    assert np.abs(got.numpy().reshape(8, 8) - want).max() < 1e-14
    ch = tnoise.GlobalDepolarizingChannel(qubits, p)
    port = sum(s * _full(m, qubits, n) @ rho @ _full(m, qubits, n).T.conj()
               for s, m in zip(ch.s, ch.LMatrices))
    assert np.abs(port - want).max() < 1e-14


def _spans(prof):
    """Names of the program's ``hq.`` spans in a profile, in order."""
    return [e.name for e in sorted(prof.events(),
                                   key=lambda e: e.time_range.start)
            if e.name.startswith('hq.')]


def test_spans_once_per_call_under_a_profiler():
    _, noisy = _case(4, [3, 1, 0])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            tdm.simulate(noisy, initial_state='0', device='cpu')
    names = _spans(prof)
    got = Counter(names)
    assert got['hq.dm.simulate'] == 2 and got['hq.dm.lower'] == 2
    assert got['hq.simulate'] == 2
    # each call opens its own span, lowers, then simulates
    calls = [names[i:i + 3] for i, x in enumerate(names)
             if x == 'hq.dm.simulate']
    assert all(c == ['hq.dm.simulate', 'hq.dm.lower', 'hq.simulate']
               for c in calls)
    by = {e.name: e for e in prof.events() if e.name.startswith('hq.')}
    outer, inner = by['hq.dm.simulate'].time_range, \
        by['hq.dm.lower'].time_range
    assert outer.start <= inner.start and inner.end <= outer.end


def test_no_span_without_a_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no profiler")
    monkeypatch.setattr(torch.profiler, 'record_function', refuse)
    monkeypatch.setattr(torch.autograd.profiler, 'record_function', refuse)
    _, noisy = _case(4, [3, 1, 0])
    rho = tdm.simulate(noisy, initial_state='0', device='cpu')
    assert abs(np.trace(np.reshape(rho, (16, 16))) - 1) < 1e-5


def test_counts_of_the_cells_circuit():
    """The cell's circuit ``[0, 1, 0]`` at 16 qubits, lowered without
    evolving: 299 gates doubled and 299 channels lowered, 897 gates on
    the 32 doubled qubits."""
    _, noisy = _case(16, [0, 1, 0])
    tdm.reset_counts()
    doubled = tdm_simulation._convert(SuperCircuit(noisy))
    assert tdm.counts() == {'gates': 299, 'channels': 299}
    assert len(doubled) == 897 and len(doubled.all_qubits) == 32
    tdm.reset_counts()
    assert tdm.counts() == {'gates': 0, 'channels': 0}


def test_counts_of_a_call():
    gates, noisy = _case(4, [4, 1, 0])
    tdm.reset_counts()
    tdm.simulate(noisy, initial_state='0', device='cpu')
    assert tdm.counts() == {'gates': len(gates), 'channels': len(gates)}


@pytest.mark.parametrize('key', [[0, 1, 0], [7, 1, 0]])
@pytest.mark.parametrize('simplify, launches', [(True, 51), (False, 56)])
def test_cell_schedule(key, simplify, launches):
    """The cell's circuits at 16 qubits through the lowering, simulate's
    front end and the pairing, without evolving: every launch's block
    spans both halves of the doubled register (row bits >= 16, column
    bits < 16 in the flat index), 51 launches with the default call."""
    from hybridq_tpu_torch.circuit import utils
    from hybridq_tpu_torch.gate import FunctionalGate
    from hybridq_tpu_torch.simulation.kernels import pair_matrix_gates
    from hybridq_tpu_torch.simulation.simulation import (_block_items,
                                                         _preprocess_circuit)

    _, noisy = _case(16, key)
    c = tdm_simulation._convert(SuperCircuit(noisy))
    c, qubits, _, _ = _preprocess_circuit(c, '0' * 32, None, simplify, True,
                                          1e-8, False, False, None)
    blocks = utils.compress(c, 4, skip_compression=[FunctionalGate])
    items = pair_matrix_gates(
        _block_items(blocks, np.dtype('complex64'),
                     {q: i for i, q in enumerate(qubits)}), 32)
    assert len(items) == launches
    # axis i is flat bit 31 - i: rows are axes 0..15, columns 16..31
    assert all(min(qs) < 16 <= max(qs) for _, qs in items)
