"""The port's ``simulate`` / ``expectation_value`` against the JAX package.

Each circuit is built twice from one numpy seed, once with each package's
own copy of ``get_rqc``, so both sides run the same gates.
``'evolution-fused'`` runs the port's straight engine on the plain
version of ``apply_bits`` here, and JAX's fused engine on its Pallas
kernels in interpret mode.  Tolerance: 5e-5 absolute on
the amplitudes (the JAX suite's bar for the fused engine,
``tests/test_fused_evolver.py``); 1e-5 where both sides run plain f32
arithmetic on a unit-norm state.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import hybridq_tpu as J
import hybridq_tpu_torch as T
from hybridq_tpu.extras.random import get_rqc as j_rqc
from hybridq_tpu.gate import MatrixGate as JMatrixGate
from hybridq_tpu.simulation import expectation_value as j_expect
from hybridq_tpu.simulation import simulate as j_simulate
from hybridq_tpu.simulation.fused_evolver import FusedEvolver as JEvolver
from hybridq_tpu_torch.convert import (circuit_from_matrices,
                                       state_from_reference,
                                       state_to_reference)
from hybridq_tpu_torch.extras.random import get_rqc as t_rqc
from hybridq_tpu_torch.simulation import expectation_value as t_expect
from hybridq_tpu_torch.simulation import simulate as t_simulate
from hybridq_tpu_torch.simulation.kernels import IndexedEvolver as TIndexed

ATOL_FUSED = 5e-5
ATOL = 1e-5


def _both_rqc(n, n_gates, seed, h_layer=True):
    """The same random circuit in each package (H layer first, so every
    qubit is active)."""
    out = []
    for pkg, rqc in ((J, j_rqc), (T, t_rqc)):
        np.random.seed(seed)
        c = rqc(n, n_gates, indexes=list(range(n)))
        if h_layer:
            c = pkg.Circuit([pkg.Gate('H', qubits=[q])
                             for q in range(n)]) + c
        out.append(c)
    return out


def _rand_u(k, rng):
    m = rng.standard_normal((2**k, 2**k)) + \
        1j * rng.standard_normal((2**k, 2**k))
    return np.linalg.qr(m)[0]


def _fused_gate_set(kind, n, rng):
    """Eight gates that take the JAX fused engine down one of its
    routes: a 4-qubit gate on four lane bits (flat bits 0-6) first, which
    it must evict; one on four top-row bits first, which it parks; or
    random 1-4 qubit gates alone."""
    first = {'evict': [rng.choice(range(n - 7, n), 4, replace=False)],
             'park': [rng.permutation(4)], 'random': []}[kind]
    gates = [(_rand_u(4, rng), tuple(int(q) for q in qs)) for qs in first]
    while len(gates) < 8:
        k = int(rng.integers(1, 5))
        qs = tuple(int(q) for q in rng.choice(n, k, replace=False))
        gates.append((_rand_u(k, rng), qs))
    return gates


@pytest.mark.parametrize('gate_set', ['evict', 'park', 'random'])
@pytest.mark.parametrize('n', [16, 17])
def test_simulate_fused_matches_jax(n, gate_set, seed):
    """The port's 'evolution-fused' (the straight engine) against JAX's
    fused engine, after an H layer."""
    gates = _fused_gate_set(gate_set, n, np.random.default_rng(seed))
    cj = J.Circuit([J.Gate('H', qubits=[q]) for q in range(n)] +
                   [JMatrixGate(U).on(list(qs)) for U, qs in gates])
    ct = T.Circuit([T.Gate('H', qubits=[q]) for q in range(n)]) + \
        circuit_from_matrices(gates)
    want = j_simulate(cj, optimize='evolution-fused', initial_state='0' * n,
                      fused_interpret=True)
    got, info = t_simulate(ct, optimize='evolution-fused',
                           initial_state='0' * n, device='cpu',
                           return_info=True)
    assert info['engine'] == 'indexed'
    assert got.shape == (2,) * n and got.dtype == np.complex64
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL_FUSED)


def test_simulate_fused_needs_min_qubits(seed):
    """Below 14 qubits 'evolution-fused' raises, as JAX's engine does;
    ``fused_engine=True`` falls through to the per-gate path."""
    n = 13
    cj, ct = _both_rqc(n, 10, seed)
    with pytest.raises(ValueError):
        j_simulate(cj, optimize='evolution-fused', initial_state='0' * n,
                   fused_interpret=True)
    with pytest.raises(ValueError, match='evolution-fused'):
        t_simulate(ct, optimize='evolution-fused', initial_state='0' * n,
                   device='cpu')
    _, info = t_simulate(ct, initial_state='0' * n, device='cpu',
                         fused_engine=True, return_info=True)
    assert info['engine'] == 'torch'


def test_fused_engine_runs_the_straight_engine(seed):
    """``fused_engine=True`` from 14 qubits is 'evolution-fused': the
    same engine, the same amplitudes bit for bit."""
    n = 14
    _, ct = _both_rqc(n, 20, seed)
    a, info_a = t_simulate(ct, optimize='evolution-fused',
                           initial_state='0' * n, device='cpu',
                           return_info=True)
    b, info_b = t_simulate(ct, initial_state='0' * n, device='cpu',
                           fused_engine=True, return_info=True)
    assert info_a['engine'] == info_b['engine'] == 'indexed'
    np.testing.assert_array_equal(a, b)


def test_simulate_returns_tensor_on_request(seed):
    n = 6
    _, ct = _both_rqc(n, 10, seed)
    psi = t_simulate(ct, initial_state='0' * n, device='cpu',
                     return_numpy_array=False)
    assert isinstance(psi, torch.Tensor) and psi.dtype == torch.complex64
    psi2, info = t_simulate(ct, initial_state='0' * n, device='cpu',
                            return_info=True)
    np.testing.assert_allclose(psi.numpy(), psi2, atol=ATOL)
    assert info['runtime (s)'] >= 0


@pytest.mark.parametrize('n', [4, 7, 10])
def test_simulate_evolution_matches_jax(n, seed):
    cj, ct = _both_rqc(n, 4 * n, seed)
    want = j_simulate(cj, optimize='evolution', initial_state='+' * n)
    got = t_simulate(ct, optimize='evolution', initial_state='+' * n,
                     device='cpu')
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


def test_simulate_with_measure_and_projection(seed):
    """FunctionalGates round-trip through the host.  The measured qubit
    is in |1> with certainty, so both sides collapse alike."""
    n = 8
    out = []
    for pkg, rqc in ((J, j_rqc), (T, t_rqc)):
        np.random.seed(seed)
        body = rqc(n - 1, 20, indexes=list(range(1, n)))
        c = pkg.Circuit([pkg.Gate('X', qubits=[0])] +
                        [pkg.Gate('H', qubits=[q]) for q in range(1, n)])
        c += body
        c.append(pkg.Measure(qubits=[0]))
        c.append(pkg.Projection('0', qubits=[3]))
        c += rqc(n, 6, indexes=list(range(n)))
        out.append(c)
    cj, ct = out
    np.random.seed(seed)
    want = j_simulate(cj, optimize='evolution', initial_state='0' * n)
    np.random.seed(seed)
    got = t_simulate(ct, optimize='evolution', initial_state='0' * n,
                     device='cpu')
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


def test_simulate_fused_across_a_projection(seed):
    """'evolution-fused' gathers the state, projects on the host and
    goes on with a new segment of blocks.  Held against JAX's traced
    engine: JAX's own fused engine keys its operand memo by block index
    alone and reuses the first segment's operands after the flush."""
    n = 14
    out = []
    for pkg, rqc in ((J, j_rqc), (T, t_rqc)):
        np.random.seed(seed)
        c = pkg.Circuit([pkg.Gate('H', qubits=[q]) for q in range(n)])
        c += rqc(n, 10, indexes=list(range(n)))
        c.append(pkg.Projection('0', qubits=[0]))
        c += rqc(n, 10, indexes=list(range(n)))
        out.append(c)
    want = j_simulate(out[0], optimize='evolution', initial_state='0' * n)
    got = t_simulate(out[1], optimize='evolution-fused',
                     initial_state='0' * n, device='cpu')
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


def test_split_merge_complex_match_jax(seed):
    from hybridq_tpu.simulation import statevector as jsv
    from hybridq_tpu_torch.simulation import statevector as tsv

    rng = np.random.default_rng(seed)
    psi = rng.standard_normal((2,) * 5) + 1j * rng.standard_normal((2,) * 5)
    for want, got in zip(jsv.split_complex(psi), tsv.split_complex(psi)):
        np.testing.assert_array_equal(got, want)
    re, im = tsv.split_complex(psi)
    np.testing.assert_array_equal(tsv.merge_complex(re, im),
                                  jsv.merge_complex(re, im))


def test_expectation_value_matches_jax(seed):
    n = 6
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal((2,) * n) + 1j * rng.standard_normal((2,) * n)
    psi = (psi / np.linalg.norm(psi)).astype(np.complex64)
    order = [int(q) for q in rng.permutation(n)]
    ops = []
    for pkg in (J, T):
        ops.append([pkg.Gate('X', qubits=[order[0]]),
                    pkg.Gate('Z', qubits=[order[2]]),
                    pkg.Gate('CZ', qubits=[order[1], order[4]])])
    want = j_expect(psi, ops[0], order)
    got = t_expect(psi, ops[1], order, device='cpu')
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_state_from_reference_round_trip(seed):
    """Evolve some gates in JAX's fused engine; its container and slot
    map go to the port and back unchanged.  Flushed, the container goes
    on in the port's ``IndexedEvolver``; compare with an all-JAX run."""
    n = 15
    rng = np.random.default_rng(seed)
    gates = []
    for _ in range(6):
        k = int(rng.integers(1, 4))
        qs = tuple(int(q) for q in rng.choice(n, k, replace=False))
        gates.append((_rand_u(k, rng), qs))

    ev_j = JEvolver(n, interpret=True)
    s_j = ev_j.prepare_state('0' * n)
    for U, qs in gates[:3]:
        s_j = ev_j.apply_gate(s_j, U, qs)
    mid = np.asarray(s_j)

    state, phys, _ = state_from_reference(mid, ev_j.phys, device='cpu')
    back, phys_back = state_to_reference(state, phys)
    np.testing.assert_array_equal(back, mid)
    assert phys_back == ev_j.phys

    s_j = ev_j.flush(s_j)
    state, phys, _ = state_from_reference(np.asarray(s_j), device='cpu')
    assert phys == ev_j.phys == list(range(n))
    ev_t = TIndexed(n, device='cpu')
    for U, qs in gates[3:]:
        state = ev_t.apply_gate(state, U, qs)
        s_j = ev_j.apply_gate(jnp.asarray(s_j), U, qs)
    got = ev_t.gather(state).reshape(-1).numpy()
    want = ev_j.gather(s_j).reshape(-1)
    np.testing.assert_allclose(got, want, atol=ATOL)

    c = circuit_from_matrices(gates)
    assert [tuple(g.qubits) for g in c] == [qs for _, qs in gates]


@pytest.mark.parametrize('optimize, kw', [
    ('evolution', {}),
    ('tn', {'final_state': '.', 'max_time': 1}),
])
def test_profile_dir_writes_a_trace(optimize, kw, tmp_path, seed):
    """``simulate(..., profile_dir=d)`` runs the call under
    ``torch.profiler`` and writes a Chrome trace into ``d`` (created),
    as JAX writes its ``jax.profiler`` trace there; the amplitudes are
    those of the call without it (the TN engine plans anew each call, so
    its sums may run in another order: 1e-5)."""
    import json

    _, ct = _both_rqc(6, 30, seed)
    want = t_simulate(ct, initial_state='0', optimize=optimize,
                      device='cpu', **kw)
    d = tmp_path / 'trace' / optimize
    got = t_simulate(ct, initial_state='0', optimize=optimize,
                     device='cpu', profile_dir=str(d), **kw)
    np.testing.assert_allclose(got, want, atol=ATOL)
    (trace,) = d.iterdir()
    events = json.loads(trace.read_text())['traceEvents']
    assert any(e.get('ph') == 'X' for e in events)
