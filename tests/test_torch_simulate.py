"""The port's ``simulate`` / ``expectation_value`` against the JAX package.

Each circuit is built twice from one numpy seed, once with each package's
own copy of ``get_rqc``, so both sides run the same gates.  The fused
engine runs the plain versions of the port's kernels here and the Pallas
kernels in interpret mode on the JAX side.  Tolerance: 5e-5 absolute on
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
from hybridq_tpu.simulation import expectation_value as j_expect
from hybridq_tpu.simulation import simulate as j_simulate
from hybridq_tpu.simulation.fused_evolver import FusedEvolver as JEvolver
from hybridq_tpu_torch.convert import (circuit_from_matrices,
                                       state_from_reference,
                                       state_to_reference)
from hybridq_tpu_torch.extras.random import get_rqc as t_rqc
from hybridq_tpu_torch.simulation import expectation_value as t_expect
from hybridq_tpu_torch.simulation import simulate as t_simulate
from hybridq_tpu_torch.simulation.fused_evolver import \
    FusedEvolver as TEvolver

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


def test_simulate_fused_matches_jax(seed):
    n = 15
    cj, ct = _both_rqc(n, 18, seed)
    want = j_simulate(cj, optimize='evolution-fused', initial_state='0' * n,
                      fused_interpret=True)
    got = t_simulate(ct, optimize='evolution-fused', initial_state='0' * n,
                     device='cpu')
    assert got.shape == (2,) * n and got.dtype == np.complex64
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL_FUSED)


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
    """The fused engine flushes, projects on the host and goes on with a
    new segment of blocks.  Held against JAX's traced engine: JAX's own
    fused engine keys its operand memo by block index alone and reuses
    the first segment's operands after the flush."""
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
    """Evolve some gates in JAX, carry the state over, finish in the port;
    compare with an all-JAX run."""
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

    state, phys, logi = state_from_reference(mid, ev_j.phys, device='cpu')
    back, phys_back = state_to_reference(state, phys)
    np.testing.assert_array_equal(back, mid)
    assert phys_back == ev_j.phys

    ev_t = TEvolver(n, device='cpu')
    ev_t.phys, ev_t.logi = phys, logi
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
