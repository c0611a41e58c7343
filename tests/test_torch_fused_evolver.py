"""The port's ``FusedEvolver`` against the JAX one (Pallas interpret mode).

Both engines get the same random 1-4 qubit gates; after every gate the
containers (max|d| <= 1e-5 on a unit-norm state, f32 sums in another
order) and the slot maps must agree, which covers row gates, swap gates,
lane eviction, parks, ``flush``/``gather`` and ``amplitude``.  Routing
follows step costs, so the port's cost function is replaced by the JAX
engine's (its TPU table) for these comparisons.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hybridq_tpu.simulation import fused_evolver as jfe
from hybridq_tpu.simulation import kernels as jkernels
from hybridq_tpu_torch.simulation import fused_evolver as tfe

N = 16           # 4 high slots: every gate of <= 4 qubits routes
ATOL = 1e-5


@pytest.fixture
def same_costs(monkeypatch):
    """Both routers on one cost model: JAX's per-class table, with no
    calibration (the port's own prices a step by its gate size)."""
    monkeypatch.setattr(jkernels, '_CALIB', {})
    monkeypatch.setattr(
        tfe, '_step_cost',
        lambda step, n, high=False, k=None: jfe._step_cost(step, n, high))


def _rand_u(k, rng):
    m = rng.standard_normal((2**k, 2**k)) + \
        1j * rng.standard_normal((2**k, 2**k))
    return np.linalg.qr(m)[0]


def _oracle(psi, U, qs, n):
    k = len(qs)
    T = np.moveaxis(psi.reshape((2,) * n), qs, range(k))
    T = (U @ T.reshape(2**k, -1)).reshape((2,) * n)
    return np.moveaxis(T, range(k), qs).reshape(-1)


def _rand_gates(n, count, rng, k_max=4):
    gates = []
    for _ in range(count):
        k = int(rng.integers(1, k_max + 1))
        qs = tuple(int(q) for q in rng.choice(n, k, replace=False))
        gates.append((_rand_u(k, rng), qs))
    return gates


def _run_both(gates, inplace, rng):
    n = N
    psi = rng.standard_normal(2**n) + 1j * rng.standard_normal(2**n)
    psi /= np.linalg.norm(psi)
    cont = np.concatenate([psi.real, psi.imag]).astype(np.float32)

    ev_j = jfe.FusedEvolver(n, interpret=True, inplace=inplace)
    ev_t = tfe.FusedEvolver(n, device='cpu', inplace=inplace)
    s_j = jnp.asarray(cont.reshape(-1, 128))
    s_t = torch.from_numpy(cont.copy())
    want = psi
    for U, qs in gates:
        want = _oracle(want, U, qs, n)
        ev_j.last_steps, ev_t.last_steps = [], []
        s_j = ev_j.apply_gate(s_j, U, qs)
        s_t = ev_t.apply_gate(s_t, U, qs)
        assert ev_t.last_steps == ev_j.last_steps, qs
        assert ev_t.phys == ev_j.phys and ev_t.logi == ev_j.logi, qs
        err = np.abs(np.asarray(s_j).reshape(-1) - s_t.numpy()).max()
        assert err <= ATOL, (qs, err)
    for i in rng.choice(2**n, 8, replace=False):
        assert abs(ev_t.amplitude(s_t, int(i)) - want[i]) <= ATOL
        assert ev_t.amplitude_location(int(i)) == \
            ev_j.amplitude_location(int(i))
    got_j = ev_j.gather(s_j).reshape(-1)
    got_t = ev_t.gather(s_t).reshape(-1).numpy()
    assert ev_t.phys == list(range(n))
    np.testing.assert_allclose(got_t, got_j, atol=ATOL)
    np.testing.assert_allclose(got_t, want, atol=ATOL)
    return ev_t


def test_evolver_matches_jax_inplace(same_costs, seed):
    """Default mode: parks are permutation passes of the fused kernel."""
    rng = np.random.default_rng(seed)
    # a 4-lane-bit gate forces eviction; the rest are random
    lanes = tuple(int(q) for q in rng.choice(range(N - 7, N), 4,
                                             replace=False))
    gates = [(_rand_u(4, rng), lanes)] + _rand_gates(N, 7, rng)
    _run_both(gates, inplace=True, rng=rng)


def test_evolver_matches_jax_row_gather(same_costs, seed):
    """``inplace=False``: parks and flush use the row gather."""
    rng = np.random.default_rng(seed)
    high = tuple(int(q) for q in rng.choice(4, 4, replace=False))
    gates = [(_rand_u(4, rng), high)] + _rand_gates(N, 6, rng)
    _run_both(gates, inplace=False, rng=rng)


@pytest.mark.parametrize('inplace', [True, False])
def test_mapsim_mirrors_engine(inplace, seed):
    """MapSim predicts exactly the steps the port's engine runs, with the
    port's own cost table."""
    n = 17
    rng = np.random.default_rng(seed)
    ev = tfe.FusedEvolver(n, device='cpu', inplace=inplace)
    sim = tfe.MapSim.of(ev)
    st = ev.prepare_state('0' * n)
    for U, qs in _rand_gates(n, 10, rng):
        want_steps = sim.route_gate(qs)
        ev.last_steps = []
        st = ev.apply_gate(st, U, qs)
        assert ev.last_steps == want_steps, (qs, ev.last_steps, want_steps)
        assert sim.phys == ev.phys
        assert sim.logi == ev.logi


@pytest.mark.parametrize('n, inplace', [(20, True), (29, True),
                                        (29, False)])
def test_routing_and_pairing_match_jax(same_costs, n, inplace, seed):
    """Host-only: on one cost table the port routes and pairs exactly as
    the JAX engine does."""
    rng = np.random.default_rng(seed)
    gates = _rand_gates(n, 16, rng)
    sim_j = jfe.MapSim(n, inplace=inplace)
    sim_t = tfe.MapSim(n, inplace=inplace)
    for _, qs in gates:
        assert sim_t.route_gate(qs) == sim_j.route_gate(qs), qs
        assert sim_t.phys == sim_j.phys
    blocks_j = jfe.pair_fused_gates(gates, n, jfe.MapSim(n, inplace=inplace))
    blocks_t = tfe.pair_fused_gates(gates, n, tfe.MapSim(n, inplace=inplace))
    assert [tuple(q) for _, q in blocks_t] == [tuple(q) for _, q in blocks_j]
    for (Ut, _), (Uj, _) in zip(blocks_t, blocks_j):
        np.testing.assert_allclose(Ut, Uj, atol=1e-12)


def test_econ_parking_with_jax_costs(same_costs):
    """On the JAX cost table a 4-high-bit gate parks before it runs."""
    n = 29
    steps = tfe.MapSim(n).route_gate((0, 1, 2, 3))
    direct = tfe._step_cost(('fused', 4), n)
    assert sum(tfe._step_cost(s, n) for s in steps) < direct
    assert steps[0] == ('park',), steps


def _schedule_cost(items, n):
    sim = tfe.MapSim(n, inplace=True)
    total = 0.0
    for _, qs in items:
        total += sim.route_cost(tuple(qs))
        sim.route_gate(tuple(qs))
    return total


@pytest.mark.parametrize('min_bit', [0, 3])
def test_pairing_on_port_costs(min_bit, seed):
    """Host-only, on the port's own (gate-size) cost table at n = 30:
    pairing ``bench.py``-style 4-qubit gates builds no block of 7-8
    qubits, whose compute-bound kernel costs more than the gates it
    would merge, and raises the modelled pass cost by at most 10%.  (The
    greedy judges a merge on the current slot map; the map it leaves
    can cost later gates more: at most 6.3% over 800 seeds.)"""
    n = 30
    rng = np.random.default_rng(seed)
    gates = []
    for _ in range(24):
        qs = tuple(int(q) for q in rng.choice(n - min_bit, 4, replace=False))
        gates.append((_rand_u(4, rng), qs))
    blocks = tfe.pair_fused_gates(gates, n, tfe.MapSim(n, inplace=True))
    assert max(len(q) for _, q in blocks) <= 6
    assert _schedule_cost(blocks, n) <= 1.1 * _schedule_cost(gates, n)


def test_step_cost_follows_gate_size():
    """The port prices a kernel call by its gate size, so parking a high
    bit (a TPU routing class change) never pays on its own."""
    n = 30
    assert tfe._step_cost(('fused', 0), n, k=4) == \
        tfe._step_cost(('fused', 4), n, k=4)
    assert tfe._step_cost(('fused', 4), n, k=8) > \
        2 * tfe._step_cost(('fused', 4), n, k=4)
    assert tfe._step_cost(('ipark', 5), n) == float('inf')
    steps = tfe.MapSim(n, inplace=True).route_gate((0, 1, 2, 3))
    assert steps == [('fused', 4)], steps


@pytest.mark.parametrize('tokens', ['0' * 15, '+' * 15,
                                    ('01+-' * 4)[:15]])
def test_prepare_state_matches_jax(tokens):
    n = len(tokens)
    got = tfe.FusedEvolver(n, device='cpu').prepare_state(tokens)
    want = jfe.FusedEvolver(n, interpret=True).prepare_state(tokens)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).reshape(-1))
