"""The port's straight engine (``IndexedEvolver`` on ``apply_bits``) and
complex128 evolution against the JAX package, on the CPU.

The cases are ``tests/test_kernels.py``'s: random circuits, single gates
of k = 1..8 qubits at every position (flat bits 0-2 included), two-qubit
order, gates across JAX's row/column split, and paired against unpaired
blocks.  The port runs ``apply_bits``'s plain version here; JAX runs its
XLA gate classes.  Tolerance: 1e-5 absolute on unit-norm f32 states (f32
sums in another order); 1e-10 in complex128, where both sides run exact
complex128 products (JAX on host numpy einsum); 5e-5 for the fused
engines (the JAX suite's bar, ``tests/test_fused_evolver.py``).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import hybridq_tpu as J
import hybridq_tpu_torch as T
from hybridq_tpu.extras.random import get_rqc as j_rqc
from hybridq_tpu.simulation import simulate as j_simulate
from hybridq_tpu.simulation.fused_evolver import FusedEvolver as JFused
from hybridq_tpu.simulation.kernels import IndexedEvolver as JIndexed
from hybridq_tpu_torch.convert import (pair_to_reference,
                                       state_from_reference)
from hybridq_tpu_torch.extras.random import get_rqc as t_rqc
from hybridq_tpu_torch.simulation import fused_kernels as fk
from hybridq_tpu_torch.simulation import simulate as t_simulate
from hybridq_tpu_torch.simulation.kernels import IndexedEvolver as TIndexed
from hybridq_tpu_torch.simulation.kernels import (pair_matrix_gates,
                                                  straight_cost)

ATOL = 1e-5
ATOL_C128 = 1e-10
ATOL_FUSED = 5e-5


def _both_rqc(n, n_gates, seed, h_layer=False):
    """The same random circuit in each package."""
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


def _run_jax(gates, n, row_bits=0, init='0'):
    ev = JIndexed(n, row_bits=row_bits)
    state = ev.prepare_state(init * n)
    for U, qs in gates:
        state = ev.apply_gate(state, np.asarray(U, np.complex64), qs)
    return ev.gather(state)


def _run_port(gates, n, init='0'):
    ev = TIndexed(n, device='cpu')
    state = ev.prepare_state(init * n)
    for U, qs in gates:
        state = ev.apply_gate(state, U, qs)
    return ev.gather(state).numpy()


@pytest.mark.parametrize('n, row_bits', [(6, 3), (8, 4), (8, 0), (8, 8)])
def test_indexed_matches_jax(n, row_bits, seed):
    cj, ct = _both_rqc(n, 30, seed)
    ev = JIndexed(n, row_bits=row_bits)
    s = ev.apply_gates(ev.prepare_state('0' * n), cj,
                       {q: q for q in range(n)})
    want = ev.gather(s)
    evt = TIndexed(n, device='cpu')
    st = evt.apply_gates(evt.prepare_state('0' * n), ct,
                         {q: q for q in range(n)})
    np.testing.assert_allclose(evt.gather(st).numpy(), want, atol=ATOL)


@pytest.mark.parametrize('k', range(1, 9))
def test_indexed_single_gates_every_position(k):
    """A k-qubit gate on every window of k consecutive qubits (so every
    flat bit, 0-2 included, is a gate bit), in both bit orders."""
    n = 9
    rng = np.random.default_rng(k)
    gates = []
    for start in range(n - k + 1):
        qs = tuple(range(start, start + k))
        gates.append((_rand_u(k, rng), qs))
        gates.append((_rand_u(k, rng), qs[::-1]))
    for U, qs in gates:
        want = _run_jax([(U, qs)], n, init='+')
        got = _run_port([(U, qs)], n, init='+')
        np.testing.assert_allclose(got, want, atol=ATOL, err_msg=str(qs))


def test_indexed_two_qubit_order():
    """CX control/target order at both ends of the register."""
    n = 6
    X, CX = J.Gate('X').matrix(), J.Gate('CX').matrix()
    for qs in [(0, 5), (5, 0), (1, 2), (4, 3)]:
        gates = [(X, (qs[0],)), (CX, qs)]
        psi = _run_port(gates, n)
        idx = [0] * n
        idx[qs[0]] = idx[qs[1]] = 1
        assert abs(psi[tuple(idx)] - 1) < ATOL, qs
        np.testing.assert_allclose(psi, _run_jax(gates, n, row_bits=3),
                                   atol=ATOL)


def test_indexed_mixed_hi_lo_gate():
    """A 3-qubit gate across JAX's row/column split (row_bits = 3)."""
    n = 6
    rng = np.random.default_rng(5)
    H = J.Gate('H').matrix()
    gates = [(H, (1,)), (H, (4,)), (_rand_u(3, rng), (1, 3, 4))]
    np.testing.assert_allclose(_run_port(gates, n),
                               _run_jax(gates, n, row_bits=3), atol=ATOL)


@pytest.mark.parametrize('max_k', [4, 8])
def test_indexed_random_gates_match_jax(max_k):
    """``test_kernels.py``'s extended low-7 case: gates of up to ``max_k``
    qubits anywhere, at n = 14 (JAX's big path, L = 10)."""
    rng = np.random.default_rng(11 + max_k)
    n = 14
    gates = []
    for _ in range(25):
        k = int(rng.integers(1, max_k + 1))
        qs = tuple(int(x) for x in rng.choice(n, k, replace=False))
        gates.append((_rand_u(k, rng), qs))
    np.testing.assert_allclose(_run_port(gates, n),
                               _run_jax(gates, n, row_bits=10), atol=ATOL)


def test_pair_matrix_gates_matches_unpaired():
    rng = np.random.default_rng(3)
    n = 14
    items = []
    for _ in range(20):
        qs = tuple(int(x) for x in rng.choice(n, 4, replace=False))
        items.append((_rand_u(4, rng), qs))
    paired = pair_matrix_gates(items, n)
    assert len(paired) < len(items)            # some blocks must fuse
    assert max(len(qs) for _, qs in paired) <= 8
    want = _run_jax(items, n, row_bits=10)
    np.testing.assert_allclose(_run_port(paired, n), want, atol=ATOL)
    np.testing.assert_allclose(_run_port(items, n), want, atol=ATOL)


def _schedule_cost(items, n):
    return sum(straight_cost(n, [n - 1 - q for q in qs]) for _, qs in items)


@pytest.mark.parametrize('min_bit', [0, 3])
def test_pairing_on_port_costs(min_bit, seed):
    """On the straight cost table at n = 30, pairing ``bench.py``-style
    4-qubit gates (flat bits from ``min_bit`` up) builds no block of 7-8
    qubits, whose compute-bound launch costs more than the gates it would
    merge, and never raises the modelled cost of the schedule."""
    n = 30
    rng = np.random.default_rng(seed)
    gates = []
    for _ in range(24):
        qs = tuple(int(q) for q in rng.choice(n - min_bit, 4, replace=False))
        gates.append((_rand_u(4, rng), qs))
    blocks = pair_matrix_gates(gates, n)
    assert max(len(q) for _, q in blocks) <= 6
    assert _schedule_cost(blocks, n) <= _schedule_cost(gates, n)


def _cell_items(seed, simplify):
    """The state-vector cells' circuit ``[seed, 1, 0]`` at 32 qubits
    (``benchmark/hqbench``, read only) through simulate's front end:
    ``(U, qs)`` of its 4-qubit compressed blocks."""
    bench = str(Path(__file__).resolve().parents[1] / 'benchmark')
    if bench not in sys.path:
        sys.path.insert(0, bench)
    from hqbench import circuits, system
    from hybridq_tpu_torch.circuit import utils
    from hybridq_tpu_torch.gate import FunctionalGate
    from hybridq_tpu_torch.simulation.simulation import (_block_items,
                                                         _preprocess_circuit)

    c = system.circuit(circuits.rqc(32, 14, [seed, 1, 0]))
    c, qubits, _, _ = _preprocess_circuit(c, '0' * 32, None, simplify, True,
                                          1e-8, False, False, None)
    blocks = utils.compress(c, 4, skip_compression=[FunctionalGate])
    return _block_items(blocks, np.dtype('complex64'),
                        {q: i for i, q in enumerate(qubits)})


@pytest.mark.parametrize('seed_', [0, 7])
@pytest.mark.parametrize('simplify, compressed, launches',
                         [(False, 83, 74), (True, 56, 43)])
def test_cell_schedules(seed_, simplify, compressed, launches):
    """The n = 32 cells' schedules on the host: 83 compressed blocks
    paired to 74 launches with ``simplify=False``, 56 to 43 with it (the
    cells' ``launches_per_circuit``)."""
    items = _cell_items(seed_, simplify)
    assert len(items) == compressed
    assert len(pair_matrix_gates(items, 32)) == launches


@pytest.mark.parametrize('tokens', ['0' * 15, '+' * 15,
                                    ('01+-' * 4)[:15], '+-01+-0',
                                    '1-+0-+10', '0' * 8 + '+-01-+1',
                                    '+-01-+10' + '0' * 7])
def test_prepare_state_matches_jax(tokens):
    """The token product state, bit for bit the JAX package's container
    (both in canonical order): its fused engine's from 14 qubits, which
    folds the row and the lane tokens apart as the port does; below, its
    indexed engine's single fold, which equals the split one at n <= 8."""
    n = len(tokens)
    got = TIndexed(n, device='cpu').prepare_state(tokens)
    if n >= 14:
        want = JFused(n, interpret=True).prepare_state(tokens)
    else:
        ev = JIndexed(n)
        want = ev.unpack_host(ev.prepare_state(tokens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).reshape(-1))


@pytest.mark.parametrize('k', [1, 3, 5, 8])
def test_apply_bits_plain_matches_jax(k):
    """``apply_bits_plain`` on the container against one JAX
    ``IndexedEvolver`` gate, at random bits with bit 0 among them."""
    rng = np.random.default_rng(20 + k)
    n = 11
    qs = [n - 1] + [int(q) for q in rng.choice(n - 1, k - 1, replace=False)]
    rng.shuffle(qs)
    U = _rand_u(k, rng)
    psi = rng.standard_normal(2**n) + 1j * rng.standard_normal(2**n)
    psi /= np.linalg.norm(psi)
    ev = JIndexed(n, row_bits=0)
    want = ev.gather(ev.apply_gate(
        ev.pack(jnp.asarray(psi.real, jnp.float32),
                jnp.asarray(psi.imag, jnp.float32)),
        np.asarray(U, np.complex64), tuple(qs)))
    st = torch.from_numpy(np.concatenate([psi.real, psi.imag]).astype(
        np.float32))
    fk.reset_counts()
    fk.apply_bits_plain(st, U, [n - 1 - q for q in qs])
    assert fk.counts()['apply_bits_plain'] == 1
    got = (st[:2**n] + 1j * st[2**n:]).numpy().reshape((2,) * n)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_apply_bits_on_cpu_runs_the_plain_version(seed):
    rng = np.random.default_rng(seed)
    st = torch.from_numpy(rng.standard_normal(2**9).astype(np.float32))
    want = st.clone()
    U = _rand_u(3, rng)
    fk.reset_counts()
    fk.apply_bits(st, U, [0, 2, 7])
    fk.apply_bits_plain(want, U, [0, 2, 7])
    assert fk.counts()['apply_bits'] == 0
    assert fk.counts()['apply_bits_plain'] == 2
    assert torch.equal(st, want)
    with pytest.raises(ValueError, match='distinct'):
        fk.apply_bits(st, _rand_u(2, rng), [1, 1])


@pytest.mark.parametrize('n', [4, 9, 15])
def test_simulate_indexed_matches_jax(n, seed):
    cj, ct = _both_rqc(n, 3 * n, seed, h_layer=True)
    want = j_simulate(cj, optimize='evolution-indexed',
                      initial_state='0' * n)
    got, info = t_simulate(ct, optimize='evolution-indexed',
                           initial_state='0' * n, device='cpu',
                           return_info=True)
    assert info['engine'] == 'indexed'
    assert got.shape == (2,) * n and got.dtype == np.complex64
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


def test_simulate_indexed_tensor_and_initial_array(seed):
    """An array initial state and ``return_numpy_array=False``.  The H
    layer keeps every qubit active, so the state's 7 axes always match
    the circuit (20 random gates leave a qubit idle on some draws)."""
    n = 7
    cj, ct = _both_rqc(n, 20, seed, h_layer=True)
    rng = np.random.default_rng(seed)
    psi0 = rng.standard_normal((2,) * n) + 1j * rng.standard_normal(
        (2,) * n)
    psi0 = (psi0 / np.linalg.norm(psi0)).astype(np.complex64)
    want = j_simulate(cj, optimize='evolution-indexed', initial_state=psi0)
    got = t_simulate(ct, optimize='evolution-indexed', initial_state=psi0,
                     device='cpu', return_numpy_array=False)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_simulate_indexed_across_a_projection(seed):
    """A FunctionalGate goes to the host and back in the straight
    engine."""
    n = 9
    out = []
    for pkg, rqc in ((J, j_rqc), (T, t_rqc)):
        np.random.seed(seed)
        c = pkg.Circuit([pkg.Gate('H', qubits=[q]) for q in range(n)])
        c += rqc(n, 12, indexes=list(range(n)))
        c.append(pkg.Projection('0', qubits=[2]))
        c += rqc(n, 12, indexes=list(range(n)))
        out.append(c)
    want = j_simulate(out[0], optimize='evolution-indexed',
                      initial_state='0' * n)
    got = t_simulate(out[1], optimize='evolution-indexed',
                     initial_state='0' * n, device='cpu')
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


@pytest.mark.parametrize('n, optimize', [(5, 'evolution'),
                                         (9, 'evolution-indexed'),
                                         (12, 'evolution-tpu')])
def test_simulate_complex128_matches_jax(n, optimize, seed):
    """complex128 goes to the per-gate torch path in complex128; JAX's
    goes to host numpy einsum, the reference."""
    cj, ct = _both_rqc(n, 4 * n, seed, h_layer=True)
    want = j_simulate(cj, optimize=optimize, initial_state='0' * n,
                      complex_type='complex128')
    got, info = t_simulate(ct, optimize=optimize, initial_state='0' * n,
                           complex_type='complex128', device='cpu',
                           return_info=True)
    assert info['engine'] == 'torch' and got.dtype == np.complex128
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL_C128)


def test_simulate_complex128_with_measure(seed):
    """FunctionalGates keep complex128 through the host round trip."""
    n = 6
    out = []
    for pkg, rqc in ((J, j_rqc), (T, t_rqc)):
        np.random.seed(seed)
        c = pkg.Circuit([pkg.Gate('X', qubits=[0])] +
                        [pkg.Gate('H', qubits=[q]) for q in range(1, n)])
        c += rqc(n - 1, 12, indexes=list(range(1, n)))
        c.append(pkg.Measure(qubits=[0]))
        c += rqc(n, 6, indexes=list(range(n)))
        out.append(c)
    want = j_simulate(out[0], initial_state='0' * n,
                      complex_type='complex128')
    got = t_simulate(out[1], initial_state='0' * n,
                     complex_type='complex128', device='cpu')
    assert got.dtype == np.complex128
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL_C128)


def test_simulate_fused_complex128_matches_jax(seed):
    """'evolution-fused' in complex128: f32 kernels, gathered to
    complex128 on both sides."""
    n = 14
    cj, ct = _both_rqc(n, 12, seed, h_layer=True)
    want = j_simulate(cj, optimize='evolution-fused', initial_state='0' * n,
                      complex_type='complex128', fused_interpret=True)
    got = t_simulate(ct, optimize='evolution-fused', initial_state='0' * n,
                     complex_type='complex128', device='cpu')
    assert got.dtype == np.complex128 and np.asarray(want).dtype == \
        np.complex128
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL_FUSED)


def test_state_from_reference_pair_round_trip(seed):
    """Evolve some gates in JAX's IndexedEvolver, carry the flushed
    ``[2, 2^n]`` pair over, go on in the port; then carry it back and
    finish in JAX.  Both against all-JAX runs of the same gates."""
    n = 10
    rng = np.random.default_rng(seed)
    gates = []
    for _ in range(9):
        k = int(rng.integers(1, 5))
        qs = tuple(int(q) for q in rng.choice(n, k, replace=False))
        gates.append((np.asarray(_rand_u(k, rng), np.complex64), qs))

    ev_j = JIndexed(n, row_bits=4)
    s_j = ev_j.prepare_state('0' * n)
    for U, qs in gates[:3]:
        s_j = ev_j.apply_gate(s_j, U, qs)
    pair = ev_j.unpack_host(ev_j.flush(s_j))
    assert pair.shape == (2, 2**n)

    state, phys, logi = state_from_reference(pair, device='cpu')
    assert phys == logi == list(range(n))
    np.testing.assert_array_equal(pair_to_reference(state), pair)
    ev_t = TIndexed(n, device='cpu')
    for U, qs in gates[3:6]:
        state = ev_t.apply_gate(state, U, qs)
    np.testing.assert_allclose(ev_t.gather(state).numpy(),
                               _run_jax(gates[:6], n, row_bits=4),
                               atol=ATOL)

    back = pair_to_reference(state)
    ev_b = JIndexed(n, row_bits=4)
    s_b = ev_b.pack(jnp.asarray(back[0]), jnp.asarray(back[1]))
    for U, qs in gates[6:]:
        s_b = ev_b.apply_gate(s_b, U, qs)
    np.testing.assert_allclose(ev_b.gather(s_b),
                               _run_jax(gates, n, row_bits=4), atol=ATOL)


@pytest.mark.parametrize('chunk', [1, 24, 2**20])
def test_gather_host_in_chunks(chunk, seed):
    """``gather_host`` builds the host array a chunk at a time (a last
    chunk shorter than the others, or one chunk past the state's end):
    the same array as ``gather``, in either complex type."""
    rng = np.random.default_rng(seed)
    n = 7
    ev = TIndexed(n, device='cpu')
    st = torch.from_numpy(rng.standard_normal(2**(n + 1)).astype(np.float32))
    for ctype in ('complex64', 'complex128'):
        got = ev.gather_host(st, ctype, chunk=chunk)
        assert got.dtype == np.dtype(ctype) and got.shape == (2,) * n
        np.testing.assert_array_equal(got, ev.gather(st, ctype).numpy())
