"""The port's sharded engines (``simulation/sharded.py``) against the JAX
package's, on the CPU.

The cases are ``tests/test_sharded.py``'s.  JAX runs its engines on the
8-device CPU mesh of ``tests/conftest.py``; the port runs the same circuit
from the same seed on ``devices=['cpu'] * n_dev`` (each shard a split
container on the host, gates through ``apply_bits``'s plain version).
Tolerance: ``test_sharded.py``'s, 1e-5 absolute on unit-norm complex64
states (1e-4 where it uses 1e-4), 1e-10 in complex128; outcome
probabilities 1e-5.  After every ``evolve`` the port's ``perm`` must equal
JAX's, and ``measure`` must draw JAX's outcome from the same seed.
"""

import numpy as np
import pytest
import torch

import jax

import hybridq_tpu as J
import hybridq_tpu_torch as T
from hybridq_tpu import dm as jdm
from hybridq_tpu.extras.random import get_rqc as j_rqc
from hybridq_tpu.gate import FunctionalGate as JFG
from hybridq_tpu.gate import MeasureGate as JMeasure
from hybridq_tpu.gate import ProjectionGate as JProj
from hybridq_tpu.simulation import simulate as j_simulate
from hybridq_tpu.simulation.sharded import ShardedEvolver as JSharded
from hybridq_tpu.simulation.sharded import \
    ShardedIndexedEvolver as JShardedIndexed
from hybridq_tpu_torch import dm as tdm
from hybridq_tpu_torch.convert import sharded_from_reference
from hybridq_tpu_torch.extras.random import get_rqc as t_rqc
from hybridq_tpu_torch.gate import FunctionalGate as TFG
from hybridq_tpu_torch.gate import MeasureGate as TMeasure
from hybridq_tpu_torch.gate import ProjectionGate as TProj
from hybridq_tpu_torch.simulation import fused_kernels as fk
from hybridq_tpu_torch.simulation import simulate as t_simulate
from hybridq_tpu_torch.simulation.sharded import ShardedEvolver as TSharded
from hybridq_tpu_torch.simulation.sharded import \
    ShardedIndexedEvolver as TShardedIndexed

ATOL = 1e-5
ATOL_C128 = 1e-10
CLASSES = {'traced': (JSharded, TSharded),
           'indexed': (JShardedIndexed, TShardedIndexed)}


def _both(build, seed):
    """``build(pkg, rqc)`` for each package, from one seed."""
    out = []
    for pkg, rqc in ((J, j_rqc), (T, t_rqc)):
        np.random.seed(seed)
        out.append(build(pkg, rqc))
    return out


def _rqc_h(n, depth, seed):
    """``test_sharded.py``'s circuit: an RQC, then an H layer."""
    return _both(lambda pkg, rqc: rqc(n, depth, indexes=list(range(n))) +
                 pkg.Circuit(pkg.Gate('H', qubits=[q]) for q in range(n)),
                 seed)


def _pad(pkg, n):
    return pkg.Circuit(pkg.Gate('I', qubits=[q]) for q in range(n))


def _c128(c):
    return np.asarray(t_simulate(c, initial_state='0', device='cpu',
                                 complex_type='complex128', simplify=False,
                                 remove_id_gates=False))


def _pair(mode, n, n_dev, **kw):
    """The JAX evolver on its first ``n_dev`` CPU devices and the port's
    on ``n_dev`` CPU shards."""
    jcls, tcls = CLASSES[mode]
    return (jcls(n_qubits=n, devices=jax.devices()[:n_dev], **kw),
            tcls(n, devices=['cpu'] * n_dev, **kw))


@pytest.mark.parametrize('mode', ['traced', 'indexed'])
@pytest.mark.parametrize('n_dev', [2, 4, 8])
def test_sharded_matches_single_chip_and_jax(mode, n_dev, seed):
    n = 7
    cj, ct = _rqc_h(n, 30, seed)
    jev, tev = _pair(mode, n, n_dev)
    want = jev.gather(jev.evolve(jev.prepare_state('0' * n), cj))
    psi = tev.evolve(tev.prepare_state('0' * n), ct)
    got = tev.gather(psi)
    assert tev.perm == jev.perm
    assert len(psi) == n_dev and tev.g == int(np.log2(n_dev))
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got, _c128(ct), atol=ATOL)
    assert abs(tev.norm(psi) - 1) < 1e-5


@pytest.mark.parametrize('mode', ['traced', 'indexed'])
def test_sharded_complex128(mode, seed):
    """complex128 shards run the plain per-gate path in f64."""
    n = 7
    _, ct = _rqc_h(n, 30, seed)
    ev = CLASSES[mode][1](n, devices=['cpu'] * 4, complex_type='complex128')
    psi = ev.evolve(ev.prepare_state('0' * n), ct)
    assert psi[0].dtype == torch.float64
    got = ev.gather(psi)
    assert got.dtype == np.complex128
    np.testing.assert_allclose(got, _c128(ct), atol=ATOL_C128)


def test_sharded_global_qubit_gates():
    """Gates acting directly on the three global qubits of 8 shards."""
    n = 6
    cj, ct = [pkg.Circuit([pkg.Gate('H', qubits=[0]),
                           pkg.Gate('H', qubits=[1]),
                           pkg.Gate('CX', qubits=[0, 2]),
                           pkg.Gate('CZ', qubits=[1, 2]),
                           pkg.Gate('X', qubits=[0])]) for pkg in (J, T)]
    for mode in CLASSES:
        jev, tev = _pair(mode, n, 8)
        want = jev.gather(jev.evolve(jev.prepare_state('0' * n), cj,
                                     qubits=list(range(n))))
        psi = tev.evolve(tev.prepare_state('0' * n), ct,
                         qubits=list(range(n)))
        assert tev.perm == jev.perm and tev.exchanges > 0
        np.testing.assert_allclose(tev.gather(psi), want, atol=ATOL)
        np.testing.assert_allclose(tev.gather(psi), _c128(ct + _pad(T, n)),
                                   atol=ATOL)


def test_sharded_initial_states_and_norm():
    from hybridq_tpu_torch.simulation.prepare import prepare_state

    n = 6
    jev, tev = _pair('traced', n, 4)
    got = tev.gather(tev.prepare_state('+-01+-'))
    np.testing.assert_allclose(got, jev.gather(jev.prepare_state('+-01+-')),
                               atol=ATOL)
    np.testing.assert_allclose(got, prepare_state('+-01+-'), atol=ATOL)
    assert abs(tev.norm(tev.prepare_state('+-01+-')) - 1.0) < 1e-6


@pytest.mark.parametrize('mode', ['traced', 'indexed'])
def test_sharded_sequential_evolutions(mode, seed):
    """The layout persists across evolve calls, and the shards keep their
    storage."""
    n = 6
    qubits = list(range(n))
    c1j, c1t = _both(lambda pkg, rqc: rqc(n, 12, indexes=qubits), seed)
    c2j, c2t = _both(lambda pkg, rqc: rqc(n, 12, indexes=qubits), seed + 1)
    jev, tev = _pair(mode, n, 4)
    js = jev.evolve(jev.prepare_state('0' * n), c1j, qubits=qubits)
    psi = tev.prepare_state('0' * n)
    ptrs = [s.data_ptr() for s in psi]
    psi = tev.evolve(psi, c1t, qubits=qubits)
    assert tev.perm == jev.perm
    js = jev.evolve(js, c2j, qubits=qubits)
    psi = tev.evolve(psi, c2t, qubits=qubits)
    assert tev.perm == jev.perm
    assert [s.data_ptr() for s in psi] == ptrs
    np.testing.assert_allclose(tev.gather(psi), jev.gather(js), atol=ATOL)
    np.testing.assert_allclose(tev.gather(psi),
                               _c128(c1t + c2t + _pad(T, n)), atol=ATOL)


@pytest.mark.parametrize('mode', ['traced', 'indexed'])
@pytest.mark.parametrize('n_dev', [2, 4, 8])
def test_simulate_dispatch_sharded(mode, n_dev, seed):
    """``optimize='evolution-sharded'`` through ``simulate``, both
    ``sharded_mode``s, against JAX's dispatch on as many devices."""
    n = 6
    cj, ct = _both(lambda pkg, rqc: rqc(n, 20, indexes=list(range(n))) +
                   _pad(pkg, n), seed)
    kw = dict(initial_state='0', optimize='evolution-sharded',
              remove_id_gates=False, simplify=False, sharded_mode=mode)
    want = np.asarray(j_simulate(cj, devices=jax.devices()[:n_dev], **kw))
    got, info = t_simulate(ct, devices=['cpu'] * n_dev, return_info=True,
                           **kw)
    assert info['engine'] == 'sharded' and got.dtype == np.complex64
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(got, _c128(ct), atol=1e-4)


def test_simulate_dispatch_sharded_array_initial_state(seed):
    """Array initial states scatter into the shard layout."""
    n = 7
    rng = np.random.default_rng(seed)
    psi0 = rng.standard_normal((2,) * n) + \
        1j * rng.standard_normal((2,) * n)
    psi0 = (psi0 / np.linalg.norm(psi0)).astype('complex64')
    cj, ct = _both(lambda pkg, rqc: pkg.Circuit(
        pkg.Gate('H', qubits=[q]) for q in range(n)) +
        rqc(n, 20, indexes=list(range(n))), seed)
    want = np.asarray(j_simulate(cj, initial_state=psi0, simplify=False,
                                 optimize='evolution-sharded'))
    got = t_simulate(ct, initial_state=psi0, simplify=False,
                     optimize='evolution-sharded', devices=['cpu'] * 8)
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(
        got, t_simulate(ct, initial_state=psi0, simplify=False,
                        complex_type='complex128', device='cpu'), atol=1e-4)


def test_sharded_evolver_state_stays_bounded(seed):
    """In place of ``test_sharded.py``'s program-cache test (eager
    PyTorch compiles nothing): over 7 distinct circuits the shards keep
    their storage, and no container of the evolver grows."""
    n = 7
    qubits = list(range(n))
    ev = TShardedIndexed(n, devices=['cpu'] * 4)
    psi = ev.prepare_state('0' * n)
    ptrs = [s.data_ptr() for s in psi]
    sizes = None
    for i in range(7):
        np.random.seed(seed + i)
        psi = ev.evolve(psi, t_rqc(n, 20, indexes=qubits), qubits=qubits)
        now = {k: len(v) for k, v in vars(ev).items()
               if isinstance(v, (dict, list, tuple))}
        assert sizes is None or now == sizes
        sizes = now
    assert [s.data_ptr() for s in psi] == ptrs
    assert abs(ev.norm(psi) - 1) < 1e-5


def test_indexed_sharded_projection(seed):
    n = 6
    qubits = list(range(n))
    cj, ct = _both(lambda pkg, rqc: rqc(n, 15, indexes=qubits), seed)
    jev, tev = _pair('indexed', n, 4)
    js = jev.evolve(jev.prepare_state('0' * n),
                    cj + J.Circuit([JProj('01', [0, 3])]), qubits=qubits)
    psi = tev.evolve(tev.prepare_state('0' * n),
                     ct + T.Circuit([TProj('01', [0, 3])]), qubits=qubits)
    assert tev.perm == jev.perm
    np.testing.assert_allclose(tev.gather(psi), jev.gather(js), atol=ATOL)
    np.testing.assert_allclose(
        tev.gather(psi),
        _c128(ct + T.Circuit([TProj('01', [0, 3])]) + _pad(T, n)),
        atol=ATOL)


def test_indexed_sharded_project_without_renormalizing(seed):
    n = 6
    qubits = list(range(n))
    cj, ct = _both(lambda pkg, rqc: rqc(n, 15, indexes=qubits), seed)
    jev, tev = _pair('indexed', n, 8)
    js = jev.project(jev.evolve(jev.prepare_state('0' * n), cj,
                                qubits=qubits), [2, 0], 2,
                     renormalize=False)
    psi = tev.project(tev.evolve(tev.prepare_state('0' * n), ct,
                                 qubits=qubits), [2, 0], 2,
                      renormalize=False)
    assert tev.perm == jev.perm
    np.testing.assert_allclose(tev.gather(psi), jev.gather(js), atol=ATOL)
    assert abs(tev.norm(psi) - jev.norm(js)) < 1e-6


def test_indexed_sharded_measure_probabilities(seed):
    n = 6
    qubits = list(range(n))
    cj, ct = _both(lambda pkg, rqc: rqc(n, 15, indexes=qubits), seed)
    full = _c128(ct + _pad(T, n))
    m = np.transpose(np.abs(full) ** 2, (1, 4, 0, 2, 3, 5))
    expected = m.reshape(4, -1).sum(axis=1)

    jev, tev = _pair('indexed', n, 4, seed=seed)
    js = jev.evolve(jev.prepare_state('0' * n), cj, qubits=qubits)
    psi = tev.evolve(tev.prepare_state('0' * n), ct, qubits=qubits)
    js, jprobs = jev.probabilities(js, [1, 4])
    psi, probs = tev.probabilities(psi, [1, 4])
    assert tev.perm == jev.perm and probs.dtype == np.float64
    np.testing.assert_allclose(probs, jprobs, atol=1e-5)
    np.testing.assert_allclose(probs, expected, atol=1e-5)

    js, joutcome = jev.measure(js, [1, 4])
    psi, outcome = tev.measure(psi, [1, 4])
    assert outcome == joutcome
    mask = np.zeros_like(full, dtype=bool)
    idx = [slice(None)] * n
    idx[1] = outcome >> 1
    idx[4] = outcome & 1
    mask[tuple(idx)] = True
    sel = np.where(mask, full, 0)
    sel = sel / np.linalg.norm(sel)
    np.testing.assert_allclose(tev.gather(psi), sel, atol=ATOL)
    np.testing.assert_allclose(tev.gather(psi), jev.gather(js), atol=ATOL)


def test_indexed_sharded_measure_gate_draws_jax_outcomes(seed):
    """A circuit with MeasureGates: the same seed draws the same
    outcomes, so the collapsed states agree."""
    n = 6
    qubits = list(range(n))
    cj, ct = _both(lambda pkg, rqc: pkg.Circuit(
        pkg.Gate('H', qubits=[q]) for q in qubits) +
        rqc(n, 12, indexes=qubits), seed)
    jev, tev = _pair('indexed', n, 4, seed=seed)
    js = jev.evolve(jev.prepare_state('0' * n),
                    cj + J.Circuit([JMeasure([0, 5])]) + cj, qubits=qubits)
    psi = tev.evolve(tev.prepare_state('0' * n),
                     ct + T.Circuit([TMeasure([0, 5])]) + ct, qubits=qubits)
    assert tev.perm == jev.perm
    np.testing.assert_allclose(tev.gather(psi), jev.gather(js), atol=ATOL)


def test_indexed_sharded_functional_host_fallback(seed):
    n = 6
    qubits = list(range(n))
    cj, ct = _both(lambda pkg, rqc: rqc(n, 10, indexes=qubits), seed)

    def phase_flip(self, psi, order):
        out = psi.copy()
        out *= -1
        return out, order

    jev, tev = _pair('indexed', n, 4)
    with pytest.warns(UserWarning, match='host'):
        js = jev.evolve(jev.prepare_state('0' * n),
                        cj + J.Circuit([JFG(phase_flip, qubits=[0])]),
                        qubits=qubits)
    psi = tev.prepare_state('0' * n)
    ptrs = [s.data_ptr() for s in psi]
    with pytest.warns(UserWarning, match='host'):
        psi = tev.evolve(psi, ct + T.Circuit([TFG(phase_flip, qubits=[0])]),
                         qubits=qubits)
    assert tev.perm == jev.perm == qubits
    assert [s.data_ptr() for s in psi] == ptrs
    np.testing.assert_allclose(tev.gather(psi), jev.gather(js), atol=ATOL)
    np.testing.assert_allclose(tev.gather(psi), -_c128(ct + _pad(T, n)),
                               atol=ATOL)


def test_traced_sharded_rejects_functional_gates():
    ev = TSharded(4, devices=['cpu'] * 2)
    with pytest.raises(NotImplementedError, match='FunctionalGates'):
        ev.evolve(ev.prepare_state('0000'),
                  T.Circuit([TProj('0', [0])]))


@pytest.mark.parametrize('n_dev', [2, 8])
def test_indexed_sharded_expectation_value(n_dev, seed):
    """<psi|op|psi> of a 2-qubit Pauli product, global or local after the
    circuit; the layout is restored afterwards."""
    n = 7
    qubits = list(range(n))
    cj, ct = _rqc_h(n, 25, seed)
    # one compressed block: restoring the layout after it is always
    # possible (after several blocks JAX's _restore_perm may refuse)
    op = [(pkg.Circuit([pkg.Gate('X', qubits=[0]),
                        pkg.Gate('Z', qubits=[5])])) for pkg in (J, T)]
    jev, tev = _pair('indexed', n, n_dev)
    js = jev.evolve(jev.prepare_state('0' * n), cj)
    psi = tev.evolve(tev.prepare_state('0' * n), ct)
    perm0 = list(tev.perm)
    want = jev.expectation_value(js, op[0], qubits=qubits)
    got = tev.expectation_value(psi, op[1], qubits=qubits)
    assert tev.perm == perm0 == jev.perm
    assert abs(got - want) < 1e-5
    full = tev.gather(psi).astype(np.complex128)
    phi = _apply_ops(full, op[1])
    assert abs(got - np.vdot(full, phi)) < 1e-5


def _apply_ops(psi, circuit):
    for g in circuit:
        (q,) = g.qubits
        psi = np.moveaxis(np.tensordot(g.matrix(), psi, axes=([1], [q])),
                          0, q)
    return psi


@pytest.mark.parametrize('mode', ['traced', 'indexed'])
def test_sharded_from_reference_mid_circuit(mode, seed):
    """A JAX sharded state taken mid-circuit (a non-canonical layout)
    carried into the port, and both engines evolved on from it."""
    n = 7
    qubits = list(range(n))
    c1j, c1t = _both(lambda pkg, rqc: rqc(n, 20, indexes=qubits), seed)
    c2j, c2t = _both(lambda pkg, rqc: rqc(n, 20, indexes=qubits), seed + 7)
    jev, tev = _pair(mode, n, 4)
    js = jev.evolve(jev.prepare_state('0' * n), c1j, qubits=qubits)
    if jev.perm == qubits:   # a gate on a global qubit moves the layout
        js = jev.evolve(js, J.Circuit([J.Gate('H', qubits=[0])]),
                        qubits=qubits)
    assert jev.perm != qubits
    psi, perm = sharded_from_reference(np.asarray(js[0]), np.asarray(js[1]),
                                       jev.perm, ['cpu'] * 4)
    tev.perm = perm
    np.testing.assert_allclose(tev.gather(psi), jev.gather(js), atol=0)
    js = jev.evolve(js, c2j, qubits=qubits)
    psi = tev.evolve(psi, c2t, qubits=qubits)
    assert tev.perm == jev.perm
    np.testing.assert_allclose(tev.gather(psi), jev.gather(js), atol=ATOL)


def test_dm_simulate_sharded(seed):
    """``dm.simulate(optimize='evolution-sharded')`` runs through the
    sharded engine on the doubled register (8 qubits on 4 shards)."""
    n = 4
    cj, ct = _rqc_h(n, 12, seed)
    kw = dict(initial_state='0', optimize='evolution-sharded')
    want = np.asarray(jdm.simulate(cj, devices=jax.devices()[:4], **kw))
    got = np.asarray(tdm.simulate(ct, devices=['cpu'] * 4, **kw))
    np.testing.assert_allclose(got, want, atol=ATOL)
    rho = got.reshape(2 ** n, 2 ** n)
    assert abs(np.trace(rho) - 1) < 1e-5


def test_sharded_launches_one_apply_bits_a_shard_and_block(seed):
    """Each compressed block is one ``apply_bits`` call on every shard
    (here its plain version, the CPU's)."""
    n = 7
    _, ct = _rqc_h(n, 20, seed)
    ev = TShardedIndexed(n, devices=['cpu'] * 4, compress=2)
    blocks = ev._compressed(ct)
    psi = ev.prepare_state('0' * n)
    fk.reset_counts()
    ev.evolve(psi, ct)
    assert fk.counts()['apply_bits_plain'] == 4 * len(blocks)
    assert fk.counts()['apply_bits'] == 0


@pytest.mark.parametrize('n_dev', [2, 3, 4])
def test_contract_over_several_devices(n_dev):
    """``contract(devices=[...])`` on JAX's carried tree: a device count
    that divides the slices sums one contiguous range on each and adds
    the partials (JAX: ``_contract_jax_mesh`` on as many CPU devices);
    3 does not divide them and falls back to one device, as in JAX."""
    from hybridq_tpu.simulation.tn import contract as jcontract
    from hybridq_tpu_torch.convert import tn_from_reference
    from hybridq_tpu_torch.simulation.tn import contract as tcontract
    from tests.test_torch_tn import _case

    jnet, _, jtree, sliced, oo = _case('sliced')
    tnet, ttree = tn_from_reference(jnet, jtree)
    jsc = jcontract.SlicedContractor(jcontract.ContractionPlan(jtree, sliced),
                                     jnet.tensors, oo)
    tsc = tcontract.SlicedContractor(tcontract.ContractionPlan(ttree, sliced),
                                     tnet.tensors, oo)
    assert tsc.nslices % 4 == 0 and tsc.nslices % 3 != 0
    want = jsc.contract_jax(devices=jax.devices()[:n_dev])
    scale = np.abs(want).max()
    calls = []
    contract_torch = tsc.contract_torch

    def recorded(device=None, slice_range=None):
        calls.append((str(device), slice_range))
        return contract_torch(device=device, slice_range=slice_range)
    tsc.contract_torch = recorded
    got = tsc.contract(devices=['cpu'] * n_dev)
    assert got.dtype == np.complex64 and got.shape == want.shape
    assert np.abs(got - want).max() / scale <= 1e-5
    assert np.abs(got - jsc.contract_np()).max() / scale <= 1e-5
    if n_dev == 3:
        assert calls == [('cpu', None)]
    else:
        per = tsc.nslices // n_dev
        assert calls == [('cpu', (i * per, (i + 1) * per))
                         for i in range(n_dev)]
