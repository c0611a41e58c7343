"""The noisy density-matrix cell on the host at a small size: its plain
reference against dense Kraus sums, ``correct`` for a sound run and not
for the TF32 control or a fault planted in the timed path, the
calibration readings, and its readers on synthetic events and on a traced
host run."""

import numpy as np
import pytest
import torch

import _small
import calibrate
from hqbench import circuits, harness
from hqbench.drivers.densitymatrix import Driver
from reference import densitymatrix, statevector
from test_bench_metrics import H100, ev, record

CELL = 'sycamore-dm16-m14.depolarizing'
PAULIS = (np.eye(2), np.array([[0, 1], [1, 0]]),
          np.array([[0, -1j], [1j, 0]]), np.diag([1.0, -1.0]))


def small(n=6, cycles=14):
    """The cell at ``n`` qubits on the host, through the straight engine
    (``'evolution-indexed'``, the card's route of ``'evolution'``) and the
    plain version of its kernel."""
    _, _, config, traffic = harness.load_cell(CELL)
    return dict(config, n_qubits=n, cycles=cycles), dict(
        traffic, entries=4096,
        simulate=dict(traffic['simulate'], optimize='evolution-indexed'))


def run(config, traffic, trace=False):
    return _small.run(CELL, config, traffic, trace=trace)


def noise_of(config):
    e = config['noise']
    return {1: densitymatrix.depolarizing_p(e['one_qubit_pauli_error'], 1),
            2: densitymatrix.depolarizing_p(e['two_qubit_pauli_error'], 2)}


def full(u, qubits, n):
    """``u`` on ``qubits`` as a 2^n x 2^n matrix, qubit 0 the most
    significant bit."""
    k = len(qubits)
    op = np.tensordot(u.reshape((2,) * 2 * k),
                      np.eye(2 ** n).reshape((2,) * 2 * n),
                      (list(range(k, 2 * k)), list(qubits)))
    return np.moveaxis(op, list(range(k)), list(qubits)).reshape(
        2 ** n, 2 ** n)


def kraus_rho(gates, n, noise):
    """rho by dense products: each gate as U rho U^dagger, each channel as
    its Pauli Kraus sum (1 - p) rho + p/d^2 sum_P P rho P."""
    rho = np.zeros((2 ** n, 2 ** n), complex)
    rho[0, 0] = 1
    for name, qubits, params in gates:
        u = full(statevector.gate_matrix(name, params), qubits, n)
        rho = u @ rho @ u.conj().T
        k, p = len(qubits), noise[len(qubits)]
        out = (1 - p) * rho
        for x in range(4 ** k):
            m = np.ones((1, 1))
            for j in range(k):
                m = np.kron(m, PAULIS[x >> 2 * (k - 1 - j) & 3])
            m = full(m, qubits, n)
            out = out + p / 4 ** k * m @ rho @ m.conj().T
        rho = out
    return rho


@pytest.mark.parametrize('n,cycles,seed', [(3, 6, 0), (4, 8, 1), (5, 5, 2)])
def test_reference_matches_kraus_sums(n, cycles, seed):
    config, _ = small()
    noise = noise_of(config)
    gates = circuits.rqc(n, cycles, seed)
    want = kraus_rho(gates, n, noise)
    got = densitymatrix.evolve(gates, n, noise, 'cpu',
                               dtype=torch.complex128).numpy()
    assert np.abs(got.reshape(want.shape) - want).max() < 1e-13
    assert abs(np.trace(want) - 1) < 1e-12
    low = densitymatrix.evolve(gates, n, noise, 'cpu').numpy()
    assert np.abs(low.reshape(want.shape) - want).max() < 1e-6


def test_reference_blocks():
    config, _ = small()
    noise = noise_of(config)
    gates = circuits.rqc(5, 6, 4)
    want = densitymatrix.evolve(gates, 5, noise, 'cpu').numpy()
    chunk = statevector.CHUNK
    try:
        statevector.CHUNK = 2 ** 3
        got = densitymatrix.evolve(gates, 5, noise, 'cpu').numpy()
    finally:
        statevector.CHUNK = chunk
    assert np.abs(got - want).max() < 1e-6


def test_depolarizing_strength():
    """p = e d^2/(d^2 - 1): the configuration's 0.16% and 0.62% give
    0.0021333 and 0.0066133, and a channel of that p applies a Pauli other
    than the identity with chance e."""
    config, _ = small()
    noise = noise_of(config)
    assert noise[1] == pytest.approx(0.0021333, abs=1e-7)
    assert noise[2] == pytest.approx(0.0066133, abs=1e-7)
    for k, e in ((1, 0.0016), (2, 0.0062)):
        assert noise[k] * (4 ** k - 1) / 4 ** k == pytest.approx(e)


def test_a_request_counts_gates_and_channels():
    gates = circuits.rqc(16, 14, [0, 1, 0])
    assert len(gates) == 299
    config, traffic = small(4, 2)
    driver = Driver(config, traffic, 5, 'cpu', _small.ROOT)
    got = driver.request(0)
    assert got['gates'] == 2 * len(driver._gates((1, 0)))
    assert driver.index.numel() == 2 ** 4 + 4096
    assert driver.costs() == {'n_qubits': 8, 'state_bytes': 8 * 2 ** 8}


def test_sound_run_is_correct():
    result, checks = run(*small())
    assert result['correct'], checks
    assert result['attempted'] >= 1 and result['failed'] == 0
    assert 0 < checks['rho_gap'][0] < checks['rho_gap'][1] / 10


def test_control_is_not_correct():
    with Driver.control():
        result, checks = run(*small())
    assert not result['correct']
    assert checks['rho_gap'][0] > checks['rho_gap'][1]


def test_calibration_readings():
    config, traffic = small()
    program = calibrate.reading(7, config, traffic, 'cpu')['rho_gap']
    with Driver.control():
        control = calibrate.reading(7, config, traffic, 'cpu',
                                    warm=False)['rho_gap']
    assert program < config['checks']['rho_gap'] and control > 10 * program


def test_channels_left_out_are_not_correct(monkeypatch):
    from hybridq_tpu_torch.dm import simulation
    from hybridq_tpu_torch.dm.gate import BaseSuperGate

    real = simulation._transform

    def _transform(gate):
        return () if isinstance(gate, BaseSuperGate) else real(gate)
    monkeypatch.setattr(simulation, '_transform', _transform)
    result, _ = run(*small())
    assert not result['correct']


def test_channels_at_half_strength_are_not_correct(monkeypatch):
    from hybridq_tpu_torch import noise

    real = noise.GlobalDepolarizingChannel

    def half(qubits, p, **kwargs):
        return real(qubits, p / 2, **kwargs)
    monkeypatch.setattr(noise, 'GlobalDepolarizingChannel', half)
    result, _ = run(*small())
    assert not result['correct']


def test_one_gates_conj_half_skipped_is_not_correct(monkeypatch):
    """The lowering of each call drops ``g.conj()`` on ``(1, q)`` of its
    first two-qubit gate: rho -> U rho there, not U rho U^dagger."""
    from hybridq_tpu_torch.dm import simulation

    real_convert, real_transform = simulation._convert, \
        simulation._transform
    left = []

    def _convert(circuit):
        left[:] = [1]
        return real_convert(circuit)

    def _transform(gate):
        out = real_transform(gate)
        if left and len(out) == 2 and len(gate.qubits) == 2:
            left.clear()
            return out[:1]
        return out
    monkeypatch.setattr(simulation, '_convert', _convert)
    monkeypatch.setattr(simulation, '_transform', _transform)
    result, _ = run(*small())
    assert not result['correct']


def test_rho_read_transposed_is_not_correct(monkeypatch):
    """rho with its row and column indices swapped: every diagonal entry
    reads right, so only the off-diagonal entries tell."""
    real = Driver._rho

    def _rho(self, gates):
        side = 2 ** self.n
        return real(self, gates).reshape(side, side).T.reshape(-1)
    monkeypatch.setattr(Driver, '_rho', _rho)
    result, _ = run(*small())
    assert not result['correct']


def dm_events():
    """Two calls: the first lowers 0-100 inside ``hq.dm.simulate``, then
    preprocess 100-300, compress 300-350, block matrices 340-400 and one
    k = 6 launch; the second lowers 1000-1050, preprocess 1050-1100."""
    k = 'void (anonymous namespace)::'
    span = lambda name, ts, dur: ev('user_annotation', name, ts, dur)  # noqa
    return [
        span('bench.request', 0, 1000), span('bench.simulate', 0, 950),
        span('hq.dm.simulate', 0, 940), span('hq.dm.lower', 0, 100),
        span('hq.simulate', 100, 800), span('hq.preprocess', 100, 200),
        span('hq.compress', 300, 50), span('hq.block_matrices', 340, 60),
        span('hq.apply_bits k=6 lo=0 n=20', 410, 5),
        ev('kernel', k + 'group_apply_kernel<6>(float*, ...)', 500, 200),
        span('bench.request', 1000, 1000), span('bench.simulate', 1000, 900),
        span('hq.dm.simulate', 1000, 890), span('hq.dm.lower', 1000, 50),
        span('hq.simulate', 1050, 800), span('hq.preprocess', 1050, 50),
        span('hq.apply_bits k=4 lo=0 n=20', 1110, 5),
        ev('kernel', k + 'column_apply_kernel<4>(float*, ...)', 1200, 300)]


def dm_record(events):
    reqs = [{'gates': 598, 'launches': 1, 'traced': True, 'failed': False},
            {'gates': 598, 'launches': 1, 'traced': True, 'failed': False}]
    return record('gates', events, reqs,
                  {'n_qubits': 20, 'state_bytes': 8 * 2 ** 20})


def test_dm_readers_on_synthetic_events():
    from hqbench.yardstick import peaks

    r = dm_record(dm_events())
    assert harness.reader('dm_lower_ms')(r) == pytest.approx((0.1 + 0.05) / 2)
    # call 1: [0, 400); call 2: [1000, 1100)
    assert harness.reader('dm_entry_host_ms')(r) == pytest.approx(
        (0.4 + 0.1) / 2)
    least_us = 2 * 8 * 2 ** 20 / peaks(H100)[0] * 1e6
    assert harness.reader('apply_roofline.dm_k6')(r) == pytest.approx(
        100 * least_us / 200)
    # busy 200 + 300 of the 2000 us window
    assert harness.reader('device_idle.dm')(r) == pytest.approx(75.0)


@pytest.mark.parametrize('name', ['dm_lower_ms', 'dm_entry_host_ms',
                                  'apply_roofline.dm_k6'])
def test_a_program_without_dm_spans_reads_nothing(name):
    """The parent commit's trace has no ``hq.dm.*`` (its ``simulate``
    spans remain, which the roofline reads), and an untraced run reads
    nothing."""
    events = [e for e in dm_events() if not e['name'].startswith('hq.dm.')]
    got = harness.reader(name)(dm_record(events))
    assert (got is not None) == (name == 'apply_roofline.dm_k6')
    assert harness.reader(name)(dm_record(None)) is None


def test_traced_host_run_reads_the_lowering():
    result, checks = run(*small(), trace=True)
    got = result['metrics']
    assert result['correct'], checks
    assert 0 < got['dm_lower_ms']['value'] < got['dm_entry_host_ms']['value']
    assert 'apply_roofline.dm_k6' not in got and 'device_idle.dm' not in got
