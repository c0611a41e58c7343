"""The sharded cell on the host at a small size: its four-quarter
reference against the flat one, ``correct`` for a sound run and not for
the control or a planted fault, the driver's refusal of a program that
returns a host array, and its readers on synthetic events."""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import _small
import calibrate
import calibrate_sharded
from hqbench import circuits, harness
from hqbench.drivers import sharded as driver
from hqbench.harness import Record
from hqbench.timeline import Timeline
from reference import sharded as quarters
from reference import statevector

CELL = 'sycamore-n34-m14.sharded4'
H100 = 'NVIDIA H100 80GB HBM3'


def small(n=10, cycles=8):
    """The sharded cell at ``n`` qubits on four host shards."""
    _, _, config, traffic = harness.load_cell(CELL)
    return dict(config, n_qubits=n, cycles=cycles), \
        dict(traffic, bitstrings=256)


def run(config, traffic, trace=False):
    return harness.run_cell(CELL, 2 ** 31 + 13, 0.2, trace, 'cpu',
                            time.perf_counter(), config=config,
                            traffic=traffic)


@pytest.mark.parametrize('n', [6, 10])
@pytest.mark.parametrize('chunk', [2 ** 27, 16])
@pytest.mark.parametrize('tf32', [False, True])
def test_quarters_match_the_flat_reference(monkeypatch, n, chunk, tf32):
    """Blocks of every size the reference takes: the quarters are the
    flat state within float32 rounding (the products run in another
    order), in the control too."""
    monkeypatch.setattr(quarters, 'CHUNK', chunk)
    monkeypatch.setattr(statevector, 'CHUNK', chunk)
    gates = circuits.rqc(n, 8, [3, 1, n])
    want = statevector.evolve(gates, n, 'cpu', tf32=tf32).numpy()
    got = quarters.evolve(gates, n, ['cpu'] * 4, tf32=tf32)
    assert [q.numel() for q in got] == [2 ** (n - 2)] * 4
    np.testing.assert_allclose(torch.cat(got).numpy(), want, atol=2e-7)
    index = torch.as_tensor(np.random.default_rng(n).integers(
        0, 2 ** n, 64))
    amps = quarters.amplitudes(gates, n, index, ['cpu'] * 4, tf32=tf32)
    np.testing.assert_array_equal(amps, torch.cat(got).numpy()[index])


def test_reference_times_its_phases():
    """``on_phase`` sees the uploads, then the gates within a quarter and
    those across quarters as they alternate, then the end; the driver's
    clock sums their seconds; nothing computed changes."""
    gates = circuits.rqc(10, 8, [3, 1, 10])
    seen = []
    got = quarters.evolve(gates, 10, ['cpu'] * 4, on_phase=seen.append)
    want = quarters.evolve(gates, 10, ['cpu'] * 4)
    assert seen[0] == 'upload' and seen[-1] is None
    assert set(seen[1:-1]) == {'within', 'across'}
    assert all(a != b for a, b in zip(seen, seen[1:]))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    clock = driver.PhaseClock(['cpu'] * 4)
    quarters.evolve(gates, 10, ['cpu'] * 4, on_phase=clock)
    assert set(clock.times) == {'upload', 'within', 'across'}
    assert all(v >= 0 for v in clock.times.values())


def test_quarters_mix_only_the_gates_quarters():
    """A gate on qubit 0 alone leaves the pairs (0, 2) and (1, 3) apart:
    a state in quarters 0 and 1 only is rotated into 2 and 3, not mixed
    between 0 and 1."""
    n = 6
    gates = [('SQRT_X', (1,), ()), ('SQRT_Y', (0,), ())]
    got = torch.cat(quarters.evolve(gates, n, ['cpu'] * 4)).numpy()
    want = statevector.evolve(gates, n, 'cpu').numpy()
    np.testing.assert_allclose(got, want, atol=1e-7)
    assert np.count_nonzero(np.abs(got) > 1e-7) == 4


def test_sound_run_is_correct():
    result, checks = run(*small())
    assert result['correct'], checks
    assert result['attempted'] >= 1 and result['failed'] == 0
    assert 0 < checks['amp_gap'][0] < checks['amp_gap'][1] / 10
    assert result['device']['count'] == 4
    assert set(result['metrics']) == {'gates_per_s', 'setup_s'}


def test_traced_run_reads_the_exchange_counter():
    result, _ = run(*small(), trace=True)
    assert result['correct']
    # the host trace holds no device copies: the device readers are silent
    assert set(result['metrics']) == {'exchanges_per_circuit'}
    assert result['metrics']['exchanges_per_circuit']['value'] > 0


def test_control_is_not_correct():
    config, traffic = small()
    with calibrate_sharded.control():
        result, checks = run(config, traffic)
    assert not result['correct']
    assert checks['amp_gap'][0] > checks['amp_gap'][1]


def test_calibration_readings():
    config, traffic = small()
    program = calibrate.reading(7, config, traffic, 'cpu')['amp_gap']
    with calibrate_sharded.control():
        control = calibrate.reading(7, config, traffic, 'cpu',
                                    warm=False)['amp_gap']
    assert program < config['checks']['amp_gap'] < control
    assert control > 100 * program


def _fault(monkeypatch, target, name, every, n_local):
    """Replace ``target.name`` by a version that does nothing on its
    ``every``-th call at ``n_local`` local qubits (the probe's smaller
    shards are left alone); returns the list of calls."""
    real, calls = getattr(target, name), []

    def wrapped(*args):
        if args[-1] == n_local or getattr(args[0], 'numel', lambda: 0)() \
                == 2 ** (n_local + 1):
            calls.append(1)
            if len(calls) % every == 0:
                return 0 if name == 'exchange' else args[0]
        return real(*args)
    monkeypatch.setattr(target, name, wrapped)
    return calls


def test_skipped_exchange_is_not_correct(monkeypatch):
    from hybridq_tpu_torch.parallel.mesh import Mesh

    config, traffic = small()
    calls = _fault(monkeypatch, Mesh, 'exchange', 3, config['n_qubits'] - 2)
    result, checks = run(config, traffic)
    assert calls and not result['correct'], checks


def test_skipped_shard_launch_is_not_correct(monkeypatch):
    from hybridq_tpu_torch.simulation import fused_kernels

    config, traffic = small()
    # one shard's launch of every seventh block: calls come shard by shard
    calls = _fault(monkeypatch, fused_kernels, 'apply_bits', 4 * 7 + 2,
                   config['n_qubits'] - 2)
    result, checks = run(config, traffic)
    assert calls and not result['correct'], checks


def test_driver_refuses_a_host_array(monkeypatch):
    """A program that returns the gathered array (as the parent does)
    fails in the first, small call, before the warm-up."""
    config, traffic = small()
    sizes = []

    def run_program(gates, n, options, devices):
        sizes.append(n)
        return np.zeros((2,) * n, dtype=np.complex64)
    monkeypatch.setattr(driver, 'run_program', run_program)
    with pytest.raises(RuntimeError, match='not a state left on the cards'):
        run(config, traffic)
    assert sizes == [driver.PROBE_QUBITS]


def test_reference_loads_nothing_of_the_program():
    code = (
        "import sys; sys.path[:0] = ['benchmark']\n"
        "import torch\n"
        "from reference import sharded\n"
        "from hqbench import circuits\n"
        "sharded.amplitudes(circuits.rqc(6, 2, 1), 6, torch.arange(4),\n"
        "                   ['cpu'] * 4)\n"
        "print(*sorted({m.split('.')[0] for m in sys.modules}\n"
        "              & {'jax', 'jaxlib', 'flax', 'hybridq_tpu',\n"
        "                 'hybridq_tpu_torch'}))\n")
    out = subprocess.run([sys.executable, '-c', code], cwd=_small.ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=''))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == []


# -- readers -------------------------------------------------------------

SHARD = 8 * 2 ** 32           # bytes of a 32-qubit shard


def ev(cat, name, ts, dur):
    return {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur}


def record(events, requests):
    return Record(cell={}, config={}, traffic={}, unit='gates', setup_s=20.0,
                  window_s=10.0, requests=requests, peak_bytes=0,
                  device_name=H100,
                  costs={'n_qubits': 34, 'state_bytes': 8 * 2 ** 34,
                         'shard_bytes': SHARD},
                  timeline=None if events is None
                  else Timeline.from_chrome(events))


def events(copy_us):
    """One traced circuit of 5 s: a kernel, then two cards' copies side
    by side (their union ``copy_us``), a host gap, another kernel; and a
    copy after the call, which no reader of the copies counts."""
    half = copy_us // 2
    return [ev('user_annotation', 'bench.request', 0, 5_000_000),
            ev('user_annotation', 'bench.simulate', 0, 4_500_000),
            ev('kernel', 'column_apply_kernel<4>', 100_000, 100_000),
            ev('gpu_memcpy', 'Memcpy DtoD (Device -> Device)', 200_000,
               half),
            ev('gpu_memcpy', 'Memcpy PtoP (Device -> Device)', 200_000,
               half),
            ev('gpu_memcpy', 'Memcpy PtoP (Device -> Device)',
               200_000 + half, copy_us - half),
            ev('gpu_memcpy', 'Memcpy HtoD (Pageable -> Device)', 150_000,
               10_000),
            ev('kernel', 'column_apply_kernel<4>', 4_000_000, 50_000),
            ev('gpu_memcpy', 'Memcpy PtoP (Device -> Device)', 4_700_000,
               10_000)]


def requests(traced=20, untraced=(21, 19)):
    out = [{'gates': 660, 'traced': True, 'failed': False,
            'exchange': traced, 'exchange_bytes': traced * 2 * SHARD}]
    return out + [{'gates': 660, 'traced': False, 'failed': False,
                   'exchange': x, 'exchange_bytes': x * 2 * SHARD}
                  for x in untraced]


def test_exchange_readers():
    r = record(events(2_000_000), requests())
    read = harness.reader
    assert read('exchanges_per_circuit')(r) == 20
    assert read('exchange_ms')(r) == pytest.approx(2000.0)
    # 20 exchanges of half a shard a card at 450 GB/s over 2 s
    want = 100 * 20 * (SHARD / 2) / 450e9 / 2.0
    assert read('exchange_link_roofline')(r) == pytest.approx(want)
    assert read('exchange_link_roofline')(r) <= 100
    # busy of the 5 s: 0.1-0.2 (0.15-0.16 inside), the copies 0.2-2.2,
    # 4.0-4.05 and the copy after the call 4.7-4.71
    assert read('device_idle.sharded')(r) == pytest.approx(
        100 * (1 - 2.16 / 5))
    assert read('gates_per_s')(r) == pytest.approx(3 * 660 / 10.0)


def test_link_roofline_at_its_bound_reads_100():
    least_us = round(20 * (SHARD / 2) / 450e9 * 1e6)
    r = record(events(least_us), requests())
    assert harness.reader('exchange_link_roofline')(r) == pytest.approx(
        100, rel=1e-5)


def test_exchange_readers_silent_without_their_sources():
    plain = [{k: v for k, v in q.items() if not k.startswith('exchange')}
             for q in requests()]
    for r in (record(None, plain), record(events(2_000_000), plain)):
        assert harness.reader('exchanges_per_circuit')(r) is None
        assert harness.reader('exchange_link_roofline')(r) is None
    assert harness.reader('exchange_ms')(record(None, requests())) is None
    no_copies = [e for e in events(2_000_000)
                 if not e['name'].startswith(('Memcpy PtoP', 'Memcpy DtoD'))]
    r = record(no_copies, requests())
    assert harness.reader('exchange_ms')(r) is None
    assert harness.reader('exchange_link_roofline')(r) is None
    assert harness.reader('device_idle.sharded')(record(None, requests())) \
        is None
