"""The metric readers on synthetic profiler events."""

import pytest

import _small  # noqa: F401
from hqbench import harness
from hqbench.harness import Record
from hqbench.timeline import Timeline, union
from hqbench.yardstick import evolution_bytes, peaks, state_bytes

H100 = 'NVIDIA H100 80GB HBM3'


def ev(cat, name, ts, dur):
    return {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur}


def record(unit, events, requests, costs, **kw):
    return Record(cell={}, config={}, traffic={}, unit=unit,
                  setup_s=kw.get('setup_s', 12.5),
                  window_s=kw.get('window_s', 10.0), requests=requests,
                  peak_bytes=kw.get('peak', 0), device_name=H100,
                  costs=costs,
                  timeline=None if events is None
                  else Timeline.from_chrome(events))


def sv_events():
    # two calls: host until 100 (resp. 1100), then kernels
    return [ev('user_annotation', 'bench.request', 0, 1000),
            ev('user_annotation', 'bench.simulate', 0, 900),
            ev('gpu_memcpy', 'Memcpy HtoD', 100, 10),
            ev('kernel', 'column_apply_kernel<4>', 200, 300),
            ev('kernel', 'column_apply_kernel<4>', 500, 300),
            ev('cpu_op', 'aten::index_select', 950, 20),
            ev('kernel', 'index_select', 960, 10),
            ev('user_annotation', 'bench.request', 1000, 1000),
            ev('user_annotation', 'bench.simulate', 1000, 900),
            ev('kernel', 'column_apply_kernel<4>', 1300, 400),
            ev('cpu_op', 'cudaStreamSynchronize', 1050, 100)]


def sv_requests():
    return [{'gates': 618, 'launches': 1, 'traced': True, 'failed': False},
            {'gates': 618, 'launches': 2, 'traced': True, 'failed': False},
            {'gates': 618, 'launches': 4, 'traced': False, 'failed': False}]


def test_union():
    assert union([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4


def test_rates_and_setup():
    r = record('gates', None, sv_requests(), {'state_bytes': 80},
               peak=160)
    assert harness.reader('gates_per_s')(r) == pytest.approx(185.4)
    assert harness.reader('slices_per_s')(r) is None
    assert harness.reader('setup_s')(r) == 12.5
    assert harness.reader('peak_over_state')(r) == 2.0
    assert harness.reader('launches_per_circuit')(r) == pytest.approx(7 / 3)
    t = record('slices', None, [{'slices': 256}] * 3, {})
    assert harness.reader('slices_per_s')(t) == pytest.approx(76.8)
    assert harness.reader('gates_per_s')(t) is None


def test_sv_trace_readers():
    costs = {'n_qubits': 20, 'state_bytes': state_bytes(20)}
    r = record('gates', sv_events(), sv_requests(), costs)
    assert harness.reader('front_end_ms')(r) == pytest.approx(
        (0.1 + 0.3) / 2)
    # busy 10 + 600 + 10 + 400 of the 2000 us window
    assert harness.reader('device_idle.sv')(r) == pytest.approx(49.0)
    assert harness.reader('device_idle.tn')(r) is None
    least = evolution_bytes(20, 3, 2) / peaks(H100)[0]
    # device time inside the two simulate spans: 10 + 600 + 400 us
    assert harness.reader('sv_bytes_roofline')(r) == pytest.approx(
        100 * least / 1010e-6)
    t = r.timeline
    assert t.top_device(0, 2000)[0] == ['column_apply_kernel<4>', 1e-3]
    gaps = t.idle_gaps(0, 2000)
    assert [g[0] for g in gaps] == ['cudaStreamSynchronize',
                                    'bench.simulate', 'bench.simulate',
                                    'bench.simulate', 'bench.simulate']
    assert [g[1] for g in gaps] == pytest.approx(
        [330e-6, 300e-6, 160e-6, 100e-6, 90e-6])


def test_readers_say_nothing_without_device_activity():
    events = [e for e in sv_events() if e['cat'] not in (
        'kernel', 'gpu_memcpy')]
    r = record('gates', events, sv_requests(), {'n_qubits': 20})
    for name in ('front_end_ms', 'sv_bytes_roofline', 'device_idle.sv'):
        assert harness.reader(name)(r) is None
    t = record('slices', events, [{'slices': 4, 'traced': True}],
               {'macs_per_slice': 1e9})
    for name in ('tn_flops_share', 'tn_other_kernels_ms', 'device_idle.tn'):
        assert harness.reader(name)(t) is None


def test_tn_trace_readers():
    events = [ev('user_annotation', 'bench.request', 0, 10000),
              ev('user_annotation', 'bench.simulate', 0, 10000),
              ev('kernel', 'void tn_column_kernel<2, 2>(...)', 1000, 4000),
              ev('kernel', 'cutlass_80_cgemm_largek', 5000, 2000),
              ev('kernel', 'void at::native::elementwise_kernel<copy>', 7000,
                 1000),
              ev('kernel', 'void tn_tile_kernel<6>(...)', 8000, 1000)]
    reqs = [{'slices': 4, 'traced': True}, {'slices': 4, 'traced': False}]
    r = record('slices', events, reqs, {'macs_per_slice': 2 ** 30})
    busy = 8000e-6
    assert harness.reader('tn_flops_share')(r) == pytest.approx(
        100 * 8 * 2 ** 30 * 4 / peaks(H100)[1] / busy)
    assert harness.reader('tn_other_kernels_ms')(r) == pytest.approx(
        3.0 / 4)
    assert harness.reader('device_idle.tn')(r) == pytest.approx(20.0)
    assert harness.reader('device_idle.sv')(r) is None


def test_peaks_refuse_an_unknown_card():
    with pytest.raises(KeyError):
        peaks('NVIDIA A100-SXM4-80GB')
