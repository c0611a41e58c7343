"""The readers of the program's spans (``hqbench/spans.py``) on synthetic
profiler events, and on a traced run of the small cells on the host."""

import pytest

import _small
from hqbench import harness
from hqbench.spans import parse
from hqbench.yardstick import peaks, state_bytes
from test_bench_metrics import H100, ev, record

SV_READERS = ('entry_host_ms', 'pairing_ms', 'apply_roofline.k4',
              'apply_roofline.k5', 'apply_roofline.k6')
TN_READERS = ('tn_call_host_ms', 'tn_contracted_pct')


def span(name, ts, dur):
    return ev('user_annotation', name, ts, dur)


def sv_events(n=20):
    """Two calls.  The first: front end 0-300 (simplify inside
    preprocess), pairing 300-340, three launches (k = 4, 6, 5) whose
    kernels run 400-500, 500-700, 700-850; the second: front end 1000-1200
    with compress overlapping block matrices, two pairings, one k = 4
    launch whose kernel runs 1400-1450."""
    k = 'void (anonymous namespace)::'
    return [
        span('bench.request', 0, 1000), span('bench.simulate', 0, 950),
        span('hq.simulate', 10, 900),
        span('hq.preprocess', 10, 200), span('hq.simplify', 20, 150),
        span('hq.compress', 210, 50), span('hq.block_matrices', 260, 40),
        span('hq.pair', 300, 40),
        span(f'hq.apply_bits k=4 lo=3 n={n}', 350, 5),
        span(f'hq.apply_bits k=6 lo=0 n={n}', 360, 5),
        span(f'hq.apply_bits k=5 lo=7 n={n}', 370, 5),
        ev('kernel', k + 'column_apply_kernel<4>(float*, ...)', 400, 100),
        ev('kernel', k + 'group_apply_kernel<6>(float*, ...)', 500, 200),
        ev('kernel', k + 'column_apply_kernel<5>(float*, ...)', 700, 150),
        ev('kernel', 'void at::native::elementwise_kernel', 860, 20),
        ev('cpu_op', 'aten::complex', 855, 10),
        span('bench.request', 1000, 1000), span('bench.simulate', 1000, 900),
        span('hq.simulate', 1000, 800),
        span('hq.preprocess', 1000, 100), span('hq.compress', 1100, 60),
        span('hq.block_matrices', 1140, 60),
        span('hq.pair', 1200, 30), span('hq.pair', 1250, 20),
        span(f'hq.apply_bits k=4 lo=0 n={n}', 1300, 5),
        ev('kernel', k + 'column_apply_kernel<4>(float*, ...)', 1400, 50)]


def sv_requests():
    return [{'gates': 618, 'launches': 3, 'traced': True, 'failed': False},
            {'gates': 618, 'launches': 1, 'traced': True, 'failed': False}]


def sv_record(events):
    return record('gates', events, sv_requests(),
                  {'n_qubits': 20, 'state_bytes': state_bytes(20)})


def tn_events():
    """Two calls of 8 slices: chunks of 4 and 4, then of 3, 3 and 2."""
    return [
        span('bench.request', 0, 5000), span('bench.simulate', 0, 5000),
        span('hq.simulate', 0, 4900), span('hq.tn.plan', 5, 10),
        span('hq.tn.contractor', 20, 5), span('hq.tn.leaves', 30, 5),
        span('hq.tn.fixed', 40, 100), span('hq.tn.chunk n=4', 200, 2000),
        span('hq.tn.chunk n=4', 2200, 2000),
        ev('kernel', 'void tn_column_kernel<2, 2>(...)', 250, 4000),
        span('bench.request', 5000, 5000), span('bench.simulate', 5000, 5000),
        span('hq.simulate', 5000, 4900),
        span('hq.tn.chunk n=3', 5400, 1000),
        span('hq.tn.chunk n=3', 6400, 1000),
        span('hq.tn.chunk n=2', 7400, 1000),
        ev('kernel', 'void tn_column_kernel<2, 2>(...)', 5450, 4000)]


def tn_record(events):
    reqs = [{'slices': 8, 'traced': True}, {'slices': 8, 'traced': True},
            {'slices': 8, 'traced': False}]
    return record('slices', events, reqs, {'macs_per_slice': 2 ** 30})


def test_parse():
    assert parse('hq.apply_bits k=4 lo=0 n=32') == (
        'hq.apply_bits', {'k': 4, 'lo': 0, 'n': 32})
    assert parse('hq.simulate') == ('hq.simulate', {})


def test_sv_span_readers():
    r = sv_record(sv_events())
    # call 1: [10, 300) less nothing; call 2: [1000, 1200)
    assert harness.reader('entry_host_ms')(r) == pytest.approx(
        (0.29 + 0.2) / 2)
    assert harness.reader('pairing_ms')(r) == pytest.approx(
        (0.04 + 0.05) / 2)
    least_us = 2 * state_bytes(20) / peaks(H100)[0] * 1e6
    assert harness.reader('apply_roofline.k4')(r) == pytest.approx(
        100 * 2 * least_us / 150)
    assert harness.reader('apply_roofline.k5')(r) == pytest.approx(
        100 * least_us / 150)
    assert harness.reader('apply_roofline.k6')(r) == pytest.approx(
        100 * least_us / 200)


def test_tn_span_readers():
    r = tn_record(tn_events())
    assert harness.reader('tn_call_host_ms')(r) == pytest.approx(
        (0.2 + 0.4) / 2)
    assert harness.reader('tn_contracted_pct')(r) == pytest.approx(100.0)


def test_skipped_slices_read_below_100():
    events = [e for e in tn_events() if e['name'] != 'hq.tn.chunk n=2' and
              not (e['name'] == 'hq.tn.chunk n=4' and e['ts'] == 2200)]
    assert harness.reader('tn_contracted_pct')(
        tn_record(events)) == pytest.approx(100 * 10 / 16)


def test_a_launch_count_unlike_the_kernel_count_reads_nothing():
    events = [e for e in sv_events() if e['ts'] != 1400]
    r = sv_record(events)
    for k in (4, 5, 6):
        assert harness.reader(f'apply_roofline.k{k}')(r) is None
    # the host spans still read
    assert harness.reader('pairing_ms')(r) == pytest.approx(0.045)


def test_a_size_no_launch_has_reads_nothing():
    events = [e for e in sv_events() if 'k=5' not in e['name'] and
              '<5>' not in e['name']]
    assert harness.reader('apply_roofline.k5')(sv_record(events)) is None
    assert harness.reader('apply_roofline.k4')(sv_record(events)) \
        is not None


@pytest.mark.parametrize('name', SV_READERS + TN_READERS)
def test_a_cell_of_the_wrong_unit_reads_nothing(name):
    """A state-vector reader on the TN cell's trace, and the other way
    round."""
    other = tn_record(tn_events()) if name in SV_READERS \
        else sv_record(sv_events())
    assert harness.reader(name)(other) is None


@pytest.mark.parametrize('name', SV_READERS + TN_READERS)
def test_a_program_without_spans_reads_nothing(name):
    """The parent commit's trace (the benchmark's spans and the device's
    events, no ``hq.*``), and an untraced run."""
    make = sv_record if name in SV_READERS else tn_record
    events = sv_events() if name in SV_READERS else tn_events()
    for r in (make([e for e in events if not e['name'].startswith('hq.')]),
              make(None)):
        assert harness.reader(name)(r) is None


@pytest.fixture(scope='module')
def plan(tmp_path_factory):
    path = tmp_path_factory.mktemp('plan') / 'plan.pkl'
    assert _small.make_plan(path) >= 8
    return path


def test_traced_host_runs_read_the_host_spans(plan):
    """The small cells traced on the host: the spans of the host's work
    read, the rooflines read nothing (the host runs no kernel to pair
    with a launch), and every slice asked for is contracted."""
    result, _ = _small.run(_small.SV_CELL, *_small.small_sv(), trace=True)
    got = result['metrics']
    assert got['entry_host_ms']['value'] > 0
    assert got['pairing_ms']['value'] > 0
    assert not any(k.startswith('apply_roofline') for k in got)
    result, _ = _small.run(_small.TN_CELL, *_small.small_tn(plan),
                           trace=True)
    got = result['metrics']
    assert got['tn_contracted_pct']['value'] == 100.0
    assert got['tn_call_host_ms']['value'] > 0
