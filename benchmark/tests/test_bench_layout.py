"""``BENCHMARK.json`` against the benchmark's contract, and every cell
resolved to its configuration, driver, traffic and metric files."""

import json
import os
import re

import pytest

import _small
from hqbench import harness

BENCH = json.load(open(os.path.join(_small.ROOT, 'BENCHMARK.json')))
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
LINE = re.compile(r'^[^\t\n]{1,200}$')
CELLS = [w['name'] for w in BENCH['workloads']]


def test_top_level_keys():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert 1 <= BENCH['run_seconds'] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_command_and_paths():
    assert 1 <= len(BENCH['paths']) <= 16
    for p in BENCH['paths']:
        assert re.match(r'^[A-Za-z0-9_./-]{1,200}$', p) and '..' not in p
        assert os.path.isdir(os.path.join(_small.ROOT, p))
        assert not p.endswith('_torch')
    cmd = BENCH['command']
    assert len(cmd) <= 32 and all(LINE.match(w) for w in cmd)
    files = [w for w in cmd if os.path.exists(os.path.join(_small.ROOT, w))]
    assert files and all(any(f.startswith(p + '/') for p in BENCH['paths'])
                         for f in files)


def test_names_units_and_lines():
    names = []
    for group in ('configs', 'workloads', 'end_to_end', 'per_layer'):
        for e in BENCH[group]:
            assert NAME.match(e['name']), e['name']
            names.append((group in ('end_to_end', 'per_layer'), e['name']))
            if 'unit' in e:
                assert UNIT.match(e['unit']) and e['better'] in (
                    'lower', 'higher')
            for k in ('why', 'layer', 'source'):
                if k in e:
                    assert LINE.match(e[k]), (e['name'], k)
    assert len(set(names)) == len(names)


def test_configs():
    for c in BENCH['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert c['file'].startswith('benchmark/')
        cfg = json.load(open(os.path.join(_small.ROOT, c['file'])))
        assert cfg['name'] == c['name'] and cfg['reduced'] == c['reduced']
        assert cfg['source'] == c['source']
        assert all(NAME.match(k) for k in c['reduced'])
        assert os.path.exists(os.path.join(_small.ROOT, cfg['reference']))
        assert os.path.exists(os.path.join(
            _small.HERE, 'hqbench', 'drivers', cfg['driver'] + '.py'))
        assert any(w['config'] == c['name'] for w in BENCH['workloads'])


def test_metrics():
    e2e = {m['name']: m for m in BENCH['end_to_end']}
    assert 'setup_s' in e2e and e2e['setup_s']['bound'] <= 0.25
    for m in BENCH['end_to_end']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'bound',
                                          'source'}
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    for m in BENCH['per_layer']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better',
                                          'source', 'layer', 'moves'}
        assert m['moves'] in e2e and m['source'] in (
            'device_trace', 'program_span', 'program_counter', 'host_clock')
        for w in m['workloads']:
            moved = e2e[m['moves']]
            assert 'workloads' not in moved or w in moved['workloads']
    layers = {}
    for m in BENCH['per_layer']:
        layers.setdefault(m['layer'].split(':')[0], set()).add(m['layer'])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize('cell', CELLS)
def test_cell_resolves(cell):
    bench, w, config, traffic = harness.load_cell(cell)
    assert w['chips'] in (1, 4) and LINE.match(w['why'])
    mine = [m for kind in ('end_to_end', 'per_layer') for m in bench[kind]
            if 'workloads' not in m or cell in m['workloads']]
    kinds = {m['name'] for m in mine}
    assert 'setup_s' in kinds
    assert len([m for m in bench['end_to_end']
                if m['name'] in kinds]) >= 2
    assert any(m['name'] in kinds for m in bench['per_layer'])
    for m in mine:
        assert callable(harness.reader(m['name']))
    assert traffic['traced_requests'] >= 1 and traffic[
        'checked_requests'] >= 1


def test_pairs_of_config_and_traffic_are_unique():
    pairs = [(w['config'], w['traffic']) for w in BENCH['workloads']]
    assert len(set(pairs)) == len(pairs)
    four = sum(w['chips'] == 4 for w in BENCH['workloads'])
    assert four <= max(1, len(BENCH['workloads']) // 4)
