"""One run of one cell: set-up, the measured window, the traced
sub-window, the check of the answers, and the result.

The cell, its configuration and its traffic are found by their names in
``BENCHMARK.json``: the configuration's file names its ``driver``
(``hqbench/drivers/<driver>.py``), the traffic is
``traffic/<traffic>.json`` and each metric is read by
``metrics/<metric>.py``, whose ``read(record)`` returns a number or None.

The window is a closed loop: requests run back to back, and the window
closes when the request in flight at ``seconds`` completes, so that a
rate counts whole requests over the whole time they took.  With
``trace`` the first ``traced_requests`` requests run under
``torch.profiler``; their timeline is what the per-layer readers read.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import tempfile
import time
from dataclasses import dataclass

import numpy as np
import torch

from hqbench import system
from hqbench.timeline import Timeline

__all__ = ['HERE', 'ROOT', 'Record', 'load_cell', 'reader', 'run_cell']

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


@dataclass
class Record:
    """What a run gives its metric readers."""
    cell: dict
    config: dict
    traffic: dict
    unit: str                    # what a request's work is counted in
    setup_s: float
    window_s: float
    requests: list               # one dict per request, in order
    peak_bytes: int
    device_name: str
    costs: dict
    timeline: Timeline | None = None


def _load(path):
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT):
    """``(bench, cell, config, traffic)`` of the cell ``name``."""
    bench = _load(os.path.join(root, 'BENCHMARK.json'))
    cells = {w['name']: w for w in bench['workloads']}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    (entry,) = [c for c in bench['configs'] if c['name'] == cell['config']]
    config = _load(os.path.join(root, entry['file']))
    traffic = _load(os.path.join(HERE, 'traffic', cell['traffic'] + '.json'))
    return bench, cell, config, traffic


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = os.path.join(HERE, 'metrics', name + '.py')
    spec = importlib.util.spec_from_file_location(
        'hqbench_metric_' + name.replace('.', '_').replace('-', '_'), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _metrics_of(bench, cell, kind):
    return [m for m in bench[kind]
            if 'workloads' not in m or cell['name'] in m['workloads']]


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def _timeline(prof) -> Timeline:
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'trace.json')
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)['traceEvents']
    return Timeline.from_chrome(events)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, root: str = ROOT, config=None, traffic=None):
    """Run the cell; returns ``(result, checks)``: the result line's
    object without its ``checks`` key (with ``request_seconds``, each
    request's seconds, which the line leaves out), and ``{name: (value,
    limit)}``.
    ``config`` and ``traffic`` replace the cell's own (the tests run the
    cells' code at small sizes on the host)."""
    bench, cell, own_config, own_traffic = load_cell(name, root)
    config = own_config if config is None else config
    traffic = own_traffic if traffic is None else traffic
    kind = 'per_layer' if trace else 'end_to_end'
    metrics = _metrics_of(bench, cell, kind)
    readers = {m['name']: reader(m['name']) for m in metrics}
    device = torch.device(device)
    Driver = importlib.import_module(
        f"hqbench.drivers.{config['driver']}").Driver

    driver = Driver(config, traffic, seed, device, root)
    driver.warm()
    _sync(device)
    setup_s = time.perf_counter() - t_start

    n_traced = int(traffic['traced_requests']) if trace else 0
    prof = None
    if n_traced:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == 'cuda' else [])
        prof = profile(activities=acts)
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)
    requests = []
    t0 = time.perf_counter()
    while True:
        i = len(requests)
        if prof is not None and i == 0:
            prof.start()
        c0, r0 = system.launches(), time.perf_counter()
        with torch.profiler.record_function('bench.request'):
            rec = driver.request(i)
            _sync(device)
        r1 = time.perf_counter()
        rec.update(index=i, seconds=r1 - r0, traced=i < n_traced,
                   launches=system.launches() - c0)
        requests.append(rec)
        if prof is not None and i + 1 == n_traced:
            prof.stop()
        if r1 - t0 >= seconds and len(requests) >= n_traced:
            break
    window_s = r1 - t0
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == 'cuda' else 0
    name_of = torch.cuda.get_device_name(device) \
        if device.type == 'cuda' else 'cpu'

    timeline = _timeline(prof) if prof is not None else None
    del prof
    driver.release()
    checks = driver.check(np.random.default_rng([int(seed), 3]))
    record = Record(cell, config, traffic, driver.unit, setup_s, window_s,
                    requests, peak, name_of, driver.costs(), timeline)
    values = {}
    for m in metrics:
        v = readers[m['name']](record)
        if v is not None:
            values[m['name']] = {'value': float(v), 'unit': m['unit']}
    failed = sum(bool(r['failed']) for r in requests)
    # a NaN compares false, so it fails here
    correct = failed == 0 and all(v <= lim for v, lim in checks.values())
    dev = {'platform': 'gpu' if device.type == 'cuda' else device.type,
           'kind': name_of, 'count': int(cell['chips']),
           'memory_peak_bytes': int(peak)}
    result = {'correct': bool(correct), 'attempted': len(requests),
              'failed': failed, 'metrics': values, 'device': dev,
              'request_seconds': [r['seconds'] for r in requests]}
    if timeline is not None:
        span = timeline.window()
        if span is not None:
            lo, hi = span
            dev['busy_s'] = timeline.busy_us(lo, hi) / 1e6
            dev['window_s'] = (hi - lo) / 1e6
            result['breakdown'] = {
                'device_ops': timeline.top_device(lo, hi),
                'idle_gaps': timeline.idle_gaps(lo, hi)}
    return result, checks
