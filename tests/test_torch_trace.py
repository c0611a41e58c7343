"""The port's spans (``_device.span``) under ``torch.profiler`` on the host.

While a profiler records, ``simulate`` is the span ``hq.simulate`` and its
parts are spans nested inside it, named ``hq.<part>`` with `` key=value``
metadata; with no profiler running no span is opened at all.  The traces
are read from the Chrome export, as the benchmark reads them.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import hybridq_tpu_torch as T
from hybridq_tpu_torch.extras.random import get_rqc
from hybridq_tpu_torch.simulation import fused_kernels
from hybridq_tpu_torch.simulation import simulate
from hybridq_tpu_torch.simulation.tn.contract import (ContractionPlan,
                                                      SlicedContractor)
from hybridq_tpu_torch.simulation.tn.network import build_tn
from hybridq_tpu_torch.simulation.tn.path import PathInfo, find_path

N_SV = 12
SV_CHILDREN = {'hq.preprocess', 'hq.compress', 'hq.prepare_state',
               'hq.block_matrices', 'hq.pair', 'hq.preload',
               'hq.apply_bits'}
TN_CHILDREN = {'hq.tn.plan', 'hq.tn.contractor', 'hq.tn.schedule',
               'hq.tn.leaves', 'hq.tn.fixed', 'hq.tn.chunk', 'hq.tn.result'}


def _circuit(n, seed):
    np.random.seed(seed)
    return T.Circuit([T.Gate('H', qubits=[q]) for q in range(n)]) + \
        get_rqc(n, 5 * n, indexes=list(range(n)))


def _spans(path):
    """``[(base, meta, start, end), ...]`` of the program's spans in a
    Chrome trace, in order of start."""
    out = []
    for e in json.loads(path.read_text())['traceEvents']:
        if e.get('ph') == 'X' and e.get('cat') == 'user_annotation' and \
                e['name'].startswith('hq.'):
            base, *pairs = e['name'].split()
            meta = {k: int(v) for k, v in (p.split('=') for p in pairs)}
            out.append((base, meta, e['ts'], e['ts'] + e['dur']))
    return sorted(out, key=lambda s: s[2])


def _traced(fn, tmp_path):
    """``(fn(), spans)`` with ``fn`` run under the host profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = fn()
    path = tmp_path / f'trace-{len(list(tmp_path.iterdir()))}.json'
    prof.export_chrome_trace(str(path))
    return got, _spans(path)


def _inside(inner, outer):
    return outer[2] <= inner[2] and inner[3] <= outer[3]


def _sv(circuit, **kw):
    return simulate(circuit, initial_state='0', device='cpu',
                    optimize='evolution-indexed', **kw)


@pytest.fixture(scope='module')
def tn_case():
    """A small network and a plan of 16 slices over it: a greedy tree
    and four inner indices sliced, no path search."""
    n = 8
    c = _circuit(n, 17)
    net, output = build_tn(c, '0' * n, '0' * n, complex_type='complex64',
                           simplify=True)
    inputs = [t.inds for t in net.tensors]
    size = {i: d for t in net.tensors for i, d in zip(t.inds, t.data.shape)}
    tree = find_path(inputs, output, size, methods=['greedy'],
                     max_repeats=1, seed=0)
    inner = sorted(i for i in size if i not in output and size[i] == 2)
    plan = ContractionPlan(tree, frozenset(inner[:4]))
    assert plan.nslices == 16
    return net, (PathInfo(tree), plan)


def _tn(case, slice_range, **kw):
    net, optimize = case
    return simulate(net, optimize=optimize, slice_range=slice_range,
                    device='cpu', **kw)


@pytest.mark.parametrize('simplify, numpy_result', [
    (False, True), (True, True), (False, False)])
def test_simulate_spans_nest(simplify, numpy_result, tmp_path, seed):
    """One ``hq.simulate`` holds every part of the straight engine's
    call, ``hq.simplify`` inside ``hq.preprocess`` when it runs, and the
    result's conversion (``hq.gather_host`` or ``hq.gather``)."""
    c = _circuit(N_SV, seed)
    _, spans = _traced(lambda: _sv(c, simplify=simplify,
                                   return_numpy_array=numpy_result),
                       tmp_path)
    (root,) = [s for s in spans if s[0] == 'hq.simulate']
    assert all(_inside(s, root) for s in spans)
    names = {s[0] for s in spans}
    gather = 'hq.gather_host' if numpy_result else 'hq.gather'
    assert SV_CHILDREN | {gather} <= names
    assert ('hq.simplify' in names) == simplify
    if simplify:
        (pre,) = [s for s in spans if s[0] == 'hq.preprocess']
        (simp,) = [s for s in spans if s[0] == 'hq.simplify']
        assert _inside(simp, pre)


@pytest.mark.parametrize('simplify', [False, True])
def test_apply_bits_spans_match_launches(simplify, tmp_path, monkeypatch,
                                         seed):
    """One ``hq.apply_bits`` span a call of ``apply_bits``, in the order
    of the calls, each with the launch's k, lowest flat bit and n."""
    launches = []
    plain = fused_kernels.apply_bits_plain

    def logged(state, U, bits):
        launches.append({'k': len(bits), 'lo': min(bits), 'n': N_SV})
        return plain(state, U, bits)

    monkeypatch.setattr(fused_kernels, 'apply_bits_plain', logged)
    c = _circuit(N_SV, seed)
    before = fused_kernels.counts()['apply_bits_plain']
    _, spans = _traced(lambda: _sv(c, simplify=simplify), tmp_path)
    delta = fused_kernels.counts()['apply_bits_plain'] - before
    got = [s[1] for s in spans if s[0] == 'hq.apply_bits']
    assert delta > 0 and len(got) == delta
    assert got == launches


@pytest.mark.parametrize('chunk, slice_range', [
    (None, (3, 11)), (1, (0, 5)), (3, (5, 16))])
def test_tn_spans_count_the_slices(chunk, slice_range, tn_case, tmp_path,
                                   monkeypatch):
    """The TN executor's parts nest in ``hq.simulate``, and the ``n`` of
    its chunks sums to the slices of ``slice_range`` that it contracts:
    those that select no all-zero leaf row (the plan's slices 4-11 are
    exactly zero)."""
    if chunk is not None:
        monkeypatch.setattr(SlicedContractor, '_chunk', lambda self: chunk)
    net, (_, plan) = tn_case
    keep = SlicedContractor(plan, net.tensors,
                            plan.tree.output).nonzero_slices()
    assert keep.tolist() == [True] * 4 + [False] * 8 + [True] * 4
    a, b = slice_range
    _, spans = _traced(lambda: _tn(tn_case, slice_range), tmp_path)
    (root,) = [s for s in spans if s[0] == 'hq.simulate']
    assert all(_inside(s, root) for s in spans)
    assert TN_CHILDREN <= {s[0] for s in spans}
    chunks = [s[1]['n'] for s in spans if s[0] == 'hq.tn.chunk']
    assert sum(chunks) == keep[a:b].sum() < b - a
    if chunk is not None:
        assert len(chunks) == -(-int(keep[a:b].sum()) // chunk)


@pytest.mark.parametrize('engine', ['sv', 'tn'])
def test_no_span_without_a_profiler(engine, tn_case, tmp_path,
                                    monkeypatch, seed):
    """With no profiler running the program never calls
    ``record_function``; with one, its answers are bitwise those
    without."""
    c = _circuit(N_SV, seed)
    run = (lambda: _sv(c)) if engine == 'sv' else \
        (lambda: _tn(tn_case, (2, 14)))
    traced, spans = _traced(run, tmp_path)
    assert spans

    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no profiler")

    monkeypatch.setattr(torch.profiler, 'record_function', refuse)
    monkeypatch.setattr(torch.autograd.profiler, 'record_function', refuse)
    plain = run()
    assert plain.dtype == traced.dtype
    np.testing.assert_array_equal(plain, traced)


@pytest.mark.parametrize('engine', ['sv', 'tn'])
def test_profile_dir_trace_holds_one_simulate_span(engine, tn_case,
                                                   tmp_path, seed):
    """``profile_dir=`` traces the call once: one ``hq.simulate``, the
    root of every other span."""
    d = tmp_path / 'trace'
    if engine == 'sv':
        _sv(_circuit(N_SV, seed), profile_dir=str(d))
    else:
        _tn(tn_case, (0, 16), profile_dir=str(d))
    (trace,) = d.iterdir()
    spans = _spans(trace)
    (root,) = [s for s in spans if s[0] == 'hq.simulate']
    assert len(spans) > 1 and all(_inside(s, root) for s in spans)
