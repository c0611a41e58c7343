"""The port's tensor-network engine against the JAX package's.

Networks are built from one numpy seed by each package's own copy of
``get_rqc``; where a test holds the executor, the JAX package's path
search makes the tree and ``convert.tn_from_reference`` carries the
identical tree (node ids and child order) to the port, so both sides
contract the same steps.  Tolerances, as max|d| / max|ref|: complex128
1e-10 and complex64 1e-5 for the torch executor against JAX's
``contract_np`` (the same products in another order); ``ATOL = 1e-4``
absolute for ``simulate(optimize='tn')`` against the exact complex128
evolution, as ``tests/test_tn.py`` holds JAX's engine; 1e-12 (complex128)
and 1e-6 (complex64) absolute for ``'evolution-einsum'`` against JAX's
numpy einsum engine.  Path search gets a small ``max_time`` here.
"""

import os
import pickle
from collections import Counter

import numpy as np
import pytest
import torch

import hybridq_tpu as J
import hybridq_tpu_torch as T
from hybridq_tpu import native as jnative
from hybridq_tpu.circuit import utils as jutils
from hybridq_tpu.extras.random import get_rqc as j_rqc
from hybridq_tpu.simulation import simulate as j_simulate
from hybridq_tpu.simulation.tn import contract as jcontract
from hybridq_tpu.simulation.tn.network import build_tn as j_build_tn
from hybridq_tpu.simulation.tn.path import find_path as j_find_path
from hybridq_tpu.simulation.tn.slicer import find_slices as j_find_slices
from hybridq_tpu_torch import native as tnative
from hybridq_tpu_torch.circuit import utils as tutils
from hybridq_tpu_torch.convert import load_reference_plan, tn_from_reference
from hybridq_tpu_torch.extras.random import get_rqc as t_rqc
from hybridq_tpu_torch.simulation import simulate as t_simulate
from hybridq_tpu_torch.simulation.tn import contract as tcontract
from hybridq_tpu_torch.simulation.tn import make_plan
from hybridq_tpu_torch.simulation.tn.network import build_tn as t_build_tn
from hybridq_tpu_torch.simulation.tn.path import _greedy_ssa

ATOL = 1e-4
TOL = {'complex64': 1e-5, 'complex128': 1e-10}
SEARCH = dict(max_time=1, max_repeats=4)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLANS = os.path.join(ROOT, 'scripts', '_plan_cache')


def _both_rqc(n, n_gates, seed):
    """The same random circuit in each package, after an H layer, so
    that every qubit is active whatever the draw."""
    out = []
    for pkg, rqc in ((J, j_rqc), (T, t_rqc)):
        np.random.seed(seed)
        out.append(pkg.Circuit([pkg.Gate('H', qubits=[q])
                                for q in range(n)]) +
                   rqc(n, n_gates, indexes=list(range(n))))
    return out


def _fsim_layered(pkg, n, depth, seed=0):
    """``tests/test_tn.py``'s supremacy-style network in ``pkg``: 1-qubit
    sqrt gates and diagonal couplers, which ``simplify_tn='full'`` turns
    into hyperedges."""
    rng = np.random.default_rng(seed)
    c = pkg.Circuit()
    for d in range(depth):
        for q in range(n):
            c.append(pkg.Gate(str(rng.choice(['SQRT_X', 'SQRT_Y', 'T',
                                              'H'])), [q]))
        for q in range(d % 2, n - 1, 2):
            r = rng.random()
            if r < 0.4:
                c.append(pkg.Gate('FSIM', [q, q + 1],
                                  params=[np.pi / 2, np.pi / 6]))
            elif r < 0.7:
                c.append(pkg.Gate('CZ', [q, q + 1]))
            else:
                c.append(pkg.Gate('CPHASE', [q, q + 1],
                                  params=[float(rng.random())]))
    return c


def _net(pkg, utils, build, c, initial, final, simplify, ctype):
    if simplify != 'full':
        c = pkg.Circuit(utils.to_matrix_gate(b, complex_type=ctype)
                        for b in utils.compress(c, 2))
    return build(c, initial, final, complex_type=ctype, simplify=simplify)


# (n, gates or depth, final state, simplify, log2 slice target or None)
CASES = {
    'open': (6, 40, '.' * 6, True, None),
    'sliced': (8, 100, '0' * 8, True, 6),
    'hyper_sliced': (6, 10, '0..0..', 'full', 2),
    'hyper_open': (6, 6, '.' * 6, 'full', None),
}


def _case(name, ctype='complex64'):
    """JAX's network, tree and slice set for a case, and the port's
    network built by the port from the same circuit."""
    n, m, final, simplify, target = CASES[name]
    if simplify == 'full':
        cj, ct = _fsim_layered(J, n, m, 3), _fsim_layered(T, n, m, 3)
    else:
        cj, ct = _both_rqc(n, m, 11)
    jnet, oo = _net(J, jutils, j_build_tn, cj, '0' * n, final, simplify,
                    ctype)
    tnet, too = _net(T, tutils, t_build_tn, ct, '0' * n, final, simplify,
                     ctype)
    assert too == oo
    inputs = [t.inds for t in jnet.tensors]
    size_dict = {i: d for t in jnet.tensors
                 for i, d in zip(t.inds, t.data.shape)}
    jtree = j_find_path(inputs, oo, size_dict, max_repeats=4, seed=0)
    sliced = frozenset()
    if target is not None:
        sliced, _ = j_find_slices(jtree, 2 ** target)
        assert len(sliced) >= 2
    return jnet, tnet, jtree, sliced, oo


@pytest.mark.parametrize('name', sorted(CASES))
def test_network_and_plan_match_jax(name):
    """The port builds the same network, and its ``ContractionPlan`` of
    the carried tree lists JAX's steps, effective indices and leaf
    slices (hyperedge steps included)."""
    jnet, tnet, jtree, sliced, oo = _case(name)
    assert [t.inds for t in tnet.tensors] == [t.inds for t in jnet.tensors]
    for a, b in zip(tnet.tensors, jnet.tensors):
        np.testing.assert_allclose(a.data, b.data, atol=1e-6)
    cnet, ttree = tn_from_reference(jnet, jtree)
    jp = jcontract.ContractionPlan(jtree, sliced)
    tp = tcontract.ContractionPlan(ttree, sliced)
    assert tp.steps == jp.steps and tp.eff == jp.eff
    assert tp.leaf_slices == jp.leaf_slices and tp.sliced == jp.sliced
    assert tp.nslices == jp.nslices and tp.root == jp.root
    if CASES[name][3] == 'full':
        assert any(s[5] is not None for s in tp.steps)   # hyperedges


def _ranges(nslices):
    cuts = sorted({0, nslices // 3, (2 * nslices) // 3 + 1, nslices})
    return list(zip(cuts[:-1], cuts[1:]))


@pytest.mark.parametrize('ctype', ['complex64', 'complex128'])
@pytest.mark.parametrize('name', ['open', 'sliced', 'hyper_sliced'])
def test_torch_executor_matches_contract_np(name, ctype):
    """``contract_torch`` on the CPU against JAX's ``contract_np`` on the
    carried tree: the full sum and every partial range, and against
    ``contract_jax`` (its vmap path: these trees have at most 40 steps
    and rank 12) in complex64, since JAX without x64 contracts complex128
    in f32."""
    jnet, _, jtree, sliced, oo = _case(name, ctype)
    tnet, ttree = tn_from_reference(jnet, jtree)
    jsc = jcontract.SlicedContractor(jcontract.ContractionPlan(jtree, sliced),
                                     jnet.tensors, oo, complex_type=ctype)
    tsc = tcontract.SlicedContractor(tcontract.ContractionPlan(ttree, sliced),
                                     tnet.tensors, oo, complex_type=ctype)
    want = jsc.contract_np()
    scale = np.abs(want).max()
    got = tsc.contract_torch(device='cpu')
    assert got.dtype == np.dtype(ctype) and got.shape == want.shape
    assert np.abs(got - want).max() / scale <= TOL[ctype]
    if tsc.nslices > 1:
        for r in _ranges(tsc.nslices):
            part = tsc.contract_torch(device='cpu', slice_range=r)
            ref = jsc.contract_np(slice_range=r)
            assert np.abs(part - ref).max() / scale <= TOL[ctype], r
    if ctype == 'complex64':
        assert len(jsc.plan.steps) <= 40
        assert max(len(x) for x in jsc.plan.eff.values()) <= 12
        assert np.abs(got - jsc.contract_jax()).max() / scale <= TOL[ctype]
        if tsc.nslices > 1:
            r = (1, tsc.nslices - 1)
            assert np.abs(tsc.contract_torch(device='cpu', slice_range=r) -
                          jsc.contract_jax(slice_range=r)).max() / scale \
                <= TOL[ctype]


@pytest.mark.parametrize('chunk', [1, 3])
def test_torch_executor_chunks_and_invariant_subtrees(chunk, monkeypatch):
    """Any chunk of slices (3 leaves a partial last chunk) gives the same
    sum; a step whose subtree carries no sliced index runs once a call,
    a batched step once a chunk of the slices that select no all-zero
    leaf row; TF32 is off inside and the caller's flags come back."""
    jnet, _, jtree, sliced, oo = _case('sliced')
    tnet, ttree = tn_from_reference(jnet, jtree)
    tsc = tcontract.SlicedContractor(tcontract.ContractionPlan(ttree, sliced),
                                     tnet.tensors, oo)
    want = jcontract.SlicedContractor(
        jcontract.ContractionPlan(jtree, sliced), jnet.tensors,
        oo).contract_np()
    batched, steps = tsc.schedule()
    n_fixed = sum(not batched[v] for v, *_ in steps)
    n_batched = len(steps) - n_fixed
    assert n_fixed > 0 and n_batched > 0

    calls, tf32 = [], []
    step = tcontract._step

    def counting(x, y, op):
        calls.append(op)
        tf32.append(torch.backends.cuda.matmul.allow_tf32)
        return step(x, y, op)

    monkeypatch.setattr(tcontract, '_step', counting)
    monkeypatch.setattr(tsc, '_chunk', lambda: chunk)
    monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', True)
    got = tsc.contract_torch(device='cpu')
    kept = int(tsc.nonzero_slices().sum())
    assert tsc.last_counts == {'asked': tsc.nslices, 'contracted': kept}
    n_chunks = -(-kept // chunk)
    assert len(calls) == n_fixed + n_chunks * n_batched
    assert not any(tf32) and torch.backends.cuda.matmul.allow_tf32
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


# (initial state, final state, boundary legs added to the slices, slice
# ranges): '0' and '1' boundary vectors each have an all-zero row
ZERO_CASES = {
    'zero_rows': ('010000', '000000', ('q__0_i', 'q__1_i', 'q__2_f'),
                  'thirds'),
    'all_zero': ('010000', '000000', ('q__0_i', 'q__1_i', 'q__2_f'),
                 'zero run'),
    'open_legs': ('000000', '..0100', ('q__0_i', 'q__3_f'), 'thirds'),
    'no_zero_rows': ('++++++', '......', (), 'thirds'),
    'inf_leaf': ('010000', '000000', ('q__0_i', 'q__1_i', 'q__2_f'),
                 'thirds'),
}


def _nonzero_count(tensors, sliced, ids):
    """How many of the slice ids ``ids`` leave no tensor all zero, read
    from the tensors alone: slice ``s`` fixes ``sorted(sliced)[j]`` to bit
    ``j`` of ``s``.  Every id counts where a tensor holds a value that is
    not finite (``0 * inf`` is NaN)."""
    if not all(np.isfinite(t.data).all() for t in tensors):
        return len(ids)
    order = sorted(sliced)
    count = 0
    for s in ids:
        count += all(np.any(t.data[tuple(
            (s >> order.index(i)) & 1 if i in sliced else slice(None)
            for i in t.inds)]) for t in tensors)
    return count


@pytest.mark.parametrize('ctype', ['complex64', 'complex128'])
@pytest.mark.parametrize('case', sorted(ZERO_CASES))
def test_torch_executor_skips_zero_slices(case, ctype):
    """A forced-slicing plan whose sliced legs include legs of '0' and '1'
    boundary vectors: ``contract_torch`` contracts only the slices that
    select no all-zero row (``last_counts`` against a count from the
    tensors), and every range sums to JAX's ``contract_np`` of all its
    slices.  A range of zero slices gives zeros of the output's shape and
    dtype; with no zero row, or with an ``inf`` in a leaf, nothing is
    skipped, and the ``inf`` gives NaN where ``contract_np`` does."""
    initial, final, boundary, ranges = ZERO_CASES[case]
    cj, _ = _both_rqc(6, 30, 11)
    jnet, oo = _net(J, jutils, j_build_tn, cj, initial, final, False, ctype)
    if case == 'inf_leaf':
        t = next(t for t in jnet.tensors if len(t.inds) == 4)
        t.data = t.data.copy()
        t.data.flat[5] = np.inf
    inputs = [t.inds for t in jnet.tensors]
    size_dict = {i: d for t in jnet.tensors
                 for i, d in zip(t.inds, t.data.shape)}
    jtree = j_find_path(inputs, oo, size_dict, max_repeats=4, seed=0)
    sliced, _ = j_find_slices(jtree, 2 ** 4)
    sliced = frozenset(sliced) | frozenset(boundary)
    tnet, ttree = tn_from_reference(jnet, jtree)
    jsc = jcontract.SlicedContractor(jcontract.ContractionPlan(jtree, sliced),
                                     jnet.tensors, oo, complex_type=ctype)
    tsc = tcontract.SlicedContractor(tcontract.ContractionPlan(ttree, sliced),
                                     tnet.tensors, oo, complex_type=ctype)
    assert 4 <= tsc.nslices <= 256
    n_all = _nonzero_count(jnet.tensors, sliced, range(tsc.nslices))
    if case in ('no_zero_rows', 'inf_leaf'):
        assert n_all == tsc.nslices
    else:
        assert 0 < n_all < tsc.nslices
    want = jsc.contract_np()
    scale = np.abs(want).max()
    if ranges == 'zero run':
        keep = [_nonzero_count(jnet.tensors, sliced, [s])
                for s in range(tsc.nslices)]
        a = max(range(tsc.nslices), key=lambda s: keep[s:].index(1)
                if 1 in keep[s:] else tsc.nslices - s)
        b = keep.index(1, a) if 1 in keep[a:] else tsc.nslices
        assert b - a >= 2
        todo = [(a, b)]
    else:
        todo = [None] + _ranges(tsc.nslices)
    for r in todo:
        ids = range(*(r or (0, tsc.nslices)))
        got = tsc.contract_torch(device='cpu', slice_range=r)
        ref = jsc.contract_np(slice_range=r)
        assert tsc.last_counts == {
            'asked': len(ids),
            'contracted': _nonzero_count(jnet.tensors, sliced, ids)}, r
        assert got.dtype == np.dtype(ctype) and got.shape == ref.shape
        if ranges == 'zero run':
            assert tsc.last_counts['contracted'] == 0
            assert np.array_equal(got, np.zeros_like(ref))
            assert np.array_equal(ref, np.zeros_like(ref))
        elif case == 'inf_leaf':
            assert np.isnan(ref).all()
            assert np.array_equal(np.isnan(got), np.isnan(ref)), r
        else:
            assert np.abs(got - ref).max() / scale <= TOL[ctype], r


def test_d12_plan_keeps_the_nonzero_slices():
    """The committed Sycamore-53 depth-12 plan, on the host, contracting
    nothing: 4,096 of its 65,536 slices select no all-zero leaf row (slice
    id bits 2, 8, 14 and 15 read 0 in each), and each of the 32 ranges of
    256 that hold one keeps 128."""
    path = os.path.join(ROOT, 'benchmark', 'data', 'syc53_d12_s0_t26.pkl')
    net, oo, tree, sliced, _ = load_reference_plan(path)
    sc = tcontract.SlicedContractor(tcontract.ContractionPlan(tree, sliced),
                                    net.tensors, oo)
    keep = sc.nonzero_slices()
    assert keep.shape == (2 ** 16,) and keep.sum() == 4096
    ids = np.nonzero(keep)[0]
    assert not np.any(ids & (1 << 2 | 1 << 8 | 1 << 14 | 1 << 15))
    per_range = keep.reshape(-1, 256).sum(1)
    assert sorted(Counter(per_range.tolist()).items()) == [(0, 224),
                                                           (128, 32)]
    a = 256 * int(np.nonzero(per_range)[0][0])
    assert np.array_equal(sc.nonzero_slices((a, a + 256)),
                          keep[a:a + 256])


def _evolution(c, initial_state='0'):
    return np.asarray(j_simulate(c, initial_state=initial_state,
                                 complex_type='complex128'))


@pytest.mark.parametrize('n, m', [(4, 20), (6, 30)])
def test_simulate_tn_full_amplitudes(n, m, seed):
    cj, ct = _both_rqc(n, m, seed)
    got = t_simulate(ct, initial_state='0', final_state='.', optimize='tn',
                     device='cpu', **SEARCH)
    np.testing.assert_allclose(got, _evolution(cj), atol=ATOL)


def test_simulate_tn_single_amplitude_and_open_qubits(seed):
    n = 5
    cj, ct = _both_rqc(n, 25, seed)
    psi = _evolution(cj)
    for final, want in (('00000', psi[(0,) * 5]),
                        ('01011', psi[0, 1, 0, 1, 1]),
                        ('0..00', psi[0, :, :, 0, 0])):
        got = t_simulate(ct, initial_state='0', final_state=final,
                         optimize='tn', device='cpu', **SEARCH)
        np.testing.assert_allclose(got, want, atol=ATOL)


def test_simulate_tn_plus_initial_state(seed):
    cj, ct = _both_rqc(4, 15, seed)
    got = t_simulate(ct, initial_state='+', final_state='.', optimize='tn',
                     device='cpu', **SEARCH)
    np.testing.assert_allclose(got, _evolution(cj, '+'), atol=ATOL)


def test_simulate_tn_forced_slicing(seed):
    """A small ``max_largest_intermediate`` forces slices on a closed
    amplitude; the sum is the unsliced one and the evolution's."""
    n = 6
    cj, ct = _both_rqc(n, 30, seed)
    full = t_simulate(ct, initial_state='0', final_state='0' * n,
                      optimize='tn', device='cpu', **SEARCH)
    out, info = t_simulate(ct, initial_state='0', final_state='0' * n,
                           optimize='tn', device='cpu',
                           max_largest_intermediate=2 ** 2,
                           return_info=True, **SEARCH)
    assert info['n_slices'] > 1
    np.testing.assert_allclose(complex(out), complex(full), atol=ATOL)
    np.testing.assert_allclose(complex(out), _evolution(cj)[(0,) * n],
                               atol=ATOL)


def test_simulate_tn_trace_letters():
    got = t_simulate(T.Circuit([T.Gate('H', [0])]), initial_state='a',
                     final_state='a', optimize='tn', device='cpu',
                     compress=0, simplify=False)
    np.testing.assert_allclose(complex(got), 0, atol=ATOL)
    c2 = T.Circuit([T.Gate('T', [0]), T.Gate('X', [1])])
    got2 = t_simulate(c2, initial_state='ab', final_state='ab',
                      optimize='tn', device='cpu', compress=0,
                      simplify=False)
    want = np.trace(J.Gate('T').matrix()) * np.trace(J.Gate('X').matrix())
    np.testing.assert_allclose(complex(got2), want, atol=ATOL)


@pytest.mark.parametrize('final, target', [('.', None), ('0', 2 ** 3)])
def test_simulate_tn_full_simplify_hyperedges(final, target):
    """``simplify_tn='full'`` (hyperedge indices), open and sliced."""
    n = 6
    seed = 0 if target is None else 3
    cj, ct = _fsim_layered(J, n, 6 + 2 * (target is not None), seed), \
        _fsim_layered(T, n, 6 + 2 * (target is not None), seed)
    psi = _evolution(cj)
    kw = {} if target is None else {'max_largest_intermediate': target}
    got, info = t_simulate(ct, initial_state='0', final_state=final * n,
                           optimize='tn', device='cpu', simplify_tn='full',
                           return_info=True, **SEARCH, **kw)
    if target is None:
        np.testing.assert_allclose(got, psi, atol=ATOL)
    else:
        assert info['n_slices'] > 1
        np.testing.assert_allclose(complex(got), psi[(0,) * n], atol=ATOL)


def test_simulate_tn_random_token_states(seed):
    """Random 0/1/./letter tokens on both boundaries against a dense
    einsum of the circuit's complex128 matrix (``tests/test_tn.py``'s
    oracle)."""
    rng = np.random.default_rng(seed)
    n = 5
    cj, ct = _both_rqc(n, 20, seed)
    cj = cj + J.Circuit(J.Gate('H', [q]) for q in range(n))
    ct = ct + T.Circuit(T.Gate('H', [q]) for q in range(n))
    U = jutils.matrix(cj, complex_type='complex128').reshape((2,) * (2 * n))
    vec = {'0': np.array([1., 0]), '1': np.array([0., 1])}
    for _ in range(3):
        initial = [str(rng.choice(list('01.ab'))) for _ in range(n)]
        final = [str(rng.choice(list('01.ab'))) for _ in range(n)]
        cnt = Counter(x for x in initial + final if x.isalpha())
        initial = ['0' if x.isalpha() and cnt[x] < 2 else x
                   for x in initial]
        final = ['0' if x.isalpha() and cnt[x] < 2 else x for x in final]
        got = t_simulate(ct, initial_state=''.join(initial),
                         final_state=''.join(final), optimize='tn',
                         device='cpu', **SEARCH)
        # U's axes: final legs 0..n-1, initial legs n..2n-1; a letter
        # gives every leg it names one label
        labels = list(range(2 * n))
        letter = {}
        operands = []
        opened = {0: [], 1: []}
        for side, tokens in ((1, initial), (0, final)):
            for q, tok in enumerate(tokens):
                ax = side * n + q
                if tok == '.':
                    opened[side].append(ax)
                elif tok in vec:
                    operands += [vec[tok], [ax]]
                else:
                    labels[ax] = letter.setdefault(tok, 2 * n + len(letter))
        out = [labels[ax] for ax in opened[1] + opened[0]]
        want = np.einsum(U, labels, *operands, out)
        np.testing.assert_allclose(got, want, atol=ATOL)


def test_simulate_tn_tensor_only_and_pickle_round_trip(seed):
    n = 5
    cj, ct = _both_rqc(n, 20, seed)
    want = _evolution(cj)
    net, plan = t_simulate(ct, initial_state='0', final_state='.',
                           optimize='tn', tensor_only=True, device='cpu',
                           **SEARCH)
    got = t_simulate(net, optimize=plan, device='cpu',
                     max_largest_intermediate=2 ** (n - 1), **SEARCH)
    np.testing.assert_allclose(got, want, atol=ATOL)
    net2, plan2 = pickle.loads(pickle.dumps((net, plan)))
    got2 = t_simulate(net2, optimize=plan2, backend='numpy', **SEARCH)
    np.testing.assert_allclose(got2, want, atol=ATOL)


def test_make_plan_slice_ranges_sum_to_full(seed):
    """One pre-sliced plan, reused: every partial range on the torch
    executor, summed, is the full contraction of both backends."""
    n = 7
    cj, ct = _both_rqc(n, 50, seed)
    net, plan = t_simulate(ct, initial_state='0', final_state='0' * n,
                           optimize='tn', tensor_only=True, device='cpu',
                           **SEARCH)
    info, cplan = make_plan(plan, target_size=2 ** 2, time_budget=1)
    assert cplan.nslices > 1
    full = t_simulate(net, optimize=(info, cplan), device='cpu')
    np.testing.assert_allclose(complex(full), _evolution(cj)[(0,) * n],
                               atol=ATOL)
    parts = [t_simulate(net, optimize=(info, cplan), device='cpu',
                        slice_range=r) for r in _ranges(cplan.nslices)]
    np.testing.assert_allclose(complex(sum(parts)), complex(full),
                               atol=1e-6)
    ref = t_simulate(net, optimize=(info, cplan), backend='numpy')
    np.testing.assert_allclose(complex(ref), complex(full), atol=1e-6)


def test_dm_via_tn_engine():
    """``tests/test_dm_noise.py::test_dm_via_tn_engine`` on the port:
    the doubled circuit through the TN engine against JAX's complex128
    DM evolution."""
    from hybridq_tpu import dm as jdm
    from hybridq_tpu.noise import add_depolarizing_noise as j_noise
    from hybridq_tpu_torch import dm as tdm
    from hybridq_tpu_torch.noise import add_depolarizing_noise as t_noise

    def circ(pkg):
        return pkg.Circuit([pkg.Gate('H', [0]), pkg.Gate('CX', [0, 1]),
                            pkg.Gate('T', [1])])

    want = np.asarray(jdm.simulate(j_noise(circ(J), probs=0.1),
                                   initial_state='0',
                                   complex_type='complex128'))
    got = tdm.simulate(t_noise(circ(T), probs=0.1), initial_state='0',
                       optimize='tn', final_state='.', device='cpu',
                       **SEARCH)
    np.testing.assert_allclose(got.reshape(4, 4), want.reshape(4, 4),
                               atol=ATOL)


def test_load_reference_plan_matches_jax():
    """The committed Sycamore-53 depth-12 plan, read without the JAX
    package, is the plan JAX reads: 234 steps, 2^16 slices."""
    path = os.path.join(PLANS, 'syc53_d12_s0_t26.pkl')
    tnet, too, ttree, tsl, tcost = load_reference_plan(path)
    with open(path, 'rb') as f:
        jnet, joo, jtree, jsl, jcost = pickle.load(f)
    assert type(ttree).__module__ == 'hybridq_tpu_torch.simulation.tn.path'
    assert type(tcost).__module__ == \
        'hybridq_tpu_torch.simulation.tn.slicer'
    tp = tcontract.ContractionPlan(ttree, tsl)
    jp = jcontract.ContractionPlan(jtree, jsl)
    assert len(tp.steps) == 234 and tp.nslices == 2 ** 16
    assert tp.steps == jp.steps and tp.eff == jp.eff
    assert tp.sliced == jp.sliced and tp.leaf_slices == jp.leaf_slices
    assert too == joo and tcost.nslices == jcost.nslices
    assert [t.inds for t in tnet.tensors] == [t.inds for t in jnet.tensors]
    assert all(np.array_equal(a.data, b.data)
               for a, b in zip(tnet.tensors, jnet.tensors))


def test_load_reference_plan_refuses_other_jax_classes(tmp_path):
    path = tmp_path / 'gate.pkl'
    path.write_bytes(pickle.dumps(J.Gate('H', [0])))
    with pytest.raises(pickle.UnpicklingError, match='no counterpart'):
        load_reference_plan(path)


def test_native_library_matches_jax(monkeypatch, tmp_path):
    """The port's build of the same C++ sources gives JAX's bipartition
    and optimal subpath on a fixed seed."""
    if not jnative.hgp_available():
        # JAX's loader builds next to its sources and loads whatever file
        # is there, so a worker that looked while another one's g++ was
        # writing it finds no library: build a private copy instead.
        monkeypatch.setattr(jnative, '_DIR', str(tmp_path))
        monkeypatch.setattr(jnative, '_lib', None)
        monkeypatch.setattr(jnative, '_tried', False)
    assert tnative.hgp_available() and jnative.hgp_available()
    rng = np.random.default_rng(3)
    n_nodes = 40
    nets = [sorted(rng.choice(n_nodes, size=int(rng.integers(2, 5)),
                              replace=False).tolist()) for _ in range(90)]
    w = rng.uniform(0.5, 2.0, len(nets)).tolist()
    for eps, s in ((0.1, 0), (0.47, 7)):
        lt, ct = tnative.bipartition(nets, w, n_nodes, eps=eps, seed=s)
        lj, cj = jnative.bipartition(nets, w, n_nodes, eps=eps, seed=s)
        np.testing.assert_array_equal(lt, lj)
        assert ct == cj
    jnet, _, jtree, _, oo = _case('open')
    sub = [t.inds for t in jnet.tensors][:12]
    sd = {i: 2 for inds in sub for i in inds}
    out = sorted({i for inds in sub for i in inds})[:4]
    assert tnative.optimal_subpath(sub, out, sd) == \
        jnative.optimal_subpath(sub, out, sd)


def test_greedy_is_opt_einsum_greedy():
    """The port's greedy (no opt_einsum on the card) picks opt_einsum's
    ``greedy`` path, pair for pair, on plain and hyperedge networks."""
    import opt_einsum as oe

    for name in ('open', 'sliced', 'hyper_open'):
        jnet, _, _, _, oo = _case(name)
        inputs = [t.inds for t in jnet.tensors]
        sd = {i: d for t in jnet.tensors for i, d in zip(t.inds,
                                                         t.data.shape)}
        want = oe.paths.ssa_greedy_optimize([frozenset(x) for x in inputs],
                                            frozenset(oo), sd)
        assert _greedy_ssa(inputs, oo, sd) == [tuple(p) for p in want]


@pytest.mark.parametrize('ctype, atol', [('complex64', 1e-6),
                                         ('complex128', 1e-12)])
@pytest.mark.parametrize('optimize', ['evolution-einsum',
                                      'evolution-einsum-opt'])
def test_evolution_einsum_matches_jax(optimize, ctype, atol, seed):
    n = 8
    cj, ct = _both_rqc(n, 40, seed)
    want = np.asarray(j_simulate(cj, initial_state='0', optimize=optimize,
                                 complex_type=ctype, backend='numpy'))
    got, info = t_simulate(ct, initial_state='0', optimize=optimize,
                           complex_type=ctype, device='cpu',
                           return_info=True)
    assert info['engine'] == 'einsum' and got.dtype == np.dtype(ctype)
    np.testing.assert_allclose(got, want, atol=atol)


def test_evolution_einsum_label_limit(monkeypatch):
    """``torch.einsum`` takes 52 labels: n + k above that is refused with
    a ValueError, not a failure inside torch, before any state is
    made."""
    from hybridq_tpu_torch.simulation import prepare

    def no_state(*args, **kwargs):
        raise AssertionError("a state was prepared")

    monkeypatch.setattr(prepare, 'prepare_state', no_state)
    c = T.Circuit([T.Gate('H', [q]) for q in range(50)] +
                  [T.Gate('CX', [0, 1]), T.Gate('CX', [2, 3])])
    with pytest.raises(ValueError, match='52'):
        t_simulate(c, initial_state='0', optimize='evolution-einsum',
                   device='cpu', compress=4, simplify=False,
                   max_largest_intermediate=2 ** 60)


def test_native_build_failure_warns_once(monkeypatch, tmp_path):
    """A failed g++ build warns once, with the compiler's output, and
    path search goes on without the library (the graceful fallback)."""
    import warnings

    monkeypatch.setattr(tnative, '_lib', None)
    monkeypatch.setattr(tnative, '_tried', False)
    monkeypatch.setattr(tnative, '_BUILD_DIR', str(tmp_path))
    monkeypatch.setattr(tnative, '_FLAGS',
                        tnative._FLAGS + ['-fno-such-flag-here'])
    with pytest.warns(UserWarning, match='no-such-flag-here'):
        assert not tnative.hgp_available()
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        assert not tnative.hgp_available()
    assert list(tmp_path.iterdir()) == []
