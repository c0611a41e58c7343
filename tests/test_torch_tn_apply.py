"""``tn_kernels.tn_apply`` and the executor that tracks leg orders.

* ``tn_apply_plain`` (the CPU route of ``tn_apply``) against a numpy
  ``einsum`` over every class of ``s`` summed and ``f`` new legs, s, f in
  0..7, whose operator fits in 2^12 entries: the summed legs at random
  places of ``x`` (bits 0-2 included), the operator's legs in a random
  order, either operand batched or both, square steps also in place.
  Tolerances, max|d|/rms against the einsum in complex128 of the same
  inputs: complex64 1e-6 up to s = 5, then 1e-6 sqrt(2^s / 32), as the
  rounding of a sum of 2^s f32 products grows (s = 7 reads 1.1e-6);
  complex128 1e-12.
* ``SlicedContractor.contract_torch(device='cpu')`` against JAX's
  ``contract_np``, the full sum and range for range, on a network built
  so that its schedule holds every kind of step: square (in place),
  growing, shrinking and outer ``'apply'`` steps, an unbatched larger
  operand with a batched smaller one and both batched, a large-by-large
  ``matmul`` and hyperedge ``einsum`` steps, batched and once a call.
  As in ``test_torch_tn.py``: complex64 1e-5 and complex128 1e-10 of
  max|ref|.
* The schedule of the committed Sycamore-53 depth-12 plan, contracting
  nothing: every batched step but the two large-by-large products goes
  to ``tn_apply``.
* Marked ``gpu`` (skipped without a card): the kernel against the plain
  version for every class on the card, max|d|/rms <= 1e-5 (complex64,
  f32 sums in another order) and 1e-12 (complex128); and
  ``contract_torch`` on the card, which leaves out the slices that select
  an all-zero leaf row, against the port's ``contract_np`` range for
  range at the executor's tolerances; on the card:
  ``python -m pytest --noconftest -m gpu tests/test_torch_tn_apply.py``.
"""

import os

import numpy as np
import pytest
import torch

from hybridq_tpu.simulation.tn import contract as jcontract
from hybridq_tpu.simulation.tn.network import Tensor as JTensor
from hybridq_tpu.simulation.tn.network import TensorNetwork as JNetwork
from hybridq_tpu.simulation.tn.path import ContractionTree as JTree
from hybridq_tpu_torch.convert import load_reference_plan, tn_from_reference
from hybridq_tpu_torch.simulation.tn import contract as tcontract
from hybridq_tpu_torch.simulation.tn import tn_kernels as tk

PLAIN_TOL = {np.complex64: 1e-6, np.complex128: 1e-12}
CARD_TOL = {np.complex64: 1e-5, np.complex128: 1e-12}
EXEC_TOL = {'complex64': 1e-5, 'complex128': 1e-10}
MAX_ENTRIES = 12           # log2 of the largest operand of the plain cases
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D12 = os.path.join(ROOT, 'scripts', '_plan_cache', 'syc53_d12_s0_t26.pkl')
LETTERS = 'abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXY'
CLASSES = [(s, f) for s in range(8) for f in range(8)]


def _rand(rng, shape, dtype):
    return np.asarray(rng.standard_normal(shape) +
                      1j * rng.standard_normal(shape), dtype=dtype)


def _steps(rng, s, f, dtype, batch=3):
    """A step of each batching, its operands and the numpy einsum of the
    same inputs in complex128, for the largest ``x`` that keeps ``x`` and
    ``y`` within 2^12 entries (and one with no untouched leg)."""
    for nx in sorted({s, MAX_ENTRIES - max(0, f - s)}):
        for xb, ob in ((1, 0), (0, 1), (1, 1), (0, 0)):
            xbits = [int(b) for b in rng.permutation(nx)[:s]]
            perm = [int(b) for b in rng.permutation(s + f)]
            step = tk.TnStep(nx, xbits, f, perm[:f], perm[f:], xb, ob)
            x = _rand(rng, (batch,) * xb + (2,) * nx, dtype)
            op = _rand(rng, (batch,) * ob + (2,) * (s + f), dtype)
            yield step, x, op, _einsum(step, x, op)


def _einsum(step, x, op):
    """``y`` of ``step`` by numpy, from the leg letters alone."""
    s, f, nx = step.s, step.f, step.nx
    xl = LETTERS[:nx]
    new = LETTERS[nx:nx + f]
    ol = [''] * (s + f)
    for u, b in enumerate(step.orow):
        ol[s + f - 1 - b] = new[u]
    for t, b in enumerate(step.xbits):
        ol[s + f - 1 - step.ocol[t]] = xl[nx - 1 - b]
    yl = ''.join(xl[a] if kind == 'x' else new[a]
                 for kind, a in step.y_axes)
    z = lambda on: 'Z' if on else ''  # noqa: E731
    spec = (f"{z(step.x_batched)}{xl},{z(step.op_batched)}{''.join(ol)}"
            f"->{z(step.batched)}{yl}")
    return np.einsum(spec, x.astype(np.complex128),
                     op.astype(np.complex128))


def _rel(got, want):
    rms = np.sqrt(np.mean(np.abs(want) ** 2))
    return float(np.abs(np.asarray(got) - want).max() / rms)


@pytest.mark.parametrize('s, f', [(s, f) for s, f in CLASSES
                                  if s + f <= MAX_ENTRIES])
def test_tn_apply_plain_matches_einsum(s, f):
    """The CPU route of ``tn_apply``, out of place and (square, batched
    ``x``) in place, in both types."""
    rng = np.random.default_rng(10 * s + f)
    for dtype in (np.complex64, np.complex128):
        tol = PLAIN_TOL[dtype] * max(1.0, np.sqrt(2.0 ** s / 32))
        for step, x, op, want in _steps(rng, s, f, dtype):
            xt, ot = torch.from_numpy(x), torch.from_numpy(op)
            got = tk.tn_apply(xt, ot, step)
            assert got.dtype == xt.dtype and got.is_contiguous()
            assert tuple(got.shape) == want.shape
            assert _rel(got.numpy(), want) <= tol
            if f == s and step.x_batched:
                xc = xt.clone()
                out = tk.tn_apply(xc, ot, step, inplace=True)
                assert out is xc
                assert _rel(xc.numpy(), want) <= tol


def test_tn_apply_checks_its_arguments():
    step = tk.TnStep(4, [3, 0], 2, x_batched=True)
    x = torch.zeros(2, 2, 2, 2, 2, dtype=torch.complex64)
    op = torch.zeros(4, 4, dtype=torch.complex64)
    assert tuple(tk.tn_apply(x, op, step).shape) == (2,) * 5
    with pytest.raises(ValueError, match='one type'):
        tk.tn_apply(x, op.to(torch.complex128), step)
    with pytest.raises(ValueError, match='do not fit'):
        tk.tn_apply(x, torch.zeros(8, 4, dtype=torch.complex64), step)
    with pytest.raises(ValueError, match='no kernel'):
        tk.tn_apply(x.to('meta'), op.to('meta'), step)
    with pytest.raises(ValueError, match='in place'):
        tk.tn_apply(x, torch.zeros(8, 4, dtype=torch.complex64),
                    tk.TnStep(4, [3, 0], 3, x_batched=True), inplace=True)
    for args in (([0, 0], 2), ([4], 1), ([0], 8)):
        with pytest.raises(ValueError):
            tk.TnStep(4, *args)


def test_tn_step_layout():
    """The first min(s, f) new legs take the summed legs' places, the
    others lead; unused summed places are dropped."""
    step, legs = tk.TnStep.from_legs('abcde', 'xbyd', ['b', 'd'])
    assert legs == ('a', 'x', 'c', 'y', 'e') and step.ybits == (3, 1)
    step, legs = tk.TnStep.from_legs('abcde', 'pxbqyd', ['b', 'd'])
    assert legs == ('q', 'y', 'a', 'p', 'c', 'x', 'e')
    step, legs = tk.TnStep.from_legs('abcde', 'xbd', ['b', 'd'])
    assert legs == ('a', 'x', 'c', 'e') and step.ny == 4
    assert tk.TnStep.from_legs('abc', 'xy', [])[1] == ('x', 'y', 'a', 'b',
                                                        'c')


# -- the executor ----------------------------------------------------------

# leaves (indices) and the tree: see _every_class_network
LEAVES = [
    'a0 a1 a2 a3 a4 a5 a6 a7 a8 a9 a10 a11',   # 0: the large operand
    'b0 a3 b1 a6',                              # 1: square, s = f = 2
    'c0 a1 c1 c2',                              # 2: grows, s = 1, f = 3
    'a7 d0 a8 a9',                              # 3: shrinks, s = 3, f = 1
    'e0 e1',                                    # 4: outer, s = 0, f = 2
    'b0 c0 c1 a10 a11 d0 e0 e1 w0',             # 5: large, s = 8
    'h a2', 'h a4',                             # 6, 7: hyperedge h
    'a5 k0',                                    # 8: hyperedge a5, batched
    'z p0 p1',                                  # 9: small, sliced z
    'p0 p1 p2 p3 c2',                           # 10: large, not sliced
    'z q0',                                     # 11
    'a0 r0',                                    # 12: closes sliced a0
]
# (left, right) of nodes 13, 14, ...
TREE = [(0, 12), (13, 1), (14, 2), (15, 3), (16, 4), (6, 7), (17, 18),
        (19, 8), (20, 5), (10, 9), (22, 11), (21, 23)]
OUTPUT = ('q0', 'h', 'r0', 'p3', 'a5', 'w0', 'b1', 'k0', 'p2')
SLICED = frozenset({'a0', 'z'})


def _every_class_network(ctype):
    rng = np.random.default_rng(5)
    inputs = [tuple(t.split()) for t in LEAVES]
    tensors = [JTensor(_rand(rng, (2,) * len(i), ctype), i) for i in inputs]
    avail, path = list(range(len(inputs))), []
    for k, (a, b) in enumerate(TREE):
        path.append((avail.index(a), avail.index(b)))
        avail = [v for v in avail if v not in (a, b)] + [len(inputs) + k]
    size = {i: 2 for t in inputs for i in t}
    jtree = JTree(inputs, OUTPUT, size, path)
    assert jtree.children == {len(inputs) + k: ab
                              for k, ab in enumerate(TREE)}
    return JNetwork(tensors), jtree


@pytest.mark.parametrize('ctype', ['complex64', 'complex128'])
def test_tracked_executor_matches_contract_np(ctype):
    """Every kind of step on the CPU, range for range against JAX."""
    jnet, jtree = _every_class_network(ctype)
    tnet, ttree = tn_from_reference(jnet, jtree)
    jsc = jcontract.SlicedContractor(jcontract.ContractionPlan(jtree, SLICED),
                                     jnet.tensors, OUTPUT, complex_type=ctype)
    tsc = tcontract.SlicedContractor(tcontract.ContractionPlan(ttree, SLICED),
                                     tnet.tensors, OUTPUT, complex_type=ctype)
    batched, steps = tsc.schedule()
    kinds = set()
    for v, a, b, op in steps:
        if op[0] != 'apply':
            kinds.add((op[0], batched[v]))
            continue
        step, _, inplace = op[1:]
        kinds.add('in place' if inplace else
                  'square' if step.f == step.s else
                  'grows' if step.f > step.s else 'shrinks')
        kinds.add(('x', step.x_batched, 'op', step.op_batched))
        kinds.add('outer' if step.s == 0 else 'summed')
    assert kinds >= {'in place', 'grows', 'shrinks', 'outer',
                     ('x', False, 'op', True), ('x', True, 'op', True),
                     ('x', True, 'op', False), ('matmul', True),
                     ('einsum', True), ('einsum', False)}, kinds

    want = jsc.contract_np()
    scale = np.abs(want).max()
    got = tsc.contract_torch(device='cpu')
    assert got.dtype == np.dtype(ctype) and got.shape == want.shape
    assert np.abs(got - want).max() / scale <= EXEC_TOL[ctype]
    for r in ((0, 1), (1, 3), (3, 4)):
        part = tsc.contract_torch(device='cpu', slice_range=r)
        assert np.abs(part - jsc.contract_np(slice_range=r)).max() / scale \
            <= EXEC_TOL[ctype], r
    # the numpy executor runs the plan's own orders: the same sum
    assert np.abs(tsc.contract_np() - want).max() / scale <= \
        EXEC_TOL[ctype]


def test_d12_schedule_sends_the_small_operand_steps_to_tn_apply():
    """The committed Sycamore-53 depth-12 plan, scheduled and not
    contracted: of the 136 batched steps, 134 are ``'apply'`` steps (66
    square on a batched operand, in place) and the two large-by-large
    products are ``'matmul'`` steps; the slice-invariant steps are all
    ``'apply'``; the root's legs map onto the output."""
    net, oo, tree, sliced, _ = load_reference_plan(D12)
    sc = tcontract.SlicedContractor(tcontract.ContractionPlan(tree, sliced),
                                    net.tensors, oo)
    batched, steps = sc.schedule()
    assert sc.schedule() is sc.schedule()
    per_kind = {}
    for v, _, _, op in steps:
        key = (op[0], batched[v])
        per_kind[key] = per_kind.get(key, 0) + 1
    assert per_kind == {('apply', True): 134, ('apply', False): 98,
                        ('matmul', True): 2}
    assert sum(op[0] == 'apply' and op[3] for *_, op in steps) == 66
    assert all(op[1].s <= tk.MAX_LEGS and op[1].f <= tk.MAX_LEGS
               for *_, op in steps if op[0] == 'apply')
    assert sorted(sc.root_perm) == list(range(len(oo)))
    assert tuple(sc.order[sc.plan.root][i] for i in sc.root_perm) == \
        tuple(oo)


def test_permuted_copies_past_25_dims_in_pieces():
    """A permute of 27 axes (a CUDA copy takes 25) goes in pieces over
    the leading axes of the result, and equals one permute."""
    rng = np.random.default_rng(3)
    t = torch.from_numpy(_rand(rng, (3,) + (2,) * 8 + (1,) * 18,
                               np.complex64))
    perm = [int(p) for p in rng.permutation(27)]
    got = tcontract._permuted(t, perm)
    assert got.is_contiguous()
    assert torch.equal(got, t.permute(perm).contiguous())
    assert tcontract._permuted(t, list(range(27))) is t


# -- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the card: python -m pytest "
                    "--noconftest -m gpu tests/test_torch_tn_apply.py)")
    return torch.device('cuda')


@pytest.mark.gpu
@pytest.mark.parametrize('s, f', CLASSES)
def test_cuda_tn_apply_matches_plain(cuda, s, f):
    """The kernel against the plain version on the card, every batching,
    in place where square, at x of up to 2^14 entries a batch entry."""
    rng = np.random.default_rng(10 * s + f)
    for dtype in (np.complex64, np.complex128):
        for nx in sorted({s, s + 1, 14 - max(0, f - s)}):
            for xb, ob in ((1, 0), (0, 1), (1, 1), (0, 0)):
                xbits = [int(b) for b in rng.permutation(nx)[:s]]
                perm = [int(b) for b in rng.permutation(s + f)]
                step = tk.TnStep(nx, xbits, f, perm[:f], perm[f:], xb, ob)
                x = torch.from_numpy(_rand(rng, (3,) * xb + (2,) * nx,
                                           dtype)).to(cuda)
                op = torch.from_numpy(_rand(rng, (3,) * ob + (2,) * (s + f),
                                            dtype)).to(cuda)
                want = tk.tn_apply_plain(x, op, step).cpu().numpy()
                n = tk.launches
                got = tk.tn_apply(x, op, step)
                assert tk.launches == n + 1
                assert _rel(got.cpu().numpy(), want) <= CARD_TOL[dtype]
                if f == s and xb:
                    tk.tn_apply(x, op, step, inplace=True)
                    assert _rel(x.cpu().numpy(), want) <= CARD_TOL[dtype]


def _zero_row_contractor(ctype):
    """The port's own forced-slicing plan (no JAX): an 8-qubit closed
    amplitude, its raw network (the '0' and '1' boundary vectors kept as
    leaves), the slicer's legs and three boundary legs, each of whose
    vectors has an all-zero row."""
    from hybridq_tpu_torch import Circuit, Gate
    from hybridq_tpu_torch.circuit import utils
    from hybridq_tpu_torch.extras.random import get_rqc
    from hybridq_tpu_torch.simulation.tn import build_tn, find_path, \
        find_slices

    np.random.seed(7)
    n = 8
    c = Circuit([Gate('H', qubits=[q]) for q in range(n)]) + \
        get_rqc(n, 60, indexes=list(range(n)))
    c = Circuit(utils.to_matrix_gate(b) for b in utils.compress(c, 2))
    net, order = build_tn(c, '01000000', '00000000', complex_type=ctype,
                          simplify=False)
    inputs = [t.inds for t in net.tensors]
    sizes = {i: d for t in net.tensors for i, d in zip(t.inds, t.data.shape)}
    tree = find_path(inputs, order, sizes, max_repeats=4, seed=0)
    sliced, _ = find_slices(tree, 2 ** 6)
    sliced = frozenset(sliced) | {'q__0_i', 'q__1_i', 'q__2_f'}
    return tcontract.SlicedContractor(tcontract.ContractionPlan(tree, sliced),
                                      net.tensors, order, complex_type=ctype)


@pytest.mark.gpu
@pytest.mark.parametrize('ctype', ['complex64', 'complex128'])
def test_cuda_executor_skips_zero_slices(cuda, ctype):
    """``contract_torch`` on the card leaves out the slices that select an
    all-zero leaf row, as many as ``nonzero_slices`` predicts on the host,
    and sums every range as the port's ``contract_np`` sums all of its
    slices; a range of zero slices gives zeros."""
    sc = _zero_row_contractor(ctype)
    keep = sc.nonzero_slices()
    assert 0 < keep.sum() < sc.nslices
    want = sc.contract_np()
    scale = np.abs(want).max()
    zero = int(np.argmin(keep))
    for r in [None, (zero, zero + 1)] + _thirds(sc.nslices):
        a, b = r or (0, sc.nslices)
        got = sc.contract_torch(device=cuda, slice_range=r)
        ref = sc.contract_np(slice_range=r)
        assert sc.last_counts == {'asked': b - a,
                                  'contracted': int(keep[a:b].sum())}, r
        assert got.dtype == np.dtype(ctype) and got.shape == ref.shape
        assert np.abs(got - ref).max() / scale <= EXEC_TOL[ctype], r
    assert sc.last_counts['contracted'] < sc.last_counts['asked']


def _thirds(nslices):
    cuts = sorted({0, nslices // 3, (2 * nslices) // 3 + 1, nslices})
    return list(zip(cuts[:-1], cuts[1:]))
