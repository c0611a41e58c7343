"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA device and skips without one.  The file
imports nothing of JAX and needs no fixture of ``tests/conftest.py``, so
on the card it runs without the JAX test setup:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

Tolerance: max|d| <= 1e-5 on a unit-norm state -- f32 sums taken in
another order than ``torch.matmul``'s.  The probes' copies and gathers are
exact (doubling and bf16 rounding are exact); their dots are held against
float64: one TF32 pass within [1e-5, 1e-2] (f32 accuracy would mean the
tensor cores were not used), 3xTF32 within 1e-5.
"""

import numpy as np
import pytest
import torch

from hybridq_tpu_torch.probes import bw, fused_k4, gather
from hybridq_tpu_torch.simulation import fused_kernels as fk
from hybridq_tpu_torch.simulation import row_kernels as rk
from hybridq_tpu_torch.simulation.fused_evolver import FusedEvolver

ATOL = 1e-5
FUSED_CLASSES = [0, 1, 2, 3, 4]
SWAP_CLASSES = [(1, 1), (2, 1), (3, 1), (4, 1), (2, 2), (3, 2), (4, 2)]

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the card: python -m pytest "
                    "--noconftest -m gpu tests/test_torch_cuda.py)")
    return torch.device('cuda')


def _rand_u(k, rng):
    m = rng.standard_normal((2**k, 2**k)) + \
        1j * rng.standard_normal((2**k, 2**k))
    return np.linalg.qr(m)[0]


def _rand_state(n, rng, device):
    st = rng.standard_normal(2**(n + 1)).astype(np.float32)
    return torch.from_numpy(st / np.linalg.norm(st)).to(device)


def _class_gate(n, k_hi, k_l, rng):
    """Random bits of a routing class (see test_torch_fused_kernels)."""
    high = [int(b) for b in rng.choice(range(12, n), k_hi + k_l,
                                       replace=False)]
    gate_hi, victims = high[:k_hi], high[k_hi:]
    k_sub = int(rng.integers(0 if k_hi + k_l else 1, 3))
    sub = [int(b) for b in rng.choice(range(7, 12), k_sub, replace=False)]
    lane = [int(b) for b in rng.choice(7, k_l, replace=False)]
    bits = gate_hi + sub + lane
    rng.shuffle(bits)
    return bits, victims


@pytest.mark.parametrize('kind, cls', [('fused', (k,))
                                       for k in FUSED_CLASSES] +
                         [('swap', c) for c in SWAP_CLASSES])
def test_cuda_kernel_matches_plain(kind, cls, cuda):
    rng = np.random.default_rng(sum(cls) + 10 * len(cls))
    n = 22
    k_hi, k_l = (cls[0], 0) if kind == 'fused' else (cls[0] - cls[1],
                                                     cls[1])
    bits, victims = _class_gate(n, k_hi, k_l, rng)
    U = torch.as_tensor(_rand_u(len(bits), rng), dtype=torch.complex64,
                        device=cuda)
    st = _rand_state(n, rng, cuda)
    a, b = st.clone(), st.clone()
    fk.reset_counts()
    if kind == 'fused':
        fk.apply_fused(a, U, bits)
        fk.apply_fused_plain(b, U, bits)
    else:
        fk.apply_swap(a, U, bits, victims)
        fk.apply_swap_plain(b, U, bits, victims)
    torch.cuda.synchronize()
    assert fk.counts()['fused_apply' if kind == 'fused'
                       else 'swap_apply'] == 1
    assert (a - b).abs().max().item() <= ATOL


@pytest.mark.parametrize('k', range(1, 9))
def test_cuda_fused_every_gate_size(k, cuda):
    rng = np.random.default_rng(k)
    n = 20
    bits = [int(b) for b in rng.choice(range(7, n), k, replace=False)]
    U = torch.as_tensor(_rand_u(k, rng), dtype=torch.complex64,
                        device=cuda)
    st = _rand_state(n, rng, cuda)
    a, b = st.clone(), st.clone()
    fk.apply_fused(a, U, bits)
    fk.apply_fused_plain(b, U, bits)
    torch.cuda.synchronize()
    assert (a - b).abs().max().item() <= ATOL


def test_cuda_evolver_matches_cpu_evolver(cuda):
    """Same gates on the card and on the host: same routing, same
    containers within f32 rounding."""
    n = 18
    rng = np.random.default_rng(7)
    ev_c, ev_h = FusedEvolver(n, device=cuda), FusedEvolver(n, device='cpu')
    s_c, s_h = ev_c.prepare_state('+' * n), ev_h.prepare_state('+' * n)
    for _ in range(12):
        k = int(rng.integers(1, 5))
        qs = tuple(int(q) for q in rng.choice(n, k, replace=False))
        U = _rand_u(k, rng)
        s_c = ev_c.apply_gate(s_c, U, qs)
        s_h = ev_h.apply_gate(s_h, U, qs)
        assert ev_c.phys == ev_h.phys
    assert (s_c.cpu() - s_h).abs().max().item() <= ATOL
    got = ev_c.gather(s_c).cpu()
    want = ev_h.gather(s_h)
    assert (got - want).abs().max().item() <= ATOL


@pytest.mark.parametrize('n, bits', [(8, [7]), (11, [10, 7]),
                                     (12, [7, 11, 9, 8, 10]), (13, [12, 9])])
def test_cuda_fused_below_one_tile(n, bits, cuda):
    """Registers smaller than the kernel's 2^13-amplitude tile."""
    rng = np.random.default_rng(n)
    U = torch.as_tensor(_rand_u(len(bits), rng), dtype=torch.complex64,
                        device=cuda)
    st = _rand_state(n, rng, cuda)
    a, b = st.clone(), st.clone()
    fk.apply_fused(a, U, bits)
    fk.apply_fused_plain(b, U, bits)
    torch.cuda.synchronize()
    assert (a - b).abs().max().item() <= ATOL


@pytest.mark.parametrize('n, L, positions', [
    (11, 10, (0,)), (12, 10, (1, 0)), (14, 10, (1, 3, 0, 2)),
    (20, 10, (9, 0, 7, 2, 5, 1, 8, 3)),
])
def test_cuda_gate_rows_matches_plain(n, L, positions, cuda):
    rng = np.random.default_rng(n + len(positions))
    U = _rand_u(len(positions), rng)
    re = torch.from_numpy(rng.standard_normal(2**n).astype(np.float32))
    im = torch.from_numpy(rng.standard_normal(2**n).astype(np.float32))
    a = re.to(cuda), im.to(cuda)
    b = re.to(cuda), im.to(cuda)
    rk.reset_counts()
    rk.apply_gate_rows(*a, U.real, U.imag, positions, n, L)
    rk.apply_gate_rows_plain(*b, U.real, U.imag, positions, n, L)
    torch.cuda.synchronize()
    assert rk.counts() == {'apply_gate_rows': 1, 'apply_gate_rows_plain': 1}
    for x, y in zip(a, b):
        assert (x - y).abs().max().item() <= 1e-4


@pytest.mark.parametrize('row_bits, lane_bits', [
    ((19, 12, 7, 15, 9, 11), (0, 1, 2, 3, 4, 5, 6)),     # one launch
    ((18, 17, 16, 15, 14, 13, 12), (3, 5)),              # two launches
    (tuple(range(19, 10, -1)), tuple(range(6, -1, -1))),  # largest, (9, 7)
])
def test_cuda_factored_largest(row_bits, lane_bits, cuda):
    rng = np.random.default_rng(len(row_bits))
    Ur, Ul = _rand_u(len(row_bits), rng), _rand_u(len(lane_bits), rng)
    st = _rand_state(20, rng, cuda)
    a, b = st.clone(), st.clone()
    fk.apply_factored(a, Ur, row_bits, Ul, lane_bits)
    fk.apply_factored_plain(b, Ur, row_bits, Ul, lane_bits)
    torch.cuda.synchronize()
    assert (a - b).abs().max().item() <= ATOL


@pytest.mark.parametrize('n, bits', [(11, (10, 9, 8, 7)),
                                     (22, (21, 16, 9, 14)),
                                     (22, (7, 8, 20, 13))])
def test_cuda_fused_k4_matches_plain(n, bits, cuda):
    rng = np.random.default_rng(n)
    U = torch.as_tensor(_rand_u(4, rng), dtype=torch.complex64, device=cuda)
    st = _rand_state(n, rng, cuda)
    a, b = st.clone(), st.clone()
    fused_k4.reset_counts()
    fused_k4.apply_fused_k4(a, U, bits)
    fk.apply_fused_plain(b, U, bits)
    torch.cuda.synchronize()
    assert fused_k4.counts() == {'fused_k4_apply': 1}
    assert (a - b).abs().max().item() <= ATOL


@pytest.mark.parametrize('kind, rows, cols, tile, nbuf', [
    ('auto', 64, 1024, 16, 0), ('auto', 100, 256, 24, 0),
    ('aliased', 64, 1024, 16, 0), ('aliased', 100, 256, 7, 0),
    ('manual', 64, 1024, 4, 2), ('manual', 100, 256, 8, 2),
    ('manual', 97, 256, 4, 4),
])
def test_cuda_stream_scale_matches_plain(kind, rows, cols, tile, nbuf, cuda):
    x = torch.randn(rows, cols, generator=torch.Generator().manual_seed(rows))
    x = x.to(cuda)
    v = bw.Variant('test', kind, tile, tile, nbuf)
    bw.reset_counts()
    got = bw.run_variant(v, x.clone())
    torch.cuda.synchronize()
    key = {'auto': 'stream_scale', 'aliased': 'stream_scale_inplace',
           'manual': 'stream_scale_pipelined'}[kind]
    assert bw.counts()[key] == 1
    assert torch.equal(got, bw.scale_plain(x))


@pytest.mark.parametrize('kind, rows', [('auto', 16), ('manual', 4)])
def test_cuda_stream_scale_into_out(kind, rows, cuda):
    x = torch.randn(64, 1024, generator=torch.Generator().manual_seed(3))
    x = x.to(cuda)
    out = torch.full_like(x, float('nan'))
    v = bw.Variant('test', kind, rows, rows, 2)
    assert bw.run_variant(v, x, out=out) is out
    torch.cuda.synchronize()
    assert torch.equal(out, bw.scale_plain(x))


@pytest.mark.parametrize('precision, lo, hi', [('tf32', 1e-5, 1e-2),
                                               ('3xtf32', 0.0, 1e-5)])
def test_cuda_dot_accuracy(precision, lo, hi, cuda):
    a, b = bw.dot_inputs()
    bw.reset_counts()
    got = bw.dot(torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda),
                 precision)
    torch.cuda.synchronize()
    assert bw.counts()[f'dot_{precision}'] == 1
    assert lo <= bw.rel_err(got, a, b) <= hi


@pytest.mark.parametrize('rows, run, blk, matmul, nbuf', [
    (2048, 1, 128, False, 2), (2048, 4, 256, False, 2),
    (2048, 128, 128, False, 2), (2048, 512, 1024, False, 2),
    (2048, 32, 128, True, 2), (2048, 8, 128, False, 4),
    (4096, 2048, 4096, True, 2),
])
def test_cuda_gather_matches_plain(rows, run, blk, matmul, nbuf, cuda):
    x = torch.randn(rows, 128, generator=torch.Generator().manual_seed(run))
    x = x.to(cuda)
    got = x.clone()
    gather.reset_counts()
    gather.gather_scale_(got, run, blk, matmul, nbuf)
    torch.cuda.synchronize()
    assert gather.counts() == {'gather_scale': 1}
    assert torch.equal(got, gather.gather_scale_plain(x, matmul))
