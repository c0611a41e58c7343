"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA device and skips without one.  The file
imports nothing of JAX and needs no fixture of ``tests/conftest.py``, so
on the card it runs without the JAX test setup:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

Tolerance: max|d| <= 1e-5 on a unit-norm state -- f32 sums taken in
another order than ``torch.matmul``'s.  The probes' copies and gathers are
exact (doubling and bf16 rounding are exact); their dots are held against
float64: one TF32 pass within [1e-5, 1e-2] (f32 accuracy would mean the
tensor cores were not used) and within 1e-5 of the product of its operands
rounded to TF32, 3xTF32 within 1e-5.
"""

import numpy as np
import pytest
import torch

from hybridq_tpu_torch import Circuit, Gate
from hybridq_tpu_torch.convert import circuit_from_matrices
from hybridq_tpu_torch.probes import bw, fused_k4, gather
from hybridq_tpu_torch.simulation import fused_kernels as fk
from hybridq_tpu_torch.simulation import prepare
from hybridq_tpu_torch.simulation import row_kernels as rk
from hybridq_tpu_torch.simulation import simulate
from hybridq_tpu_torch.simulation.kernels import IndexedEvolver
from tests.test_torch_dot_host import tf32_round

ATOL = 1e-5
FUSED_CLASSES = [0, 1, 2, 3, 4]
SWAP_CLASSES = [(1, 1), (2, 1), (3, 1), (4, 1), (2, 2), (3, 2), (4, 2)]
# SWAP of two bits, the factor of the pair-SWAP permutation of a park
_SW = np.array([[1, 0, 0, 0], [0, 0, 1, 0],
                [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.complex64)

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


def _hold_group(n, bits, lane, victims, rng, device):
    """``hq_group_apply`` through ``fused_kernels._launch`` (any gate and
    victim positions, which ``apply_swap``'s lane/victim checks do not
    take below n = 13) against ``fused_kernels._plain``."""
    U = torch.as_tensor(_rand_u(len(bits), rng), dtype=torch.complex64,
                        device=device)
    st = _rand_state(n, rng, device)
    a, b = st.clone(), st.clone()
    fk._launch(*fk._halves(a, n), U, n, bits, lane, victims)
    fk._plain(*fk._halves(b, n), n, U, bits, lane, victims)
    torch.cuda.synchronize()
    assert (a - b).abs().max().item() <= ATOL


@pytest.mark.parametrize('k, kv', [(k, kv) for k in range(1, 9)
                                   for kv in range(min(k, 2) + 1)])
def test_cuda_fused_every_gate_size(k, kv, cuda):
    """Every gate size at n = 20, through ``apply_fused`` (kv = 0, bits
    >= 7) or ``apply_swap`` (kv lane bits, victims >= 12)."""
    rng = np.random.default_rng(10 * k + kv)
    n = 20
    victims = [int(v) for v in rng.choice(range(12, n), kv, replace=False)]
    bits = [int(b) for b in rng.choice(7, kv, replace=False)] + \
        [int(b) for b in rng.choice([b for b in range(7, n)
                                     if b not in victims], k - kv,
                                    replace=False)]
    rng.shuffle(bits)
    U = torch.as_tensor(_rand_u(k, rng), dtype=torch.complex64,
                        device=cuda)
    st = _rand_state(n, rng, cuda)
    a, b = st.clone(), st.clone()
    if kv:
        fk.apply_swap(a, U, bits, victims)
        fk.apply_swap_plain(b, U, bits, victims)
    else:
        fk.apply_fused(a, U, bits)
        fk.apply_fused_plain(b, U, bits)
    torch.cuda.synchronize()
    assert (a - b).abs().max().item() <= ATOL


def test_cuda_evolver_matches_cpu_evolver(cuda):
    """``simulate(optimize='evolution-fused')`` on the card and on the
    host, after an H layer: the same amplitudes within f32 rounding,
    ``apply_bits`` launched on the card."""
    n = 18
    rng = np.random.default_rng(7)
    items = []
    for _ in range(12):
        k = int(rng.integers(1, 5))
        qs = tuple(int(q) for q in rng.choice(n, k, replace=False))
        items.append((_rand_u(k, rng), qs))
    c = Circuit([Gate('H', qubits=[q]) for q in range(n)]) + \
        circuit_from_matrices(items)
    fk.reset_counts()
    got, info = simulate(c, initial_state='0' * n, optimize='evolution-fused',
                         device=cuda, return_info=True)
    assert info['engine'] == 'indexed' and fk.counts()['apply_bits'] > 0
    want = simulate(c, initial_state='0' * n, optimize='evolution-fused',
                    device='cpu')
    assert np.abs(got - want).max() <= ATOL


@pytest.mark.parametrize('n, bits, kv', [
    (8, [7], 0), (11, [10, 7], 0), (12, [7, 11, 9, 8, 10], 0),
    (13, [12, 9], 0),
] + [(n, k, kv) for k in range(1, 9) for kv in range(min(k, 2) + 1)
     for n in sorted({k + kv, 11})])
def test_cuda_fused_below_one_tile(n, bits, kv, cuda):
    """Registers smaller than a block's columns or a tile: the fixed bit
    sets through ``apply_fused``, then k = 1..8 gate bits (``bits`` a
    count: random positions, bits 0-2 included) with kv of them exchanged
    with victims, at n = k + kv (one column) and n = 11."""
    rng = np.random.default_rng([n, kv, bits if isinstance(bits, int)
                                 else len(bits)])
    if isinstance(bits, int):
        allb = [int(b) for b in rng.permutation(n)[:bits + kv]]
        bits, victims = allb[:len(allb) - kv], allb[len(allb) - kv:]
        lane = sorted((int(b) for b in rng.choice(bits, kv, replace=False)),
                      reverse=True)
        _hold_group(n, bits, lane, victims, rng, cuda)
        return
    U = torch.as_tensor(_rand_u(len(bits), rng), dtype=torch.complex64,
                        device=cuda)
    st = _rand_state(n, rng, cuda)
    a, b = st.clone(), st.clone()
    fk.apply_fused(a, U, bits)
    fk.apply_fused_plain(b, U, bits)
    torch.cuda.synchronize()
    assert (a - b).abs().max().item() <= ATOL


@pytest.mark.parametrize('k, low', [(k, low) for k in range(1, 9)
                                    for low in (0, 1, 2, 7)])
def test_cuda_apply_bits_matches_plain(k, low, cuda):
    """The straight route's ``apply_bits`` at k = 1..8 with the lowest gate
    bit at 0, 1, 2 or 7, at n = 20: one launch, no plain call."""
    rng = np.random.default_rng([k, low])
    n = 20
    bits = [low] + [int(b) for b in rng.choice(range(low + 1, n), k - 1,
                                               replace=False)]
    rng.shuffle(bits)
    U = torch.as_tensor(_rand_u(k, rng), dtype=torch.complex64,
                        device=cuda)
    st = _rand_state(n, rng, cuda)
    a, b = st.clone(), st.clone()
    fk.reset_counts()
    fk.apply_bits(a, U, bits)
    assert fk.counts()['apply_bits'] == 1
    assert fk.counts()['apply_bits_plain'] == 0
    fk.apply_bits_plain(b, U, bits)
    torch.cuda.synchronize()
    assert (a - b).abs().max().item() <= ATOL


def test_cuda_indexed_evolver_matches_cpu(cuda):
    """The straight engine on the card and on the host: same gates, same
    container within f32 rounding; on the card each operand comes from
    ``preload``, as ``simulate`` passes it."""
    n = 16
    rng = np.random.default_rng(8)
    ev_c = IndexedEvolver(n, device=cuda)
    ev_h = IndexedEvolver(n, device='cpu')
    s_c, s_h = ev_c.prepare_state('+' * n), ev_h.prepare_state('+' * n)
    for _ in range(16):
        k = int(rng.integers(1, 9))
        qs = tuple(int(q) for q in rng.choice(n, k, replace=False))
        U = _rand_u(k, rng)
        s_c = ev_c.apply_gate(s_c, ev_c.preload([U])[0], qs)
        s_h = ev_h.apply_gate(s_h, U, qs)
    assert (s_c.cpu() - s_h).abs().max().item() <= ATOL
    want = ev_h.gather(s_h).numpy()
    for chunk in (2 ** 24, 2 ** 10, 3000):     # one chunk; many, staged
        np.testing.assert_allclose(ev_c.gather_host(s_c, chunk=chunk), want,
                                   atol=ATOL)
    np.testing.assert_allclose(
        ev_c.gather_host(s_c, 'complex128', chunk=2 ** 10), want, atol=ATOL)


@pytest.mark.parametrize('state', ['0' * 26, '-+01+1-0+-10-+01-1+0+-01+-'])
def test_cuda_token_container_matches_cpu(state, cuda):
    """The token fill at n = 26 on the card: bit for bit the container
    built on the host, with only the token table uploaded."""
    n = len(state)
    prepare.reset_counts()
    got = prepare.token_container(state, n, cuda)
    counts = prepare.counts()
    assert counts['token_fills'] == 1
    assert counts['fill_upload_bytes'] <= 2 * n * 4
    want = prepare.token_container(state, n, 'cpu')
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize('c', [3, 4])
def test_cuda_park_permutation(c, cuda):
    """An in-place park on 2c = 6 or 8 bits: the pair-SWAP permutation of
    the JAX fused engine's ``_park_pass`` through ``apply_fused``, on the
    tensor
    cores from k = 6 (3xTF32 carries about 2^-22 relative rounding where
    the FMA kernel was exact)."""
    rng = np.random.default_rng(c)
    n = 20
    U = np.array([[1.0]], dtype=np.complex64)
    for _ in range(c):
        U = np.kron(U, _SW)
    U = torch.as_tensor(U, device=cuda)
    high = [int(b) for b in rng.choice(range(12, n), c, replace=False)]
    sub = [int(b) for b in rng.choice(range(7, 12), c, replace=False)]
    bits = [b for pair in zip(high, sub) for b in pair]
    st = _rand_state(n, rng, cuda)
    a, b = st.clone(), st.clone()
    fk.apply_fused(a, U, bits)
    fk.apply_fused_plain(b, U, bits)
    torch.cuda.synchronize()
    assert (a - b).abs().max().item() <= ATOL


@pytest.mark.parametrize('n, L, positions', [
    (11, 10, (0,)), (12, 10, (1, 0)), (14, 10, (1, 3, 0, 2)),
    (20, 10, (9, 0, 7, 2, 5, 1, 8, 3)),
    (9, 0, (0, 2, 1)), (10, 0, (4, 0, 3, 1, 2)), (20, 0, (0, 1, 2, 3)),
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


# chip_smoke.FACTORED_CASES at n = 20-22: the same factor sizes, lane bits
# and order of row bits, the largest (kr = 9, kl = 7) included
FACTORED_CHIP_CASES = [
    (20, (), (6, 5, 4, 3)), (21, (19, 9), (6, 5)), (22, (21, 14), (6, 5)),
    (22, (15, 9), (4, 2)), (20, (), (6, 3, 0)), (22, (14, 13), (5,)),
    (22, (9, 15), (2, 4)),
    (22, (21, 20, 19, 18, 11, 10, 9, 8, 7), (6, 5, 4, 3, 2, 1, 0)),
]


@pytest.mark.parametrize('n, row_bits, lane_bits', FACTORED_CHIP_CASES)
def test_cuda_factored_chip_bit_sets(n, row_bits, lane_bits, cuda):
    """Each launch of the kernel counted once: two for kr >= 7."""
    rng = np.random.default_rng(n + len(row_bits))
    Ur = _rand_u(len(row_bits), rng) if row_bits else np.ones((1, 1))
    Ul = _rand_u(len(lane_bits), rng)
    st = _rand_state(n, rng, cuda)
    a, b = st.clone(), st.clone()
    fk.reset_counts()
    fk.apply_factored(a, Ur, row_bits, Ul, lane_bits)
    fk.apply_factored_plain(b, Ur, row_bits, Ul, lane_bits)
    torch.cuda.synchronize()
    assert fk.counts()['factored_apply'] == 1
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
    # 32 MiB: many tiles and blocks, an SM holding several in turn
    ('auto', 8192, 1024, 512, 0), ('aliased', 8192, 1024, 512, 0),
    # more tiles than the grid's 65535 rows: tiles looped over
    ('auto', 70000, 4, 1, 0), ('aliased', 70001, 4, 1, 0),
    # the probe's mappings (S = 256, 512, 1024 x2buf; S = 256 x4buf) on
    # row counts that leave a partial last stage and block
    ('manual', 8195, 1024, 4, 2), ('manual', 1001, 1024, 8, 2),
    ('manual', 8200, 1024, 16, 2), ('manual', 8190, 1024, 4, 4),
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


@pytest.mark.parametrize('offset', [1, 37])
def test_cuda_stream_scale_inplace_view(offset, cuda):
    """``scale_`` on a view that starts ``offset`` rows into its array:
    the view doubles, the rows before it stay."""
    x = torch.randn(300, 1024, generator=torch.Generator().manual_seed(7))
    x = x.to(cuda)
    want = torch.cat([x[:offset], bw.scale_plain(x[offset:])])
    assert bw.scale_(x[offset:], 64).data_ptr() == x[offset:].data_ptr()
    torch.cuda.synchronize()
    assert torch.equal(x, want)


@pytest.mark.parametrize('kind, rows', [('auto', 16), ('manual', 4)])
def test_cuda_stream_scale_into_out(kind, rows, cuda):
    x = torch.randn(64, 1024, generator=torch.Generator().manual_seed(3))
    x = x.to(cuda)
    out = torch.full_like(x, float('nan'))
    v = bw.Variant('test', kind, rows, rows, 2)
    assert bw.run_variant(v, x, out=out) is out
    torch.cuda.synchronize()
    assert torch.equal(out, bw.scale_plain(x))


DOT_BANDS = [('tf32', 1e-5, 1e-2), ('3xtf32', 0.0, 1e-5)]
# (0, 1): the probe scripts' operands
DOT_SEEDS = [(0, 1), (2, 3), (4, 5)]


@pytest.mark.parametrize('seeds', DOT_SEEDS,
                         ids=lambda s: f'seeds{s[0]}{s[1]}')
@pytest.mark.parametrize('precision, lo, hi', DOT_BANDS)
def test_cuda_dot_accuracy(precision, lo, hi, seeds, cuda):
    a, b = bw.dot_inputs(seeds)
    bw.reset_counts()
    got = bw.dot(torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda),
                 precision)
    torch.cuda.synchronize()
    assert bw.counts()[f'dot_{precision}'] == 1
    assert lo <= bw.rel_err(got, a, b) <= hi
    if precision == 'tf32':      # operands rounded to nearest, not cut
        assert bw.rel_err(got, tf32_round(a), tf32_round(b)) <= 1e-5


def test_cuda_dot_rejects_misaligned(cuda):
    """The kernel loads 16-byte chunks: an operand 4 bytes off raises."""
    a = torch.zeros(bw.DOT_N ** 2 + 1, device=cuda)[1:].view(bw.DOT_N,
                                                            bw.DOT_N)
    b = torch.zeros(bw.DOT_N, bw.DOT_N, device=cuda)
    bw.reset_counts()
    with pytest.raises(ValueError, match='aligned'):
        bw.dot(a, b)
    assert bw.counts()['dot_tf32'] == 0


@pytest.mark.parametrize('precision', ['tf32', '3xtf32'])
def test_cuda_dot_is_deterministic(precision, cuda):
    """Two calls on the same operands give the same bits: the partial sums
    of a tile meet in a fixed order, with no atomics."""
    a, b = (torch.from_numpy(x).to(cuda) for x in bw.dot_inputs((2, 3)))
    first = bw.dot(a, b, precision)
    second = bw.dot(a, b, precision)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


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


@pytest.mark.parametrize('i', range(len(gather.VARIANTS)))
def test_cuda_gather_variant_on_view(i, cuda):
    """Every probe variant on 32 MiB that starts 3 rows into its array:
    the view is doubled or rounded to bf16, the rows before it stay."""
    v = gather.VARIANTS[i]
    rows, offset = 2 ** 16, 3
    x = torch.randn(rows + offset, 128,
                    generator=torch.Generator().manual_seed(i)).to(cuda)
    want = torch.cat([x[:offset], gather.gather_scale_plain(x[offset:],
                                                            v.matmul)])
    gather.reset_counts()
    assert gather.run_variant(v, x[offset:]).data_ptr() == \
        x[offset:].data_ptr()
    torch.cuda.synchronize()
    assert gather.counts() == {'gather_scale': 1}
    assert torch.equal(x, want)


@pytest.mark.parametrize('simplify, final, target, chunk', [
    (True, '0' * 8, 2 ** 6, None), (True, '0' * 8, 2 ** 6, 3),
    ('full', '0..0..0.', 2 ** 4, None)])
def test_cuda_tn_executor_matches_cpu(simplify, final, target, chunk,
                                      monkeypatch, cuda):
    """``contract_torch`` on the card against the same executor on the
    host, slices batched (one chunk, then chunks of 3), hyperedge steps
    included, full sum and a partial range; complex64 to 1e-5 and
    complex128 to 1e-12 of the largest entry, with the global TF32 flags
    on (the executor turns TF32 off)."""
    from hybridq_tpu_torch import Circuit, Gate
    from hybridq_tpu_torch.circuit import utils
    from hybridq_tpu_torch.extras.random import get_rqc
    from hybridq_tpu_torch.simulation.tn import (ContractionPlan,
                                                 SlicedContractor,
                                                 build_tn, find_path,
                                                 find_slices)

    np.random.seed(5)
    n = 8
    c = Circuit([Gate('H', qubits=[q]) for q in range(n)]) + \
        get_rqc(n, 100, indexes=list(range(n)))
    if simplify != 'full':
        c = Circuit(utils.to_matrix_gate(b) for b in utils.compress(c, 2))
    monkeypatch.setattr(torch.backends.cuda.matmul, 'allow_tf32', True)
    for ctype, tol in (('complex64', 1e-5), ('complex128', 1e-12)):
        net, order = build_tn(c, '0' * n, final, complex_type=ctype,
                              simplify=simplify)
        inputs = [t.inds for t in net.tensors]
        sizes = {i: d for t in net.tensors
                 for i, d in zip(t.inds, t.data.shape)}
        tree = find_path(inputs, order, sizes, max_repeats=4, seed=0)
        sliced, _ = find_slices(tree, target)
        sc = SlicedContractor(ContractionPlan(tree, sliced), net.tensors,
                              order, complex_type=ctype)
        assert sc.nslices > 1
        if chunk is not None:
            monkeypatch.setattr(sc, '_chunk', lambda: chunk)
        for r in (None, (1, sc.nslices - 2)):
            want = sc.contract_torch(device='cpu', slice_range=r)
            got = sc.contract_torch(device=cuda, slice_range=r)
            assert got.dtype == np.dtype(ctype)
            assert np.abs(got - want).max() <= tol * np.abs(want).max()
        assert torch.backends.cuda.matmul.allow_tf32


def _noisy_rqc(n, depth, damped, seed):
    """``get_rqc(n, depth)`` with a ``LocalDepolarizingChannel`` (p =
    0.01) after each layer of ``n`` gates, then an
    ``AmplitudeDampingChannel`` (p = 1: Kraus sites) on ``damped``."""
    from hybridq_tpu_torch import Circuit
    from hybridq_tpu_torch.extras.random import get_rqc
    from hybridq_tpu_torch.noise import (AmplitudeDampingChannel,
                                         LocalDepolarizingChannel)

    np.random.seed(seed)
    out = []
    for i, g in enumerate(get_rqc(n, depth, indexes=list(range(n)))):
        out.append(g)
        if (i + 1) % n == 0:
            out += list(LocalDepolarizingChannel(list(range(n)), 0.01))
    out += list(AmplitudeDampingChannel(list(damped), gamma=0.3, p=1))
    return Circuit(out)


@pytest.mark.parametrize('n, route', [(8, 'plain'), (20, 'bits')])
def test_cuda_trajectories_match_cpu(n, route, cuda):
    """``sample_trajectories`` on the card (below 20 qubits the batched
    ``matmul`` on CUDA tensors, from 20 one ``apply_bits`` launch a gate
    and sample) against the same seed on the host: max|d|/rms <= 1e-5 a
    sample from |+...+> (from |0...0> the samples are peaked, and f32
    rounding alone reads up to 8e-5 of the rms there), and every launch
    counted."""
    from hybridq_tpu_torch.gate import FunctionalGate
    from hybridq_tpu_torch.simulation import trajectories

    c = _noisy_rqc(n, 2 * n, (0, n - 1), 1)
    S = 4
    assert trajectories._route(cuda, np.dtype('complex64'), n) == route
    fk.reset_counts()
    got = trajectories.sample_trajectories(c, S, initial_state='+', seed=2,
                                           device=cuda)
    launches = fk.counts()
    want = trajectories.sample_trajectories(c, S, initial_state='+', seed=2,
                                            device='cpu')
    n_kraus = sum(isinstance(g, FunctionalGate) for g in c)
    assert launches['apply_bits'] == (
        S * (len(c) + 2 * n_kraus) if route == 'bits' else 0)
    assert launches['apply_bits_plain'] == 0
    rms = np.sqrt((np.abs(want) ** 2).mean(axis=1))
    assert (np.abs(got - want).max(axis=1) / rms).max() <= ATOL


@pytest.mark.parametrize('float_type, tol', [('float64', 1e-9),
                                             ('float32', 1e-5)])
def test_cuda_clifford_matches_numpy(float_type, tol, cuda):
    """``update_pauli_string(backend='torch')`` on the card against the
    numpy backend on a Clifford+T circuit, with a batch cap that makes
    the frontier split: the same strings above 1e-6, values within
    ``tol`` of max|v|."""
    from hybridq_tpu_torch import Circuit, Gate
    from hybridq_tpu_torch.extras.random import get_rqc
    from hybridq_tpu_torch.simulation import clifford

    n = 8
    np.random.seed(0)
    gates = list(get_rqc(n, 200, indexes=list(range(n)),
                         use_clifford_only=True, randomize_power=False))
    for p in np.sort(np.random.choice(len(gates), 16, replace=False))[::-1]:
        gates.insert(int(p), Gate('T', [int(np.random.randint(n))]))
    c = Circuit(gates)
    kw = dict(float_type=float_type, max_breadth_first_branches=32,
              return_info=True)
    got, info = clifford.update_pauli_string(c, 'Z' + 'I' * (n - 1),
                                             device=cuda, **kw)
    want, _ = clifford.update_pauli_string(c, 'Z' + 'I' * (n - 1),
                                           backend='numpy', **kw)
    assert info['largest_batch'] > 32
    assert {k for k, v in got.items() if abs(v) > 1e-6} == \
        {k for k, v in want.items() if abs(v) > 1e-6}
    scale = max(abs(v) for v in want.values())
    for k in set(got) | set(want):
        assert abs(got.get(k, 0) - want.get(k, 0)) <= tol * scale


@pytest.mark.parametrize('n_shards', [4, 8])
def test_cuda_sharded_matches_straight(n_shards, cuda):
    """``ShardedIndexedEvolver`` on ``['cuda:0'] * n_shards`` at n = 20
    against the straight engine on the same gates, global qubits hit:
    one ``apply_bits`` launch a shard and block, no plain call, and the
    same state within f32 rounding."""
    from hybridq_tpu_torch.convert import circuit_from_matrices
    from hybridq_tpu_torch.simulation.sharded import ShardedIndexedEvolver

    n = 20
    rng = np.random.default_rng(12)
    gates = []
    for _ in range(24):
        k = int(rng.integers(1, 5))
        gates.append((_rand_u(k, rng),
                      tuple(int(q) for q in rng.choice(n, k,
                                                       replace=False))))
    assert any(q < 3 for _, qs in gates for q in qs)
    ev = ShardedIndexedEvolver(n, devices=['cuda:0'] * n_shards,
                               compress=0)
    psi = ev.prepare_state('+' * n)
    fk.reset_counts()
    psi = ev.evolve(psi, circuit_from_matrices(gates), qubits=range(n))
    torch.cuda.synchronize()
    assert fk.counts()['apply_bits'] == n_shards * len(gates)
    assert fk.counts()['apply_bits_plain'] == 0 and ev.exchanges > 0
    st = IndexedEvolver(n, device=cuda)
    s = st.prepare_state('+' * n)
    for U, qs in gates:
        s = st.apply_gate(s, U, qs)
    np.testing.assert_allclose(ev.gather(psi), st.gather_host(s),
                               atol=ATOL)


def test_cuda_contract_over_two_entries(cuda):
    """``contract(devices=['cuda:0'] * 2)``: each entry sums half of the
    slices on the card; the sum equals one device's to 1e-5 of the
    largest entry."""
    from hybridq_tpu_torch.extras.random import get_rqc
    from hybridq_tpu_torch.simulation import simulate
    from hybridq_tpu_torch.simulation.tn import make_plan

    n = 12
    np.random.seed(3)
    c = get_rqc(n, 60, indexes=list(range(n)))
    net, opt = simulate(c, initial_state='0' * n, final_state='..' + '0' *
                        (n - 2), optimize='tn', tensor_only=True,
                        max_time=2, device=cuda)
    info, plan = make_plan(opt, target_size=2 ** 2, time_budget=2)
    assert plan.nslices > 1
    one = simulate(net, optimize=(info, plan), device=cuda)
    two = simulate(net, optimize=(info, plan), devices=['cuda:0'] * 2)
    assert np.abs(two - one).max() <= 1e-5 * np.abs(one).max()


CARD_WORKER = r'''
import json, sys, time
import numpy as np
import torch
import torch.distributed as dist
from hybridq_tpu_torch import Circuit, Gate, parallel
from hybridq_tpu_torch.convert import circuit_from_matrices
from hybridq_tpu_torch.simulation.clifford import update_pauli_string
from hybridq_tpu_torch.simulation.kernels import IndexedEvolver
from hybridq_tpu_torch.simulation.sharded import ShardedIndexedEvolver

device, n, timeout = sys.argv[1], int(sys.argv[2]), float(sys.argv[3])
parallel.initialize(device=device, timeout=timeout)
rank, world = parallel.process_index(), parallel.process_count()
rng = np.random.default_rng(5)
gates = []
for _ in range(24):
    m = rng.standard_normal((16, 16)) + 1j * rng.standard_normal((16, 16))
    gates.append((np.linalg.qr(m)[0], tuple(
        int(q) for q in rng.choice(n, 4, replace=False))))
ev = ShardedIndexedEvolver(n)          # this process's device: one shard
psi = ev.evolve(ev.prepare_state('0' * n), circuit_from_matrices(gates),
                qubits=range(n))
st = IndexedEvolver(n, device=ev.mesh.devices[0])
s = st.prepare_state('0' * n)
for U, qs in gates:
    s = st.apply_gate(s, U, qs)
want = st.gather_host(s)
d = float(np.abs(ev.gather(psi) - want).max())
# the marginal summed in float64 (numpy's float32 sum over 23 axes is
# off by about 1e-3 here)
want_p = (np.abs(want.astype(np.complex128)) ** 2).sum(
    axis=tuple(range(2, n - 1))).reshape(-1)
probs_d = float(np.abs(ev.probabilities(psi, [0, 1, n - 1])[1] -
                       want_p).max())
d_after = float(np.abs(ev.gather(psi) - want).max())
if ev.mesh.devices[0].type == 'cuda':
    torch.cuda.synchronize()
t0 = time.perf_counter()
for _ in range(10):
    ev.mesh.exchange(psi, 0, 0, ev.n_local)
if ev.mesh.devices[0].type == 'cuda':
    torch.cuda.synchronize()
ex_ms = (time.perf_counter() - t0) / 10 * 1e3
cc = Circuit([Gate('H', [q]) for q in range(6)] +
             [Gate('T', [q]) for q in range(6)] +
             [Gate('CX', [q, q + 1]) for q in range(5)]) * 3
kw = dict(float_type='float64', device=ev.mesh.devices[0])
split = update_pauli_string(cc, 'ZIIXII', **kw)
whole = update_pauli_string(cc, 'ZIIXII', use_mpi=False, **kw)
clifford_d = max(abs(split.get(k, 0) - whole.get(k, 0))
                 for k in set(split) | set(whole))
print(json.dumps({'rank': rank, 'world': world, 'g': ev.g,
                  'backend': dist.get_backend(), 'device': str(ev.mesh.devices[0]),
                  'exchanges': ev.exchanges, 'max_abs_err': d,
                  'probs_err': probs_d, 'state_err_after': d_after,
                  'exchange_ms': ex_ms,
                  'exchange_bytes_per_rank': 2 ** (ev.n_local + 1) * 4,
                  'clifford_err': clifford_d, 'strings': len(split)}),
      flush=True)
dist.destroy_process_group()
'''


def run_card_workers(device, world, n, tmp_path, timeout=120):
    """One worker interpreter per rank (``CARD_WORKER``) in a group on a
    ``file://`` store; returns each rank's JSON line."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS='1',
               HYBRIDQ_TPU_COORDINATOR=f'file://{tmp_path}/store',
               HYBRIDQ_TPU_NUM_PROCESSES=str(world))
    procs = [subprocess.Popen(
        [sys.executable, '-c', CARD_WORKER, device, str(n), str(timeout)],
        env=dict(env, HYBRIDQ_TPU_PROCESS_ID=str(r)), cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=2 * timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [json.loads(log.strip().splitlines()[-1]) for log in logs]


def test_cuda_nccl_exchanges_across_cards(tmp_path, cuda):
    """One process per card, one shard each, under NCCL: every exchange
    crosses a card; the gathered state and the probabilities equal the
    straight engine's on one card, and the Clifford split equals the
    unsplit expansion on every rank.  Needs two cards or more."""
    world = torch.cuda.device_count()
    if world < 2:
        pytest.skip("needs two CUDA devices or more (one process a card)")
    world = 2 ** (world.bit_length() - 1)
    for r in run_card_workers('cuda', world, 26, tmp_path):
        print(r)
        assert r['backend'] == 'nccl' and r['world'] == world
        assert r['exchanges'] > 0 and r['max_abs_err'] <= ATOL
        assert r['state_err_after'] <= ATOL
        assert r['probs_err'] <= ATOL
        assert r['clifford_err'] <= 1e-9
