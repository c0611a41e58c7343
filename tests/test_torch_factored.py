"""``fused_kernels.apply_factored`` against the Pallas ``factored_kernel``.

On the CPU the wrapper runs its plain PyTorch version; it is held against
``pallas_fused.factored_kernel`` in interpret mode, driven by JAX's own
``build_w_factored`` on the same container, at the bit sets of
``scripts/probe_fused_check.py`` (unsorted bits, pure lane, empty
``row_bits``).  The ``gpu`` cases hold the CUDA kernel against the plain
version on a card at the same shapes (the largest ones are in
``test_torch_cuda.py``).

Tolerance: max|d| <= 1e-5 on a unit-norm state -- f32 sums taken in
another order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hybridq_tpu.simulation import pallas_fused as pf
from hybridq_tpu_torch.simulation import fused_kernels as fk

ATOL = 1e-5
# (n, row_bits, lane_bits): probe_fused_check.py's four, and one at n = 14
CASES = [(16, (15, 9), (4, 2)), (16, (), (6, 3, 0)), (16, (14, 13), (5,)),
         (16, (9, 15), (2, 4)), (14, (13, 8), (6, 1))]


def _rand_u(k, rng):
    m = rng.standard_normal((2**k, 2**k)) + \
        1j * rng.standard_normal((2**k, 2**k))
    return np.linalg.qr(m)[0]


def _rand_state(n, rng):
    st = rng.standard_normal(2**(n + 1)).astype(np.float32)
    return st / np.linalg.norm(st)


def _factors(row_bits, lane_bits, rng):
    Ur = _rand_u(len(row_bits), rng) if row_bits else \
        np.ones((1, 1), dtype=complex)
    return Ur, _rand_u(len(lane_bits), rng)


@pytest.mark.parametrize('n, row_bits, lane_bits', CASES)
def test_factored_plain_matches_pallas(n, row_bits, lane_bits, seed):
    rng = np.random.default_rng(seed)
    Ur, Ul = _factors(row_bits, lane_bits, rng)
    st = _rand_state(n, rng)

    k_hi = pf.fused_meta(n, row_bits)[0] if row_bits else 0
    W, Br, Bi, h_offs, rest_mask = pf.build_w_factored(n, Ur, row_bits,
                                                       Ul, lane_bits)
    want = pf.factored_kernel(n, k_hi, interpret=True)(
        jnp.asarray(st.reshape(-1, 128)), jnp.asarray(W), jnp.asarray(Br),
        jnp.asarray(Bi), jnp.asarray(h_offs, jnp.int32),
        jnp.asarray([rest_mask], jnp.int32))

    got = fk.apply_factored(torch.from_numpy(st.copy()), Ur, row_bits, Ul,
                            lane_bits)
    err = np.abs(np.asarray(want).reshape(-1) - got.numpy()).max()
    assert err <= ATOL, (row_bits, lane_bits, err)


def test_factored_scalar_row_factor(seed):
    """An empty ``row_bits`` with a 1x1 ``U_row`` applies its phase, as
    JAX's ``W`` does; ``U_row=None`` means 1."""
    rng = np.random.default_rng(seed)
    st = torch.from_numpy(_rand_state(12, rng))
    Ul = _rand_u(2, rng)
    phase = np.exp(1j * rng.uniform(0, 2 * np.pi))
    a = fk.apply_factored(st.clone(), [[phase]], (), Ul, (5, 1))
    b = fk.apply_factored(st.clone(), None, (), phase * Ul, (5, 1))
    assert (a - b).abs().max().item() <= ATOL


def test_factored_counts_plain_calls_on_cpu(seed):
    rng = np.random.default_rng(seed)
    st = torch.from_numpy(_rand_state(14, rng))
    fk.reset_counts()
    fk.apply_factored(st, _rand_u(1, rng), [9], _rand_u(1, rng), [0])
    assert fk.counts()['apply_factored_plain'] == 1
    assert fk.counts()['factored_apply'] == 0


@pytest.mark.parametrize('row_bits, lane_bits, match', [
    ((9,), (), '1..7 bits'),
    ((3,), (1,), 'row_bits must be >= 7'),
    ((9,), (7,), 'lane_bits < 7'),
    (tuple(range(7, 17)), (0,), 'at most 9'),
    ((9, 9), (0,), 'distinct'),
])
def test_factored_rejects_bad_arguments(row_bits, lane_bits, match):
    st = torch.zeros(2**18, dtype=torch.float32)
    with pytest.raises(ValueError, match=match):
        fk.apply_factored(st, np.eye(2 ** len(row_bits)), row_bits,
                          np.eye(2 ** len(lane_bits)), lane_bits)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the card: python -m pytest "
                    "--noconftest -m gpu tests/test_torch_factored.py)")
    return torch.device('cuda')


@pytest.mark.gpu
@pytest.mark.parametrize('n, row_bits, lane_bits', CASES)
def test_cuda_factored_matches_plain(n, row_bits, lane_bits, cuda):
    rng = np.random.default_rng(len(row_bits) + 10 * len(lane_bits))
    Ur, Ul = _factors(row_bits, lane_bits, rng)
    st = torch.from_numpy(_rand_state(n, rng)).to(cuda)
    a, b = st.clone(), st.clone()
    fk.reset_counts()
    fk.apply_factored(a, Ur, row_bits, Ul, lane_bits)
    fk.apply_factored_plain(b, Ur, row_bits, Ul, lane_bits)
    torch.cuda.synchronize()
    assert fk.counts()['factored_apply'] == 1
    assert (a - b).abs().max().item() <= ATOL
