"""The port's gate kernels (``hybridq_tpu_torch.simulation.fused_kernels``)
against the Pallas TPU kernels they replace.

On the CPU the wrappers run their plain PyTorch versions; those are held
against ``pallas_fused.fused_kernel`` / ``swap_kernel`` in interpret mode,
driven by JAX's own ``build_w`` / ``build_w_swap`` / ``swap_meta`` on the
same container, for every routing class of the fused engine.  The CUDA
kernels are held against the plain versions on a card in
``test_torch_cuda.py``, which imports no JAX.

Tolerance: max|d| <= 1e-5 on a unit-norm state -- f32 sums taken in
another order (the JAX suite's own bar is 5e-5).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hybridq_tpu.simulation import pallas_fused as pf
from hybridq_tpu_torch.simulation import fused_kernels as fk

N = 16           # smallest n at which every class (k_hi / ke <= 4) exists
ATOL = 1e-5
FUSED_CLASSES = [0, 1, 2, 3, 4]
SWAP_CLASSES = [(1, 1), (2, 1), (3, 1), (4, 1), (2, 2), (3, 2), (4, 2)]


def _rand_u(k, rng):
    m = rng.standard_normal((2**k, 2**k)) + \
        1j * rng.standard_normal((2**k, 2**k))
    return np.linalg.qr(m)[0]


def _rand_state(n, rng):
    st = rng.standard_normal(2**(n + 1)).astype(np.float32)
    return st / np.linalg.norm(st)


def _class_gate(n, k_hi, k_l, rng):
    """Random gate bits of a routing class: ``k_hi`` high bits (>= 12),
    ``k_l`` lane bits (< 7), 0-2 sublane bits (7-11, at least one when
    there is no other bit), and ``k_l`` victims; bits in random order."""
    high = [int(b) for b in rng.choice(range(12, n), k_hi + k_l,
                                       replace=False)]
    gate_hi, victims = high[:k_hi], high[k_hi:]
    k_sub = int(rng.integers(0 if k_hi + k_l else 1, 3))
    sub = [int(b) for b in rng.choice(range(7, 12), k_sub, replace=False)]
    lane = [int(b) for b in rng.choice(7, k_l, replace=False)]
    bits = gate_hi + sub + lane
    rng.shuffle(bits)
    return bits, victims


@pytest.mark.parametrize('k_hi', FUSED_CLASSES)
def test_fused_plain_matches_pallas(k_hi, seed):
    rng = np.random.default_rng(seed)
    bits, _ = _class_gate(N, k_hi, 0, rng)
    U = _rand_u(len(bits), rng)
    st = _rand_state(N, rng)

    W, h_offs, rest_mask = pf.build_w(N, U, bits)
    assert pf.fused_meta(N, bits)[0] == k_hi
    want = pf.fused_kernel(N, k_hi, interpret=True)(
        jnp.asarray(st.reshape(-1, 128)), jnp.asarray(W),
        jnp.asarray(h_offs, jnp.int32), jnp.asarray([rest_mask], jnp.int32))

    got = fk.apply_fused(torch.from_numpy(st.copy()), U, bits)
    err = np.abs(np.asarray(want).reshape(-1) - got.numpy()).max()
    assert err <= ATOL, (bits, err)


@pytest.mark.parametrize('ke, k_l', SWAP_CLASSES)
def test_swap_plain_matches_pallas(ke, k_l, seed):
    rng = np.random.default_rng(seed)
    bits, victims = _class_gate(N, ke - k_l, k_l, rng)
    U = _rand_u(len(bits), rng)
    st = _rand_state(N, rng)

    _, _, h_offs, rest_mask, Ms = pf.swap_meta(N, bits, victims)
    W = pf.build_w_swap(N, U, bits, victims)
    want = pf.swap_kernel(N, ke, k_l, interpret=True)(
        jnp.asarray(st.reshape(-1, 128)), jnp.asarray(W), jnp.asarray(Ms),
        jnp.asarray(h_offs, jnp.int32), jnp.asarray([rest_mask], jnp.int32))

    got = fk.apply_swap(torch.from_numpy(st.copy()), U, bits, victims)
    err = np.abs(np.asarray(want).reshape(-1) - got.numpy()).max()
    assert err <= ATOL, (bits, victims, err)


@pytest.mark.parametrize('k_hi, k_l', [(k, 0) for k in FUSED_CLASSES] +
                         [(ke - kl, kl) for ke, kl in SWAP_CLASSES])
def test_host_metadata_matches_pallas(k_hi, k_l, seed):
    """The copied host metadata gives JAX's classes, offsets and masks."""
    rng = np.random.default_rng(seed)
    n = 20
    bits, victims = _class_gate(n, k_hi, k_l, rng)
    if k_l == 0:
        want, got = pf.fused_meta(n, bits), fk.fused_meta(n, bits)
        assert len(want) == len(got)
    else:
        want = pf.swap_meta(n, bits, victims)[:4]
        got = fk.swap_meta(n, bits, victims)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)


def test_wrappers_count_plain_calls_on_cpu(seed):
    rng = np.random.default_rng(seed)
    st = torch.from_numpy(_rand_state(14, rng))
    fk.reset_counts()
    fk.apply_fused(st, _rand_u(2, rng), [8, 13])
    fk.apply_swap(st, _rand_u(2, rng), [3, 9], [12])
    fk.apply_bits(st, _rand_u(2, rng), [0, 13])
    assert fk.counts() == {'apply_bits': 0, 'fused_apply': 0,
                           'swap_apply': 0, 'factored_apply': 0,
                           'apply_bits_plain': 1, 'apply_fused_plain': 1,
                           'apply_swap_plain': 1, 'apply_factored_plain': 0}


@pytest.mark.parametrize('call, match', [
    (lambda st, U: fk.apply_fused(st, U, [3, 8]), 'bits >= 7'),
    (lambda st, U: fk.apply_fused(st, U, [8, 8]), 'distinct'),
    (lambda st, U: fk.apply_fused(st.double(), U, [8, 9]), 'float32'),
    (lambda st, U: fk.apply_fused(st, U, [8, 9, 10]), 'U must be'),
    (lambda st, U: fk.apply_swap(st, U, [3, 8], [9]), 'victims'),
    (lambda st, U: fk.apply_swap(st, U, [8, 9], []), 'lane bits'),
])
def test_wrappers_reject_bad_arguments(call, match):
    st = torch.zeros(2**15, dtype=torch.float32)
    with pytest.raises(ValueError, match=match):
        call(st, np.eye(4))
