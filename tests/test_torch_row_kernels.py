"""``row_kernels.apply_gate_rows`` against the Pallas ``apply_gate_rows``.

On the CPU the port's function runs its plain PyTorch version; it is held
against ``pallas_kernels.apply_gate_rows`` (interpret mode off the TPU) on
``tests/test_pallas.py``'s position sets, on the smallest registers the
JAX function runs (n = L + k) and at another row length.  The CUDA kernel
is held against the plain version in ``test_torch_cuda.py``.

Tolerance: atol 1e-4 on unnormalised states, as ``tests/test_pallas.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hybridq_tpu.simulation import pallas_kernels as pk
from hybridq_tpu_torch.simulation import row_kernels as rk

ATOL = 1e-4


def _rand_u(k, rng):
    m = rng.standard_normal((2**k, 2**k)) + \
        1j * rng.standard_normal((2**k, 2**k))
    return np.linalg.qr(m)[0]


@pytest.mark.parametrize('n, L, positions', [
    (14, 10, (0,)), (14, 10, (3, 0)), (14, 10, (1, 3, 0, 2)),
    (11, 10, (0,)), (12, 10, (1, 0)), (16, 12, (2, 0, 3)),
])
def test_gate_rows_plain_matches_pallas(n, L, positions, seed):
    rng = np.random.default_rng(seed)
    k = len(positions)
    U = _rand_u(k, rng)
    Ur, Ui = U.real.astype(np.float32), U.imag.astype(np.float32)
    re = rng.standard_normal(2**n).astype(np.float32)
    im = rng.standard_normal(2**n).astype(np.float32)

    want = pk.apply_gate_rows(jnp.asarray(re), jnp.asarray(im),
                              jnp.asarray(Ur), jnp.asarray(Ui),
                              list(positions), n, L)

    t_re, t_im = torch.from_numpy(re.copy()), torch.from_numpy(im.copy())
    rk.reset_counts()
    got = rk.apply_gate_rows(t_re, t_im, Ur, Ui, positions, n, L)
    assert got[0] is t_re and got[1] is t_im          # updated in place
    assert rk.counts() == {'apply_gate_rows': 0, 'apply_gate_rows_plain': 1}
    np.testing.assert_allclose(t_re.numpy(), np.asarray(want[0]), atol=ATOL)
    np.testing.assert_allclose(t_im.numpy(), np.asarray(want[1]), atol=ATOL)


@pytest.mark.parametrize('n, L, positions, match', [
    (20, 10, tuple(range(9)), r'1\.\.8 qubits only \(the CUDA kernel'),
    (12, 10, (2,), 'row_positions'),
    (12, 10, (1, 1), 'row_positions'),
])
def test_gate_rows_rejects_bad_arguments(n, L, positions, match):
    k = len(positions)
    re = torch.zeros(2**n)
    im = torch.zeros(2**n)
    with pytest.raises(ValueError, match=match):
        rk.apply_gate_rows(re, im, np.eye(2**k), np.zeros((2**k, 2**k)),
                           positions, n, L)


def test_gate_rows_rejects_mismatched_arrays():
    with pytest.raises(ValueError, match='2\\^n'):
        rk.apply_gate_rows(torch.zeros(2**12), torch.zeros(2**11),
                           np.eye(2), np.zeros((2, 2)), (0,), 12, 10)
