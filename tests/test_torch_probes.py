"""The port's probes (``hybridq_tpu_torch.probes``) against the JAX side.

``apply_fused_k4`` computes what ``scripts/probe_fused_k4.py``'s ``mk``
computes: ``fused_kernel`` at k_hi = 4 with the ``W`` of ``build_w``.  The
probe itself hard-codes n = 28 and compiles for the TPU only, so the
reference here is ``pallas_fused.fused_kernel(n, 4, interpret=True)``, the
kernel ``mk`` varies.  On the CPU the wrapper runs its plain version; the
CUDA kernel is held against it in ``test_torch_cuda.py``.

Tolerance: max|d| <= 1e-5 on a unit-norm state.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hybridq_tpu.simulation import pallas_fused as pf
from hybridq_tpu_torch.probes import apply_fused_k4, fused_k4
from hybridq_tpu_torch.simulation import fused_kernels as fk

ATOL = 1e-5


def _rand_u(k, rng):
    m = rng.standard_normal((2**k, 2**k)) + \
        1j * rng.standard_normal((2**k, 2**k))
    return np.linalg.qr(m)[0]


def test_fused_k4_plain_matches_pallas(seed):
    rng = np.random.default_rng(seed)
    n, bits = 16, (15, 14, 13, 12)
    U = _rand_u(4, rng)
    st = rng.standard_normal(2**(n + 1)).astype(np.float32)
    st /= np.linalg.norm(st)

    W, h_offs, rest_mask = pf.build_w(n, U, bits)
    assert pf.fused_meta(n, bits)[0] == 4
    want = pf.fused_kernel(n, 4, interpret=True)(
        jnp.asarray(st.reshape(-1, 128)), jnp.asarray(W),
        jnp.asarray(h_offs, jnp.int32), jnp.asarray([rest_mask], jnp.int32))

    fk.reset_counts()
    fused_k4.reset_counts()
    got = apply_fused_k4(torch.from_numpy(st.copy()), U, bits)
    assert fk.counts()['apply_fused_plain'] == 1
    assert fused_k4.counts() == {'fused_k4_apply': 0}
    err = np.abs(np.asarray(want).reshape(-1) - got.numpy()).max()
    assert err <= ATOL, err


@pytest.mark.parametrize('bits, match', [
    ((15, 14, 13), '4-qubit'),
    ((15, 14, 13, 12, 11), '4-qubit'),
    ((15, 14, 13, 3), 'bits >= 7'),
    ((15, 15, 13, 12), 'distinct'),
])
def test_fused_k4_rejects_bad_arguments(bits, match):
    st = torch.zeros(2**17, dtype=torch.float32)
    with pytest.raises(ValueError, match=match):
        apply_fused_k4(st, np.eye(2 ** len(bits)), bits)
