"""A 4-qubit gate kernel with the gate size fixed at compile time.

The counterpart of ``scripts/probe_fused_k4.py`` ``mk``, the TPU's
experiment with a k_hi = 4 variant of ``fused_kernel``.
``apply_fused_k4(state, U, bits)`` computes exactly
``fused_kernels.apply_fused`` at k = 4 (any four bits >= 7) on the same
container, through ``hq_group_apply`` of ``csrc/fused_apply.cu``, whose
``column_apply_kernel<4>`` has k fixed at compile time (one column a
thread in registers); its plain version is
``fused_kernels.apply_fused_plain``.  The engine does not route to it.

``fused_k4_launches`` counts the kernel's launches; ``reset_counts``
zeroes it and ``counts`` reads it.
"""

from __future__ import annotations

from typing import Sequence

import torch

from hybridq_tpu_torch.simulation import fused_kernels as fk

__all__ = ['apply_fused_k4', 'reset_counts', 'counts']

_K = 4

fused_k4_launches = 0


def reset_counts():
    global fused_k4_launches
    fused_k4_launches = 0


def counts() -> dict:
    return {'fused_k4_apply': fused_k4_launches}


def apply_fused_k4(state: torch.Tensor, U, bits: Sequence[int]
                   ) -> torch.Tensor:
    """Apply the 16x16 ``U`` to physical bits ``bits`` (four bits >= 7,
    MSB of U first) of ``state`` in place; returns ``state``."""
    global fused_k4_launches
    n = fk._n_of(state)
    bits = [int(b) for b in bits]
    if len(bits) != _K:
        raise ValueError(f"apply_fused_k4 takes 4-qubit gates, got "
                         f"{len(bits)} bits")
    fk._check_bits(n, bits)
    if any(b < fk._LANE_BITS for b in bits):
        raise ValueError("apply_fused_k4 handles bits >= 7 only")
    if not fk._kernel_device(state):
        return fk.apply_fused_plain(state, U, bits)
    U = fk._operand(U, _K, state.device)
    fk._launch(*fk._halves(state, n), U, n, bits, [], [])
    fused_k4_launches += 1
    return state
