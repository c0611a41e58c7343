"""Carry state between ``hybridq_tpu`` and this port.

The system has no weights: its state is the fused engine's container and
slot map.  The JAX engine keeps the container as a ``[2^(n-6), 128]`` f32
array; the port keeps the same floats as a flat tensor.  Both sides take
numpy arrays, so this module imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from hybridq_tpu_torch.circuit import Circuit
from hybridq_tpu_torch.gate import MatrixGate

__all__ = ['state_from_reference', 'state_to_reference',
           'circuit_from_matrices']


def _check_phys(phys, n):
    phys = [int(p) for p in phys]
    if sorted(phys) != list(range(n)):
        raise ValueError(f"phys must be a permutation of range({n})")
    return phys


def state_from_reference(container: np.ndarray, phys: Sequence[int],
                         device=None):
    """The JAX engine's container (``[2^(n-6), 128]`` f32) and slot map
    ``phys`` -> ``(state, phys, logi)`` for a port ``FusedEvolver``
    (assign ``ev.phys, ev.logi = phys, logi``)."""
    container = np.asarray(container)
    if container.dtype != np.float32 or container.ndim != 2 or \
            container.shape[1] != 128:
        raise ValueError("container must be a [2^(n-6), 128] f32 array")
    n = container.shape[0].bit_length() + 5
    if container.shape[0] != 2 ** (n - 6):
        raise ValueError("container rows must be a power of two")
    phys = _check_phys(phys, n)
    logi = [0] * n
    for b, s in enumerate(phys):
        logi[s] = b
    state = torch.from_numpy(np.array(container).reshape(-1)).to(device)
    return state, phys, logi


def state_to_reference(state: torch.Tensor, phys: Sequence[int]):
    """The port's container and slot map -> ``(container, phys)`` in the
    JAX engine's form (``[2^(n-6), 128]`` f32 numpy array)."""
    flat = state.detach().to('cpu', torch.float32).numpy()
    n = flat.size.bit_length() - 2
    if flat.size != 2 ** (n + 1):
        raise ValueError("state must hold 2^(n+1) floats")
    return flat.reshape(2 ** (n - 6), 128).copy(), _check_phys(phys, n)


def circuit_from_matrices(items) -> Circuit:
    """``[(U, qubits), ...]`` -> a port ``Circuit`` of ``MatrixGate``s, so
    that both packages can run the same gates."""
    return Circuit(MatrixGate(np.asarray(U)).on(list(qs))
                   for U, qs in items)
