"""Initial/final state preparation (host side).

A copy of the token-state helpers of ``hybridq_tpu/simulation/prepare.py``:
tokens '0', '1', '+', '-' build a product state of ``len(state)`` qubits.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = ['prepare_state', 'TOKEN_VECTORS']

_SQRT2 = np.sqrt(2.0)

TOKEN_VECTORS = {
    '0': np.array([1.0, 0.0]),
    '1': np.array([0.0, 1.0]),
    '+': np.array([1.0, 1.0]) / _SQRT2,
    '-': np.array([1.0, -1.0]) / _SQRT2,
}


def _check_state(state, d) -> str:
    state = str(state)
    if set(state) - set('01+-'):
        raise ValueError(
            f"Symbols {set(state) - set('01+-')} are not allowed.")
    try:
        d = (int(d),) * len(state)
    except (TypeError, ValueError):
        d = tuple(int(x) for x in d)
    if len(d) != len(state):
        raise ValueError(
            "Number of qubits and dimensions are not consistent.")
    if any(x != 2 for x in d):
        raise ValueError("Only qubits of dimension 2 are supported.")
    return state


def prepare_state(state: str, d=2, complex_type='complex64') -> np.ndarray:
    """Dense product state of shape ``(2,)*n`` for a token string."""
    state = _check_state(state, d)
    psi = functools.reduce(np.multiply.outer,
                           (TOKEN_VECTORS[s] for s in state),
                           np.array(1.0))
    return np.asarray(psi, dtype=complex_type)
