"""Initial/final state preparation.

A copy of the token-state helpers of ``hybridq_tpu/simulation/prepare.py``:
tokens '0', '1', '+', '-' build a product state of ``len(state)`` qubits,
on the host (``prepare_state``) or straight into the engines' split
container on the device (``token_container``, ``token_containers``
for several devices).  The device fill uploads only the ``(n, 2)`` table
of token vectors and builds every amplitude on the device; ``counts()``
reads its fills and uploaded bytes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ['prepare_state', 'token_container', 'token_containers',
           'pack_container', 'TOKEN_VECTORS', 'counts', 'reset_counts']

_SQRT2 = np.sqrt(2.0)

TOKEN_VECTORS = {
    '0': np.array([1.0, 0.0]),
    '1': np.array([0.0, 1.0]),
    '+': np.array([1.0, 1.0]) / _SQRT2,
    '-': np.array([1.0, -1.0]) / _SQRT2,
}

# Containers filled from a token string (one a device), and the bytes
# copied from the host for them.
token_fills = 0
fill_upload_bytes = 0


def reset_counts():
    global token_fills, fill_upload_bytes
    token_fills = fill_upload_bytes = 0


def counts() -> dict:
    return {'token_fills': token_fills,
            'fill_upload_bytes': fill_upload_bytes}


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


def token_container(state: str, n: int, device,
                    dtype=torch.float32) -> torch.Tensor:
    """The split container (``2^(n+1)`` floats of ``dtype``, re half then
    im half) of a token product state of ``n`` qubits, built on
    ``device``: the re half is ``outer(row_amp, lane_amp)`` over the first
    ``n - 7`` and the last ``min(n, 7)`` qubits, written straight into the
    container with no state-sized temporary; the tokens are real, so the
    im half is 0."""
    return token_containers(state, n, [device], dtype)[0]


def _fold(vectors: torch.Tensor) -> torch.Tensor:
    """The ``2^m`` amplitudes of the product of the ``(m, 2)`` token
    ``vectors``, the first the most significant bit: the left fold of
    ``np.multiply.outer``, one multiply of the same two values an
    amplitude, so it is bitwise numpy's."""
    a = torch.ones(1, dtype=vectors.dtype, device=vectors.device)
    for v in vectors:
        a = (a[:, None] * v[None, :]).reshape(-1)
    return a


def token_containers(state: str, n: int, devices,
                     dtype=torch.float32) -> list:
    """``token_container`` on each of ``devices``: each device gets the
    ``(n, 2)`` table of the tokens' vectors in ``dtype`` (``2 n`` floats,
    the only bytes copied from the host), folds its row and lane
    amplitudes from it and fills its own container, so that no container
    or amplitude array is copied to or between devices."""
    global token_fills, fill_upload_bytes
    state = _check_state(state, 2)
    if len(state) != n:
        raise ValueError("Wrong number of qubits for state.")
    lo = min(n, 7)

    ftype = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    table_h = np.stack([TOKEN_VECTORS[s] for s in state]).astype(ftype)
    outs = []
    for device in devices:
        table = torch.as_tensor(table_h, device=device)
        row, lane = _fold(table[:n - lo]), _fold(table[n - lo:])
        out = torch.empty(2 ** (n + 1), dtype=dtype, device=device)
        torch.mul(row[:, None], lane[None, :],
                  out=out[:2 ** n].view(2 ** (n - lo), 2 ** lo))
        out[2 ** n:].zero_()
        outs.append(out)
        token_fills += 1
        fill_upload_bytes += table_h.nbytes
    return outs


def pack_container(psi, device) -> torch.Tensor:
    """The split f32 container of a complex ``(2,)*n`` host array or
    tensor: its re and im parts are copied straight into the two halves,
    with no complex copy on ``device``."""
    psi = torch.as_tensor(psi).reshape(-1)
    N = psi.numel()
    out = torch.empty(2 * N, dtype=torch.float32, device=device)
    if psi.is_complex():
        out[:N].copy_(psi.real)
        out[N:].copy_(psi.imag)
    else:
        out[:N].copy_(psi)
        out[N:].zero_()
    return out
