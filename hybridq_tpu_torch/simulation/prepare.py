"""Initial/final state preparation.

A copy of the token-state helpers of ``hybridq_tpu/simulation/prepare.py``:
tokens '0', '1', '+', '-' build a product state of ``len(state)`` qubits,
on the host (``prepare_state``) or straight into the engines' split
container on the device (``token_container``, ``token_containers``
for several devices).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ['prepare_state', 'token_container', 'token_containers',
           'pack_container', 'TOKEN_VECTORS']

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


def token_container(state: str, n: int, device,
                    dtype=torch.float32) -> torch.Tensor:
    """The split container (``2^(n+1)`` floats of ``dtype``, re half then
    im half) of a token product state of ``n`` qubits, built on
    ``device``: the re half is ``outer(row_amp, lane_amp)`` over the first
    ``n - 7`` and the last ``min(n, 7)`` qubits, written straight into the
    container with no state-sized temporary; the tokens are real, so the
    im half is 0."""
    return token_containers(state, n, [device], dtype)[0]


def token_containers(state: str, n: int, devices,
                     dtype=torch.float32) -> list:
    """``token_container`` on each of ``devices``: the row and lane
    amplitudes are built once on the host, and each container is filled
    on its own device from them, so that no container is copied between
    devices."""
    state = _check_state(state, 2)
    if len(state) != n:
        raise ValueError("Wrong number of qubits for state.")
    lo = min(n, 7)

    ftype = {torch.float32: np.float32, torch.float64: np.float64}[dtype]

    def amps(tokens):
        a = np.array([1.0], dtype=ftype)
        for s in tokens:
            a = np.multiply.outer(
                a, TOKEN_VECTORS[s].astype(ftype)).reshape(-1)
        return a

    row_h, lane_h = amps(state[:n - lo]), amps(state[n - lo:])
    outs = []
    for device in devices:
        row = torch.as_tensor(row_h, device=device)
        lane = torch.as_tensor(lane_h, device=device)
        out = torch.zeros(2 ** (n + 1), dtype=dtype, device=device)
        torch.mul(row[:, None], lane[None, :],
                  out=out[:2 ** n].view(2 ** (n - lo), 2 ** lo))
        outs.append(out)
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
