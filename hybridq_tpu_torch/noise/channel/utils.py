"""Channel math utilities: density-matrix checks, partial trace, Choi
matrix, CPTP check, fidelity (parity with
``hybridq/noise/channel/utils.py``)."""

from __future__ import annotations

from warnings import warn

import numpy as np

__all__ = ['is_dm', 'ptrace', 'is_channel', 'choi_matrix', 'fidelity',
           'reconstruct_dm']


def is_dm(rho, atol=1e-6) -> bool:
    """True if ``rho`` is Hermitian, trace-1, and PSD."""
    rho = np.asarray(rho)
    d = int(np.sqrt(np.prod(rho.shape)))
    m = np.reshape(rho, (d, d))
    if not np.allclose(m, m.conj().T, atol=atol):
        return False
    if not np.isclose(np.trace(m), 1, atol=atol):
        return False
    ev = np.linalg.eigvalsh(m)
    return bool(np.all(ev >= -atol))


def ptrace(state, keep, dims=None) -> np.ndarray:
    """Partial trace of a pure state (1-D) or density matrix (2-D),
    keeping the given qubits."""
    state = np.asarray(state)
    if state.ndim not in (1, 2):
        raise ValueError('should be pure state (one dimensional) or '
                         'density matrix (two dimensional). '
                         f'Received dimension {state.ndim}')
    pure = state.ndim == 1
    if not pure and state.shape[0] != state.shape[1]:
        raise ValueError('invalid state input.')

    full_dim = state.shape[0]
    if dims is not None and full_dim != int(np.prod(dims)):
        raise ValueError('specified dimensions inconsistent with state')
    n = int(round(np.log2(full_dim))) if dims is None else len(dims)
    if dims is None and 2**n != full_dim:
        raise ValueError('invalid state size')
    dims = [2] * n if dims is None else list(dims)

    keep = [keep] if isinstance(keep, (int, np.integer)) else list(keep)
    if not all(q in range(n) for q in keep) or len(keep) >= n:
        raise ValueError('invalid axes')

    final_dim = int(np.prod([dims[i] for i in keep]))
    drop_dim = full_dim // final_dim

    if pure:
        t = state.reshape(dims)
        perm = keep + [q for q in range(n) if q not in keep]
        t = np.transpose(t, perm).reshape(final_dim, drop_dim)
        return np.einsum('ij,kj->ik', t, t.conj())
    density_dims = dims + dims
    keep2 = keep + [q + n for q in keep]
    perm = keep2 + [q for q in range(2 * n) if q not in keep2]
    t = state.reshape(density_dims)
    t = np.transpose(t, perm).reshape(
        (final_dim, final_dim, drop_dim, drop_dim))
    return np.einsum('ijkk->ij', t)


def _channel_dim(channel) -> int:
    shape = channel.map().shape
    d = np.sqrt(shape[0])
    if not np.isclose(d, int(d)):
        raise ValueError('invalid shape for channel')
    return int(d)


def choi_matrix(channel, order=None, **kwargs) -> np.ndarray:
    """Choi matrix of the channel: Λ(ρ) = Tr_0[(I ⊗ ρ^T) C]."""
    if not hasattr(channel, 'map'):
        raise ValueError("'channel' must have method 'map()'")
    op = channel.map(order, **kwargs)
    d = _channel_dim(channel)
    C = np.zeros((d**2, d**2), dtype=complex)
    for ij in range(d**2):
        Eij = np.zeros(d**2)
        Eij[ij] = 1
        out = op @ Eij
        C += np.kron(Eij.reshape((d, d)), out.reshape((d, d)))
    return C


def is_channel(channel, atol=1e-8, order=None, **kwargs) -> bool:
    """CPTP check via the Choi matrix."""
    C = choi_matrix(channel, order, **kwargs)
    d = _channel_dim(channel)
    if not np.isclose(np.trace(C), d, atol=atol):
        return False
    if not np.allclose(C, C.conj().T, atol=atol):
        return False
    ev = np.linalg.eigvalsh(C)
    return bool(np.all(ev >= -atol))


def fidelity(state1, state2, *, use_sqrt_def: bool = False,
             atol: float = 1e-8) -> float:
    """Fidelity between kets and/or density matrices."""
    state1, state2 = np.asarray(state1), np.asarray(state2)
    for s in (state1, state2):
        if s.ndim not in (1, 2) or (s.ndim == 2 and
                                    s.shape[0] != s.shape[1]):
            raise ValueError(
                "Invalid state dimensions. Ket type should be "
                "1-dimensional; density matrix should be square.")
    if state1.shape[0] != state2.shape[0]:
        raise ValueError(
            f"state dimensions inconsistent, got {state1.shape[0]} != "
            f"{state2.shape[0]}")

    def _real(F):
        if np.isclose(np.imag(F), 0, atol=atol):
            return np.real(F)
        warn("Fidelity has non-trivial imaginary component")
        return F

    power = 1 if use_sqrt_def else 2
    ket1, ket2 = state1.ndim == 1, state2.ndim == 1
    if ket1 and ket2:
        return np.abs(np.inner(state1.conj(), state2))**power
    if ket1 != ket2:
        rho = state2 if ket1 else state1
        psi = state1 if ket1 else state2
        return _real(np.sqrt(np.inner(psi.conj(), rho @ psi)))**power
    import scipy.linalg
    sq = scipy.linalg.sqrtm(state1)
    ev = np.linalg.eigvals(sq @ state2 @ sq)
    return _real(np.sum(np.sqrt(ev.astype(complex))))**power


def reconstruct_dm(pure_states, probs=None) -> np.ndarray:
    """Σ_i p_i |ψ_i><ψ_i| from a list of pure states."""
    if probs is None:
        probs = [1 / len(pure_states)] * len(pure_states)
    if len(probs) != len(pure_states):
        raise ValueError("Invalid `probs`: length not consistent.")
    flat = [np.sqrt(p) * np.asarray(psi).ravel()
            for p, psi in zip(probs, pure_states)]
    if len({v.size for v in flat}) != 1:
        raise ValueError("Received states with inconsistent dimensions.")
    flat = np.asarray(flat)
    return np.einsum('ij,ik', flat, flat.conj())
