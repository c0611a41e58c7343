"""Host-side linear algebra helpers (numpy/scipy).

These run on the host CPU: they act on small gate matrices (at most a few
thousand entries), never on device state.  Mirrors the behavior of the
reference ``hybridq/utils/utils.py:307-451``.
"""

from __future__ import annotations

import numpy as np

__all__ = ['svd', 'kron', 'isunitary', 'matrix_power']


def svd(a, axes, sort: bool = False, atol: float = 1e-8, **kwargs):
    """Split-SVD of ``a`` along the given axes.

    Returns ``(s, uh, vh)`` with ``a = sum_k s[k] * outer(uh[k], vh[k])``
    (after transposing ``a`` so that ``axes`` come first).  ``uh`` carries
    ``axes``; weights below ``atol`` are dropped; ``sort=True`` orders by
    ascending weight.
    """
    from scipy.linalg import svd as _svd

    kwargs.setdefault('full_matrices', False)
    a = np.asarray(a)
    axes = tuple(map(int, axes))
    if len(axes) != len(set(axes)):
        raise ValueError("Axes cannot be repeated in 'axes'.")
    if any(not 0 <= x < a.ndim for x in axes):
        raise ValueError("'axes' must be a list of valid 'a' axes.")

    alt_axes = tuple(x for x in range(a.ndim) if x not in axes)
    shape = a.shape
    size_l = int(np.prod([shape[x] for x in axes], dtype=np.int64))
    size_r = int(np.prod([shape[x] for x in alt_axes], dtype=np.int64))

    m = np.reshape(np.transpose(a, axes + alt_axes), (size_l, size_r))
    u, s, vh = _svd(m, **kwargs)
    uh = u.T

    if atol:
        sel = np.abs(s) >= atol
        s, uh, vh = s[sel], uh[sel], vh[sel]
    if sort:
        idx = np.argsort(s)
        s, uh, vh = s[idx], uh[idx], vh[idx]

    uh = np.reshape(uh, (len(s),) + tuple(shape[x] for x in axes))
    vh = np.reshape(vh, (len(s),) + tuple(shape[x] for x in alt_axes))
    return s, uh, vh


def kron(a, *cs):
    """Kronecker product of one or more arrays."""
    a = np.asarray(a)
    for c in cs:
        a = np.kron(a, np.asarray(c))
    return a


def isunitary(m, atol: float = 1e-8) -> bool:
    """Return True if ``m`` is a (square) unitary matrix."""
    m = np.asarray(m)
    if m.ndim != 2 or m.shape[0] != m.shape[1]:
        return False
    m1 = m.conj().T @ m
    if not np.allclose(m1, np.eye(m.shape[0]), atol=atol):
        return False
    m2 = m @ m.conj().T
    return np.allclose(m2, np.eye(m.shape[0]), atol=atol)


def matrix_power(m, p) -> np.ndarray:
    """``m ** p`` for scalar ``p`` (integer powers exact, fractional via
    scipy's fractional_matrix_power)."""
    m = np.asarray(m)
    if p == 1:
        return m
    if isinstance(p, (int, np.integer)) or (isinstance(p, float) and
                                            float(p).is_integer()):
        p = int(p)
        if p >= 0:
            return np.linalg.matrix_power(m, p)
        return np.linalg.matrix_power(np.linalg.inv(m), -p)
    from scipy.linalg import fractional_matrix_power
    return fractional_matrix_power(m, float(p))
