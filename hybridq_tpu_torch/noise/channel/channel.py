"""Noise channels.

Parity with the reference ``hybridq/noise/channel/channel.py``: a channel
``ρ → Σ_ij s_ij L_i ρ R_j†`` is *both* a gate and a supergate — in a
pure-state circuit it runs in trajectory mode (stochastic unitary mixing,
or probabilistic Kraus projection), in a density-matrix circuit it lowers
exactly through its Kraus map.

``MatrixChannel`` auto-specializes (reference ``channel.py:134-298``):
  * ``s`` diagonal + all L unitary + Σs = 1  → stochastic-unitary channel
    (sampled per trajectory);
  * ``s`` diagonal + Σ_k s_k L_k†L_k = 1    → general CPTP channel applied
    by cumulative-probability Kraus projection;
  * anything else                            → exact (supergate) mode only.
"""

from __future__ import annotations

from itertools import product

import numpy as np

from hybridq_tpu_torch.dm.gate import BaseSuperGate, KrausSuperGate
from hybridq_tpu_torch.gate import (BaseGate, FunctionalGate, MatrixGate,
                              StochasticGate)
from hybridq_tpu_torch.utils import isnumber
from hybridq_tpu_torch.utils.linalg import isunitary, kron

__all__ = ['BaseChannel', 'MatrixChannel', 'GlobalPauliChannel',
           'LocalPauliChannel', 'LocalDepolarizingChannel',
           'GlobalDepolarizingChannel', 'LocalDephasingChannel',
           'AmplitudeDampingChannel']

_PAULIS = {
    'I': np.eye(2, dtype=complex),
    'X': np.array([[0, 1], [1, 0]], dtype=complex),
    'Y': np.array([[0, -1j], [1j, 0]]),
    'Z': np.diag([1.0, -1.0]).astype(complex),
}


class BaseChannel(BaseSuperGate):
    """Marker type for channels."""


class _ChannelOps:
    """Shared channel behavior: Kraus construction and the vectorized map.

    Mixin expects ``self.qubits`` (flat tuple or None), ``self._s``,
    ``self._LMatrices``, ``self._RMatrices``."""

    @property
    def s(self):
        return self._s

    @property
    def LMatrices(self):
        return self._LMatrices

    @property
    def RMatrices(self):
        return self._RMatrices

    @property
    def Kraus(self) -> KrausSuperGate:
        qubits = self.qubits
        lg = tuple(MatrixGate(m, qubits=qubits) for m in self._LMatrices)
        rg = tuple(MatrixGate(m, qubits=qubits) for m in self._RMatrices)
        return KrausSuperGate(gates=(lg, rg), s=self._s)

    def map(self, order=None) -> np.ndarray:
        """Vectorized superoperator Σ_ij s_ij L_i ⊗ conj(R_j)."""
        return self.Kraus.map(order=order)


class _SuperChannel(_ChannelOps, BaseChannel, BaseGate):
    """Exact-mode-only channel (general s)."""

    def __init__(self, LMatrices, RMatrices, s, qubits, n_qubits, name,
                 tags):
        BaseGate.__init__(self, qubits=qubits, n_qubits=n_qubits, tags=tags)
        self.name = str(name).upper()
        self._LMatrices = LMatrices
        self._RMatrices = RMatrices
        self._s = s


class _StochasticChannel(_ChannelOps, BaseChannel, StochasticGate):
    """Unitary-mixing channel: trajectory mode samples one unitary."""

    def __init__(self, LMatrices, RMatrices, s, qubits, n_qubits, name,
                 tags):
        self._LMatrices = LMatrices
        self._RMatrices = RMatrices
        self._s = s
        self._channel_n_qubits = n_qubits
        gates = tuple(
            MatrixGate(m, qubits=qubits) for m in LMatrices)
        StochasticGate.__init__(self, gates=gates, p=np.real(s), tags=tags)
        self.name = str(name).upper()

    @property
    def qubits(self):
        q = self._gates[0].qubits if self._gates else None
        return q

    @property
    def n_qubits(self):
        return self._channel_n_qubits

    def on(self, qubits=None, *, inplace: bool = False):
        import copy as _copy
        g = self if inplace else _copy.deepcopy(self)
        g._gates = type(g._gates)(x.on(qubits) for x in g._gates)
        return g


class _FunctionalChannel(_ChannelOps, BaseChannel, FunctionalGate):
    """General CPTP channel: trajectory mode projects onto one Kraus
    operator with cumulative probability (reference
    ``channel.py:211-298``)."""

    def __init__(self, LMatrices, RMatrices, s, qubits, n_qubits, name,
                 tags, norm_atol: float = 1e-6):
        self._LMatrices = LMatrices
        self._RMatrices = RMatrices
        self._s = s
        self._norm_atol = float(norm_atol)
        # Apply largest-norm Kraus operators first (fewer projections on
        # average).
        self._order = tuple(
            np.argsort([np.linalg.norm(np.linalg.eigvals(m))
                        for m in LMatrices])[::-1])
        FunctionalGate.__init__(self, f=type(self)._apply, qubits=qubits,
                                n_qubits=n_qubits, tags=tags)
        self.name = str(name).upper()

    def _apply(self, psi, order, rng=None):
        order = tuple(order)
        rng = np.random.default_rng() if rng is None else rng
        axes = tuple(order.index(q) for q in self.qubits)
        k = len(axes)

        complex_split = psi.ndim > len(order)
        full = (psi[0] + 1j * psi[1]) if complex_split else psi

        def _project(idx):
            U = self._LMatrices[idx].reshape((2,) * (2 * k))
            proj = np.tensordot(U, full, axes=(tuple(range(k, 2 * k)),
                                               axes))
            proj = np.moveaxis(proj, range(k), axes)
            norm = np.linalg.norm(proj.ravel())
            if norm < self._norm_atol:
                norm = 0.0
            prob = np.real(self._s[idx]) * norm**2
            return proj, norm, prob

        r = rng.random()
        c = 0.0
        chosen = None
        for idx in self._order:
            proj, norm, prob = _project(idx)
            if norm > 0:
                chosen = (proj, norm)
                c += prob
                if c >= r:
                    break
        if chosen is None:
            raise RuntimeError("All projected states have norm below "
                               f"norm_atol={self._norm_atol}.")
        proj, norm = chosen
        proj = proj / norm
        if complex_split:
            proj = np.stack([proj.real, proj.imag]).astype(psi.dtype)
        return proj, order


def MatrixChannel(LMatrices, RMatrices=None, s=1, qubits=None, tags=None,
                  name: str = 'MATRIX_CHANNEL', copy: bool = True,
                  atol: float = 1e-8, methods=None, use_cache: bool = True,
                  norm_atol: float = 1e-6):
    """Build a channel ρ → Σ_ij s_ij L_i ρ R_j†, auto-specializing to
    stochastic / functional trajectory modes when possible."""
    LMatrices = tuple(np.array(m, dtype=complex) for m in LMatrices)
    RMatrices = None if RMatrices is None else tuple(
        np.array(m, dtype=complex) for m in RMatrices)

    if isnumber(s):
        s = float(s) * np.ones(len(LMatrices))
        if RMatrices is not None and len(LMatrices) != len(RMatrices):
            raise ValueError("'s' cannot be a float if 'LMatrices' and "
                             "'RMatrices' have different size")
    else:
        s = np.array(s)
        if s.ndim == 2 and s.shape[0] == s.shape[1] and np.allclose(
                s, np.diag(np.diag(s)), atol=atol):
            s = np.diag(s).copy()
        elif s.ndim > 2:
            raise ValueError("'s' not supported.")

    if not len(LMatrices) or (RMatrices is not None and not RMatrices):
        raise ValueError("At least one matrix must be provided")

    n_qubits = float(np.log2(LMatrices[0].shape[0]))
    if n_qubits != int(n_qubits):
        raise ValueError("Only matrices acting on qubits are supported")
    n_qubits = int(n_qubits)
    if any(m.shape != (2**n_qubits, 2**n_qubits) for m in LMatrices) or (
            RMatrices is not None and any(
                m.shape != (2**n_qubits, 2**n_qubits) for m in RMatrices)):
        raise ValueError("All matrices must have the same shape")

    qubits = None if qubits is None else tuple(qubits)
    if qubits and len(qubits) != n_qubits:
        raise ValueError(
            "'qubits' is not consistent with the size of matrices")

    same_lr = RMatrices is None or all(
        np.array_equal(a, b) for a, b in zip(LMatrices, RMatrices))
    R = LMatrices if RMatrices is None else RMatrices

    args = dict(LMatrices=LMatrices, RMatrices=R, s=s, qubits=qubits,
                n_qubits=n_qubits, name=name, tags=tags)
    if s.ndim == 1 and same_lr:
        if np.isclose(np.sum(np.real(s)), 1, atol=atol) and all(
                isunitary(m) for m in LMatrices):
            return _StochasticChannel(**args)
        if np.allclose(
                sum(w * (m.conj().T @ m) for w, m in zip(s, LMatrices)),
                np.eye(2**n_qubits), atol=atol):
            return _FunctionalChannel(norm_atol=norm_atol, **args)
    return _SuperChannel(**args)


def GlobalPauliChannel(qubits, s, tags=None,
                       name: str = 'GLOBAL_PAULI_CHANNEL',
                       copy: bool = True, atol: float = 1e-8, methods=None,
                       use_cache: bool = True):
    """ρ → Σ σ_i1..σ_in ρ σ_j1..σ_jn weighted by ``s``
    (reference ``channel.py:413-532``)."""
    qubits = tuple(qubits)
    n_qubits = len(qubits)

    if isinstance(s, dict):
        s = {str(k).upper(): v for k, v in s.items()}
        if any(len(k) != 2 * n_qubits for k in s):
            raise ValueError("Keys in 's' must have a number of tokens "
                             "which is twice the number of qubits")
        if any(set(k) - set('IXYZ') for k in s):
            raise ValueError("'s' contains non-valid tokens")

        def _pos(tok):
            return sum(4**i * dict(I=0, X=1, Y=2, Z=3)[c]
                       for i, c in enumerate(tok))

        m = np.zeros((4**n_qubits, 4**n_qubits))
        for k, v in s.items():
            m[_pos(k[:n_qubits]), _pos(k[n_qubits:])] = v
        s = m
    else:
        s = np.array(s)
        if s.ndim == 0:
            s = np.ones(4**n_qubits) * float(s)
        elif s.ndim > 2 or set(s.shape) != {4**n_qubits}:
            raise ValueError(
                f"'s' must be either a vector of exactly {4**n_qubits} "
                f"elements, or a {(4**n_qubits, 4**n_qubits)} matrix")

    mats = [kron(*m) for m in product(*([[_PAULIS[g] for g in 'IXYZ']] *
                                        n_qubits))]
    return MatrixChannel(LMatrices=mats, qubits=qubits, s=s, tags=tags,
                         name=name, copy=False, atol=atol, methods=methods,
                         use_cache=use_cache)


def LocalPauliChannel(qubits, s, tags=None,
                      name: str = 'LOCAL_PAULI_CHANNEL', copy: bool = True,
                      atol: float = 1e-8, methods=None,
                      use_cache: bool = True):
    """One single-qubit Pauli channel per qubit."""
    return tuple(
        GlobalPauliChannel(qubits=(q,), name=name, s=s, tags=tags,
                           copy=copy, atol=atol, methods=methods,
                           use_cache=use_cache) for q in qubits)


def GlobalDepolarizingChannel(qubits, p,
                              name: str = 'GLOBAL_DEPOLARIZING_CHANNEL',
                              **kwargs):
    """ρ → (1-p) ρ + p I/d on all ``qubits``."""
    p = float(p)
    ns = 4**len(tuple(qubits))
    s = [1 - p + p / ns] + [p / ns] * (ns - 1)
    return GlobalPauliChannel(qubits=qubits, name=name, s=s, **kwargs)


def LocalDepolarizingChannel(qubits, p,
                             name: str = 'LOCAL_DEPOLARIZING_CHANNEL',
                             **kwargs):
    """One depolarizing channel per qubit."""
    p = _get_params(qubits, p, value_type=float)
    return tuple(
        GlobalDepolarizingChannel(qubits=(q,), name=name, p=p[q], **kwargs)
        for q in qubits)


def LocalDephasingChannel(qubits, p, pauli_index: int = 3,
                          name: str = 'LOCAL_DEPHASING_CHANNEL', **kwargs):
    """ρ → (1-p) ρ + p σ ρ σ per qubit, with σ a chosen Pauli."""
    p = _get_params(qubits, p, value_type=float)
    pauli_index = _get_params(qubits, pauli_index, value_type=int)
    if any(v not in range(4) for v in
           (pauli_index[q] for q in qubits)):
        raise ValueError("`pauli_index` must be in {0,1,2,3}")

    def _one(q):
        s = [1 - p[q], 0, 0, 0]
        s[pauli_index[q]] += p[q]
        return GlobalPauliChannel(qubits=(q,), name=name, s=s, **kwargs)

    return tuple(map(_one, qubits))


def AmplitudeDampingChannel(qubits, gamma, p=1,
                            name: str = 'AMPLITUDE_DAMPING_CHANNEL',
                            atol: float = 1e-8, **kwargs):
    """Generalized amplitude damping with four Kraus operators
    (reference ``channel.py:733-808``)."""
    gamma = _get_params(qubits, gamma, value_type=float)
    p = _get_params(qubits, p, value_type=float)

    def _one(q):
        _g, _p = gamma[q], p[q]
        E0 = np.sqrt(_p) * np.diag([1, np.sqrt(1 - _g)])
        E1 = np.sqrt(_p) * np.array([[0, np.sqrt(_g)], [0, 0]])
        E2 = np.sqrt(1 - _p) * np.diag([np.sqrt(1 - _g), 1])
        E3 = np.sqrt(1 - _p) * np.array([[0, 0], [np.sqrt(_g), 0]])
        mats = [m for m in (E0, E1, E2, E3)
                if not np.allclose(m, 0, atol=atol)]
        return MatrixChannel(LMatrices=tuple(mats), qubits=(q,), s=1,
                             name=name, atol=atol, **kwargs)

    return tuple(map(_one, qubits))


def _get_params(keys, args, value_type=lambda x: x, key_name='qubit'):
    """Broadcast a scalar / list / dict of per-key parameters; a dict may
    carry a builtin-``any`` key as fallback
    (reference ``channel.py:810-861``)."""
    from collections import defaultdict

    keys = tuple(keys)
    try:
        v = value_type(args)
        return {k: v for k in keys}
    except (TypeError, ValueError):
        pass
    if isinstance(args, dict):
        out = {k: (v if k is any else value_type(v))
               for k, v in args.items()}
        if any in out:
            default = value_type(out.pop(any))
            return defaultdict(lambda: default, out)
        if set(keys) != set(out):
            raise ValueError(f"All {key_name}s must be specified")
        return out
    vals = [value_type(v) for v in args]
    if len(vals) != len(keys):
        raise ValueError(f"Must have exactly one value per {key_name}")
    return dict(zip(keys, vals))
