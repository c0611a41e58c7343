"""SuperGates: operators acting on density matrices.

Parity with the reference ``hybridq/dm/gate/`` (gate.py, property.py):

  * ``MatrixSuperGate``  — explicit map matrix with (l_qubits, r_qubits).
  * ``KrausSuperGate``   — K(ρ) = Σ_ij s_ij L_i ρ R_j†; its vectorized map
    is Σ_ij s_ij L_i ⊗ conj(R_j) (row-major vec convention), which is
    exactly a SchmidtGate with conjugated right gates
    (``dm/gate/gate.py:123-212``).
  * ``TupleSuperGate``   — container.

SuperGates expose ``qubits == (l_qubits, r_qubits)`` and ``map(order)``;
the density-matrix engine lowers them onto a doubled-qubit pure-state
circuit (see ``hybridq_tpu_torch.dm.simulation``).
"""

from __future__ import annotations

from warnings import warn

import numpy as np

from hybridq_tpu_torch.gate import (BaseGate, MatrixGate, SchmidtGate, TupleGate)
from hybridq_tpu_torch.utils import sort

__all__ = ['BaseSuperGate', 'MatrixSuperGate', 'KrausSuperGate',
           'TupleSuperGate', 'Gate']


class BaseSuperGate:
    """Marker base type for all supergates (operators on density
    matrices)."""


class _MapMixin:
    """Provides ``map(order)`` given ``_map_matrix()`` and
    ``qubits == (l_qubits, r_qubits)``."""

    def _map_matrix(self) -> np.ndarray:
        raise NotImplementedError

    def map(self, order=None) -> np.ndarray:
        """Vectorized superoperator matrix acting on vec(ρ) (row-major),
        optionally reordered (reference ``dm/gate/property.py:76-137``)."""
        l_qubits, r_qubits = self.qubits
        U = self._map_matrix()
        if order is None:
            return U
        order = tuple(order)
        try:
            l_order, r_order = order
            l_order, r_order = tuple(l_order), tuple(r_order)
            if sort(l_order) != sort(l_qubits) or \
                    sort(r_order) != sort(r_qubits):
                raise ValueError(
                    "'order' is not a valid permutation of qubits.")
        except (TypeError, ValueError) as e:
            if isinstance(e, ValueError) and 'permutation' in str(e):
                raise
            if l_qubits != r_qubits or sort(order) != sort(l_qubits):
                raise ValueError(
                    "'order' is not a valid permutation of qubits.")
            l_order = r_order = tuple(order)
        if l_order == tuple(l_qubits) and r_order == tuple(r_qubits):
            return U
        g = MatrixGate(U,
                       qubits=tuple((0, q) for q in l_qubits) + tuple(
                           (1, q) for q in r_qubits), copy_matrix=False)
        return g.matrix(order=tuple((0, q) for q in l_order) + tuple(
            (1, q) for q in r_order))

    def isclose(self, gate, atol: float = 1e-8) -> bool:
        if not isinstance(gate, _MapMixin) or self.qubits != gate.qubits:
            return False
        return np.allclose(self.map(order=self.qubits),
                           gate.map(order=self.qubits), atol=atol)

    def commutes_with(self, gate, atol: float = 1e-7) -> bool:
        if not isinstance(gate, _MapMixin):
            raise ValueError(
                "Cannot compute commutation with a non-map gate.")
        g1 = MatrixGate(self._map_matrix(),
                        qubits=[(0, q) for q in self.qubits[0]] +
                        [(1, q) for q in self.qubits[1]], copy_matrix=False)
        g2 = MatrixGate(gate._map_matrix(),
                        qubits=[(0, q) for q in gate.qubits[0]] +
                        [(1, q) for q in gate.qubits[1]], copy_matrix=False)
        return g1.commutes_with(g2, atol=atol)


class MatrixSuperGate(BaseSuperGate, _MapMixin):
    """SuperGate defined by an explicit map matrix."""

    name = 'SMATRIX'

    def __init__(self, Map, l_qubits, r_qubits=None, tags=None,
                 copy: bool = True):
        Map = (np.array if copy else np.asarray)(Map)
        l_qubits = tuple(l_qubits)
        r_qubits = l_qubits if r_qubits is None else tuple(r_qubits)
        n = len(l_qubits) + len(r_qubits)
        if Map.shape != (2**n, 2**n):
            raise ValueError("'Map' must be consistent with the total "
                             "number of qubits.")
        self._map = Map
        self._l_qubits = l_qubits
        self._r_qubits = r_qubits
        self.tags = dict(tags) if tags else {}

    @property
    def Map(self):
        return self._map

    @property
    def Matrix(self):
        return self._map

    @property
    def l_qubits(self):
        return self._l_qubits

    @property
    def r_qubits(self):
        return self._r_qubits

    @property
    def qubits(self):
        return (self._l_qubits, self._r_qubits)

    @property
    def n_qubits(self):
        return tuple(len(q) for q in self.qubits)

    def provides(self, attrs) -> bool:
        if isinstance(attrs, str):
            attrs = attrs.split(',')
        return all(hasattr(self, a.strip()) for a in attrs)

    def _map_matrix(self) -> np.ndarray:
        return self._map

    def __repr__(self):
        return (f"SuperGate(name={self.name!r}, l_qubits={self._l_qubits}, "
                f"r_qubits={self._r_qubits})")


class KrausSuperGate(BaseSuperGate, _MapMixin):
    """SuperGate K(ρ) = Σ_ij s_ij L_i ρ R_j†."""

    name = 'KRAUS'

    def __init__(self, gates, s=1, tags=None):
        try:
            l_gates, r_gates = gates
            l_gates = TupleGate(tuple(l_gates))
            r_gates = TupleGate(tuple(r_gates))
        except (TypeError, ValueError):
            l_gates = TupleGate(tuple(gates))
            r_gates = l_gates
        if r_gates and not l_gates:
            raise ValueError(
                "'l_gates' cannot be empty if 'r_gates' is provided")
        s = np.asarray(s)
        if s.ndim == 0:
            s = float(s) * np.ones(len(l_gates))
        self._gates = (l_gates, r_gates)
        self._s = s
        self.tags = dict(tags) if tags else {}

    @property
    def gates(self):
        return self._gates

    @property
    def s(self):
        return self._s

    @property
    def qubits(self):
        return (self._gates[0].qubits, self._gates[1].qubits)

    @property
    def n_qubits(self):
        return tuple(None if q is None else len(q) for q in self.qubits)

    def provides(self, attrs) -> bool:
        if isinstance(attrs, str):
            attrs = attrs.split(',')
        return all(hasattr(self, a.strip()) for a in attrs)

    def _map_matrix(self) -> np.ndarray:
        # Σ_ij s_ij L_i ⊗ conj(R_j) == SchmidtGate with conjugated right
        # gates (hybridq/dm/gate/gate.py:212).
        sg = SchmidtGate(gates=self._gates, s=self._s, conj_rgates=True)
        return sg.matrix()

    def __repr__(self):
        return (f"SuperGate(name={self.name!r}, "
                f"l_qubits={self.qubits[0]}, r_qubits={self.qubits[1]})")


class TupleSuperGate(tuple, BaseSuperGate):
    """Tuple of (super)gates."""

    name = 'STUPLE'

    def __new__(cls, gates=(), tags=None):
        return tuple.__new__(cls, tuple(gates))

    def __init__(self, gates=(), tags=None):
        self.tags = dict(tags) if tags else {}

    @property
    def qubits(self):
        lq, rq = [], []
        for g in self:
            if isinstance(g, BaseSuperGate):
                l, r = g.qubits
            elif isinstance(g, BaseGate):
                l = r = g.qubits
            else:
                raise TypeError(type(g).__name__)
            if l is None or r is None:
                return None
            lq.extend(l)
            rq.extend(r)
        return (tuple(sort(set(lq))), tuple(sort(set(rq))))

    @property
    def n_qubits(self):
        q = self.qubits
        return None if q is None else tuple(len(x) for x in q)

    def provides(self, attrs) -> bool:
        if isinstance(attrs, str):
            attrs = attrs.split(',')
        return all(hasattr(self, a.strip()) for a in attrs)


_GATE_ALIASES = {'KSG': 'KRAUS', 'MSG': 'SMATRIX'}


def Gate(name: str, **kwargs):
    """SuperGate factory (reference ``dm/gate/gate.py:225-242``)."""
    name = str(name).upper()
    if name in _GATE_ALIASES:
        warn(f"'{name}' is an alias for '{_GATE_ALIASES[name]}'.")
        name = _GATE_ALIASES[name]
    if name == 'KRAUS':
        return KrausSuperGate(**kwargs)
    if name == 'SMATRIX':
        return MatrixSuperGate(**kwargs)
    if name == 'STUPLE':
        return TupleSuperGate(**kwargs)
    raise NotImplementedError(f"'{name}' not implemented.")
