"""Gate algebra: plain-dataclass rebuild of the reference gate layer.

The reference builds every gate as a dynamically generated type with a
metaclass factory (``hybridq/base/base.py:538``) so that gate classes pickle
across MPI ranks.  Here circuits are host-side data and only dense arrays
cross device boundaries, so gates are ordinary Python classes — simpler,
picklable with the stdlib, and equally expressive.  (A copy of
``hybridq_tpu/gate/gate.py``; the port imports nothing of that package.)

Behavioral parity targets (reference file:line):
  * ``Gate()`` factory and gate zoo          — ``hybridq/gate/gate.py:368-497``
  * ``matrix(order)`` semantics (reorder → power → conj → T)
                                             — ``hybridq/gate/property.py:377-445``
  * rotation power folding into the angle    — ``hybridq/gate/property.py:699-722``
  * commutation / isclose checks             — ``hybridq/gate/property.py:447-573``
  * Schmidt / stochastic / functional /
    controlled gates                         — ``hybridq/gate/gate.py:677-1063``
  * projection / measure                     — ``hybridq/gate/projection.py``,
                                               ``hybridq/gate/measure.py``
"""

from __future__ import annotations

import copy
from typing import Callable, Optional

import numpy as np

from hybridq_tpu_torch.gate.zoo import GATES, ALIASES, GateSpec, resolve_name
from hybridq_tpu_torch.utils import sort
from hybridq_tpu_torch.utils.linalg import isunitary, matrix_power

__all__ = [
    'BaseGate', 'PowerMatrixGate', 'NamedGate', 'MatrixGate', 'TupleGate',
    'FunctionalGate', 'StochasticGate', 'SchmidtGate', 'ControlledGate',
    'ProjectionGate', 'MeasureGate', 'Gate', 'Projection', 'Measure',
    'Control'
]


class BaseGate:
    """Common base type for all gates.

    Attributes
    ----------
    qubits: tuple | None
        Qubits the gate acts on (arbitrary hashable labels), or None if not
        yet assigned.
    tags: dict
        Arbitrary user metadata.  Excluded from equality.
    """

    name: str = 'BASE'

    def __init__(self, qubits=None, n_qubits: Optional[int] = None,
                 tags: Optional[dict] = None):
        if qubits is not None:
            qubits = tuple(qubits)
            if len(set(qubits)) != len(qubits):
                raise ValueError("'qubits' must be unique.")
            if n_qubits is not None and n_qubits != len(qubits):
                raise ValueError("'n_qubits' inconsistent with 'qubits'.")
            n_qubits = len(qubits)
        self._qubits = qubits
        self._n_qubits = n_qubits
        self.tags = dict(tags) if tags else {}

    # -- structure -------------------------------------------------------
    @property
    def qubits(self):
        return self._qubits

    @property
    def n_qubits(self) -> Optional[int]:
        return self._n_qubits

    def on(self, qubits=None, *, inplace: bool = False) -> 'BaseGate':
        """Return a copy of the gate acting on ``qubits``."""
        g = self if inplace else copy.deepcopy(self)
        if qubits is None:
            g._qubits = None
        else:
            qubits = tuple(qubits)
            if len(set(qubits)) != len(qubits):
                raise ValueError("'qubits' must be unique.")
            if g._n_qubits not in (None, len(qubits)):
                raise ValueError(
                    f"Expected {g._n_qubits} qubits, got {len(qubits)}.")
            g._qubits = qubits
            g._n_qubits = len(qubits)
        return g

    def provides(self, attrs) -> bool:
        """Return True if the gate provides all the given attribute names."""
        if isinstance(attrs, str):
            attrs = attrs.split(',')
        return all(hasattr(self, a.strip()) for a in attrs)

    def is_clifford(self) -> bool:
        return False

    # -- tags ------------------------------------------------------------
    def set_tags(self, tags: dict, *, inplace: bool = False) -> 'BaseGate':
        g = self if inplace else copy.deepcopy(self)
        g.tags = dict(tags) if tags else {}
        return g

    def update_tags(self, tags: dict, *, inplace: bool = False) -> 'BaseGate':
        g = self if inplace else copy.deepcopy(self)
        g.tags.update(tags)
        return g

    def remove_tags(self, keys, *, inplace: bool = False) -> 'BaseGate':
        g = self if inplace else copy.deepcopy(self)
        for k in tuple(keys):
            g.tags.pop(k, None)
        return g

    # -- identity --------------------------------------------------------
    def _eq_state(self) -> tuple:
        """State participating in equality/hash (tags excluded)."""
        return (type(self).__name__, self.name, self._qubits, self._n_qubits)

    def __eq__(self, other):
        if not isinstance(other, BaseGate):
            return NotImplemented
        try:
            return self._eq_state() == other._eq_state()
        except Exception:
            return False

    def __hash__(self):
        def _freeze(x):
            if isinstance(x, np.ndarray):
                return (x.shape, x.tobytes())
            if isinstance(x, tuple):
                return tuple(_freeze(v) for v in x)
            return x
        return hash(_freeze(self._eq_state()))

    def __repr__(self):
        parts = [f"name={self.name!r}"]
        if self._qubits is not None:
            parts.append(f"qubits={self._qubits!r}")
        elif self._n_qubits is not None:
            parts.append(f"n_qubits={self._n_qubits}")
        parts.extend(self._repr_extra())
        if self.tags:
            parts.append(f"tags={self.tags!r}")
        return f"Gate({', '.join(parts)})"

    def _repr_extra(self):
        return []

    def copy(self) -> 'BaseGate':
        return copy.deepcopy(self)

    def __copy__(self):
        return copy.deepcopy(self)


class PowerMatrixGate(BaseGate):
    """A gate with a matrix representation, a power, and conj/T flags.

    ``matrix(order)`` applies, in this order: qubit reordering, matrix power
    (fractional via scipy on host), complex conjugation, transposition —
    matching ``hybridq/gate/property.py:377-445``.
    """

    def __init__(self, qubits=None, n_qubits=None, power=1, tags=None):
        super().__init__(qubits=qubits, n_qubits=n_qubits, tags=tags)
        self._power = 1 if power is None else power
        self._conj = False
        self._T = False

    # -- power / conj / T ------------------------------------------------
    @property
    def power(self):
        return self._power

    def set_power(self, power, *, inplace: bool = False) -> 'PowerMatrixGate':
        g = self if inplace else copy.deepcopy(self)
        g._power = 1 if power is None else power
        return g

    def __pow__(self, p) -> 'PowerMatrixGate':
        return self.set_power(self._power * p)

    def inv(self, *, inplace: bool = False) -> 'PowerMatrixGate':
        return self.set_power(self._power * -1, inplace=inplace)

    def conj(self, *, inplace: bool = False) -> 'PowerMatrixGate':
        g = self if inplace else copy.deepcopy(self)
        g._conj ^= True
        return g

    def T(self, *, inplace: bool = False) -> 'PowerMatrixGate':
        g = self if inplace else copy.deepcopy(self)
        g._T ^= True
        return g

    def adj(self, *, inplace: bool = False) -> 'PowerMatrixGate':
        g = self if inplace else copy.deepcopy(self)
        g._conj ^= True
        g._T ^= True
        return g

    def is_conjugated(self) -> bool:
        return self._conj

    def is_transposed(self) -> bool:
        return self._T

    # -- matrix ----------------------------------------------------------
    def base_matrix(self) -> np.ndarray:
        """Matrix before power/conj/T, in declared qubit order."""
        raise NotImplementedError

    def matrix(self, order=None) -> np.ndarray:
        U = np.asarray(self.base_matrix())
        n = self.n_qubits
        if n is None:
            n = int(round(np.log2(U.shape[0])))

        if order is not None:
            order = tuple(order)
            if self.qubits is None or sort(order) != sort(self.qubits):
                raise ValueError(
                    "'order' is not a permutation of 'gate.qubits'.")
            if order != self.qubits:
                perm = [self.qubits.index(q) for q in order]
                U = np.reshape(
                    np.transpose(np.reshape(U, (2,) * (2 * n)),
                                 perm + [n + p for p in perm]), (2**n, 2**n))

        if self._power != 1:
            U = matrix_power(U, self._power)
        if self._conj:
            U = U.conj()
        if self._T:
            U = U.T
        return U

    def unitary(self) -> bool:
        """True if the gate's matrix is unitary."""
        return isunitary(self.matrix())

    def isclose(self, gate, atol: float = 1e-8) -> bool:
        """True if ``gate`` has the same matrix on the same qubits."""
        if not (isinstance(gate, BaseGate) and gate.provides('matrix')):
            return False
        if self.n_qubits != gate.n_qubits:
            return False
        if (self.qubits is None) != (gate.qubits is None):
            return False
        if self.qubits is not None:
            if sort(self.qubits) != sort(gate.qubits):
                return False
            return np.allclose(self.matrix(),
                               gate.matrix(order=self.qubits),
                               atol=atol)
        return np.allclose(self.matrix(), gate.matrix(), atol=atol)

    def commutes_with(self, gate, atol: float = 1e-8) -> bool:
        """Numerically check commutation with another matrix gate
        (reference: ``hybridq/gate/property.py:498-573``)."""
        if not (isinstance(gate, BaseGate) and
                gate.provides('matrix,qubits')):
            raise ValueError("'gate' must provide matrix and qubits.")
        if self.qubits is None or gate.qubits is None:
            raise ValueError("Both gates must have qubits assigned.")
        shared = set(self.qubits) & set(gate.qubits)
        if not shared:
            return True
        from hybridq_tpu_torch.gate.utils import merge
        ab = merge(self, gate)
        ba = merge(gate, self)
        return np.allclose(ab.matrix(order=ba.qubits), ba.matrix(), atol=atol)

    def _eq_state(self):
        return super()._eq_state() + (self._power, self._conj, self._T)

    def _repr_extra(self):
        out = []
        if self._power != 1:
            out.append(f"power={self._power}")
        if self._conj and self._T:
            out.append("adj=True")
        elif self._conj:
            out.append("conj=True")
        elif self._T:
            out.append("T=True")
        return out


class NamedGate(PowerMatrixGate):
    """A gate from the named zoo (H, X, CZ, FSIM, ...)."""

    def __init__(self, name: str, qubits=None, n_qubits=None, params=None,
                 power=1, tags=None):
        name = resolve_name(name)
        if name not in GATES:
            raise ValueError(f"Gate '{name}' not available.")
        spec = GATES[name]
        if spec.n_qubits is any:
            # Variable-size gates default to one qubit, like the reference
            # (hybridq/gate/gate.py:553-561).
            if n_qubits is None and qubits is None:
                n_qubits = 1
        else:
            if n_qubits is not None and n_qubits != spec.n_qubits:
                raise ValueError(
                    f"Gate '{name}' acts on {spec.n_qubits} qubits.")
            n_qubits = spec.n_qubits
        super().__init__(qubits=qubits, n_qubits=n_qubits, power=power,
                         tags=tags)
        self.name = name
        self._params = None
        if params is not None:
            self.set_params(params, inplace=True)
        elif spec.n_params and params is None:
            pass  # params may be provided later via set_params

    @property
    def spec(self) -> GateSpec:
        return GATES[self.name]

    @property
    def n_params(self) -> int:
        return self.spec.n_params

    @property
    def params(self):
        return self._params

    def set_params(self, params, *, inplace: bool = False) -> 'NamedGate':
        g = self if inplace else copy.deepcopy(self)
        if params is None:
            g._params = None
            return g
        params = tuple(params)
        if len(params) != g.spec.n_params:
            raise ValueError(
                f"Gate '{g.name}' requires {g.spec.n_params} params.")
        if g.spec.is_rotation:
            # Rotations fold power into the angle
            # (hybridq/gate/property.py:699-722).
            try:
                params = tuple((float(p) * g._power) % (4 * np.pi)
                               for p in params)
                g._params = params
                g._power = 1
                return g
            except (TypeError, ValueError):
                pass
        g._params = params
        return g

    def set_power(self, power, *, inplace: bool = False) -> 'NamedGate':
        power = 1 if power is None else power
        if self.spec.is_rotation and self._params is not None:
            try:
                return self.set_params(
                    tuple(float(p) * power for p in self._params),
                    inplace=inplace)
            except (TypeError, ValueError):
                pass
        if self.name == 'I':
            # Identity is idempotent under powers.
            return self if inplace else copy.deepcopy(self)
        return super().set_power(power, inplace=inplace)

    def base_matrix(self) -> np.ndarray:
        if self.name == 'I':
            if self.n_qubits is None:
                raise ValueError("'I' requires n_qubits or qubits.")
            return np.eye(2**self.n_qubits, dtype=complex)
        if self.spec.n_params and self._params is None:
            raise ValueError("'params' must be provided.")
        return self.spec.base_matrix(self._params)

    def is_clifford(self) -> bool:
        if not self.spec.clifford:
            return False
        p = self._power
        try:
            return float(p) == int(p)
        except (TypeError, ValueError):
            return False

    # Functional identity: 'I' can be applied without a matrix.
    def apply(self, psi, order):
        if self.name != 'I':
            raise AttributeError("Only 'I' supports direct apply.")
        return psi, order

    def _eq_state(self):
        return super()._eq_state() + (self._params,)

    def _repr_extra(self):
        out = []
        if self._params is not None:
            out.append(f"params={tuple(np.round(self._params, 5))}")
        return out + super()._repr_extra()


class MatrixGate(PowerMatrixGate):
    """A gate defined by an explicit matrix."""

    name = 'MATRIX'

    def __init__(self, U, qubits=None, n_qubits=None, power=1, tags=None,
                 copy_matrix: bool = True):
        U = np.array(U, dtype=complex, copy=copy_matrix)
        if U.ndim != 2 or U.shape[0] != U.shape[1]:
            raise ValueError("'U' must be a square matrix.")
        nq = int(round(np.log2(U.shape[0])))
        if 2**nq != U.shape[0]:
            raise ValueError("'U' must have power-of-two dimensions.")
        if n_qubits is not None and n_qubits != nq:
            raise ValueError("'n_qubits' inconsistent with 'U'.")
        super().__init__(qubits=qubits, n_qubits=nq, power=power, tags=tags)
        self._U = U

    @property
    def Matrix(self) -> np.ndarray:
        return self._U

    def base_matrix(self) -> np.ndarray:
        return self._U

    def _eq_state(self):
        return super()._eq_state() + (self._U,)

    def _eq_state_cmp(self):  # pragma: no cover - helper
        return self._eq_state()

    def __eq__(self, other):
        if not isinstance(other, BaseGate):
            return NotImplemented
        if type(self) is not type(other):
            return False
        s, o = self._eq_state(), other._eq_state()
        if s[:-1] != o[:-1]:
            return False
        return np.array_equal(s[-1], o[-1])


class TupleGate(BaseGate, tuple):
    """A tuple of gates behaving as a single container gate
    (reference: ``hybridq/gate/property.py:767-830``)."""

    name = 'TUPLE'

    def __new__(cls, gates=(), tags=None):
        return tuple.__new__(cls, tuple(gates))

    def __init__(self, gates=(), tags=None):
        BaseGate.__init__(self, tags=tags)

    @property
    def qubits(self):
        qs = []
        for g in self:
            if g.qubits is None:
                return None
            qs.extend(g.qubits)
        return tuple(sort(set(qs)))

    @property
    def n_qubits(self):
        q = self.qubits
        return None if q is None else len(q)

    def on(self, qubits=None, *, inplace: bool = False):
        raise NotImplementedError(
            "TupleGate qubits are defined by its elements.")

    def flatten(self) -> 'TupleGate':
        out = []
        for g in self:
            if isinstance(g, TupleGate):
                out.extend(g.flatten())
            else:
                out.append(g)
        return TupleGate(out, tags=self.tags)

    def _eq_state(self):
        return (type(self).__name__, tuple(g._eq_state() for g in self))

    def __repr__(self):
        return f"TupleGate({tuple.__repr__(self)})"

    def __hash__(self):
        return BaseGate.__hash__(self)

    def __eq__(self, other):
        if not isinstance(other, TupleGate):
            return NotImplemented
        return len(self) == len(other) and all(
            a == b for a, b in zip(self, other))


class FunctionalGate(BaseGate):
    """A gate defined by an arbitrary state transformation.

    ``f(self, psi, order) -> (new_psi, new_order)`` operates on a host-side
    dense state of shape ``(2,)*len(order)`` whose axis ``i`` corresponds to
    qubit ``order[i]``.
    """

    name = 'FUNCTIONAL'

    def __init__(self, f: Callable, qubits=None, n_qubits=None, tags=None):
        if not callable(f):
            raise ValueError("'f' must be callable.")
        super().__init__(qubits=qubits, n_qubits=n_qubits, tags=tags)
        self._f = f

    @property
    def f(self):
        return self._f

    def apply(self, psi, order, **kwargs):
        return self._f(self, psi, order, **kwargs)

    def __call__(self, psi, order, **kwargs):
        if self.qubits is None:
            raise ValueError("'qubits' must be specified.")
        order = tuple(order)
        if any(q not in order for q in self.qubits):
            raise ValueError(
                "'FunctionalGate' is expecting qubits not in 'order'.")
        return self.apply(psi, order, **kwargs)

    def _eq_state(self):
        code = getattr(self._f, '__code__', self._f)
        return super()._eq_state() + (code,)


class StochasticGate(BaseGate):
    """A gate sampled from a set of gates with given probabilities
    (reference: ``hybridq/gate/gate.py:763-840``)."""

    name = 'STOCHASTIC'

    def __init__(self, gates, p, tags=None):
        gates = TupleGate(gates)
        p = np.asarray(p, dtype=float)
        if len(p) != len(gates):
            raise ValueError("'p' must have one entry per gate.")
        if np.any(p < 0) or not np.isclose(np.sum(p), 1):
            raise ValueError("'p' must be a probability distribution.")
        super().__init__(tags=tags)
        self._gates = gates
        self._p = p

    @property
    def gates(self) -> TupleGate:
        return self._gates

    @property
    def p(self) -> np.ndarray:
        return self._p

    @property
    def qubits(self):
        return self._gates.qubits

    @property
    def n_qubits(self):
        return self._gates.n_qubits

    def sample(self, size=None, replace=True, rng=None):
        """Sample gate(s) according to the probabilities."""
        rng = np.random.default_rng() if rng is None else rng
        if size is None:
            return self._gates[int(rng.choice(len(self._gates), p=self._p))]
        idx = rng.choice(len(self._gates), size=size, replace=replace,
                         p=self._p)
        return TupleGate(self._gates[int(i)] for i in idx)

    def _eq_state(self):
        return (type(self).__name__, self._gates._eq_state(),
                tuple(self._p))


class SchmidtGate(BaseGate):
    """Gate of the form ``U = sum_ij s_ij L_i ⊗ R_j``
    (reference: ``hybridq/gate/property.py:832-979``)."""

    name = 'SCHMIDT'

    def __init__(self, gates, s, tags=None, conj_rgates: bool = False):
        gates_l, gates_r = gates
        self._gates = (TupleGate(gates_l), TupleGate(gates_r))
        s = np.asarray(s, dtype=complex)
        if s.ndim == 1:
            if len(self._gates[0]) != len(self._gates[1]) or \
                    len(s) != len(self._gates[0]):
                raise ValueError("'s' inconsistent with gates.")
        elif s.ndim == 2:
            if s.shape != (len(self._gates[0]), len(self._gates[1])):
                raise ValueError("'s' inconsistent with gates.")
        else:
            raise ValueError("'s' must be a vector or a matrix.")
        super().__init__(tags=tags)
        self._s = s
        self._conj_rgates = conj_rgates

    @property
    def gates(self):
        return self._gates

    @property
    def s(self) -> np.ndarray:
        return self._s

    @property
    def qubits(self):
        ql, qr = self._gates[0].qubits, self._gates[1].qubits
        if ql is None or qr is None:
            return None
        return ql + qr

    @property
    def n_qubits(self):
        q = self.qubits
        return None if q is None else len(q)

    def matrix(self, order=None) -> np.ndarray:
        ql = self._gates[0].qubits
        qr = self._gates[1].qubits
        if ql is None or qr is None:
            raise ValueError("All sub-gates must have qubits.")
        s = self._s if self._s.ndim == 2 else np.diag(self._s)
        U = 0
        for i, gl in enumerate(self._gates[0]):
            Ml = gl.matrix(order=ql)
            for j, gr in enumerate(self._gates[1]):
                if not s[i, j]:
                    continue
                Mr = gr.matrix(order=qr)
                if self._conj_rgates:
                    Mr = Mr.conj()
                U = U + s[i, j] * np.kron(Ml, Mr)
        if order is not None:
            return MatrixGate(U, qubits=self.qubits).matrix(order=order)
        return U

    def _eq_state(self):
        return (type(self).__name__, self._gates[0]._eq_state(),
                self._gates[1]._eq_state(), self._s.tobytes(),
                self._conj_rgates)


class ControlledGate(PowerMatrixGate):
    """Controlled version of a matrix gate: block-diag(I, U) with control
    qubits first (reference: ``hybridq/gate/gate.py:923-1059``)."""

    name = 'CONTROL'

    def __init__(self, c_qubits, gate: PowerMatrixGate, power=1, tags=None):
        c_qubits = tuple(c_qubits)
        if gate.qubits is None:
            raise ValueError("'gate' must have qubits.")
        if set(c_qubits) & set(gate.qubits):
            raise ValueError("Control qubits must differ from gate qubits.")
        super().__init__(qubits=c_qubits + gate.qubits, power=power,
                         tags=tags)
        self._c_qubits = c_qubits
        self._gate = gate

    @property
    def c_qubits(self):
        return self._c_qubits

    @property
    def gate(self):
        return self._gate

    def on(self, qubits=None, *, inplace: bool = False):
        g = self if inplace else copy.deepcopy(self)
        if qubits is None:
            raise ValueError("ControlledGate requires explicit qubits.")
        qubits = tuple(qubits)
        nc = len(g._c_qubits)
        if len(qubits) != nc + g._gate.n_qubits:
            raise ValueError("Wrong number of qubits.")
        g._c_qubits = qubits[:nc]
        g._gate = g._gate.on(qubits[nc:])
        g._qubits = qubits
        g._n_qubits = len(qubits)
        return g

    def base_matrix(self) -> np.ndarray:
        U = self._gate.matrix()
        nc = len(self._c_qubits)
        d = U.shape[0]
        M = np.eye(d * 2**nc, dtype=complex)
        M[-d:, -d:] = U
        return M

    def _eq_state(self):
        return super()._eq_state() + (self._c_qubits,
                                      self._gate._eq_state())


# ---------------------------------------------------------------------------
# Projection / Measure (z-basis, host-side dense apply)
# ---------------------------------------------------------------------------

def _project_dense(psi, axes, state, renormalize: bool = True,
                   atol: float = 1e-6):
    """Zero all amplitudes inconsistent with ``state`` on ``axes``
    (reference: ``hybridq/gate/projection.py:25-70``)."""
    sel = tuple(
        state[axes.index(x)] if x in axes else slice(None)
        for x in range(psi.ndim))
    new = np.zeros_like(psi)
    norm = np.linalg.norm(psi[sel].ravel())
    if norm > atol:
        new[sel] = psi[sel]
        if renormalize:
            new /= norm
    return new


class ProjectionGate(FunctionalGate):
    """Projection onto a z-basis state of a subset of qubits."""

    name = 'PROJECTION'

    def __init__(self, state, qubits=None, tags=None):
        state = ''.join(str(s) for s in state)
        if any(s not in '01' for s in state):
            raise ValueError(
                "Only projections to the z-basis are supported.")
        if qubits is not None and len(tuple(qubits)) != len(state):
            raise ValueError("'state' inconsistent with 'qubits'.")
        super().__init__(f=self._apply, qubits=qubits,
                         n_qubits=len(state), tags=tags)
        self._state = state

    @property
    def state(self) -> str:
        return self._state

    @staticmethod
    def _apply(self, psi, order, renormalize: bool = True):
        order = tuple(order)
        axes = tuple(order.index(q) for q in self.qubits)
        st = tuple(int(s) for s in self._state)
        complex_split = psi.ndim > len(order)
        if complex_split:
            new = np.zeros_like(psi)
            new[0] = _project_dense(psi[0], axes, st, renormalize=False)
            new[1] = _project_dense(psi[1], axes, st, renormalize=False)
            if renormalize:
                norm = np.linalg.norm(new.ravel())
                if norm != 0:
                    new /= norm
            return new, order
        return _project_dense(psi, axes, st,
                              renormalize=renormalize), order

    def _eq_state(self):
        return BaseGate._eq_state(self) + (self._state,)


class MeasureGate(FunctionalGate):
    """Projective measurement with state collapse
    (reference: ``hybridq/gate/measure.py:25-128``)."""

    name = 'MEASURE'

    def __init__(self, qubits=None, n_qubits=None, tags=None):
        super().__init__(f=self._apply, qubits=qubits, n_qubits=n_qubits,
                         tags=tags)

    @staticmethod
    def _apply(self, psi, order, renormalize: bool = True,
               get_probs_only: bool = False, get_state_only: bool = False,
               rng=None):
        order = tuple(order)
        axes = tuple(order.index(q) for q in self.qubits)
        complex_split = psi.ndim > len(order)
        if complex_split:
            full = psi[0] + 1j * psi[1]
        else:
            full = psi
        shape = full.shape
        rest = tuple(x for x in range(full.ndim) if x not in axes)
        size = int(np.prod([shape[x] for x in axes], dtype=np.int64))
        m = np.transpose(full, axes + rest).reshape(size, -1)
        probs = np.sum(np.real(m * m.conj()), axis=1)
        if get_probs_only:
            return probs
        rng = np.random.default_rng() if rng is None else rng
        k = int(rng.choice(size, p=probs / probs.sum()))
        if get_state_only:
            return k
        new = np.zeros_like(m)
        row = m[k]
        new[k] = row / np.linalg.norm(row) if renormalize else row
        inv = np.argsort(axes + rest)
        out = np.transpose(
            new.reshape([shape[x] for x in axes + rest]), inv)
        if complex_split:
            out = np.stack([out.real, out.imag]).astype(psi.dtype)
        return out, order


# ---------------------------------------------------------------------------
# Factories (the reference public constructors)
# ---------------------------------------------------------------------------

def Gate(name: str, qubits=None, params=None, n_qubits=None, power=1,
         tags=None, **kwargs) -> BaseGate:
    """Generate a gate by name — the main gate factory
    (reference: ``hybridq/gate/gate.py:368-497``)."""
    rname = resolve_name(name)
    if rname == 'MATRIX':
        U = kwargs.pop('U', None)
        if U is None:
            raise ValueError("'MATRIX' requires 'U'.")
        g = MatrixGate(U, qubits=qubits, n_qubits=n_qubits, power=power,
                       tags=tags, **kwargs)
    elif rname == 'TUPLE':
        g = TupleGate(kwargs.pop('gates', ()), tags=tags)
    elif rname == 'FUNCTIONAL':
        g = FunctionalGate(kwargs.pop('f'), qubits=qubits,
                           n_qubits=n_qubits, tags=tags)
    elif rname == 'STOCHASTIC':
        g = StochasticGate(kwargs.pop('gates'), kwargs.pop('p'), tags=tags)
    elif rname == 'SCHMIDT':
        g = SchmidtGate(kwargs.pop('gates'), kwargs.pop('s'), tags=tags,
                        **kwargs)
    elif rname == 'PROJECTION':
        g = ProjectionGate(kwargs.pop('state'), qubits=qubits, tags=tags)
    elif rname == 'MEASURE':
        g = MeasureGate(qubits=qubits, n_qubits=n_qubits, tags=tags)
    else:
        g = NamedGate(rname, qubits=qubits, n_qubits=n_qubits, params=params,
                      power=power, tags=tags)
    if kwargs:
        raise ValueError(f"Unexpected arguments: {tuple(kwargs)}")
    return g


def Projection(state, qubits=None, tags=None) -> ProjectionGate:
    return ProjectionGate(state, qubits=qubits, tags=tags)


def Measure(qubits=None, n_qubits=None, tags=None) -> MeasureGate:
    return MeasureGate(qubits=qubits, n_qubits=n_qubits, tags=tags)


class ControlledFunctionalGate(FunctionalGate):
    """Controlled FunctionalGate / StochasticGate.

    The controlled action decomposes on the projector onto the all-ones
    control subspace P: ``psi -> (psi - P psi) + G(P psi)`` for a
    functional gate G, and ``psi -> psi + (U - I)(P psi)`` for a sampled
    stochastic matrix U (reference ``hybridq/gate/gate.py:962-1031``).
    """

    name = 'CONTROL'

    def __init__(self, c_qubits, gate, tags=None):
        c_qubits = tuple(c_qubits)
        if gate.qubits is None:
            raise ValueError("'gate' must have qubits.")
        if set(c_qubits) & set(gate.qubits):
            raise ValueError(
                "Control qubits must differ from gate qubits.")
        super().__init__(f=self._apply_controlled,
                         qubits=c_qubits + tuple(gate.qubits), tags=tags)
        self._c_qubits = c_qubits
        self._gate = gate

    @property
    def c_qubits(self):
        return self._c_qubits

    @property
    def gate(self):
        return self._gate

    @staticmethod
    def _apply_controlled(self, psi, order, **kwargs):
        order = tuple(order)
        split = psi.ndim > len(order)
        if split:
            full = psi[0] + 1j * psi[1]
        else:
            full = psi
        pg = ProjectionGate('1' * len(self._c_qubits),
                            qubits=self._c_qubits)
        proj, _ = pg.apply(full, order, renormalize=False)
        inner = self._gate
        if isinstance(inner, StochasticGate):
            g = inner.sample()
            U = np.asarray(g.matrix(), dtype=complex) - \
                np.eye(2**g.n_qubits)
            axes = tuple(order.index(q) for q in g.qubits)
            k = len(axes)
            d = np.moveaxis(proj, axes, range(k))
            d = (U @ d.reshape(2**k, -1)).reshape((2,) * len(order))
            d = np.moveaxis(d, range(k), axes)
            out = full + d
        else:
            rest = full - proj
            new, new_order = inner.apply(proj, order, **kwargs)
            if tuple(new_order) != order:
                raise NotImplementedError("'order' has changed.")
            out = rest + new
        if split:
            res = np.zeros_like(psi)
            res[0], res[1] = out.real, out.imag
            return res, order
        return out, order

    def _eq_state(self):
        return BaseGate._eq_state(self) + (self._c_qubits, self._gate)


def Control(c_qubits, gate: BaseGate = None, power=1, tags=None,
            **kwargs):
    """Controlled version of ``gate``
    (reference: ``hybridq/gate/gate.py:923-1059``): matrix gates get a
    block-diagonal ``ControlledGate``; FunctionalGates and
    StochasticGates get a projector-decomposed functional wrapper."""
    if gate is None:
        gate = Gate(**kwargs)
    if gate.provides('matrix'):
        return ControlledGate(c_qubits, gate, power=power, tags=tags)
    if isinstance(gate, (FunctionalGate, StochasticGate)):
        if power != 1:
            raise NotImplementedError(
                "power != 1 is not supported for controlled "
                "functional/stochastic gates.")
        return ControlledFunctionalGate(c_qubits, gate, tags=tags)
    raise NotImplementedError(
        f"Cannot control gate '{gate.name}'.")
