"""Circuit IR: a circuit is a list of gates.

Parity with the reference ``hybridq/circuit/circuit.py:22-509``: list
behavior (+, slicing, append/extend), tag operations, sorted ``all_qubits``
via the heterogeneous qubit order, and inv/conj/T/adj circuit transforms.
Moments are computed on demand by ``hybridq_tpu_torch.circuit.utils.moments``.
"""

from __future__ import annotations

import copy

from hybridq_tpu_torch.gate import BaseGate
from hybridq_tpu_torch.utils import sort

__all__ = ['BaseCircuit', 'Circuit']


class BaseCircuit(list):
    """A list of gates."""

    @staticmethod
    def _check_gate(gate):
        if not isinstance(gate, BaseGate):
            raise ValueError(f"'{type(gate).__name__}' is not a gate.")
        return gate

    def __init__(self, gates=()):
        super().__init__(self._check_gate(g) for g in gates)

    # -- list protocol with type checks ---------------------------------
    def append(self, gate):
        super().append(self._check_gate(gate))

    def extend(self, gates):
        super().extend(self._check_gate(g) for g in gates)

    def insert(self, i, gate):
        super().insert(i, self._check_gate(gate))

    def __add__(self, other):
        return type(self)(list(self) + list(other))

    def __radd__(self, other):
        return type(self)(list(other) + list(self))

    def __iadd__(self, other):
        self.extend(other)
        return self

    def __getitem__(self, key):
        out = super().__getitem__(key)
        return type(self)(out) if isinstance(key, slice) else out

    def __mul__(self, n):
        return type(self)(list(self) * n)

    __rmul__ = __mul__

    def copy(self):
        return copy.deepcopy(self)

    def __eq__(self, other):
        return isinstance(other, list) and len(self) == len(other) and all(
            a == b for a, b in zip(self, other))

    def __ne__(self, other):
        return not self == other

    __hash__ = None

    def __repr__(self):
        if not self:
            return f'{type(self).__name__}([])'
        body = '\n'.join(f'  {g!r},' for g in self)
        return f'{type(self).__name__}([\n{body}\n])'

    # -- tags ------------------------------------------------------------
    @property
    def all_tags(self) -> list:
        """All distinct tag dictionaries' keys appearing in the circuit."""
        keys = []
        for g in self:
            for k in getattr(g, 'tags', {}):
                if k not in keys:
                    keys.append(k)
        return keys

    def set_tags(self, tags: dict, *, inplace: bool = False):
        c = self if inplace else self.copy()
        for i, g in enumerate(c):
            c[i] = g.set_tags(tags)
        return c

    def update_tags(self, tags: dict, *, inplace: bool = False):
        c = self if inplace else self.copy()
        for i, g in enumerate(c):
            c[i] = g.update_tags(tags)
        return c

    def remove_tags(self, keys, *, inplace: bool = False):
        c = self if inplace else self.copy()
        for i, g in enumerate(c):
            c[i] = g.remove_tags(keys)
        return c


class Circuit(BaseCircuit):
    """A quantum circuit over arbitrarily labeled qubits."""

    @property
    def all_qubits(self) -> list:
        """Sorted list of all qubits appearing in the circuit (the sorted
        qubit order is the state axis order everywhere downstream)."""
        qubits = set()
        for g in self:
            q = g.qubits
            if q is None:
                raise ValueError(
                    f"Gate {g!r} has no qubits assigned.")
            qubits.update(q)
        return sort(qubits)

    @property
    def n_qubits(self) -> int:
        return len(self.all_qubits)

    # -- circuit-level transforms ---------------------------------------
    def inv(self, *, inplace: bool = False) -> 'Circuit':
        """Inverse circuit: reversed order, every gate inverted."""
        gates = [g.inv() for g in reversed(self)]
        if inplace:
            self[:] = gates
            return self
        return type(self)(gates)

    def conj(self, *, inplace: bool = False) -> 'Circuit':
        """Complex conjugate of every gate."""
        gates = [g.conj() for g in self]
        if inplace:
            self[:] = gates
            return self
        return type(self)(gates)

    def T(self, *, inplace: bool = False) -> 'Circuit':
        """Transpose: reversed order, every gate transposed."""
        gates = [g.T() for g in reversed(self)]
        if inplace:
            self[:] = gates
            return self
        return type(self)(gates)

    def adj(self, *, inplace: bool = False) -> 'Circuit':
        """Adjoint: reversed order, every gate conjugate-transposed."""
        gates = [g.adj() for g in reversed(self)]
        if inplace:
            self[:] = gates
            return self
        return type(self)(gates)
