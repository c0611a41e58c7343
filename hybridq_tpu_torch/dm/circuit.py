"""Density-matrix circuits: lists mixing gates and supergates.

Parity with ``hybridq/dm/circuit/circuit.py``: ``all_qubits`` returns the
(left, right) qubit lists.
"""

from __future__ import annotations

from hybridq_tpu_torch.circuit import BaseCircuit
from hybridq_tpu_torch.dm.gate import BaseSuperGate, TupleSuperGate
from hybridq_tpu_torch.gate import BaseGate, TupleGate
from hybridq_tpu_torch.utils import sort

__all__ = ['Circuit']


class Circuit(BaseCircuit):
    """A circuit over density matrices (gates and supergates)."""

    @staticmethod
    def _check_gate(gate):
        if isinstance(gate, (tuple, TupleGate)) and not isinstance(
                gate, (BaseGate, BaseSuperGate)):
            return TupleSuperGate(map(Circuit._check_gate, gate))
        if isinstance(gate, (BaseGate, BaseSuperGate)):
            return gate
        raise ValueError(f"'{type(gate).__name__}' not supported.")

    @property
    def all_qubits(self):
        """Sorted (left, right) qubit lists."""
        if not len(self):
            return ([], [])
        lq, rq = set(), set()
        for g in self:
            if isinstance(g, BaseGate):
                q = g.qubits
                if q is None:
                    raise ValueError(
                        "Circuit contains virtual gates with no qubits.")
                lq.update(q)
                rq.update(q)
            else:
                q = g.qubits
                if q is None:
                    raise ValueError(
                        "Circuit contains virtual gates with no qubits.")
                l, r = q
                lq.update(l)
                rq.update(r)
        return (sort(lq), sort(rq))

    @property
    def n_qubits(self):
        lq, rq = self.all_qubits
        return (len(lq), len(rq))
