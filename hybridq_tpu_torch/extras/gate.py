"""Debug gates: MessageGate prints a message mid-simulation
(parity with ``hybridq/extras/gate/gate.py``)."""

from __future__ import annotations

import sys

from hybridq_tpu_torch.gate import FunctionalGate

__all__ = ['MessageGate']


class MessageGate(FunctionalGate):
    """A FunctionalGate that prints a message when applied and leaves the
    state untouched — a debugging hook into the evolution hot loop."""

    name = 'MESSAGE'

    def __init__(self, message: str = '', qubits=None, n_qubits=None,
                 tags=None, file=None):
        self._message = str(message)
        self._file = file
        super().__init__(f=type(self)._apply, qubits=qubits,
                         n_qubits=n_qubits, tags=tags)

    @property
    def message(self) -> str:
        return self._message

    def _apply(self, psi, order, **kwargs):
        print(self._message, file=self._file or sys.stderr)
        return psi, tuple(order)
