"""Density-matrix layer: supergates, super-circuits, and the
doubled-qubit evolution engine (copies of ``hybridq_tpu/dm``; the
simulation calls the port's ``simulate``)."""

from hybridq_tpu_torch.dm.gate import (BaseSuperGate, MatrixSuperGate,
                                 KrausSuperGate, TupleSuperGate, Gate)
from hybridq_tpu_torch.dm.circuit import Circuit
from hybridq_tpu_torch.dm.simulation import counts, reset_counts, simulate

__all__ = ['BaseSuperGate', 'MatrixSuperGate', 'KrausSuperGate',
           'TupleSuperGate', 'Gate', 'Circuit', 'simulate', 'counts',
           'reset_counts']
