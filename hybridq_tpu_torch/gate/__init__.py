"""Gate layer: gate zoo, algebra, and composition utilities."""

from hybridq_tpu_torch.gate.gate import (BaseGate, PowerMatrixGate,
                                         NamedGate, MatrixGate, TupleGate,
                                         FunctionalGate, StochasticGate,
                                         SchmidtGate, ControlledGate,
                                         ProjectionGate, MeasureGate, Gate,
                                         Projection, Measure, Control)
from hybridq_tpu_torch.gate.utils import (get_available_gates,
                                          get_clifford_gates, merge, pad,
                                          decompose, is_clifford)
from hybridq_tpu_torch.gate.zoo import GATES, ALIASES

__all__ = [
    'BaseGate', 'PowerMatrixGate', 'NamedGate', 'MatrixGate', 'TupleGate',
    'FunctionalGate', 'StochasticGate', 'SchmidtGate', 'ControlledGate',
    'ProjectionGate', 'MeasureGate', 'Gate', 'Projection', 'Measure',
    'Control', 'get_available_gates', 'get_clifford_gates', 'merge', 'pad',
    'decompose', 'is_clifford', 'GATES', 'ALIASES'
]
