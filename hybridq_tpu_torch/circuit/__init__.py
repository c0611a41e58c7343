"""Circuit IR and transformation toolbox."""

from hybridq_tpu_torch.circuit.circuit import BaseCircuit, Circuit
from hybridq_tpu_torch.circuit import utils

__all__ = ['BaseCircuit', 'Circuit', 'utils']
