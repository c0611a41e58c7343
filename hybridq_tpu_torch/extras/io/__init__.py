"""Circuit IO: QASM dialect and cirq export."""

from hybridq_tpu_torch.extras.io import qasm
from hybridq_tpu_torch.extras.io.cirq_io import to_cirq

__all__ = ['qasm', 'to_cirq']
