"""Simulation engines: state-vector evolution on CUDA kernels (fused
engine) and on plain PyTorch (small registers, CPU)."""

from hybridq_tpu_torch.simulation.prepare import prepare_state
from hybridq_tpu_torch.simulation.simulation import (simulate,
                                                     expectation_value)

__all__ = ['prepare_state', 'simulate', 'expectation_value']
