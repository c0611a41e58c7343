"""Simulation engines: state-vector evolution on CUDA kernels (the
straight engine, ``kernels.IndexedEvolver``, which serves
``'evolution'``, ``'evolution-indexed'`` and ``'evolution-fused'``) and
on plain PyTorch (small registers, complex128, ``torch.einsum``, CPU),
tensor-network contraction (``simulation.tn``), batched noise
trajectories (``trajectories``) and Clifford expansion (``clifford``);
the gate kernels' public functions beside the engines'."""

from hybridq_tpu_torch.simulation.prepare import prepare_state
from hybridq_tpu_torch.simulation.simulation import (simulate,
                                                     expectation_value)
from hybridq_tpu_torch.simulation.fused_kernels import apply_factored
from hybridq_tpu_torch.simulation.row_kernels import apply_gate_rows
from hybridq_tpu_torch.simulation import clifford

__all__ = ['prepare_state', 'simulate', 'expectation_value',
           'apply_factored', 'apply_gate_rows', 'clifford']
