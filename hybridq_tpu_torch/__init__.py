"""hybridq_tpu_torch — the PyTorch/CUDA port of ``hybridq_tpu``.

The gate and circuit IR are copies of the JAX package's; the state-vector
engine runs on an NVIDIA GPU through hand-written CUDA kernels
(``hybridq_tpu_torch/csrc``), with plain PyTorch versions of the same
kernels for tensors on the CPU.  This package imports neither ``jax``
nor ``hybridq_tpu``.

Engines:
  * state-vector evolution  — `hybridq_tpu_torch.simulation.simulate`
    (complex64 on the straight engine, one `apply_bits` launch a
    block, for every `'evolution'` name; complex128 on plain PyTorch)
  * density matrices        — `hybridq_tpu_torch.dm.simulate`, with the
    noise channels of `hybridq_tpu_torch.noise`
  * tensor networks         — `simulate(..., optimize='tn')`: host path
    search and slicing (`simulation.tn`, the C++ of
    `hybridq_tpu_torch.native`), contraction on the card
  * noise trajectories      — `simulation.trajectories`, a batch of
    samples on `apply_bits`
  * Clifford expansion      — `simulation.clifford`, the branch frontier
    on the card
  * command lines           — `hybridq_tpu_torch.cli` (`main`, `main_dm`)

Kernels off the engine's path: `simulation.apply_factored`,
`simulation.apply_gate_rows`, `fused_kernels.apply_fused` and
`apply_swap` (the TPU engine's in-place kernels, ported alone) and the
probe `probes.apply_fused_k4`.
"""

__version__ = '0.1.0'

from hybridq_tpu_torch.gate import Gate, Projection, Measure, Control
from hybridq_tpu_torch.circuit import Circuit

__all__ = ['Gate', 'Projection', 'Measure', 'Control', 'Circuit',
           '__version__']
