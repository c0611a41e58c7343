"""Counterparts of the JAX package's Pallas probes (``scripts/probe_*``):
kernels that measure the card rather than serve the engine.

  * ``fused_k4``: ``apply_fused_k4``, a 4-qubit gate kernel
    (``scripts/probe_fused_k4.py``);
  * ``bw``: streaming bandwidth and the TF32 / 3xTF32 dot
    (``scripts/probe_pallas_bw.py``), ``python -m hybridq_tpu_torch.probes.bw``;
  * ``gather``: bandwidth of gathered runs by run length
    (``scripts/probe_pallas_gather.py``),
    ``python -m hybridq_tpu_torch.probes.gather``.
"""

from hybridq_tpu_torch.probes.fused_k4 import apply_fused_k4

__all__ = ['apply_fused_k4']
