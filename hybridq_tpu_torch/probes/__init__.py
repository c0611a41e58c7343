"""Counterparts of the JAX package's Pallas probes (``scripts/probe_*``):
kernels that measure the card rather than serve the engine."""

from hybridq_tpu_torch.probes.fused_k4 import apply_fused_k4

__all__ = ['apply_fused_k4']
