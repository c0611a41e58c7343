"""Extras: random circuit generators."""

from hybridq_tpu_torch.extras import random

__all__ = ['random']
