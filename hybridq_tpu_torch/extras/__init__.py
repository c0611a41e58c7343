"""Extras: random circuits, OTOC workloads, IO, debug gates."""

from hybridq_tpu_torch.extras import random, otoc, io
from hybridq_tpu_torch.extras.gate import MessageGate

__all__ = ['random', 'otoc', 'io', 'MessageGate']
