"""Percent of the traced sub-window of the sharded cell in which no card
ran anything: the union of every card's kernels and copies (the trace
keeps no card number)."""

from hqbench.readers import device_idle


def read(record):
    return device_idle(record) if record.unit == 'gates' else None
