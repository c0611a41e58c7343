"""Percent of the traced sub-window of a density-matrix cell in which no
kernel or copy ran on the device (the union of device intervals)."""

from hqbench.readers import device_idle


def read(record):
    return device_idle(record) if record.unit == 'gates' else None
