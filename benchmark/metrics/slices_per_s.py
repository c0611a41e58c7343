"""Slices of every call the window completed, over the window's
seconds."""

from hqbench.readers import rate


def read(record):
    return rate(record, 'slices')
