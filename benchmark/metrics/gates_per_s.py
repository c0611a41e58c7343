"""Circuit gates, as generated, of every circuit the window completed, over
the window's seconds."""

from hqbench.readers import rate


def read(record):
    return rate(record, 'gates')
