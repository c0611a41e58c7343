"""Percent of the bytes roofline of the traced calls' ``apply_bits``
launches of 5-qubit blocks (``hqbench.spans.apply_roofline``)."""

from hqbench.spans import apply_roofline


def read(record):
    return apply_roofline(record, 5)
