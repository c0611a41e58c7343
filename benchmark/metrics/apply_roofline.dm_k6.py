"""Percent of the bytes roofline of the traced density-matrix calls'
``apply_bits`` launches of 6-qubit blocks, ``group_apply_kernel<6>``
(``hqbench.spans.apply_roofline``)."""

from hqbench.spans import apply_roofline


def read(record):
    return apply_roofline(record, 6)
