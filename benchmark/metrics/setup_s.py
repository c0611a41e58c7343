"""Seconds from the start of the process to the window's first request:
imports, the card's context, the kernels' build or load, the inputs and
the warm-up request."""


def read(record):
    return record.setup_s
