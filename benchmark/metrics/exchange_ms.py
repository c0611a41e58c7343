"""Milliseconds a traced circuit of the union of the copies between and
on the cards, over every card (``hqbench.exchange.copy_ms``): the
exchanges' time."""

from hqbench.exchange import copy_ms


def read(record):
    return copy_ms(record)
