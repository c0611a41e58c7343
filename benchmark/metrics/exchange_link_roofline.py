"""Percent of the link roofline of the traced circuit's exchanges: the
bytes each card must send (half a shard an exchange, by the program's
counter) at the per-direction peak of the link between two cards
(``hqbench.exchange.LINK_PEAK``), over ``exchange_ms``."""

from hqbench.exchange import LINK_PEAK, copy_ms


def read(record):
    ms = copy_ms(record)
    reqs = [r for r in record.requests if r['traced']]
    half = record.costs.get('shard_bytes', 0) / 2
    if ms is None or not reqs or not half or \
            any('exchange' not in r for r in reqs):
        return None
    exchanges = sum(r['exchange'] for r in reqs) / len(reqs)
    return 100.0 * exchanges * half / LINK_PEAK / (ms / 1e3)
