"""Exchanges between shards a circuit (the program's ``sharded.counts()``
counter), over the window's circuits."""


def read(record):
    reqs = record.requests
    if not reqs or any('exchange' not in r for r in reqs):
        return None
    return sum(r['exchange'] for r in reqs) / len(reqs)
