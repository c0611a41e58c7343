"""Percent of the bytes roofline of the traced ``simulate`` calls: the
least time of their work (each launch reads and writes the state once,
the result's conversion reads the container and writes the state, at the
card's published memory rate) over the device time of every device
operation inside those calls."""

from hqbench.yardstick import evolution_bytes, peaks


def read(record):
    t = record.timeline
    if t is None or record.unit != 'gates':
        return None
    calls = t.named('bench.simulate')
    launches = sum(r['launches'] for r in record.requests if r['traced'])
    device_us = sum(b - a for lo, hi in calls
                    for a, b, _, _ in t.device_in(lo, hi))
    if not device_us or len(calls) != sum(r['traced']
                                          for r in record.requests):
        return None
    bw = peaks(record.device_name)[0]
    n = record.costs['n_qubits']
    least_s = evolution_bytes(n, launches, len(calls)) / bw
    return 100.0 * least_s / (device_us / 1e6)
