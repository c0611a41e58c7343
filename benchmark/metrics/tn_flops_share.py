"""Percent of the card's float32 peak: the plan's complex multiply-adds a
slice, 8 real operations each, over the device's busy time a slice in
the traced calls.  The work is counted from the plan's tree and sliced
indices, whatever kernels run."""

from hqbench.readers import traced
from hqbench.yardstick import peaks


def read(record):
    got = traced(record)
    if got is None or record.unit != 'slices':
        return None
    t, calls, _ = got
    slices = sum(r['slices'] for r in record.requests if r['traced'])
    busy_us = sum(t.busy_us(lo, hi) for lo, hi in calls)
    if not busy_us or not slices:
        return None
    flops = 8 * record.costs['macs_per_slice'] * slices
    return 100.0 * flops / peaks(record.device_name)[1] / (busy_us / 1e6)
