"""What several metric readers share."""

from __future__ import annotations

__all__ = ['rate', 'traced', 'device_idle']


def rate(record, unit: str):
    """Work in ``unit`` completed over the window's seconds, or None where
    the cell's requests are counted in another unit."""
    if record.unit != unit:
        return None
    return sum(r[unit] for r in record.requests) / record.window_s


def traced(record):
    """``(timeline, [(start, end) of each traced call], window)``, or None
    where the trace holds no device activity."""
    t = record.timeline
    if t is None or not t.device or t.window() is None:
        return None
    return t, t.named('bench.simulate'), t.window()


def device_idle(record):
    """Percent of the traced sub-window in which the device ran
    nothing."""
    got = traced(record)
    if got is None:
        return None
    t, _, (lo, hi) = got
    return 100.0 * (1.0 - t.busy_us(lo, hi) / (hi - lo))
