"""The profiler's timeline of a traced sub-window, reduced to what the
readers need.

``Timeline.from_chrome(events)`` takes the ``traceEvents`` of a Chrome
trace that ``torch.profiler`` exported: complete events (``ph == 'X'``)
with ``ts`` and ``dur`` in microseconds on one clock for host and device.
Device activity is the events of category ``kernel``, ``gpu_memcpy`` and
``gpu_memset``; the benchmark's spans are ``user_annotation`` events whose
names start with ``bench.``; host operators are ``cpu_op`` events.
"""

from __future__ import annotations

from bisect import bisect_right
from dataclasses import dataclass, field

__all__ = ['Timeline', 'union', 'clip', 'DEVICE_CATS']

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')


def union(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total, end = total + b - a, b
        elif b > end:
            total, end = total + b - end, b
    return total


def clip(intervals, lo: float, hi: float):
    """The parts of ``intervals`` inside ``[lo, hi]``."""
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if b > lo and a < hi]


@dataclass
class Timeline:
    device: list = field(default_factory=list)   # (start, end, cat, name)
    spans: list = field(default_factory=list)    # (start, end, name)
    host: list = field(default_factory=list)     # (start, end, name)

    @classmethod
    def from_chrome(cls, events) -> 'Timeline':
        t = cls()
        for e in events:
            if e.get('ph') != 'X' or 'dur' not in e:
                continue
            a = float(e['ts'])
            b = a + float(e['dur'])
            cat, name = e.get('cat'), str(e.get('name', ''))
            if cat in DEVICE_CATS:
                t.device.append((a, b, cat, name))
            elif cat == 'user_annotation' and name.startswith('bench.'):
                t.spans.append((a, b, name))
            elif cat in ('cpu_op', 'user_annotation'):
                t.host.append((a, b, name))
        t.device.sort()
        t.spans.sort()
        t.host.sort()
        return t

    def named(self, name: str):
        """The benchmark's spans called ``name``, in order."""
        return [(a, b) for a, b, n in self.spans if n == name]

    def window(self):
        """``(start, end)`` of the traced requests (``bench.request``
        spans), or None."""
        req = self.named('bench.request')
        if not req:
            return None
        return req[0][0], max(b for _, b in req)

    def device_in(self, lo: float, hi: float):
        """Device events that start inside ``[lo, hi]``."""
        return [d for d in self.device if lo <= d[0] <= hi]

    def busy_us(self, lo: float, hi: float) -> float:
        """Microseconds of ``[lo, hi]`` in which the device ran
        something."""
        return union(clip([(a, b) for a, b, _, _ in self.device], lo, hi))

    def top_device(self, lo: float, hi: float, count: int = 10):
        """``[[name, seconds], ...]``: device time by operation name."""
        by = {}
        for a, b, _, name in self.device_in(lo, hi):
            by[name] = by.get(name, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:count]]

    def idle_gaps(self, lo: float, hi: float, count: int = 10):
        """``[[host operation, seconds], ...]``: the ``count`` longest
        spells inside ``[lo, hi]`` in which the device ran nothing, each
        named by the innermost host operator or span that covers its
        middle."""
        busy = sorted(clip([(a, b) for a, b, _, _ in self.device], lo, hi))
        gaps, t = [], lo
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if hi > t:
            gaps.append((t, hi))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:count]
        # by start, the longer first: the innermost of equal starts last
        labelled = sorted(self.host + self.spans,
                          key=lambda h: (h[0], h[0] - h[1]))
        starts = [a for a, _, _ in labelled]
        out = []
        for a, b in gaps:
            mid, name = (a + b) / 2, 'no host operation'
            # the latest-starting operation that still covers the middle
            for ha, hb, n in reversed(labelled[:bisect_right(starts, mid)]):
                if hb >= mid:
                    name = n
                    break
            out.append([name, (b - a) / 1e6])
        return out
