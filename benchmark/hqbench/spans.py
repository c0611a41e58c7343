"""The program's own spans in a traced sub-window, as the readers take
them.

While a profiler records, ``hybridq_tpu_torch`` opens a span for each
part of a ``simulate`` call (``_device.span``): ``hq.<part>``, then
`` key=value`` for each number the part carries, as in ``hq.apply_bits
k=4 lo=3 n=32``.  ``Timeline.from_chrome`` keeps them in
``Timeline.host``.  A program without them gives no ``hq.simulate``, and
every reader of them then returns None.
"""

from __future__ import annotations

from hqbench.timeline import union
from hqbench.yardstick import peaks, state_bytes

__all__ = ['parse', 'named', 'calls', 'mean_ms', 'apply_roofline']

PREFIX = 'hq.'
# the kernels behind fused_kernels.apply_bits (csrc/fused_apply.cu)
APPLY_KERNELS = ('column_apply_kernel', 'group_apply_kernel')


def parse(name: str):
    """``(base, {key: int value})`` of a span's name."""
    base, *pairs = name.split()
    return base, {k: int(v) for k, v in (p.split('=') for p in pairs)}


def named(t, base: str, lo=None, hi=None):
    """``[(start, end, meta), ...]`` of the program's spans called
    ``base`` (that start inside ``[lo, hi]`` when given), in order."""
    out = []
    for a, b, name in t.host:
        if not name.startswith(PREFIX) or (lo is not None and
                                           not lo <= a <= hi):
            continue
        got, meta = parse(name)
        if got == base:
            out.append((a, b, meta))
    return out


def calls(record, unit: str):
    """``(timeline, [(start, end) of each traced hq.simulate])``, or None
    where the cell counts its work in another unit than ``unit`` or the
    trace holds no such span."""
    t = record.timeline
    if t is None or record.unit != unit:
        return None
    spans = [(a, b) for a, b, _ in named(t, 'hq.simulate')]
    return (t, spans) if spans else None


def mean_ms(record, bases) -> float | None:
    """Milliseconds of the union of the spans called any of ``bases``
    inside each traced state-vector call, the mean over the calls; None
    where no call has such a span."""
    got = calls(record, 'gates')
    if got is None:
        return None
    t, spans = got
    parts = [[(a, b) for base in bases for a, b, _ in named(t, base, lo, hi)]
             for lo, hi in spans]
    if not any(parts):
        return None
    return sum(union(p) for p in parts) / 1e3 / len(parts)


def apply_roofline(record, k: int) -> float | None:
    """Percent of the bytes roofline of the traced calls' ``apply_bits``
    launches of ``k`` qubits: each reads and writes the state once, at the
    card's published memory rate, over their device time.  In each call
    the ``hq.apply_bits`` spans (host order) and the kernels of
    ``APPLY_KERNELS`` (device order, one stream) pair one to one; None
    where their counts differ in any call, or no launch has ``k``."""
    got = calls(record, 'gates')
    if got is None:
        return None
    t, spans = got
    least_bytes = device_us = 0
    for lo, hi in spans:
        launches = named(t, 'hq.apply_bits', lo, hi)
        kernels = [(a, b) for a, b, _, name in t.device_in(lo, hi)
                   if any(x in name for x in APPLY_KERNELS)]
        if len(launches) != len(kernels):
            return None
        for (_, _, meta), (a, b) in zip(launches, kernels):
            if meta.get('k') == k:
                least_bytes += 2 * state_bytes(meta['n'])
                device_us += b - a
    if not device_us:
        return None
    least_s = least_bytes / peaks(record.device_name)[0]
    return 100.0 * least_s / (device_us / 1e6)
