"""Percent of the slices the traced calls asked for that the executor
contracted: the ``n`` of every ``hq.tn.chunk`` span inside the traced
``simulate`` calls over the slices of those calls.  100 while every
slice of a range is contracted; lower once the executor skips slices
that it knows to be zero."""

from hqbench.spans import calls, named


def read(record):
    got = calls(record, 'slices')
    if got is None:
        return None
    asked = sum(r['slices'] for r in record.requests if r['traced'])
    if not asked:
        return None
    t, spans = got
    done = sum(meta['n'] for lo, hi in spans
               for _, _, meta in named(t, 'hq.tn.chunk', lo, hi))
    return 100.0 * done / asked
