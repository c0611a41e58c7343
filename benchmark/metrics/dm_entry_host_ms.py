"""Host milliseconds of a density-matrix call's work before and between
its launches: the union of its ``hq.dm.lower``, ``hq.preprocess``
(``simplify`` inside), ``hq.compress`` and ``hq.block_matrices`` spans in
each traced ``bench.simulate`` call, the mean over the traced calls; None
where no call has the lowering's span."""

from hqbench.spans import named
from hqbench.timeline import union

BASES = ('hq.dm.lower', 'hq.preprocess', 'hq.compress', 'hq.block_matrices')


def read(record):
    t = record.timeline
    if t is None or record.unit != 'gates':
        return None
    calls = t.named('bench.simulate')
    if not any(named(t, 'hq.dm.lower', lo, hi) for lo, hi in calls):
        return None
    ms = [union([(a, b) for base in BASES
                 for a, b, _ in named(t, base, lo, hi)]) / 1e3
          for lo, hi in calls]
    return sum(ms) / len(ms)
