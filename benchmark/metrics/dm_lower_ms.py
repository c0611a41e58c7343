"""Host milliseconds of the program's density-matrix lowering (the
``hq.dm.lower`` spans: the super-circuit, each gate doubled and each
channel's superoperator) in each traced call, the mean over the traced
calls.  ``dm.simulate`` lowers before it calls ``simulate``, so the calls
are the benchmark's ``bench.simulate`` spans; None where no call has the
span."""

from hqbench.spans import named


def read(record):
    t = record.timeline
    if t is None or record.unit != 'gates':
        return None
    ms = [sum(b - a for a, b, _ in named(t, 'hq.dm.lower', lo, hi)) / 1e3
          for lo, hi in t.named('bench.simulate')]
    return sum(ms) / len(ms) if any(ms) else None
