"""Host milliseconds from the start of each traced ``simulate`` call to
its first device activity, the mean over the traced calls."""

from hqbench.readers import traced


def read(record):
    got = traced(record)
    if got is None:
        return None
    t, calls, _ = got
    ms = []
    for lo, hi in calls:
        dev = t.device_in(lo, hi)
        if dev:
            ms.append((dev[0][0] - lo) / 1e3)
    return sum(ms) / len(ms) if ms else None
