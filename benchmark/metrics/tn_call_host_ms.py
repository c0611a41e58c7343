"""Milliseconds from the start of each traced ``simulate`` call of a
tensor-network cell to the start of its first chunk of slices
(``hq.tn.chunk``): the plan, the contractor and its schedule, the leaf
upload and the slice-invariant subtrees.  The mean over the traced
calls."""

from hqbench.spans import calls, named


def read(record):
    got = calls(record, 'slices')
    if got is None:
        return None
    t, spans = got
    ms = []
    for lo, hi in spans:
        chunks = named(t, 'hq.tn.chunk', lo, hi)
        if chunks:
            ms.append((chunks[0][0] - lo) / 1e3)
    return sum(ms) / len(ms) if ms else None
