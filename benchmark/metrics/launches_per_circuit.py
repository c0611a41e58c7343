"""Launches of the program's kernels (all its counters summed) a circuit,
over the window's circuits."""


def read(record):
    if record.unit != 'gates' or not record.requests:
        return None
    return sum(r['launches'] for r in record.requests) / len(record.requests)
