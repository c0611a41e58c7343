"""Device milliseconds a slice, in the traced calls, of every device
operation but the kernels of ``tn_apply`` (``tn_column_kernel`` and
``tn_tile_kernel``): the products and copies of the large-by-large
steps, leaf uploads and the rest."""

from hqbench.readers import traced

TN_APPLY = ('tn_column_kernel', 'tn_tile_kernel')


def read(record):
    got = traced(record)
    if got is None or record.unit != 'slices':
        return None
    t, calls, _ = got
    slices = sum(r['slices'] for r in record.requests if r['traced'])
    us = sum(b - a for lo, hi in calls for a, b, _, name in t.device_in(lo, hi)
             if not any(k in name for k in TN_APPLY))
    return us / 1e3 / slices if slices else None
