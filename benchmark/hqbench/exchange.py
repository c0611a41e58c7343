"""What the sharded cell's readers of the exchange share.

The program's exchange between two cards of one process moves each
piece of a half as one contiguous copy (``parallel/mesh.py``), which the
profiler records as a memcpy event: ``Memcpy PtoP`` between cards,
``Memcpy DtoD`` for the staging copy on one card.

``LINK_PEAK``: the per-direction peak of the link between two cards of
the machine the cell runs on.  There ``nvidia-smi nvlink --status``
reads 18 links of 26.562 GB/s on a card and ``nvidia-smi topo -p2p n``
peer access between every two of its four H100 SXM cards
(``nvidia-smi topo -m`` does not run there): NVLink 4, 18 links of
25 GB/s of data a direction each, 450 GB/s (NVIDIA's H100 data sheet:
900 GB/s of NVLink bandwidth, both directions together).  The copies of
an exchange reach about 397 GB/s a direction, six times a PCIe Gen5
x16 link's 64 GB/s.
"""

from __future__ import annotations

from hqbench.readers import traced
from hqbench.timeline import union

__all__ = ['LINK_PEAK', 'COPIES', 'copy_ms']

LINK_PEAK = 450e9                  # bytes/s, one direction of one pair
COPIES = ('Memcpy PtoP', 'Memcpy DtoD')


def copy_ms(record):
    """Milliseconds a traced circuit of the union of the copies between
    and on the cards (``COPIES``) that start inside its ``bench.simulate``
    span, over every card; None without a trace, without such a span for
    each traced request, or without any such copy.  Inside that span the
    exchanges make all of them: each card fills its own shard from the
    host (``Memcpy HtoD`` and a kernel), and the amplitudes are read
    after the span."""
    got = traced(record)
    if got is None:
        return None
    t, calls, _ = got
    if not calls or len(calls) != sum(r['traced'] for r in record.requests):
        return None
    total = sum(union([(a, b) for a, b, cat, name in t.device_in(lo, hi)
                       if cat == 'gpu_memcpy' and name.startswith(COPIES)])
                for lo, hi in calls)
    return total / 1e3 / len(calls) if total else None
