"""Total ordering over heterogeneous qubit labels.

Qubit labels may be ints, strings, tuples, or any mix thereof (the reference
tests deliberately mix them; see ``hybridq/utils/utils.py:283-304``).  The
order defined here is load-bearing: everywhere in the framework, the sorted
qubit order *is* the state axis order.

Ordering rule (matches the reference semantics):
  1. try the native ``<``;
  2. if the native comparison fails and the types differ, order by the
     string representation of the type (so all ints sort before all strs
     before all tuples);
  3. same type but incomparable: order by ``repr``.
"""

from __future__ import annotations

import functools

__all__ = ['sort', 'argsort', 'sort_key']


@functools.total_ordering
class _Key:
    """Comparison wrapper implementing the heterogeneous ordering."""

    __slots__ = ('v',)

    def __init__(self, v):
        self.v = v

    def __repr__(self):
        return repr(self.v)

    def __hash__(self):
        return hash(self.v)

    def __eq__(self, other):
        other = other.v if isinstance(other, _Key) else other
        try:
            return bool(self.v == other)
        except Exception:
            return False

    def __lt__(self, other):
        other = other.v if isinstance(other, _Key) else other
        try:
            if self.v == other:
                return False
        except Exception:
            pass
        try:
            return bool(self.v < other)
        except TypeError:
            pass
        if type(self.v) is not type(other):
            return str(type(self.v)) < str(type(other))
        # Same type but not natively comparable (e.g. tuples mixing
        # ints/strs): recurse elementwise for sequences, else use repr.
        if isinstance(self.v, (tuple, list)) and isinstance(other,
                                                            (tuple, list)):
            for a, b in zip(self.v, other):
                if _Key(a) != _Key(b):
                    return _Key(a) < _Key(b)
            return len(self.v) < len(other)
        r1, r2 = repr(self.v), repr(other)
        if r1 != r2:
            return r1 < r2
        raise TypeError(f"'<' not supported between {self.v!r} and {other!r}")


def sort_key(x):
    """Key function implementing the heterogeneous order (for ``sorted``)."""
    return _Key(x)


def sort(iterable, *, key=None, reverse: bool = False) -> list:
    """Sort a heterogeneous iterable (ints/strs/tuples freely mixed)."""
    return sorted(iterable,
                  key=lambda x: _Key(x if key is None else key(x)),
                  reverse=reverse)


def argsort(iterable, *, key=None, reverse: bool = False) -> list:
    """Return indexes that sort a heterogeneous iterable."""
    pairs = ((y if key is None else key(y), i)
             for i, y in enumerate(iterable))
    return [
        i for _, i in sort(pairs, key=lambda p: p[0], reverse=reverse)
    ]
