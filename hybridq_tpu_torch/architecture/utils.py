"""QPU layout parsing: ASCII drawing → (qubits, couplings).

Parity with ``hybridq/architecture/utils.py:41-152``: 'X' marks a qubit;
'-', '|', '/', '\\' mark couplings between the adjacent qubits.  Returned
coordinates are (x, y) with y increasing upward, rescaled by the GCD of
all coordinates.
"""

from __future__ import annotations

from math import gcd

__all__ = ['get_layout_from_drawing']

_COUPLERS = {
    '-': lambda x, y: ((x - 1, y), (x + 1, y)),
    '|': lambda x, y: ((x, y - 1), (x, y + 1)),
    '\\': lambda x, y: ((x - 1, y - 1), (x + 1, y + 1)),
    '/': lambda x, y: ((x + 1, y - 1), (x - 1, y + 1)),
}


def get_layout_from_drawing(drawing: str):
    """Parse an ASCII QPU drawing into sorted (qubits, couplings)."""
    if not isinstance(drawing, str):
        raise ValueError("'drawing' must be a valid string")

    lines = [l for l in drawing.upper().split('\n') if l.strip()]
    indent = min(len(l) - len(l.lstrip(' ')) for l in lines)
    lines = [l[indent:] for l in lines]

    if any(set(l) - set(r'X-|/\ ') for l in lines):
        raise ValueError("'drawing' must be a valid layout")

    qubits = sorted((x, y) for y, l in enumerate(lines)
                    for x, c in enumerate(l) if c == 'X')
    qubit_set = set(qubits)

    couplings = []
    for y, l in enumerate(lines):
        for x, c in enumerate(l):
            if c in _COUPLERS:
                pair = _COUPLERS[c](x, y)
                if any(q not in qubit_set for q in pair):
                    raise ValueError("'drawing' has not valid couplings")
                couplings.append(pair)
    couplings.sort()

    # Rescale by the common coordinate divisor.
    g = 0
    for q in qubits:
        for v in q:
            g = gcd(g, v)
    if g > 1:
        qubits = [(x // g, y // g) for x, y in qubits]
        couplings = [((x1 // g, y1 // g), (x2 // g, y2 // g))
                     for (x1, y1), (x2, y2) in couplings]

    # Flip y so it increases upward.
    ymax = max(y for _, y in qubits)
    qubits = sorted((x, ymax - y) for x, y in qubits)
    couplings = sorted(
        tuple(sorted(((x1, ymax - y1), (x2, ymax - y2))))
        for (x1, y1), (x2, y2) in couplings)
    return qubits, couplings
