"""Arute et al.'s random circuits on the Sycamore layout, as plain data.

Nature 574:505 (2019), Fig. 4a: each cycle is a layer of one-qubit gates
drawn from {sqrt(X), sqrt(Y), sqrt(W)} on every qubit, then a layer of
fSim(pi/2, pi/6) couplers chosen by the pattern ABCDCDAB.  The layout is
the 53-qubit Sycamore drawing; coordinates are (x, y) with y growing
upward.  A circuit is a list of ``(name, qubits, params)`` with integer
qubits: qubit ``i`` is the ``i``-th qubit of the patch, which takes the
layout's qubits in their sorted (x, y) order (the order in which the
program sorts (x, y) labels, so qubit ``i`` is axis ``i`` of its state).

Nothing here imports the program: the benchmark hands these gates to the
program by name and builds their matrices itself in ``reference/``.
"""

from __future__ import annotations

import numpy as np

__all__ = ['DRAWING', 'layout', 'couplers', 'patch', 'layer_couplers',
           'rqc', 'ONE_QUBIT_GATES', 'FSIM_PARAMS']

DRAWING = r"""
      X-X
      | |
    X-X-X-X
    | | | |
  X-X-X-X-X-X
  | | | | | |
X-X-X-X-X-X-X-X
| | | | | | | |
X-X-X-X-X-X-X-X-X
  | | | | | | | |
  X-X-X-X-X-X-X-X-X
      | | | | | |
      X-X-X-X-X-X
      | | | | |
      X-X-X-X-X
        | | |
        X-X-X
          |
          X
"""

# (name, params) of the one-qubit set; sqrt(W) is the pi/2 rotation about
# (X + Y)/sqrt(2), the program's R_PI_2 at phi = pi/4.
ONE_QUBIT_GATES = (('SQRT_X', ()), ('SQRT_Y', ()),
                   ('R_PI_2', (np.pi / 4,)))
FSIM_PARAMS = (np.pi / 2, np.pi / 6)

# Arute et al.'s coupler layers, by the parity of the first qubit and the
# direction of the coupler (pairs sorted, so the first has the smaller x).
_LAYERS = {
    'A': lambda a, b: not (a[0] + a[1]) % 2 and a[1] == b[1],
    'B': lambda a, b: (a[0] + a[1]) % 2 and a[1] == b[1],
    'C': lambda a, b: (a[0] + a[1]) % 2 and a[0] == b[0],
    'D': lambda a, b: not (a[0] + a[1]) % 2 and a[0] == b[0],
}


def layout():
    """The 53 qubits of the drawing as sorted ``(x, y)``, y upward, the
    coordinates divided by 2 (a qubit every other character)."""
    lines = [line for line in DRAWING.split('\n') if line.strip()]
    top = len(lines) - 1
    return sorted((x // 2, (top - y) // 2) for y, line in enumerate(lines)
                  for x, ch in enumerate(line) if ch == 'X')


def couplers(qubits):
    """Nearest-neighbour pairs among ``qubits``, each sorted, sorted."""
    qs = set(qubits)
    return sorted({tuple(sorted((a, b))) for a in qs
                   for b in ((a[0] + 1, a[1]), (a[0], a[1] + 1)) if b in qs})


def patch(n: int):
    """The first ``n`` qubits of the layout in sorted (x, y) order."""
    return layout()[:n]


def layer_couplers(qubits, letter: str):
    """The couplers of layer ``letter`` (A-D) among ``qubits``."""
    return [c for c in couplers(qubits) if _LAYERS[letter](*c)]


def rqc(n: int, cycles: int, seed, pattern: str = 'ABCDCDAB'):
    """One random circuit on the ``n``-qubit patch: ``cycles`` cycles of
    one-qubit gates (uniform over ``ONE_QUBIT_GATES``, drawn qubit by
    qubit in patch order from ``numpy.random.default_rng(seed)``) and fSim
    couplers.  Returns ``[(name, qubits, params), ...]``."""
    qubits = patch(n)
    index = {q: i for i, q in enumerate(qubits)}
    layers = {k: [(index[a], index[b]) for a, b in layer_couplers(qubits, k)]
              for k in set(pattern)}
    rng = np.random.default_rng(seed)
    gates = []
    for c in range(cycles):
        for q in range(n):
            name, params = ONE_QUBIT_GATES[int(rng.integers(3))]
            gates.append((name, (q,), params))
        for pair in layers[pattern[c % len(pattern)]]:
            gates.append(('FSIM', pair, FSIM_PARAMS))
    return gates
