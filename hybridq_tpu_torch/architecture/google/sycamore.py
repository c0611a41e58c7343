"""Google Sycamore (gmon54) layout and supremacy-paper gate layers.

Layout data and ABCD/EFGH layer predicates match the reference
(``hybridq/architecture/google/sycamore.py``), reproducing the
Nature 574, 505-510 (2019) coupler activation patterns.
"""

from __future__ import annotations

from hybridq_tpu_torch.architecture.utils import get_layout_from_drawing
from hybridq_tpu_torch.utils import sort

__all__ = ['drawing', 'layout', 'couplings', 'get_all_couplings',
           'get_layer', 'get_layers']

drawing = r"""
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

layout, couplings = get_layout_from_drawing(drawing)


def get_all_couplings(qpu_layout):
    """All nearest-neighbor couplings within ``qpu_layout``."""
    return sort({
        tuple(sort(((x1, y1), (x2, y2))))
        for x1, y1 in qpu_layout
        for x2, y2 in qpu_layout
        if (x1 == x2 and abs(y1 - y2) == 1) or
           (y1 == y2 and abs(x1 - x2) == 1)
    })


_LAYER_PREDICATES = {
    # supremacy layers
    'A': lambda q: (not (q[0][0] + q[0][1]) % 2) and q[0][1] == q[1][1],
    'B': lambda q: ((q[0][0] + q[0][1]) % 2) and q[0][1] == q[1][1],
    'C': lambda q: ((q[0][0] + q[0][1]) % 2) and q[0][0] == q[1][0],
    'D': lambda q: (not (q[0][0] + q[0][1]) % 2) and q[0][0] == q[1][0],
    # simplifiable layers
    'E': lambda q: (not q[0][1] % 2) and q[0][0] == q[1][0],
    'F': lambda q: (q[0][1] % 2) and q[0][0] == q[1][0],
    'G': lambda q: (not q[0][0] % 2) and q[0][1] == q[1][1],
    'H': lambda q: (q[0][0] % 2) and q[0][1] == q[1][1],
}


def get_layer(layer_idx: str, qpu_layout=None):
    """Couplings active in the given supremacy layer ('A'..'H')."""
    if not isinstance(layer_idx, str) or \
            layer_idx.upper() not in _LAYER_PREDICATES:
        raise ValueError("Valid 'layer_idx' values are 'A', 'B', 'C', "
                         "'D', 'E', 'F', 'G' and 'H'")
    qpu_layout = layout if qpu_layout is None else list(qpu_layout)
    all_couplings = get_all_couplings(qpu_layout)
    return list(filter(_LAYER_PREDICATES[layer_idx.upper()],
                       all_couplings))


def get_layers(qpu_layout=None):
    """Map layer name → couplings for all supremacy layers."""
    return {k: get_layer(k, qpu_layout) for k in _LAYER_PREDICATES}
