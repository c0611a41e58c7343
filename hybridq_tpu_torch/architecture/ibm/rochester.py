"""IBM Rochester (53-qubit) layout
(data parity with ``hybridq/architecture/ibm/rochester.py``)."""

from hybridq_tpu_torch.architecture.utils import get_layout_from_drawing

__all__ = ['drawing', 'layout', 'couplings']

drawing = r"""
    X-X-X-X-X
    |       |
    X       X
    |       |
X-X-X-X-X-X-X-X-X
|       |       |
X       X       X
|       |       |
X-X-X-X-X-X-X-X-X
    |       |
    X       X
    |       |
X-X-X-X-X-X-X-X-X
|       |       |
X       X       X
|       |       |
X-X-X-X-X-X-X-X-X
    |       |
    X       X
"""

layout, couplings = get_layout_from_drawing(drawing)
