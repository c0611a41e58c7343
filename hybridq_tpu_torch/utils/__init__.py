"""Generic utilities: heterogeneous sorting, linear algebra helpers.

A copy of ``hybridq_tpu/utils`` (sorting and linear algebra, numpy and
scipy only); the XLA compile cache (``utils/cache.py``) is not carried
over.  The gate kernels live in ``hybridq_tpu_torch.simulation``.
"""

from hybridq_tpu_torch.utils.sorting import sort, argsort
from hybridq_tpu_torch.utils.linalg import svd, kron, isunitary

__all__ = [
    'sort', 'argsort', 'svd', 'kron', 'isunitary', 'isintegral', 'isnumber',
    'to_list'
]


def isintegral(x) -> bool:
    """Return True if ``x`` converts to ``int`` without loss."""
    try:
        return int(x) == x
    except (TypeError, ValueError):
        return False


def isnumber(x) -> bool:
    """Return True if ``x`` converts to ``float``."""
    try:
        float(x)
    except (TypeError, ValueError):
        return False
    return True


def to_list(x, value_type=lambda v: v, list_type=list):
    """Convert ``x`` to a list, mapping every element through ``value_type``."""
    return list_type(value_type(v) for v in x)
