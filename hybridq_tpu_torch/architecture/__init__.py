"""QPU architecture data: layouts and coupling layers."""

from hybridq_tpu_torch.architecture.utils import get_layout_from_drawing
from hybridq_tpu_torch.architecture import google, ibm, rigetti

__all__ = ['get_layout_from_drawing', 'google', 'ibm', 'rigetti']
