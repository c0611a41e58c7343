"""Sliced tensor-network contraction engine: host planning (network,
path search, slicing) and the contraction on a torch device."""

from hybridq_tpu_torch.simulation.tn.network import (Tensor, TensorNetwork,
                                                     circuit_to_tn,
                                                     build_tn)
from hybridq_tpu_torch.simulation.tn.path import (ContractionTree,
                                                  PathInfo, find_path)
from hybridq_tpu_torch.simulation.tn.slicer import find_slices, SliceCost
from hybridq_tpu_torch.simulation.tn.contract import (ContractionPlan,
                                                      SlicedContractor)
from hybridq_tpu_torch.simulation.tn.simulate import (simulate_tn,
                                                      make_plan)

__all__ = ['Tensor', 'TensorNetwork', 'circuit_to_tn', 'build_tn',
           'ContractionTree', 'PathInfo', 'find_path', 'find_slices',
           'SliceCost', 'ContractionPlan', 'SlicedContractor',
           'simulate_tn', 'make_plan']
