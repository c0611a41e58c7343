"""The system under test: the calls into ``hybridq_tpu_torch``.

Everything the benchmark takes from the program goes through this module:
its entry (``simulate``), its plan loader and its launch counters.  The
program is imported inside the functions, so that the reference and the
readers can be imported without it.
"""

from __future__ import annotations

import numpy as np

__all__ = ['circuit', 'simulate_circuit', 'load_plan', 'simulate_slices',
           'launches']


def circuit(gates):
    """The program's ``Circuit`` of ``[(name, qubits, params), ...]``."""
    from hybridq_tpu_torch import Circuit, Gate

    return Circuit(Gate(name, qubits=list(qubits), params=list(params))
                   if params else Gate(name, qubits=list(qubits))
                   for name, qubits, params in gates)


def simulate_circuit(gates, n: int, options: dict, device):
    """``simulate`` of the evolution engine from ``|0...0>``: the flat
    state as a tensor on ``device``.  ``options`` are the traffic's
    keyword arguments of ``simulate``."""
    from hybridq_tpu_torch.simulation import simulate

    psi = simulate(circuit(gates), initial_state='0' * n, device=device,
                   **options)
    return psi.reshape(-1)


def load_plan(path):
    """``(net, (PathInfo, ContractionPlan))`` of a plan file, as the
    program reads it."""
    from hybridq_tpu_torch.convert import load_reference_plan
    from hybridq_tpu_torch.simulation.tn.contract import ContractionPlan
    from hybridq_tpu_torch.simulation.tn.path import PathInfo

    net, _, tree, sliced, _ = load_reference_plan(path)
    return net, (PathInfo(tree), ContractionPlan(tree, sliced))


def simulate_slices(net, optimize, start: int, stop: int, options: dict,
                    device) -> np.ndarray:
    """``simulate`` of the TN engine over the slices ``[start, stop)``:
    their partial sum."""
    from hybridq_tpu_torch.simulation import simulate

    return simulate(net, optimize=optimize, slice_range=(start, stop),
                    device=device, **options)


def launches() -> int:
    """Launches and plain calls of the program's kernels so far, all
    counters summed."""
    from hybridq_tpu_torch.simulation import fused_kernels
    from hybridq_tpu_torch.simulation.tn import tn_kernels

    return sum(fused_kernels.counts().values()) + \
        sum(tn_kernels.counts().values())
