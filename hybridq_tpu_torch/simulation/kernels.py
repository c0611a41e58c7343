"""Gate composition helper for the pairing scheduler.

Holds only ``_compose_matrix_gates`` (a copy of
``hybridq_tpu/simulation/kernels.py``'s), which ``pair_fused_gates``
needs; the ``IndexedEvolver`` engine of that module is not ported yet.
"""

from __future__ import annotations

import numpy as np

__all__ = []


def _compose_matrix_gates(items):
    """Compose a list of (U, qs) into one fused (U, qs) block (applied
    left-to-right) via the circuit toolbox."""
    from hybridq_tpu_torch.circuit import Circuit
    from hybridq_tpu_torch.circuit import utils as cutils
    from hybridq_tpu_torch.gate import MatrixGate

    g = cutils.to_matrix_gate(
        Circuit(MatrixGate(np.asarray(U)).on(list(qs))
                for U, qs in items), complex_type='complex128')
    return np.asarray(g.matrix()), tuple(g.qubits)
