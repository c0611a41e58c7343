"""Cirq export: a copy of ``hybridq_tpu/extras/io/cirq_io.py`` (parity
with ``hybridq/extras/io/cirq.py``).

Gated on cirq availability: where cirq is not installed, ``to_cirq``
raises a clear ImportError; the conversion logic is exercised wherever
cirq exists.
"""

from __future__ import annotations

import numpy as np

from hybridq_tpu_torch.circuit import Circuit

__all__ = ['to_cirq']

# HybridQ gate name -> cirq constructor (built lazily).
_SIMPLE = {
    'I': lambda cirq, g: cirq.I,
    'H': lambda cirq, g: cirq.H,
    'X': lambda cirq, g: cirq.X,
    'Y': lambda cirq, g: cirq.Y,
    'Z': lambda cirq, g: cirq.Z,
    'CZ': lambda cirq, g: cirq.CZ,
    'CX': lambda cirq, g: cirq.CNOT,
    'SWAP': lambda cirq, g: cirq.SWAP,
    'ISWAP': lambda cirq, g: cirq.ISWAP,
    'T': lambda cirq, g: cirq.T,
    'P': lambda cirq, g: cirq.S,
    'SQRT_X': lambda cirq, g: cirq.X**0.5,
    'SQRT_Y': lambda cirq, g: cirq.Y**0.5,
    'RX': lambda cirq, g: cirq.rx(g.params[0]),
    'RY': lambda cirq, g: cirq.ry(g.params[0]),
    'RZ': lambda cirq, g: cirq.rz(g.params[0]),
    'CPHASE': lambda cirq, g: cirq.CZPowGate(
        exponent=g.params[0] / np.pi),
    'FSIM': lambda cirq, g: cirq.FSimGate(g.params[0], g.params[1]),
    'SQRT_SWAP': lambda cirq, g: cirq.SWAP**0.5,
    'SQRT_ISWAP': lambda cirq, g: cirq.ISWAP**0.5,
    'ZZ': lambda cirq, g: cirq.ZZ,
}


def to_cirq(circuit: Circuit, qubits_map: dict = None):
    """Convert a circuit to a ``cirq.Circuit``."""
    try:
        import cirq
    except ImportError as e:
        raise ImportError(
            "'to_cirq' requires cirq, which is not installed in this "
            "environment.") from e

    circuit = Circuit(circuit)
    if qubits_map is None:
        qubits_map = {q: cirq.LineQubit(i)
                      for i, q in enumerate(circuit.all_qubits)}

    out = cirq.Circuit()
    for g in circuit:
        cq = [qubits_map[q] for q in g.qubits]
        power = getattr(g, 'power', 1)
        simple = _SIMPLE.get(g.name)
        if simple is not None and power == 1 and not (
                g.provides('is_conjugated') and g.is_conjugated()) and \
                not (g.provides('is_transposed') and g.is_transposed()):
            out.append(simple(cirq, g).on(*cq))
        elif g.provides('matrix'):
            # MATRIX / U3 / powered / conj / T gates export as a raw
            # matrix (reference ``cirq.py:122-127``).
            out.append(cirq.MatrixGate(np.asarray(g.matrix())).on(*cq))
        else:
            raise ValueError(f"Cannot convert gate '{g.name}' to cirq.")
    return out
