"""Per-gate state-vector evolution on a complex ``(2,)*n`` torch tensor.

The counterpart of ``hybridq_tpu``'s traced engine (``_evolve_tpu`` /
``evolve_statevector``), which the main path takes below the fused
threshold.  That engine runs no Pallas kernel, so plain PyTorch is the
whole port here: one ``tensordot`` per gate, then ``movedim`` puts the
gate axes back.  Native complex arithmetic replaces the split re/im pair
the TPU needed.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ['split_complex', 'merge_complex', 'apply_gate',
           'evolve_statevector']


def split_complex(psi, float_type='float32'):
    """Host complex array -> (re, im) float pair."""
    psi = np.asarray(psi)
    return (np.ascontiguousarray(psi.real, dtype=float_type),
            np.ascontiguousarray(psi.imag, dtype=float_type))


def merge_complex(re, im, complex_type='complex64'):
    """(re, im) pair -> host complex array."""
    out = np.asarray(re).astype(complex_type)
    out += 1j * np.asarray(im).astype(np.asarray(re).dtype)
    return out


def apply_gate(psi: torch.Tensor, U: torch.Tensor, axes) -> torch.Tensor:
    """Apply the ``2^k x 2^k`` matrix ``U`` to axes ``axes`` (first axis
    = most significant bit of the gate index) of the ``(2,)*n`` tensor
    ``psi``; returns a new tensor."""
    k = len(axes)
    U = U.reshape((2,) * (2 * k))
    out = torch.tensordot(U, psi, dims=(list(range(k, 2 * k)), list(axes)))
    return torch.movedim(out, list(range(k)), list(axes))


def evolve_statevector(psi: torch.Tensor, gates, qubit_index
                       ) -> torch.Tensor:
    """Apply matrix gates in order to ``psi`` (complex ``(2,)*n`` torch
    tensor); ``qubit_index`` maps qubit labels to axes."""
    for g in gates:
        U = torch.as_tensor(np.ascontiguousarray(g.matrix()),
                            dtype=psi.dtype, device=psi.device)
        psi = apply_gate(psi, U, [qubit_index[q] for q in g.qubits])
    return psi
