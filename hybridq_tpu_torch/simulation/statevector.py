"""Per-gate state-vector evolution on a complex ``(2,)*n`` torch tensor.

The counterpart of ``hybridq_tpu``'s traced engine (``_evolve_tpu`` /
``evolve_statevector``), which the main path takes below 20 qubits, and
the port's complex128 engine.  That engine runs no Pallas kernel, so plain
PyTorch is the whole port here: native complex arithmetic replaces the
split re/im pair the TPU needed.

A gate copies the state once, with its axes moved to the front, and
multiplies that copy in place, a slice of columns at a time: two buffers
the size of the state are live at once (a complex128 state of 30 qubits
is 16 GiB).  ``evolve_statevector`` leaves the axes where the last gate
put them and permutes back once at the end.
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


# elements of the temporary that one slice of the product takes
_CHUNK = 2 ** 24


def _apply_front(psi: torch.Tensor, U: torch.Tensor, axes) -> torch.Tensor:
    """``U`` applied to axes ``axes`` of ``psi`` (first axis = most
    significant bit of the gate index); returns a new contiguous tensor
    whose first ``len(axes)`` axes are ``axes``, the others following in
    their order."""
    n, k = psi.dim(), len(axes)
    rest = [a for a in range(n) if a not in axes]
    out = torch.empty(psi.shape, dtype=psi.dtype, device=psi.device)
    out.copy_(psi.permute(list(axes) + rest))
    cols = out.view(2 ** k, -1)
    step = max(1, _CHUNK >> k)
    for s in range(0, cols.shape[1], step):
        cols[:, s:s + step] = torch.matmul(U, cols[:, s:s + step])
    return out


def apply_gate(psi: torch.Tensor, U: torch.Tensor, axes) -> torch.Tensor:
    """Apply the ``2^k x 2^k`` matrix ``U`` to axes ``axes`` (first axis
    = most significant bit of the gate index) of the ``(2,)*n`` tensor
    ``psi``; returns a new contiguous tensor in ``psi``'s axis order."""
    axes = list(axes)
    out = _apply_front(psi, U, axes)
    order = axes + [a for a in range(psi.dim()) if a not in axes]
    return out.permute([order.index(a) for a in range(psi.dim())]
                       ).contiguous()


def evolve_statevector(psi: torch.Tensor, gates, qubit_index
                       ) -> torch.Tensor:
    """Apply matrix gates in order to ``psi`` (complex ``(2,)*n`` torch
    tensor); ``qubit_index`` maps qubit labels to axes.  Returns a new
    contiguous tensor."""
    n = psi.dim()
    order = list(range(n))      # order[i]: the axis of psi held at i
    for g in gates:
        U = torch.as_tensor(np.ascontiguousarray(g.matrix()),
                            dtype=psi.dtype, device=psi.device)
        targets = [qubit_index[q] for q in g.qubits]
        axes = [order.index(t) for t in targets]
        psi = _apply_front(psi, U, axes)
        order = targets + [order[i] for i in range(n) if i not in axes]
    if order != list(range(n)):
        psi = psi.permute([order.index(a) for a in range(n)]).contiguous()
    return psi
