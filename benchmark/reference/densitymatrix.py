"""Plain density-matrix reference for the benchmark's noisy circuits.

Plain PyTorch, by the definitions: rho is a 2^n x 2^n complex matrix,
held flat (row index the high n bits, column index the low n bits, qubit
0 the most significant bit of each: the program's layout of its doubled
register), updated in place.

* A gate U on qubits Q is applied to rho's row axes Q, then conj(U) to its
  column axes Q: rho -> U rho U^dagger, with no superoperator.  Products
  run through ``statevector``'s blocks (``_apply``, at most ``CHUNK``
  entries a product) with TF32 off; a run of one-qubit gates on distinct
  qubits goes as ``statevector.operations`` groups it.
* A depolarizing channel of strength p on qubits Q (d = 2^|Q|) is applied
  as rho -> (1 - p) rho + p Tr_Q(rho) (x) I/d: in each d x d sub-block over
  Q's row and column bits the entries are scaled by (1 - p), as
  rho - p rho (a rounded 1 - p would bias every channel alike), and p/d
  times the sub-block's trace is added to its diagonal.  No products; a
  block of at most ``CHUNK`` entries at a time.

The noise is Arute et al.'s digital error model (Nature 574:505 (2019),
Fig. 2) as the configuration states it, with these departures: one
uniform depolarizing channel after every gate, on that gate's qubits,
whose total Pauli error e is the paper's mean simultaneous error of its
gate kind (p = e d^2 / (d^2 - 1), see ``depolarizing_p``), in place of each
qubit's and pair's measured Pauli errors; no readout error (a classical
map on the read probabilities); no idle errors.

``tf32=True`` is the control: every product's operands rounded to TF32
first, as ``statevector`` does; the channels have no product and stay
exact.

Imports nothing of the program or of JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import statevector

__all__ = ['depolarizing_p', 'evolve', 'entries', 'apply_gate',
           'depolarize']


def depolarizing_p(error: float, k: int) -> float:
    """The strength p of the depolarizing channel on ``k`` qubits whose
    total Pauli error (the chance of a Pauli other than the identity) is
    ``error``: the channel applies each of the d^2 Paulis with chance
    p/d^2, so ``error = p (d^2 - 1)/d^2``."""
    d2 = 4 ** k
    return error * d2 / (d2 - 1)


def apply_gate(rho: torch.Tensor, n: int, u: np.ndarray, axes,
               tf32: bool = False):
    """``rho`` (flat, 4^n) <- U rho U^dagger for ``u`` on the qubits
    ``axes``, in place."""
    m = torch.as_tensor(u, dtype=rho.dtype, device=rho.device)
    statevector._apply(rho, 2 * n, m, tuple(axes), tf32)
    statevector._apply(rho, 2 * n, m.conj().resolve_conj(),
                       tuple(n + a for a in axes),
                       tf32)


def depolarize(rho: torch.Tensor, n: int, qubits, p: float):
    """``rho`` (flat, 4^n) <- (1 - p) rho + p Tr_Q(rho) (x) I/d on the
    qubits ``Q`` = ``qubits``, in place."""
    k, q = len(qubits), sorted(qubits)
    marked = set(q) | {n + a for a in q}
    # rho as dims of size 2 (Q's row bits, then its column bits) and
    # merged runs of the other bits
    shape, is_q = [], []
    for a in range(2 * n):
        if a in marked:
            shape.append(2)
            is_q.append(True)
        elif shape and not is_q[-1]:
            shape[-1] *= 2
        else:
            shape.append(2)
            is_q.append(False)
    view = rho.view(shape)
    q_dims = [i for i, x in enumerate(is_q) if x]
    o_dims = [i for i, x in enumerate(is_q) if not x]
    if not o_dims:                       # the channel spans rho
        o_dims, shape, view = [len(shape)], shape + [1], view[..., None]
    cut = max(o_dims, key=lambda i: shape[i])
    step = max(1, shape[cut] * statevector.CHUNK // rho.numel())
    diagonal = [bits + bits for bits in (
        tuple(x >> (k - 1 - j) & 1 for j in range(k)) for x in range(2 ** k))]
    for s in range(0, shape[cut], step):
        blk = view.narrow(cut, s, min(step, shape[cut] - s))
        moved = blk.permute(q_dims + o_dims)
        trace = sum(moved[x] for x in diagonal)
        blk.add_(blk, alpha=-p)
        for x in diagonal:
            moved[x].add_(trace, alpha=p / 2 ** k)


def evolve(gates, n: int, noise: dict, device, tf32: bool = False,
           dtype=torch.complex64) -> torch.Tensor:
    """The flat rho of the circuit ``gates`` (``[(name, qubits, params),
    ...]``) on ``n`` qubits from |0...0><0...0|, with a depolarizing
    channel of strength ``noise[k]`` after every gate of ``k`` qubits, on
    its qubits."""
    rho = torch.zeros(4 ** n, dtype=dtype, device=device)
    rho[0] = 1
    run = []                 # one-qubit gates on distinct qubits, in order

    def flush():
        for u, axes in statevector.operations(run, n):
            apply_gate(rho, n, u, axes, tf32)
        for _, qubits, _ in run:
            depolarize(rho, n, qubits, noise[1])
        run.clear()

    for name, qubits, params in gates:
        if len(qubits) == 1 and qubits[0] not in {r[1][0] for r in run}:
            run.append((name, qubits, params))
            continue
        flush()
        if len(qubits) == 1:
            run.append((name, qubits, params))
        else:
            apply_gate(rho, n, statevector.gate_matrix(name, params),
                       qubits, tf32)
            depolarize(rho, n, qubits, noise[len(qubits)])
    flush()
    return rho


def entries(gates, n: int, noise: dict, index: torch.Tensor, device,
            tf32: bool = False) -> np.ndarray:
    """The entries of the flat rho at ``index`` as a complex64 host
    array."""
    rho = evolve(gates, n, noise, device, tf32)
    out = rho.index_select(0, index.to(device)).cpu().numpy()
    del rho
    return out
