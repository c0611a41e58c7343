"""Gate composition utilities: merge, pad, decompose.

Behavioral parity with the reference ``hybridq/gate/utils.py:41-254``.
All of this runs on the host on small gate matrices.
"""

from __future__ import annotations

import numpy as np

from hybridq_tpu_torch.gate.gate import (BaseGate, Gate, MatrixGate, SchmidtGate)
from hybridq_tpu_torch.gate.zoo import GATES, get_clifford_gates
from hybridq_tpu_torch.utils import sort
from hybridq_tpu_torch.utils.linalg import svd

__all__ = [
    'get_available_gates', 'get_clifford_gates', 'merge', 'pad', 'decompose',
    'is_clifford'
]


def get_available_gates() -> tuple:
    """Names of all gates in the zoo."""
    return tuple(GATES)


def is_clifford(gate: BaseGate) -> bool:
    """True if ``gate`` is a Clifford gate."""
    return gate.is_clifford()


def merge(a: BaseGate, *bs) -> BaseGate:
    """Merge gates so that the result is equivalent to applying
    ``bs[-1] ... bs[0] a`` to a state (reference:
    ``hybridq/gate/utils.py:41-120``).

    Returns a ``MatrixGate`` acting on the union of the qubits, ordered as
    ``b.qubits + (a.qubits - b.qubits)`` at each pairwise step.
    """
    if len(bs) == 0:
        return a
    b, rest = bs[0], bs[1:]
    for g in (a, b):
        if not g.provides('matrix,qubits') or g.qubits is None:
            raise ValueError(
                "Both 'a' and 'b' must provide 'qubits' and 'matrix'.")

    Ua, Ub = a.matrix(), b.matrix()
    shared = set(a.qubits) & set(b.qubits)
    all_qubits = b.qubits + tuple(q for q in a.qubits if q not in b.qubits)
    n_a, n_b, n_c = len(a.qubits), len(b.qubits), len(all_qubits)

    if shared:
        # Contract Ub @ Ua over the shared qubit axes.  Axis layout:
        # Ub -> (b_out, b_in), Ua -> (a_out, a_in); b_in contracts with a_out
        # on shared qubits.
        Tb = Ub.reshape((2,) * (2 * n_b))
        Ta = Ua.reshape((2,) * (2 * n_a))
        b_out = list(range(n_b))
        b_in = list(range(n_b, 2 * n_b))
        a_out = list(range(2 * n_b, 2 * n_b + n_a))
        a_in = list(range(2 * n_b + n_a, 2 * n_b + 2 * n_a))
        # Contract: b_in axis of shared qubit == a_out axis of same qubit.
        for q in shared:
            a_out[a.qubits.index(q)] = b_in[b.qubits.index(q)]
        out_l = [
            b_out[b.qubits.index(q)] if q in b.qubits else
            a_out[a.qubits.index(q)] for q in all_qubits
        ]
        out_r = [
            b_in[b.qubits.index(q)]
            if (q in b.qubits and q not in shared) else
            a_in[a.qubits.index(q)] for q in all_qubits
        ]
        U = np.einsum(Tb, b_out + b_in, Ta, a_out + a_in, out_l + out_r)
        U = U.reshape((2**n_c, 2**n_c))
    else:
        U = np.kron(Ub, Ua)

    gate = Gate('MATRIX', qubits=all_qubits, U=U)
    return merge(gate, *rest) if rest else gate


def pad(gate: BaseGate, qubits, order=None,
        return_matrix_only: bool = False):
    """Extend ``gate`` with identities to act on all ``qubits``
    (reference: ``hybridq/gate/utils.py:123-188``)."""
    qubits = tuple(qubits)
    order = None if order is None else tuple(order)
    if order and sort(qubits) != sort(order):
        raise ValueError("'order' must be a permutation of 'qubits'")
    if not gate.provides('qubits') or gate.qubits is None or \
            set(gate.qubits) - set(qubits):
        raise ValueError("'gate' must provide qubits and those qubits "
                         "must be a subset of 'qubits'.")

    M = gate.matrix()
    if gate.n_qubits != len(qubits):
        M = np.kron(M, np.eye(2**(len(qubits) - gate.n_qubits)))
    new_qubits = gate.qubits + tuple(q for q in qubits
                                     if q not in gate.qubits)
    if order and order != new_qubits:
        M = MatrixGate(M, qubits=new_qubits).matrix(order=order)
        new_qubits = order
    if return_matrix_only:
        return M
    return MatrixGate(M, qubits=new_qubits, tags=dict(gate.tags))


def decompose(gate: BaseGate, qubits, return_matrices: bool = False,
              atol: float = 1e-8):
    """Schmidt-decompose ``gate`` across the bipartition ``(qubits, rest)``
    (reference: ``hybridq/gate/utils.py:190-254``)."""
    qubits = tuple(qubits)
    ns = len(qubits)
    if set(qubits) - set(gate.qubits):
        raise ValueError("'qubits' must be a valid subset of 'gate.qubits'.")
    alt_qubits = tuple(q for q in gate.qubits if q not in qubits)

    axes = [gate.qubits.index(x) for x in qubits]
    axes += [x + gate.n_qubits for x in axes]
    s, uh, vh = svd(
        np.reshape(gate.matrix(), (2,) * (2 * gate.n_qubits)), axes,
        atol=atol)
    uh = np.reshape(uh, (len(s), 2**ns, 2**ns))
    vh = np.reshape(vh, (len(s), 2**(gate.n_qubits - ns),
                         2**(gate.n_qubits - ns)))
    if return_matrices:
        return s, uh, vh
    return SchmidtGate(gates=(tuple(
        Gate('MATRIX', qubits=qubits, U=x) for x in uh), tuple(
            Gate('MATRIX', qubits=alt_qubits, U=x) for x in vh)), s=s)
