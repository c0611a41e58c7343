"""Random gate / circuit generators (test fixtures and benchmark workloads).

Parity with the reference ``hybridq/extras/random.py``: heterogeneous qubit
labels (ints / strings / tuples freely mixed) deliberately stress the
label-sorting machinery.
"""

from __future__ import annotations

import numpy as np

from hybridq_tpu_torch.circuit import Circuit
from hybridq_tpu_torch.gate import (Gate, MatrixGate,
                                    get_available_gates, get_clifford_gates)

__all__ = ['get_indexes', 'get_random_gate', 'get_rqc']


def get_indexes(n_qubits: int, *, use_random_indexes: bool = False):
    """Sequential int labels, or a random mix of strings and int-tuples."""
    if not use_random_indexes:
        return list(range(n_qubits))

    indexes = []
    while len(indexes) < n_qubits // 3:
        indexes += [
            ''.join(
                np.random.choice(list('abcdefghijklmnopqrstuvwxyz'), size=20))
            for _ in range(n_qubits // 3 - len(indexes))
        ]
    while len(indexes) < n_qubits:
        cand = np.unique(np.random.randint(-2**31 + 1, 2**31 - 1,
                                           size=(n_qubits - len(indexes), 2)),
                         axis=0)
        indexes += [tuple(int(v) for v in x) for x in cand]
    indexes = list(dict.fromkeys(indexes))[:n_qubits]
    while len(indexes) < n_qubits:  # de-dup collisions, top up
        indexes.append(('extra', len(indexes)))
    return [indexes[i] for i in np.random.permutation(n_qubits)]


def get_random_gate(randomize_power: bool = True,
                    use_clifford_only: bool = False,
                    use_unitary_only: bool = True):
    """Generate a random gate (named or random-matrix), with random params,
    power, conj and T."""
    avail = get_clifford_gates() if use_clifford_only else \
        get_available_gates()
    if not use_unitary_only:
        avail = tuple(avail) + ('RANDOM_MATRIX',)

    name = np.random.choice(avail)
    if name == 'RANDOM_MATRIX':
        nq = int(np.random.choice(range(1, 3)))
        M = (2 * np.random.random((2**nq, 2**nq)) - 1).astype(complex)
        M += 1j * (2 * np.random.random((2**nq, 2**nq)) - 1)
        M /= 2
        M /= np.sqrt(np.linalg.norm(np.linalg.eigvalsh(M.conj().T @ M)))
        gate = MatrixGate(M)
    else:
        gate = Gate(name)

    if gate.provides('params') and gate.n_params:
        gate.set_params(np.random.random(size=gate.n_params), inplace=True)
    if randomize_power:
        gate = gate**(2 * np.random.random() - 1)
    if gate.provides('conj') and np.random.random() < 0.5:
        gate = gate.conj()
    if gate.provides('T') and np.random.random() < 0.5:
        gate = gate.T()
    # Convert to a raw MatrixGate half of the time.
    if gate.name != 'MATRIX' and np.random.random() < 0.5:
        gate = MatrixGate(gate.matrix())
    return gate


def get_rqc(n_qubits: int, n_gates: int, *, indexes=None,
            randomize_power: bool = True, use_clifford_only: bool = False,
            use_unitary_only: bool = True, use_random_indexes: bool = False,
            verbose: bool = False) -> Circuit:
    """Generate a random quantum circuit on ``n_qubits`` with ``n_gates``
    gates."""
    if indexes is None:
        indexes = get_indexes(n_qubits,
                              use_random_indexes=use_random_indexes)
    else:
        indexes = list(indexes)
    assert len(indexes) == n_qubits

    circuit = Circuit()
    for _ in range(n_gates):
        gate = get_random_gate(randomize_power=randomize_power,
                               use_unitary_only=use_unitary_only,
                               use_clifford_only=use_clifford_only)
        pos = np.random.choice(n_qubits, gate.n_qubits, replace=False)
        circuit.append(gate.on([indexes[i] for i in pos]))
    return circuit
