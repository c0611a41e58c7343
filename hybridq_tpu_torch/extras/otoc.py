"""OTOC circuit generators (Science 374, 6574 (2021) scrambling
experiment workload; parity with ``hybridq/extras/simulation/otoc.py``)."""

from __future__ import annotations

from hybridq_tpu_torch.circuit import Circuit
from hybridq_tpu_torch.gate import Gate
from hybridq_tpu_torch.utils import sort

__all__ = ['generate_U', 'generate_OTOC']


def generate_U(layout, qubits_order, depth: int, sequence,
               one_qb_gates, two_qb_gates, exclude_qubits=None) -> Circuit:
    """Brickwork scrambling unitary: alternating single-qubit gates and
    layer-patterned two-qubit gates."""
    circ = Circuit()
    exclude_qubits = set() if exclude_qubits is None else set(
        exclude_qubits)
    qubits_order = [q for q in qubits_order if q not in exclude_qubits]

    index = 0
    for d in range(depth):
        seq = sequence[d % len(sequence)]
        layer = layout[seq]
        tags = {'depth': d, 'sequence': seq}
        circ += [
            next(one_qb_gates).on([q]).set_tags({**tags,
                                                 'index': index + i})
            for i, q in enumerate(qubits_order)
        ]
        circ += [
            next(two_qb_gates).on(q).set_tags(tags) for q in layer
            if not exclude_qubits.intersection(q)
        ]
        index += len(qubits_order)
    return circ


def generate_OTOC(layout, depth: int, sequence, one_qb_gates,
                  two_qb_gates, butterfly_op: str, ancilla, targets,
                  qubits_order=None) -> Circuit:
    """Full OTOC sandwich: prep, CZ(ancilla, target), U, butterfly,
    U^-1, CZ(ancilla, target)."""
    all_qubits = {
        q for s in sequence[:min(depth, len(sequence))]
        for pair in layout[s] for q in pair
    }
    qubits_order = sort(all_qubits) if qubits_order is None else \
        list(qubits_order)
    butterfly_op = list(butterfly_op)

    if sort(all_qubits) != sort(qubits_order):
        raise ValueError(
            "'qubits_order' must be a valid permutation of all qubits.")
    if set(butterfly_op) - {'I', 'X', 'Y', 'Z'}:
        raise ValueError('Only {I, X, Y, Z} are valid butterfly operators')
    if (set(targets) | {ancilla}) - all_qubits:
        raise ValueError("Ancilla/Targets must be in layout.")
    if len(set(targets)) != len(targets):
        raise ValueError('Targets must be unique.')
    if ancilla in targets:
        raise ValueError('Ancilla must be different from targets')
    if len(targets) != len(butterfly_op) + 1:
        raise ValueError(
            "Number of butterfly operators does not match number of "
            f"targets (expected {len(targets) - 1}, "
            f"got {len(butterfly_op)}).")
    if not any(
            sort(w) == sort([ancilla, targets[0]])
            for s in sequence[:min(depth, len(sequence))]
            for w in layout[s]):
        raise ValueError(
            f"No available two-qubit gate between ancilla {ancilla} and "
            f"qubit {targets[0]}.")

    circ = Circuit()
    circ.extend([
        Gate('SQRT_Y' if q != ancilla else 'SQRT_X', qubits=[q],
             tags={'depth': 0, 'sequence': 'initial'})
        for q in sort(all_qubits)
    ])
    circ.append(Gate('CZ', [ancilla, targets[0]],
                     tags={'depth': 0, 'sequence': 'first_control'}))

    U = generate_U(layout=layout, qubits_order=qubits_order, depth=depth,
                   sequence=sequence, one_qb_gates=one_qb_gates,
                   two_qb_gates=two_qb_gates,
                   exclude_qubits=[ancilla]).update_tags({'U': True})
    circ += U

    circ.extend([
        Gate(b, qubits=[t],
             tags={'depth': depth - 1, 'sequence': 'butterfly'})
        for b, t in zip(butterfly_op, targets[1:])
    ])

    circ += Circuit(
        gate.update_tags({
            'depth': 2 * depth - gate.tags['depth'] - 1,
            'U^-1': True
        }).remove_tags(['U']) for gate in U.inv())

    circ.append(Gate('CZ', [ancilla, targets[0]],
                     tags={'depth': 2 * depth - 1,
                           'sequence': 'second_control'}))
    return circ
