"""Noise injection: wrap every gate of a circuit with channels
(parity with ``hybridq/noise/utils.py``)."""

from __future__ import annotations

from hybridq_tpu_torch.circuit import Circuit
from hybridq_tpu_torch.dm.circuit import Circuit as SuperCircuit
from hybridq_tpu_torch.noise.channel import channel

__all__ = ['add_depolarizing_noise', 'add_dephasing_noise',
           'add_amplitude_damping_noise']


def _check_where(where):
    if where not in ('before', 'after'):
        raise ValueError("'where' can only be either 'before' or 'after'")


def add_depolarizing_noise(circuit, probs, where: str = 'after',
                           verbose: bool = False) -> SuperCircuit:
    """Add a global depolarizing channel around each gate, with the same
    locality as the gate.  ``probs`` may be a float, a per-locality list,
    or a dict keyed by gate qubit-count (``any`` fallback supported)."""
    _check_where(where)
    circuit = Circuit(circuit)
    probs = channel._get_params(
        keys=sorted({g.n_qubits for g in circuit}), args=probs,
        value_type=float, key_name='n_qubits')

    def _wrap(g):
        if isinstance(g, channel.BaseChannel):
            return [g]
        noise = channel.GlobalDepolarizingChannel(g.qubits,
                                                  probs[g.n_qubits])
        return [g, noise] if where == 'after' else [noise, g]

    return SuperCircuit(x for g in circuit for x in _wrap(g))


def add_dephasing_noise(circuit, probs, pauli_indexes=3,
                        where: str = 'after',
                        verbose: bool = False) -> SuperCircuit:
    """Add local dephasing channels around each gate (one per gate
    qubit)."""
    _check_where(where)
    circuit = Circuit(circuit)
    qubits = circuit.all_qubits
    probs = channel._get_params(qubits, probs, value_type=float)
    pauli_indexes = channel._get_params(qubits, pauli_indexes,
                                        value_type=int)

    def _wrap(g):
        if isinstance(g, channel.BaseChannel):
            return (g,)
        noise = channel.LocalDephasingChannel(
            g.qubits, p={q: probs[q] for q in g.qubits},
            pauli_index={q: pauli_indexes[q] for q in g.qubits})
        return (g,) + noise if where == 'after' else noise + (g,)

    return SuperCircuit(x for g in circuit for x in _wrap(g))


def add_amplitude_damping_noise(circuit, gammas, probs=1,
                                where: str = 'after',
                                verbose: bool = False) -> SuperCircuit:
    """Add amplitude-damping channels around each gate (one per gate
    qubit)."""
    _check_where(where)
    circuit = Circuit(circuit)
    qubits = circuit.all_qubits
    gammas = channel._get_params(qubits, gammas, value_type=float)
    probs = channel._get_params(qubits, probs, value_type=float)

    def _wrap(g):
        if isinstance(g, channel.BaseChannel):
            return (g,)
        noise = channel.AmplitudeDampingChannel(
            g.qubits, gamma={q: gammas[q] for q in g.qubits},
            p={q: probs[q] for q in g.qubits})
        return (g,) + noise if where == 'after' else noise + (g,)

    return SuperCircuit(x for g in circuit for x in _wrap(g))
