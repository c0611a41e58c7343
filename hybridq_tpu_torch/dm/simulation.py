"""Density-matrix evolution via the doubled-qubit vectorization trick.

The counterpart of ``hybridq_tpu/dm/simulation.py``, with the same
lowering (the reference's ``hybridq/dm/circuit/simulation.py:24-51``):

  * each pure gate ``g`` becomes ``g`` on qubits ``(0, q)`` and
    ``g.conj()`` on ``(1, q)``, since rho -> U rho U^dagger vectorizes to
    ``(U (x) U*) vec(rho)``;
  * each supergate becomes one ``MatrixGate(gate.map())`` on the doubled
    qubits;

then the port's pure-state ``simulate`` runs the doubled circuit, on the
card unless ``device='cpu'`` is passed (every other keyword goes through
to it).  Sorted, the ``(1, q)`` half of the doubled register lands on the
lowest flat bits, which the straight engine (``IndexedEvolver``) applies
in place like any other bits: rho's row index is the high half of the
result's flat index and its column index the low half.

While a profiler records, a call is the span ``hq.dm.simulate`` and its
lowering the span ``hq.dm.lower`` inside it (``_device.span``); the
lowering counts its work in ``counts()``: ``gates``, the pure gates
doubled, and ``channels``, the supergates lowered to one ``MatrixGate``
each.
"""

from __future__ import annotations

import numpy as np

from hybridq_tpu_torch.circuit import Circuit as PureCircuit
from hybridq_tpu_torch.circuit.utils import matrix as circuit_matrix
from hybridq_tpu_torch.dm.circuit import Circuit as SuperCircuit
from hybridq_tpu_torch.dm.gate import BaseSuperGate
from hybridq_tpu_torch.gate import BaseGate, MatrixGate
from hybridq_tpu_torch.simulation._device import span
from hybridq_tpu_torch.utils import sort

__all__ = ['simulate', 'counts', 'reset_counts']

# Work of the lowering: pure gates doubled, and supergates lowered to one
# MatrixGate each.
gates = 0
channels = 0


def reset_counts():
    global gates, channels
    gates = channels = 0


def counts() -> dict:
    return {'gates': gates, 'channels': channels}


def _transform(gate):
    """SuperCircuit gate -> pure-state gate(s) on doubled qubits."""
    global gates, channels
    if isinstance(gate, BaseSuperGate):
        # Channels may be both BaseGate and BaseSuperGate; the supergate
        # lowering takes precedence (exact evolution).
        if isinstance(gate, BaseGate):
            l_qubits = r_qubits = gate.qubits
        else:
            l_qubits, r_qubits = gate.qubits
        channels += 1
        return (MatrixGate(gate.map(),
                           qubits=[(0, q) for q in l_qubits] +
                           [(1, q) for q in r_qubits]),)
    if isinstance(gate, BaseGate):
        gates += 1
        return (gate.on([(0, q) for q in gate.qubits]),
                gate.conj().on([(1, q) for q in gate.qubits]))
    raise TypeError(f"{type(gate).__name__} not supported.")


def _convert(circuit) -> PureCircuit:
    """SuperCircuit -> pure Circuit on doubled qubits."""
    flat = (g for w in circuit
            for g in (w if isinstance(w, tuple) and not isinstance(
                w, (BaseGate, BaseSuperGate)) else [w]))
    return PureCircuit(g for gate in flat for g in _transform(gate))


def simulate(circuit, initial_state, final_state=None,
             optimize='evolution', parallel=False, verbose: bool = False,
             **kwargs):
    """Simulate a density-matrix circuit: lower it to a doubled-qubit
    pure-state circuit and call ``hybridq_tpu_torch.simulation.simulate``
    with ``optimize`` and ``kwargs`` (``device=``, ``complex_type=``, ...).

    ``initial_state`` may be a token string (single char broadcast; doubled
    automatically), a pure ``Circuit`` (its matrix U is used as rho,
    transposed input/output, as in the reference), or a dense array of
    ``nl + nr`` qubit axes.  ``optimize='clifford'`` delegates to the
    Pauli-string engine (``simulation.clifford.update_pauli_string``, on
    the card unless ``device='cpu'`` or ``backend='numpy'``), with
    ``initial_state`` the Pauli string.  While a profiler records, the
    call is the span ``hq.dm.simulate`` and its lowering ``hq.dm.lower``.
    """
    with span('hq.dm.simulate'):
        circuit = list(circuit)

        if optimize == 'clifford':
            from hybridq_tpu_torch.simulation import clifford

            if any(not isinstance(g, BaseGate) for g in circuit):
                raise NotImplementedError(
                    "'optimize=clifford' only supports 'BaseGate's")
            if final_state is not None:
                raise ValueError(
                    "'final_state' cannot be provided if optimize='clifford'.")
            return clifford.update_pauli_string(
                PureCircuit(circuit), initial_state, verbose=verbose, **kwargs)

        from hybridq_tpu_torch.simulation import simulate as pure_simulate

        with span('hq.dm.lower'):
            circuit = SuperCircuit(circuit)
            l_qubits, r_qubits = circuit.all_qubits
            doubled = _convert(circuit)
        nl, nr = len(l_qubits), len(r_qubits)

        def _get_state(state, name):
            if state is None:
                return None
            if isinstance(state, str):
                state = state * (nl + nr) if len(state) == 1 else state
                if not (len(state) == nl + nr or
                        (l_qubits == r_qubits and len(state) == nl)):
                    raise ValueError(
                        f"'{name}' has the wrong number of qubits.")
                return state + state if len(state) == nl else state
            if isinstance(state, PureCircuit):
                if l_qubits != r_qubits or sort(l_qubits) != sort(
                        state.all_qubits):
                    raise ValueError(
                        f"Qubits in '{name}' are not consistent with "
                        "'circuit'.")
                U = circuit_matrix(state, order=l_qubits)
                return np.transpose(np.reshape(U, (2,) * (2 * nl)),
                                    list(range(nl, 2 * nl)) + list(range(nl)))
            state = np.asarray(state)
            if set(state.shape) != {2}:
                raise NotImplementedError(
                    "Only 2-dimensional qubits are allowed.")
            if not (state.ndim == nl + nr or
                    (l_qubits == r_qubits and state.ndim == nl)):
                raise ValueError(
                    f"'{name}' has the wrong number of qubits.")
            if state.ndim == nl:
                state = np.reshape(np.kron(state.ravel(), state.ravel()),
                                   (2,) * (2 * nl))
            return state

        return pure_simulate(doubled,
                             initial_state=_get_state(initial_state,
                                                      'initial_state'),
                             final_state=_get_state(final_state,
                                                    'final_state'),
                             optimize=optimize, verbose=verbose, **kwargs)
