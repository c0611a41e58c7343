"""Engine dispatch + state-vector evolution front-end.

The counterpart of ``hybridq_tpu/simulation/simulation.py`` for the
``optimize='evolution'`` family:

  * ``'evolution'`` / ``'evolution-tpu'`` / ``'evolution-hybridq'``: the
    native engine.  On a CUDA device with >= 20 qubits in complex64 it is
    the fused engine (``FusedEvolver`` on the CUDA kernels of
    ``fused_kernels``); otherwise one ``tensordot`` per gate block on a
    complex ``(2,)*n`` tensor (``statevector``).
  * ``'evolution-fused'``: the fused engine at any n >= 14.
  * ``expectation_value(state, op, qubits_order)``.

``device=None`` means ``'cuda'``; without a CUDA device ``simulate``
raises (pass ``device='cpu'`` to run on the host, as the tests do).  The
engines not ported yet raise ``NotImplementedError`` naming the
``ROADMAP.md`` item that ports them.
"""

from __future__ import annotations

import time as _time_mod
from warnings import warn

import numpy as np
import torch

from hybridq_tpu_torch.circuit import Circuit, utils
from hybridq_tpu_torch.gate import FunctionalGate, Gate, StochasticGate

__all__ = ['simulate', 'expectation_value']

_NOT_PORTED = {
    'indexed': "ROADMAP.md Queue 1, item 6 (IndexedEvolver)",
    'einsum': "ROADMAP.md Queue 1, item 4a (_evolve_einsum on "
              "torch.einsum)",
    'sharded': "ROADMAP.md Queue 1, item 11 (sharded engines)",
    'tn': "ROADMAP.md Queue 1, item 10 (tensor-network contraction)",
    'complex128': "ROADMAP.md Queue 1, item 2a (complex128 evolution)",
}


def _not_ported(what):
    return NotImplementedError(
        f"{what} is not ported to hybridq_tpu_torch yet: see "
        f"{_NOT_PORTED[what]}")


def _preprocess_circuit(circuit, initial_state, final_state, simplify,
                        remove_id_gates, atol, verbose, allow_sampling,
                        sampling_seed):
    """Shared front-end: flatten, sample stochastic gates, simplify."""
    circuit = utils.flatten(Circuit(circuit))

    if sampling_seed is not None:
        rng = np.random.default_rng(int(sampling_seed))
    else:
        rng = np.random.default_rng(np.random.randint(2**63))
    circuit = Circuit(
        g.sample(rng=rng) if isinstance(g, StochasticGate) and allow_sampling
        else g for g in circuit)

    qubits = circuit.all_qubits
    n_qubits = len(qubits)

    def _prep(state):
        if state is None:
            return None
        if isinstance(state, str):
            if len(state) == 1:
                state *= n_qubits
            if len(state) != n_qubits:
                raise ValueError(
                    "Wrong number of qubits for initial/final state.")
            return state
        state = np.asarray(state)
        if any(x != 2 for x in state.shape):
            raise ValueError("Only qubits of dimension 2 are supported.")
        if state.ndim != n_qubits:
            raise ValueError(
                "Wrong number of qubits for initial/final state.")
        return state

    initial_state = _prep(initial_state)
    final_state = _prep(final_state)

    if remove_id_gates:
        circuit = Circuit(g for g in circuit if g.name != 'I')
    if simplify:
        circuit = utils.simplify(
            circuit, remove_id_gates=remove_id_gates, atol=atol,
            verbose=verbose,
            **(simplify if isinstance(simplify, dict) else {}))
    if circuit and circuit.all_qubits != qubits:
        raise ValueError("Active qubits have changed after simplification. "
                         "Forcing stop.")
    return circuit, qubits, initial_state, final_state


def _resolve_device(device) -> torch.device:
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("simulate() runs on a CUDA device by default "
                           "and none is available; pass device='cpu' to "
                           "run on the host")
    return device


def simulate(circuit, initial_state=None, final_state=None,
             optimize='evolution', backend='torch',
             complex_type='complex64', tensor_only: bool = False,
             simplify=True, remove_id_gates: bool = True, use_mpi=None,
             atol: float = 1e-8, verbose: bool = False, device=None,
             **kwargs):
    """Simulate a circuit by state-vector evolution (see the module
    docstring).  Returns a numpy array by default, or the torch tensor on
    ``device`` with ``return_numpy_array=False``."""
    kwargs.setdefault('allow_sampling', False)
    kwargs.setdefault('sampling_seed', None)

    if not (isinstance(optimize, str) and 'evolution' in optimize):
        raise _not_ported('tn')
    if tensor_only:
        raise ValueError(
            f"'tensor_only' is not supported for optimize={optimize}")
    if np.dtype(complex_type) != np.dtype('complex64'):
        raise _not_ported('complex128')
    device = _resolve_device(device)

    circuit, qubits, initial_state, final_state = _preprocess_circuit(
        circuit, initial_state, final_state, simplify, remove_id_gates,
        atol, verbose, kwargs['allow_sampling'], kwargs['sampling_seed'])

    sub = '-'.join(optimize.split('-')[1:]) or 'tpu'
    if sub == 'hybridq':  # reference alias for its native engine
        sub = 'tpu'
    kwargs.setdefault('compress', 4)
    kwargs.setdefault('max_largest_intermediate', 2**30)
    kwargs.setdefault('return_info', False)
    kwargs.setdefault('block_until_ready', True)
    kwargs.setdefault('return_numpy_array', True)
    return _simulate_evolution(circuit, qubits, initial_state, final_state,
                               sub, complex_type, device, **kwargs)


def _segment_blocks(blocks):
    """Group compressed blocks into maximal runs of matrix gates, keeping
    FunctionalGates as singleton separators."""
    segments = []  # list of ('mat', [gates]) | ('fun', gate)
    current = []
    for block in blocks:
        if any(isinstance(g, FunctionalGate) for g in block):
            assert len(block) == 1
            if current:
                segments.append(('mat', current))
                current = []
            segments.append(('fun', block[0]))
        else:
            current.append(block)
    if current:
        segments.append(('mat', current))
    return segments


def _simulate_evolution(circuit, qubits, initial_state, final_state, sub,
                        complex_type, device, **kwargs):
    n_qubits = len(qubits)
    qubit_index = {q: i for i, q in enumerate(qubits)}
    info = {}

    if 2**n_qubits > kwargs['max_largest_intermediate']:
        raise MemoryError("Memory for the given number of qubits exceeds "
                          "the 'max_largest_intermediate'.")
    if final_state is not None:
        warn("'final_state' cannot be specified in optimize='evolution'. "
             "Ignoring 'final_state'.")
    if initial_state is None:
        raise ValueError(
            "'initial_state' must be specified for optimize='evolution'.")
    if sub.split('-')[0] in ('indexed', 'einsum', 'sharded'):
        raise _not_ported(sub.split('-')[0])
    if sub not in ('tpu', 'fused'):
        raise ValueError(f"optimize='evolution-{sub}' not implemented.")

    complex_type = np.dtype(complex_type)

    # Compress into k-qubit blocks, never merging FunctionalGates.
    compress_opt = kwargs['compress']
    max_k = compress_opt['max_n_qubits'] if isinstance(compress_opt, dict) \
        else compress_opt
    compress_kw = ({k: v for k, v in compress_opt.items()
                    if k != 'max_n_qubits'}
                   if isinstance(compress_opt, dict) else {})
    blocks = utils.compress(circuit, max_k,
                            skip_compression=[FunctionalGate],
                            **compress_kw)

    t0 = _time_mod.time()
    if sub == 'fused' or _use_fused(n_qubits, device, kwargs):
        psi = _evolve_fused(blocks, qubits, qubit_index, initial_state,
                            complex_type, device, kwargs)
    else:
        psi = _evolve_torch(blocks, qubits, qubit_index, initial_state,
                            complex_type, device)
    if kwargs['block_until_ready'] and psi.is_cuda:
        torch.cuda.synchronize(psi.device)
    info['runtime (s)'] = _time_mod.time() - t0

    if kwargs['return_numpy_array']:
        psi = psi.cpu().numpy().astype(complex_type, copy=False)

    return (psi, info) if kwargs['return_info'] else psi


def _use_fused(n_qubits, device, kwargs) -> bool:
    """Auto-select the fused engine: CUDA device, wide register,
    complex64 (the only type reaching here), a precision it runs."""
    from hybridq_tpu_torch.simulation.fused_evolver import MIN_FUSED_QUBITS

    if kwargs.get('fused_engine') is not None:
        return bool(kwargs['fused_engine']) and \
            n_qubits >= MIN_FUSED_QUBITS
    if n_qubits < max(20, MIN_FUSED_QUBITS):
        return False
    if kwargs.get('matmul_precision', 'highest') not in ('highest',
                                                         'high'):
        return False
    return device.type == 'cuda'


def _host_round_trip(payload, psi, qubits):
    """Run a FunctionalGate on the host copy of ``psi``; returns the new
    host array."""
    new_psi, new_order = payload(psi.cpu().numpy(), tuple(qubits))
    if tuple(new_order) != tuple(qubits):
        raise RuntimeError("'order' has changed.")
    return new_psi


def _evolve_torch(blocks, qubits, qubit_index, initial_state, complex_type,
                  device):
    """Per-gate evolution on a complex ``(2,)*n`` tensor; FunctionalGates
    (measure / projection / message) run on the host between runs of
    matrix blocks."""
    from hybridq_tpu_torch.simulation.prepare import prepare_state
    from hybridq_tpu_torch.simulation.statevector import evolve_statevector

    if isinstance(initial_state, str):
        initial_state = prepare_state(initial_state,
                                      complex_type=complex_type)
    psi = torch.as_tensor(np.asarray(initial_state, dtype=complex_type),
                          device=device)
    for kind, payload in _segment_blocks(blocks):
        if kind == 'mat':
            gates = [utils.to_matrix_gate(b, complex_type=complex_type)
                     if len(b) > 1 else b[0] for b in payload]
            psi = evolve_statevector(psi, gates, qubit_index)
        else:
            psi = torch.as_tensor(
                np.asarray(_host_round_trip(payload, psi, qubits),
                           dtype=complex_type), device=device)
    return psi


def _evolve_fused(blocks, qubits, qubit_index, initial_state,
                  complex_type, device, kwargs):
    """Fused engine (``fused_evolver.py``): a cost-model-paired schedule
    of in-place gate kernels."""
    from hybridq_tpu_torch.simulation.fused_evolver import (FusedEvolver,
                                                            MapSim,
                                                            pair_fused_gates)

    n_qubits = len(qubits)
    ev = FusedEvolver(n_qubits,
                      precision=kwargs.get('matmul_precision', 'highest'),
                      device=device)
    if isinstance(initial_state, str):
        state = ev.prepare_state(initial_state)
    else:
        state = ev.pack(np.asarray(initial_state))

    for seg, (kind, payload) in enumerate(_segment_blocks(blocks)):
        if kind == 'mat':
            items = []
            for b in payload:
                g = utils.to_matrix_gate(b, complex_type=complex_type) \
                    if len(b) > 1 else b[0]
                items.append((np.ascontiguousarray(g.matrix()),
                              tuple(qubit_index[q] for q in g.qubits)))
            items = pair_fused_gates(items, n_qubits, MapSim.of(ev))
            # The key names the segment too: after a flush the map is
            # canonical again, and block i of a later segment must not
            # hit block i of an earlier one in the prep memo.
            for i, (U, qs) in enumerate(items):
                state = ev.apply_gate(state, np.asarray(U), tuple(qs),
                                      gate_key=('blk', seg, i))
        else:
            psi = ev.gather(state)
            del state
            state = ev.pack(_host_round_trip(payload, psi, qubits))
    return ev.gather(state, complex_type)


def expectation_value(state, op, qubits_order, complex_type='complex64',
                      backend='torch', verbose: bool = False,
                      **kwargs) -> complex:
    """Expectation value <state| op |state>.

    ``qubits_order`` maps the axes of ``state`` to qubit labels; the
    state is permuted into sorted-qubit order before evolution."""
    from hybridq_tpu_torch.utils import sort

    kwargs['remove_id_gates'] = False
    state = np.asarray(state)
    n_qubits = state.ndim
    qubits_order = list(qubits_order)
    if len(qubits_order) != n_qubits:
        raise ValueError("'qubits_order' must have the same number of "
                         "qubits of 'state'.")
    op = Circuit(op)
    if set(op.all_qubits) - set(qubits_order):
        raise ValueError("'op' has qubits not included in 'qubits_order'.")

    sorted_qubits = sort(qubits_order)
    if sorted_qubits != qubits_order:
        perm = [qubits_order.index(q) for q in sorted_qubits]
        state = np.transpose(state, perm)

    op = op + [Gate('I', qubits=[q])
               for q in set(qubits_order) - set(op.all_qubits)]
    new_state = simulate(op, initial_state=state, optimize='evolution',
                         complex_type=complex_type, backend=backend,
                         verbose=verbose, **kwargs)
    return np.real_if_close(np.sum(np.asarray(new_state) * state.conj()))
