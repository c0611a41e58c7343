"""Engine dispatch + state-vector evolution front-end.

The counterpart of ``hybridq_tpu/simulation/simulation.py`` (its
``:204-240`` for the ``optimize='evolution'`` family):

  * ``'evolution'`` / ``'evolution-tpu'`` / ``'evolution-hybridq'``: the
    native engine.  On a CUDA device with >= 20 qubits in complex64 it is
    the straight engine (``kernels.IndexedEvolver``, one ``apply_bits``
    launch a block paired by ``kernels.pair_matrix_gates``); otherwise one
    ``tensordot`` per gate block on a complex ``(2,)*n`` tensor
    (``statevector``).  ``fused_engine=False`` keeps it off the straight
    engine.
  * ``'evolution-indexed'``: the straight engine at any n.
  * ``'evolution-fused'`` (from ``MIN_FUSED_QUBITS`` qubits; below, a
    ``ValueError``) and ``fused_engine=True`` (from ``MIN_FUSED_QUBITS``
    qubits): the straight engine too, the one state-vector engine of the
    card.  ``info['engine']`` is ``'indexed'``.
  * ``complex_type='complex128'``: the per-gate ``statevector`` path in
    complex128 on the device (JAX sends it to host numpy einsum, the
    reference), except under ``'evolution-fused'``, which runs the f32
    kernels and gathers the result to complex128, as JAX does.
  * ``'evolution-einsum[-<opt>]'``: one ``torch.einsum`` a block.
  * any other ``optimize`` (``'tn'``, or ``(info, tree)`` with a
    ``TensorNetwork`` as ``circuit``): the sliced tensor-network engine
    (``tn/simulate.py``), planned on the host and contracted on the
    device; ``backend='numpy'`` contracts on the host with numpy.
  * ``'evolution-sharded'``: the state split over a mesh of shards
    (``sharded.py``; ``sharded_mode='indexed'``, the default, or
    ``'traced'``; ``devices=`` lists this process's devices, one shard
    each, ``['cuda:0'] * 4`` on one card, ``['cpu'] * 4`` on the host;
    without it every visible card).  ``return_numpy_array=False`` leaves
    the result on the shards' devices, a ``sharded.ShardedState``.
  * ``expectation_value(state, op, qubits_order)``.

``device=None`` means ``'cuda'``, or the first entry of ``devices=`` when
given; without a CUDA device ``simulate`` raises (pass ``device='cpu'``
to run on the host, as the tests do).
"""

from __future__ import annotations

import time as _time_mod
from warnings import warn

import numpy as np
import torch

from hybridq_tpu_torch.circuit import Circuit, utils
from hybridq_tpu_torch.gate import FunctionalGate, Gate, StochasticGate
from hybridq_tpu_torch.simulation._device import resolve_device, span

__all__ = ['simulate', 'expectation_value']

_COMPLEX_TYPES = (np.dtype('complex64'), np.dtype('complex128'))

# The fewest qubits 'evolution-fused' takes, as in the JAX engine.
MIN_FUSED_QUBITS = 14


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
        with span('hq.simplify'):
            circuit = utils.simplify(
                circuit, remove_id_gates=remove_id_gates, atol=atol,
                verbose=verbose,
                **(simplify if isinstance(simplify, dict) else {}))
    if circuit and circuit.all_qubits != qubits:
        raise ValueError("Active qubits have changed after simplification. "
                         "Forcing stop.")
    return circuit, qubits, initial_state, final_state


def simulate(circuit, initial_state=None, final_state=None,
             optimize='evolution', backend='torch',
             complex_type='complex64', tensor_only: bool = False,
             simplify=True, remove_id_gates: bool = True, use_mpi=None,
             atol: float = 1e-8, verbose: bool = False, device=None,
             **kwargs):
    """Simulate a circuit by state-vector evolution or tensor-network
    contraction (see the module docstring).  Evolution returns a numpy
    array by default, or the torch tensor on ``device`` with
    ``return_numpy_array=False``; the TN engine returns a numpy array,
    or ``(net, (info, tree))`` with ``tensor_only=True``.  With
    ``profile_dir=d`` the whole call runs under ``torch.profiler`` (the
    card's activity too on a CUDA device) and writes a Chrome trace into
    ``d``, as the JAX package writes a ``jax.profiler`` trace there.
    While a profiler records, the call is the span ``hq.simulate`` and
    its parts are spans inside it (``_device.span``; PERF.md lists
    them)."""
    kwargs.setdefault('allow_sampling', False)
    kwargs.setdefault('sampling_seed', None)

    evolution = isinstance(optimize, str) and 'evolution' in optimize
    if tensor_only and evolution:
        raise ValueError(
            f"'tensor_only' is not supported for optimize={optimize}")
    if np.dtype(complex_type) not in _COMPLEX_TYPES:
        raise ValueError(f"complex_type must be complex64 or complex128, "
                         f"got {complex_type}")
    if device is None and kwargs.get('devices'):
        device = list(kwargs['devices'])[0]
    if evolution or backend != 'numpy':
        device = resolve_device(device)

    profile_dir = kwargs.pop('profile_dir', None)
    if profile_dir:
        from hybridq_tpu_torch.simulation._device import profiled

        with profiled(profile_dir, device):
            return simulate(circuit, initial_state=initial_state,
                            final_state=final_state, optimize=optimize,
                            backend=backend, complex_type=complex_type,
                            tensor_only=tensor_only, simplify=simplify,
                            remove_id_gates=remove_id_gates,
                            use_mpi=use_mpi, atol=atol, verbose=verbose,
                            device=device, **kwargs)

    with span('hq.simulate'):
        from hybridq_tpu_torch.simulation.tn.network import TensorNetwork
        if not isinstance(circuit, TensorNetwork):
            with span('hq.preprocess'):
                circuit, qubits, initial_state, final_state = \
                    _preprocess_circuit(
                        circuit, initial_state, final_state, simplify,
                        remove_id_gates, atol, verbose,
                        kwargs['allow_sampling'], kwargs['sampling_seed'])
        elif evolution:
            raise ValueError("a TensorNetwork needs optimize=(info, tree) "
                             "or (info, ContractionPlan), not an evolution "
                             "engine")

        if not evolution:
            # Tensor-network contraction (host planning, contraction on
            # ``device``; ``backend='numpy'`` runs the plain executor).
            from hybridq_tpu_torch.simulation.tn import simulate_tn
            kwargs.setdefault('compress', 2)
            return simulate_tn(circuit, initial_state, final_state, optimize,
                               backend, complex_type, tensor_only, verbose,
                               device=device, **kwargs)

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


def _segment_blocks(blocks, matrices):
    """Group compressed blocks into maximal runs of matrix gates, keeping
    FunctionalGates as singleton separators; ``matrices`` are the blocks'
    from ``utils._compress``."""
    # list of ('mat', [blocks], [matrices]) | ('fun', gate, None)
    segments = []
    current, mats = [], []
    for block, M in zip(blocks, matrices):
        if any(isinstance(g, FunctionalGate) for g in block):
            assert len(block) == 1
            if current:
                segments.append(('mat', current, mats))
                current, mats = [], []
            segments.append(('fun', block[0], None))
        else:
            current.append(block)
            mats.append(M)
    if current:
        segments.append(('mat', current, mats))
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
    if sub not in ('tpu', 'fused', 'indexed', 'sharded') and \
            sub.split('-')[0] != 'einsum':
        raise ValueError(f"optimize='evolution-{sub}' not implemented.")

    complex_type = np.dtype(complex_type)
    if sub == 'sharded':
        t0 = _time_mod.time()
        psi = _evolve_sharded(circuit, qubits, initial_state, complex_type,
                              device, kwargs)
        info.update({'engine': 'sharded',
                     'runtime (s)': _time_mod.time() - t0})
        if kwargs['return_numpy_array']:
            psi = psi.astype(complex_type, copy=False)
        return (psi, info) if kwargs['return_info'] else psi

    # Compress into k-qubit blocks, never merging FunctionalGates.
    compress_opt = kwargs['compress']
    max_k = compress_opt['max_n_qubits'] if isinstance(compress_opt, dict) \
        else compress_opt
    compress_kw = ({k: v for k, v in compress_opt.items()
                    if k != 'max_n_qubits'}
                   if isinstance(compress_opt, dict) else {})
    with span('hq.compress'):
        blocks, matrices = utils._compress(circuit, max_k,
                                           skip_compression=[FunctionalGate],
                                           **compress_kw)

    engine = _engine(sub, n_qubits, complex_type, device, kwargs)
    info['engine'] = engine
    evolve = {'indexed': _evolve_indexed, 'torch': _evolve_torch,
              'einsum': _evolve_einsum}[engine]
    t0 = _time_mod.time()
    psi = evolve(blocks, matrices, qubits, qubit_index, initial_state,
                 complex_type, device, kwargs)
    if kwargs['block_until_ready'] and device.type == 'cuda':
        with span('hq.sync'):
            torch.cuda.synchronize(device)
    info['runtime (s)'] = _time_mod.time() - t0

    if kwargs['return_numpy_array'] and isinstance(psi, torch.Tensor):
        psi = psi.cpu().numpy()
    if kwargs['return_numpy_array']:
        psi = psi.astype(complex_type, copy=False)

    return (psi, info) if kwargs['return_info'] else psi


def _engine(sub, n_qubits, complex_type, device, kwargs) -> str:
    """'indexed', 'einsum' or 'torch' (the per-gate ``statevector``
    path) for ``optimize='evolution-<sub>'``; see the module
    docstring."""
    if sub == 'fused':
        if n_qubits < MIN_FUSED_QUBITS:
            raise ValueError(f"optimize='evolution-fused' needs n >= "
                             f"{MIN_FUSED_QUBITS} qubits, got {n_qubits}")
        return 'indexed'
    if sub.split('-')[0] == 'einsum':
        return 'einsum'
    if complex_type == np.dtype('complex128'):
        return 'torch'
    fused = kwargs.get('fused_engine')
    if sub == 'indexed' or (fused and n_qubits >= MIN_FUSED_QUBITS):
        return 'indexed'
    if fused is None and device.type == 'cuda' and n_qubits >= 20 and \
            kwargs.get('matmul_precision', 'highest') in ('highest',
                                                          'high'):
        return 'indexed'
    return 'torch'


def _evolve_sharded(circuit, qubits, initial_state, complex_type, device,
                    kwargs):
    """The sharded engines (``sharded.py``) over ``devices=`` (``None``:
    this process's card in a process group, else every visible card, or
    the host when ``device`` is the CPU).  ``sharded_mode='indexed'``
    (default) runs gate by gate with Measure/Projection on the shards;
    ``'traced'`` plans the whole circuit first.  Returns the gathered
    host state, or with ``return_numpy_array=False`` the state left on
    the shards (``ShardedState``); ``block_until_ready`` waits for every
    device of the mesh."""
    from hybridq_tpu_torch.simulation.sharded import (ShardedEvolver,
                                                      ShardedIndexedEvolver)

    mode = kwargs.get('sharded_mode') or 'indexed'
    cls = ShardedIndexedEvolver if mode == 'indexed' else ShardedEvolver
    devices = kwargs.get('devices')
    if devices is None and device.type == 'cpu':
        devices = [device]
    ev = cls(n_qubits=len(qubits), devices=devices,
             complex_type=complex_type,
             compress=kwargs.get('compress', 2) or 2)
    with span('hq.prepare_state'):
        if isinstance(initial_state, str):
            psi = ev.prepare_state(initial_state)
        else:
            psi = ev.scatter_state(
                np.asarray(initial_state, dtype=complex_type))
    state = ev.state(ev.evolve(psi, circuit, qubits=qubits))
    if kwargs['block_until_ready']:
        with span('hq.sync'):
            state.synchronize()
    if kwargs['return_numpy_array']:
        return state.gather()
    return state


def _host_round_trip(payload, psi, qubits):
    """Run a FunctionalGate on the host copy of ``psi`` (a tensor or a
    host array); returns the new host array."""
    if isinstance(psi, torch.Tensor):
        psi = psi.cpu().numpy()
    new_psi, new_order = payload(psi, tuple(qubits))
    if tuple(new_order) != tuple(qubits):
        raise RuntimeError("'order' has changed.")
    return new_psi


def _evolve_torch(blocks, matrices, qubits, qubit_index, initial_state,
                  complex_type, device, kwargs):
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
    for kind, payload, mats in _segment_blocks(blocks, matrices):
        if kind == 'mat':
            gates = [utils._block_gate(b, M, complex_type)
                     for b, M in zip(payload, mats)]
            psi = evolve_statevector(psi, gates, qubit_index)
        else:
            psi = torch.as_tensor(
                np.asarray(_host_round_trip(payload, psi, qubits),
                           dtype=complex_type), device=device)
    return psi


def _evolve_einsum(blocks, matrices, qubits, qubit_index, initial_state,
                   complex_type, device, kwargs):
    """``'evolution-einsum[-<opt>]'``: one ``torch.einsum`` a compressed
    block on a complex ``(2,)*n`` tensor, with subscripts built by hand
    as the JAX engine builds them (``hybridq_tpu/simulation/
    simulation.py:463-522``): the state's axes are labels ``0..n-1``,
    the block's new axes ``n..n+k-1``.  ``<opt>`` names opt_einsum's
    optimizer there; a product of two operands has one order, so it is
    accepted and unused.  TF32 is off inside, as JAX forces 'highest'.
    FunctionalGates run on the host between runs of matrix blocks."""
    from hybridq_tpu_torch.simulation._device import full_precision_matmul
    from hybridq_tpu_torch.simulation.prepare import prepare_state

    n = len(qubits)
    segments = [(kind, payload if kind == 'fun' else [
        utils._block_gate(b, M, complex_type) for b, M in zip(payload, mats)])
        for kind, payload, mats in _segment_blocks(blocks, matrices)]
    k = max((len(g.qubits) for kind, gates in segments if kind == 'mat'
             for g in gates), default=0)
    if n + k > 52:
        raise ValueError(
            f"'evolution-einsum' needs n + k = {n + k} einsum labels for "
            f"blocks of k = {k} qubits on n = {n}; torch.einsum takes at "
            "most 52")
    if isinstance(initial_state, str):
        initial_state = prepare_state(initial_state,
                                      complex_type=complex_type)
    psi = torch.as_tensor(np.asarray(initial_state, dtype=complex_type),
                          device=device)
    state = list(range(n))
    with full_precision_matmul():
        for kind, payload in segments:
            if kind == 'fun':
                psi = torch.as_tensor(
                    np.asarray(_host_round_trip(payload, psi, qubits),
                               dtype=complex_type), device=device)
                continue
            for g in payload:
                axes = [qubit_index[q] for q in g.qubits]
                k = len(axes)
                U = torch.as_tensor(
                    np.reshape(np.asarray(g.matrix(), dtype=complex_type),
                               (2,) * (2 * k)), device=device)
                new = list(range(n, n + k))
                out = list(state)
                for j, a in enumerate(axes):
                    out[a] = n + j
                psi = torch.einsum(U, new + axes, psi, state, out)
    return psi


def _block_items(payload, complex_type, qubit_index, matrices=None):
    """``[(U, dense qubit indices), ...]`` of a run of compressed blocks
    and their ``matrices`` from ``utils._compress`` (``None``: build
    each)."""
    items = []
    with span('hq.block_matrices'):
        for b, M in zip(payload, matrices or [None] * len(payload)):
            g = utils._block_gate(b, M, complex_type)
            items.append((np.ascontiguousarray(g.matrix()),
                          tuple(qubit_index[q] for q in g.qubits)))
    return items


def _evolve_indexed(blocks, matrices, qubits, qubit_index, initial_state,
                    complex_type, device, kwargs):
    """Straight engine (``kernels.IndexedEvolver``): blocks paired by
    ``pair_matrix_gates``, one ``apply_bits`` launch each, the state in
    canonical order throughout.  Device memory holds one container: the
    input is dropped once packed, and with ``return_numpy_array`` the
    result goes to the host a chunk at a time (``gather_host``)."""
    from hybridq_tpu_torch.simulation.kernels import (IndexedEvolver,
                                                      pair_matrix_gates)

    n_qubits = len(qubits)
    ev = IndexedEvolver(n_qubits,
                        precision=kwargs.get('matmul_precision', 'highest'),
                        device=device)
    with span('hq.prepare_state'):
        if isinstance(initial_state, str):
            state = ev.prepare_state(initial_state)
        else:
            state = ev.pack(np.asarray(initial_state))
    del initial_state

    for kind, payload, mats in _segment_blocks(blocks, matrices):
        if kind == 'mat':
            items = _block_items(payload, complex_type, qubit_index, mats)
            with span('hq.pair'):
                items = pair_matrix_gates(items, n_qubits)
            # one stacked upload per block size, then one launch a block
            for U, (_, qs) in zip(ev.preload([U for U, _ in items]), items):
                state = ev.apply_gate(state, U, qs)
        else:
            psi = ev.gather_host(state)
            del state
            psi = _host_round_trip(payload, psi, qubits)
            state = ev.pack(psi)
            del psi
    if kwargs['return_numpy_array']:
        with span('hq.gather_host'):
            return ev.gather_host(state, complex_type)
    with span('hq.gather'):
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
