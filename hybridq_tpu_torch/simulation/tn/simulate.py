"""Tensor-network simulation front-end.

A copy of ``hybridq_tpu/simulation/tn/simulate.py`` whose contraction
runs on a torch device (``backend='torch'``, on ``device``; ``None``
means ``'cuda'``) or on the plain numpy executor (``backend='numpy'``).
Mirrors the reference ``_simulate_tn`` (``simulation.py:784-1122``):
compress(2) → build network with boundary tokens → simplify → path search
→ slice → contract, with the two-phase ``tensor_only=True`` plan
checkpointing (returns ``(TensorNetwork, (PathInfo, tree))`` that can be
passed back as ``circuit=``/``optimize=``).
"""

from __future__ import annotations

import sys
import time
from string import ascii_letters

import numpy as np

from hybridq_tpu_torch.circuit import Circuit, utils
from hybridq_tpu_torch.simulation._device import span
from hybridq_tpu_torch.simulation.tn.contract import (ContractionPlan,
                                                      SlicedContractor)
from hybridq_tpu_torch.simulation.tn.network import (TensorNetwork,
                                                     build_tn)
from hybridq_tpu_torch.simulation.tn.path import (PathInfo, anneal,
                                                  find_path, reconfigure)
from hybridq_tpu_torch.simulation.tn.slicer import slice_and_reconfigure

__all__ = ['simulate_tn', 'make_plan']


def simulate_tn(circuit, initial_state, final_state, optimize, backend,
                complex_type, tensor_only: bool, verbose: bool, **kwargs):
    """Contract a circuit (or a prebuilt network) as a sliced tensor
    network."""
    kwargs.setdefault('simplify_tn', True)
    kwargs.setdefault('max_iterations', 1)
    kwargs.setdefault('methods', ['greedy', 'bisection'])
    kwargs.setdefault('max_time', 120)
    kwargs.setdefault('max_repeats', 16)
    kwargs.setdefault('minimize', 'combo')
    kwargs.setdefault('target_largest_intermediate', 0)
    kwargs.setdefault('max_largest_intermediate', 2**26)
    kwargs.setdefault('temperatures', [1.0, 0.1, 0.01])
    kwargs.setdefault('parallel', None)
    kwargs.setdefault('max_n_slices', None)
    kwargs.setdefault('return_info', False)
    kwargs.setdefault('devices', None)
    kwargs.setdefault('slice_range', None)
    kwargs.setdefault('device', None)

    info_dict = {}
    if optimize == 'tn':
        optimize = 'cotengra'

    if isinstance(circuit, Circuit):
        qubits = circuit.all_qubits
        n_qubits = len(qubits)
        initial_state = '.' * n_qubits if initial_state is None else \
            initial_state
        final_state = '.' * n_qubits if final_state is None else final_state

        for state, sname in ((initial_state, 'initial_state'),
                             (final_state, 'final_state')):
            if not isinstance(state, str):
                raise ValueError(f"'{sname}' must be a valid string.")
            if set(state) - set('01+-.' + ascii_letters):
                raise ValueError(f"'{sname}' contains invalid symbols.")
            if len(state) != n_qubits:
                raise ValueError(
                    f"'{sname}' has the wrong number of qubits "
                    f"(expected {n_qubits}, got {len(state)})")

        if 2**(initial_state.count('.') + final_state.count('.')) > \
                kwargs['max_largest_intermediate']:
            raise MemoryError(
                "Memory for the given number of open qubits exceeds the "
                "'max_largest_intermediate'.")

        # Compress into 2-qubit blocks (reference default for TN).
        # ``simplify_tn='full'`` skips compression: merging 1-qubit
        # gates into their couplers destroys exactly the diagonal /
        # crossed-wire structure the hyperedge simplification extracts
        # (FSIM(θ=π/2) → one 2×2 tensor, CZ → phase hyperedge).
        compress = 0 if kwargs['simplify_tn'] == 'full' else \
            kwargs.get('compress', 2)
        if compress:
            max_k = compress['max_n_qubits'] if isinstance(
                compress, dict) else compress
            blocks = utils.compress(
                circuit, max_k,
                **({k: v for k, v in compress.items()
                    if k != 'max_n_qubits'}
                   if isinstance(compress, dict) else {}))
            circuit = Circuit(
                utils.to_matrix_gate(c, complex_type=complex_type)
                for c in blocks)

        net, output_order = build_tn(circuit, initial_state, final_state,
                                     complex_type=complex_type,
                                     simplify=kwargs['simplify_tn'])

        # Path search (host CPU combinatorics).
        t0 = time.time()
        inputs = [t.inds for t in net.tensors]
        size_dict = {}
        for t in net.tensors:
            for i, d in zip(t.inds, t.data.shape):
                size_dict[i] = d
        tree = find_path(inputs, output_order, size_dict,
                         methods=kwargs['methods'],
                         max_repeats=kwargs['max_repeats'],
                         minimize=kwargs['minimize'],
                         parallel=kwargs['parallel'], verbose=verbose)
        # Restructure: simulated annealing (native) drives most of the
        # quality; exact subtree reconfiguration polishes locally.
        budget = max(5.0, float(kwargs['max_time']) / 2)
        tree = anneal(tree, time_budget=0.6 * budget, verbose=verbose)
        tree = reconfigure(tree, time_budget=0.4 * budget,
                           verbose=verbose)
        info = PathInfo(tree)
        if verbose:
            print(f'# Path search: {time.time()-t0:.2f}s, {info}',
                  file=sys.stderr)

        if tensor_only:
            return net, (info, tree)
    else:
        # Prebuilt network (two-phase reuse).
        if isinstance(circuit, TensorNetwork):
            net = circuit
        else:
            raise ValueError(f"'{type(circuit).__name__}' not supported.")
        try:
            info, tree = optimize
        except (TypeError, ValueError):
            raise ValueError(
                "When passing a TensorNetwork, 'optimize' must be the "
                "(PathInfo, tree) pair returned by tensor_only=True, or "
                "a (PathInfo, ContractionPlan) pair (pre-sliced).")
        # The tree records the open legs in build order (count-based
        # outer-index detection breaks once hyperedges exist).
        try:
            output_order = list(
                (tree if not isinstance(tree, ContractionPlan)
                 else tree.tree).output)
        except (TypeError, ValueError, AttributeError):
            from hybridq_tpu_torch.utils import sort
            outer = net.outer_inds
            i_inds = sort([x for x in outer if x.endswith('_i')],
                          key=lambda x: int(x.split('_')[-2]))
            f_inds = sort([x for x in outer if x.endswith('_f')],
                          key=lambda x: int(x.split('_')[-2]))
            output_order = i_inds + f_inds
        if not isinstance(tree, ContractionPlan):
            # Slice-aware reconfiguration mutates the tree; never mutate
            # a user-held plan (repeated calls must see their own fresh
            # slicing).
            import copy as _copy
            tree = _copy.deepcopy(tree)

    with span('hq.tn.plan'):
        if isinstance(tree, ContractionPlan):
            # Pre-sliced plan (e.g. broadcast to every process so that
            # slice_range partial sums are consistent, the analog of the
            # reference's rank-0 SlicedContractor bcast,
            # ``simulation_mpi.py:451``): use it verbatim.
            tree, sliced = tree.tree, tree.sliced_set
            from hybridq_tpu_torch.simulation.tn.slicer import SliceCost
            cost = SliceCost(tree, frozenset(sliced))
            info = PathInfo(tree)
        else:
            # Slice to fit memory, re-optimizing the tree under the slicing
            # (slice-and-reconfigure alternation).
            budget = max(5.0, float(kwargs['max_time']) / 4)
            tree, sliced, cost = slice_and_reconfigure(
                tree, target_size=kwargs['max_largest_intermediate'],
                time_budget=budget, verbose=verbose)
        plan = ContractionPlan(tree, sliced)
    info_dict.update({
        'flops': info.opt_cost,
        'largest_intermediate': info.largest_intermediate,
        'n_slices': cost.nslices,
        'total_flops': cost.total_flops,
    })
    if verbose:
        print(f"# Slices: {cost.nslices} "
              f"(max size 2^{np.log2(max(cost.max_size, 1)):.1f}, "
              f"total flops 2^{np.log2(max(cost.total_flops, 1)):.1f})",
              file=sys.stderr)
    if kwargs['max_n_slices'] and cost.nslices > kwargs['max_n_slices']:
        raise RuntimeError(
            f"Too many slices ({cost.nslices} > {kwargs['max_n_slices']})")

    with span('hq.tn.contractor'):
        sc = SlicedContractor(plan, net.tensors, output_order,
                              complex_type=complex_type)
    t0 = time.time()
    out = sc.contract(backend=backend, devices=kwargs['devices'],
                      device=kwargs['device'], verbose=verbose,
                      slice_range=kwargs['slice_range'])
    info_dict['runtime (s)'] = time.time() - t0

    if kwargs['return_info']:
        return out, info_dict
    return out


def make_plan(optimize, target_size, time_budget: float = 30.0,
              verbose: bool = False):
    """Slice a ``tensor_only=True`` result into a concrete, reusable
    ``(PathInfo, ContractionPlan)`` pair.

    Passing the returned pair as ``optimize=`` to ``simulate`` makes
    every call (or every process, with ``slice_range=``) use the
    identical slicing — the analog of the reference broadcasting rank
    0's ``SlicedContractor`` (``simulation_mpi.py:451``).
    """
    import copy as _copy

    info, tree = optimize
    if isinstance(tree, ContractionPlan):
        return info, tree
    tree = _copy.deepcopy(tree)
    tree, sliced, _ = slice_and_reconfigure(
        tree, target_size=target_size, time_budget=time_budget,
        verbose=verbose)
    return PathInfo(tree), ContractionPlan(tree, sliced)
