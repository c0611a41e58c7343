"""Tensor-network representation of circuits.

The reference delegates to quimb (``hybridq/circuit/utils.py:324-417``,
``simulation.py:873-917``); quimb is not available, so this is a host
copy of ``hybridq_tpu/simulation/tn/network.py``, a small self-contained
TN layer: named indices, circuit →
network construction with initial/final state boundary tensors, and
rank-simplification (absorb low-rank tensors) replacing quimb's
``full_simplify('RC')``.

All indices are dimension-2 (qubit legs); index names follow the
reference convention ``{prefix}_{qubit_index}_{tag}`` with tags ``i``
(initial leg), ``f`` (final leg), or the gate position.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from string import ascii_letters
from typing import Dict, List, Tuple

import numpy as np

from hybridq_tpu_torch.circuit import Circuit
from hybridq_tpu_torch.utils import sort

__all__ = ['Tensor', 'TensorNetwork', 'circuit_to_tn', 'build_tn']

_MPS = {
    '0': np.array([1.0, 0.0]),
    '1': np.array([0.0, 1.0]),
    '+': np.array([1.0, 1.0]) / np.sqrt(2),
    '-': np.array([1.0, -1.0]) / np.sqrt(2),
}


@dataclasses.dataclass
class Tensor:
    """A dense tensor with named indices."""
    data: np.ndarray
    inds: Tuple[str, ...]

    def __post_init__(self):
        self.data = np.asarray(self.data)
        self.inds = tuple(self.inds)
        if self.data.ndim != len(self.inds):
            raise ValueError("indices inconsistent with data rank")

    @property
    def rank(self) -> int:
        return len(self.inds)

    def reindex(self, mapping: Dict[str, str]) -> 'Tensor':
        return Tensor(self.data, tuple(mapping.get(i, i)
                                       for i in self.inds))


def _contract_pair(a: Tensor, b: Tensor, keep: set) -> Tensor:
    """Contract two tensors over shared indices not in ``keep``.

    Hyperedge-aware: a shared index in ``keep`` (it appears in a third
    tensor, or is an outer leg) is *batched* — retained once in the
    result — instead of summed (einsum diagonal semantics, matching
    quimb's hyper-index contraction)."""
    shared = [i for i in a.inds if i in b.inds]
    summed = [i for i in shared if i not in keep]
    batch = [i for i in shared if i in keep]
    if not batch:
        a_axes = [a.inds.index(i) for i in summed]
        b_axes = [b.inds.index(i) for i in summed]
        data = np.tensordot(a.data, b.data, axes=(a_axes, b_axes))
        inds = tuple(i for i in a.inds if i not in summed) + tuple(
            i for i in b.inds if i not in summed)
        return Tensor(data, inds)
    # einsum integer-label form (no 52-symbol limit).
    labels = {i: k for k, i in enumerate(
        dict.fromkeys(a.inds + b.inds))}
    out_inds = tuple(i for i in a.inds if i not in summed) + tuple(
        i for i in b.inds if i not in summed and i not in batch)
    data = np.einsum(a.data, [labels[i] for i in a.inds],
                     b.data, [labels[i] for i in b.inds],
                     [labels[i] for i in out_inds])
    return Tensor(data, out_inds)


def _self_diagonal(t: Tensor) -> Tensor:
    """Collapse indices repeated WITHIN one tensor (einsum diagonal)."""
    if len(set(t.inds)) == len(t.inds):
        return t
    labels = {}
    for i in t.inds:
        if i not in labels:
            labels[i] = len(labels)
    out_inds = tuple(dict.fromkeys(t.inds))
    data = np.einsum(t.data, [labels[i] for i in t.inds],
                     [labels[i] for i in out_inds])
    return Tensor(data, out_inds)


class TensorNetwork:
    """A list of tensors plus designated open (outer) indices."""

    def __init__(self, tensors: List[Tensor]):
        self.tensors = list(tensors)

    @property
    def outer_inds(self) -> List[str]:
        """Indices appearing exactly once."""
        count = defaultdict(int)
        for t in self.tensors:
            for i in t.inds:
                count[i] += 1
        return [i for i, c in count.items() if c == 1]

    def copy(self) -> 'TensorNetwork':
        return TensorNetwork([Tensor(t.data, t.inds)
                              for t in self.tensors])

    def simplify(self, max_rank: int = 4,
                 protected=()) -> 'TensorNetwork':
        """Absorb every tensor of rank ≤ 2 into a neighbor when this does
        not grow the neighbor's rank (replacement for quimb's
        rank-simplify).  Hyperedge-aware: an index shared with a third
        tensor is batched, not summed.  ``protected`` names open legs
        that must survive (count-1 detection breaks once hyperedges
        exist).  Runs until fixpoint."""
        outer = set(self.outer_inds) | set(protected)
        tensors = list(self.tensors)
        changed = True
        while changed:
            changed = False
            # index -> tensor positions
            where = defaultdict(list)
            for pos, t in enumerate(tensors):
                if t is None:
                    continue
                for i in t.inds:
                    where[i].append(pos)
            for pos, t in enumerate(tensors):
                if t is None or t.rank > 2:
                    continue
                # find a neighbor sharing an index
                neigh = None
                for i in t.inds:
                    if i in outer:
                        continue
                    for p in where[i]:
                        if p != pos and tensors[p] is not None:
                            neigh = p
                            break
                    if neigh is not None:
                        break
                if neigh is None:
                    continue
                # Batch (retain) any shared index that also appears in a
                # third tensor or is an outer leg.
                keep = outer | {
                    i for i in t.inds
                    if sum(1 for p in where[i]
                           if tensors[p] is not None) > 2}
                merged = _contract_pair(tensors[neigh], t, keep)
                if merged.rank > max(tensors[neigh].rank, max_rank):
                    continue
                tensors[neigh] = merged
                tensors[pos] = None
                changed = True
                # rebuild adjacency lazily
                where = defaultdict(list)
                for p2, t2 in enumerate(tensors):
                    if t2 is None:
                        continue
                    for i in t2.inds:
                        where[i].append(p2)
        self.tensors = [t for t in tensors if t is not None]
        # scalar tensors (rank 0) fold into the first tensor
        scalars = [t for t in self.tensors if t.rank == 0]
        if scalars and len(self.tensors) > len(scalars):
            rest = [t for t in self.tensors if t.rank > 0]
            factor = np.prod([t.data for t in scalars])
            rest[0] = Tensor(rest[0].data * factor, rest[0].inds)
            self.tensors = rest
        return self

    def diagonal_reduce(self, tol: float = 1e-10,
                        protected=()) -> 'TensorNetwork':
        """Merge index pairs over which a tensor is diagonal into ONE
        index (a hyperedge), replacing the tensor by its diagonal —
        quimb's ``diagonal_reduce``.  This is what turns each
        supremacy-pattern FSIM(θ=π/2, φ) coupler
        (``hybridq/extras/random.py`` workloads) into a single 2×2
        tensor on crossed wires: the gate is δ(a_out,b_in) δ(b_out,a_in)
        p(a_out,b_out), i.e. diagonal over BOTH cross pairs, and CZ /
        CPHASE / T-like gates into wire-attached phase vectors.  The
        executor and tree search batch hyperedge indices natively.

        ``tol`` is relative to the tensor's max magnitude; entries are
        compared, never zeroed (the diagonal is extracted exactly).
        """
        protected = set(protected)
        tensors = [_self_diagonal(t) for t in self.tensors]
        changed = True
        while changed:
            changed = False
            # Open legs move as merges rename indices: recompute.
            count = defaultdict(int)
            for t in tensors:
                for i in t.inds:
                    count[i] += 1
            outer = {i for i, c in count.items() if c == 1} | protected
            for pos, t in enumerate(tensors):
                if t.rank < 2:
                    continue
                scale = float(np.abs(t.data).max()) or 1.0
                pair = None
                for a1 in range(t.rank):
                    for a2 in range(a1 + 1, t.rank):
                        i, j = t.inds[a1], t.inds[a2]
                        if t.data.shape[a1] != t.data.shape[a2]:
                            continue
                        if i in outer and j in outer:
                            continue  # cannot merge two open legs
                        d = np.moveaxis(t.data, (a1, a2), (0, 1))
                        off = d.copy()
                        k = np.arange(d.shape[0])
                        off[k, k] = 0
                        if np.abs(off).max() <= tol * scale:
                            pair = (a1, a2)
                            break
                    if pair:
                        break
                if not pair:
                    continue
                a1, a2 = pair
                i, j = t.inds[a1], t.inds[a2]
                # Merge toward the outer name so open legs keep theirs.
                src, dst = (i, j) if j in outer else (j, i)
                data = np.diagonal(t.data, axis1=a1, axis2=a2)
                inds = tuple(x for k2, x in enumerate(t.inds)
                             if k2 not in (a1, a2)) + (dst,)
                tensors[pos] = Tensor(data, inds)
                if src != dst:
                    for p2, t2 in enumerate(tensors):
                        if p2 != pos and src in t2.inds:
                            tensors[p2] = _self_diagonal(
                                t2.reindex({src: dst}))
                changed = True
                break  # openness changed: recompute counts
        # Drop trivial all-ones factors left by identity-wire merges
        # when the sum over their index still happens without them
        # (>= 2 other holders), or the leg is protected-open anyway.
        count = defaultdict(int)
        for t in tensors:
            for i in t.inds:
                count[i] += 1
        kept = []
        for t in tensors:
            if (t.rank == 1 and np.issubdtype(t.data.dtype, np.number)
                    and t.data.shape[0] > 0
                    and np.allclose(t.data, 1.0, atol=tol)
                    and (count[t.inds[0]] >= 3
                         or (t.inds[0] in protected
                             and count[t.inds[0]] >= 2))):
                count[t.inds[0]] -= 1
                continue
            kept.append(t)
        self.tensors = kept
        return self

    def full_simplify(self, max_rank: int = 4, tol: float = 1e-10,
                      protected=()) -> 'TensorNetwork':
        """Alternate diagonal reduction and rank simplification to a
        fixpoint (the load-bearing subset of quimb's
        ``full_simplify('ADCRS')`` for circuit networks)."""
        while True:
            n_before = len(self.tensors)
            inds_before = sum(t.rank for t in self.tensors)
            self.diagonal_reduce(tol=tol, protected=protected)
            self.simplify(max_rank=max_rank, protected=protected)
            if len(self.tensors) == n_before and \
                    sum(t.rank for t in self.tensors) == inds_before:
                return self

    def astype(self, dtype) -> 'TensorNetwork':
        self.tensors = [Tensor(t.data.astype(dtype), t.inds)
                        for t in self.tensors]
        return self

    def __len__(self):
        return len(self.tensors)


def circuit_to_tn(circuit, complex_type='complex64',
                  return_qubits_map: bool = False,
                  leaves_prefix: str = 'q_'):
    """Circuit → TensorNetwork, reference index conventions
    (``hybridq/circuit/utils.py:324-417``)."""
    circuit = Circuit(circuit)
    all_qubits = circuit.all_qubits
    qubits_map = {q: i for i, q in enumerate(all_qubits)}
    last_tag = {q: 'i' for q in all_qubits}

    tensors = []
    for t, gate in enumerate(circuit):
        U = np.reshape(gate.matrix().astype(complex_type),
                       (2,) * (2 * len(gate.qubits)))
        inds = [f'{leaves_prefix}_{qubits_map[q]}_{t}'
                for q in gate.qubits]
        inds += [f'{leaves_prefix}_{qubits_map[q]}_{last_tag[q]}'
                 for q in gate.qubits]
        for q in gate.qubits:
            last_tag[q] = t
        tensors.append(Tensor(U, tuple(inds)))

    out_map = {
        f'{leaves_prefix}_{qubits_map[q]}_{t}':
        f'{leaves_prefix}_{qubits_map[q]}_f' for q, t in last_tag.items()
    }
    tensors = [t.reindex(out_map) for t in tensors]
    net = TensorNetwork(tensors)
    return (net, qubits_map) if return_qubits_map else net


def build_tn(circuit, initial_state: str, final_state: str,
             complex_type='complex64', leaves_prefix: str = 'q_',
             simplify=True):
    """Build the full network with boundary tensors attached.

    Tokens: '0','1','+','-' attach product-state vectors; '.' leaves the
    leg open; any ascii letter traces together all legs sharing that
    letter (reference ``simulation.py:879-917``).

    ``simplify``: False = raw network; True = rank simplification;
    ``'full'`` = diagonal reduction (FSIM/CZ → hyperedge tensors) +
    rank simplification to a fixpoint — the quimb ``full_simplify``
    analog; feed the *uncompressed* circuit for best effect (2-qubit
    block compression destroys the diagonal structure).

    Simplification runs in complex128 regardless of ``complex_type``
    (diagonality tests and 2×2 chain products stay exact); the result
    is cast to ``complex_type`` at the end."""
    circuit = Circuit(circuit)
    qubits = circuit.all_qubits
    build_type = 'complex128' if simplify else complex_type
    net, qmap = circuit_to_tn(circuit, complex_type=build_type,
                              return_qubits_map=True,
                              leaves_prefix=leaves_prefix)

    for state, ext in ((initial_state, 'i'), (final_state, 'f')):
        for s, q in zip(state, qubits):
            if s in _MPS:
                ind = f'{leaves_prefix}_{qmap[q]}_{ext}'
                net.tensors.append(
                    Tensor(_MPS[s].astype(build_type), (ind,)))

    for x in set(initial_state + final_state) - set('01+-.'):
        if x not in ascii_letters:
            raise ValueError(f"Invalid state token '{x}'.")
        inds = [f'{leaves_prefix}_{qmap[q]}_i'
                for s, q in zip(initial_state, qubits) if s == x]
        inds += [f'{leaves_prefix}_{qmap[q]}_f'
                 for s, q in zip(final_state, qubits) if s == x]
        tr = np.reshape([1] + [0] * (2**len(inds) - 2) + [1],
                        (2,) * len(inds))
        net.tensors.append(Tensor(tr.astype(build_type), tuple(inds)))

    # Open legs by token ('.'), by NAME: once hyperedges exist, an open
    # leg may legitimately appear in several tensors, so appears-once
    # detection cannot identify the output.
    open_inds = [f'{leaves_prefix}_{qmap[q]}_i'
                 for s, q in zip(initial_state, qubits) if s == '.']
    open_inds += [f'{leaves_prefix}_{qmap[q]}_f'
                  for s, q in zip(final_state, qubits) if s == '.']

    if simplify == 'full':
        net.full_simplify(protected=open_inds)
    elif simplify:
        net.simplify(protected=open_inds)
    net.astype(complex_type)

    # Output order: sorted initial legs then sorted final legs.
    i_inds = sort([x for x in open_inds if x.endswith('_i')],
                  key=lambda x: int(x.split('_')[-2]))
    f_inds = sort([x for x in open_inds if x.endswith('_f')],
                  key=lambda x: int(x.split('_')[-2]))
    return net, i_inds + f_inds
