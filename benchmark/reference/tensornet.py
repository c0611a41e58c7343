"""Plain sliced tensor-network reference for the benchmark's plans.

A plan file holds ``(network, output_order, tree, sliced, cost)`` as the
planners of both packages pickle them.  ``load_plan`` reads it with an
unpickler of its own into plain objects: the leaves (``inds``, ``data``),
the tree's ``inputs``, ``output``, ``size_dict``, ``children`` and
``root``, and the sliced indices.  Every other class of either package is
refused.  Nothing else of the file is used: the legs each node keeps are
worked out here from the tree.

Slice ``s`` fixes sliced index ``j`` (the sliced indices sorted by name)
to bit ``j`` of ``s``, the convention of the program's ``slice_range``.
Each slice is contracted node by node with ``torch.einsum`` in complex64
(TF32 off); nodes whose leaves hold no sliced index are contracted once.
The slices' values are summed in complex128.  ``tf32=True`` is the
control: both operands of every step rounded to TF32 first.

Imports nothing of the program or of JAX.
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass

import numpy as np
import torch

from reference.statevector import no_tf32, round_tf32

__all__ = ['Plan', 'load_plan', 'node_legs', 'slice_values',
           'macs_per_slice', 'nonzero_slices']

# (module suffix, class) pairs the plan files name, under either package
_CLASSES = {('simulation.tn.network', 'TensorNetwork'),
            ('simulation.tn.network', 'Tensor'),
            ('simulation.tn.path', 'ContractionTree'),
            ('simulation.tn.slicer', 'SliceCost')}
_PACKAGES = ('hybridq_tpu', 'hybridq_tpu_torch')


class _Plain:
    """What a plan file's object becomes: its attributes, nothing more."""


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        pkg, _, rest = module.partition('.')
        if pkg in _PACKAGES:
            if (rest, name) not in _CLASSES:
                raise pickle.UnpicklingError(f"{module}.{name} is not part "
                                             "of a plan file")
            return type(name, (_Plain,), {})
        if pkg not in ('numpy', 'builtins', 'copyreg', '_codecs',
                       'collections'):
            raise pickle.UnpicklingError(f"{module}.{name} is not part of "
                                         "a plan file")
        return super().find_class(module, name)


@dataclass
class Plan:
    leaves: list            # [(inds, complex ndarray)], in tree leaf order
    output: tuple
    size: dict
    children: dict          # node -> (a, b)
    root: int
    sliced: tuple           # sorted by name

    @property
    def nslices(self) -> int:
        return int(np.prod([self.size[i] for i in self.sliced],
                           dtype=np.int64))


def load_plan(path) -> Plan:
    """Read a plan file (see the module docstring)."""
    with open(path, 'rb') as f:
        net, _, tree, sliced, _ = _Unpickler(f).load()
    tensors = {tuple(t.inds): t for t in net.tensors}
    leaves = []
    for inds in tree.inputs:
        t = tensors[tuple(inds)]
        leaves.append((tuple(inds), np.asarray(t.data).reshape(
            [tree.size_dict[i] for i in inds])))
    return Plan(leaves, tuple(tree.output), dict(tree.size_dict),
                {int(v): tuple(c) for v, c in tree.children.items()},
                int(tree.root), tuple(sorted(sliced)))


def node_legs(plan: Plan):
    """``(legs, leaf_sets, order)``: the legs each node keeps (those of
    its leaves that a leaf outside it or the output also has), the leaves
    under each node, and the internal nodes children first."""
    n = len(plan.leaves)
    order, stack, seen = [], [plan.root], set()
    while stack:                       # post-order without recursion
        v = stack.pop()
        if v < n:
            continue
        if v in seen:
            order.append(v)
            continue
        seen.add(v)
        stack.append(v)
        stack.extend(plan.children[v])
    under = {v: {v} for v in range(n)}
    for v in order:
        a, b = plan.children[v]
        under[v] = under[a] | under[b]
    count = {}
    for inds, _ in plan.leaves:
        for i in set(inds):
            count[i] = count.get(i, 0) + 1
    legs = {v: tuple(plan.leaves[v][0]) for v in range(n)}
    out = set(plan.output)
    for v in order:
        a, b = plan.children[v]
        inner = {}
        for leaf in under[v]:
            for i in set(plan.leaves[leaf][0]):
                inner[i] = inner.get(i, 0) + 1
        mine = dict.fromkeys(legs[a] + legs[b])
        legs[v] = tuple(i for i in mine if i in out or inner[i] < count[i])
    return legs, under, order


def macs_per_slice(plan: Plan) -> float:
    """Complex multiply-adds of one slice: every step of the tree at its
    sliced size (the product of the sizes of both children's legs)."""
    legs, _, order = node_legs(plan)
    sl = set(plan.sliced)
    total = 0.0
    for v in order:
        a, b = plan.children[v]
        total += float(np.prod([plan.size[i]
                                for i in set(legs[a]) | set(legs[b])
                                if i not in sl], dtype=float))
    return total


def nonzero_slices(plan: Plan) -> np.ndarray:
    """Boolean mask over the slice ids: False where fixing the sliced legs
    leaves some leaf all zero, so that the slice's value is exactly 0."""
    sl = {i: j for j, i in enumerate(plan.sliced)}
    ids = np.arange(plan.nslices)
    keep = np.ones(plan.nslices, dtype=bool)
    for inds, data in plan.leaves:
        pos = [(ax, sl[i]) for ax, i in enumerate(inds) if i in sl]
        for bits in range(2 ** len(pos)):
            index = [slice(None)] * len(inds)
            for k, (ax, _) in enumerate(pos):
                index[ax] = (bits >> k) & 1
            if pos and not np.any(data[tuple(index)]):
                hit = np.ones(plan.nslices, dtype=bool)
                for k, (_, j) in enumerate(pos):
                    hit &= ((ids >> j) & 1) == ((bits >> k) & 1)
                keep &= ~hit
    return keep


def slice_values(plan: Plan, start: int, stop: int, device,
                 tf32: bool = False) -> np.ndarray:
    """The value of each slice in ``[start, stop)`` (complex128 host
    array of shape ``(stop - start,) + output shape``)."""
    legs, under, order = node_legs(plan)
    sl = {i: j for j, i in enumerate(plan.sliced)}
    n = len(plan.leaves)
    sliced_leaf = [any(i in sl for i in inds) for inds, _ in plan.leaves]
    depends = {v: sliced_leaf[v] for v in range(n)}
    for v in order:
        a, b = plan.children[v]
        depends[v] = depends[a] or depends[b]
    # the legs of each tensor once its sliced legs are fixed
    live = {v: tuple(i for i in legs[v] if i not in sl) for v in legs}
    data = [torch.as_tensor(d.astype(np.complex64), device=device)
            for _, d in plan.leaves]

    def leaf(v, s):
        t, inds = data[v], plan.leaves[v][0]
        for ax in reversed(range(len(inds))):
            if inds[ax] in sl:
                t = t.select(ax, (s >> sl[inds[ax]]) & 1)
        return t

    def step(v, x, y):
        a, b = plan.children[v]
        lab = {i: k for k, i in enumerate(dict.fromkeys(live[a] + live[b]))}
        if tf32:
            x, y = round_tf32(x), round_tf32(y)
        with no_tf32():
            return torch.einsum(x, [lab[i] for i in live[a]],
                                y, [lab[i] for i in live[b]],
                                [lab[i] for i in live[v]])

    # the nodes no slice changes, once
    fixed = {v: leaf(v, 0) for v in range(n) if not depends[v]}
    for v in order:
        if not depends[v]:
            a, b = plan.children[v]
            fixed[v] = step(v, fixed.pop(a), fixed.pop(b))

    def contract(s):
        vals = {v: leaf(v, s) for v in range(n) if depends[v]}
        for v in order:
            if depends[v]:
                a, b = plan.children[v]
                vals[v] = step(v, vals.pop(a) if depends[a] else fixed[a],
                               vals.pop(b) if depends[b] else fixed[b])
        return vals[plan.root]

    perm = [live[plan.root].index(i) for i in plan.output]
    out = []
    for s in range(start, stop):
        r = contract(s) if depends[plan.root] else fixed[plan.root]
        out.append(r.permute(perm) if perm else r)
    return torch.stack(out).to(torch.complex128).cpu().numpy()
