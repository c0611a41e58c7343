"""Sliced contraction executor.

The counterpart of ``hybridq_tpu/simulation/tn/contract.py``, which
replaces cotengra's ``SlicedContractor`` (reference
``simulation.py:1050-1084``):

  * ``ContractionPlan`` (a copy): the contraction tree as a static list
    of pairwise steps — a ``tensordot`` spec, or an integer-label einsum
    spec where the step keeps a hyperedge index;
  * ``SlicedContractor.contract_np`` (a copy): the plain numpy executor,
    one slice at a time — the reference the others are held against,
    and ``backend='numpy'``;
  * ``SlicedContractor.contract_torch``: native complex tensors on a
    torch device.  A slice whose sliced legs select an all-zero row of
    some leaf is exactly 0 and is left out (``nonzero_slices``).  A
    chunk of the other slices runs as a leading batch dimension
    of every intermediate that depends on the slice; a subtree whose
    leaves carry no sliced index is contracted once per call and enters
    the batched steps unbatched.  Each node's legs stay in the order its
    step left them (``schedule``): a step whose smaller operand sums and
    brings at most 7 legs is one ``tn_kernels.tn_apply`` (on a card, the
    kernel of ``csrc/tn_apply.cu``, which reads the legs where they lie),
    the others a permute and ``torch.matmul`` (``torch.einsum`` where a
    hyperedge is kept).  Matmuls run with TF32 off, whatever the
    caller's flags.

Slice id ``s`` selects bit ``j`` of ``s`` for ``sliced[j]`` (the sliced
indices sorted by name), as in the JAX package, so ``slice_range``
partial sums — the unit of checkpoint and resume — agree range for range
with it.
"""

from __future__ import annotations

import itertools
from typing import Dict, FrozenSet, List, Sequence, Tuple

import numpy as np
import torch

from hybridq_tpu_torch.simulation._device import (full_precision_matmul,
                                                  resolve_device, span)
from hybridq_tpu_torch.simulation.tn import tn_kernels
from hybridq_tpu_torch.simulation.tn.network import Tensor
from hybridq_tpu_torch.simulation.tn.path import ContractionTree

__all__ = ['ContractionPlan', 'SlicedContractor']

_MAX_LABELS = 52        # torch.einsum's sublist labels are 0..51
_MAX_COPY_DIMS = 25     # dimensions of one CUDA copy (OffsetCalculator)
_ROW_BLOCK = 4096       # chunks whose leaf rows are computed in one go


class ContractionPlan:
    """Static schedule of pairwise contractions for (tree, sliced).

    Hyperedge-aware: an index shared by both children that is RETAINED
    at the parent (``tree.node_inds``: it appears in a third subtree or
    in the output — quimb-style hyper indices, produced by
    ``TensorNetwork.diagonal_reduce``) is *batched*, not summed.  Each
    step carries a tensordot spec (fast path, no batch) or an einsum
    spec in integer-label form (batched)."""

    def __init__(self, tree: ContractionTree, sliced: FrozenSet[str]):
        self.tree = tree
        self.sliced = tuple(sorted(sliced))
        self.sliced_set = frozenset(sliced)
        sl = self.sliced_set

        # Effective (post-slicing) index list per node.
        self.eff: Dict[int, Tuple[str, ...]] = {}
        for v in range(tree.n_leaves):
            self.eff[v] = tuple(i for i in tree.inputs[v] if i not in sl)
        self.steps: List[tuple] = []
        for v in tree.topo_order():
            if v < tree.n_leaves:
                continue
            a, b = tree.children[v]
            ea, eb = self.eff[a], self.eff[b]
            retained = set(tree.node_inds[v])
            shared = [i for i in ea if i in eb]
            summed = [i for i in shared if i not in retained]
            batch = tuple(i for i in shared if i in retained)
            self.eff[v] = batch + tuple(
                i for i in ea if i not in shared) + tuple(
                i for i in eb if i not in shared)
            if not batch:
                a_axes = tuple(ea.index(i) for i in summed)
                b_axes = tuple(eb.index(i) for i in summed)
                self.steps.append((v, a, b, a_axes, b_axes, None))
            else:
                labels = {i: k for k, i in enumerate(
                    dict.fromkeys(ea + eb))}
                spec = (tuple(labels[i] for i in ea),
                        tuple(labels[i] for i in eb),
                        tuple(labels[i] for i in self.eff[v]))
                self.steps.append((v, a, b, None, None, spec))
        self.root = tree.root

        # Per-leaf sliced axes: (axis_in_original_inds, slice_position).
        self.leaf_slices: Dict[int, Tuple[Tuple[int, int], ...]] = {}
        for v in range(tree.n_leaves):
            entries = []
            for pos, i in enumerate(tree.inputs[v]):
                if i in sl:
                    entries.append((pos, self.sliced.index(i)))
            self.leaf_slices[v] = tuple(entries)

        self.nslices = 1
        for i in self.sliced:
            self.nslices *= tree.size_dict[i]

    def output_perm(self, output_order: Sequence[str]) -> Tuple[int, ...]:
        """Permutation taking the root's index order to
        ``output_order``."""
        root_inds = self.eff[self.root]
        if set(root_inds) != set(output_order):
            raise ValueError("output order inconsistent with root indices")
        return tuple(root_inds.index(i) for i in output_order)


class SlicedContractor:
    """Executes a ContractionPlan over all slices, on numpy or torch."""

    def __init__(self, plan: ContractionPlan, tensors: Sequence[Tensor],
                 output_order: Sequence[str], complex_type='complex64'):
        if len(tensors) != plan.tree.n_leaves:
            raise ValueError("wrong number of tensors")
        self.plan = plan
        self.output_order = tuple(output_order)
        self.perm = plan.output_perm(output_order)
        self.complex_type = np.dtype(complex_type)
        # Reorder each tensor's data to the tree's declared leaf index
        # order (tree.inputs comes from the same tensors, so this is a
        # no-op unless the caller reordered).
        self.datas = []
        for t, inds in zip(tensors, plan.tree.inputs):
            if t.inds != inds:
                perm = tuple(t.inds.index(i) for i in inds)
                d = np.ascontiguousarray(np.transpose(t.data, perm))
            else:
                d = np.ascontiguousarray(t.data)
            # Normalize to the declared leaf shape: a fully-simplified
            # (scalar) tensor can arrive as shape (1,) while its index
            # list is () — tensordot would then grow spurious size-1
            # dims that desync every later step from ``plan.eff``.
            want = tuple(plan.tree.size_dict[i] for i in inds)
            if d.shape != want:
                d = d.reshape(want)
            self.datas.append(d)
        self.nslices = plan.nslices
        self._schedule = None

    def _range(self, slice_range):
        """Clamp a ``(start, stop)`` request to the valid slice ids:
        ids >= nslices alias the low slice bits and would silently
        double-count slices."""
        start, stop = slice_range if slice_range is not None \
            else (0, self.nslices)
        return max(0, start), min(stop, self.nslices)

    def _zeros(self):
        return np.zeros([self.plan.tree.size_dict[i]
                         for i in self.output_order],
                        dtype=self.complex_type)

    # -- numpy backend ---------------------------------------------------
    def _leaf_np(self, v, sid):
        d = self.datas[v]
        for pos, j in sorted(self.plan.leaf_slices[v], reverse=True):
            bit = (sid >> j) & 1
            d = np.take(d, bit, axis=pos)
        return d

    def contract_slice_np(self, sid: int) -> np.ndarray:
        vals = {v: self._leaf_np(v, sid)
                for v in range(self.plan.tree.n_leaves)}
        for v, a, b, a_axes, b_axes, spec in self.plan.steps:
            if spec is None:
                vals[v] = np.tensordot(vals.pop(a), vals.pop(b),
                                       axes=(a_axes, b_axes))
            else:
                la, lb, lo = spec
                vals[v] = np.einsum(vals.pop(a), list(la),
                                    vals.pop(b), list(lb), list(lo))
        out = vals[self.plan.root]
        return np.transpose(out, self.perm) if self.perm else out

    def contract_np(self, verbose: bool = False,
                    slice_range=None) -> np.ndarray:
        start, stop = self._range(slice_range)
        if stop <= start:  # empty range: a zero partial sum
            return self._zeros()
        out = self.contract_slice_np(start).astype(self.complex_type)
        for sid in range(start + 1, stop):
            out = out + self.contract_slice_np(sid)
        return out

    # -- torch backend ---------------------------------------------------
    def _chunk(self, max_batch_elems: float = 2**25):
        size = max(self.plan.tree.max_size(self.plan.sliced_set), 1)
        chunk = int(max(1, min(self.nslices, max_batch_elems // size)))
        # the largest divisor of nslices that is <= chunk
        while self.nslices % chunk:
            chunk -= 1
        return chunk

    def schedule(self):
        """``(batched, steps)``, computed once per contractor.
        ``batched[v]`` is True when node ``v`` depends on the slice id (a
        leaf under it carries a sliced index), and then its tensor has a
        leading slice-batch axis.  Each step is ``(v, a, b, op)``; ``op``
        reads the children's legs in the order their tensors really hold
        them (``self.order``, tracked from the leaves as JAX's
        ``_flat_schedule`` tracks it, so that no step permutes to restore
        ``plan.eff``):

          * ``('apply', step, a_is_x, inplace)``: the smaller operand
            sums ``s <= 7`` legs of the larger and brings ``f <= 7`` new
            ones, no hyperedge, every leg of size 2: one
            ``tn_kernels.tn_apply`` with the ``TnStep`` built here, in
            place where the step is square and the larger operand is
            batched (that tensor is then needed by no other step);
          * ``('matmul', perm_a, perm_b, (m, k, n), shape, xb, yb)``: a
            large-by-large product: each child permuted to (batch, free
            legs, summed legs) and (batch, summed legs, free legs), one
            ``torch.matmul``, the result (batch, free legs of ``a``, free
            legs of ``b``);
          * ``('einsum', la, lb, lo)``: a retained hyperedge; integer
            sublist labels with the batch as one more label.

        ``self.root_perm`` takes the root's legs to ``output_order``."""
        if self._schedule is not None:
            return self._schedule
        plan = self.plan
        size = plan.tree.size_dict
        batched = {v: bool(plan.leaf_slices[v])
                   for v in range(plan.tree.n_leaves)}
        order = {v: plan.eff[v] for v in range(plan.tree.n_leaves)}
        steps = []
        for v, a, b, _, _, _ in plan.steps:
            xb, yb = batched[a], batched[b]
            batched[v] = xb or yb
            oa, ob = order[a], order[b]
            keep = set(plan.eff[v])
            shared = [i for i in oa if i in ob]
            summed = [i for i in shared if i not in keep]
            hyper = tuple(i for i in shared if i in keep)
            free_a = tuple(i for i in oa if i not in shared)
            free_b = tuple(i for i in ob if i not in shared)
            a_is_x = (len(oa), xb) >= (len(ob), yb)
            ox, oo = (oa, ob) if a_is_x else (ob, oa)
            s, f = len(summed), len(oo) - len(summed)
            if not hyper and s <= tn_kernels.MAX_LEGS and \
                    f <= tn_kernels.MAX_LEGS and \
                    all(size[i] == 2 for i in ox + oo):
                x_batched = xb if a_is_x else yb
                step, order[v] = tn_kernels.TnStep.from_legs(
                    ox, oo, summed, x_batched, yb if a_is_x else xb)
                steps.append((v, a, b, ('apply', step, a_is_x,
                                        f == s and x_batched)))
            elif not hyper:
                order[v] = free_a + free_b
                summed = tuple(summed)
                steps.append((v, a, b, (
                    'matmul',
                    tuple(range(xb)) + tuple(oa.index(i) + xb
                                             for i in free_a + summed),
                    tuple(range(yb)) + tuple(ob.index(i) + yb
                                             for i in summed + free_b),
                    tuple(int(np.prod([size[i] for i in legs],
                                      dtype=np.int64))
                          for legs in (free_a, summed, free_b)),
                    tuple(size[i] for i in order[v]), xb, yb)))
            else:
                order[v] = hyper + free_a + free_b
                labels = {i: k for k, i in enumerate(dict.fromkeys(oa + ob))}
                spec = (tuple(labels[i] for i in oa),
                        tuple(labels[i] for i in ob),
                        tuple(labels[i] for i in order[v]))
                # the slice batch takes the next label
                n_labels = len(labels)
                if n_labels + batched[v] > _MAX_LABELS:
                    raise ValueError(
                        f"step {v} needs {n_labels + 1} einsum labels; "
                        f"torch.einsum takes at most {_MAX_LABELS}")
                batch = (n_labels,)
                steps.append((v, a, b, (
                    'einsum', batch * xb + spec[0], batch * yb + spec[1],
                    batch * batched[v] + spec[2])))
        self.order = order
        root = order[plan.root]
        self.root_perm = tuple(root.index(i) for i in self.output_order)
        self._schedule = batched, steps
        return self._schedule

    def _slice_rows(self, datas):
        """The sliced leaves' rows: ``(vs, shifts, weights, nonzero)``.

        Leaf ``vs[l]``, its sliced axes first and flattened to one axis,
        has ``2^s`` rows; slice id ``i`` takes its row
        ``sum_k ((i >> shifts[l, k]) & 1) * weights[l, k]``.
        ``nonzero[l]`` marks the rows that hold an entry other than an
        exact zero: a slice that takes any other row is exactly 0.
        ``nonzero`` is None where some leaf of ``datas`` holds a value
        that is not finite (``0 * inf`` is NaN, so no slice is 0 there)."""
        plan = self.plan
        vs = [v for v in range(plan.tree.n_leaves) if plan.leaf_slices[v]]
        width = max([len(plan.leaf_slices[v]) for v in vs] + [1])
        shifts = np.zeros((len(vs), width), dtype=np.int64)
        weights = np.zeros_like(shifts)
        for l, v in enumerate(vs):
            sl = plan.leaf_slices[v]
            shifts[l, :len(sl)] = [j for _, j in sl]
            weights[l, :len(sl)] = [2 ** (len(sl) - 1 - k)
                                    for k in range(len(sl))]
        nonzero = None
        if np.isfinite(np.concatenate([d.ravel() for d in datas])).all():
            nonzero = []
            for v in vs:
                axes = [pos for pos, _ in plan.leaf_slices[v]]
                rest = [p for p in range(datas[v].ndim) if p not in axes]
                rows = np.transpose(datas[v], axes + rest).reshape(
                    2 ** len(axes), -1)
                nonzero.append(np.any(rows != 0, axis=1))
        return vs, shifts, weights, nonzero

    @staticmethod
    def _rows(ids, shifts, weights, nonzero):
        """``(rows, keep)`` for the slice ids ``ids``: ``keep`` marks the
        ids whose rows are all in ``nonzero``, ``rows[l]`` is sliced leaf
        ``l``'s row of each kept id (``_slice_rows``)."""
        rows = (((ids[:, None] >> shifts[:, None]) & 1) *
                weights[:, None]).sum(-1)
        keep = np.ones(len(ids), dtype=bool)
        for l, nz in enumerate(nonzero or ()):
            keep &= nz[rows[l]]
        return rows[:, keep], keep

    def nonzero_slices(self, slice_range=None) -> np.ndarray:
        """Mask over the slice ids ``[start, stop)`` of ``slice_range``
        (all by default): False where the slice's sliced legs select an
        all-zero row of some leaf, so that its value is exactly 0 and
        ``contract_torch`` does not contract it."""
        start, stop = self._range(slice_range)
        datas = [d.astype(self.complex_type, copy=False) for d in self.datas]
        _, shifts, weights, nonzero = self._slice_rows(datas)
        return self._rows(np.arange(start, max(start, stop)), shifts,
                          weights, nonzero)[1]

    def contract_torch(self, device=None,
                       slice_range=None) -> np.ndarray:
        """Sum the slices ``[start, stop)`` of ``slice_range`` (all by
        default) on ``device`` (``None`` means ``'cuda'``, which raises
        without a card); returns a numpy array of ``complex_type``.

        A slice whose sliced legs select an all-zero row of some leaf is
        exactly 0 and is not contracted (``nonzero_slices``); nothing is
        skipped where a leaf holds a value that is not finite.  The
        others run in chunks of ``_chunk()`` slices (2^25 elements over
        the widest intermediate, as the JAX executor sizes its vmap), each
        one batch.  Each child is freed once its parent is made; a square
        ``'apply'`` step on a batched operand writes over it.  The root is
        permuted to ``output_order`` once, after the sum.
        ``self.last_counts`` holds the call's slices ``'asked'`` and
        ``'contracted'``.
        """
        device = resolve_device(device, 'contract_torch()')
        start, stop = self._range(slice_range)
        self.last_counts = {'asked': max(0, stop - start), 'contracted': 0}
        if stop <= start:  # empty range: a zero partial sum
            return self._zeros()
        plan = self.plan
        if any(plan.tree.size_dict[i] != 2 for i in plan.sliced):
            raise ValueError("sliced indices must have dimension 2")
        with span('hq.tn.schedule'):
            batched, steps = self.schedule()
        n = plan.tree.n_leaves

        with full_precision_matmul():
            with span('hq.tn.leaves'):
                datas = [d.astype(self.complex_type, copy=False)
                         for d in self.datas]
                vs, shifts, weights, nonzero = self._slice_rows(datas)
                leaves = [torch.as_tensor(d, device=device) for d in datas]
                del datas
                # Sliced leaves: sliced axes first, flattened to one axis
                # of 2^s rows that the chunk's ids index (``_slice_rows``).
                gathers = {}
                for v in vs:
                    axes = [pos for pos, _ in plan.leaf_slices[v]]
                    rest = [p for p in range(leaves[v].dim())
                            if p not in axes]
                    d = leaves[v].permute(axes + rest).reshape(
                        (2 ** len(axes),) +
                        tuple(leaves[v].shape[p] for p in rest))
                    gathers[v] = d.contiguous()
                    leaves[v] = None

            # Slice-invariant subtrees, once per call: what stays in
            # ``fixed`` is the root or a child of a batched step.
            fixed = {v: leaves[v] for v in range(n) if not batched[v]}
            del leaves
            with span('hq.tn.fixed'):
                for v, a, b, op in steps:
                    if not batched[v]:
                        fixed[v] = _step(fixed.pop(a), fixed.pop(b), op)

            if not batched[plan.root]:   # no sliced index: one slice
                acc = fixed[plan.root] * (stop - start)
                self.last_counts['contracted'] = stop - start
            else:
                acc = None
                chunk = self._chunk()
                block = chunk * _ROW_BLOCK
                for b0 in range(start, stop, block):
                    # every sliced leaf's rows for a block of chunks at
                    # once, the zero slices dropped; the copy from
                    # pageable memory is staged before it returns
                    rows, _ = self._rows(
                        np.arange(b0, min(b0 + block, stop)), shifts,
                        weights, nonzero)
                    n_ids = rows.shape[1]
                    self.last_counts['contracted'] += n_ids
                    rows = torch.from_numpy(rows).to(device,
                                                     non_blocking=True)
                    for c0 in range(0, n_ids, chunk):
                        with span('hq.tn.chunk',
                                  n=min(chunk, n_ids - c0)):
                            vals = {v: d.index_select(
                                0, rows[l, c0:c0 + chunk])
                                for l, (v, d) in enumerate(gathers.items())}
                            for v, a, b, op in steps:
                                if not batched[v]:
                                    continue
                                x = vals.pop(a) if batched[a] else fixed[a]
                                y = vals.pop(b) if batched[b] else fixed[b]
                                vals[v] = _step(x, y, op)
                                del x, y
                            part = vals.pop(plan.root).sum(0)
                            acc = part if acc is None else acc + part
                            del part
            if acc is None:   # every slice of the range is exactly 0
                return self._zeros()
            with span('hq.tn.result'):
                out = acc.permute(self.root_perm) if self.root_perm \
                    else acc
                return out.cpu().numpy().astype(self.complex_type,
                                                copy=False)

    def contract(self, backend='torch', devices=None, device=None,
                 verbose: bool = False, slice_range=None) -> np.ndarray:
        """``backend='numpy'``: ``contract_np``; otherwise
        ``contract_torch`` on ``device`` (or the first entry of
        ``devices``).  With more than one entry in ``devices``, no
        ``slice_range`` and a slice count that they divide, each device
        sums its contiguous range of slices and the partial sums are
        added (JAX's ``_contract_jax_mesh`` and its ``psum``); the devices
        take their ranges one after the other.  Across processes, split
        the slices with ``parallel.local_slice_range`` and pass each
        process's range as ``slice_range``."""
        devices = None if devices is None else list(devices)
        if devices and device is None:
            device = devices[0]
        if backend == 'numpy':
            return self.contract_np(verbose=verbose,
                                    slice_range=slice_range)
        if backend != 'torch':
            raise ValueError(f"backend must be 'torch' or 'numpy', "
                             f"got {backend!r}")
        n_dev = len(devices) if devices else 1
        if slice_range is None and n_dev > 1 and \
                self.nslices % n_dev == 0:
            per = self.nslices // n_dev
            out = sum(self.contract_torch(device=d,
                                          slice_range=(i * per,
                                                       (i + 1) * per))
                      .astype(np.complex128) for i, d in enumerate(devices))
            return out.astype(self.complex_type)
        return self.contract_torch(device=device, slice_range=slice_range)


def _step(x, y, op):
    """One pairwise contraction of ``SlicedContractor.schedule``: ``x`` is
    child ``a``'s tensor, ``y`` child ``b``'s."""
    kind = op[0]
    if kind == 'apply':
        _, step, a_is_x, inplace = op
        return tn_kernels.tn_apply(*((x, y) if a_is_x else (y, x)), step,
                                   inplace)
    if kind == 'einsum':
        _, la, lb, lo = op
        return torch.einsum(x, list(la), y, list(lb), list(lo)).contiguous()
    _, pa, pb, (m, k, n), shape, xb, yb = op
    z = torch.matmul(_permuted(x, pa).reshape((-1,) * xb + (m, k)),
                     _permuted(y, pb).reshape((-1,) * yb + (k, n)))
    return z.reshape((-1,) * (xb or yb) + shape)


def _permuted(t, perm):
    """``t.permute(perm)``, contiguous.  A CUDA copy takes at most 25
    dimensions that do not merge (a slice batch and 26 legs in a tracked
    order can have 27), so past 25 the copy goes in pieces, one for each
    value of the leading axes of the result."""
    if list(perm) == list(range(t.dim())):
        return t
    p = t.permute(perm)
    lead = t.dim() - _MAX_COPY_DIMS
    if lead <= 0:
        return p.contiguous()
    out = torch.empty(p.shape, dtype=t.dtype, device=t.device)
    for idx in itertools.product(*(range(d) for d in p.shape[:lead])):
        out[idx].copy_(p[idx])
    return out
