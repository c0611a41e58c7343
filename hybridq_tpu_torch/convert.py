"""Carry state between ``hybridq_tpu`` and this port.

The system has no weights: its state is the engines' split container (re
half, then im half) and, for the fused engine, its slot map; for the
tensor-network engine, the network and its contraction tree (and the
plans that ``scripts/_plan_cache/*.pkl`` hold, pickled by the JAX
package).  The JAX
fused engine keeps the container as a ``[2^(n-6), 128]`` f32 array and
JAX's ``IndexedEvolver`` hands out a flushed ``[2, 2^n]`` pair
(``unpack_host``); both are reshapes of the port's flat tensor.  Both
sides take numpy arrays, so this module imports nothing of the JAX
package.
"""

from __future__ import annotations

import pickle
from typing import Sequence

import numpy as np
import torch

from hybridq_tpu_torch.circuit import Circuit
from hybridq_tpu_torch.gate import MatrixGate
from hybridq_tpu_torch.simulation._device import resolve_device

__all__ = ['state_from_reference', 'state_to_reference',
           'pair_to_reference', 'circuit_from_matrices',
           'tn_from_reference', 'load_reference_plan',
           'sharded_from_reference']


def _check_phys(phys, n):
    phys = [int(p) for p in phys]
    if sorted(phys) != list(range(n)):
        raise ValueError(f"phys must be a permutation of range({n})")
    return phys


def state_from_reference(container: np.ndarray,
                         phys: Sequence[int] = None, device=None):
    """A JAX engine's state -> ``(state, phys, logi)`` on ``device``:
    the fused engine's container (``[2^(n-6), 128]`` f32) with its slot
    map ``phys``; or ``IndexedEvolver``'s flushed ``[2, 2^n]`` pair with
    ``phys=None`` (canonical: the identity), for the port's
    ``IndexedEvolver``.  ``device=None`` means ``'cuda'``, which raises
    without a card (pass ``device='cpu'``)."""
    device = resolve_device(device, 'state_from_reference()')
    container = np.asarray(container)
    if container.dtype != np.float32 or container.ndim != 2:
        raise ValueError("container must be a 2-D f32 array")
    n = container.size.bit_length() - 2
    if n < 1 or container.size != 2 ** (n + 1) or \
            container.shape not in ((2 ** (n - 6), 128), (2, 2 ** n)):
        raise ValueError("container must be a [2^(n-6), 128] or a "
                         "[2, 2^n] f32 array")
    phys = _check_phys(range(n) if phys is None else phys, n)
    logi = [0] * n
    for b, s in enumerate(phys):
        logi[s] = b
    state = torch.from_numpy(np.array(container).reshape(-1)).to(device)
    return state, phys, logi


def state_to_reference(state: torch.Tensor, phys: Sequence[int]):
    """The port's container and slot map -> ``(container, phys)`` in the
    JAX engine's form (``[2^(n-6), 128]`` f32 numpy array)."""
    flat = state.detach().to('cpu', torch.float32).numpy()
    n = flat.size.bit_length() - 2
    if flat.size != 2 ** (n + 1):
        raise ValueError("state must hold 2^(n+1) floats")
    return flat.reshape(2 ** (n - 6), 128).copy(), _check_phys(phys, n)


def pair_to_reference(state: torch.Tensor) -> np.ndarray:
    """The port's container in canonical order -> the ``[2, 2^n]`` f32
    pair (re, im) that JAX's ``IndexedEvolver`` packs."""
    flat = state.detach().to('cpu', torch.float32).numpy()
    n = flat.size.bit_length() - 2
    if flat.size != 2 ** (n + 1):
        raise ValueError("state must hold 2^(n+1) floats")
    return flat.reshape(2, 2 ** n).copy()


def sharded_from_reference(re: np.ndarray, im: np.ndarray,
                           perm: Sequence[int], devices=None):
    """A JAX sharded engine's state -> ``(shards, perm)`` for the port's
    sharded engines on ``devices``: ``re`` and ``im`` are its
    ``(2^g, 2^n_local)`` host arrays and ``perm`` its layout (physical
    position -> logical qubit), kept as it is, so that a port evolver with
    ``ev.perm = perm`` continues where the JAX one stood.  Each shard of
    this process is the split container of its row (re, then im), in the
    precision of ``re``; ``devices`` as the engines take it."""
    from hybridq_tpu_torch.parallel.mesh import Mesh

    re, im = np.asarray(re), np.asarray(im)
    if re.shape != im.shape or re.ndim != 2 or \
            re.shape[0] & (re.shape[0] - 1) or \
            re.shape[1] & (re.shape[1] - 1):
        raise ValueError("re and im must be (2^g, 2^n_local) arrays")
    n = (re.size - 1).bit_length()
    perm = _check_phys(perm, n)
    mesh = Mesh(devices)
    if mesh.size != re.shape[0]:
        raise ValueError(f"{re.shape[0]} shards given, the mesh of "
                         f"these devices holds {mesh.size}")
    shards = [torch.from_numpy(np.concatenate([re[d], im[d]])).to(dev)
              for d, dev in zip(mesh.index, mesh.devices)]
    return shards, perm


def circuit_from_matrices(items) -> Circuit:
    """``[(U, qubits), ...]`` -> a port ``Circuit`` of ``MatrixGate``s, so
    that both packages can run the same gates."""
    return Circuit(MatrixGate(np.asarray(U)).on(list(qs))
                   for U, qs in items)


def tn_from_reference(net, tree=None):
    """A JAX ``TensorNetwork`` (any object whose ``.tensors`` have
    ``.inds`` and ``.data``) -> the port's ``TensorNetwork``; with
    ``tree`` (a JAX ``ContractionTree``: ``inputs``, ``output``,
    ``size_dict``, ``children``, ``root``), also the port's tree with the
    same nodes, so both packages can contract the identical tree.
    Returns the network, or ``(network, tree)``."""
    from hybridq_tpu_torch.simulation.tn.network import (Tensor,
                                                         TensorNetwork)
    from hybridq_tpu_torch.simulation.tn.path import ContractionTree

    out = TensorNetwork([Tensor(np.array(t.data), tuple(t.inds))
                         for t in net.tensors])
    if tree is None:
        return out
    return out, ContractionTree.from_children(
        tree.inputs, tree.output, tree.size_dict, tree.children, tree.root)


# the JAX package's modules whose pickled classes the port restores
_REFERENCE_MODULES = {
    f'hybridq_tpu.simulation.tn.{m}': f'hybridq_tpu_torch.simulation.tn.{m}'
    for m in ('network', 'path', 'slicer')}


class _ReferenceUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module in _REFERENCE_MODULES:
            module = _REFERENCE_MODULES[module]
        elif module == 'hybridq_tpu' or module.startswith('hybridq_tpu.'):
            raise pickle.UnpicklingError(
                f"{module}.{name} has no counterpart in hybridq_tpu_torch")
        return super().find_class(module, name)


def load_reference_plan(path):
    """Unpickle a plan that the JAX package wrote (``scripts/bench_tn.py``
    writes ``(net, output_order, tree, sliced, cost)`` into
    ``scripts/_plan_cache``) into the port's ``TensorNetwork``,
    ``ContractionTree`` and ``SliceCost``, without importing
    ``hybridq_tpu``; any other ``hybridq_tpu`` class is refused.  Read
    only trusted files: unpickling runs what the file names."""
    with open(path, 'rb') as f:
        return _ReferenceUnpickler(f).load()
