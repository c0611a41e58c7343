"""Sharded state-vector evolution: the state split over a mesh of shards.

The counterpart of ``hybridq_tpu/simulation/sharded.py``.  The ``2^n``
state is split over ``2^g`` shards (``parallel.mesh.Mesh``: every
process's devices, in order):

  * each shard is the split container of the port's other engines,
    ``2^(n_local+1)`` floats (re half, then im half), ``n_local = n - g``;
  * the first ``g`` physical positions are global: they are the bits of
    the shard's index; the other ``n_local`` are the shard's own, physical
    position ``g + s`` (local *slot* ``s``) at flat bit ``n_local - 1 - s``;
  * ``perm[p]`` is the logical qubit at physical position ``p``;
  * a gate on a global qubit first swaps it with a local slot: each
    shard trades half of its container with the shard whose index differs
    in that bit (``Mesh.exchange``, JAX's ``lax.ppermute``);
  * a local gate is one in-place ``fused_kernels.apply_bits`` launch on
    each shard at the gate's flat bits.  On a CPU shard that is the plain
    version; in complex128 (no kernel takes f64) a gather, a complex128
    matmul and a scatter on the shard's device.

Shards are updated in place, where JAX's programs return new arrays: the
methods return the same list of tensors.  What JAX adds for the TPU is
not ported: the ``R x C`` take-permutations and ``row_bits`` (the TPU's
``(8, 128)`` tiles; ``apply_bits`` addresses any flat bit), and the
program caches (``_progs``, ``_compiled``); PyTorch runs eagerly.
``ShardedState`` is a result left on the shards' devices
(``simulate(..., optimize='evolution-sharded', return_numpy_array=False)``):
it reads given amplitudes where they lie, and gathers the whole state to
the host only when asked.

``ShardedIndexedEvolver`` (the default of ``optimize='evolution-sharded'``)
swaps an incoming global qubit into the lowest local slot the gate does
not use, and runs Projection and Measure gates on the shards.
``ShardedEvolver`` plans a whole circuit first (``_schedule``) with JAX's
rule for its traced program, the highest free slot, and rejects
FunctionalGates; so after any ``evolve`` each class's ``perm`` equals its
JAX twin's.

While a profiler records, the engines open the spans ``hq.compress``,
``hq.prepare_state``, ``hq.sharded.schedule`` (the layout's planning),
``hq.sharded.operands`` (the block matrices' uploads) and ``hq.exchange
b= slot= n=`` (each exchange: global position, local slot, the shard's
qubits).  ``counts()`` holds ``exchange`` (exchanges run) and
``exchange_bytes`` (bytes that crossed between devices, ``Mesh.exchange``)
since the last ``reset_counts()``.
"""

from __future__ import annotations

import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from hybridq_tpu_torch.circuit import Circuit, utils as circuit_utils
from hybridq_tpu_torch.gate import FunctionalGate
from hybridq_tpu_torch.simulation._device import span
from hybridq_tpu_torch.simulation.prepare import TOKEN_VECTORS, _check_state

__all__ = ['ShardedEvolver', 'ShardedIndexedEvolver', 'ShardedState',
           'counts', 'reset_counts']

_COMPLEX_TYPES = {np.dtype('complex64'): torch.float32,
                  np.dtype('complex128'): torch.float64}

exchanges = 0          # Mesh.exchange calls
exchange_bytes = 0     # bytes they sent between devices


def reset_counts():
    global exchanges, exchange_bytes
    exchanges = exchange_bytes = 0


def counts() -> dict:
    return {'exchange': exchanges, 'exchange_bytes': exchange_bytes}


def _bit_view(n_local, bits):
    """``(shape, order)``: a view of ``2^n_local`` entries whose axes
    ``1, 3, ...`` are the flat ``bits`` from the most significant down
    (``order[a]`` is the index in ``bits`` of axis ``2a + 1``), the even
    axes the runs between them."""
    order = sorted(range(len(bits)), key=lambda j: -bits[j])
    shape, prev = [], n_local
    for j in order:
        shape += [2 ** (prev - bits[j] - 1), 2]
        prev = bits[j]
    return shape + [2 ** prev], order


def _dot(a, b):
    """``torch.dot`` in pieces of 2^30 entries: cuBLAS takes at most
    2^31 - 1, fewer than a shard of 30 local qubits holds."""
    step = 2 ** 30
    return sum(torch.dot(a[i:i + step], b[i:i + step])
               for i in range(0, a.numel(), step))


def _apply_plain(shard, U, bits, n_local):
    """A gate on a shard in its own precision: gather, matmul, scatter."""
    from hybridq_tpu_torch.simulation.fused_kernels import _group_index

    N = 2 ** n_local
    re, im = shard[:N], shard[N:]
    idx = _group_index(n_local, bits, (), shard.device)
    Y = torch.matmul(U, torch.complex(re[idx], im[idx]))
    re[idx] = Y.real
    im[idx] = Y.imag


class ShardedState:
    """A state left on its shards: the split containers ``shards`` of this
    process (``Mesh`` order), the mesh, and the layout ``perm``
    (``perm[p]`` is the logical qubit at physical position ``p``; the
    first ``g`` positions are the bits of a shard's index)."""

    def __init__(self, mesh, shards, perm, complex_type):
        self.mesh = mesh
        self.shards = list(shards)
        self.perm = list(perm)
        self.complex_type = np.dtype(complex_type)
        self.n_qubits = len(self.perm)
        self.n_local = self.n_qubits - mesh.g

    def synchronize(self):
        """Wait for the work queued on every CUDA device of the shards."""
        for dev in dict.fromkeys(self.mesh.devices):
            if dev.type == 'cuda':
                torch.cuda.synchronize(dev)

    def amplitudes(self, index) -> torch.Tensor:
        """The amplitudes of the logical bitstrings ``index`` (int64, qubit
        0 the most significant bit: the flat index of the one-device
        result), complex, on the first device of the mesh.  Each shard
        reads its own on its device; across processes every process must
        call this (one ``all_sum``)."""
        n, nl = self.n_qubits, self.n_local
        N = 2 ** nl
        ctype = torch.complex64 if self.shards[0].dtype == torch.float32 \
            else torch.complex128
        parts = []
        for d, shard in zip(self.mesh.index, self.shards):
            logical = torch.as_tensor(index, dtype=torch.int64).to(
                shard.device)
            phys = torch.zeros_like(logical)
            for p, q in enumerate(self.perm):
                phys |= ((logical >> (n - 1 - q)) & 1) << (n - 1 - p)
            off = phys & (N - 1)
            amp = torch.complex(shard[off], shard[N + off])
            mine = (phys >> nl) == d
            parts.append(torch.view_as_real(torch.where(
                mine, amp, torch.zeros((), dtype=ctype,
                                       device=shard.device))))
        # each index lies on one shard: the others add exact zeros
        return torch.view_as_complex(self.mesh.all_sum(parts))

    def gather(self) -> np.ndarray:
        """The full complex state on the host, axes in sorted-qubit
        order (``(2,)*n``)."""
        rows = self.mesh.gather(self.shards).numpy()
        N = 2 ** self.n_local
        full = (rows[:, :N].astype(self.complex_type) +
                1j * rows[:, N:]).reshape((2,) * self.n_qubits)
        if self.perm != list(range(self.n_qubits)):
            inv = [self.perm.index(q) for q in range(self.n_qubits)]
            full = np.transpose(full, inv)
        return full


class ShardedEvolver:
    """State-vector engine over a mesh of shards (see the module
    docstring).  Usage::

        ev = ShardedEvolver(n, devices=['cuda:0'] * 4)
        psi = ev.prepare_state('0' * n)      # list of this process's shards
        psi = ev.evolve(psi, circuit)
        full = ev.gather(psi)                # (2,)*n numpy, sorted qubits

    ``devices=None`` means this process's card inside a process group
    (``parallel.initialize``), else every visible CUDA device; it raises
    without one (pass ``devices=['cpu'] * 2**g`` for the host)."""

    def __init__(self, n_qubits: int, devices: Optional[Sequence] = None,
                 complex_type='complex64', compress: int = 2):
        from hybridq_tpu_torch.parallel.mesh import Mesh

        self.mesh = Mesh(devices)
        g = self.mesh.g
        if n_qubits <= g:
            raise ValueError("Need more qubits than global (device) bits.")
        self.n_qubits = int(n_qubits)
        self.g = g
        self.n_local = self.n_qubits - g
        self.complex_type = np.dtype(complex_type)
        if self.complex_type not in _COMPLEX_TYPES:
            raise ValueError("complex_type must be complex64 or complex128")
        self.float_type = np.real(np.zeros(1, dtype=complex_type)).dtype
        self.dtype = _COMPLEX_TYPES[self.complex_type]
        self.compress = compress
        # perm[p] = logical qubit at physical position p.
        self.perm = list(range(self.n_qubits))
        self.exchanges = 0          # global-local swaps run, in all

    # -- state construction -----------------------------------------------
    def prepare_state(self, state: str):
        """A token product state: each device builds its own container
        from the local tokens' vectors (``prepare.token_containers``; only
        the ``(n_local, 2)`` table is copied from the host, nothing crosses
        between devices), then each shard is scaled by its global tokens'
        amplitude."""
        from hybridq_tpu_torch.simulation.prepare import token_containers

        state = _check_state(state, 2)
        if len(state) != self.n_qubits:
            raise ValueError("Wrong number of qubits for state.")
        g, nl = self.g, self.n_local
        amps = []
        for d in self.mesh.index:
            amp = 1.0
            for p in range(g):
                amp *= TOKEN_VECTORS[state[p]][(d >> (g - 1 - p)) & 1]
            amps.append(float(amp))
        shards = token_containers(state[g:], nl, self.mesh.devices,
                                  self.dtype)
        return [s.mul_(amp) for s, amp in zip(shards, amps)]

    def scatter_state(self, psi):
        """This process's shards of a full host state (``(2,)*n`` or flat,
        in the canonical layout)."""
        if self.perm != list(range(self.n_qubits)):
            raise RuntimeError(
                "scatter_state requires the canonical layout")
        psi = np.asarray(psi)
        if psi.size != 2 ** self.n_qubits:
            raise ValueError("Wrong state size for scatter_state.")
        rows = psi.reshape(2 ** self.g, 2 ** self.n_local)
        return [self._pack(rows[d], dev)
                for d, dev in zip(self.mesh.index, self.mesh.devices)]

    def _pack(self, row, device, out=None):
        """The split container of one complex host row."""
        N = row.size
        out = torch.empty(2 * N, dtype=self.dtype, device=device) \
            if out is None else out
        out[:N].copy_(torch.from_numpy(np.ascontiguousarray(
            row.real, dtype=self.float_type)))
        out[N:].copy_(torch.from_numpy(np.ascontiguousarray(
            row.imag, dtype=self.float_type)))
        return out

    # -- scheduling ---------------------------------------------------------
    def _free_slot(self, perm, qs) -> int:
        """The local slot an incoming global qubit of a gate on logical
        ``qs`` takes: the highest one no member of ``qs`` holds
        (``ShardedEvolver._schedule`` of the JAX package)."""
        g = self.g
        return next(p for p in range(self.n_qubits - 1, g - 1, -1)
                    if perm[p] not in qs) - g

    def _moves(self, perm, qs):
        """The global-local swaps ``(global position, local slot)`` that
        bring every member of ``qs`` local, in order; ``perm`` is updated
        to match."""
        g = self.g
        if len(qs) > self.n_local:
            raise ValueError(
                f"Gate acts on {len(qs)} qubits but only "
                f"{self.n_local} local positions exist.")
        moves = []
        for q in qs:
            p = perm.index(q)
            if p < g:
                slot = self._free_slot(perm, qs)
                moves.append((p, slot))
                perm[p], perm[g + slot] = perm[g + slot], perm[p]
        return moves

    def _schedule(self, gates, qubit_index):
        """A gate list as ``(ops, perm)``: ops ``('swap', global position,
        slot)`` and ``('gate', i, slots)`` for ``gates[i]``, and the layout
        after them; the data is not touched."""
        perm = list(self.perm)
        ops = []
        for i, gate in enumerate(gates):
            qs = [qubit_index[q] for q in gate.qubits]
            ops += [('swap', p, s) for p, s in self._moves(perm, qs)]
            ops.append(('gate', i,
                        tuple(perm.index(q) - self.g for q in qs)))
        return ops, perm

    def _exchange(self, psi, b, slot):
        global exchanges, exchange_bytes
        with span('hq.exchange', b=b, slot=slot, n=self.n_local):
            sent = self.mesh.exchange(psi, b, slot, self.n_local)
        self.exchanges += 1
        exchanges += 1
        exchange_bytes += sent

    # -- gates ------------------------------------------------------------
    def _operands(self, mats):
        """Each matrix of ``mats`` on every device of the shards, one
        stacked upload a size and device: ``{device: [U, ...]}``."""
        ctype = torch.complex64 if self.dtype == torch.float32 \
            else torch.complex128
        out = {}
        with span('hq.sharded.operands'):
            for dev in dict.fromkeys(self.mesh.devices):
                ops = [None] * len(mats)
                by_dim: dict = {}
                for i, U in enumerate(mats):
                    by_dim.setdefault(np.shape(U)[0], []).append(i)
                for idxs in by_dim.values():
                    stack = torch.as_tensor(np.stack(
                        [np.asarray(mats[i]) for i in idxs]), dtype=ctype,
                        device=dev)
                    for j, i in enumerate(idxs):
                        ops[i] = stack[j]
                out[dev] = ops
        return out

    def _apply_local(self, psi, ops, i, slots):
        """Matrix ``i`` of ``ops`` (``_operands``) on local ``slots`` of
        every shard: one ``apply_bits`` launch a shard in complex64."""
        from hybridq_tpu_torch.simulation.fused_kernels import apply_bits

        nl = self.n_local
        bits = [nl - 1 - s for s in slots]
        for shard, dev in zip(psi, self.mesh.devices):
            if self.dtype == torch.float32:
                apply_bits(shard, ops[dev][i], bits)
            else:
                _apply_plain(shard, ops[dev][i], bits, nl)
        return psi

    def _compressed(self, circuit, skip=None):
        if not (self.compress and self.compress > 1):
            return list(circuit)
        with span('hq.compress'):
            blocks, matrices = circuit_utils._compress(
                circuit, min(self.compress, self.n_local),
                skip_compression=skip)
            gates = []
            for b, M in zip(blocks, matrices):
                if any(isinstance(gg, FunctionalGate) for gg in b):
                    gates.extend(b)
                else:
                    gates.append(circuit_utils._block_gate(
                        b, M, self.complex_type))
        return gates

    def _qubit_index(self, circuit, qubits):
        all_qubits = circuit.all_qubits if qubits is None else list(qubits)
        if len(all_qubits) > self.n_qubits:
            raise ValueError("Circuit has more qubits than the evolver.")
        return all_qubits, {q: i for i, q in enumerate(all_qubits)}

    # -- public API ---------------------------------------------------------
    def evolve(self, psi, circuit, qubits=None):
        """Apply ``circuit`` to the shards ``psi`` (in place)."""
        circuit = Circuit(circuit)
        if any(isinstance(gg, FunctionalGate) for gg in circuit):
            raise NotImplementedError(
                "FunctionalGates are not supported in the sharded engine "
                "yet; use the single-chip engine.")
        _, qubit_index = self._qubit_index(circuit, qubits)
        gates = self._compressed(circuit)
        with span('hq.sharded.schedule'):
            ops, perm = self._schedule(gates, qubit_index)
        mats = self._operands([np.asarray(gate.matrix(),
                                          dtype=self.complex_type)
                               for gate in gates])
        for op in ops:
            if op[0] == 'swap':
                self._exchange(psi, op[1], op[2])
            else:
                self._apply_local(psi, mats, op[1], op[2])
        self.perm = perm
        return psi

    def state(self, psi) -> ShardedState:
        """The shards ``psi`` in the current layout, as a result."""
        return ShardedState(self.mesh, psi, self.perm, self.complex_type)

    def gather(self, psi) -> np.ndarray:
        """The full complex state on the host, axes in sorted-qubit
        order."""
        return self.state(psi).gather()

    def norm(self, psi) -> float:
        """Global L2 norm (one ``all_sum`` over the mesh)."""
        n2 = self.mesh.all_sum([_dot(s, s) for s in psi])
        return float(np.sqrt(float(n2)))


class ShardedIndexedEvolver(ShardedEvolver):
    """The sharded engine gate by gate: an incoming global qubit takes
    the lowest local slot the gate does not use (JAX's ``_ensure_local``).
    ``ProjectionGate`` and ``MeasureGate`` run on the shards (outcome
    probabilities by one ``all_sum``, collapse by zeroing in place);
    other FunctionalGates go through the host (gather, apply, re-shard),
    with a warning."""

    def __init__(self, n_qubits: int, devices: Optional[Sequence] = None,
                 complex_type='complex64', compress: int = 2, seed=None):
        super().__init__(n_qubits, devices=devices,
                         complex_type=complex_type, compress=compress)
        self._rng = np.random.default_rng(seed)

    def _free_slot(self, perm, qs) -> int:
        return next(s for s in range(self.n_local)
                    if perm[self.g + s] not in qs)

    def _ensure_local(self, psi, logical_qubits):
        """Swap every global member of ``logical_qubits`` into a local
        slot; returns ``(psi, slots)``."""
        qs = list(logical_qubits)
        with span('hq.sharded.schedule'):
            moves = self._moves(self.perm, qs)
        for p, slot in moves:
            self._exchange(psi, p, slot)
        return psi, [self.perm.index(q) - self.g for q in qs]

    def apply_gate(self, psi, U, logical_qubits):
        """Apply a k-qubit unitary at logical (dense) qubits."""
        psi, slots = self._ensure_local(psi, logical_qubits)
        return self._apply_local(psi, self._operands([U]), 0, slots)

    def _restore_perm(self, psi, perm0):
        """Swap qubits until the layout matches ``perm0`` (only
        global-local moves occur in this engine)."""
        g = self.g
        for p in range(g):
            want = perm0[p]
            if self.perm[p] == want:
                continue
            cur = self.perm.index(want)
            if cur < g:
                # ``want`` sits at another global position: route it
                # through a free local slot first.
                slot = next(s for s in range(self.n_local)
                            if self.perm[g + s] not in perm0[:g])
                self._exchange(psi, cur, slot)
                self.perm[cur], self.perm[g + slot] = \
                    self.perm[g + slot], self.perm[cur]
                cur = self.perm.index(want)
            slot = cur - g
            self._exchange(psi, p, slot)
            self.perm[p], self.perm[g + slot] = \
                self.perm[g + slot], self.perm[p]
        if list(self.perm) != list(perm0):
            raise RuntimeError("could not realign sharded layout")
        return psi

    def expectation_value(self, psi, circuit, qubits=None) -> complex:
        """<psi| circuit |psi> on the shards: the operator runs on a copy,
        and the inner product reduces with one ``all_sum``."""
        perm0 = list(self.perm)
        phi = [s.clone() for s in psi]
        phi = self.evolve(phi, circuit, qubits=qubits)
        phi = self._restore_perm(phi, perm0)
        N = 2 ** self.n_local
        parts = []
        for a, b in zip(psi, phi):
            ar, ai, br, bi = a[:N], a[N:], b[:N], b[N:]
            parts.append(torch.stack([
                _dot(ar, br) + _dot(ai, bi),
                _dot(ar, bi) - _dot(ai, br)]))
        del phi
        vr, vi = self.mesh.all_sum(parts).tolist()
        return complex(vr, vi)

    # -- functional gates ---------------------------------------------------
    def probabilities(self, psi, logical_qubits):
        """Joint z-basis outcome probabilities of ``logical_qubits`` (bit
        order = the order given).  Returns ``(psi, probs)``: swap-ins may
        have relabeled the state."""
        psi, slots = self._ensure_local(psi, logical_qubits)
        nl = self.n_local
        shape, order = _bit_view(nl, [nl - 1 - s for s in slots])
        k = len(slots)
        parts = []
        for s in psi:
            N = 2 ** nl
            p2 = (s[:N] * s[:N] + s[N:] * s[N:]).view(shape)
            m = p2.sum(dim=tuple(range(0, 2 * k + 1, 2)))
            parts.append(m.permute([order.index(j) for j in range(k)])
                         .reshape(-1))
        probs = self.mesh.all_sum(parts).cpu().numpy()
        return psi, probs.astype(np.float64)

    def project(self, psi, logical_qubits, outcome: int,
                renormalize: bool = True):
        """Collapse ``logical_qubits`` onto the z-basis ``outcome``, in
        place."""
        psi, slots = self._ensure_local(psi, logical_qubits)
        nl = self.n_local
        shape, order = _bit_view(nl, [nl - 1 - s for s in slots])
        k = len(slots)
        for s in psi:
            v = s.view([2] + shape)
            for a, j in enumerate(order):
                bit = (int(outcome) >> (k - 1 - j)) & 1
                v.select(2 + 2 * a, 1 - bit).zero_()
        n2 = float(self.mesh.all_sum([_dot(s, s) for s in psi]))
        if renormalize and n2 > 0:
            scale = float(np.float32(1.0) / np.sqrt(np.float32(n2))) \
                if self.dtype == torch.float32 else 1.0 / np.sqrt(n2)
            for s in psi:
                s.mul_(scale)
        return psi

    def measure(self, psi, logical_qubits, renormalize: bool = True):
        """Projective measurement with collapse; returns
        ``(psi, outcome)``."""
        psi, probs = self.probabilities(psi, logical_qubits)
        p = np.maximum(probs, 0)
        norm = p.sum()
        if not norm > 0:
            raise ValueError(
                "cannot measure a zero-norm state (e.g. after a "
                "ProjectionGate with renormalize=False onto a "
                "zero-probability outcome)")
        outcome = int(self._rng.choice(p.size, p=p / norm))
        psi = self.project(psi, logical_qubits, outcome,
                           renormalize=renormalize)
        return psi, outcome

    def _apply_functional_host(self, psi, gate, qubits_order):
        """Generic FunctionalGate fallback: gather, apply on the host,
        write the result back into the same shards (warns)."""
        warnings.warn(
            f"Gate '{gate.name}' runs on host (gather/re-shard) in the "
            "sharded engine.", stacklevel=2)
        full = self.gather(psi)  # canonical qubit order
        new, order = gate.apply(full, tuple(qubits_order))
        if tuple(order) != tuple(qubits_order):
            inv = [tuple(order).index(q) for q in qubits_order]
            new = np.transpose(new, inv)
        self.perm = list(range(self.n_qubits))
        rows = np.asarray(new).reshape(2 ** self.g, -1)
        for d, s in zip(self.mesh.index, psi):
            self._pack(rows[d], s.device, out=s)
        return psi

    # -- public API ---------------------------------------------------------
    def evolve(self, psi, circuit, qubits=None):
        from hybridq_tpu_torch.gate import MeasureGate, ProjectionGate

        circuit = Circuit(circuit)
        all_qubits, qubit_index = self._qubit_index(circuit, qubits)
        gates = self._compressed(circuit, skip=[FunctionalGate])
        mats = [np.asarray(gate.matrix(), dtype=self.complex_type)
                if not isinstance(gate, FunctionalGate) else None
                for gate in gates]
        ops = self._operands([U for U in mats if U is not None])
        i = 0
        for gate in gates:
            qs = [qubit_index[q] for q in gate.qubits] \
                if gate.qubits is not None else None
            if isinstance(gate, ProjectionGate):
                psi = self.project(psi, qs, int(gate.state, 2))
            elif isinstance(gate, MeasureGate):
                psi, _ = self.measure(psi, qs)
            elif isinstance(gate, FunctionalGate):
                psi = self._apply_functional_host(psi, gate, all_qubits)
            else:
                psi, slots = self._ensure_local(psi, qs)
                psi = self._apply_local(psi, ops, i, slots)
                i += 1
        return psi
