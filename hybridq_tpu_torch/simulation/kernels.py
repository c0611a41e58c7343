"""The straight-route engine: ``IndexedEvolver`` and its pairing scheduler.

The counterpart of ``hybridq_tpu/simulation/kernels.py``'s
``IndexedEvolver`` (``:426``) and ``pair_matrix_gates`` (``:351``).  The
state is the JAX fused engine's split container (``2^(n+1)`` f32, re half
then im half), always in canonical bit order: every gate is one in-place
``fused_kernels.apply_bits`` launch at its flat bits ``n - 1 - q``,
whichever they are, lane bits 0-6 included.  There is no slot map, so no
victims, parks, lane eviction or flush; ``flush`` is the identity.

What the JAX module carries for the TPU is not ported: the ``[2R, C]``
row/column classes and their deferred permutations (the MXU wants
contiguous rows), and the compile amortisation around them
(``_calibration``, ``_device_kind``, ``_class_cost``, ``plan_classes``,
``warm``, ``calibrate``).  ``hq_group_apply`` takes its bit positions as
arguments, so one build serves every gate.

``pair_matrix_gates`` is the scheduler: a greedy that fuses gates into
blocks of up to 8 qubits when one launch of the larger block costs less
than the launches it replaces, priced by ``straight_cost``.  The layout
never changes, so a gate's cost depends on its own bits alone.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from hybridq_tpu_torch.simulation._device import span

__all__ = ['IndexedEvolver', 'pair_matrix_gates', 'straight_cost']


def _compose_matrix_gates(items):
    """Compose a list of (U, qs) into one fused (U, qs) block (applied
    left-to-right) via the circuit toolbox."""
    from hybridq_tpu_torch.circuit import Circuit
    from hybridq_tpu_torch.circuit import utils as cutils
    from hybridq_tpu_torch.gate import MatrixGate

    g = cutils.to_matrix_gate(
        Circuit(MatrixGate(np.asarray(U)).on(list(qs))
                for U, qs in items), complex_type='complex128')
    return np.asarray(g.matrix()), tuple(g.qubits)


# -- cost of one apply_bits launch -------------------------------------
#
# ms of one launch at n = _COST_N by gate size k and the class of the
# lowest gate bit: 0, 1, 2, 3 (bits 3-6) and 7 (all >= 7).  A low bit
# shortens the contiguous runs of a gate row (2^low floats), which costs
# the tiles of group_apply_kernel (k >= 6) up to 32% and the columns of
# column_apply_kernel up to 9%.  Every launch streams the whole state once,
# so the kernel's time scales by 2^(n - _COST_N); _STEP_MS is the host
# time of one step, which no n scales.  Measured by chip_smoke.py's
# `kernels` phase (its `straight` table and `step_ms`) on an NVIDIA H100
# 80GB HBM3 at a 700 W power limit; PERF.md names the run.
_COST_N = 28
_STEP_MS = 0.0685
_STRAIGHT_COST = {
    1: {0: 1.458, 1: 1.453, 2: 1.508, 3: 1.453, 7: 1.455},
    2: {0: 1.518, 1: 1.481, 2: 1.502, 3: 1.463, 7: 1.544},
    3: {0: 1.639, 1: 1.596, 2: 1.559, 3: 1.479, 7: 1.498},
    4: {0: 1.672, 1: 1.635, 2: 1.569, 3: 1.491, 7: 1.562},
    5: {0: 1.890, 1: 1.927, 2: 1.912, 3: 1.863, 7: 1.866},
    6: {0: 3.205, 1: 2.555, 2: 3.005, 3: 2.844, 7: 2.419},
    7: {0: 4.989, 1: 4.291, 2: 4.883, 3: 4.584, 7: 4.248},
    8: {0: 8.487, 1: 7.707, 2: 8.306, 3: 7.857, 7: 7.782},
}

# A merge must save 0.16 of one one-qubit launch.  That launch is priced
# at 1.446 ms, the one-qubit cost the cells' schedules were built with
# (not _STRAIGHT_COST's own, which would move the threshold).
_MERGE_FLOOR_1Q_MS = 1.446


def straight_cost(n: int, bits) -> float:
    """Cost (ms) of one ``apply_bits`` launch on flat ``bits`` at ``n``
    qubits: host step plus the kernel's time, scaled from ``_COST_N`` by
    the state's size; ``inf`` past 8 bits."""
    low = min(bits)
    row = _STRAIGHT_COST.get(len(bits))
    if row is None:
        return float('inf')
    base = row[low if low < 3 else 3 if low < 7 else 7]
    return _STEP_MS + base * 2.0 ** (n - _COST_N)


def pair_matrix_gates(items, n: int, max_k: int = 8):
    """Fuse gates into larger blocks when one straight launch of the
    block costs less than the launches it replaces.  ``items`` is a list
    of ``(U, qs)`` with dense qubit indices; gates may jump over earlier
    gates they commute with (disjoint supports).  Greedy: each block
    takes, while it has fewer than ``max_k`` qubits, the gate whose merge
    saves the most, if that beats the merge floor.  Returns a new
    ``(U, qs)`` list."""
    items = list(items)

    def cost(qs):
        return straight_cost(n, [n - 1 - q for q in qs])

    gate_cost = [cost(qs) for _, qs in items]
    min_profit = 0.16 * (_STEP_MS + _MERGE_FLOOR_1Q_MS *
                         2.0 ** (n - _COST_N))
    used = [False] * len(items)
    out = []
    for i in range(len(items)):
        if used[i]:
            continue
        used[i] = True
        cur = [items[i]]
        qs_set = set(items[i][1])
        c_cur = gate_cost[i]
        while len(qs_set) < max_k:
            # a later gate may join only past gates disjoint from it
            blocked: set = set()
            best, best_profit = None, min_profit
            for j in range(i + 1, len(items)):
                if used[j]:
                    continue
                qsj = set(items[j][1])
                union = qs_set | qsj
                if not qsj & blocked and len(union) <= max_k:
                    c_union = cost(union)
                    profit = c_cur + gate_cost[j] - c_union
                    if profit > best_profit:
                        best, best_profit = (j, union, c_union), profit
                blocked |= qsj
            if best is None:
                break
            j, qs_set, c_cur = best
            used[j] = True
            cur.append(items[j])
        out.append(cur[0] if len(cur) == 1 else _compose_matrix_gates(cur))
    return out


def _torch_complex(complex_type):
    return {np.dtype('complex64'): torch.complex64,
            np.dtype('complex128'): torch.complex128}[np.dtype(complex_type)]


# ---------------------------------------------------------------------
# the evolver
# ---------------------------------------------------------------------

class IndexedEvolver:
    """Single-device evolution, one ``apply_bits`` launch a gate, on the
    split container in canonical bit order.  Usage::

        ev = IndexedEvolver(n, device='cuda')
        state = ev.prepare_state('0' * n)     # 2^(n+1) f32 on the device
        state = ev.apply_gates(state, gates, qubit_index)
        psi = ev.gather(state)                # complex (2,)*n tensor

    The kernel updates ``state`` in place; the methods return it.
    ``device=None`` means ``'cuda'``, which raises without a card (pass
    ``device='cpu'`` to run the plain versions on the host)."""

    def __init__(self, n_qubits: int, precision: str = 'highest',
                 device=None):
        from hybridq_tpu_torch.simulation._device import resolve_device

        self.n = int(n_qubits)
        if self.n < 1:
            raise ValueError("IndexedEvolver needs n >= 1")
        # 'high' runs the same exact-f32 kernel; taken for the callers.
        if str(precision).lower() not in ('highest', 'high'):
            raise ValueError("precision must be 'highest' or 'high'")
        self.device = resolve_device(device, 'IndexedEvolver')
        self._operands: dict = {}         # gate_key -> U on the device

    # -- state ---------------------------------------------------------
    def prepare_state(self, state: str) -> torch.Tensor:
        """Token product state built on the device, with no state-sized
        temporary (``prepare.token_container``)."""
        from hybridq_tpu_torch.simulation.prepare import token_container

        return token_container(state, self.n, self.device)

    def pack(self, psi) -> torch.Tensor:
        """Container of a complex ``(2,)*n`` host array or tensor (the
        re and im parts copied straight into the two halves)."""
        from hybridq_tpu_torch.simulation.prepare import pack_container

        state = pack_container(psi, self.device)
        if state.numel() != 2 ** (self.n + 1):
            raise ValueError(f"psi must hold 2^{self.n} amplitudes")
        return state

    def flush(self, state):
        """The layout is always canonical: nothing to restore."""
        return state

    def amplitude(self, state, i: int) -> complex:
        i = int(i)
        return complex(float(state[i]), float(state[i + 2 ** self.n]))

    def gather(self, state, complex_type='complex64') -> torch.Tensor:
        """The complex ``(2,)*n`` state as a tensor on the evolver's
        device (a new buffer beside the container)."""
        N = 2 ** self.n
        psi = torch.complex(state[:N], state[N:]).to(_torch_complex(
            complex_type))
        return psi.reshape((2,) * self.n)

    def gather_host(self, state, complex_type='complex64',
                    chunk: int = 2 ** 24) -> np.ndarray:
        """The complex ``(2,)*n`` state as a host array, built ``chunk``
        amplitudes at a time on the device: no complex buffer of the
        state's size there.  From the card each chunk lands in one of two
        pinned staging buffers, so that the copy of one chunk off the card
        overlaps the host's copy of the one before into the result."""
        N = 2 ** self.n
        dtype = _torch_complex(complex_type)
        out = torch.empty(N, dtype=dtype)
        chunk = min(chunk, N)
        if state.is_cuda:
            stages = [torch.empty(chunk, dtype=dtype, pin_memory=True)
                      for _ in range(2)]
            stream = torch.cuda.current_stream(state.device)
            landed = [torch.cuda.Event(), torch.cuda.Event()]
        pending = None            # (stage, s, e): on its way to the host

        def drain(b, s, e):
            landed[b].synchronize()
            out[s:e].copy_(stages[b][:e - s])

        for i, s in enumerate(range(0, N, chunk)):
            e = min(s + chunk, N)
            z = torch.complex(state[s:e], state[N + s:N + e]).to(dtype)
            if not state.is_cuda:
                out[s:e].copy_(z)
                continue
            # stage b was last drained (read by the host) one chunk ago
            b = i % 2
            stages[b][:e - s].copy_(z, non_blocking=True)
            landed[b].record(stream)
            if pending is not None:
                drain(*pending)
            pending = (b, s, e)
        if pending is not None:
            drain(*pending)
        return out.numpy().reshape((2,) * self.n)

    # -- gates ---------------------------------------------------------
    def _operand(self, U, gate_key=None) -> torch.Tensor:
        """``U`` as a complex64 tensor on the device, memoized by
        ``gate_key``."""
        if gate_key is not None:
            hit = self._operands.get(gate_key)
            if hit is not None:
                return hit
        if isinstance(U, torch.Tensor):
            Ud = U.to(self.device, torch.complex64).contiguous()
        else:
            Ud = torch.as_tensor(np.ascontiguousarray(U, np.complex64),
                                 device=self.device)
        if gate_key is not None:
            self._operands[gate_key] = Ud
        return Ud

    def apply_gate(self, state, U, qubits: Tuple[int, ...], gate_key=None):
        """Apply one gate; ``qubits`` are dense indices in [0, n).
        ``gate_key`` (hashable) memoizes the operand upload across
        repeated applications of the same gate."""
        from hybridq_tpu_torch.simulation.fused_kernels import apply_bits

        bits = [self.n - 1 - int(q) for q in qubits]
        return apply_bits(state, self._operand(U, gate_key), bits)

    def preload(self, mats):
        """Upload a list of k-qubit matrices as one stacked transfer per
        size; returns one device operand per matrix (views of the
        stacks), for ``apply_gate``."""
        by_dim: dict = {}
        for i, U in enumerate(mats):
            by_dim.setdefault(np.shape(U)[0], []).append(i)
        out = [None] * len(mats)
        with span('hq.preload'):
            for idxs in by_dim.values():
                stack = torch.as_tensor(
                    np.stack([np.asarray(mats[i], np.complex64)
                              for i in idxs]), device=self.device)
                for j, i in enumerate(idxs):
                    out[i] = stack[j]
        return out

    def apply_gates(self, state, gates, qubit_index):
        mats = [np.ascontiguousarray(g.matrix()) for g in gates]
        for g, U in zip(gates, self.preload(mats)):
            qs = tuple(qubit_index[q] for q in g.qubits)
            state = self.apply_gate(state, U, qs)
        return state
