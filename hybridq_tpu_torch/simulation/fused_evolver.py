"""Single-device evolution engine on the in-place gate kernels.

The counterpart of ``hybridq_tpu/simulation/fused_evolver.py``, with the
same slot map, routing, victim policy, parks, eviction and flush, so that
containers and ``phys`` compare one to one with the JAX engine after every
gate.

Container: a contiguous f32 tensor of ``2^(n+1)`` floats (re half, then im
half; the JAX ``[2^(n-6), 128]`` view is a reshape of it).  Physical layout
is tracked as a bit permutation (``phys[logical_bit] -> physical slot``):
the kernels read and write every amplitude in place, so applying a gate
never perturbs the layout, except the swap path, which exchanges the
gate's lane slots (0-6) with victim high slots (>= 12, lowest first) as a
free relabel inside the same pass.

Per-gate routing by the gate bits' current physical slots:

  =============================  ===========================
  class                          kernel (``fused_kernels``)
  =============================  ===========================
  no lane slots, k_hi <= 4       ``apply_fused``
  k_l <= 2 lane slots            ``apply_swap`` (+ relabel)
  k_l >= 3                       lane eviction, then above
  =============================  ===========================

Parks move gate high bits onto free sublane slots (7-11) with one
``apply_fused`` pass of a pair-SWAP permutation (``inplace=True``, the
default), or with a row gather that needs a second state-sized buffer
(``inplace=False``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from hybridq_tpu_torch.simulation.fused_kernels import (apply_fused,
                                                        apply_swap,
                                                        fused_meta,
                                                        swap_meta)

__all__ = ['FusedEvolver', 'MapSim', 'pair_fused_gates',
           'MIN_FUSED_QUBITS']

MIN_FUSED_QUBITS = 14
_MAX_KE = 4              # largest (victim + high) group exponent routed
_MAX_KL = 2              # lane bits handled per swap application

_SW = np.array([[1, 0, 0, 0], [0, 0, 1, 0],
                [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.complex64)


def _econ_park_count(n, phys, logi, bits_log, high,
                     inplace=False) -> int:
    """How many gate high bits to park on free sublane slots BEFORE
    routing (0 = apply directly): the ``c`` minimizing
    ``park + class(k_hi - c)`` against the direct class.  Pure function
    of the slot map, mirrored exactly by ``MapSim.route_gate``."""
    phys_bits = [phys[b] for b in bits_log]
    k_l = sum(1 for b in phys_bits if b < 7)
    if k_l > _MAX_KL:
        return 0            # lane eviction must run first
    k_hi = sum(1 for b in phys_bits if b >= 12)
    free_sub = sum(1 for s in range(7, 12) if logi[s] not in bits_log)
    c_max = min(k_hi, free_sub)
    if c_max <= 0:
        return 0
    k = len(bits_log)

    def cls_cost(kh):
        if kh + k_l > _MAX_KE:
            return float('inf')
        if k_l == 0:
            return _step_cost(('fused', kh), n, high, k)
        return _step_cost(('swap', kh + k_l, k_l), n, high, k)

    best_c, best = 0, cls_cost(k_hi)
    for c in range(1, c_max + 1):
        park = _step_cost(('ipark', c) if inplace else ('park',),
                          n, high)
        v = park + cls_cost(k_hi - c)
        if v < best - 1e-9:
            best_c, best = c, v
    return best_c


class _NeedHighSlots(RuntimeError):
    """Swap path found fewer free high slots than victims needed."""

    def __init__(self, missing):
        super().__init__(f"need {missing} more free high slots")
        self.missing = missing


class FusedEvolver:
    """See module docstring.  Usage::

        ev = FusedEvolver(n, device='cuda')
        state = ev.prepare_state('0' * n)
        state = ev.apply_gates(state, gates, qubit_index)
        psi = ev.gather(state)          # complex (2,)*n tensor, on device

    ``state`` is updated in place by the kernels; the methods return it
    (a row gather returns a new tensor).
    """

    def __init__(self, n_qubits: int, precision: str = 'highest',
                 device=None, inplace=None):
        self.n = int(n_qubits)
        if self.n < MIN_FUSED_QUBITS:
            raise ValueError(
                f"FusedEvolver needs n >= {MIN_FUSED_QUBITS}")
        # In-place parks (a permutation pass of apply_fused) need no
        # second state-sized buffer, unlike the row gather.
        self.inplace = bool(True if inplace is None else inplace)
        precision = str(precision).lower()
        if precision not in ('highest', 'high'):
            raise ValueError("precision must be 'highest' or 'high'")
        # 'high' runs the same exact-f32 kernels as 'highest'; it is kept
        # so that routing costs and callers match the JAX engine.
        self.high = precision == 'high'
        self.device = torch.device('cuda' if device is None else device)
        # phys[b] = physical slot of logical flat bit b; lanes are
        # slots 0-6, rows 7..n-1 (the stack bit is never tracked).
        self.phys = list(range(self.n))
        self.logi = list(range(self.n))
        self._prep_cache: dict = {}       # (gate_key, map_key) -> prep
        self._rowmap_cache: dict = {}
        # Step classes executed by apply_gate (MapSim mirrors this).
        self.last_steps: list = []

    # -- layout helpers ------------------------------------------------
    def _map_key(self):
        return tuple(self.phys)

    def _victims(self, k: int, exclude) -> list:
        """``k`` victim bits on high slots (>= 12), excluded bits
        skipped; returns their PHYSICAL slots, lowest first (a pure
        function of the slot map, so repeated schedules hit the prep
        memo)."""
        cands = sorted(
            (self.phys[b] for b in range(self.n)
             if self.phys[b] >= 12 and b not in exclude))
        if len(cands) < k:
            raise _NeedHighSlots(k - len(cands))
        return cands[:k]

    def _free_high_slots(self, state, bits_log, count):
        """Row gather parking ``count`` of the gate's high-slot bits on
        free sublane slots (7-11)."""
        gate_hi = [b for b in bits_log if self.phys[b] >= 12]
        free_sub = [s for s in range(7, 12)
                    if self.logi[s] not in bits_log]
        if len(gate_hi) < count or len(free_sub) < count:
            raise RuntimeError(
                "cannot free enough high slots for the swap path "
                f"(n={self.n} too small for this gate)")
        new_phys = list(self.phys)
        for b, s in zip(gate_hi[:count], free_sub[:count]):
            other = self.logi[s]
            new_phys[b], new_phys[other] = s, self.phys[b]
        return self._row_permute(state, new_phys)

    def _park_pass(self, state, bits_log, count):
        """In-place park: exchange ``count`` gate high bits with
        free-sublane residents in ONE ``apply_fused`` pass whose U is the
        pair-SWAP permutation (class ``fused(count)``)."""
        gate_hi = [b for b in bits_log if self.phys[b] >= 12][:count]
        free_sub = [s for s in range(7, 12)
                    if self.logi[s] not in bits_log][:count]
        if len(gate_hi) < count or len(free_sub) < count:
            raise RuntimeError(
                "cannot free enough high slots for the swap path "
                f"(n={self.n} too small for this gate)")
        phys_bits = []
        for b, s in zip(gate_hi, free_sub):
            phys_bits += [self.phys[b], s]
        U = self._rowmap_cache.get(('park', count))
        if U is None:
            U = np.array([[1.0]], dtype=np.complex64)
            for _ in range(count):
                U = np.kron(U, _SW)
            U = torch.as_tensor(U, device=self.device)
            self._rowmap_cache[('park', count)] = U
        state = apply_fused(state, U, phys_bits)
        for b, s in zip(gate_hi, free_sub):
            other = self.logi[s]
            pb = self.phys[b]
            self.phys[b], self.phys[other] = s, pb
            self.logi[s], self.logi[pb] = b, other
        return state

    def _apply_swap_relabel(self, lane_slots, victim_slots):
        """Record the lane<->victim physical exchange."""
        for a, v in zip(lane_slots, victim_slots):
            la, lv = self.logi[a], self.logi[v]
            self.phys[la], self.phys[lv] = v, a
            self.logi[a], self.logi[v] = lv, la

    # -- gate preparation ----------------------------------------------
    def _prepare(self, U: np.ndarray, qubits: Tuple[int, ...],
                 gate_key=None):
        """Kernel and operands for one application at the CURRENT map
        state, memoized by (gate_key, map state).  Returns
        ``(kind, cls, args, relabel)``; ``relabel`` is the
        (lane_slots, victim_slots) exchange to record at apply time."""
        n = self.n
        bits_log = [n - 1 - q for q in qubits]
        key = None
        if gate_key is not None:
            key = (gate_key, self._map_key())
            hit = self._prep_cache.get(key)
            if hit is not None:
                return hit
        phys_bits = [self.phys[b] for b in bits_log]
        lane = sorted((b for b in phys_bits if b < 7), reverse=True)
        k_l = len(lane)

        if k_l == 0:
            k_hi = fused_meta(n, phys_bits)[0]
            if k_hi > _MAX_KE:
                raise _NeedHighSlots(k_hi - _MAX_KE)
            out = ('fused', (k_hi,), (self._upload(U), phys_bits), None)
        elif k_l > _MAX_KL:
            out = None     # caller evicts surplus lane bits first
        else:
            k_hi = sum(1 for b in phys_bits if b >= 12)
            if k_hi + k_l > _MAX_KE:
                raise _NeedHighSlots(k_hi + k_l - _MAX_KE)
            victims = self._victims(k_l, set(bits_log))
            k_hi = swap_meta(n, phys_bits, victims)[0]
            out = ('swap', (k_hi + k_l, k_l),
                   (self._upload(U), phys_bits, victims), (lane, victims))
        if key is not None and out is not None:
            self._prep_cache[key] = out
        return out

    def _upload(self, U):
        return torch.as_tensor(np.ascontiguousarray(U, dtype=np.complex64),
                               device=self.device)

    # -- application ---------------------------------------------------
    def apply_gate(self, state, U: np.ndarray,
                   qubits: Tuple[int, ...], gate_key=None):
        """Apply one gate; ``qubits`` are dense indices in [0, n).
        ``gate_key`` (hashable) memoizes the operand upload across
        repeated applications of the same gate."""
        n = self.n
        bits_log = [n - 1 - q for q in qubits]

        prep = None
        for _ in range(6):
            c = _econ_park_count(self.n, self.phys, self.logi,
                                 bits_log, self.high, self.inplace)
            if c:
                state = self._park(state, bits_log, c)
            try:
                prep = self._prepare(U, qubits, gate_key=gate_key)
                if prep is not None:
                    break
                # > _MAX_KL lane bits: evict surplus lane bits with a
                # pure-swap pass (identity gate), then retry.
                state = self._evict_lanes(state, keep=set(bits_log))
            except _NeedHighSlots as e:
                state = self._park(state, bits_log, e.missing)
        if prep is None:
            raise NotImplementedError("lane eviction failed")
        kind, cls, args, relabel = prep
        if kind == 'fused':
            state = apply_fused(state, *args)
        else:
            state = apply_swap(state, *args)
        self.last_steps.append((kind,) + cls)
        if relabel is not None:
            self._apply_swap_relabel(*relabel)
        return state

    def _park(self, state, bits_log, count):
        if self.inplace:
            self.last_steps.append(('ipark', count))
            return self._park_pass(state, bits_log, count)
        self.last_steps.append(('park',))
        return self._free_high_slots(state, bits_log, count)

    def _identity_swap(self, state, lane_slots, victim_slots):
        """Pure-swap pass: exchange ``lane_slots`` (< 7) with
        ``victim_slots`` (>= 12) under an identity gate.  The kernel
        pairs victims with lane bits sorted descending."""
        pairs = sorted(zip(lane_slots, victim_slots), reverse=True)
        lane_slots = [a for a, _ in pairs]
        victim_slots = [v for _, v in pairs]
        k_l = len(lane_slots)
        state = apply_swap(state, self._upload(np.eye(2 ** k_l)),
                           lane_slots, victim_slots)
        self._apply_swap_relabel(lane_slots, victim_slots)
        return state

    def _evict_lanes(self, state, keep):
        """Move ``_MAX_KL`` of the gate's lane bits out of lanes so
        the next application fits k_l <= ``_MAX_KL``."""
        lanes_to_move = sorted(
            (self.phys[b] for b in keep if self.phys[b] < 7),
            reverse=True)[:_MAX_KL]
        victims = self._victims(len(lanes_to_move), keep)
        self.last_steps.append(('evict', len(lanes_to_move)))
        return self._identity_swap(state, lanes_to_move, victims)

    def apply_gates(self, state, gates, qubit_index):
        for g in gates:
            qs = tuple(qubit_index[q] for q in g.qubits)
            state = self.apply_gate(state, np.ascontiguousarray(g.matrix()),
                                    qs)
        return state

    # -- state ---------------------------------------------------------
    def prepare_state(self, state: str) -> torch.Tensor:
        """Token product state built on the device, with no state-sized
        temporary (``prepare.token_container``)."""
        from hybridq_tpu_torch.simulation.prepare import token_container

        return token_container(state, self.n, self.device)

    def pack(self, psi) -> torch.Tensor:
        """Container of a complex ``(2,)*n`` host array or tensor in the
        canonical layout (the caller resets the slot map)."""
        from hybridq_tpu_torch.simulation.prepare import pack_container

        return pack_container(psi, self.device)

    def amplitude_location(self, i: int):
        """Physical ``(row_re, col, row_im)`` of logical flat amplitude
        ``i`` in the ``[2^(n-6), 128]`` view under the CURRENT slot map:
        readback without a flush."""
        p = 0
        for b in range(self.n):
            if (i >> b) & 1:
                p |= 1 << self.phys[b]
        r, c = divmod(p, 128)
        return r, c, r + 2 ** (self.n - 7)

    def amplitude(self, state, i: int) -> complex:
        r, c, ri = self.amplitude_location(int(i))
        return complex(float(state[r * 128 + c]), float(state[ri * 128 + c]))

    def _row_permute(self, state, new_phys):
        """One row gather (``index_select``) re-homing ROW bits
        (slots >= 7) so logical bit b sits at ``new_phys[b]``; lane slots
        must agree.  Out of place: it needs a second state-sized
        buffer."""
        n = self.n
        mkey = (tuple(self.phys), tuple(new_phys))
        src = self._rowmap_cache.get(mkey)
        if src is None:
            n_rows = 2 ** (n + 1 - 7)
            rows = torch.arange(n_rows, dtype=torch.int64,
                                device=self.device)
            src = (rows >> (n - 7)) << (n - 7)      # stack bit stays
            for b in range(n):
                if self.phys[b] < 7:
                    if new_phys[b] != self.phys[b]:
                        raise ValueError(
                            "lane slots cannot row-permute")
                    continue
                src |= (((rows >> (new_phys[b] - 7)) & 1)
                        << (self.phys[b] - 7))
            self._rowmap_cache[mkey] = src
        state = torch.index_select(state.view(-1, 128), 0, src).view(-1)
        for b in range(n):
            self.phys[b] = new_phys[b]
            self.logi[new_phys[b]] = b
        return state

    def _make_free_high(self, state, count):
        """Row-permute lane-destined bits parked on high slots down to
        sublane slots, releasing high slots for swap victims."""
        new_phys = list(self.phys)
        hi_parked = [b for b in range(7) if self.phys[b] >= 12]
        sub_other = [self.logi[s] for s in range(7, 12)
                     if self.logi[s] >= 7]
        moved = 0
        for b, o in zip(hi_parked, sub_other):
            if moved >= count:
                break
            new_phys[b], new_phys[o] = new_phys[o], new_phys[b]
            moved += 1
        if moved < count:
            raise RuntimeError(
                f"flush: cannot free {count} high slots (n={self.n})")
        return self._row_permute(state, new_phys)

    def flush(self, state):
        """Restore the canonical layout (logical bit b at slot b):
        identity swaps re-home the lane slots, then one row gather
        canonicalizes the row bits."""
        n = self.n
        lane_dest = set(range(7))
        while self.phys != list(range(n)):
            stuck = [a for a in range(7)
                     if self.phys[a] < 7 and self.phys[a] != a]
            if stuck:
                batch = stuck[:_MAX_KL]
                try:
                    victims = self._victims(len(batch), lane_dest)
                except _NeedHighSlots as e:
                    state = self._make_free_high(state, e.missing)
                    continue
                state = self._identity_swap(
                    state, [self.phys[a] for a in batch], victims)
                continue
            wrong = [a for a in range(7) if self.logi[a] != a]
            if wrong:
                batch = wrong[:_MAX_KL]
                need = [a for a in batch if self.phys[a] < 12]
                if need:
                    new_phys = list(self.phys)
                    frees = [s for s in range(12, n)
                             if self.logi[s] not in batch]
                    for a in need:
                        s_free = frees.pop()
                        other = self.logi[s_free]
                        new_phys[a], new_phys[other] = \
                            s_free, new_phys[a]
                    state = self._row_permute(state, new_phys)
                state = self._identity_swap(
                    state, batch, [self.phys[a] for a in batch])
                continue
            state = self._row_permute(state, list(range(n)))
        return state

    def gather(self, state, complex_type='complex64') -> torch.Tensor:
        """Flush, then the complex ``(2,)*n`` state as a tensor on the
        evolver's device."""
        state = self.flush(state)
        N = 2 ** self.n
        dtype = {np.dtype('complex64'): torch.complex64,
                 np.dtype('complex128'): torch.complex128}[
                     np.dtype(complex_type)]
        psi = torch.complex(state[:N], state[N:]).to(dtype)
        return psi.reshape((2,) * self.n)


# ---------------------------------------------------------------------
# scheduler: routing mirror + fused-aware gate pairing
# ---------------------------------------------------------------------
#
# ``MapSim`` replicates FusedEvolver's routing and layout bookkeeping
# exactly and is asserted against the recorded ``last_steps`` trace
# (tests/test_torch_fused_evolver.py).

# Per-application costs (ms) at n = _COST_N, scaled by 2^(n - _COST_N):
# every call streams the whole state once.  On the CUDA kernel the time
# follows the gate size k (2^k multiply-adds per amplitude; compute-bound
# from k = 6) and whether lane bits are exchanged, not the TPU's routing
# class (k_hi, k_l), so the tables are keyed by k:
#   _FUSED_COST[k]          apply_fused on k bits >= 7;
#   _SWAP_COST[(k, k_l)]    apply_swap on k bits, k_l of them lane bits;
#   _PARK_COST              the row gather (index_select) of a park;
#   _STEP_MS                host time of one step, which no n scales.
# Measured by chip_smoke.py's `kernels` phase (kernel ms at n = 28; the
# host time of a memoized step at n = 16) on an NVIDIA H100 80GB HBM3 at
# a 700 W power limit: k <= 5 (csrc/fused_apply.cu's column_apply_kernel),
# the park and the step in one run, k = 6..8 (its group_apply_kernel,
# 3xTF32 on the tensor cores) in a later one; PERF.md names both runs.
_COST_N = 28
_STEP_MS = 0.0685
_FUSED_COST = {1: 1.446, 2: 1.512, 3: 1.496, 4: 1.527, 5: 1.882, 6: 2.445,
               7: 4.268, 8: 7.758}
_SWAP_COST = {(1, 1): 1.825, (2, 1): 1.502, (3, 1): 1.536, (4, 1): 1.535,
              (5, 1): 2.0, (6, 1): 2.478, (7, 1): 4.401, (8, 1): 7.785,
              (2, 2): 1.669, (3, 2): 1.542, (4, 2): 1.554, (5, 2): 2.189,
              (6, 2): 2.509, (7, 2): 4.454, (8, 2): 7.926}
_PARK_COST = 2.555


def _step_cost(step, n: int, high: bool = False, k: int = None) -> float:
    """Cost (ms) of one routing step at ``n`` qubits; ``k`` is the gate
    size of a ``fused`` or ``swap`` step.  A size the kernel cannot run
    costs ``inf``.  ``high`` runs the same kernels and costs the same."""
    kind = step[0]
    if kind == 'park':
        base = _PARK_COST
    elif kind == 'ipark':       # a pair-SWAP permutation on 2c bits
        base = _FUSED_COST.get(2 * step[1], float('inf'))
    elif kind == 'evict':       # an identity on its k_l lane bits
        base = _SWAP_COST.get((step[1], step[1]), float('inf'))
    elif kind == 'fused':
        base = _FUSED_COST.get(k, float('inf'))
    else:  # swap
        base = _SWAP_COST.get((k, step[2]), float('inf'))
    return _STEP_MS + base * 2.0 ** (n - _COST_N)


class MapSim:
    """Clonable mirror of FusedEvolver's slot map + routing."""

    __slots__ = ('n', 'phys', 'logi', 'high', 'inplace')

    def __init__(self, n, phys=None, logi=None, high=False,
                 inplace=False):
        self.n = n
        self.phys = list(phys) if phys else list(range(n))
        self.logi = list(logi) if logi else list(range(n))
        self.high = bool(high)
        self.inplace = bool(inplace)

    @classmethod
    def of(cls, ev: 'FusedEvolver') -> 'MapSim':
        return cls(ev.n, ev.phys, ev.logi, ev.high, ev.inplace)

    def clone(self) -> 'MapSim':
        return MapSim(self.n, self.phys, self.logi, self.high,
                      self.inplace)

    def _victims(self, k, exclude):
        cands = sorted(
            (self.phys[b] for b in range(self.n)
             if self.phys[b] >= 12 and b not in exclude))
        if len(cands) < k:
            raise _NeedHighSlots(k - len(cands))
        return cands[:k]

    def _relabel(self, lane_slots, victim_slots):
        pairs = sorted(zip(lane_slots, victim_slots), reverse=True)
        for a, v in pairs:
            la, lv = self.logi[a], self.logi[v]
            self.phys[la], self.phys[lv] = v, a
            self.logi[a], self.logi[v] = lv, la

    def _park(self, bits_log, count):
        gate_hi = [b for b in bits_log if self.phys[b] >= 12]
        free_sub = [s for s in range(7, 12)
                    if self.logi[s] not in bits_log]
        if len(gate_hi) < count or len(free_sub) < count:
            raise RuntimeError("cannot free high slots")
        for b, s in zip(gate_hi[:count], free_sub[:count]):
            other = self.logi[s]
            pb = self.phys[b]
            self.phys[b], self.phys[other] = s, pb
            self.logi[s], self.logi[pb] = b, other

    def route_gate(self, qubits) -> list:
        """Mirror of ``FusedEvolver.apply_gate`` routing: mutates the
        sim and returns the step-class list the engine would execute
        (same tuples as ``FusedEvolver.last_steps``).  Raises on
        impossible gates (the pairing scheduler treats that as an
        illegal merge)."""
        n = self.n
        bits_log = [n - 1 - q for q in qubits]
        steps = []
        for _ in range(6):
            c = _econ_park_count(n, self.phys, self.logi, bits_log,
                                 self.high, self.inplace)
            if c:
                self._park(bits_log, c)
                steps.append(('ipark', c) if self.inplace
                             else ('park',))
            phys_bits = [self.phys[b] for b in bits_log]
            lane = sorted((b for b in phys_bits if b < 7),
                          reverse=True)
            k_l = len(lane)
            try:
                if k_l == 0:
                    k_hi = sum(1 for b in phys_bits if b >= 12)
                    if k_hi > _MAX_KE:
                        raise _NeedHighSlots(k_hi - _MAX_KE)
                    steps.append(('fused', k_hi))
                    return steps
                if k_l <= _MAX_KL:
                    k_hi = sum(1 for b in phys_bits if b >= 12)
                    if k_hi + k_l > _MAX_KE:
                        raise _NeedHighSlots(k_hi + k_l - _MAX_KE)
                    victims = self._victims(k_l, set(bits_log))
                    steps.append(('swap', k_hi + k_l, k_l))
                    self._relabel(lane, victims)
                    return steps
                to_move = sorted(
                    (self.phys[b] for b in bits_log
                     if self.phys[b] < 7), reverse=True)[:_MAX_KL]
                victims = self._victims(len(to_move), set(bits_log))
                steps.append(('evict', len(to_move)))
                self._relabel(to_move, victims)
            except _NeedHighSlots as e:
                self._park(bits_log, e.missing)
                steps.append(('ipark', e.missing) if self.inplace
                             else ('park',))
        raise NotImplementedError("route did not settle")

    def route_cost(self, qubits) -> float:
        """Cost (ms) of applying a gate on ``qubits`` NOW, without
        mutating this sim.  The gate's own step (the last) runs all
        ``len(qubits)`` bits."""
        sim = self.clone()
        return sum(_step_cost(s, self.n, self.high, len(qubits))
                   for s in sim.route_gate(qubits))


def pair_fused_gates(items, n: int, sim: MapSim = None,
                     max_k: int = 8):
    """Fuse gates into larger blocks when the routed classes say it is
    cheaper, tracking the evolving slot map.  ``items`` is a list of
    ``(U, qs)`` with dense qubit indices; gates may jump over earlier
    gates they commute with (disjoint supports).  Returns a new
    ``(U, qs)`` list."""
    from hybridq_tpu_torch.simulation.kernels import _compose_matrix_gates

    items = list(items)
    sim = sim.clone() if sim is not None else MapSim(n)
    used = [False] * len(items)
    out = []
    for i in range(len(items)):
        if used[i]:
            continue
        used[i] = True
        cur = [items[i]]
        qs_set = set(items[i][1])
        try:
            cost = sim.route_cost(tuple(qs_set))
        except (NotImplementedError, RuntimeError):
            cost = 1e9
        min_profit = 0.16 * _step_cost(('fused', 1), n, sim.high, 1)
        while len(qs_set) < max_k:
            blocked: set = set()
            best_j, best_profit, best = None, min_profit, None
            for j in range(i + 1, len(items)):
                if used[j]:
                    continue
                qsj = set(items[j][1])
                if qsj & blocked:
                    blocked |= qsj
                    continue
                union = qs_set | qsj
                if len(union) <= max_k:
                    try:
                        cu = sim.route_cost(tuple(union))
                        cj = sim.route_cost(tuple(qsj))
                    except (NotImplementedError, RuntimeError):
                        blocked |= qsj
                        continue
                    profit = cost + cj - cu
                    if profit > best_profit:
                        best_j, best_profit = j, profit
                        best = (union, cu)
                blocked |= qsj
            if best_j is None:
                break
            used[best_j] = True
            cur.append(items[best_j])
            qs_set, cost = best
        if len(cur) == 1:
            blk = cur[0]
        else:
            blk = _compose_matrix_gates(cur)
        out.append(blk)
        # advance the map exactly as apply_gate will
        sim.route_gate(tuple(blk[1]))
    return out
