"""In-place gate kernels on the split-complex state container.

The counterpart of ``hybridq_tpu/simulation/pallas_fused.py``.  The
container is the JAX engine's: a contiguous f32 tensor of ``2^(n+1)``
floats, the real part of physical amplitude ``p`` at ``p`` and the
imaginary part at ``p + 2^n`` (physical bit ``n`` is the "stack" bit), so
that containers and slot maps compare one to one with JAX.

Four wrappers, each with a plain PyTorch version beside it:

  * ``apply_bits(state, U, bits)`` applies ``U`` at any distinct flat
    bits, lane bits 0-6 included, in place: the straight route of
    ``IndexedEvolver``, which keeps the layout canonical;
  * ``apply_fused(state, U, bits)`` applies the complex ``2^k x 2^k``
    matrix ``U`` to physical bits ``bits`` (MSB of the U index first, all
    >= 7), in place: ``psi'[p] = sum_j U[i(p), j] psi[p with bits := j]``;
  * ``apply_swap(state, U, bits, victims)`` applies ``U`` to ``bits``,
    1-2 of which are lane bits (< 7), and stores amplitude ``p`` at
    ``sigma(p)``, where sigma swaps lane bit ``a_j`` (lane bits sorted
    descending) with victim bit ``victims[j]`` (>= 12).  The caller
    records the relabel in its slot map, as JAX's fused engine does; no
    engine of this package calls it;
  * ``apply_factored(state, U_row, row_bits, U_lane, lane_bits)`` applies
    ``U_row (x) U_lane`` to ``row_bits + lane_bits`` (row bits >= 7, lane
    bits < 7), the counterpart of ``pallas_fused.factored_kernel``.

A CUDA tensor goes to the kernel (``csrc/fused_apply.cu``,
``csrc/factored_apply.cu``) or raises; a CPU tensor goes to the plain
version.  The TPU kernels' ``build_w`` / ``build_w_swap`` /
``build_w_factored`` operators and 0/1 lane-combine matrices are not
carried over: the CUDA kernels take the gate's own matrices.

Launch counters are plain ints on this module; ``reset_counts`` zeroes
them and ``counts`` reads them.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from hybridq_tpu_torch.simulation._device import span

__all__ = ['fused_meta', 'swap_meta', 'apply_bits', 'apply_fused',
           'apply_swap', 'apply_factored', 'apply_bits_plain',
           'apply_fused_plain', 'apply_swap_plain', 'apply_factored_plain',
           'reset_counts', 'counts', 'FUSED_RUN_ROWS']

FUSED_RUN_ROWS = 32
_SUB_BITS = 5          # log2(FUSED_RUN_ROWS)
_LANE_BITS = 7         # 128 lanes = flat bits 0-6
_MAX_K = 8             # largest gate the CUDA kernel takes
# Largest U_row of apply_factored: JAX's k_hi <= 4 high bits plus the 5
# sublane bits.
_MAX_ROW_BITS = 9

# Launches of each CUDA kernel, and calls of each plain version.
bits_launches = 0
fused_launches = 0
swap_launches = 0
factored_launches = 0
fused_plain_calls = 0
swap_plain_calls = 0
factored_plain_calls = 0
bits_plain_calls = 0


def reset_counts():
    global bits_launches, fused_launches, swap_launches, \
        factored_launches, bits_plain_calls, fused_plain_calls, \
        swap_plain_calls, factored_plain_calls
    bits_launches = fused_launches = swap_launches = factored_launches = 0
    bits_plain_calls = fused_plain_calls = swap_plain_calls = \
        factored_plain_calls = 0


def counts() -> dict:
    return {'apply_bits': bits_launches, 'fused_apply': fused_launches,
            'swap_apply': swap_launches,
            'factored_apply': factored_launches,
            'apply_bits_plain': bits_plain_calls,
            'apply_fused_plain': fused_plain_calls,
            'apply_swap_plain': swap_plain_calls,
            'apply_factored_plain': factored_plain_calls}


# -- host metadata (copied from pallas_fused.py) -----------------------

def _classify_bits(n: int, bits: Sequence[int]):
    """Split flat amplitude bits into (high desc, sublane desc, lane
    desc) relative to the fused layout."""
    hi = sorted((b for b in bits if b >= _LANE_BITS + _SUB_BITS),
                reverse=True)
    sub = sorted((b for b in bits
                  if _LANE_BITS <= b < _LANE_BITS + _SUB_BITS),
                 reverse=True)
    lane = sorted((b for b in bits if b < _LANE_BITS), reverse=True)
    return hi, sub, lane


def fused_meta(n: int, bits: Sequence[int]):
    """Host metadata of the TPU fused kernel for a gate on flat bits
    ``bits`` (all >= 7): ``(k_hi, h_offs[int32 H2], rest_mask, uperm,
    sperm)``.  The routing reads ``k_hi``, the kernel class."""
    bits = [int(b) for b in bits]
    if any(b < _LANE_BITS for b in bits):
        raise ValueError("fused kernel handles bits >= 7 only")
    hi, sub, _ = _classify_bits(n, bits)
    k_hi = len(hi)
    n_run_bits = n + 1 - _LANE_BITS - _SUB_BITS   # incl. stack bit
    stack_run_bit = n_run_bits - 1

    H2 = 2 ** (k_hi + 1)
    h_offs = np.zeros(H2, dtype=np.int32)
    for h in range(H2):
        off = (h >> k_hi) << stack_run_bit
        for j, b in enumerate(hi):
            if (h >> (k_hi - 1 - j)) & 1:
                off |= 1 << (b - _LANE_BITS - _SUB_BITS)
        h_offs[h] = off

    gate_run_bits = {stack_run_bit}
    gate_run_bits.update(b - _LANE_BITS - _SUB_BITS for b in hi)
    rest_mask = 0
    for p in range(n_run_bits):
        if p not in gate_run_bits:
            rest_mask |= 1 << p

    kernel_order = hi + sub
    k = len(bits)
    order = [bits.index(b) for b in kernel_order]
    i = np.arange(2 ** k, dtype=np.int32)
    uperm = np.zeros(2 ** k, dtype=np.int32)
    for a, oa in enumerate(order):
        uperm |= ((i >> (k - 1 - a)) & 1) << (k - 1 - oa)

    sub_rel = [b - _LANE_BITS for b in sub]
    rest_rel = [p for p in range(_SUB_BITS) if p not in sub_rel]
    x = np.arange(FUSED_RUN_ROWS, dtype=np.int32)
    gate_part = np.zeros_like(x)
    for j, p in enumerate(sub_rel):
        gate_part |= ((x >> p) & 1) << (len(sub_rel) - 1 - j)
    rest_part = np.zeros_like(x)
    for i2, p in enumerate(rest_rel):
        rest_part |= ((x >> p) & 1) << i2
    sperm = (gate_part << len(rest_rel)) | rest_part
    return k_hi, h_offs, int(rest_mask), uperm, sperm.astype(np.int32)


def swap_meta(n: int, bits: Sequence[int], victims: Sequence[int]):
    """Host metadata of the TPU swap kernel: gate on flat ``bits`` whose
    lane bits are exchanged with flat high bits ``victims`` (one per lane
    bit, each >= 12, not in ``bits``).  Returns ``(k_hi, k_l, h_offs,
    rest_mask)``; the TPU kernel's lane-combine matrices are not needed
    here."""
    bits = [int(b) for b in bits]
    victims = [int(v) for v in victims]
    hi, sub, lane = _classify_bits(n, bits)
    k_hi, k_l = len(hi), len(lane)
    if len(victims) != k_l:
        raise ValueError("need one victim high bit per lane bit")
    if any(v < _LANE_BITS + _SUB_BITS or v in bits for v in victims):
        raise ValueError("victims must be free high bits")
    n_run_bits = n + 1 - _LANE_BITS - _SUB_BITS
    stack_run_bit = n_run_bits - 1

    hbits = victims + hi
    ke = len(hbits)
    H2 = 2 ** (ke + 1)
    h_offs = np.zeros(H2, dtype=np.int32)
    for h in range(H2):
        off = (h >> ke) << stack_run_bit
        for j, b in enumerate(hbits):
            if (h >> (ke - 1 - j)) & 1:
                off |= 1 << (b - _LANE_BITS - _SUB_BITS)
        h_offs[h] = off
    gate_run_bits = {stack_run_bit}
    gate_run_bits.update(b - _LANE_BITS - _SUB_BITS for b in hbits)
    rest_mask = 0
    for p in range(n_run_bits):
        if p not in gate_run_bits:
            rest_mask |= 1 << p
    return k_hi, k_l, h_offs, int(rest_mask)


# -- argument checks ---------------------------------------------------

def _n_of(state: torch.Tensor) -> int:
    if state.dtype != torch.float32 or state.dim() != 1 or \
            not state.is_contiguous():
        raise ValueError("state must be a contiguous 1-D float32 tensor")
    size = state.numel()
    n = size.bit_length() - 2
    if n < 1 or size != 2 ** (n + 1):
        raise ValueError("state must hold 2^(n+1) floats, n >= 1")
    return n


def _halves(state: torch.Tensor, n: int):
    """The re and im halves of the container (views)."""
    return state[:2 ** n], state[2 ** n:]


def _check_bits(n, bits, victims=(), max_k=_MAX_K):
    allb = list(bits) + list(victims)
    if len(set(allb)) != len(allb) or any(not 0 <= b < n for b in allb):
        raise ValueError(f"bits {list(bits)} / victims {list(victims)} "
                         f"must be distinct and in [0, {n})")
    if not 1 <= len(bits) <= max_k:
        raise ValueError(f"gates of 1..{max_k} qubits only")


def _operand(U, k: int, device) -> torch.Tensor:
    U = torch.as_tensor(U).to(device=device, dtype=torch.complex64)
    if U.shape != (2 ** k, 2 ** k):
        raise ValueError(f"U must be {2 ** k}x{2 ** k}, got {U.shape}")
    return U.contiguous()


def _kernel_device(t: torch.Tensor):
    """True for a CUDA tensor (the kernel's), False for a CPU tensor (the
    plain version's); raises for any other device."""
    if t.device.type == 'cpu':
        return False
    if t.device.type != 'cuda':
        raise ValueError(f"no kernel for device {t.device}")
    return True


def _swap_pairs(bits, victims):
    """Lane bits sorted descending, paired with ``victims`` in order (the
    pairing of ``pallas_fused.swap_meta``)."""
    lane = sorted((int(b) for b in bits if b < _LANE_BITS), reverse=True)
    victims = [int(v) for v in victims]
    if not 1 <= len(lane) <= 2 or len(victims) != len(lane):
        raise ValueError("swap path takes 1-2 lane bits, one victim each")
    if any(v < _LANE_BITS + _SUB_BITS for v in victims):
        raise ValueError("victims must be high bits (>= 12)")
    return lane, victims


# -- CUDA launch -------------------------------------------------------

_INT, _INT_P, _PTR = ctypes.c_int, ctypes.POINTER(ctypes.c_int), \
    ctypes.c_void_p


def _c_function(source: str, name: str, argtypes):
    """``name`` of the library built from ``csrc/<source>.cu``, with its
    argument types declared (pointers and the stream as ``c_void_p``, so
    that ctypes does not cut them to 32 bits)."""
    from hybridq_tpu_torch.simulation import _build

    fn = getattr(_build.load(source), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _ints(values, size):
    return (ctypes.c_int * size)(*values)


def _stream(t: torch.Tensor) -> int:
    """The ``cudaStream_t`` of PyTorch's current stream on ``t``'s card,
    read as PyTorch's own generated launchers read it: without building a
    ``torch.cuda.Stream`` object, which costs microseconds a launch."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _check_launch(err, what):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _launch(re, im, U, n, bits, lane, victims):
    """``hq_group_apply`` on the real parts ``re`` and imaginary parts
    ``im`` (two tensors of ``2^n`` floats on one card)."""
    # re, im, U, n, k, gbits, kv, abits, vbits, stream
    fn = _c_function('fused_apply', 'hq_group_apply',
                     [_PTR, _PTR, _PTR, _INT, _INT, _INT_P, _INT, _INT_P,
                      _INT_P, _PTR])
    if not U.device == re.device == im.device:
        raise ValueError("U, re and im must be on the same device")
    with torch.cuda.device(re.device):
        err = fn(re.data_ptr(), im.data_ptr(), U.data_ptr(), n, len(bits),
                 _ints(bits, _MAX_K), len(victims), _ints(lane, 2),
                 _ints(victims, 2), _stream(re))
    _check_launch(err, f"fused_apply (n={n}, bits={bits}, "
                       f"victims={victims})")


# -- wrappers ----------------------------------------------------------

def apply_bits(state: torch.Tensor, U, bits: Sequence[int]) -> torch.Tensor:
    """Apply the k = 1..8 qubit gate ``U`` to any distinct flat bits
    ``bits`` (MSB of the U index first) of ``state`` in place; returns
    ``state``.  ``U`` is best a complex64 tensor already on the state's
    device: the launch then uploads nothing."""
    global bits_launches
    n = _n_of(state)
    bits = [int(b) for b in bits]
    _check_bits(n, bits)
    with span('hq.apply_bits', k=len(bits), lo=min(bits), n=n):
        if not _kernel_device(state):
            return apply_bits_plain(state, U, bits)
        U = _operand(U, len(bits), state.device)
        _launch(*_halves(state, n), U, n, bits, [], [])
    bits_launches += 1
    return state


def apply_fused(state: torch.Tensor, U, bits: Sequence[int]
                ) -> torch.Tensor:
    """Apply ``U`` to physical bits ``bits`` (all >= 7) of ``state`` in
    place; returns ``state``."""
    global fused_launches
    n = _n_of(state)
    bits = [int(b) for b in bits]
    _check_bits(n, bits)
    if any(b < _LANE_BITS for b in bits):
        raise ValueError("apply_fused handles bits >= 7 only")
    if not _kernel_device(state):
        return apply_fused_plain(state, U, bits)
    U = _operand(U, len(bits), state.device)
    _launch(*_halves(state, n), U, n, bits, [], [])
    fused_launches += 1
    return state


def apply_swap(state: torch.Tensor, U, bits: Sequence[int],
               victims: Sequence[int]) -> torch.Tensor:
    """Apply ``U`` to ``bits`` and exchange each lane bit with its victim
    bit, in place; returns ``state``."""
    global swap_launches
    n = _n_of(state)
    bits = [int(b) for b in bits]
    _check_bits(n, bits, victims)
    lane, victims = _swap_pairs(bits, victims)
    if not _kernel_device(state):
        return apply_swap_plain(state, U, bits, victims)
    U = _operand(U, len(bits), state.device)
    _launch(*_halves(state, n), U, n, bits, lane, victims)
    swap_launches += 1
    return state


def _factored_args(state, U_row, row_bits, U_lane, lane_bits):
    n = _n_of(state)
    row_bits = [int(b) for b in row_bits]
    lane_bits = [int(b) for b in lane_bits]
    _check_bits(n, row_bits + lane_bits,
                max_k=_MAX_ROW_BITS + _LANE_BITS)
    if n < _LANE_BITS:
        raise ValueError(f"apply_factored needs n >= {_LANE_BITS}")
    if any(b < _LANE_BITS for b in row_bits) or \
            any(b >= _LANE_BITS for b in lane_bits):
        raise ValueError("row_bits must be >= 7 and lane_bits < 7")
    if not 1 <= len(lane_bits) <= _LANE_BITS:
        raise ValueError("lane_bits must hold 1..7 bits")
    if len(row_bits) > _MAX_ROW_BITS:
        raise ValueError(f"U_row of at most {_MAX_ROW_BITS} "
                         f"qubits, got {len(row_bits)}")
    U_row = _operand(np.ones((1, 1)) if U_row is None else U_row,
                     len(row_bits), state.device)
    U_lane = _operand(U_lane, len(lane_bits), state.device)
    if not row_bits:        # a 1x1 U_row is a scalar: fold it into U_lane
        U_lane = U_lane * U_row[0, 0]
    return n, U_row, row_bits, U_lane, lane_bits


def apply_factored(state: torch.Tensor, U_row, row_bits: Sequence[int],
                   U_lane, lane_bits: Sequence[int]) -> torch.Tensor:
    """Apply ``U_row (x) U_lane`` to ``row_bits + lane_bits`` (MSB of each
    factor first; ``row_bits`` >= 7, possibly empty with ``U_row`` None or
    1x1; 1..7 ``lane_bits`` < 7) of ``state`` in place; returns
    ``state``."""
    global factored_launches
    if not _kernel_device(state):
        return apply_factored_plain(state, U_row, row_bits, U_lane,
                                    lane_bits)
    n, U_row, row_bits, U_lane, lane_bits = _factored_args(
        state, U_row, row_bits, U_lane, lane_bits)
    if state.data_ptr() % 16:
        raise ValueError("apply_factored needs a 16-byte aligned state")
    # re, im, n, U_row, kr, row_bits, U_lane, kl, lane_bits, stream
    fn = _c_function('factored_apply', 'hq_factored_apply',
                     [_PTR, _PTR, _INT, _PTR, _INT, _INT_P, _PTR, _INT,
                      _INT_P, _PTR])
    re, im = _halves(state, n)
    with torch.cuda.device(state.device):
        err = fn(re.data_ptr(), im.data_ptr(), n, U_row.data_ptr(),
                 len(row_bits), _ints(row_bits, _MAX_ROW_BITS),
                 U_lane.data_ptr(), len(lane_bits),
                 _ints(lane_bits, _LANE_BITS), _stream(state))
    _check_launch(err, f"factored_apply (n={n}, row_bits={row_bits}, "
                       f"lane_bits={lane_bits})")
    factored_launches += 1
    return state


# -- plain versions ----------------------------------------------------

def _group_index(n, bits, victims, device) -> torch.Tensor:
    """``idx[j, c]``: physical index of gate row ``j`` of column ``c``;
    columns run over (victim combination, rest index)."""
    group = sorted(set(bits) | set(victims))
    rest_bits = [b for b in range(n) if b not in group]
    r = torch.arange(2 ** len(rest_bits), dtype=torch.int64, device=device)
    base = torch.zeros_like(r)
    for i, b in enumerate(rest_bits):
        base |= ((r >> i) & 1) << b
    kv = len(victims)
    c = torch.arange(2 ** kv, dtype=torch.int64, device=device)
    voff = torch.zeros_like(c)
    for j, v in enumerate(victims):
        voff |= ((c >> (kv - 1 - j)) & 1) << v
    k = len(bits)
    j = torch.arange(2 ** k, dtype=torch.int64, device=device)
    goff = torch.zeros_like(j)
    for a, b in enumerate(bits):
        goff |= ((j >> (k - 1 - a)) & 1) << b
    cols = (voff[:, None] | base[None, :]).reshape(-1)
    return goff[:, None] | cols[None, :]


def _plain(re, im, n, U, bits, lane=(), victims=()):
    """Gather, complex64 matmul and scatter on the real parts ``re`` and
    imaginary parts ``im`` (``2^n`` floats each), in place."""
    U = _operand(U, len(bits), re.device)
    idx = _group_index(n, bits, victims, re.device)
    X = torch.complex(re[idx], im[idx])
    Y = torch.matmul(U, X)
    del X
    for a, v in zip(lane, victims):
        d = ((idx >> a) ^ (idx >> v)) & 1
        idx ^= (d << a) | (d << v)
    re[idx] = Y.real
    im[idx] = Y.imag


def apply_bits_plain(state: torch.Tensor, U, bits: Sequence[int]
                     ) -> torch.Tensor:
    """Plain PyTorch version of ``apply_bits`` (gather, complex64 matmul,
    scatter)."""
    global bits_plain_calls
    bits_plain_calls += 1
    n = _n_of(state)
    bits = [int(b) for b in bits]
    _check_bits(n, bits)
    _plain(*_halves(state, n), n, U, bits)
    return state


def apply_fused_plain(state: torch.Tensor, U, bits: Sequence[int]
                      ) -> torch.Tensor:
    """Plain PyTorch version of ``apply_fused`` (gather, complex64
    matmul, scatter)."""
    global fused_plain_calls
    fused_plain_calls += 1
    n = _n_of(state)
    _plain(*_halves(state, n), n, U, [int(b) for b in bits])
    return state


def apply_swap_plain(state: torch.Tensor, U, bits: Sequence[int],
                     victims: Sequence[int]) -> torch.Tensor:
    """Plain PyTorch version of ``apply_swap``."""
    global swap_plain_calls
    swap_plain_calls += 1
    bits = [int(b) for b in bits]
    lane, victims = _swap_pairs(bits, victims)
    n = _n_of(state)
    _plain(*_halves(state, n), n, U, bits, lane, victims)
    return state


def apply_factored_plain(state: torch.Tensor, U_row, row_bits, U_lane,
                         lane_bits) -> torch.Tensor:
    """Plain PyTorch version of ``apply_factored``: the two factors one
    after the other (they act on disjoint bits, so they commute), each a
    gather, complex64 matmul and scatter; never their 2^(kr+kl) product."""
    global factored_plain_calls
    factored_plain_calls += 1
    n, U_row, row_bits, U_lane, lane_bits = _factored_args(
        state, U_row, row_bits, U_lane, lane_bits)
    re, im = _halves(state, n)
    _plain(re, im, n, U_lane, lane_bits)
    if row_bits:
        _plain(re, im, n, U_row, row_bits)
    return state
