"""Plain four-quarter state-vector reference for the sharded cell.

The flat complex64 state of ``n`` qubits (qubit 0 the most significant
bit, the program's axis order) lies in four quarters of ``2^(n-2)``
amplitudes, indexed by its two most significant qubits: quarter ``q``
holds the amplitudes whose qubits 0 and 1 read ``q >> 1`` and ``q & 1``,
and lives on ``devices[q]``.  The gates are ``statevector.operations``'s
(its formulas and Kronecker groups):

- a gate on qubits >= 2 runs on each quarter in place, a block of at most
  ``CHUNK`` amplitudes at a time (``statevector``'s own product, on the
  quarter as a state of ``n - 2`` qubits);
- a gate that touches qubit 0 or 1 mixes 2 or 4 quarters.  For each block
  of local offsets, the matching blocks of those quarters (together at
  most ``CHUNK`` amplitudes) are made contiguous on their own devices,
  copied onto one device, the devices taking the blocks in turn, stacked
  so that the quarters' bits are leading axes, multiplied there, and
  copied back.

Every gate's matrix is uploaded to every device before the first product,
so that no upload waits for a device in the middle of the circuit.

Nothing here follows the program's layout: no qubit ever moves between a
quarter's number and its offsets.  Matrix products run with TF32 off;
``tf32=True`` is the control, with both operands of every product rounded
to TF32 first, as in ``statevector``.

Imports nothing of the program or of JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from reference.statevector import (CHUNK, _apply, no_tf32, operations,
                                   round_tf32)

__all__ = ['QUARTERS', 'evolve', 'amplitudes']

QUARTERS = 4        # the state's split, by its two most significant qubits


def _legs_ascending(u: torch.Tensor, axes):
    """``(u, axes)`` with u's legs reordered so that ``axes`` ascend."""
    k = len(axes)
    order = sorted(range(k), key=lambda j: axes[j])
    if order != list(range(k)):
        perm = order + [k + j for j in order]
        u = u.reshape((2,) * 2 * k).permute(perm).reshape(2 ** k, 2 ** k)
    return u, sorted(axes)


def _dims(m: int, gate_axes):
    """A quarter of ``m`` qubits as dims: size 2 for each of
    ``gate_axes``, merged runs of the other axes between them.  Returns
    ``(shape, gate dims, other dims)``; a state the gate spans gets a
    trailing dim of 1."""
    shape, is_gate = [], []
    for a in range(m):
        if a in gate_axes:
            shape.append(2)
            is_gate.append(True)
        elif shape and not is_gate[-1]:
            shape[-1] *= 2
        else:
            shape.append(2)
            is_gate.append(False)
    g_dims = [d for d, g in enumerate(is_gate) if g]
    o_dims = [d for d, g in enumerate(is_gate) if not g]
    if not o_dims:
        o_dims, shape = [len(shape)], shape + [1]
    return shape, g_dims, o_dims


def _apply_across(quarters, n: int, us, axes, devices, tf32: bool):
    """The gate ``us`` (``{device: matrix}``, its legs in ascending axis
    order) on ``axes`` (ascending), some of them 0 or 1, over the
    quarters it mixes."""
    top = [a for a in axes if a < 2]              # the quarters' bits
    m = n - 2
    shape, g_dims, o_dims = _dims(m, [a - 2 for a in axes if a >= 2])
    if tf32:
        us = {d: round_tf32(u) for d, u in us.items()}
    t = len(top)
    free = [b for b in (0, 1) if b not in top]
    groups = []
    for fixed in range(2 ** len(free)):
        bits = dict(zip(free, ((fixed >> (len(free) - 1 - j)) & 1
                               for j in range(len(free)))))
        members = []
        for v in range(2 ** t):
            bits.update(zip(top, ((v >> (t - 1 - j)) & 1
                                  for j in range(t))))
            members.append(2 * bits[0] + bits[1])
        groups.append(members)
    cut = max(o_dims, key=lambda d: shape[d])
    step = max(1, shape[cut] * (CHUNK >> t) // 2 ** m)
    # the stacked blocks: the quarters' bits, then the quarter's dims
    z_gate = list(range(t)) + [t + d for d in g_dims]
    z_other = [t + d for d in o_dims]
    turn = 0
    for members in groups:
        for s in range(0, shape[cut], step):
            dev = devices[turn % len(devices)]
            turn += 1
            blks = [quarters[q].view(shape).narrow(
                cut, s, min(step, shape[cut] - s)) for q in members]
            z = torch.stack([b.contiguous().to(dev) for b in blks])
            z = z.view([2] * t + list(blks[0].shape))
            moved = z.permute(z_gate + z_other)
            x = moved.reshape(2 ** len(axes), -1)
            if tf32:
                x = round_tf32(x)
            with no_tf32():
                y = torch.matmul(us[dev], x)
            moved.copy_(y.view(moved.shape))
            z = z.reshape([len(members)] + list(blks[0].shape))
            for j, b in enumerate(blks):
                b.copy_(z[j].to(b.device))


def evolve(gates, n: int, devices, tf32: bool = False, on_phase=None):
    """The four quarters of ``C|0...0>`` for the circuit ``gates``
    (``[(name, qubits, params), ...]``) on ``n`` qubits, quarter ``q`` a
    flat complex64 tensor on ``devices[q]``.  ``on_phase``, where given,
    is called as each phase begins: ``'upload'``, then ``'within'`` (gates
    on qubits >= 2) and ``'across'`` (gates on qubit 0 or 1) as they
    alternate, and ``None`` at the end."""
    devices = [torch.device(d) for d in devices]
    if len(devices) != QUARTERS:
        raise ValueError(f"the reference takes {QUARTERS} devices")
    phase = [None]

    def enter(name):
        if on_phase is not None and name != phase[0]:
            phase[0] = name
            on_phase(name)

    enter('upload')
    m = n - 2
    quarters = [torch.zeros(2 ** m, dtype=torch.complex64, device=d)
                for d in devices]
    quarters[0][0] = 1
    plan = []
    for u, axes in operations(gates, n):
        u = torch.as_tensor(u, dtype=torch.complex64)
        if min(axes) < 2:
            u, axes = _legs_ascending(u, axes)
        plan.append(({d: u.to(d) for d in dict.fromkeys(devices)}, axes))
    for us, axes in plan:
        if min(axes) < 2:
            enter('across')
            _apply_across(quarters, n, us, axes, devices, tf32)
            continue
        enter('within')
        for q, d in zip(quarters, devices):
            _apply(q, m, us[d], [a - 2 for a in axes], tf32)
    if on_phase is not None:
        on_phase(None)
    return quarters


def amplitudes(gates, n: int, index: torch.Tensor, devices,
               tf32: bool = False, on_phase=None) -> np.ndarray:
    """The amplitudes ``<index|C|0...0>`` (``index`` flat, qubit 0 the
    most significant bit) as a complex64 host array; ``on_phase`` as in
    ``evolve``."""
    quarters = evolve(gates, n, devices, tf32, on_phase)
    m = n - 2
    first = quarters[0].device
    index = torch.as_tensor(index, dtype=torch.int64).to(first)
    out = torch.zeros(index.shape, dtype=torch.complex64, device=first)
    for q, quarter in enumerate(quarters):
        off = (index & (2 ** m - 1)).to(quarter.device)
        out = torch.where((index >> m) == q, quarter[off].to(first), out)
    del quarters
    return out.cpu().numpy()
