"""Plain state-vector reference for the benchmark's circuits.

Plain PyTorch: the gate matrices come from their formulas here, the state
is a flat complex64 vector with qubit 0 as the most significant bit (the
program's axis order), and each gate is a matrix product on the axes it
acts on.  A run of one-qubit gates is applied as Kronecker products of
``GROUP`` neighbouring qubits.  The state is updated in place, a block of
at most ``CHUNK`` amplitudes at a time, so that at 32 qubits it needs the
state's 32 GiB and a few GiB more.  Matrix products run with TF32 off.

``tf32=True`` is the control: both operands of every product rounded to
TF32 (10 mantissa bits, to nearest) first, which is what the tensor cores
do with TF32 on; the sums stay in float32.

Imports nothing of the program or of JAX.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

__all__ = ['gate_matrix', 'operations', 'evolve', 'amplitudes',
           'round_tf32', 'no_tf32', 'GROUP', 'CHUNK']

GROUP = 4           # one-qubit gates merged into one product of 2^4 x 2^4
CHUNK = 2 ** 27     # amplitudes of the state updated by one product

_S2 = np.sqrt(2.0)


def gate_matrix(name: str, params=()) -> np.ndarray:
    """The complex128 matrix of one gate of the benchmark's circuits.
    SQRT_X and SQRT_Y are the principal square roots of X and Y;
    R_PI_2(phi) is the pi/2 rotation about cos(phi) X + sin(phi) Y, which
    at phi = pi/4 is Arute et al.'s sqrt(W); FSIM(theta, phi) is their
    fSim."""
    if name == 'SQRT_X':
        return 0.5 * np.array([[1 + 1j, 1 - 1j], [1 - 1j, 1 + 1j]])
    if name == 'SQRT_Y':
        return 0.5 * np.array([[1 + 1j, -1 - 1j], [1 + 1j, 1 + 1j]])
    if name == 'R_PI_2':
        (phi,) = params
        return np.array([[1, -1j * np.exp(-1j * phi)],
                         [-1j * np.exp(1j * phi), 1]]) / _S2
    if name == 'FSIM':
        theta, phi = params
        c, s = np.cos(theta), -1j * np.sin(theta)
        return np.array([[1, 0, 0, 0], [0, c, s, 0], [0, s, c, 0],
                         [0, 0, 0, np.exp(-1j * phi)]])
    raise ValueError(f"no formula for gate {name!r}")


def operations(gates, n: int, group: int = GROUP):
    """``[(matrix, axes), ...]`` to apply in order.  Each maximal run of
    one-qubit gates on distinct qubits becomes one Kronecker product for
    each block of ``group`` neighbouring axes that it touches; every other
    gate is applied as it is."""
    ops, run = [], {}

    def flush():
        for b in sorted({q // group for q in run}):
            axes = [q for q in range(b * group, min((b + 1) * group, n))
                    if q in run]
            m = np.ones((1, 1), dtype=complex)
            for q in axes:
                m = np.kron(m, run[q])
            ops.append((m, tuple(axes)))
        run.clear()

    for name, qubits, params in gates:
        u = gate_matrix(name, params)
        if len(qubits) == 1 and qubits[0] not in run:
            run[qubits[0]] = u
            continue
        flush()
        if len(qubits) == 1:
            run[qubits[0]] = u
        else:
            ops.append((u, tuple(qubits)))
    flush()
    return ops


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32 or complex64) with every float rounded to the
    nearest TF32 value (10 mantissa bits), as a new tensor."""
    f = torch.view_as_real(x) if x.is_complex() else x
    i = f.contiguous().view(torch.int32)
    i = (i + 0x1000) & ~0x1FFF
    f = i.view(torch.float32)
    return torch.view_as_complex(f) if x.is_complex() else f


@contextlib.contextmanager
def no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _apply(psi: torch.Tensor, n: int, u: torch.Tensor, axes, tf32: bool):
    """``psi`` (flat, 2^n) <- ``u`` on ``axes`` (the first axis the most
    significant bit of u's index), in place, a block at a time."""
    order = sorted(range(len(axes)), key=lambda j: axes[j])
    k = len(axes)
    if order != list(range(k)):          # u's legs in ascending axis order
        perm = order + [k + j for j in order]
        u = u.reshape((2,) * 2 * k).permute(perm).reshape(2 ** k, 2 ** k)
    gate = set(axes)
    # the state as dims of size 2 (gate axes) and merged runs of the rest
    shape, is_gate = [], []
    for a in range(n):
        if a in gate:
            shape.append(2)
            is_gate.append(True)
        elif shape and not is_gate[-1]:
            shape[-1] *= 2
        else:
            shape.append(2)
            is_gate.append(False)
    view = psi.view(shape)
    g_dims = [d for d, g in enumerate(is_gate) if g]
    o_dims = [d for d, g in enumerate(is_gate) if not g]
    # split the largest other dim so that a block holds <= CHUNK amplitudes
    if not o_dims:                       # the gate spans the state
        o_dims, shape, view = [len(shape)], shape + [1], view[..., None]
    cut = max(o_dims, key=lambda d: shape[d])
    step = max(1, shape[cut] * CHUNK // psi.numel())
    if tf32:
        u = round_tf32(u)
    for s in range(0, shape[cut], step):
        blk = view.narrow(cut, s, min(step, shape[cut] - s))
        moved = blk.permute(g_dims + o_dims)
        x = moved.reshape(2 ** k, -1)
        if tf32:
            x = round_tf32(x)
        with no_tf32():
            y = torch.matmul(u, x)
        moved.copy_(y.view(moved.shape))


def evolve(gates, n: int, device, tf32: bool = False) -> torch.Tensor:
    """The flat complex64 state ``C|0...0>`` of the circuit ``gates``
    (``[(name, qubits, params), ...]``) on ``n`` qubits."""
    psi = torch.zeros(2 ** n, dtype=torch.complex64, device=device)
    psi[0] = 1
    for u, axes in operations(gates, n):
        _apply(psi, n, torch.as_tensor(u, dtype=torch.complex64,
                                       device=device), axes, tf32)
    return psi


def amplitudes(gates, n: int, index: torch.Tensor, device,
               tf32: bool = False) -> np.ndarray:
    """The amplitudes ``<index|C|0...0>`` as a complex64 host array."""
    psi = evolve(gates, n, device, tf32)
    out = psi.index_select(0, index.to(device)).cpu().numpy()
    del psi
    return out
