"""In-place gate on the row index of separate flat re/im arrays.

The counterpart of ``hybridq_tpu/simulation/pallas_kernels.py``: the
state is two flat f32 tensors of ``2^n`` floats, real and imaginary parts,
viewed as rows of ``2^L`` amplitudes; a k-qubit gate acts on bits of the
row index.  Row bit ``p`` is flat bit ``p + L``.

``apply_gate_rows`` runs the engine's CUDA kernels (``csrc/fused_apply.cu``,
``hq_group_apply``) on the two tensors; a CPU tensor goes to
``apply_gate_rows_plain``.  The TPU kernel's ``kron(U, I(8*RL))`` operator
and run-length DMAs are not carried over: the kernel takes ``U`` itself.

``gate_rows_launches`` counts the kernel's launches; ``reset_counts``
zeroes it and ``counts`` reads it.
"""

from __future__ import annotations

from typing import Sequence

import torch

from hybridq_tpu_torch.simulation import fused_kernels as fk

__all__ = ['apply_gate_rows', 'apply_gate_rows_plain', 'reset_counts',
           'counts']

gate_rows_launches = 0
gate_rows_plain_calls = 0


def reset_counts():
    global gate_rows_launches, gate_rows_plain_calls
    gate_rows_launches = gate_rows_plain_calls = 0


def counts() -> dict:
    return {'apply_gate_rows': gate_rows_launches,
            'apply_gate_rows_plain': gate_rows_plain_calls}


def _args(re, im, Ur, Ui, row_positions, n, L):
    """Checked ``(flat gate bits, complex U)``."""
    n, L = int(n), int(L)
    for t in (re, im):
        if t.dtype != torch.float32 or t.dim() != 1 or \
                not t.is_contiguous() or t.numel() != 2 ** n:
            raise ValueError(f"re and im must be contiguous 1-D float32 "
                             f"tensors of 2^n = {2 ** n} floats")
    if re.device != im.device:
        raise ValueError("re and im must be on the same device")
    pos = [int(p) for p in row_positions]
    k = len(pos)
    if not 1 <= k <= fk._MAX_K:
        raise ValueError(f"gates of 1..{fk._MAX_K} qubits only (the CUDA "
                         f"kernel's limit), got {k}")
    if not 0 <= L < n or len(set(pos)) != k or \
            any(not 0 <= p < n - L for p in pos):
        raise ValueError(f"row_positions {pos} must be distinct row bits "
                         f"in [0, n - L) = [0, {n - L})")
    U = torch.complex(torch.as_tensor(Ur, dtype=torch.float32),
                      torch.as_tensor(Ui, dtype=torch.float32))
    return [p + L for p in pos], fk._operand(U, k, re.device)


def apply_gate_rows(re: torch.Tensor, im: torch.Tensor, Ur, Ui,
                    row_positions: Sequence[int], n: int, L: int):
    """Apply the k-qubit gate ``Ur + i Ui`` (``2^k x 2^k`` f32 each) to
    row bits ``row_positions`` (gate MSB first; flat bits ``p + L``) of the
    state ``re + i im``, in place; returns ``(re, im)``."""
    global gate_rows_launches
    bits, U = _args(re, im, Ur, Ui, row_positions, n, L)
    if not fk._kernel_device(re):
        return apply_gate_rows_plain(re, im, Ur, Ui, row_positions, n, L)
    fk._launch(re, im, U, int(n), bits, [], [])
    gate_rows_launches += 1
    return re, im


def apply_gate_rows_plain(re: torch.Tensor, im: torch.Tensor, Ur, Ui,
                          row_positions: Sequence[int], n: int, L: int):
    """Plain PyTorch version of ``apply_gate_rows`` (gather, complex64
    matmul, scatter)."""
    global gate_rows_plain_calls
    gate_rows_plain_calls += 1
    bits, U = _args(re, im, Ur, Ui, row_positions, n, L)
    fk._plain(re, im, int(n), U, bits)
    return re, im
