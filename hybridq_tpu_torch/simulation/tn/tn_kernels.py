"""Contraction steps with a small operand, at the legs where they lie.

``tn_apply(x, op, step)`` contracts the larger operand ``x`` (every leg of
size 2, the slice batch in front when ``step.x_batched``) with the smaller
one ``op``: for each column ``c`` over ``x``'s untouched legs,

    y[c, j] = sum_i op[j, i] * x[c, i],

``i`` over the ``s`` summed legs and ``j`` over the ``f`` new legs.  The
layout of ``y`` (``TnStep``): the first ``min(s, f)`` new legs take the
places of the summed legs, in order; with ``f > s`` the others become the
most significant legs, after the batch axis; with ``f < s`` the unused
summed places are dropped.  A step that needs no permute of ``x`` before
its product needs none after it either, so the executor
(``contract.SlicedContractor``) tracks each node's leg order instead of
permuting.

A CUDA tensor goes to ``csrc/tn_apply.cu`` (the kernel reads ``x`` and
``op`` where their legs lie, with no permute copy) or raises; a CPU tensor
goes to ``tn_apply_plain`` (permute, ``torch.matmul``, permute), which the
tests hold against numpy.  The kernel has no Pallas counterpart: the JAX
package leaves these steps to XLA's ``dot_general``.

``inplace=True`` (``f == s``, ``x`` batched and not needed after the step)
writes ``y`` over ``x`` and returns ``x``: the square steps, nine tenths of
a Sycamore slice's bytes, then allocate nothing.

``launches`` counts the kernel's launches and ``plain_calls`` the plain
version's calls; ``reset_counts`` zeroes both and ``counts`` reads them.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from hybridq_tpu_torch.simulation import fused_kernels as _fk

__all__ = ['MAX_LEGS', 'TnStep', 'tn_apply', 'tn_apply_plain',
           'reset_counts', 'counts']

MAX_LEGS = 7           # s and f the kernel takes
_DTYPES = {torch.complex64: 0, torch.complex128: 1}

launches = 0
plain_calls = 0
_fn = None


def reset_counts():
    global launches, plain_calls
    launches = plain_calls = 0


def counts() -> dict:
    return {'tn_apply': launches, 'tn_apply_plain': plain_calls}


class _Desc(ctypes.Structure):
    """``TnDesc`` of ``csrc/tn_apply.cu``."""
    _fields_ = [('nx', ctypes.c_int), ('s', ctypes.c_int),
                ('f', ctypes.c_int), ('x_batched', ctypes.c_int),
                ('op_batched', ctypes.c_int),
                ('xbits', ctypes.c_int * MAX_LEGS),
                ('ybits', ctypes.c_int * MAX_LEGS),
                ('orow', ctypes.c_int * MAX_LEGS),
                ('ocol', ctypes.c_int * MAX_LEGS)]


class TnStep:
    """The static description of one step, built once per contractor.

    ``nx``: legs of ``x`` (batch excluded); ``xbits[t]``: the flat bit of
    summed leg ``t`` in ``x`` (axis ``a`` of ``n`` legs is bit
    ``n - 1 - a``); ``f``: new legs; ``orow`` / ``ocol``: the flat bits of
    ``op``'s new and summed legs (by default ``op`` is the operator
    ``[2^f, 2^s]``).  Derived: ``ny``, ``ybits`` (each new leg's bit in
    ``y``) and ``y_axes`` (for each axis of ``y``, ``('x', a)``: axis
    ``a`` of ``x``, or ``('new', u)``)."""

    def __init__(self, nx: int, xbits: Sequence[int], f: int,
                 orow: Sequence[int] = None, ocol: Sequence[int] = None,
                 x_batched: bool = False, op_batched: bool = False):
        self.nx, self.s, self.f = int(nx), len(xbits), int(f)
        s, f = self.s, self.f
        self.xbits = tuple(int(b) for b in xbits)
        self.orow = tuple(range(s + f - 1, s - 1, -1)) if orow is None \
            else tuple(int(b) for b in orow)
        self.ocol = tuple(range(s - 1, -1, -1)) if ocol is None \
            else tuple(int(b) for b in ocol)
        self.x_batched, self.op_batched = bool(x_batched), bool(op_batched)
        if not (s <= MAX_LEGS and 0 <= f <= MAX_LEGS and s <= self.nx):
            raise ValueError(f"tn_apply takes s, f <= {MAX_LEGS} and "
                             f"s <= nx, got s={s}, f={f}, nx={self.nx}")
        if len(self.orow) != f or len(self.ocol) != s or \
                sorted(self.orow + self.ocol) != list(range(s + f)):
            raise ValueError("orow and ocol must place the operator's "
                             f"{s + f} legs")
        if len(set(self.xbits)) != s or \
                any(not 0 <= b < self.nx for b in self.xbits):
            raise ValueError(f"xbits must be {s} distinct bits < {self.nx}")
        summed = {self.nx - 1 - b: t for t, b in enumerate(self.xbits)}
        axes = [('new', u) for u in range(s, f)]
        for a in range(self.nx):
            t = summed.get(a)
            if t is None:
                axes.append(('x', a))
            elif t < f:
                axes.append(('new', t))
        self.y_axes = tuple(axes)
        self.ny = len(axes)
        place = {u: self.ny - 1 - a for a, (kind, u) in enumerate(axes)
                 if kind == 'new'}
        self.ybits = tuple(place[u] for u in range(f))
        self.batched = self.x_batched or self.op_batched

        pad = lambda v: (ctypes.c_int * MAX_LEGS)(*v)  # noqa: E731
        self.desc = _Desc(self.nx, s, f, self.x_batched, self.op_batched,
                          pad(self.xbits), pad(self.ybits), pad(self.orow),
                          pad(self.ocol))
        self._desc_ptr = ctypes.addressof(self.desc)
        self._y_shape = (2,) * self.ny

    @classmethod
    def from_legs(cls, x_legs, op_legs, summed, x_batched=False,
                  op_batched=False):
        """The step that sums ``summed`` (legs of both, in this order)
        between an ``x`` with legs ``x_legs`` and an ``op`` with legs
        ``op_legs``; ``op``'s other legs are the new ones, in its order.
        Returns ``(step, y_legs)``."""
        x_legs, op_legs = tuple(x_legs), tuple(op_legs)
        nx, no = len(x_legs), len(op_legs)
        new = [i for i in op_legs if i not in summed]
        step = cls(nx, [nx - 1 - x_legs.index(i) for i in summed], len(new),
                   [no - 1 - op_legs.index(i) for i in new],
                   [no - 1 - op_legs.index(i) for i in summed],
                   x_batched, op_batched)
        y_legs = tuple(x_legs[a] if kind == 'x' else new[a]
                       for kind, a in step.y_axes)
        return step, y_legs

    def batch_of(self, x: torch.Tensor, op: torch.Tensor) -> int:
        """The batch size of a call, after checking both operands."""
        if x.dtype != op.dtype or x.dtype not in _DTYPES:
            raise ValueError(f"tn_apply takes complex64 or complex128 "
                             f"operands of one type, got {x.dtype} and "
                             f"{op.dtype}")
        bx = x.shape[0] if self.x_batched else 1
        bo = op.shape[0] if self.op_batched else 1
        if self.x_batched and self.op_batched and bx != bo:
            raise ValueError(f"batch sizes differ: {bx} and {bo}")
        if x.numel() != bx << self.nx or \
                op.numel() != bo << (self.s + self.f):
            raise ValueError(f"operands of {x.numel()} and {op.numel()} "
                             f"elements do not fit the step (nx={self.nx}, "
                             f"s={self.s}, f={self.f})")
        return max(bx, bo)


def tn_apply(x: torch.Tensor, op: torch.Tensor, step: TnStep,
             inplace: bool = False) -> torch.Tensor:
    """``y`` of ``step`` (see the module docstring), shaped ``[batch] +
    [2] * ny`` when batched; with ``inplace`` it is written over ``x``."""
    global launches
    if x.device.type != 'cuda':
        if x.device.type != 'cpu':
            raise ValueError(f"no kernel for device {x.device}")
        return tn_apply_plain(x, op, step, inplace)
    batch = step.batch_of(x, op)
    if inplace:
        _check_inplace(step)
    if not (x.is_contiguous() and op.is_contiguous()):
        raise ValueError("tn_apply needs contiguous operands")
    card = x.get_device()
    if op.get_device() != card:
        raise ValueError("x and op must be on one device")
    y = x if inplace else torch.empty(
        (batch,) + step._y_shape if step.batched else step._y_shape,
        dtype=x.dtype, device=x.device)
    args = (x.data_ptr(), y.data_ptr(), op.data_ptr(), batch,
            step._desc_ptr, _DTYPES[x.dtype], _fk._stream(x))
    # the executor runs on the current card: no device switch a step
    if card == torch.cuda.current_device():
        err = _kernel()(*args)
    else:
        with torch.cuda.device(card):
            err = _kernel()(*args)
    _fk._check_launch(err, f"tn_apply (nx={step.nx}, s={step.s}, "
                           f"f={step.f}, batch={batch})")
    launches += 1
    return y


def _kernel():
    """``hq_tn_apply``, built and loaded at first use."""
    global _fn
    if _fn is None:
        _fn = _fk._c_function('tn_apply', 'hq_tn_apply', [
            _fk._PTR, _fk._PTR, _fk._PTR, ctypes.c_longlong, _fk._PTR,
            ctypes.c_int, _fk._PTR])
    return _fn


def _check_inplace(step):
    if step.f != step.s or not step.x_batched:
        raise ValueError("in place needs f == s and a batched x")


def tn_apply_plain(x: torch.Tensor, op: torch.Tensor, step: TnStep,
                   inplace: bool = False) -> torch.Tensor:
    """The plain version of ``tn_apply``: ``x`` permuted to (batch,
    untouched legs, summed legs), ``op`` to (batch, new legs, summed legs),
    one ``torch.matmul``, and the product permuted into ``y``'s layout."""
    global plain_calls
    plain_calls += 1
    batch = step.batch_of(x, op)
    if inplace:
        _check_inplace(step)
    s, f, nx = step.s, step.f, step.nx
    xb, ob = int(step.x_batched), int(step.op_batched)
    summed = [nx - 1 - b for b in step.xbits]
    keep = [a for a in range(nx) if a not in summed]
    xm = x.reshape((-1,) * xb + (2,) * nx).permute(
        list(range(xb)) + [a + xb for a in keep + summed]).reshape(
        (-1,) * xb + (2 ** (nx - s), 2 ** s))
    no = s + f
    rows = [no - 1 - b for b in step.orow]
    cols = [no - 1 - b for b in step.ocol]
    om = op.reshape((-1,) * ob + (2,) * no).permute(
        list(range(ob)) + [a + ob for a in rows + cols]).reshape(
        (-1,) * ob + (2 ** f, 2 ** s))
    ym = torch.matmul(xm, om.transpose(-1, -2))    # [B?, cols, 2^f]
    yb = int(step.batched)
    ym = ym.reshape((batch,) * yb + (2,) * (nx - s + f))
    src = {a: k for k, a in enumerate(keep)}
    perm = [(nx - s) + u if kind == 'new' else src[u]
            for kind, u in step.y_axes]
    y = ym.permute(list(range(yb)) + [a + yb for a in perm])
    if inplace:
        return x.copy_(y.reshape(x.shape))
    return y.contiguous()
