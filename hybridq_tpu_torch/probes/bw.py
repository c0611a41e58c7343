"""Streaming bandwidth and dot accuracy of the card.

The counterpart of ``scripts/probe_pallas_bw.py``:

  * ``scale(x, tile_rows, out=None)``: ``out = 2 * x`` out of place, a grid
    of 16-byte loads and stores in which each block loops over tiles of
    ``tile_rows`` rows (``mk_auto``);
  * ``scale_(x, tile_rows)``: the same in place (``mk_auto_aliased``);
  * ``scale_pipelined(x, chunk_rows, nbuf)``: the same copy streamed by
    hand through an ``nbuf``-stage ring of ``chunk_rows``-row stages in
    shared memory, filled and drained by TMA bulk copies (``mk_manual``);
  * ``dot(a, b, precision)``: one 128 x 128 x 128 f32 product on the
    tensor cores, one TF32 pass (``'tf32'``, the TPU's default-precision
    dot) or the 3xTF32 split (``'3xtf32'``, its ``Precision.HIGHEST``).

All run ``csrc/stream_scale.cu`` or ``csrc/dot_probe.cu`` on a CUDA tensor
and the plain versions ``scale_plain`` (``2 * x``) and ``dot_plain`` (an
f32 ``torch.matmul``) on a CPU tensor.

``VARIANTS`` keeps the script's names in its order.  The script's 1-4 MB
VMEM blocks do not fit a block's 227 KB of shared memory: the streamed
variants take stages of S / 64 rows (16-64 KiB), and ``describe`` prints
each mapping.  Row ``A`` is the library yardstick, as the script's XLA
copy is.  Run on the card at the script's size (2 GiB of f32):

    python -m hybridq_tpu_torch.probes.bw

Launch counters are plain ints on this module; ``reset_counts`` zeroes
them and ``counts`` reads them.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from typing import NamedTuple

import numpy as np
import torch

from hybridq_tpu_torch.simulation import fused_kernels as fk

__all__ = ['scale', 'scale_', 'scale_pipelined', 'scale_plain', 'dot',
           'dot_plain', 'Variant', 'VARIANTS', 'run_variant', 'describe',
           'main', 'reset_counts', 'counts']

R, C = 2 ** 19, 1024           # 2 GiB of f32
NBYTES = R * C * 4
REPS = 6
DOT_N = 128
PRECISIONS = {'tf32': 1, '3xtf32': 3}
MAX_BUF = 8
MAX_RING_BYTES = 227 * 1024     # shared memory a block can have
_I64 = ctypes.c_int64

scale_launches = 0
scale_inplace_launches = 0
pipelined_launches = 0
dot_launches = {p: 0 for p in PRECISIONS}


def reset_counts():
    global scale_launches, scale_inplace_launches, pipelined_launches
    scale_launches = scale_inplace_launches = pipelined_launches = 0
    for p in dot_launches:
        dot_launches[p] = 0


def counts() -> dict:
    return {'stream_scale': scale_launches,
            'stream_scale_inplace': scale_inplace_launches,
            'stream_scale_pipelined': pipelined_launches,
            'dot_tf32': dot_launches['tf32'],
            'dot_3xtf32': dot_launches['3xtf32']}


# -- argument checks ---------------------------------------------------

def _shape_of(x: torch.Tensor):
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("x must be a contiguous 2-D float32 tensor")
    rows, cols = x.shape
    if rows < 1 or cols < 4 or cols % 4:
        raise ValueError(f"x must have rows >= 1 and a multiple of 4 "
                         f"columns, got {tuple(x.shape)}")
    return rows, cols


def _positive(v, what) -> int:
    if int(v) != v or v < 1:
        raise ValueError(f"{what} must be a positive integer, got {v}")
    return int(v)


def _aligned(*ts):
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("the kernel needs 16-byte aligned tensors")


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.numel() * 4 and b0 < a0 + a.numel() * 4


# -- streaming copy ----------------------------------------------------

def scale_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of every streaming variant: ``2 * x``."""
    return 2 * x


def _out_like(x: torch.Tensor, out) -> torch.Tensor:
    """``out``, checked to be a contiguous tensor like ``x`` that does not
    overlap it, or a new one."""
    if out is None:
        return torch.empty_like(x)
    if out.shape != x.shape or out.dtype != x.dtype or \
            out.device != x.device or not out.is_contiguous():
        raise ValueError("out must be a contiguous tensor like x")
    if _overlap(x, out):
        raise ValueError("out must not overlap x: use scale_ in place")
    return out


def scale(x: torch.Tensor, tile_rows: int, out=None) -> torch.Tensor:
    """``2 * x`` into ``out`` (a new tensor by default, never overlapping
    ``x``), a block looping over tiles of ``tile_rows`` rows."""
    global scale_launches
    rows, cols = _shape_of(x)
    tile_rows = _positive(tile_rows, 'tile_rows')
    out = _out_like(x, out)
    if not fk._kernel_device(x):
        return out.copy_(scale_plain(x))
    _aligned(x, out)
    # x, out, rows, cols, tile_rows, stream
    fn = fk._c_function('stream_scale', 'hq_scale',
                        [fk._PTR, fk._PTR, _I64, fk._INT, fk._INT, fk._PTR])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), rows, cols, tile_rows,
                 fk._stream(x))
    fk._check_launch(err, f"stream_scale ({rows}x{cols}, tile {tile_rows})")
    scale_launches += 1
    return out


def scale_(x: torch.Tensor, tile_rows: int) -> torch.Tensor:
    """``x *= 2`` in place, as ``scale``; returns ``x``."""
    global scale_inplace_launches
    rows, cols = _shape_of(x)
    tile_rows = _positive(tile_rows, 'tile_rows')
    if not fk._kernel_device(x):
        return x.copy_(scale_plain(x))
    _aligned(x)
    # x, rows, cols, tile_rows, stream
    fn = fk._c_function('stream_scale', 'hq_scale_inplace',
                        [fk._PTR, _I64, fk._INT, fk._INT, fk._PTR])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), rows, cols, tile_rows, fk._stream(x))
    fk._check_launch(err, f"stream_scale_inplace ({rows}x{cols}, tile "
                          f"{tile_rows})")
    scale_inplace_launches += 1
    return x


def scale_pipelined(x: torch.Tensor, chunk_rows: int, nbuf: int = 2,
                    out=None) -> torch.Tensor:
    """``2 * x`` into ``out`` (as in ``scale``) through an ``nbuf``-stage
    ring of ``chunk_rows``-row stages in shared memory (at most 227 KB in
    all)."""
    global pipelined_launches
    rows, cols = _shape_of(x)
    chunk_rows = _positive(chunk_rows, 'chunk_rows')
    nbuf = _positive(nbuf, 'nbuf')
    if not 2 <= nbuf <= MAX_BUF:
        raise ValueError(f"nbuf must be in 2..{MAX_BUF}, got {nbuf}")
    if nbuf * chunk_rows * cols * 4 > MAX_RING_BYTES:
        raise ValueError(f"{nbuf} stages of {chunk_rows} x {cols} floats "
                         f"exceed {MAX_RING_BYTES} bytes of shared memory")
    out = _out_like(x, out)
    if not fk._kernel_device(x):
        return out.copy_(scale_plain(x))
    _aligned(x, out)
    # x, out, rows, cols, chunk_rows, nbuf, stream
    fn = fk._c_function('stream_scale', 'hq_scale_pipelined',
                        [fk._PTR, fk._PTR, _I64, fk._INT, fk._INT, fk._INT,
                         fk._PTR])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), rows, cols, chunk_rows, nbuf,
                 fk._stream(x))
    fk._check_launch(err, f"stream_scale_pipelined ({rows}x{cols}, "
                          f"{nbuf} x {chunk_rows} rows)")
    pipelined_launches += 1
    return out


# -- dot -----------------------------------------------------------------

def dot_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``dot``: the f32 product."""
    return torch.matmul(a, b)


def dot(a: torch.Tensor, b: torch.Tensor, precision: str = 'tf32'
        ) -> torch.Tensor:
    """``a @ b`` for two 128 x 128 f32 tensors on the tensor cores: one
    TF32 pass (``'tf32'``) or the 3xTF32 split (``'3xtf32'``)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {sorted(PRECISIONS)}, "
                         f"got {precision!r}")
    for t in (a, b):
        if t.dtype != torch.float32 or tuple(t.shape) != (DOT_N, DOT_N) or \
                not t.is_contiguous():
            raise ValueError(f"dot takes contiguous {DOT_N}x{DOT_N} "
                             f"float32 tensors")
    if a.device != b.device:
        raise ValueError("a and b must be on the same device")
    if not fk._kernel_device(a):
        return dot_plain(a, b)
    out = torch.empty_like(a)
    # A, B, C, passes, stream
    fn = fk._c_function('dot_probe', 'hq_dot128',
                        [fk._PTR, fk._PTR, fk._PTR, fk._INT, fk._PTR])
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                 PRECISIONS[precision], fk._stream(a))
    fk._check_launch(err, f"dot_probe ({precision})")
    dot_launches[precision] += 1
    return out


def dot_inputs():
    """The script's operands: ``default_rng(0)`` and ``default_rng(1)``
    standard normals of shape (128, 128), in f32."""
    return tuple(np.random.default_rng(s).standard_normal(
        (DOT_N, DOT_N)).astype(np.float32) for s in (0, 1))


def rel_err(got, a, b) -> float:
    """max|got - a b| / max|a b|, the product taken in float64."""
    want = a.astype(np.float64) @ b.astype(np.float64)
    got = np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got)
    return float(np.abs(got - want).max() / np.abs(want).max())


def library_matmul(a: torch.Tensor, b: torch.Tensor, tf32: bool):
    """``torch.matmul`` with ``allow_tf32`` set for the call and restored
    afterwards: the yardstick of ``dot``."""
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        return torch.matmul(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


# -- the probe ---------------------------------------------------------

class Variant(NamedTuple):
    name: str          # the script's name
    kind: str          # 'library', 'auto', 'aliased' or 'manual'
    S: int             # the script's block rows
    rows: int          # the card's tile rows ('auto'), stage rows ('manual')
    nbuf: int = 0


VARIANTS = [
    Variant('A  XLA copy', 'library', 0, 0),
    Variant('B  auto S=256 (1MB)', 'auto', 256, 256),
    Variant('B  auto S=512 (2MB)', 'auto', 512, 512),
    Variant('B  auto S=1024 (4MB)', 'auto', 1024, 1024),
    Variant('B2 auto aliased S=512', 'aliased', 512, 512),
    Variant('C  manual S=256 x2buf', 'manual', 256, 4, 2),
    Variant('C  manual S=512 x2buf', 'manual', 512, 8, 2),
    Variant('C  manual S=1024 x2buf', 'manual', 1024, 16, 2),
    Variant('C  manual S=256 x4buf', 'manual', 256, 4, 4),
]


def run_variant(v: Variant, x: torch.Tensor, out=None) -> torch.Tensor:
    """``2 * x`` by variant ``v``: into ``out`` (a new tensor by default),
    or into ``x`` itself for the in-place variant, which takes no
    ``out``."""
    if v.kind == 'aliased':
        if out is not None:
            raise ValueError(f"{v.name} runs in place: it takes no out")
        return scale_(x, v.rows)
    if v.kind == 'library':
        return torch.mul(x, 2, out=out)
    if v.kind == 'auto':
        return scale(x, v.rows, out=out)
    if v.kind == 'manual':
        return scale_pipelined(x, v.rows, v.nbuf, out=out)
    raise ValueError(f"unknown variant kind {v.kind!r}")


def describe(v: Variant) -> str:
    """How the card runs variant ``v`` at the script's width."""
    kib = v.rows * C * 4 / 1024
    if v.kind == 'library':
        return "torch.mul(x, 2), the library yardstick"
    if v.kind in ('auto', 'aliased'):
        place = 'in place' if v.kind == 'aliased' else 'out of place'
        return (f"grid of 16-byte loads, blocks loop over tiles of {v.rows} "
                f"rows ({kib:g} KiB), {place}")
    return (f"TMA ring of {v.nbuf} stages of {v.rows} rows ({kib:g} KiB "
            f"each, {v.nbuf * kib:g} KiB of shared memory), one block per "
            f"SM (the script's {v.S} rows do not fit)")


def card_line() -> str:
    """The card's ``name, power.limit`` as nvidia-smi prints them."""
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps) -> float:
    """``fn()`` once to warm, then ``reps`` times between two CUDA events;
    returns the ms of one call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def require_card(what: str) -> bool:
    if torch.cuda.is_available():
        return True
    print(f"{what}: needs a CUDA device; it measures the card and has no "
          f"CPU fallback", file=sys.stderr)
    return False


def main(argv=None) -> int:
    """Every variant at the script's size on the card, then the TF32 dot;
    prints ``name: ms, GB/s(rw)`` per variant and the card's name and
    power limit.  Exits non-zero without a card."""
    if not require_card('probes.bw'):
        return 2
    print(f"# device: {torch.cuda.get_device_name(0)}", flush=True)
    for v in VARIANTS:
        print(f"# {v.name:26s} -> {describe(v)}", flush=True)
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    x = torch.randn(R, C, device='cuda', generator=gen)

    def step(v):                         # x = 2 x, as the script chains it
        nonlocal x
        x = run_variant(v, x)

    # one untimed round first: without it the first timed variant read
    # 1.2-1.6x slower than the same call timed later in the process
    time_ms(lambda: step(VARIANTS[0]), REPS)
    x.mul_(2.0 ** -(REPS + 1))
    for v in VARIANTS:
        ms = time_ms(lambda: step(v), REPS)
        x.mul_(2.0 ** -(REPS + 1))       # exact: back to the start's scale
        gbs = 2 * NBYTES / (ms * 1e-3) / 1e9
        print(f"{v.name:26s}: {ms:8.3f} ms  {gbs:6.0f} GB/s(rw)", flush=True)
    del x
    torch.cuda.empty_cache()

    a, b = dot_inputs()
    ad, bd = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    err = rel_err(dot(ad, bd, 'tf32'), a, b)
    err_lib = rel_err(library_matmul(ad, bd, tf32=True), a, b)
    print(f"D  tf32 dot rel-err: {err:.2e} (torch.matmul, allow_tf32: "
          f"{err_lib:.2e})", flush=True)
    print(card_line(), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
