"""Bandwidth of gathered runs on the card, by run length.

The counterpart of ``scripts/probe_pallas_gather.py``.  A gate's lowest
row bit sets the length of the contiguous runs it moves; this probe moves
a ``[rows, 128]`` f32 array in place as runs of ``run_rows`` rows (512 B a
row) taken in a scrambled order and written back where they came from:

  * ``gather_scale_(x, run_rows, blk_rows, matmul=False, nbuf=2)`` runs
    ``csrc/gather_runs.cu`` on a CUDA tensor: one block per SM, an
    ``nbuf``-stage ring in shared memory filled and drained by one TMA
    bulk copy per run (or per stage of a run longer than a stage); the
    body doubles each stage, or with ``matmul`` multiplies each 128-row
    chunk by ``eye(128)`` in bf16 on the tensor cores, which rounds it to
    bf16 (``mk_gather``);
  * ``gather_scale_plain`` is its plain version: ``2 * x`` or
    ``x.to(torch.bfloat16).float()`` (a run's order does not change what
    is written where);
  * ``run_source(r, n_runs_total)`` is the script's scramble ``src_of``:
    the run index whose rows run ``r`` of the gathered order reads;
  * ``split3_bf16(x)`` is the script's bf16x3 split check, host math.

``VARIANTS`` keeps the script's names in its order.  The script's VMEM
steps of 1024-2048 rows (512 KB-1 MB) do not fit a block's shared memory:
the card's stage is ``stage_rows(blk_rows, nbuf)`` rows (a 128 KiB ring),
so the script's ``blk 2048`` variant runs the same launch as its
``blk 1024`` one, and ``describe`` prints each mapping and names such
twins.  Run on the card at the script's
size (2 GiB of f32), with the 3xTF32 dot of ``bw.dot`` (the script's
``Precision.HIGHEST`` dot):

    python -m hybridq_tpu_torch.probes.gather

``gather_launches`` counts the kernel's launches; ``reset_counts`` zeroes
it and ``counts`` reads it.
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import numpy as np
import torch

from hybridq_tpu_torch.probes import bw
from hybridq_tpu_torch.simulation import fused_kernels as fk

__all__ = ['gather_scale_', 'gather_scale_plain', 'run_source',
           'stage_rows', 'split3_bf16', 'GVariant', 'VARIANTS',
           'run_variant', 'describe', 'main', 'reset_counts', 'counts']

SUB, LANE = 2 ** 22, 128        # 2 GiB of f32 as [rows, 128]
ROW_BYTES = LANE * 4
NBYTES = SUB * ROW_BYTES
REPS = 4
RING_BYTES = 128 * 1024         # the ring's shared memory
MATMUL_CHUNK = 128              # rows of one identity product
MAX_BUF = 8

gather_launches = 0


def reset_counts():
    global gather_launches
    gather_launches = 0


def counts() -> dict:
    return {'gather_scale': gather_launches}


def _pow2(v) -> bool:
    return int(v) == v and v >= 1 and (int(v) & (int(v) - 1)) == 0


def run_source(r, n_runs_total: int):
    """Source run of run ``r`` (an int or an integer array): the script's
    ``src_of`` over row counts divided by the run length, which swaps the
    low ``half`` bits of ``r`` with the rest."""
    half = int(n_runs_total).bit_length() // 2
    lo = r % 2 ** half
    hi = r // 2 ** half
    return lo * (n_runs_total // 2 ** half) + hi


def stage_rows(blk_rows: int, nbuf: int) -> int:
    """Rows of one stage of the card's ring: the script's ``blk_rows``,
    cut to the largest power of two whose ``nbuf`` stages fit
    ``RING_BYTES``."""
    cap = 1 << ((RING_BYTES // (nbuf * ROW_BYTES)).bit_length() - 1)
    return min(int(blk_rows), cap)


def gather_scale_plain(x: torch.Tensor, matmul: bool = False
                       ) -> torch.Tensor:
    """Plain PyTorch version of ``gather_scale_`` (out of place)."""
    return x.to(torch.bfloat16).float() if matmul else 2 * x


def _check(x, run_rows, blk_rows, matmul, nbuf):
    if x.dtype != torch.float32 or x.dim() != 2 or \
            x.shape[1] != LANE or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous [rows, {LANE}] float32 "
                         f"tensor")
    rows = x.shape[0]
    if not (_pow2(run_rows) and _pow2(blk_rows)):
        raise ValueError(f"run_rows and blk_rows must be powers of two, "
                         f"got {run_rows} and {blk_rows}")
    if blk_rows % run_rows or rows % blk_rows:
        raise ValueError(f"run_rows {run_rows} must divide blk_rows "
                         f"{blk_rows}, which must divide rows {rows}")
    if not _pow2(rows // run_rows):
        raise ValueError(f"rows / run_rows must be a power of two, got "
                         f"{rows} / {run_rows}")
    if int(nbuf) != nbuf or not 2 <= nbuf <= MAX_BUF:
        raise ValueError(f"nbuf must be in 2..{MAX_BUF}, got {nbuf}")
    stage = stage_rows(blk_rows, int(nbuf))
    if matmul and stage % MATMUL_CHUNK:
        raise ValueError(f"matmul needs stages of a multiple of "
                         f"{MATMUL_CHUNK} rows, got {stage}")
    return rows, int(run_rows), stage, int(nbuf)


def gather_scale_(x: torch.Tensor, run_rows: int, blk_rows: int,
                  matmul: bool = False, nbuf: int = 2) -> torch.Tensor:
    """In place on ``x`` (``[rows, 128]`` f32): move it as runs of
    ``run_rows`` rows in the scrambled order, ``blk_rows`` rows a step
    through ``nbuf`` stages, doubling it or, with ``matmul``, rounding it
    to bf16; returns ``x``."""
    global gather_launches
    rows, run_rows, stage, nbuf = _check(x, run_rows, blk_rows, matmul, nbuf)
    if not fk._kernel_device(x):
        return x.copy_(gather_scale_plain(x, matmul))
    bw._aligned(x)
    half = (rows // run_rows).bit_length() // 2
    # x, rows, run_rows, stage_rows, half, nbuf, matmul, stream
    fn = fk._c_function('gather_runs', 'hq_gather_scale',
                        [fk._PTR, bw._I64, fk._INT, fk._INT, fk._INT,
                         fk._INT, fk._INT, fk._PTR])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), rows, run_rows, stage, half, nbuf,
                 int(bool(matmul)), fk._stream(x))
    fk._check_launch(err, f"gather_runs (rows={rows}, run={run_rows}, "
                          f"stage={stage}, nbuf={nbuf}, matmul={matmul})")
    gather_launches += 1
    return x


def split3_bf16(x: torch.Tensor):
    """The script's bf16x3 split: ``x ~ a0 + a1 + a2``, each term the bf16
    rounding of what the earlier terms leave; returns ``(a0, a1, a2)``."""
    def bf16(t):
        return t.to(torch.bfloat16).float()

    a0 = bf16(x)
    r1 = x - a0
    a1 = bf16(r1)
    a2 = bf16(r1 - a1)
    return a0, a1, a2


class GVariant(NamedTuple):
    name: str          # the script's name
    run_rows: int
    blk_rows: int
    matmul: bool = False
    nbuf: int = 2


VARIANTS = [
    GVariant('run 512B  (1 sub)  blk 1024', 1, 1024),
    GVariant('run 2KB   (4 sub)  blk 1024', 4, 1024),
    GVariant('run 4KB   (8 sub)  blk 1024', 8, 1024),
    GVariant('run 16KB  (32 sub) blk 1024', 32, 1024),
    GVariant('run 64KB  (128sub) blk 1024', 128, 1024),
    GVariant('run 512KB (1024)   blk 1024', 1024, 1024),
    GVariant('run 16KB  blk 2048', 32, 2048),
    GVariant('run 16KB  blk 1024 + matmul', 32, 1024, matmul=True),
    GVariant('run 4KB   blk 1024 x4buf', 8, 1024, nbuf=4),
]


def run_variant(v: GVariant, x: torch.Tensor) -> torch.Tensor:
    return gather_scale_(x, v.run_rows, v.blk_rows, v.matmul, v.nbuf)


def _launch(v: GVariant):
    """What the card's launch of ``v`` depends on."""
    return v.run_rows, stage_rows(v.blk_rows, v.nbuf), v.matmul, v.nbuf


def describe(v: GVariant) -> str:
    """How the card runs variant ``v``, naming any other variant whose
    launch is the same (their script steps differ only above the cap)."""
    stage = stage_rows(v.blk_rows, v.nbuf)
    if v.run_rows <= stage:
        per = f"{stage // v.run_rows} runs a stage"
    else:
        per = f"a run over {v.run_rows // stage} stages"
    body = ("eye(128) in bf16 on the tensor cores" if v.matmul
            else "x2")
    twins = [w.name.strip() for w in VARIANTS
             if w != v and _launch(w) == _launch(v)]
    same = f"; the same launch as {', '.join(twins)}" if twins else ""
    return (f"runs of {v.run_rows * ROW_BYTES} B, ring of {v.nbuf} stages "
            f"of {stage} rows ({stage * ROW_BYTES // 1024} KiB; the script's "
            f"step: {v.blk_rows} rows), {per}, {body}{same}")


def main(argv=None) -> int:
    """Every variant at the script's size on the card, the bf16x3 split
    residual and the 3xTF32 dot; prints ``name: ms, GB/s(rw)`` per variant
    and the card's name and power limit.  Exits non-zero without a card."""
    if not bw.require_card('probes.gather'):
        return 2
    print(f"# device: {torch.cuda.get_device_name(0)}", flush=True)
    for v in VARIANTS:
        print(f"# {v.name:30s} -> {describe(v)}", flush=True)
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    x = torch.randn(SUB, LANE, device='cuda', generator=gen)
    for v in VARIANTS:
        ms = bw.time_ms(lambda: run_variant(v, x), REPS)     # in place
        if not v.matmul:
            x.mul_(2.0 ** -(REPS + 1))   # exact: back to the start's scale
        gbs = 2 * NBYTES / (ms * 1e-3) / 1e9
        print(f"{v.name:30s}: {ms:8.3f} ms  {gbs:6.0f} GB/s(rw)", flush=True)
    del x
    torch.cuda.empty_cache()

    xs = torch.from_numpy(np.random.default_rng(0).standard_normal(
        4096).astype(np.float32))
    a0, a1, a2 = split3_bf16(xs)
    err = (a0 + a1 + a2 - xs).abs().max().item()
    print(f"bf16x3 split residual: {err:.2e}", flush=True)

    a, b = bw.dot_inputs()
    ad, bd = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    err = bw.rel_err(bw.dot(ad, bd, '3xtf32'), a, b)
    err_lib = bw.rel_err(bw.library_matmul(ad, bd, tf32=False), a, b)
    print(f"3xtf32 dot rel-err: {err:.2e} (torch.matmul, f32: "
          f"{err_lib:.2e})", flush=True)
    print(bw.card_line(), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
