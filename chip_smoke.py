#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``hybridq_tpu_torch``) on one GPU.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --out run.jsonl # also append the JSON lines
    python3 chip_smoke.py --phases build,probes   # only these phases
    python3 chip_smoke.py --phases front_end --parent DIR   # host only

Phases, each printing one JSON line (a failing phase exits non-zero):

  build      compile ``hybridq_tpu_torch/csrc/*.cu`` from the checkout and
             print each kernel's registers and spills as ptxas reports
             them; every ``column_apply_kernel<K>`` (k = 1..5) and
             ``group_apply_kernel<K>`` (k = 6..8) must spill nothing;
  kernels    at n = 28, hold every routing class of ``fused_apply`` and
             ``swap_apply``, and both kernels at gate sizes k = 1..8,
             against the plain PyTorch version (max|d|/rms <= 1e-5) and
             time kernel, plain version, bound and a ``torch.matmul`` of
             the same arithmetic; from k = 6 (the tensor cores, 3xTF32)
             the bound is the 3xTF32 one, beside the fp32 CUDA-core one,
             and U's bytes per launch stand beside the state's; also the
             host time of one step (a memoized
             ``IndexedEvolver.apply_gate``: ``kernels._STEP_MS``).  Then
             the straight classes: ``apply_bits`` at
             k = 1..8 with the lowest gate bit at 0, 1, 2, 3 and >= 7 (the
             other bits those of the fused k - 1 case), held and timed the
             same way: the straight cost table (``kernels.straight_cost``);
  parity     ``simulate(get_rqc(24, ...))`` on the card against a
             per-gate numpy oracle on the host, at 20 and 40 random gates
             after an H layer, three times: ``'evolution'`` and
             ``'evolution-einsum'`` in complex64 (max|d| over the largest
             amplitude <= 3e-6 at both depths, max|d|/rms <= 1e-5 at 20;
             the engine's kernels must launch, no plain version run), and
             ``'evolution'`` in complex128 (max|d|/rms <= 1e-6, the
             roadmap's contract);
  paths      n = 30, the public functions of the other ported kernels at
             the bit sets the JAX package's callers use: ``apply_factored``
             (``probe_fused_perf.py``'s and ``probe_fused_check.py``'s
             cases and the largest the port takes; beside each with one or
             two lane bits, ``apply_swap`` on the product with the victims
             the JAX fused engine picks: the lowest free bits >= 12),
             ``apply_gate_rows`` (``test_pallas.py``'s
             positions at L = 10, and n = 12) and ``apply_fused_k4`` (the
             main path's and ``probe_fused_k4.py``'s bits, beside
             ``apply_fused``; it runs ``column_apply_kernel<4>`` too).
             Each path runs once with launch counts zeroed just before
             and read just after, and must keep the norm; then each case
             is held against its plain version (max|d|/rms <= 1e-5) and
             timed with its bound and one PyTorch call of the same
             function: ``apply_factored`` and its ``torch.einsum`` run 3
             times each untimed, then in turns (kernel, library, library,
             kernel), each turn 3 calls between CUDA events (``ms``) and
             3 under ``torch.profiler`` (``device_ms`` and the launch
             grid), with the factor kernel over library (``vs_library``)
             and its 3xTF32 bound where a factor runs on the tensor cores
             (``bound_fp32_ms`` beside it);
  main_path  n = 30 (8 GiB of state), the workload of ``bench.py``: 24
             random 4-qubit unitaries avoiding bits 0-2.  First through
             ``simulate(..., optimize='evolution')`` (the straight engine)
             with launch counts zeroed just before and read just after,
             its seconds and device peak recorded (the result goes to the
             host); then bench-style timed passes through
             ``IndexedEvolver``, paired (``pair_matrix_gates``) and
             unpaired; a paired pass may take at most 1.1x its unpaired
             one.  Then straight passes and ``simulate`` at n = 31 and 32.
             ``apply_bits`` is then replayed at the most frequent gate
             size the main path gave it and held against its plain
             version.  Also the first
             ``simulate`` once more with ``profile_dir``: the device
             operations of its Chrome trace by name, and the share of its
             seconds the card was busy (the rest is the host's).
  dm         ``dm.simulate`` of ``get_rqc(15, 60)`` with a
             ``LocalDepolarizingChannel`` on every qubit after each layer of
             15 gates: a 15-qubit density matrix, 30 qubits doubled, in
             complex64 on the card (trace within 1e-4 of 1, Hermitian on
             sampled pairs, ``apply_bits`` launched and no plain call;
             seconds, launches and peak recorded); and the same
             construction at 12 qubits in complex64 against complex128 on
             the card (max|d| / max|amp| <= 3e-6).
  trajectories  ``simulation.trajectories.sample_trajectories``: 64
             trajectories of ``get_rqc(14, 112)`` with a
             ``LocalDepolarizingChannel`` (p = 0.01) after each layer of 14
             gates and an ``AmplitudeDampingChannel`` (p = 1, Kraus sites)
             on 2 qubits, on the card and on the host with one seed: from
             |+...+> max|d|/rms <= 1e-5 every sample, from |0...0> (peaked
             samples) max|d| over max|amp| <= 3e-6; then 8 trajectories of
             ``get_rqc(27, 216)`` built alike with damping on 4 qubits (8
             GiB of batch) through ``apply_bits``: its launches counted
             exactly, every sample's norm within 1e-4 of 1, sample-sites/s;
  clifford   ``clifford.update_pauli_string`` of a one-qubit Z through
             1920 random Clifford gates on 48 qubits with 26 T gates where
             the evolved string has an X or Y: ``backend='torch'`` on the
             card (float64 and float32) against ``backend='numpy'`` on the
             host (the same strings above 1e-6; values within 1e-9, and
             1e-5 in float32, of max|v|), the frontier past
             ``max_breadth_first_branches`` (2^18) so the split runs; then
             38 T gates on the card alone, timed (branches/s);
  cli        ``python -m hybridq_tpu_torch.cli examples/circuit.qasm`` (23
             qubits, the card's straight engine) in a subprocess, its
             pickle against an in-process ``simulate`` of the file
             (max|d|/rms <= 1e-6, ``apply_bits`` launched); ``main_dm`` on
             a 16-qubit Clifford+T file written by ``to_qasm``, its JSON
             against the numpy backend (1e-5 of max|v|).  Each of these
             three phases prints the card, its seconds and device peak;
  sharded    the sharded engines on the one card, shards in one process:
             (a) the ``main_path`` workload at n = 30 through
             ``ShardedIndexedEvolver(30, devices=['cuda:0'] * 4)``, then
             ``* 8``: ``apply_bits`` launches must equal shards x blocks
             and the exchanges the schedule's own count
             (``_schedule``); every shard is held against the straight
             engine's container on the same gates, each qubit at the
             position the sharded run left it in (max|d|/rms <= 1e-5);
             warm gates/s of a sharded pass beside the straight pass,
             ms of one exchange beside its bytes bound (half of every
             shard read and written once), the exchanges' share of a
             pass and the device peak over the shards' bytes; (b) on 4
             shards, ``probabilities`` of 3 qubits, ``expectation_value``
             of a 2-qubit Pauli product and ``project`` then ``norm``
             against the same quantities of the straight container
             (1e-5); (c) ``simulate(optimize='evolution-sharded',
             devices=['cuda:0'] * 4)`` at n = 24 against ``'evolution'``
             (the parity tolerances); (d) a process group of one under
             NCCL (``parallel.initialize`` on a ``file://`` store): the
             same call, and ``update_pauli_string(use_mpi=True)`` against
             the unsplit expansion (exchanges across ranks are held only
             on the CPU under gloo); (e) ``contract(devices=['cuda:0'] *
             2)`` on ``tn``'s 26-qubit case, sliced, against one device
             (max|d|/rms <= 1e-5).  Runs before ``tn``.
  tn         the tensor-network engine: ``simulate(get_rqc(26, 150),
             optimize='tn')`` with 10 open final qubits on the card
             against the matching amplitudes of complex128 ``'evolution'``
             on the card (max|d|/rms <= 1e-4), its steps on ``tn_apply``
             (``csrc/tn_apply.cu``), and again sliced to a widest
             intermediate of 2^12; the committed Sycamore-53 plans
             (``scripts/_plan_cache``, read by
             ``convert.load_reference_plan``) through
             ``SlicedContractor.contract_torch``: the depth-12 plan warm
             over about 10 s of slices (seconds a contracted slice,
             TFLOP/s, the bound of a slice, device peak, the projected
             full amplitude over the slices that select no all-zero leaf
             row; ``tn_apply`` launched once for each slice-invariant
             ``'apply'`` step and once a chunk of contracted slices for
             each batched one, the plain version never); each
             ``tn_apply`` class (s, f) of the plan at its widest step
             against the plain version (max|d|/rms <= 1e-5 in
             complex64, 1e-12 in complex128) and timed in turns beside
             ``torch.tensordot`` over the same legs (``turns``), with
             the plain version and the bound; 16 slices
             through the kernel route and through the plain route
             (``tn_apply`` patched to ``tn_apply_plain``) in turns, the
             sums within 1e-5; then ``torch.profiler`` over 4 slices:
             kernel time by kind and the device's busy share), two slices
             in complex64 against complex128 and again with the global
             TF32 flags on (no change allowed), and one slice of the
             depth-20 plan, timed (and a call of three, for what a slice
             adds beyond the call's own work) and profiled.  Fails if
             the native path search did not build, or if a contraction
             step ran off the card.  Runs last.
  probes     the card's counterparts of the bandwidth and dot probes
             (``scripts/probe_pallas_bw.py``, ``probe_pallas_gather.py``)
             at the scripts' 2 GiB of f32: first ``probes.bw.main()`` and
             ``probes.gather.main()``, the entry points a user runs, with
             launch counts zeroed just before and read just after (every
             kernel must launch); then every variant of both tables held
             against its plain version (``2 * x``, or ``x`` rounded to bf16
             for the matmul variant: max|d| must be 0), then kernel and
             one PyTorch call run 10 times each untimed and timed in turns
             (kernel, library, library, kernel), each turn 10 calls between
             CUDA events (``ms``), their host time (``host_ms``)
             and 10 under ``torch.profiler`` (``device_ms`` and the
             launch grid), kernel and library writing the same tensor
             (``torch.mul(x, 2, out=y)`` beside ``scale(x, ..., out=y)``,
             ``y.mul_(2)`` in place), beside its bound and its plain
             version; the same for ``gather_scale_`` on one run of the
             whole array (the array's own order: what the scramble
             costs); and the TF32 and 3xTF32 dots on the scripts' inputs
             against float64 (rel-err in [1e-5, 1e-2] for one TF32 pass:
             f32 accuracy there would mean no tensor cores; <= 1e-5 for
             3xTF32), beside ``torch.matmul``: their ptxas registers and
             spills, then kernel and library timed in turns (kernel,
             library, library, kernel), each turn 100 calls between CUDA
             events (``ms``), their host time (``host_ms``) and 100 more
             under ``torch.profiler`` (``device_ms``, and the launch grid
             as blocks x threads), after the host time of a dot call's
             parts (``dot_host_ms``).  Runs after ``paths``.
  front_end  host time of ``circuit.utils.simplify``, the front end of
             ``simulate``'s default call, on the benchmark's Sycamore
             circuits (``benchmark/hqbench/circuits.rqc(32, 14, [s, 1,
             0])``, 618 gates) for a few seeds, best of 3 each, in a fresh
             interpreter a turn; with ``--parent DIR`` (an unpacked copy
             of another commit) in turns with that copy (parent, this,
             this, parent), whose outputs must match gate for gate; and
             the ``counts()`` of this checkout's scan.  Then, on a card,
             the initial container's fill ``prepare.token_container('0' *
             32, 32, 'cuda')`` in the same turns: host ms to return, ms to
             the synchronize after it, device ms of its kernels and copies
             under ``torch.profiler``, ``prepare.counts()`` of one fill,
             and a digest of an n = 26 mixed-token container that must
             match across the turns.  Without a card the fill reads "not
             measured", and the phase runs alone.

Then the ``{"kernels": [...]}`` summary (of the phases that ran), the
card's ``name, power.limit`` and, as the last line, ``{"ok": true,
"device": {...}}``.  Without a CUDA device, or without the package beside
this script, it exits non-zero and prints no result.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

SEED = 0
REPS = 3                   # timed repetitions of each kernel and pass
N_KERNELS = 28
N_STEP = 16                # n at which a step's host time is measured
N_PARITY = 24
PARITY_GATES = (20, 40)
N_MAIN = 30
MAIN_GATES = 24
N_PATHS = 30
# (row_bits, lane_bits): probe_fused_perf.py's FACT_CASES, then
# probe_fused_check.py's four, then the largest the port takes (JAX's
# k_hi <= 4 high bits plus 5 sublane bits, all 7 lane bits).
FACTORED_CASES = [((), (6, 5, 4, 3)), ((27, 9), (6, 5)), ((27, 20), (6, 5)),
                  ((15, 9), (4, 2)), ((), (6, 3, 0)), ((14, 13), (5,)),
                  ((9, 15), (2, 4)),
                  ((29, 28, 27, 26, 11, 10, 9, 8, 7), (6, 5, 4, 3, 2, 1, 0))]
# (n, L, row positions): test_pallas.py's, and the smallest register.
GATE_ROWS_CASES = [(N_PATHS, 10, (0,)), (N_PATHS, 10, (3, 0)),
                   (N_PATHS, 10, (1, 3, 0, 2)), (12, 10, (1, 0))]
# the main path's replay bits, and probe_fused_k4.py's k_hi = 4 bits
FUSED_K4_CASES = [(22, 16, 9, 14), (27, 20, 14, 12)]
# the case of each path that the summary line reports
SUMMARY_CASE = {'factored_apply': 2, 'apply_gate_rows': 2,
                'fused_k4_apply': 0}
# the probe variant that the summary line reports for each streaming kernel
# (the dots have one case each); gather: the main path's 2 KB runs
PROBE_SUMMARY_CASE = {'stream_scale': 'B  auto S=512 (2MB)',
                      'stream_scale_inplace': 'B2 auto aliased S=512',
                      'stream_scale_pipelined': 'C  manual S=256 x2buf',
                      'gather_scale': 'run 2KB   (4 sub)  blk 1024'}
PROBE_REPS = 10            # timed repetitions of each probe kernel
DOT_REPS = 100             # calls in each timed turn of the 128^3 dots
HOST_REPS = 1000           # calls timed for each host part of a dot call
PROFILE_TRIES = 5          # torch.profiler sessions before CUDA events
TOL = 1e-5                 # max|d|/rms, kernel against plain (f32 sums)
# max|d| / max|amp| of simulate against the complex128 oracle: f32
# evolution gives 6e-7 to 8e-7 at these depths on the card and on the CPU.
PARITY_TOL = 3e-6
CONTRACT = 1e-6            # max|d|/rms of complex128 against the oracle
N_WIDE = (31, 32)          # straight passes and simulate past n = 30
STRAIGHT_LOW = (0, 1, 2, 3, 7)   # lowest gate bit of the straight classes
N_DM, DM_GATES = 15, 60    # dm: qubits of rho (doubled on the card), gates
N_DM_SMALL = 12
DM_NOISE = 0.01            # depolarizing probability after each layer
DM_TRACE_TOL = 1e-4
PAIRED_SLACK = 1.1         # paired pass time over unpaired, at most
MAX_COLUMN_K = 5           # column_apply_kernel: k <= 5; group_apply_kernel
LOG_TILE = 13              # above, on tiles of 2^13 amplitudes
FACTORED_COLUMN_K = 4      # factored_apply: kr + kl <= 4 in registers; the
FACTORED_MMA_K = 5         # tiles beyond, factors of k >= 5 in 3xTF32
NORM_TOL = 1e-4
N_TN, TN_GATES, TN_OPEN = 26, 150, 10   # tn: get_rqc(26, 150), 10 open legs
TN_MAX_TIME = 10           # simulate_tn's path-search budget (s)
TN_SLICED_WIDTH = 2 ** 12  # max_largest_intermediate that forces slices
TN_TOL = 1e-4              # max|d|/rms, TN against complex128 evolution
TN_SECONDS = 10.0          # timed slices of the d12 plan: about this long
TN_PLANS = ('syc53_d12_s0_t26.pkl', 'syc53_d20_s0_t26.pkl')
TN_PROFILE_SLICES = 4      # slices of the d12 plan under torch.profiler
TN_TURN_SLICES = 16        # d12 slices of each turn, kernel against plain
TN_APPLY_REPS = 10         # calls in each timed turn of a tn_apply class
TN_APPLY_TOL = {'complex64': 1e-5, 'complex128': 1e-12}
TN_APPLY_SUMMARY = (2, 2)  # the class the summary line reports
TRAJ_HOLD = (14, 64)       # trajectories: (qubits, samples), card vs host
TRAJ_WIDE = (27, 8)        # trajectories on apply_bits: 8 GiB of batch
TRAJ_LAYERS = 8            # layers of n gates, each then depolarized
TRAJ_GAMMA = 0.3           # amplitude damping of the Kraus sites
CLIFFORD_N, CLIFFORD_GATES = 48, 1920     # Clifford gates, then T ones
CLIFFORD_T_HOLD = 26       # T gates: a frontier of 2^18-2^19 branches
CLIFFORD_T_TIMED = 38      # T gates: about 2^22 branches explored
CLI_DM_N, CLI_DM_GATES, CLI_DM_T = 16, 320, 12   # main_dm's circuit
SHARDS = (4, 8)            # sharded: shards on the one card
FRONT_END_SEEDS = (1, 2, 3, 4)   # front_end: rqc(32, 14, [s, 1, 0])
TN_TF32_TOL = 1e-6         # |change| / |amp| when the global TF32 flags
                           # are turned on (one TF32 pass gives ~1e-3)
# Published peaks (NVIDIA data sheets, dense): bytes/s, fp32 FLOP/s outside
# the tensor cores, TF32 FLOP/s on the tensor cores.
_PEAKS = {'H100 PCIe': (2.0e12, 51.2e12, 378e12),
          'H200': (4.8e12, 67e12, 495e12),
          'H100': (3.35e12, 67e12, 495e12)}
# wrapper -> (source in the repo, the TPU kernel it replaces)
KERNEL_INFO = {
    'apply_bits': ('hybridq_tpu_torch/csrc/fused_apply.cu',
                   'hybridq_tpu/simulation/pallas_fused.py:175'),
    'apply_gate_rows': ('hybridq_tpu_torch/csrc/fused_apply.cu',
                        'hybridq_tpu/simulation/pallas_kernels.py:201'),
    'factored_apply': ('hybridq_tpu_torch/csrc/factored_apply.cu',
                       'hybridq_tpu/simulation/pallas_fused.py:633'),
    'fused_k4_apply': ('hybridq_tpu_torch/csrc/fused_apply.cu',
                       'scripts/probe_fused_k4.py:24'),
    'stream_scale': ('hybridq_tpu_torch/csrc/stream_scale.cu',
                     'scripts/probe_pallas_bw.py:42'),
    'stream_scale_inplace': ('hybridq_tpu_torch/csrc/stream_scale.cu',
                             'scripts/probe_pallas_bw.py:60'),
    'stream_scale_pipelined': ('hybridq_tpu_torch/csrc/stream_scale.cu',
                               'scripts/probe_pallas_bw.py:79'),
    'dot_tf32': ('hybridq_tpu_torch/csrc/dot_probe.cu',
                 'scripts/probe_pallas_bw.py:202'),
    'gather_scale': ('hybridq_tpu_torch/csrc/gather_runs.cu',
                     'scripts/probe_pallas_gather.py:32'),
    'dot_3xtf32': ('hybridq_tpu_torch/csrc/dot_probe.cu',
                   'scripts/probe_pallas_gather.py:233'),
    # no Pallas kernel: JAX contracts these steps with XLA dot_general
    'tn_apply': ('hybridq_tpu_torch/csrc/tn_apply.cu',
                 'hybridq_tpu/simulation/tn/contract.py:101'),
}


PHASES = ('front_end', 'build', 'kernels', 'parity', 'paths', 'probes',
          'main_path', 'dm', 'trajectories', 'clifford', 'cli', 'sharded',
          'tn')
HOST_PHASES = ('front_end',)   # phases that need no card


class PhaseError(RuntimeError):
    pass


def emit(obj, out):
    line = json.dumps(obj)
    print(line, flush=True)
    if out is not None:
        out.write(line + '\n')
        out.flush()


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def card_power():
    """The card's ``name, power.limit`` as nvidia-smi prints them."""
    from hybridq_tpu_torch.probes.bw import card_line
    return card_line()


def peaks(name):
    for key, val in _PEAKS.items():
        if all(w in name for w in key.split()):
            return val
    return _PEAKS['H100']


def bound(n, k, name, flops_needed=None):
    """Least time (ms) for one gate pass: the whole state read and
    written once, or ``flops_needed`` fp32 flops (default 8 * 2^(n+k),
    a k-qubit gate)."""
    bw, flops, _ = peaks(name)
    t_bytes = 2 * 2 ** (n + 1) * 4 / bw
    t_ops = (8 * 2 ** (n + k) if flops_needed is None
             else flops_needed) / flops
    return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops
                                       else 'operations')


def group_bound(n, k, name):
    """Least time (ms) of ``group_apply_kernel``'s pass (k >= 6): the
    state's bytes, or 3 * 8 * 2^(n+k) flops (3xTF32) at the TF32 peak of
    the tensor cores."""
    bw, _, tf32 = peaks(name)
    t_bytes = 2 * 2 ** (n + 1) * 4 / bw
    t_ops = 3 * 8 * 2 ** (n + k) / tf32
    return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops
                                       else 'operations (3xTF32)')


def factored_bound(n, kr, kl, name):
    """Least time (ms) of ``factored_apply``'s pass when a factor runs on
    the tensor cores: the state's bytes, or each factor's flops
    (8 * 2^(n+k)), 3xTF32 ones (k >= 5) three times at the TF32 peak,
    the others at the fp32 peak."""
    bw, flops, tf32 = peaks(name)
    t_bytes = 2 * 2 ** (n + 1) * 4 / bw
    t_ops = sum(3 * 8 * 2 ** (n + k) / tf32 if k >= FACTORED_MMA_K
                else 8 * 2 ** (n + k) / flops for k in (kr, kl) if k)
    return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops
                                       else 'operations (3xTF32)')


def u_bytes(n, k):
    """Bytes of U that ``group_apply_kernel`` reads through L1/L2 in one
    launch: all 2^(2k) complex64 entries once per tile of 2^(13-k)
    columns."""
    tiles = 2 ** max(0, n - LOG_TILE)
    return tiles * 2 ** (2 * k) * 8


def time_ms(fn, reps):
    """ms of one ``fn()`` between CUDA events (``probes.bw.time_ms``)."""
    from hybridq_tpu_torch.probes.bw import time_ms as timed
    return timed(fn, reps)


def rand_unitary(k, rng):
    m = rng.standard_normal((2 ** k, 2 ** k)) + \
        1j * rng.standard_normal((2 ** k, 2 ** k))
    return np.linalg.qr(m)[0].astype(np.complex64)


def rand_state(n, gen):
    import torch

    st = torch.randn(2 ** (n + 1), generator=gen, device='cuda')
    st /= torch.linalg.vector_norm(st)
    return st


def hold(make, kern, plain, rms, reps=REPS, plain_reps=2):
    """``kern`` and ``plain`` each on a copy of one state from ``make()``
    (a tuple of tensors), compared, then timed in turn on their copies;
    returns the measured numbers."""
    import torch

    a = make()
    b = tuple(t.clone() for t in a)
    kern(*a)
    plain(*b)
    torch.cuda.synchronize()
    d = max((x - y).abs_().max().item() for x, y in zip(a, b))
    ms = time_ms(lambda: kern(*a), reps)
    plain_ms = time_ms(lambda: plain(*b), plain_reps)
    del a, b
    torch.cuda.empty_cache()
    return {'max_abs_err': d, 'rel_err': d / rms, 'ms': ms,
            'plain_ms': plain_ms}


def library_ms(fn, *shapes, reps=REPS):
    """Time of ``fn`` on random complex64 tensors of ``shapes`` (the
    operands a PyTorch call of the same function takes)."""
    import torch

    gen = torch.Generator(device='cuda')
    gen.manual_seed(SEED)
    args = [torch.randn(*sh, dtype=torch.complex64, device='cuda',
                        generator=gen) for sh in shapes]
    t = time_ms(lambda: fn(*args), reps)
    del args
    torch.cuda.empty_cache()
    return t


def compare_kernel(n, kind, U, bits, victims, gen, name, reps):
    """``apply_bits``, ``fused_apply`` or ``swap_apply`` (``kind`` 'bits',
    'fused' or 'swap') against its plain version on
    one random unit-norm state, timed beside its bound and a
    ``torch.matmul`` of the same arithmetic."""
    import torch
    from hybridq_tpu_torch.simulation import fused_kernels as fk

    Ud = torch.as_tensor(U, device='cuda')
    if kind == 'bits':
        r = hold(lambda: (rand_state(n, gen),),
                 lambda s: fk.apply_bits(s, Ud, bits),
                 lambda s: fk.apply_bits_plain(s, Ud, bits),
                 2.0 ** (-n / 2), reps)
    elif kind == 'fused':
        r = hold(lambda: (rand_state(n, gen),),
                 lambda s: fk.apply_fused(s, Ud, bits),
                 lambda s: fk.apply_fused_plain(s, Ud, bits),
                 2.0 ** (-n / 2), reps)
    else:
        r = hold(lambda: (rand_state(n, gen),),
                 lambda s: fk.apply_swap(s, Ud, bits, victims),
                 lambda s: fk.apply_swap_plain(s, Ud, bits, victims),
                 2.0 ** (-n / 2), reps)
    k = len(bits)
    r['bound_ms'], r['bound_by'] = bound(n, k, name)
    if k > MAX_COLUMN_K:        # the tensor cores: the 3xTF32 bound
        r['bound_fp32_ms'] = r['bound_ms']
        r['bound_ms'], r['bound_by'] = group_bound(n, k, name)
        r['u_bytes'] = u_bytes(n, k)
        r['state_bytes'] = 2 * 2 ** (n + 1) * 4
    r['library_ms'] = library_ms(torch.matmul, (2 ** k, 2 ** k),
                                 (2 ** k, 2 ** (n - k)), reps=reps)
    return r


def swap_bits(n, k, kl):
    """Positions of a k-bit swap gate with kl lane bits (6, 5): as many
    top high bits as the routing allows (k_hi + kl <= 4), the rest on
    sublane bits 7.., victims just below the high bits.  For k <= 4 this
    is the JAX engine's calibration choice for class (k, kl)."""
    k_hi = min(k, 4) - kl
    bits = list(range(6, 6 - kl, -1)) + \
        list(range(n - 1, n - 1 - k_hi, -1)) + list(range(7, 7 + k - kl -
                                                          k_hi))
    victims = list(range(n - 1 - k_hi, n - 1 - k_hi - kl, -1))
    return bits, victims


def step_host_ms():
    """Host time (ms) of one memoized ``apply_gate`` step at n = N_STEP,
    where the kernel itself takes microseconds."""
    import torch
    from hybridq_tpu_torch.simulation.kernels import IndexedEvolver

    ev = IndexedEvolver(N_STEP, device='cuda')
    st = ev.prepare_state('0' * N_STEP)
    U = rand_unitary(1, np.random.default_rng(SEED))
    for _ in range(10):
        st = ev.apply_gate(st, U, (0,), gate_key='step')
    torch.cuda.synchronize()
    reps = 200
    t0 = time.perf_counter()
    for _ in range(reps):
        st = ev.apply_gate(st, U, (0,), gate_key='step')
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


# -- phases ------------------------------------------------------------

def phase_build(out):
    import torch
    from hybridq_tpu_torch.simulation import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    dt = time.perf_counter() - t0
    for src in ('fused_apply', 'factored_apply', 'stream_scale', 'dot_probe',
                'gather_runs'):
        check(src in libs, f"{src} was not built")
    nvcc = subprocess.run([_build.nvcc_path(), '--version'],
                          capture_output=True, text=True).stdout
    ptxas = ptxas_entries(_build.LOGS)
    emit({'phase': 'build', 'ok': True, 'seconds': dt,
          'torch': torch.__version__, 'torch_cuda': torch.version.cuda,
          'nvcc': nvcc.strip().splitlines()[-1],
          'card': card_power(), 'ptxas': ptxas}, out)
    for kernel, count in (('column_apply_kernel', 5),
                          ('group_apply_kernel', 3),
                          ('factored_apply_cu', 21), ('gather_runs_cu', 2)):
        found = {e: r for e, r in ptxas.items() if kernel in e}
        check(len(found) == count, f"build: {len(found)} {kernel} "
              f"instantiations in the ptxas output, not {count}")
        for entry, r in found.items():
            check(r['spill_stores'] == r['spill_loads'] == 0,
                  f"build: {entry} spills: {r}")


def ptxas_entries(logs):
    """``{mangled kernel name: {'registers', 'spill_stores',
    'spill_loads'}}`` from the ``-Xptxas=-v`` output of each source."""
    entries, name = {}, None
    for log in logs.values():
        for ln in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", ln)
            if m:
                name = m.group(1)
                entries[name] = {}
            m = re.search(r'Function properties for (\w+)', ln)
            if m:               # a device function's own lines follow
                name = m.group(1) if m.group(1) in entries else None
            m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill '
                          r'loads', ln)
            if m and name:
                entries[name].update(spill_stores=int(m.group(1)),
                                     spill_loads=int(m.group(2)))
            m = re.search(r'Used (\d+) registers', ln)
            if m and name:
                entries[name]['registers'] = int(m.group(1))
    return entries


def phase_kernels(out, name):
    import torch

    n = N_KERNELS
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device='cuda')
    gen.manual_seed(SEED)
    # fused classes k_hi = 0..4 on the top high bits (k_hi = 0: bit 8),
    # then gate sizes k = 1..8 on high and sublane bits mixed; swap
    # classes (k, kl) for k <= 4 and sizes up to 8 with sublane bits.
    cases = [('fused', [k], list(range(n - 1, n - 1 - k, -1)) or [8], [])
             for k in range(5)]
    cases += [('fused_k', [], [n - 1 - 2 * i for i in range(k // 2)] +
               [7 + i for i in range((k + 1) // 2)], [])
              for k in range(1, 9)]
    cases += [('swap', [min(k, 4), kl], *swap_bits(n, k, kl))
              for kl in (1, 2) for k in range(kl, 9)]
    rows = []
    for kind, cls, bits, victims in cases:
        k = len(bits)
        r = compare_kernel(n, 'swap' if victims else 'fused',
                           rand_unitary(k, rng), bits, victims, gen, name,
                           REPS)
        r.update({'kind': kind, 'cls': cls, 'k': k, 'bits': bits,
                  'victims': victims})
        rows.append(r)
        emit({'phase': 'kernels', 'n': n, **r}, out)
        check(r['rel_err'] <= TOL, f"{kind}{cls} k={k}: max|d|/rms "
              f"{r['rel_err']:.3g} > {TOL}")
    # straight classes: apply_bits at k = 1..8, the lowest gate bit at
    # 0..3 or >= 7, the other k - 1 bits those of the fused k - 1 case
    def fused_k_bits(k):
        return [n - 1 - 2 * i for i in range(k // 2)] + \
            [7 + i for i in range((k + 1) // 2)]
    straight = {}
    for k in range(1, 9):
        for low in STRAIGHT_LOW:
            bits = fused_k_bits(k) if low >= 7 else \
                fused_k_bits(k - 1) + [low]
            r = compare_kernel(n, 'bits', rand_unitary(k, rng), bits, [],
                               gen, name, REPS)
            r.update({'kind': 'bits', 'k': k, 'low': min(bits),
                      'bits': bits})
            emit({'phase': 'kernels', 'n': n, **r}, out)
            check(r['rel_err'] <= TOL, f"apply_bits k={k} bits={bits}: "
                  f"max|d|/rms {r['rel_err']:.3g} > {TOL}")
            straight.setdefault(k, {})[min(low, 7)] = round(r['ms'], 3)
    emit({'phase': 'kernels', 'ok': True, 'n': n, 'card': card_power(),
          'step_costs': {
              'fused': {r['k']: round(r['ms'], 3) for r in rows
                        if r['kind'] == 'fused_k'},
              'swap': {f"{r['k']},{r['cls'][1]}": round(r['ms'], 3)
                       for r in rows if r['kind'] == 'swap'},
              # apply_bits ms by k and lowest gate bit (7: all >= 7)
              'straight': straight,
              # group_apply_kernel per k: time against both bounds
              'group': {r['k']: {key: r[key] for key in (
                  'ms', 'bound_ms', 'bound_by', 'bound_fp32_ms',
                  'library_ms', 'u_bytes', 'state_bytes')}
                  for r in rows if r['kind'] == 'fused_k' and
                  r['k'] > MAX_COLUMN_K},
              'step_ms': round(step_host_ms(), 4)}}, out)


def numpy_oracle(circuit, qubits):
    from hybridq_tpu_torch.circuit import utils

    n = len(qubits)
    index = {q: i for i, q in enumerate(qubits)}
    psi = np.zeros((2,) * n, dtype=np.complex128)
    psi[(0,) * n] = 1
    for g in utils.flatten(circuit):
        axes = [index[q] for q in g.qubits]
        k = len(axes)
        U = np.asarray(g.matrix(), dtype=np.complex128).reshape(
            (2,) * (2 * k))
        psi = np.tensordot(U, psi, axes=(list(range(k, 2 * k)), axes))
        psi = np.moveaxis(psi, list(range(k)), axes)
    return psi


# the kernels each engine of simulate launches
ENGINE_KERNELS = {'indexed': ('apply_bits',), 'torch': (), 'einsum': ()}


def check_engine_launches(where, engine, launches):
    """Every kernel of ``engine`` launched, and no plain version ran."""
    for key in ENGINE_KERNELS[engine]:
        check(launches[key] > 0, f"{where}: {key} was not launched "
              f"({engine} engine): {launches}")
    plain = {k: v for k, v in launches.items() if k.endswith('_plain') and v}
    check(not plain, f"{where}: a plain version ran: {plain}")


def phase_parity(out):
    import torch
    from hybridq_tpu_torch import Circuit, Gate
    from hybridq_tpu_torch.extras.random import get_rqc
    from hybridq_tpu_torch.simulation import fused_kernels as fk
    from hybridq_tpu_torch.simulation import simulate

    n = N_PARITY
    runs = [('evolution', 'complex64'), ('evolution-einsum', 'complex64'),
            ('evolution', 'complex128')]
    for depth in PARITY_GATES:
        np.random.seed(SEED)
        c = Circuit([Gate('H', qubits=[q]) for q in range(n)]) + \
            get_rqc(n, depth, indexes=list(range(n)))
        want = numpy_oracle(c, sorted(c.all_qubits))
        rms = np.sqrt(np.mean(np.abs(want) ** 2))
        amax = np.abs(want).max()
        for optimize, ctype in runs:
            fk.reset_counts()
            t0 = time.perf_counter()
            psi, info = simulate(c, initial_state='0', optimize=optimize,
                                 complex_type=ctype, return_info=True)
            dt = time.perf_counter() - t0
            launches = fk.counts()
            d = np.abs(psi.astype(np.complex128) - want).max()
            emit({'phase': 'parity', 'n': n, 'gates': len(c),
                  'optimize': optimize, 'complex_type': ctype,
                  'engine': info['engine'], 'max_abs_err': float(d),
                  'rel_err': float(d / rms),
                  'err_over_max_amp': float(d / amax),
                  'max_amp_over_rms': float(amax / rms),
                  'contract': CONTRACT,
                  'within_contract': bool(d / rms <= CONTRACT),
                  'seconds': dt, 'launches': launches}, out)
            what = f"parity ({depth} gates, {optimize}, {ctype})"
            check_engine_launches(what, info['engine'], launches)
            if ctype == 'complex128':
                check(psi.dtype == np.complex128, f"{what}: {psi.dtype}")
                check(d / rms <= CONTRACT, f"{what}: max|d|/rms "
                      f"{d / rms:.3g} > {CONTRACT}")
                continue
            check(d / amax <= PARITY_TOL, f"{what}: max|d| / max|amp| "
                  f"{d / amax:.3g} > {PARITY_TOL}")
            if depth == PARITY_GATES[0]:
                check(d / rms <= TOL, f"{what}: max|d|/rms {d / rms:.3g} "
                      f"> {TOL}")
            del psi
        torch.cuda.empty_cache()


def run_path(cases, module, key, apply_one, make):
    """Drive one path: every case once through its public function on
    one state, the launch counts of ``module`` zeroed just before and
    ``key``'s read just after; the state must keep its norm (every gate
    is unitary)."""
    import torch

    state = make()
    module.reset_counts()
    for case in cases:
        apply_one(state, case)
    torch.cuda.synchronize()
    launches = module.counts()[key]
    norm = torch.sqrt(sum(torch.linalg.vector_norm(t) ** 2
                          for t in state)).item()
    del state
    torch.cuda.empty_cache()
    check(abs(norm - 1) <= NORM_TOL, f"paths: norm {norm} after "
          f"{len(cases)} gates")
    return launches


def phase_paths(out, name):
    """See the module docstring; returns the summary entries of
    ``factored_apply``, ``apply_gate_rows`` and ``fused_k4_apply``."""
    import torch
    from hybridq_tpu_torch.probes import fused_k4
    from hybridq_tpu_torch.simulation import fused_kernels as fk
    from hybridq_tpu_torch.simulation import row_kernels as rk

    n = N_PATHS
    card = card_power()
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device='cuda')
    gen.manual_seed(SEED)
    rms = 2.0 ** (-n / 2)      # of the amplitudes of a unit-norm state

    def container():
        return (rand_state(n, gen),)

    def cu(U):
        return torch.as_tensor(U, device='cuda')

    summary = []

    def summarize(kname, rows, path_launches):
        r = rows[SUMMARY_CASE[kname]]
        check(path_launches > 0, f"paths: {kname} was not launched")
        src, replaces = KERNEL_INFO[kname]
        summary.append({'name': kname, 'route': 'cuda', 'source': src,
                        'replaces': replaces, 'launches': path_launches,
                        'max_abs_err': max(x['max_abs_err'] for x in rows),
                        'ms': r['ms'], 'plain_ms': r['plain_ms'],
                        'bound_ms': r['bound_ms'],
                        'bound_by': r['bound_by'],
                        'library_ms': r['library_ms']})

    # -- factored_apply ------------------------------------------------
    fact = []
    for row_bits, lane_bits in FACTORED_CASES:
        kr, kl = len(row_bits), len(lane_bits)
        Ur = cu(rand_unitary(kr, rng) if kr else np.ones((1, 1),
                                                          np.complex64))
        Ul = cu(rand_unitary(kl, rng))
        fact.append((row_bits, lane_bits, Ur, Ul))
    launches = run_path(
        fact, fk, 'factored_apply',
        lambda st, c: fk.apply_factored(st[0], c[2], c[0], c[3], c[1]),
        container)
    rows = []
    for row_bits, lane_bits, Ur, Ul in fact:
        kr, kl = len(row_bits), len(lane_bits)
        r = hold(container,
                 lambda s: fk.apply_factored(s, Ur, row_bits, Ul, lane_bits),
                 lambda s: fk.apply_factored_plain(s, Ur, row_bits, Ul,
                                                   lane_bits), rms)
        flops = 8 * 2 ** n * (2 ** kl + (2 ** kr if kr else 0))
        r['bound_ms'], r['bound_by'] = bound(n, kr + kl, name, flops)
        if kr + kl > FACTORED_COLUMN_K and max(kr, kl) >= FACTORED_MMA_K:
            # factors of k >= 5 run on the tensor cores in 3xTF32
            r['bound_fp32_ms'] = r['bound_ms']
            r['bound_ms'], r['bound_by'] = factored_bound(n, kr, kl, name)
        # the kernel and one einsum of U_row (x) U_lane on the state viewed
        # with the gate bits outermost (operands in the order that
        # contracts U_lane first: U_row x U_lane alone would be
        # 2^(2(kr+kl)) wide), in turns
        st = rand_state(n, gen)
        gen_lib = torch.Generator(device='cuda')
        gen_lib.manual_seed(SEED)
        ops = [torch.randn(*sh, dtype=torch.complex64, device='cuda',
                           generator=gen_lib)
               for sh in ((2 ** kl, 2 ** kl),
                          (2 ** kr, 2 ** kl, 2 ** (n - kr - kl)),
                          (2 ** kr, 2 ** kr))]
        r.update(turns(
            lambda: fk.apply_factored(st, Ur, row_bits, Ul, lane_bits),
            lambda: torch.einsum('cd,bdr,ab->acr', *ops), REPS, 'paths'))
        r['vs_library'] = r['ms'] / r['library_ms']
        r['of_bound'] = r['bound_ms'] / r['ms']
        del st, ops
        torch.cuda.empty_cache()
        if kl <= 2:
            # the swap route of the same gate, as the JAX fused engine
            # takes it from the canonical layout: the lowest free bits
            # >= 12 are the victims
            bits = list(row_bits) + list(lane_bits)
            victims = [b for b in range(12, n) if b not in bits][:kl]
            U = torch.kron(Ur, Ul)
            st = rand_state(n, gen)
            r['swap_ms'] = time_ms(
                lambda: fk.apply_swap(st, U, bits, victims), REPS)
            r['swap_victims'] = victims
            del st
            torch.cuda.empty_cache()
        r.update({'row_bits': list(row_bits), 'lane_bits': list(lane_bits)})
        rows.append(r)
        emit({'phase': 'paths', 'path': 'factored_apply', 'n': n, **r,
              'card': card}, out)
        check(r['rel_err'] <= TOL, f"factored {row_bits} x {lane_bits}: "
              f"max|d|/rms {r['rel_err']:.3g} > {TOL}")
    summarize('factored_apply', rows, launches)

    # -- apply_gate_rows ------------------------------------------------
    gr = []
    for m, L, pos in GATE_ROWS_CASES:
        U = rand_unitary(len(pos), rng)
        gr.append((m, L, pos, cu(U.real.copy()), cu(U.imag.copy())))

    def rows_state(m):
        def make():
            st = rand_state(m, gen)
            return st[:2 ** m].clone(), st[2 ** m:].clone()
        return make
    launches = 0
    for m in sorted({c[0] for c in gr}):
        launches += run_path(
            [c for c in gr if c[0] == m], rk, 'apply_gate_rows',
            lambda st, c: rk.apply_gate_rows(st[0], st[1], c[3], c[4],
                                             c[2], c[0], c[1]),
            rows_state(m))
    rows = []
    for m, L, pos, Ur, Ui in gr:
        k = len(pos)
        r = hold(rows_state(m),
                 lambda re, im: rk.apply_gate_rows(re, im, Ur, Ui, pos, m, L),
                 lambda re, im: rk.apply_gate_rows_plain(re, im, Ur, Ui, pos,
                                                         m, L),
                 2.0 ** (-m / 2))
        r['bound_ms'], r['bound_by'] = bound(m, k, name)
        r['library_ms'] = library_ms(torch.matmul, (2 ** k, 2 ** k),
                                     (2 ** k, 2 ** (m - k)))
        r.update({'n': m, 'L': L, 'positions': list(pos)})
        rows.append(r)
        emit({'phase': 'paths', 'path': 'apply_gate_rows', **r,
              'card': card}, out)
        check(r['rel_err'] <= TOL, f"gate_rows n={m} {pos}: max|d|/rms "
              f"{r['rel_err']:.3g} > {TOL}")
    summarize('apply_gate_rows', rows, launches)

    # -- fused_k4_apply -------------------------------------------------
    k4 = [(bits, cu(rand_unitary(4, rng))) for bits in FUSED_K4_CASES]
    launches = run_path(
        k4, fused_k4, 'fused_k4_apply',
        lambda st, c: fused_k4.apply_fused_k4(st[0], c[1], c[0]), container)
    rows = []
    for bits, U in k4:
        r = hold(container, lambda s: fused_k4.apply_fused_k4(s, U, bits),
                 lambda s: fk.apply_fused_plain(s, U, bits), rms)
        st = rand_state(n, gen)
        # the general kernel on the same bits and U, in turns with k4
        r['fused_apply_ms'] = time_ms(lambda: fk.apply_fused(st, U, bits),
                                      REPS)
        r['ms_again'] = time_ms(
            lambda: fused_k4.apply_fused_k4(st, U, bits), REPS)
        del st
        torch.cuda.empty_cache()
        r['bound_ms'], r['bound_by'] = bound(n, 4, name)
        r['library_ms'] = library_ms(torch.matmul, (16, 16),
                                     (16, 2 ** (n - 4)))
        r['bits'] = list(bits)
        rows.append(r)
        emit({'phase': 'paths', 'path': 'fused_k4_apply', 'n': n, **r,
              'card': card}, out)
        check(r['rel_err'] <= TOL, f"fused_k4 {bits}: max|d|/rms "
              f"{r['rel_err']:.3g} > {TOL}")
    summarize('fused_k4_apply', rows, launches)
    emit({'phase': 'paths', 'ok': True, 'n': n, 'card': card}, out)
    return summary


def hold_exact(x, kern, plain, kern_ms, library):
    """``kern(x)`` against ``plain(x)`` (max|d| must be 0), then the
    kernel and ``library`` timed in turns on the same input (``turns``),
    and the plain version."""
    import torch

    want = plain(x)
    got = kern(x)
    torch.cuda.synchronize()
    d = (got - want).abs_().max().item()
    del got, want
    r = {'max_abs_err': d, **turns(kern_ms, library, PROBE_REPS, 'probes',
                                      host=True),
         'plain_ms': time_ms(lambda: plain(x), PROBE_REPS)}
    torch.cuda.empty_cache()
    return r


def profile_calls(fn, reps, where):
    """``fn()`` ``reps`` times under ``torch.profiler``: each device
    kernel's duration and launch grid (``blocks x threads``), read from the
    exported trace.  ``device_ms`` is the median kernel's duration where a
    call launches one kernel (every probe): a session sometimes drops a
    kernel's record or stretches one, and the median ignores either; where
    a call launches several (a two-launch factored case, an einsum), it is
    the sum of their durations over ``reps``.  A session whose count of
    kernels is not a whole number a call is run again, up to
    ``PROFILE_TRIES`` sessions, each retry noted on stderr.  Where no
    session recorded a device kernel at all (CUPTI has returned none, for
    every session of a process, on an H100), ``device_ms`` is the calls'
    time between CUDA events instead, ``device_ms_from`` says so and the
    grids are left empty: the profiler is a measuring aid here, and every
    check of a kernel's values and launches stands without it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from hybridq_tpu_torch.simulation import _build

    fn()
    torch.cuda.synchronize()
    path = _build.BUILD_DIR / 'probe_trace.json'
    for attempt in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(path))
        with open(path) as f:
            trace = json.load(f)
        path.unlink()
        kernels = [ev for ev in trace.get('traceEvents', [])
                   if ev.get('cat') == 'kernel']
        if kernels and len(kernels) % reps == 0:
            break
        print(f"chip_smoke: {where}: profiler session {attempt} of "
              f"{PROFILE_TRIES} saw {len(kernels)} device kernels for "
              f"{reps} calls", file=sys.stderr, flush=True)
    if not kernels:
        return {'device_ms': time_ms(fn, reps),
                'device_ms_from': 'cuda events (the profiler saw no kernel)',
                'kernels_per_call': None, 'grids': {}}
    grids = {ev['name'][:80]: (f"{int(np.prod(ev['args']['grid']))} x "
                               f"{int(np.prod(ev['args']['block']))}")
             for ev in kernels if 'grid' in ev.get('args', {})}
    per_call = len(kernels) / reps
    durs = [ev['dur'] for ev in kernels]
    device_ms = (float(np.median(durs)) if round(per_call) <= 1
                 else sum(durs) / reps) / 1e3
    return {'device_ms': device_ms, 'device_ms_from': 'torch.profiler',
            'kernels_per_call': per_call, 'grids': grids}


def host_ms(fn, reps):
    """Host time (ms) of one ``fn()``: ``reps`` calls after a warm one,
    with no synchronize inside the timed loop."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return dt


def dot_host_parts(a, b):
    """Host time (ms) of a TF32 ``bw.dot`` call and of its parts: the
    output's ``empty_like`` and the raw stream it reads, beside what it no
    longer does on every call (build a ``torch.cuda.Stream``, enter the
    device's context)."""
    import torch
    from hybridq_tpu_torch.probes import bw
    from hybridq_tpu_torch.simulation import fused_kernels as fk

    def context():
        with torch.cuda.device(a.device):
            pass

    parts = {'dot_tf32': lambda: bw.dot(a, b, 'tf32'),
             'empty_like': lambda: torch.empty_like(a),
             'raw_stream': lambda: fk._stream(a),
             'stream_object':
                 lambda: torch.cuda.current_stream(a.device).cuda_stream,
             'device_context': context}
    return {key: host_ms(fn, HOST_REPS) for key, fn in parts.items()}


def turns(kern, library, reps, where, host=False):
    """``kern`` and ``library`` in turns (kernel, library, library,
    kernel), each turn ``reps`` calls between CUDA events (``ms``, the
    kernel table's column), with ``host`` the same calls' host time
    without a synchronize (``host_ms``), then ``reps`` more under the
    profiler (``device_ms``, and the launch grid); returns the means of
    each pair of turns and the turns themselves.  Both run ``reps`` times
    untimed first: on an H100 the first turn after other work
    (``hold_exact``'s comparison) read up to 1.5% slow, which the order
    would charge to the kernel alone."""
    keys = ('ms', 'host_ms', 'device_ms') if host else ('ms', 'device_ms')
    for fn in (kern, library):
        time_ms(fn, reps)
    runs = []
    for fn in (kern, library, library, kern):
        run = {'ms': time_ms(fn, reps)}
        if host:
            run['host_ms'] = host_ms(fn, reps)
        runs.append({**run, **profile_calls(fn, reps, where)})
    k, lib = (runs[0], runs[3]), (runs[1], runs[2])
    r = {}
    for key in keys:
        r[key] = (k[0][key] + k[1][key]) / 2
        r[f'library_{key}'] = (lib[0][key] + lib[1][key]) / 2
    r.update(grid=runs[0]['grids'], library_grid=runs[1]['grids'],
             turns=runs)
    return r


def phase_probes(out, name):
    """See the module docstring; returns the summary entries of the six
    probe kernels."""
    import torch
    from hybridq_tpu_torch.probes import bw, gather
    from hybridq_tpu_torch.simulation import _build

    card = card_power()
    peak_bw, _, peak_tf32 = peaks(name)
    # the path: both entry points, launch counts zeroed just before and
    # read just after
    bw.reset_counts()
    gather.reset_counts()
    check(bw.main() == 0, "probes: probes.bw failed")
    check(gather.main() == 0, "probes: probes.gather failed")
    torch.cuda.synchronize()
    launches = {**bw.counts(), **gather.counts()}
    emit({'phase': 'probes', 'path_launches': launches, 'card': card}, out)
    for key, count in launches.items():
        check(count > 0, f"probes: {key} was not launched")

    gen = torch.Generator(device='cuda')
    gen.manual_seed(SEED)
    rows = {}

    def record(kname, case, r, bound_ms, bound_by, nbytes=None):
        r.update({'bound_ms': bound_ms, 'bound_by': bound_by})
        if nbytes is not None:
            r['gbs'] = nbytes / (r['ms'] * 1e-3) / 1e9
        rows.setdefault(kname, []).append((case, r))
        emit({'phase': 'probes', 'kernel': kname, 'case': case, **r,
              'card': card}, out)

    # rows 6-8: 2 * x over [2^19, 1024] f32, out of place or in place
    nbytes = 2 * bw.NBYTES
    t_bytes = nbytes / peak_bw * 1e3
    kname_of = {'auto': 'stream_scale', 'aliased': 'stream_scale_inplace',
                'manual': 'stream_scale_pipelined'}
    x = torch.randn(bw.R, bw.C, device='cuda', generator=gen)
    y = x.clone()
    for v in bw.VARIANTS:
        if v.kind == 'library':
            continue
        # timed as the library call is: in place on y, or from x into y
        inplace = v.kind == 'aliased'
        r = hold_exact(
            x, lambda t: bw.run_variant(v, t.clone() if inplace else t),
            bw.scale_plain,
            (lambda: bw.run_variant(v, y)) if inplace
            else (lambda: bw.run_variant(v, x, out=y)),
            (lambda: y.mul_(2)) if inplace
            else (lambda: torch.mul(x, 2, out=y)))
        r['card_mapping'] = bw.describe(v)
        record(kname_of[v.kind], v.name, r, t_bytes, 'bytes', nbytes)
        check(r['max_abs_err'] == 0, f"probes: {v.name}: max|d| "
              f"{r['max_abs_err']} against 2 * x")
        y.copy_(x)                      # keep the timed values finite
    del x, y
    torch.cuda.empty_cache()

    # row 10: gathered runs over [2^22, 128] f32, in place
    nbytes = 2 * gather.NBYTES
    t_bytes = nbytes / peak_bw * 1e3
    x = torch.randn(gather.SUB, gather.LANE, device='cuda', generator=gen)
    y = x.clone()
    for v in gather.VARIANTS:
        r = hold_exact(
            x, lambda t: gather.run_variant(v, t.clone()),
            lambda t: gather.gather_scale_plain(t, v.matmul),
            lambda: gather.run_variant(v, y), lambda: y.mul_(2))
        r['card_mapping'] = gather.describe(v)
        record('gather_scale', v.name, r, t_bytes, 'bytes', nbytes)
        check(r['max_abs_err'] == 0, f"probes: {v.name}: max|d| "
              f"{r['max_abs_err']} against its plain version")
        y.copy_(x)                      # keep the timed values finite
    # what the scramble costs: the same kernel on one run of the whole
    # array, whose virtual order is the array's own (not a probe variant)
    r = hold_exact(
        x, lambda t: gather.gather_scale_(t.clone(), gather.SUB, gather.SUB),
        gather.gather_scale_plain,
        lambda: gather.gather_scale_(y, gather.SUB, gather.SUB),
        lambda: y.mul_(2))
    emit({'phase': 'probes', 'kernel': 'gather_scale',
          'case': 'one run (array order)', **r, 'bound_ms': t_bytes,
          'bound_by': 'bytes', 'card': card}, out)
    check(r['max_abs_err'] == 0, f"probes: gather_scale on one run: max|d| "
          f"{r['max_abs_err']} against 2 * x")
    del x, y
    torch.cuda.empty_cache()

    # rows 9 and 11: the 128^3 dot against float64, on the script's inputs
    dot_ptxas = {e: r for e, r in ptxas_entries(_build.LOGS).items()
                 if 'dot_kernel' in e}
    emit({'phase': 'probes', 'ptxas': dot_ptxas, 'card': card}, out)
    check(len(dot_ptxas) == 2, f"probes: {len(dot_ptxas)} dot_kernel "
          f"instantiations in the ptxas output, not 2")
    a, b = bw.dot_inputs()
    ad, bd = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    n = bw.DOT_N
    t_ops = 2 * n ** 3 / peak_tf32 * 1e3
    t_bytes = 3 * n * n * 4 / peak_bw * 1e3
    dot_bound = (max(t_ops, t_bytes),
                 'bytes' if t_bytes >= t_ops else 'operations')
    emit({'phase': 'probes', 'dot_host_ms': dot_host_parts(ad, bd),
          'card': card}, out)
    bands = {'tf32': (1e-5, 1e-2), '3xtf32': (0.0, 1e-5)}
    for prec, (lo, hi) in bands.items():
        got = bw.dot(ad, bd, prec)
        want = bw.dot_plain(ad, bd)
        torch.cuda.synchronize()
        err = bw.rel_err(got, a, b)
        lib = bw.library_matmul(ad, bd, tf32=prec == 'tf32')
        r = {'max_abs_err': (got - want).abs().max().item(),
             'rel_err_vs_f64': err,
             'plain_rel_err_vs_f64': bw.rel_err(want, a, b),
             'library_rel_err_vs_f64': bw.rel_err(lib, a, b),
             **turns(lambda: bw.dot(ad, bd, prec),
                     lambda: bw.library_matmul(ad, bd, tf32=prec == 'tf32'),
                     DOT_REPS, 'probes', host=True),
             'plain_ms': time_ms(lambda: bw.dot_plain(ad, bd), DOT_REPS)}
        record(f'dot_{prec}', prec, r, *dot_bound)
        check(lo <= err <= hi, f"probes: {prec} dot rel-err {err:.3g} "
              f"outside [{lo}, {hi}]")

    emit({'phase': 'probes', 'ok': True, 'card': card,
          'bandwidth_gbs': {case: r['gbs'] for kname, rs in rows.items()
                            if 'gbs' in rs[0][1] for case, r in rs}}, out)
    summary = []
    for kname in ('stream_scale', 'stream_scale_inplace',
                  'stream_scale_pipelined', 'dot_tf32', 'gather_scale',
                  'dot_3xtf32'):
        case, r = next((c, r) for c, r in rows[kname]
                       if c == PROBE_SUMMARY_CASE.get(kname, c))
        src, replaces = KERNEL_INFO[kname]
        summary.append({'name': kname, 'route': 'cuda', 'source': src,
                        'replaces': replaces, 'launches': launches[kname],
                        'max_abs_err': max(q['max_abs_err']
                                           for _, q in rows[kname]),
                        'ms': r['ms'], 'plain_ms': r['plain_ms'],
                        'bound_ms': r['bound_ms'],
                        'bound_by': r['bound_by'],
                        'library_ms': r['library_ms']})
    return summary


def bench_workload(n, k, n_gates, rng, min_bit=3):
    """``bench.py``'s workload: random k-qubit unitaries on qubits whose
    flat bits avoid 0..min_bit-1."""
    gates = []
    for _ in range(n_gates):
        qs = tuple(int(x) for x in rng.choice(n - min_bit, k,
                                              replace=False))
        gates.append((rand_unitary(k, rng), qs))
    return gates


def host_norm(flat, chunk=2 ** 24):
    """2-norm of a host complex64 vector, summed in float64 a chunk at a
    time (no temporary of the vector's size)."""
    total = 0.0
    for s in range(0, flat.size, chunk):
        part = flat[s:s + chunk].astype(np.complex128)
        total += np.vdot(part, part).real
    return np.sqrt(total)


def drive_simulate(gates, n, optimize, idx):
    """One ``simulate`` of ``gates`` (identities keep all n qubits in the
    register; the result goes to the host), launch counts zeroed just
    before and read just after, device peak from just before; returns
    the measured numbers and the amplitudes at ``idx``."""
    import torch
    from hybridq_tpu_torch import Gate
    from hybridq_tpu_torch.convert import circuit_from_matrices
    from hybridq_tpu_torch.simulation import fused_kernels as fk
    from hybridq_tpu_torch.simulation import simulate

    circuit = circuit_from_matrices(gates) + \
        [Gate('I', qubits=[q]) for q in range(n)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fk.reset_counts()
    t0 = time.perf_counter()
    psi, info = simulate(circuit, initial_state='0' * n, optimize=optimize,
                         remove_id_gates=False, return_info=True,
                         max_largest_intermediate=2 ** n)
    dt = time.perf_counter() - t0
    launches = fk.counts()
    peak = torch.cuda.max_memory_allocated()
    check(psi.shape == (2,) * n and psi.dtype == np.complex64,
          f"main_path: simulate returned {psi.dtype} {psi.shape}")
    flat = psi.reshape(-1)
    norm = host_norm(flat)
    amps = {int(i): complex(flat[int(i)]) for i in idx}
    del psi, flat
    check(abs(norm - 1) <= NORM_TOL, f"main_path: simulate ({optimize}, "
          f"n={n}) norm {norm}")
    check_engine_launches(f"main_path simulate ({optimize}, n={n})",
                          info['engine'], launches)
    container = 2 ** (n + 1) * 4
    return {'optimize': optimize, 'engine': info['engine'], 'n': n,
            'simulate_s': dt, 'simulate_norm': float(norm),
            'launches': launches, 'peak_gib': peak / 2 ** 30,
            'peak_over_container': peak / container}, amps


def timed_passes(ev, state, items, tag):
    """One warm pass (every operand is then uploaded), then ``REPS`` timed
    passes; returns the state, seconds a pass and launches a pass."""
    import torch
    from hybridq_tpu_torch.simulation import fused_kernels as fk

    def run_pass(state):
        for i, (U, qs) in enumerate(items):
            state = ev.apply_gate(state, np.asarray(U), tuple(qs),
                                  gate_key=(tag, i))
        return state

    state = run_pass(state)
    torch.cuda.synchronize()
    fk.reset_counts()
    t0 = time.perf_counter()
    for _ in range(REPS):
        state = run_pass(state)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / REPS
    return state, dt, {k: v / REPS for k, v in fk.counts().items() if v}


def phase_main_path(out, name):
    import torch
    from hybridq_tpu_torch.simulation import kernels as ik

    n = N_MAIN
    card = card_power()
    rng = np.random.default_rng(SEED)
    gates = bench_workload(n, 4, MAIN_GATES, rng)
    idx = np.random.default_rng(SEED + 1).choice(2 ** n, 16, replace=False)

    # (a) the user's entry point
    sim, amps_sim = drive_simulate(gates, n, 'evolution', idx)
    emit({'phase': 'main_path', 'part': 'simulate', **sim, 'card': card},
         out)
    torch.cuda.empty_cache()
    # the same call again, under torch.profiler through profile_dir
    emit({'phase': 'main_path', 'part': 'profile', 'n': n,
          **profiled_simulate(gates, n), 'card': card}, out)
    torch.cuda.empty_cache()

    # (b) bench-style passes through IndexedEvolver, paired and unpaired
    straight = ik.pair_matrix_gates(gates, n)
    sev = ik.IndexedEvolver(n, device='cuda')
    torch.cuda.reset_peak_memory_stats()
    state = sev.prepare_state('0' * n)
    for i, (U, qs) in enumerate(straight):
        state = sev.apply_gate(state, np.asarray(U), tuple(qs),
                               gate_key=('st', i))
    d_st = max(abs(sev.amplitude(state, int(i)) - amps_sim[int(i)])
               for i in idx)
    check(d_st <= 1e-6, f"main_path: straight evolver and simulate "
          f"disagree ({d_st:.3g})")
    state, dt_st, st_launches = timed_passes(sev, state, straight, 'st')
    state, dt_st_single, _ = timed_passes(sev, state, gates, 'sg')
    peak_st = torch.cuda.max_memory_allocated()
    norm_st = torch.linalg.vector_norm(state).item()
    del state
    torch.cuda.empty_cache()
    check(abs(norm_st - 1) <= NORM_TOL, f"main_path: straight norm "
          f"{norm_st}")
    emit({'phase': 'main_path', 'part': 'passes', 'n': n,
          'gates': len(gates),
          'straight': {'blocks': len(straight),
                       'block_sizes': sorted(len(q) for _, q in straight),
                       'pass_s': dt_st, 'gates_per_s': len(gates) / dt_st,
                       'launches_per_pass': st_launches,
                       'unpaired_pass_s': dt_st_single,
                       'unpaired_gates_per_s': len(gates) / dt_st_single,
                       'norm': norm_st, 'peak_gib': peak_st / 2 ** 30},
          'amp_diff_vs_simulate': {'straight': d_st},
          'card': card}, out)
    check(dt_st <= PAIRED_SLACK * dt_st_single,
          f"main_path: the paired straight pass ({dt_st:.4f} s) is slower "
          f"than the unpaired one ({dt_st_single:.4f} s)")

    # (c) past n = 30: straight passes and simulate
    for m in N_WIDE:
        wide = bench_workload(m, 4, MAIN_GATES, np.random.default_rng(SEED))
        items = ik.pair_matrix_gates(wide, m)
        wev = ik.IndexedEvolver(m, device='cuda')
        torch.cuda.reset_peak_memory_stats()
        state = wev.prepare_state('0' * m)
        state, dt_m, _ = timed_passes(wev, state, items, 'w')
        peak_m = torch.cuda.max_memory_allocated()
        del state
        torch.cuda.empty_cache()
        sim_m, _ = drive_simulate(wide, m, 'evolution', [0])
        torch.cuda.empty_cache()
        emit({'phase': 'main_path', 'part': 'wide', 'n': m,
              'blocks': len(items), 'pass_s': dt_m,
              'gates_per_s': len(wide) / dt_m, 'peak_gib': peak_m / 2 ** 30,
              'simulate': sim_m, 'card': card}, out)

    # replay apply_bits at the main path's most frequent gate size
    gen = torch.Generator(device='cuda')
    gen.manual_seed(SEED)
    sizes = [len(qs) for _, qs in straight]
    k = max(set(sizes), key=sizes.count)
    U, qs = next(b for b in straight if len(b[1]) == k)
    bits = [n - 1 - q for q in qs]
    r = compare_kernel(n, 'bits', np.asarray(U, np.complex64), bits, [], gen,
                       name, REPS)
    emit({'phase': 'main_path_kernel', 'name': 'apply_bits', 'n': n,
          'k': len(bits), 'bits': bits, 'victims': [], **r}, out)
    check(r['rel_err'] <= TOL, f"apply_bits at n={n}: max|d|/rms "
          f"{r['rel_err']:.3g} > {TOL}")
    src, replaces = KERNEL_INFO['apply_bits']
    return [{'name': 'apply_bits', 'route': 'cuda', 'source': src,
             'replaces': replaces, 'launches': sim['launches']['apply_bits'],
             'max_abs_err': r['max_abs_err'], 'ms': r['ms'],
             'plain_ms': r['plain_ms'], 'bound_ms': r['bound_ms'],
             'bound_by': r['bound_by'], 'library_ms': r['library_ms']}]


def noisy_rqc(n, depth):
    """``get_rqc(n, depth)`` (seeded) with a ``LocalDepolarizingChannel``
    on every qubit after each layer of ``n`` gates."""
    from hybridq_tpu_torch.extras.random import get_rqc
    from hybridq_tpu_torch.noise import LocalDepolarizingChannel

    np.random.seed(SEED)
    out = []
    for i, g in enumerate(get_rqc(n, depth, indexes=list(range(n)))):
        out.append(g)
        if (i + 1) % n == 0:
            out += list(LocalDepolarizingChannel(list(range(n)), DM_NOISE))
    return out


def phase_dm(out):
    """See the module docstring."""
    import torch
    from hybridq_tpu_torch import dm
    from hybridq_tpu_torch.simulation import fused_kernels as fk

    card = card_power()
    m = N_DM
    c = noisy_rqc(m, DM_GATES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fk.reset_counts()
    t0 = time.perf_counter()
    rho, info = dm.simulate(c, initial_state='0', return_info=True,
                            max_largest_intermediate=2 ** (2 * m))
    dt = time.perf_counter() - t0
    launches = fk.counts()
    peak = torch.cuda.max_memory_allocated()
    rho = rho.reshape(2 ** m, 2 ** m)
    trace = complex(np.trace(rho))
    rng = np.random.default_rng(SEED)
    i, j = rng.integers(2 ** m, size=(2, 4096))
    herm = float(np.abs(rho[i, j] - rho[j, i].conj()).max())
    amax = float(np.abs(np.diagonal(rho)).max())
    del rho
    emit({'phase': 'dm', 'qubits': m, 'doubled': 2 * m, 'gates': len(c),
          'engine': info['engine'], 'seconds': dt, 'launches': launches,
          'peak_gib': peak / 2 ** 30, 'trace': [trace.real, trace.imag],
          'hermitian_max_abs_err': herm, 'max_abs_diag': amax,
          'card': card}, out)
    check(info['engine'] == 'indexed', f"dm: {info['engine']} engine")
    check_engine_launches('dm', info['engine'], launches)
    check(abs(trace - 1) <= DM_TRACE_TOL, f"dm: trace {trace}")
    check(herm <= TOL * amax, f"dm: not Hermitian ({herm:.3g})")

    m = N_DM_SMALL
    c = noisy_rqc(m, DM_GATES)
    r64 = dm.simulate(c, initial_state='0', optimize='evolution-indexed')
    r128 = dm.simulate(c, initial_state='0', complex_type='complex128')
    d = float(np.abs(r64.astype(np.complex128) - r128).max())
    amax = float(np.abs(r128).max())
    emit({'phase': 'dm', 'qubits': m, 'doubled': 2 * m,
          'complex64_vs_complex128': d, 'err_over_max_amp': d / amax,
          'card': card}, out)
    check(d / amax <= PARITY_TOL, f"dm: complex64 against complex128 "
          f"{d / amax:.3g} > {PARITY_TOL}")


def trace_breakdown(trace_dir, wall_s):
    """The device's side of one Chrome trace that ``simulate(...,
    profile_dir=)`` wrote into ``trace_dir``: device operations (kernels,
    copies, sets) by name, the busy share (the union of their intervals
    over the span of the call in the trace, which leaves out the trace's
    export that ``wall_s``, the call's seconds, includes), the host share
    (the rest)
    and the costliest host operators (inclusive times, so nested ones
    count in their callers too)."""
    files = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)]
    check(len(files) == 1, f"main_path: profile_dir holds {files}")
    with open(files[0]) as f:
        events = json.load(f)['traceEvents']
    dev = [e for e in events if e.get('ph') == 'X' and e.get('cat') in
           ('kernel', 'gpu_memcpy', 'gpu_memset')]
    timed = [e for e in events if e.get('ph') == 'X']
    (span,) = [e['dur'] / 1e6 for e in timed if e['name'] == 'hq.simulate'
               and e.get('cat') == 'user_annotation']
    spans = sorted((e['ts'], e['ts'] + e['dur']) for e in dev)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    def top(evs, label):
        by_name = {}
        for e in evs:
            key = label(e)
            n, ms = by_name.get(key, (0, 0.0))
            by_name[key] = (n + 1, ms + e['dur'] / 1e3)
        return [{'op': k, 'count': n, 'ms': ms} for k, (n, ms) in sorted(
            by_name.items(), key=lambda kv: -kv[1][1])[:6]]
    return {'trace_bytes': os.path.getsize(files[0]),
            'device_ops': len(dev), 'wall_s': wall_s, 'trace_span_s': span,
            'device_busy_s': busy / 1e6,
            'device_busy_share': busy / 1e6 / span,
            'host_share': 1 - busy / 1e6 / span,
            'top_device_ops': top(dev, lambda e: f"{e['cat']}: "
                                  f"{e['name'][:70]}"),
            'top_host_ops': top([e for e in timed
                                 if e.get('cat') == 'cpu_op'],
                                lambda e: e['name'][:70])}


def profiled_simulate(gates, n):
    """One ``simulate`` at ``n`` with ``profile_dir``: its seconds and the
    breakdown of the trace it wrote (``trace_breakdown``)."""
    import tempfile

    import torch
    from hybridq_tpu_torch import Gate
    from hybridq_tpu_torch.convert import circuit_from_matrices
    from hybridq_tpu_torch.simulation import simulate

    circuit = circuit_from_matrices(gates) + \
        [Gate('I', qubits=[q]) for q in range(n)]
    with tempfile.TemporaryDirectory() as tmp:
        d = os.path.join(tmp, 'trace')
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        psi = simulate(circuit, initial_state='0' * n,
                       remove_id_gates=False, profile_dir=d,
                       max_largest_intermediate=2 ** n)
        dt = time.perf_counter() - t0
        norm = host_norm(psi.reshape(-1))
        del psi
        check(abs(norm - 1) <= NORM_TOL, f"main_path: profiled simulate "
              f"norm {norm}")
        return trace_breakdown(d, dt)


def noisy_trajectory_circuit(n, depth, damped):
    """``noisy_rqc(n, depth)`` (a ``LocalDepolarizingChannel`` after each
    layer of ``n`` gates) with an ``AmplitudeDampingChannel`` (p = 1: a
    Kraus site each) on the qubits ``damped``, as
    ``tests/test_dm_noise.py``'s general-Kraus case adds it."""
    from hybridq_tpu_torch import Circuit
    from hybridq_tpu_torch.noise import AmplitudeDampingChannel

    return Circuit(noisy_rqc(n, depth) + list(AmplitudeDampingChannel(
        list(damped), gamma=TRAJ_GAMMA, p=1)))


def trajectory_launches(circuit, n_samples):
    """``apply_bits`` launches of the kernel route: one a gate, sample and
    Kraus candidate, plus the chosen Kraus operator."""
    from hybridq_tpu_torch.gate import FunctionalGate

    kraus = [g for g in circuit if isinstance(g, FunctionalGate)]
    return n_samples * (len(circuit) - len(kraus) +
                        sum(len(g.LMatrices) + 1 for g in kraus))


def phase_trajectories(out):
    """See the module docstring."""
    import torch
    from hybridq_tpu_torch.simulation import fused_kernels as fk
    from hybridq_tpu_torch.simulation import trajectories

    card = card_power()
    # (a) the card against the host, sample for sample: from |+...+>
    # at max|d|/rms, and from |0...0>, whose samples are peaked (max|amp|
    # up to 40x the rms), at max|d| over max|amp| (f32 rounding scales
    # with the largest amplitude; see the parity phase)
    n, S = TRAJ_HOLD
    c = noisy_trajectory_circuit(n, TRAJ_LAYERS * n, range(2))
    for start, scale, tol in (('+', 'rms', TOL), ('0', 'max_amp',
                                                  PARITY_TOL)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = trajectories.sample_trajectories(c, S, initial_state=start,
                                               seed=SEED)
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        want = trajectories.sample_trajectories(c, S, initial_state=start,
                                                seed=SEED, device='cpu')
        check(got.shape == (S, 2 ** n), f"trajectories: shape {got.shape}")
        rms = np.sqrt((np.abs(want) ** 2).mean(axis=1))
        amax = np.abs(want).max(axis=1)
        d = np.abs(got - want).max(axis=1)
        err = float((d / (rms if scale == 'rms' else amax)).max())
        emit({'phase': 'trajectories', 'part': 'hold', 'n': n,
              'samples': S, 'sites': len(c), 'initial_state': start,
              'route': trajectories._route(torch.device('cuda'),
                                           np.dtype('complex64'), n),
              'seconds': dt, 'peak_gib': peak / 2 ** 30,
              f'max_err_over_{scale}': err,
              'max_rel_err': float((d / rms).max()),
              'max_amp_over_rms': float((amax / rms).max()),
              'card': card}, out)
        check(err <= tol, f"trajectories: card against host from "
              f"'{start}', max|d| over {scale} {err:.3g} > {tol}")
        del got, want

    # (b) full width through apply_bits
    n, S = TRAJ_WIDE
    c = noisy_trajectory_circuit(n, TRAJ_LAYERS * n, range(4))
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fk.reset_counts()
    t0 = time.perf_counter()
    states = trajectories.sample_trajectories(c, S, seed=SEED)
    dt = time.perf_counter() - t0
    launches = fk.counts()
    peak = torch.cuda.max_memory_allocated()
    norms = [host_norm(s) for s in states]
    del states
    want = trajectory_launches(c, S)
    emit({'phase': 'trajectories', 'part': 'wide', 'n': n, 'samples': S,
          'sites': len(c), 'seconds': dt, 'launches': launches,
          'expected_apply_bits': want,
          'sample_sites_per_s': S * len(c) / dt,
          'batch_gib': S * 2 ** (n + 3) / 2 ** 30,
          'peak_gib': peak / 2 ** 30, 'norms': norms, 'card': card}, out)
    check(launches['apply_bits'] == want, f"trajectories: apply_bits "
          f"launched {launches['apply_bits']} times, not {want}")
    check_engine_launches('trajectories', 'indexed', launches)
    check(all(abs(x - 1) <= NORM_TOL for x in norms),
          f"trajectories: sample norms {norms}")


def clifford_t_circuit(n, n_gates, n_t, seed):
    """``get_rqc(n, n_gates, use_clifford_only=True)`` with ``n_t`` T
    gates inserted where the Heisenberg-evolved ``Z`` on qubit 0 (the
    Clifford circuit's own, gate by gate from the end) has an X or Y, so
    that each T lies in the light cone and can branch."""
    from hybridq_tpu_torch import Circuit, Gate
    from hybridq_tpu_torch.extras.random import get_rqc
    from hybridq_tpu_torch.simulation import clifford

    np.random.seed(seed)
    gates = list(get_rqc(n, n_gates, indexes=list(range(n)),
                         use_clifford_only=True, randomize_power=False))
    code = np.zeros(n, dtype=np.int64)
    code[0] = 3
    sites = []            # (list position, qubit): a T there sees X or Y
    for i in range(len(gates) - 1, -1, -1):
        sites += [(i + 1, int(q)) for q in np.flatnonzero(
            (code == 1) | (code == 2))]
        g = gates[i]
        rows, k = clifford._pauli_rows(np.asarray(g.matrix(), complex),
                                       1e-8)
        s = 0
        for q in g.qubits:
            s = (s << 2) | int(code[q])
        (t,), _ = rows[s]                     # a Clifford: one string
        for j, q in enumerate(g.qubits):
            code[q] = (int(t) >> (2 * (k - 1 - j))) & 3
    pick = np.random.default_rng(seed).choice(len(sites), n_t,
                                              replace=False)
    for i in sorted(pick, key=lambda j: -sites[j][0]):
        gates.insert(sites[i][0], Gate('T', [sites[i][1]]))
    return Circuit(gates)


def same_strings(got, want, tol, where):
    """Two Pauli-string dicts agree by key: the same strings above 1e-6,
    every value within ``tol`` of max|v|; returns the largest difference
    over max|v|."""
    keys = {k for k, v in got.items() if abs(v) > 1e-6}
    check(keys == {k for k, v in want.items() if abs(v) > 1e-6},
          f"{where}: the strings differ")
    scale = max(abs(v) for v in want.values())
    d = max(abs(got.get(k, 0.0) - want.get(k, 0.0))
            for k in set(got) | set(want)) / scale
    check(d <= tol, f"{where}: {d:.3g} of max|v| > {tol}")
    return d


def run_clifford(c, pauli, **kw):
    """One ``update_pauli_string`` with its info, seconds and device
    peak."""
    import torch
    from hybridq_tpu_torch.simulation import clifford

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    db, info = clifford.update_pauli_string(c, pauli, return_info=True,
                                            **kw)
    torch.cuda.synchronize()
    return db, {**info, 'seconds': time.perf_counter() - t0,
                'peak_gib': torch.cuda.max_memory_allocated() / 2 ** 30}


def phase_clifford(out):
    """See the module docstring."""
    card = card_power()
    n, n_gates = CLIFFORD_N, CLIFFORD_GATES
    pauli = 'Z' + 'I' * (n - 1)
    c = clifford_t_circuit(n, n_gates, CLIFFORD_T_HOLD, SEED)
    want, ref = run_clifford(c, pauli, backend='numpy',
                             float_type='float64')
    parts = {'numpy_float64': ref}
    for ft, tol in (('float64', 1e-9), ('float32', 1e-5)):
        got, info = run_clifford(c, pauli, float_type=ft)
        info['of_max_v'] = same_strings(got, want, tol,
                                        f"clifford ({ft})")
        parts[f'torch_{ft}'] = info
        del got
    emit({'phase': 'clifford', 'part': 'hold', 'n': n, 'gates': len(c),
          'T': CLIFFORD_T_HOLD, **parts, 'card': card}, out)
    check(ref['largest_batch'] > 2 ** 18, "clifford: the frontier stayed "
          f"below max_breadth_first_branches ({ref['largest_batch']})")

    c = clifford_t_circuit(n, n_gates, CLIFFORD_T_TIMED, SEED)
    db, info = run_clifford(c, pauli)
    emit({'phase': 'clifford', 'part': 'timed', 'n': n, 'gates': len(c),
          'T': CLIFFORD_T_TIMED, **info,
          'branches_per_s': info['n_explored_branches'] / info['seconds'],
          'card': card}, out)
    check(len(db) > 0, "clifford: empty expansion")


def phase_cli(out):
    """See the module docstring."""
    import pickle
    import tempfile

    import torch
    from hybridq_tpu_torch import cli
    from hybridq_tpu_torch.extras.io.qasm import from_qasm, to_qasm
    from hybridq_tpu_torch.simulation import clifford, simulate
    from hybridq_tpu_torch.simulation import fused_kernels as fk

    card = card_power()
    here = os.path.dirname(os.path.abspath(__file__))
    qasm = os.path.join(here, 'examples', 'circuit.qasm')
    with tempfile.TemporaryDirectory() as tmp:
        pk = os.path.join(tmp, 'out.pkl')
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, '-m', 'hybridq_tpu_torch.cli',
                            qasm, pk], cwd=here, capture_output=True,
                           text=True, timeout=600)
        dt_cli = time.perf_counter() - t0
        check(r.returncode == 0, f"cli: main exited {r.returncode}: "
              f"{r.stderr[-2000:]}")
        with open(pk, 'rb') as f:
            results = pickle.load(f)
        with open(qasm) as f:
            circuit = from_qasm(f.read())
        n = len(circuit.all_qubits)
        fk.reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        want, info = simulate(circuit, initial_state='0', return_info=True)
        launches = fk.counts()
        peak = torch.cuda.max_memory_allocated()
        got = results['simulate']
        check(isinstance(got, np.ndarray) and got.shape == want.shape,
              f"cli: the pickle holds {type(got)}")
        rel = float(np.abs(got - want).max() /
                    np.sqrt(np.mean(np.abs(want) ** 2)))
        emit({'phase': 'cli', 'part': 'main', 'qubits': n,
              'gates': len(circuit), 'engine': info['engine'],
              'cli_seconds': dt_cli, 'runtime_s': results['runtime (s)'],
              'launches': launches, 'peak_gib': peak / 2 ** 30,
              'max_rel_err': rel, 'card': card}, out)
        check(info['engine'] == 'indexed', f"cli: {info['engine']} engine")
        check_engine_launches('cli', info['engine'], launches)
        check(rel <= CONTRACT, f"cli: main against simulate {rel:.3g}")

        c = clifford_t_circuit(CLI_DM_N, CLI_DM_GATES, CLI_DM_T, SEED)
        path = os.path.join(tmp, 'clifford_t.qasm')
        with open(path, 'w') as f:
            f.write(to_qasm(c))
        js = os.path.join(tmp, 'out.json')
        pauli = 'Z' + 'I' * (CLI_DM_N - 1)
        t0 = time.perf_counter()
        cli.main_dm([path, js, '--initial-pauli-string', pauli,
                     '--return-info'])
        dt_dm = time.perf_counter() - t0
        with open(js) as f:
            payload = json.load(f)
        got = {k: v[0] for k, v in payload['pauli_strings'].items()}
        want = clifford.update_pauli_string(from_qasm(to_qasm(c)), pauli,
                                            backend='numpy')
        d = same_strings(got, want, 1e-5, 'cli main_dm')
        emit({'phase': 'cli', 'part': 'main_dm', 'qubits': CLI_DM_N,
              'gates': len(c), 'seconds': dt_dm, 'info': payload['info'],
              'of_max_v': d, 'card': card}, out)


def tn_costs(sc, name):
    """Per-slice work of a ``SlicedContractor``'s plan: complex MACs
    (``SliceCost.sliced_flops``: every step at its sliced size), those of
    the batched steps alone (the slice-invariant subtrees run once a
    call), the bytes that the batched steps write and read once each,
    and the least time (ms) of a slice: the larger of 8 real flops per
    MAC at the fp32 peak and those bytes at the memory rate."""
    tree, sl = sc.plan.tree, sc.plan.sliced_set
    batched, steps = sc.schedule()
    macs = tree.total_flops(sl)
    macs_batched = sum(tree.node_flops(v, sl) for v, *_ in steps
                       if batched[v])
    nbytes = sum(2 * 8 * tree.node_size(v, sl) for v, *_ in steps
                 if batched[v])
    bw, flops, _ = peaks(name)
    t_ops, t_bytes = 8 * macs / flops, nbytes / bw
    return {'macs_per_slice': macs, 'macs_per_slice_batched': macs_batched,
            'batched_steps': sum(batched[v] for v, *_ in steps),
            'steps': len(steps), 'bytes_per_slice': nbytes,
            'ops_bound_ms': t_ops * 1e3, 'bytes_bound_ms': t_bytes * 1e3,
            'bound_ms': max(t_ops, t_bytes) * 1e3,
            'bound_by': 'operations' if t_ops >= t_bytes else 'bytes'}


def timed_slices(sc, r, **kw):
    """``contract_torch`` over the slice range ``r`` on the card: the
    result, its seconds and the device peak (GiB) of the call."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    amp = sc.contract_torch(device='cuda', slice_range=r, **kw)
    dt = time.perf_counter() - t0
    return amp, dt, torch.cuda.max_memory_allocated() / 2 ** 30


def tn_profile(sc, r):
    """Where a range of slices spends the card's time: ``torch.profiler``
    over ``contract_torch``, the device kernels' time by kind (the
    cuBLAS products, copies such as ``tensordot``'s permutes, the
    rest), the busy share (the union of kernel intervals over the
    call's wall time) and the five costliest kernels.  Kinds:
    ``tn_apply`` (``csrc/tn_apply.cu``), ``gemm`` (cuBLAS), ``copy``
    (permutes), ``other``.  None when the trace holds no device
    kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sc.contract_torch(device='cuda', slice_range=r)
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    by_kind, by_name = {}, {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        low = e.name.lower()
        kind = ('tn_apply' if any(w in low for w in ('tn_column_kernel',
                                                      'tn_tile_kernel'))
                else 'gemm' if any(w in low for w in ('gemm', 'cutlass',
                                                       'sm90', 'xmma'))
                else 'copy' if any(w in low for w in ('copy', 'elementwise'))
                else 'other')
        by_kind[kind] = by_kind.get(kind, 0.0) + us / 1e3
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + us / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {'slices': list(r),
            'contracted_slices': sc.last_counts['contracted'],
            'wall_ms': wall * 1e3,
            'device_busy_ms': busy / 1e3,
            'device_busy_share': busy / 1e6 / wall,
            'kernel_ms_by_kind': by_kind, 'kernels': len(kernels),
            'top_kernels_ms': top}


def tn_apply_classes(sc):
    """The batched ``'apply'`` steps of a contractor's schedule by class
    ``(s, f)``: ``{(s, f): (count, (step, inplace))}``, each with its
    step that moves the most bytes (the class at its real widths)."""
    batched, steps = sc.schedule()
    classes = {}
    for v, _, _, op in steps:
        if op[0] != 'apply' or not batched[v]:
            continue
        step = op[1]
        count, best = classes.get((step.s, step.f), (0, None))
        if best is None or step.nx + step.ny > best[0].nx + best[0].ny:
            best = (step, op[3])
        classes[(step.s, step.f)] = (count + 1, best)
    return classes


def tn_apply_case(step, inplace, name, gen):
    """One ``tn_apply`` class at its widths (a batch of one slice, d12's
    chunk): the kernel against the plain version in complex64 and
    complex128 (max|d|/rms, ``TN_APPLY_TOL``), in place too where the
    executor runs it so; then the kernel (as the executor calls it) and
    ``torch.tensordot`` over the same legs of the same complex64
    operands in turns (``turns``), the plain version, and the bound: each
    operand read and the result written once, or 8 real flops a complex
    MAC at the fp32 peak."""
    import torch
    from hybridq_tpu_torch.simulation.tn import tn_kernels as tk

    r = {'s': step.s, 'f': step.f, 'nx': step.nx, 'ny': step.ny,
         'x_batched': step.x_batched, 'op_batched': step.op_batched,
         'inplace': inplace}
    for dtype in (torch.complex128, torch.complex64):
        x = torch.randn((1,) * step.x_batched + (2,) * step.nx, dtype=dtype,
                        device='cuda', generator=gen)
        # 2^(-s/2): the norm holds in expectation over repeated in-place
        # calls
        op = torch.randn((1,) * step.op_batched + (2,) * (step.s + step.f),
                         dtype=dtype, device='cuda', generator=gen) * \
            2.0 ** (-step.s / 2)
        want = tk.tn_apply_plain(x, op, step)
        got = tk.tn_apply(x, op, step)
        if inplace:
            got = torch.stack([got, tk.tn_apply(x.clone(), op, step, True)])
            want = torch.stack([want, want])
        torch.cuda.synchronize()
        rms = float(want.abs().pow(2).mean().sqrt())
        d = float((got - want).abs().max())
        key = str(dtype).replace('torch.', '')
        r[f'max_abs_err_{key}'] = d
        r[f'rel_err_{key}'] = d / rms
        check(np.isfinite(d) and d / rms <= TN_APPLY_TOL[key],
              f"tn_apply ({step.s}, {step.f}) {key}: max|d|/rms "
              f"{d / rms:.3g} > {TN_APPLY_TOL[key]}")
        del got, want
    r['max_abs_err'] = r['max_abs_err_complex64']
    # x and op: the complex64 operands, made last
    xa = [step.x_batched + step.nx - 1 - b for b in step.xbits]
    oa = [step.op_batched + step.s + step.f - 1 - b for b in step.ocol]
    t = turns(lambda: tk.tn_apply(x, op, step, inplace),
              lambda: torch.tensordot(x, op, dims=(xa, oa)),
              TN_APPLY_REPS, 'tn_apply', host=True)
    r.update({k: t[k] for k in ('ms', 'library_ms', 'device_ms',
                                'library_device_ms', 'host_ms',
                                'library_host_ms')},
             grid=t['grid'], vs_library=t['ms'] / t['library_ms'],
             plain_ms=time_ms(lambda: tk.tn_apply_plain(x, op, step),
                              TN_APPLY_REPS))
    bw, flops, _ = peaks(name)
    nbytes = 8 * (x.numel() + op.numel() + 2 ** step.ny)
    t_bytes = nbytes / bw
    t_ops = 8 * 2 ** (step.nx + step.f) / flops
    r.update(bytes=nbytes, bound_ms=max(t_bytes, t_ops) * 1e3,
             bound_by='bytes' if t_bytes >= t_ops else 'operations')
    r['of_bound'] = r['bound_ms'] / r['ms']
    del x, op
    torch.cuda.empty_cache()
    return r


def tn_turns(sc, r):
    """Whole slices of ``r``, the kernel route and the plain route
    (``tn_apply`` patched to ``tn_apply_plain`` in the executor), in turns
    (kernel, plain, plain, kernel), each turn one ``contract_torch`` over
    ``r`` on the host clock; the two sums and the ms a contracted slice
    of each."""
    from hybridq_tpu_torch.simulation.tn import tn_kernels as tk

    kernel = tk.tn_apply
    sums, ms = {}, {'kernel': [], 'plain': []}
    try:
        for route in ('kernel', 'plain', 'plain', 'kernel'):
            tk.tn_apply = kernel if route == 'kernel' else tk.tn_apply_plain
            amp, dt, _ = timed_slices(sc, r)
            sums[route] = amp
            ms[route].append(dt / sc.last_counts['contracted'] * 1e3)
    finally:
        tk.tn_apply = kernel
    return sums, ms


def straight_probs(S, n, positions):
    """Outcome probabilities of physical ``positions`` (joint, in the
    order given) of the straight container ``S``."""
    from hybridq_tpu_torch.simulation.sharded import _bit_view

    N = 2 ** n
    shape, order = _bit_view(n, [n - 1 - p for p in positions])
    k = len(positions)
    p2 = (S[:N] * S[:N] + S[N:] * S[N:]).view(shape)
    m = p2.sum(dim=tuple(range(0, 2 * k + 1, 2)))
    return m.permute([order.index(j) for j in range(k)]).reshape(-1)


def sharded_full_width(m, gates, n, name):
    """Phase ``sharded`` (a), and (b) on 4 shards: see the module
    docstring.  Returns the line's numbers."""
    import torch
    from hybridq_tpu_torch import Circuit, Gate
    from hybridq_tpu_torch.convert import circuit_from_matrices
    from hybridq_tpu_torch.simulation import fused_kernels as fk
    from hybridq_tpu_torch.simulation import kernels as ik
    from hybridq_tpu_torch.simulation.sharded import ShardedIndexedEvolver

    qubits = list(range(n))
    circuit = circuit_from_matrices(gates)
    ev = ShardedIndexedEvolver(n, devices=['cuda:0'] * m)
    blocks = ev._compressed(circuit)
    ops, planned_perm = ev._schedule(blocks, {q: q for q in qubits})
    planned = sum(op[0] == 'swap' for op in ops)
    shard_bytes = m * 2 ** (ev.n_local + 1) * 4
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    psi = ev.prepare_state('0' * n)
    fk.reset_counts()
    t0 = time.perf_counter()
    psi = ev.evolve(psi, circuit, qubits=qubits)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = fk.counts()
    exchanges = ev.exchanges
    peak = torch.cuda.max_memory_allocated()
    r = {'shards': m, 'n_local': ev.n_local, 'blocks': len(blocks),
         'launches': launches['apply_bits'], 'exchanges': exchanges,
         'planned_exchanges': planned, 'perm': list(ev.perm),
         'first_pass_s': first_s, 'peak_gib': peak / 2 ** 30,
         'peak_over_shards': peak / shard_bytes}
    check(launches['apply_bits'] == m * len(blocks),
          f"sharded ({m}): apply_bits launched {launches['apply_bits']} "
          f"times, not shards x blocks = {m * len(blocks)}")
    plain = {k: v for k, v in launches.items() if k.endswith('_plain') and v}
    check(not plain, f"sharded ({m}): a plain version ran: {plain}")
    check(exchanges == planned and ev.perm == planned_perm,
          f"sharded ({m}): {exchanges} exchanges, the schedule plans "
          f"{planned}")
    check(exchanges > 0, f"sharded ({m}): no global qubit was hit")

    # The straight engine on the same gates, each qubit at the physical
    # position the sharded run left it in: its container in canonical
    # order is the shards laid end to end.
    pos = {q: p for p, q in enumerate(ev.perm)}
    sev = ik.IndexedEvolver(n, device='cuda')
    S = sev.prepare_state('0' * n)
    for U, qs in gates:
        S = sev.apply_gate(S, U, tuple(pos[q] for q in qs))
    N, Nl = 2 ** n, 2 ** ev.n_local
    rms = torch.linalg.vector_norm(S).item() / N ** 0.5
    d = 0.0
    for i, s in zip(ev.mesh.index, psi):
        d = max(d, (s[:Nl] - S[i * Nl:(i + 1) * Nl]).abs().max().item(),
                (s[Nl:] - S[N + i * Nl:N + (i + 1) * Nl]).abs().max().item())
    r.update({'max_abs_err': d, 'rel_err': d / rms})
    check(d / rms <= TOL, f"sharded ({m}): max|d|/rms {d / rms:.3g} > "
          f"{TOL} against the straight engine")

    if m == SHARDS[0]:
        # (b) collectives against the straight container
        ex0 = ev.exchanges
        # a global qubit and two local ones; X on the other global qubit
        qs3 = [ev.perm[0]] + [q for q in (n // 2, n - 4, n // 2 - 1)
                              if q != ev.perm[0]][:2]
        z = 2 * n // 3 + (ev.perm[1] == 2 * n // 3)
        psi, probs = ev.probabilities(psi, qs3)
        want = straight_probs(S, n, [pos[q] for q in qs3]).double().cpu()
        dp = float(np.abs(probs - want.numpy()).max())
        op = Circuit([Gate('X', qubits=[ev.perm[1]]),
                      Gate('Z', qubits=[z])])
        perm0 = list(ev.perm)
        got = ev.expectation_value(psi, op, qubits=qubits)
        check(ev.perm == perm0, "sharded: expectation_value moved the "
              "layout")
        T_ = S.clone()
        for g in op:
            fk.apply_bits(T_, torch.as_tensor(np.asarray(g.matrix(),
                                                         np.complex64),
                                              device=S.device),
                          [n - 1 - pos[g.qubits[0]]])
        want_e = complex(torch.dot(S[:N], T_[:N]).item() +
                         torch.dot(S[N:], T_[N:]).item(),
                         torch.dot(S[:N], T_[N:]).item() -
                         torch.dot(S[N:], T_[:N]).item())
        del T_
        de = abs(got - want_e)
        q = ev.perm[0]
        p0 = straight_probs(S, n, [pos[q]])[0].item()
        psi = ev.project(psi, [q], 0, renormalize=False)
        norm_p = ev.norm(psi)
        psi = ev.project(psi, [q], 0)
        norm_r = ev.norm(psi)
        r['collectives'] = {
            'probabilities': {'qubits': qs3, 'max_abs_err': dp,
                              'tol': TOL},
            'expectation_value': {'op': f'X{op[0].qubits[0]} Z{z}',
                                  'value': [got.real, got.imag],
                                  'straight': [want_e.real, want_e.imag],
                                  'abs_err': de, 'tol': TOL},
            'project': {'qubit': q, 'norm2': norm_p ** 2, 'p0': p0,
                        'abs_err': abs(norm_p ** 2 - p0),
                        'renormalized_norm': norm_r},
            'exchanges': ev.exchanges - ex0}
        check(dp <= TOL, f"sharded: probabilities off by {dp:.3g}")
        check(de <= TOL, f"sharded: expectation_value off by {de:.3g} "
              "(of <psi|psi> = 1)")
        check(abs(norm_p ** 2 - p0) <= TOL and abs(norm_r - 1) <= NORM_TOL,
              f"sharded: project: norm^2 {norm_p ** 2} against p0 {p0}, "
              f"renormalized {norm_r}")
    del S

    # warm passes: the sharded one beside the straight one, in one run
    torch.cuda.synchronize()
    ex0 = ev.exchanges
    t0 = time.perf_counter()
    for _ in range(REPS):
        psi = ev.evolve(psi, circuit, qubits=qubits)
    torch.cuda.synchronize()
    pass_s = (time.perf_counter() - t0) / REPS
    pass_ex = (ev.exchanges - ex0) / REPS
    S = sev.prepare_state('0' * n)
    S, straight_s, _ = timed_passes(sev, S, gates, 'sh')
    del S, sev
    torch.cuda.empty_cache()
    # one exchange, timed: swap global bit 0 with slot 0 an even number
    # of times, the warm call included (each is its own inverse)
    ex_ms = time_ms(lambda: ev.mesh.exchange(psi, 0, 0, ev.n_local),
                    2 * REPS + 1)
    ex_bytes = m * 2 ** ev.n_local * 4 * 2     # half of each shard, r + w
    norm = ev.norm(psi)
    check(abs(norm - 1) <= NORM_TOL, f"sharded ({m}): norm {norm}")
    del psi
    torch.cuda.empty_cache()
    r.update({'pass_s': pass_s, 'gates_per_s': len(gates) / pass_s,
              'exchanges_per_pass': pass_ex,
              'straight_pass_s': straight_s,
              'straight_gates_per_s': len(gates) / straight_s,
              'sharded_over_straight': pass_s / straight_s,
              'exchange_ms': ex_ms, 'exchange_bytes': ex_bytes,
              'exchange_bound_ms': ex_bytes / peaks(name)[0] * 1e3,
              'exchange_share': pass_ex * ex_ms / (pass_s * 1e3),
              'norm': norm})
    return r


def phase_sharded(out, name):
    """The sharded engines on one card: see the module docstring."""
    import tempfile

    import torch
    import torch.distributed as dist
    from hybridq_tpu_torch import Circuit, Gate, parallel
    from hybridq_tpu_torch.extras.random import get_rqc
    from hybridq_tpu_torch.simulation import fused_kernels as fk
    from hybridq_tpu_torch.simulation import simulate
    from hybridq_tpu_torch.simulation.clifford import update_pauli_string
    from hybridq_tpu_torch.simulation.tn import make_plan

    card = card_power()
    n = N_MAIN
    gates = bench_workload(n, 4, MAIN_GATES, np.random.default_rng(SEED))
    summary = {}
    for m in SHARDS:
        r = sharded_full_width(m, gates, n, name)
        summary[m] = r['launches']
        emit({'phase': 'sharded', 'part': 'full_width', 'n': n,
              'gates': len(gates), **r, 'card': card}, out)

    # (c) simulate's entry point at n = 24, against the straight engine
    ns = N_PARITY
    np.random.seed(SEED)
    c = Circuit([Gate('H', qubits=[q]) for q in range(ns)]) + \
        get_rqc(ns, PARITY_GATES[0], indexes=list(range(ns)))
    want = simulate(c, initial_state='0', optimize='evolution')
    rms = float(np.sqrt(np.mean(np.abs(want) ** 2)))
    amax = float(np.abs(want).max())
    fk.reset_counts()
    got, info = simulate(c, initial_state='0', optimize='evolution-sharded',
                         devices=['cuda:0'] * SHARDS[0], return_info=True)
    launches = fk.counts()
    d = float(np.abs(got - want).max())
    emit({'phase': 'sharded', 'part': 'simulate', 'n': ns, 'gates': len(c),
          'engine': info['engine'], 'shards': SHARDS[0],
          'seconds': info['runtime (s)'], 'launches': launches,
          'rel_err': d / rms, 'err_over_max_amp': d / amax, 'card': card},
         out)
    check(info['engine'] == 'sharded' and got.shape == (2,) * ns,
          f"sharded: simulate gave {info['engine']} {got.shape}")
    check_engine_launches("sharded simulate", 'indexed', launches)
    check(d / amax <= PARITY_TOL and d / rms <= TOL,
          f"sharded: simulate max|d|/max|amp| {d / amax:.3g}, "
          f"max|d|/rms {d / rms:.3g}")

    # (d) a process group of one under NCCL: the collectives on CUDA
    # tensors (exchanges across ranks are held on the CPU under gloo)
    cc = clifford_t_circuit(CLI_DM_N, CLI_DM_GATES, CLI_DM_T, SEED)
    pauli = 'Z' + 'I' * (CLI_DM_N - 1)
    whole = update_pauli_string(cc, pauli, use_mpi=False,
                                float_type='float64')
    with tempfile.TemporaryDirectory() as tmp:
        parallel.initialize(f'file://{tmp}/store', 1, 0, device='cuda',
                            timeout=120)
        try:
            backend = dist.get_backend()
            got_g = simulate(c, initial_state='0',
                             optimize='evolution-sharded',
                             devices=['cuda:0'] * SHARDS[0])
            split = update_pauli_string(cc, pauli, use_mpi=True,
                                        float_type='float64')
        finally:
            dist.destroy_process_group()
    dg = float(np.abs(got_g - got).max())
    dc = same_strings(split, whole, 1e-9, "sharded: use_mpi=True")
    emit({'phase': 'sharded', 'part': 'nccl_group_of_one',
          'backend': backend, 'simulate_max_abs_diff': dg,
          'clifford_strings': len(split), 'clifford_of_max_v': dc,
          'note': 'exchanges across ranks are held only on the CPU under '
                  'gloo (tests/test_torch_parallel.py)', 'card': card}, out)
    check(backend == 'nccl', f"sharded: the group's backend is {backend}")
    check(dg <= 1e-6, f"sharded: simulate in the group differs by {dg:.3g}")

    # (e) the TN phase's case over two entries of one card
    nt = N_TN
    np.random.seed(SEED)
    ct = get_rqc(nt, TN_GATES, indexes=list(range(nt)))
    net, opt = simulate(ct, initial_state='0' * nt,
                        final_state='.' * TN_OPEN + '0' * (nt - TN_OPEN),
                        optimize='tn', tensor_only=True,
                        max_time=TN_MAX_TIME)
    tinfo, plan = make_plan(opt, target_size=TN_SLICED_WIDTH,
                            time_budget=TN_MAX_TIME)
    one = simulate(net, optimize=(tinfo, plan))
    two = simulate(net, optimize=(tinfo, plan), devices=['cuda:0'] * 2)
    trms = float(np.sqrt(np.mean(np.abs(one) ** 2)))
    dt_ = float(np.abs(two - one).max())
    emit({'phase': 'sharded', 'part': 'tn_two_entries', 'n': nt,
          'n_slices': plan.nslices, 'rel_err': dt_ / trms, 'tol': TOL,
          'card': card}, out)
    check(plan.nslices % 2 == 0, f"sharded: {plan.nslices} slices")
    check(dt_ / trms <= TOL, f"sharded: contract over two entries "
          f"max|d|/rms {dt_ / trms:.3g}")
    torch.cuda.empty_cache()
    emit({'phase': 'sharded', 'ok': True, 'apply_bits_launches': summary,
          'card': card}, out)


def phase_tn(out, name):
    """The tensor-network engine (``simulation/tn``) on the card: a
    26-qubit ``simulate(optimize='tn')`` against complex128 evolution, the
    committed Sycamore-53 plans timed, and the executor's precision."""
    import torch
    from hybridq_tpu_torch import native
    from hybridq_tpu_torch.convert import load_reference_plan
    from hybridq_tpu_torch.extras.random import get_rqc
    from hybridq_tpu_torch.simulation import simulate
    from hybridq_tpu_torch.simulation.tn import contract
    from hybridq_tpu_torch.simulation.tn import tn_kernels as tk

    card = card_power()
    check(native.hgp_available(), "tn: the native path-search library "
          "did not build (g++)")
    summary = []

    # Every contraction step must run on the card, none on the host.
    steps = {'n': 0}
    step = contract._step

    def on_card(x, y, op):
        if x.device.type != 'cuda' or y.device.type != 'cuda':
            raise PhaseError(f"tn: a step ran on {x.device}/{y.device}")
        steps['n'] += 1
        return step(x, y, op)

    def no_host(*args, **kwargs):
        raise PhaseError("tn: the numpy executor ran")

    contract_np = contract.SlicedContractor.contract_np
    contract._step = on_card
    contract.SlicedContractor.contract_np = no_host
    try:
        # Correctness: amplitudes with TN_OPEN final legs open.
        n = N_TN
        np.random.seed(SEED)
        c = get_rqc(n, TN_GATES, indexes=list(range(n)))
        final = '.' * TN_OPEN + '0' * (n - TN_OPEN)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tk.reset_counts()
        t0 = time.perf_counter()
        got, info = simulate(c, initial_state='0' * n, final_state=final,
                             optimize='tn', max_time=TN_MAX_TIME,
                             return_info=True)
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        n_steps = steps['n']
        sim_counts = tk.counts()
        psi, einfo = simulate(c, initial_state='0' * n,
                              complex_type='complex128', return_info=True)
        want = psi[(slice(None),) * TN_OPEN + (0,) * (n - TN_OPEN)]
        del psi
        torch.cuda.empty_cache()
        rms = float(np.sqrt(np.mean(np.abs(want) ** 2)))
        d = float(np.abs(got.astype(np.complex128) - want).max())
        emit({'phase': 'tn', 'part': 'simulate', 'n': n, 'gates': len(c),
              'open': TN_OPEN, 'shape': list(got.shape),
              'dtype': str(got.dtype), 'seconds': dt,
              'contract_seconds': info['runtime (s)'],
              'log2_flops': float(np.log2(max(info['flops'], 1))),
              'log2_largest': float(np.log2(info['largest_intermediate'])),
              'n_slices': info['n_slices'], 'steps_on_card': n_steps,
              'launches': sim_counts, 'peak_gib': peak,
              'reference': einfo['engine'],
              'max_abs_err': d, 'rel_err': d / rms, 'tol': TN_TOL,
              'card': card}, out)
        check(got.shape == (2,) * TN_OPEN and got.dtype == np.complex64,
              f"tn: result {got.shape} {got.dtype}")
        check(np.isfinite(got).all(), "tn: non-finite amplitudes")
        check(n_steps > 0, "tn: no contraction step ran")
        check(sim_counts['tn_apply'] > 0 and
              sim_counts['tn_apply_plain'] == 0,
              f"tn: simulate's steps did not run on tn_apply: {sim_counts}")
        check(d / rms <= TN_TOL, f"tn: max|d|/rms {d / rms:.3g} > {TN_TOL}")

        # The same amplitudes sliced: the batched steps on the card.
        steps['n'] = 0
        got, info = simulate(c, initial_state='0' * n, final_state=final,
                             optimize='tn', max_time=TN_MAX_TIME,
                             max_largest_intermediate=TN_SLICED_WIDTH,
                             return_info=True)
        d = float(np.abs(got.astype(np.complex128) - want).max())
        emit({'phase': 'tn', 'part': 'simulate_sliced', 'n': n,
              'max_largest_intermediate': TN_SLICED_WIDTH,
              'n_slices': info['n_slices'],
              'log2_largest': float(np.log2(info['largest_intermediate'])),
              'contract_seconds': info['runtime (s)'],
              'steps_on_card': steps['n'], 'max_abs_err': d,
              'rel_err': d / rms, 'tol': TN_TOL, 'card': card}, out)
        check(info['n_slices'] > 1, "tn: the sliced run made no slices")
        check(d / rms <= TN_TOL, f"tn: sliced max|d|/rms {d / rms:.3g} > "
              f"{TN_TOL}")

        # Workload: the committed Sycamore-53 plans.
        here = os.path.dirname(os.path.abspath(__file__))
        plans = os.path.join(here, 'scripts', '_plan_cache')
        net, oo, tree, sliced, cost = load_reference_plan(
            os.path.join(plans, TN_PLANS[0]))
        plan = contract.ContractionPlan(tree, sliced)
        sc = contract.SlicedContractor(plan, net.tensors, oo)
        costs = tn_costs(sc, name)
        batched, sched = sc.schedule()
        n_apply = sum(op[0] == 'apply' and batched[v]
                      for v, _, _, op in sched)
        n_apply_fixed = sum(op[0] == 'apply' and not batched[v]
                            for v, _, _, op in sched)
        timed_slices(sc, (0, 1))                      # warm
        _, dt2, _ = timed_slices(sc, (1, 3))
        count = int(max(2, min(sc.nslices - 3, TN_SECONDS / (dt2 / 2))))
        steps['n'] = 0
        tk.reset_counts()
        amp, dt, peak = timed_slices(sc, (3, 3 + count))
        launches = tk.counts()
        # the slices that select no all-zero leaf row; the slice-invariant
        # steps once a call, the batched once a chunk of those
        done = sc.last_counts['contracted']
        nonzero = int(sc.nonzero_slices().sum())
        want_launches = n_apply_fixed + n_apply * -(-done // sc._chunk())
        per = dt / done
        emit({'phase': 'tn', 'part': 'workload', 'plan': TN_PLANS[0],
              'n_slices': sc.nslices, 'timed_slices': count,
              'contracted_slices': done, 'seconds': dt,
              's_per_slice': per, 'ms_per_slice': per * 1e3,
              'tflops': 8 * costs['macs_per_slice'] / per / 1e12,
              'fp32_peak_tflops': peaks(name)[1] / 1e12,
              'of_bound': costs['bound_ms'] / (per * 1e3),
              'peak_gib': peak, 'steps_run': steps['n'],
              'apply_steps_batched': n_apply,
              'apply_steps_fixed': n_apply_fixed, 'launches': launches,
              'launches_expected': want_launches,
              'nonzero_slices': nonzero, 'projected_full_s': per * nonzero,
              'log2_largest': float(np.log2(cost.max_size)),
              **costs, 'card': card}, out)
        check(np.isfinite(amp).all(), "tn: non-finite partial sum")
        check(launches == {'tn_apply': want_launches, 'tn_apply_plain': 0},
              f"tn: tn_apply launches {launches}, want {want_launches} "
              f"({n_apply_fixed} once a call + {n_apply} x "
              f"{-(-done // sc._chunk())} chunks) and no plain call")

        # Each tn_apply class of the plan at its widths, against the plain
        # version and timed beside torch.tensordot.
        gen = torch.Generator(device='cuda')
        gen.manual_seed(SEED)
        rows = {}
        for key, (n_steps_cls, (tstep, inplace)) in sorted(
                tn_apply_classes(sc).items()):
            r = tn_apply_case(tstep, inplace, name, gen)
            rows[key] = r
            emit({'phase': 'tn', 'part': 'tn_apply', 'plan': TN_PLANS[0],
                  'steps': n_steps_cls, **r, 'card': card}, out)
        r = rows[TN_APPLY_SUMMARY]
        src, replaces = KERNEL_INFO['tn_apply']
        summary.append({'name': 'tn_apply', 'route': 'cuda', 'source': src,
                        'replaces': replaces,
                        'launches': launches['tn_apply'],
                        'max_abs_err': max(x['max_abs_err']
                                           for x in rows.values()),
                        'ms': r['ms'], 'plain_ms': r['plain_ms'],
                        'bound_ms': r['bound_ms'], 'bound_by': r['bound_by'],
                        'library_ms': r['library_ms']})

        # Whole slices, the kernel route against the plain route, in turns.
        rng_t = (3, 3 + TN_TURN_SLICES)
        sums, ms = tn_turns(sc, rng_t)
        ref = float(np.abs(sums['plain']).max())
        d = float(np.abs(sums['kernel'] - sums['plain']).max()) / ref
        emit({'phase': 'tn', 'part': 'routes', 'plan': TN_PLANS[0],
              'slices': list(rng_t), 'ms_per_slice': ms,
              'kernel_ms_per_slice': float(np.mean(ms['kernel'])),
              'plain_ms_per_slice': float(np.mean(ms['plain'])),
              'bound_ms': costs['bound_ms'], 'kernel_vs_plain': d,
              'card': card}, out)
        check(d <= TOL, f"tn: the kernel and plain routes differ by {d:.3g}")

        emit({'phase': 'tn', 'part': 'profile', 'plan': TN_PLANS[0],
              'profile': tn_profile(sc, (3, 3 + TN_PROFILE_SLICES)),
              'card': card}, out)

        # Precision: two slices in complex64 and complex128, then
        # complex64 again with the global TF32 flags on.
        a64, _, _ = timed_slices(sc, (0, 2))
        sc128 = contract.SlicedContractor(plan, net.tensors, oo,
                                          complex_type='complex128')
        a128, _, _ = timed_slices(sc128, (0, 2))
        del sc128
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            a64_tf32, _, _ = timed_slices(sc, (0, 2))
            g = torch.Generator(device='cuda')
            g.manual_seed(SEED)
            x = torch.randn(4096, 4096, dtype=torch.complex64,
                            device='cuda', generator=g)
            m_tf32 = x @ x
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        m_ieee = x @ x
        m_ref = (x.to(torch.complex128) @ x.to(torch.complex128))
        scale = float(m_ref.abs().max())
        mm = {'tf32': float((m_tf32 - m_ref).abs().max()) / scale,
              'ieee': float((m_ieee - m_ref).abs().max()) / scale}
        del x, m_tf32, m_ieee, m_ref
        ref = float(np.abs(a128).max())
        rel64 = float(np.abs(a64 - a128).max()) / ref
        rel_tf32 = float(np.abs(a64_tf32 - a64).max()) / ref
        emit({'phase': 'tn', 'part': 'precision', 'plan': TN_PLANS[0],
              'slices': [0, 2], 'complex64_vs_complex128': rel64,
              'tf32_flags_on_change': rel_tf32,
              'matmul_4096_rel_err': mm, 'card': card}, out)
        check(rel_tf32 <= TN_TF32_TOL, f"tn: the global TF32 flags changed "
              f"the result by {rel_tf32:.3g}")
        del sc, net, tree, plan
        torch.cuda.empty_cache()

        # One slice of the depth-20 plan.
        net, oo, tree, sliced, cost = load_reference_plan(
            os.path.join(plans, TN_PLANS[1]))
        sc = contract.SlicedContractor(contract.ContractionPlan(tree, sliced),
                                       net.tensors, oo)
        costs = tn_costs(sc, name)
        timed_slices(sc, (0, 1))                      # warm
        tk.reset_counts()
        amp, dt, peak = timed_slices(sc, (1, 2))
        launches = tk.counts()
        # a call of three slices: what a slice adds beyond the call's own
        # work (leaf uploads, the slice-invariant steps)
        _, dt3, _ = timed_slices(sc, (1, 4))
        emit({'phase': 'tn', 'part': 'workload', 'plan': TN_PLANS[1],
              'launches': launches, 'marginal_ms_per_slice':
                  (dt3 - dt) / 2 * 1e3,
              'n_slices': sc.nslices, 'timed_slices': 1, 's_per_slice': dt,
              'ms_per_slice': dt * 1e3,
              'tflops': 8 * costs['macs_per_slice'] / dt / 1e12,
              'of_bound': costs['bound_ms'] / (dt * 1e3), 'peak_gib': peak,
              'projected_full_s': dt * sc.nslices,
              'log2_largest': float(np.log2(cost.max_size)),
              **costs, 'card': card}, out)
        check(np.isfinite(amp).all(), "tn: non-finite d20 slice")
        emit({'phase': 'tn', 'part': 'profile', 'plan': TN_PLANS[1],
              'profile': tn_profile(sc, (1, 2)), 'card': card}, out)
        del sc, net, tree
        torch.cuda.empty_cache()
    finally:
        contract._step = step
        contract.SlicedContractor.contract_np = contract_np
    emit({'phase': 'tn', 'ok': True, 'card': card}, out)
    return summary


# One turn of ``front_end`` in a fresh interpreter: argv is the checkout,
# the benchmark's directory and the seeds.  Prints the best of 3 seconds of
# ``simplify`` a seed, a digest of each output and the scan's counts.
_FRONT_END_TURN = r"""
import hashlib, json, sys, time
root, bench, seeds = sys.argv[1], sys.argv[2], sys.argv[3].split(',')
sys.path[:0] = [root, bench]
from hqbench import circuits
from hybridq_tpu_torch import Circuit, Gate
from hybridq_tpu_torch.circuit import utils
rows = []
for s in map(int, seeds):
    c = Circuit(Gate(name, qubits=list(q), params=list(p)) if p else
                Gate(name, qubits=list(q))
                for name, q, p in circuits.rqc(32, 14, [s, 1, 0]))
    times = []
    for _ in range(3):
        t = time.perf_counter()
        out = utils.simplify(c)
        times.append(time.perf_counter() - t)
    key = repr([(g.name, g.qubits, g.power, getattr(g, 'params', None),
                 g.is_conjugated(), g.is_transposed()) for g in out])
    rows.append({'seed': s, 'gates': len(c), 'out_gates': len(out),
                 's': min(times),
                 'digest': hashlib.sha1(key.encode()).hexdigest()})
counts = getattr(utils, 'counts', None)
if counts is not None:
    utils.reset_counts()
    utils.simplify(c)
print(json.dumps({'rows': rows, 'counts': counts() if counts else None}))
"""


# One turn of ``front_end``'s fill on the card: argv is the checkout and a
# scratch path for the profiler's trace.  Prints the fill's host and wall
# ms (3 calls), its device ms (one profiled call), ``prepare.counts()`` of
# that call (None where the checkout has no counter), the n = 32 zero
# state's count of nonzeros, its 1-norm and its first amplitude (reduced
# on the card, with no state-sized temporary), and a digest of a mixed
# container.
_FILL_TURN = r"""
import hashlib, json, os, sys, time
root, trace_path = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
import torch
from torch.profiler import ProfilerActivity, profile
from hybridq_tpu_torch.simulation import prepare
n, state = 32, '0' * 32
prepare.token_container('0' * 20, 20, 'cuda')
torch.cuda.synchronize()
host, wall = [], []
for _ in range(3):
    t = time.perf_counter()
    c = prepare.token_container(state, n, 'cuda')
    host.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    wall.append((time.perf_counter() - t) * 1e3)
    del c
counts = getattr(prepare, 'counts', None)
if counts is not None:
    prepare.reset_counts()
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    c = prepare.token_container(state, n, 'cuda')
    torch.cuda.synchronize()
fill_counts = counts() if counts is not None else None
zero = [float(torch.linalg.vector_norm(c, 0)),
        float(torch.linalg.vector_norm(c, 1)), float(c[0])]
del c
prof.export_chrome_trace(trace_path)
with open(trace_path) as f:
    events = json.load(f).get('traceEvents', [])
os.unlink(trace_path)
dev = [e for e in events
       if e.get('cat') in ('kernel', 'gpu_memcpy', 'gpu_memset')]
mixed = ('-+01+1-0' * 4)[:26]
m = prepare.token_container(mixed, 26, 'cuda').cpu().numpy()
print(json.dumps({'host_ms': host, 'wall_ms': wall,
                  'device_ms': sum(e['dur'] for e in dev) / 1e3,
                  'device_ops': len(dev), 'counts': fill_counts,
                  'zero_nonzeros_first': zero,
                  'mixed26_sha1': hashlib.sha1(m.tobytes()).hexdigest()}))
"""


def _fill_turns(roots, order):
    """``_FILL_TURN`` in each of ``roots`` in ``order``: the medians of
    each side's host and wall ms and its device ms, the change's counts,
    and whether every turn built the same containers."""
    import torch
    from hybridq_tpu_torch.simulation import _build

    if not torch.cuda.is_available():
        return {'fill': 'not measured (no card)'}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    trace = str(_build.BUILD_DIR / 'fill_trace.json')
    turns = {k: [] for k in roots}
    for side in order:
        r = subprocess.run([sys.executable, '-c', _FILL_TURN, roots[side],
                            trace], capture_output=True, text=True,
                           timeout=600)
        check(r.returncode == 0,
              f"front_end: fill turn in {roots[side]} failed: "
              f"{r.stderr[-2000:]}")
        turns[side].append(json.loads(r.stdout.strip().splitlines()[-1]))
    keys = {(t['mixed26_sha1'], tuple(t['zero_nonzeros_first']))
            for v in turns.values() for t in v}
    check(len(keys) == 1, f"front_end: the fills differ: {keys}")
    line = {'fill_counts': turns['change'][0]['counts'],
            'fill_same_container': True}
    for side, v in turns.items():
        pre = '' if side == 'change' else 'parent_'
        for key in ('host_ms', 'wall_ms'):
            line[f'{pre}fill_{key}'] = float(np.median(
                [x for t in v for x in t[key]]))
        line[f'{pre}fill_device_ms'] = [t['device_ms'] for t in v]
    return line


def phase_front_end(out, parent):
    here = os.path.dirname(os.path.abspath(__file__))
    bench = os.path.join(here, 'benchmark')
    seeds = ','.join(map(str, FRONT_END_SEEDS))

    def turn(root):
        r = subprocess.run([sys.executable, '-c', _FRONT_END_TURN, root,
                            bench, seeds], capture_output=True, text=True,
                           timeout=600)
        check(r.returncode == 0,
              f"front_end: turn in {root} failed: {r.stderr[-2000:]}")
        return json.loads(r.stdout.strip().splitlines()[-1])

    roots = {'change': here}
    order = ['change']
    if parent:
        check(os.path.isdir(os.path.join(parent, 'hybridq_tpu_torch')),
              f"front_end: no hybridq_tpu_torch/ under {parent}")
        roots['parent'] = os.path.abspath(parent)
        order = ['parent', 'change', 'change', 'parent']
    turns = {k: [] for k in roots}
    for side in order:
        turns[side].append(turn(roots[side]))
    best = {k: [min(t['rows'][i]['s'] for t in v)
                for i in range(len(FRONT_END_SEEDS))]
            for k, v in turns.items()}
    line = {'phase': 'front_end', 'n': 32, 'cycles': 14,
            'seeds': list(FRONT_END_SEEDS),
            'gates': [r['gates'] for r in turns['change'][0]['rows']],
            'out_gates': [r['out_gates']
                          for r in turns['change'][0]['rows']],
            'simplify_s': best['change'],
            'counts': turns['change'][0]['counts'],
            'host_cpus': os.cpu_count()}
    if parent:
        digests = {k: [[r['digest'] for r in t['rows']] for t in v]
                   for k, v in turns.items()}
        same = all(d == digests['change'][0] for v in digests.values()
                   for d in v)
        check(same, "front_end: the parent's and this checkout's "
                    "simplify differ")
        line.update({'parent_simplify_s': best['parent'],
                     'speedup': [p / c for p, c in
                                 zip(best['parent'], best['change'])],
                     'same_output': same})
    line.update(_fill_turns(roots, order))
    emit(line, out)
    return []


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--out', default=None,
                    help="also append the JSON lines to this file")
    ap.add_argument('--phases', default=','.join(PHASES),
                    help="comma-separated phases to run, in their fixed "
                         "order (default: all)")
    ap.add_argument('--parent', default=None,
                    help="front_end: an unpacked copy of another commit "
                         "to time in turns with this checkout")
    args = ap.parse_args(argv)
    phases = args.phases.split(',')
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}; known: {PHASES}")

    import torch

    on_card = [p for p in phases if p not in HOST_PHASES]
    if on_card and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, 'hybridq_tpu_torch', 'csrc')):
        print("chip_smoke: hybridq_tpu_torch/ not found beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0) if on_card else None

    out = open(args.out, 'a') if args.out else None
    runs = {'front_end': lambda: phase_front_end(out, args.parent),
            'build': lambda: phase_build(out),
            'kernels': lambda: phase_kernels(out, name),
            'parity': lambda: phase_parity(out),
            'paths': lambda: phase_paths(out, name),
            'probes': lambda: phase_probes(out, name),
            'main_path': lambda: phase_main_path(out, name),
            'dm': lambda: phase_dm(out),
            'trajectories': lambda: phase_trajectories(out),
            'clifford': lambda: phase_clifford(out),
            'cli': lambda: phase_cli(out),
            'sharded': lambda: phase_sharded(out, name),
            'tn': lambda: phase_tn(out, name)}
    try:
        summary = {}
        for phase in PHASES:
            if phase in phases:
                summary[phase] = runs[phase]() or []
        if not on_card:
            print(json.dumps({'ok': True, 'device': {
                'platform': 'host', 'count': 0}}), flush=True)
            return 0
        emit({'kernels': [k for phase in ('main_path', 'paths', 'probes',
                                          'tn')
                          for k in summary.get(phase, [])]}, out)
        print(card_power(), flush=True)
        # count: the one card the run used (device 0)
        print(json.dumps({'ok': True, 'device': {
            'platform': 'gpu', 'kind': name, 'count': 1}}), flush=True)
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == '__main__':
    sys.exit(main())
