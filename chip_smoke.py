#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``hybridq_tpu_torch``) on one GPU.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --out run.jsonl # also append the JSON lines

Phases, each printing one JSON line (a failing phase exits non-zero):

  build      compile ``hybridq_tpu_torch/csrc/*.cu`` from the checkout;
  kernels    at n = 28, hold every routing class of ``fused_apply`` and
             ``swap_apply``, and both kernels at gate sizes k = 1..8,
             against the plain PyTorch version (max|d|/rms <= 1e-5) and
             time kernel, plain version, bound and a ``torch.matmul`` of
             the same arithmetic; also time the row gather of a park and
             the host time of one step.  These are the costs that
             ``fused_evolver._step_cost`` prices a step with;
  parity     ``simulate(get_rqc(24, ...), optimize='evolution')`` on the
             card against a per-gate numpy oracle on the host, at 20 and
             40 random gates after an H layer: max|d| over the largest
             amplitude <= 3e-6 at both depths, max|d|/rms <= 1e-5 at 20
             (the roadmap's contract is 1e-6); both kernels must launch;
  paths      n = 30, the public functions of the other ported kernels at
             the bit sets the JAX package's callers use: ``apply_factored``
             (``probe_fused_perf.py``'s and ``probe_fused_check.py``'s
             cases and the largest the port takes; beside each with one or
             two lane bits, ``apply_swap`` on the product with the victims
             ``FusedEvolver`` picks), ``apply_gate_rows`` (``test_pallas.py``'s
             positions at L = 10, and n = 12) and ``apply_fused_k4`` (the
             main path's and ``probe_fused_k4.py``'s bits, beside
             ``apply_fused``).  Each path runs once with launch counts
             zeroed just before and read just after, and must keep the
             norm; then each case is held against its plain version
             (max|d|/rms <= 1e-5) and timed with its bound and one PyTorch
             call of the same function;
  main_path  n = 30 (8 GiB of state), the workload of ``bench.py``: 24
             random 4-qubit unitaries avoiding bits 0-2.  First through
             ``simulate(..., optimize='evolution')``, with launch counts
             zeroed just before and read just after; then bench-style
             timed passes through ``FusedEvolver`` with amplitudes read
             through the slot map (no flush, no gather), paired by
             ``pair_fused_gates`` and unpaired; the paired pass may take
             at most 1.1x the unpaired one.  Each kernel is then replayed
             at the most frequent gate size the main path gave it and
             held against its plain version.
  probes     the card's counterparts of the bandwidth and dot probes
             (``scripts/probe_pallas_bw.py``, ``probe_pallas_gather.py``)
             at the scripts' 2 GiB of f32: first ``probes.bw.main()`` and
             ``probes.gather.main()``, the entry points a user runs, with
             launch counts zeroed just before and read just after (every
             kernel must launch); then every variant of both tables held
             against its plain version (``2 * x``, or ``x`` rounded to bf16
             for the matmul variant: max|d| must be 0) and timed beside
             its bound, its plain version and one PyTorch call, kernel
             and library writing the same tensor (``torch.mul(x, 2,
             out=y)`` beside ``scale(x, ..., out=y)``, ``y.mul_(2)`` in
             place); and the TF32 and 3xTF32 dots on the scripts' inputs
             against float64 (rel-err in [1e-5, 1e-2] for one TF32 pass:
             f32 accuracy there would mean no tensor cores; <= 1e-5 for
             3xTF32), beside ``torch.matmul``.  Runs after ``paths``.

Then the ``{"kernels": [...]}`` summary, the card's ``name, power.limit``
and, as the last line, ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or without the package beside this script, it exits non-zero and
prints no result.
"""

import argparse
import json
import os
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
TOL = 1e-5                 # max|d|/rms, kernel against plain (f32 sums)
# max|d| / max|amp| of simulate against the complex128 oracle: f32
# evolution gives 6e-7 to 8e-7 at these depths on the card and on the CPU.
PARITY_TOL = 3e-6
PAIRED_SLACK = 1.1         # paired pass time over unpaired, at most
NORM_TOL = 1e-4
# Published peaks (NVIDIA data sheets, dense): bytes/s, fp32 FLOP/s outside
# the tensor cores, TF32 FLOP/s on the tensor cores.
_PEAKS = {'H100 PCIe': (2.0e12, 51.2e12, 378e12),
          'H200': (4.8e12, 67e12, 495e12),
          'H100': (3.35e12, 67e12, 495e12)}
# wrapper -> (source in the repo, the TPU kernel it replaces)
KERNEL_INFO = {
    'fused_apply': ('hybridq_tpu_torch/csrc/fused_apply.cu',
                    'hybridq_tpu/simulation/pallas_fused.py:175'),
    'swap_apply': ('hybridq_tpu_torch/csrc/fused_apply.cu',
                   'hybridq_tpu/simulation/pallas_fused.py:446'),
    'apply_gate_rows': ('hybridq_tpu_torch/csrc/fused_apply.cu',
                        'hybridq_tpu/simulation/pallas_kernels.py:201'),
    'factored_apply': ('hybridq_tpu_torch/csrc/factored_apply.cu',
                       'hybridq_tpu/simulation/pallas_fused.py:633'),
    'fused_k4_apply': ('hybridq_tpu_torch/csrc/fused_k4.cu',
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
}


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
    """``fused_apply`` or ``swap_apply`` against its plain version on
    one random unit-norm state, timed beside its bound and a
    ``torch.matmul`` of the same arithmetic."""
    import torch
    from hybridq_tpu_torch.simulation import fused_kernels as fk

    Ud = torch.as_tensor(U, device='cuda')
    if kind == 'fused':
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
    from hybridq_tpu_torch.simulation.fused_evolver import FusedEvolver

    ev = FusedEvolver(N_STEP, device='cuda')
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
    for src in ('fused_apply', 'factored_apply', 'fused_k4', 'stream_scale',
                'dot_probe', 'gather_runs'):
        check(src in libs, f"{src} was not built")
    nvcc = subprocess.run([_build.nvcc_path(), '--version'],
                          capture_output=True, text=True).stdout
    ptxas = [ln.strip() for log in _build.LOGS.values()
             for ln in log.splitlines() if 'Used' in ln or 'spill' in ln]
    emit({'phase': 'build', 'ok': True, 'seconds': dt,
          'torch': torch.__version__, 'torch_cuda': torch.version.cuda,
          'nvcc': nvcc.strip().splitlines()[-1],
          'card': card_power(), 'ptxas': ptxas}, out)


def phase_kernels(out, name):
    import torch
    from hybridq_tpu_torch.simulation.fused_evolver import FusedEvolver

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
    # park by row gather (inplace=False): the cost of a ('park',) step
    ev = FusedEvolver(n, device='cuda', inplace=False)
    st = ev.prepare_state('0' * n)
    perm = list(range(n))
    perm[n - 1], perm[8] = 8, n - 1

    def gather_rows():
        nonlocal st
        ev.phys, ev.logi = list(range(n)), list(range(n))
        st = ev._row_permute(st, perm)
    park_ms = time_ms(gather_rows, REPS)
    del st
    torch.cuda.empty_cache()
    emit({'phase': 'kernels', 'ok': True, 'n': n, 'card': card_power(),
          'step_costs': {
              'fused': {r['k']: round(r['ms'], 3) for r in rows
                        if r['kind'] == 'fused_k'},
              'swap': {f"{r['k']},{r['cls'][1]}": round(r['ms'], 3)
                       for r in rows if r['kind'] == 'swap'},
              'park': round(park_ms, 3),
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


def phase_parity(out):
    import torch
    from hybridq_tpu_torch import Circuit, Gate
    from hybridq_tpu_torch.extras.random import get_rqc
    from hybridq_tpu_torch.simulation import fused_kernels as fk
    from hybridq_tpu_torch.simulation import simulate

    n = N_PARITY
    for depth in PARITY_GATES:
        np.random.seed(SEED)
        c = Circuit([Gate('H', qubits=[q]) for q in range(n)]) + \
            get_rqc(n, depth, indexes=list(range(n)))
        fk.reset_counts()
        t0 = time.perf_counter()
        psi = simulate(c, initial_state='0', optimize='evolution')
        dt = time.perf_counter() - t0
        launches = fk.counts()
        want = numpy_oracle(c, sorted(c.all_qubits))
        d = np.abs(psi.astype(np.complex128) - want).max()
        rms = np.sqrt(np.mean(np.abs(want) ** 2))
        amax = np.abs(want).max()
        emit({'phase': 'parity', 'n': n, 'gates': len(c),
              'max_abs_err': float(d), 'rel_err': float(d / rms),
              'err_over_max_amp': float(d / amax),
              'max_amp_over_rms': float(amax / rms),
              'contract': 1e-6, 'within_contract': bool(d / rms <= 1e-6),
              'seconds': dt, 'launches': launches}, out)
        check(launches['fused_apply'] > 0 and launches['swap_apply'] > 0,
              f"parity: a kernel was not launched: {launches}")
        check(launches['apply_fused_plain'] == 0 and
              launches['apply_swap_plain'] == 0,
              f"parity: a plain version ran: {launches}")
        check(d / amax <= PARITY_TOL, f"parity ({depth} gates): max|d| / "
              f"max|amp| {d / amax:.3g} > {PARITY_TOL}")
        if depth == PARITY_GATES[0]:
            check(d / rms <= TOL, f"parity ({depth} gates): max|d|/rms "
                  f"{d / rms:.3g} > {TOL}")
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
    from hybridq_tpu_torch.simulation.fused_evolver import FusedEvolver

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
    ev = FusedEvolver(n, device='cuda')
    for row_bits, lane_bits, Ur, Ul in fact:
        kr, kl = len(row_bits), len(lane_bits)
        r = hold(container,
                 lambda s: fk.apply_factored(s, Ur, row_bits, Ul, lane_bits),
                 lambda s: fk.apply_factored_plain(s, Ur, row_bits, Ul,
                                                   lane_bits), rms)
        flops = 8 * 2 ** n * (2 ** kl + (2 ** kr if kr else 0))
        r['bound_ms'], r['bound_by'] = bound(n, kr + kl, name, flops)
        # U_row (x) U_lane on the state viewed with the gate bits
        # outermost, as one einsum (operands in the order that contracts
        # U_lane first: U_row x U_lane alone would be 2^(2(kr+kl)) wide)
        r['library_ms'] = library_ms(
            lambda ul, psi, ur: torch.einsum('cd,bdr,ab->acr', ul, psi, ur),
            (2 ** kl, 2 ** kl), (2 ** kr, 2 ** kl, 2 ** (n - kr - kl)),
            (2 ** kr, 2 ** kr))
        if kl <= 2:
            # the swap route of the same gate, as FusedEvolver takes it
            bits = list(row_bits) + list(lane_bits)
            victims = ev._victims(kl, set(bits))
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
    kernel, plain version and ``library`` timed on the same input."""
    import torch

    want = plain(x)
    got = kern(x)
    torch.cuda.synchronize()
    d = (got - want).abs_().max().item()
    del got, want
    r = {'max_abs_err': d, 'ms': time_ms(kern_ms, PROBE_REPS),
         'plain_ms': time_ms(lambda: plain(x), PROBE_REPS),
         'library_ms': time_ms(library, PROBE_REPS)}
    torch.cuda.empty_cache()
    return r


def phase_probes(out, name):
    """See the module docstring; returns the summary entries of the six
    probe kernels."""
    import torch
    from hybridq_tpu_torch.probes import bw, gather

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
    del x, y
    torch.cuda.empty_cache()

    # rows 9 and 11: the 128^3 dot against float64, on the script's inputs
    a, b = bw.dot_inputs()
    ad, bd = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    n = bw.DOT_N
    t_ops = 2 * n ** 3 / peak_tf32 * 1e3
    t_bytes = 3 * n * n * 4 / peak_bw * 1e3
    dot_bound = (max(t_ops, t_bytes),
                 'bytes' if t_bytes >= t_ops else 'operations')
    bands = {'tf32': (1e-5, 1e-2), '3xtf32': (0.0, 1e-5)}
    dot_reps = 100
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
             'ms': time_ms(lambda: bw.dot(ad, bd, prec), dot_reps),
             'plain_ms': time_ms(lambda: bw.dot_plain(ad, bd), dot_reps),
             'library_ms': time_ms(
                 lambda: bw.library_matmul(ad, bd, tf32=prec == 'tf32'),
                 dot_reps)}
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


def phase_main_path(out, name):
    import torch
    from hybridq_tpu_torch import Gate
    from hybridq_tpu_torch.convert import circuit_from_matrices
    from hybridq_tpu_torch.simulation import fused_evolver as fe
    from hybridq_tpu_torch.simulation import fused_kernels as fk
    from hybridq_tpu_torch.simulation import simulate

    n = N_MAIN
    rng = np.random.default_rng(SEED)
    gates = bench_workload(n, 4, MAIN_GATES, rng)
    idx = np.random.default_rng(SEED + 1).choice(2 ** n, 16, replace=False)

    # (a) the user's entry point; the gates avoid the last 3 qubits, so
    # identities keep all n of them in the register.
    circuit = circuit_from_matrices(gates) + \
        [Gate('I', qubits=[q]) for q in range(n)]
    torch.cuda.reset_peak_memory_stats()
    fk.reset_counts()
    t0 = time.perf_counter()
    psi = simulate(circuit, initial_state='0' * n, optimize='evolution',
                   remove_id_gates=False, return_numpy_array=False)
    torch.cuda.synchronize()
    t_sim = time.perf_counter() - t0
    launches = fk.counts()
    peak_sim = torch.cuda.max_memory_allocated()
    check(tuple(psi.shape) == (2,) * n and psi.dtype == torch.complex64,
          f"main_path: simulate returned {psi.dtype} {tuple(psi.shape)}")
    flat = psi.reshape(-1)
    norm = torch.linalg.vector_norm(flat).item()
    amps_sim = {int(i): complex(flat[int(i)].item()) for i in idx}
    del psi, flat
    torch.cuda.empty_cache()
    check(abs(norm - 1) <= NORM_TOL, f"main_path: simulate norm {norm}")
    check(launches['fused_apply'] > 0 and launches['swap_apply'] > 0,
          f"main_path: a kernel was not launched: {launches}")
    check(launches['apply_fused_plain'] == 0 and
          launches['apply_swap_plain'] == 0,
          f"main_path: a plain version ran: {launches}")

    # (b) bench-style passes through FusedEvolver, never flushing
    ev = fe.FusedEvolver(n, device='cuda')
    blocks = fe.pair_fused_gates(gates, n, fe.MapSim.of(ev))

    def no_flush(*_):
        raise PhaseError("main_path: flush/gather called at n=30")
    ev.flush = no_flush
    calls = []

    def recorder(kind, fn):
        def wrapped(state, U, *rest):
            calls.append((kind, U, [list(r) for r in rest]))
            return fn(state, U, *rest)
        return wrapped
    orig = fe.apply_fused, fe.apply_swap
    fe.apply_fused = recorder('fused', fk.apply_fused)
    fe.apply_swap = recorder('swap', fk.apply_swap)

    def run_pass(state, items=blocks, tag='blk'):
        for i, (U, qs) in enumerate(items):
            state = ev.apply_gate(state, np.asarray(U), tuple(qs),
                                  gate_key=(tag, i))
        return state

    def timed_passes(state, items, tag):
        """Warm passes until the slot map repeats at a pass boundary
        (every operand is then uploaded), then timed passes."""
        seen = {tuple(ev.phys)}
        warm = 0
        for warm in range(1, 13):
            state = run_pass(state, items, tag)
            if tuple(ev.phys) in seen:
                break
            seen.add(tuple(ev.phys))
        torch.cuda.synchronize()
        fk.reset_counts()
        t0 = time.perf_counter()
        for _ in range(REPS):
            state = run_pass(state, items, tag)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / REPS
        return state, dt, warm, {k: v / REPS
                                 for k, v in fk.counts().items()}

    torch.cuda.reset_peak_memory_stats()
    try:
        state = ev.prepare_state('0' * n)
        state = run_pass(state)
    finally:
        fe.apply_fused, fe.apply_swap = orig
    d_amp = max(abs(ev.amplitude(state, int(i)) - amps_sim[int(i)])
                for i in idx)
    check(d_amp <= 1e-6, f"main_path: evolver and simulate disagree "
          f"({d_amp:.3g})")
    state, dt, warm, pass_launches = timed_passes(state, blocks, 'blk')
    # the same gates unpaired, one kernel class per 4-qubit gate
    state, dt_single, _, _ = timed_passes(state, gates, 'gate')
    peak_ev = torch.cuda.max_memory_allocated()
    norm_ev = torch.linalg.vector_norm(state).item()
    del state
    torch.cuda.empty_cache()
    check(abs(norm_ev - 1) <= NORM_TOL, f"main_path: norm {norm_ev}")
    emit({'phase': 'main_path', 'n': n, 'gates': len(gates),
          'blocks': len(blocks),
          'block_sizes': sorted(len(q) for _, q in blocks),
          'simulate_s': t_sim, 'simulate_norm': norm,
          'simulate_peak_gib': peak_sim / 2 ** 30,
          'launches': launches, 'warm_passes': warm,
          'pass_s': dt, 'gates_per_s': len(gates) / dt,
          'launches_per_pass': pass_launches,
          'unpaired_pass_s': dt_single,
          'unpaired_gates_per_s': len(gates) / dt_single,
          'evolver_norm': norm_ev, 'evolver_peak_gib': peak_ev / 2 ** 30,
          'amp_diff_vs_simulate': d_amp, 'card': card_power()}, out)
    check(dt <= PAIRED_SLACK * dt_single,
          f"main_path: the paired pass ({dt:.4f} s) is slower than the "
          f"unpaired one ({dt_single:.4f} s)")

    # replay each kernel at the main path's most frequent gate size
    gen = torch.Generator(device='cuda')
    gen.manual_seed(SEED)
    summary = []
    for kind, kname in (('fused', 'fused_apply'), ('swap', 'swap_apply')):
        mine = [c for c in calls if c[0] == kind]
        sizes = [len(c[2][0]) for c in mine]
        k = max(set(sizes), key=sizes.count)
        _, U, rest = next(c for c in mine if len(c[2][0]) == k)
        bits, victims = rest[0], (rest[1] if kind == 'swap' else [])
        r = compare_kernel(n, kind, U.cpu().numpy(), bits, victims, gen,
                           name, REPS)
        emit({'phase': 'main_path_kernel', 'name': kname, 'n': n,
              'k': k, 'bits': bits, 'victims': victims, **r}, out)
        check(r['rel_err'] <= TOL, f"{kname} at n={n}: max|d|/rms "
              f"{r['rel_err']:.3g} > {TOL}")
        src, replaces = KERNEL_INFO[kname]
        summary.append({'name': kname, 'route': 'cuda', 'source': src,
                        'replaces': replaces,
                        'launches': launches[kname],
                        'max_abs_err': r['max_abs_err'], 'ms': r['ms'],
                        'plain_ms': r['plain_ms'],
                        'bound_ms': r['bound_ms'],
                        'bound_by': r['bound_by'],
                        'library_ms': r['library_ms']})
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--out', default=None,
                    help="also append the JSON lines to this file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
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
    name = torch.cuda.get_device_name(0)

    out = open(args.out, 'a') if args.out else None
    try:
        phase_build(out)
        phase_kernels(out, name)
        phase_parity(out)
        paths = phase_paths(out, name)
        probes = phase_probes(out, name)
        emit({'kernels': phase_main_path(out, name) + paths + probes}, out)
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
