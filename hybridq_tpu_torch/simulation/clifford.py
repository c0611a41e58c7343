"""Clifford / Pauli-string expansion engine.

The counterpart of ``hybridq_tpu/simulation/clifford.py``.  It evolves an
operator P through a circuit C as a sum of Pauli strings,
``C^dagger P C = sum_s phase_s P_s`` (the reference
``hybridq/circuit/simulation/clifford.py``'s ``update_pauli_string``:
``matrix(circuit + pauli + circuit.inv())`` equals the weighted sum).

The branch frontier is a batch: Pauli strings are rows of a ``uint8``
code array (0=I, 1=X, 2=Y, 3=Z) beside their real phases, and each gate
block expands the whole batch by its Pauli-transfer rows.  Batches above
``max_breadth_first_branches`` split in two and go depth first.  Two
backends run the same algorithm:

- ``backend='torch'`` (the default, on ``device``; ``None`` means
  ``'cuda'``): the frontier stays on the device across gates.  The
  expansion, the ``branch_atol`` compaction and the merge of equal strings
  (``torch.unique(dim=0)`` and ``index_add_``) all run there; only the
  merged strings of a finished batch go to the host, into the result.
  This replaces JAX's ``_jax_expand_kernel``, whose compaction and merge
  run on the host between gates.
- ``backend='numpy'``: the host copy of JAX's numpy backend, with
  ``parallel`` worker processes.

Across the processes of a ``torch.distributed`` group (``parallel``),
``use_mpi`` splits the branch frontier as JAX's does: every process runs
the same breadth-first expansion until the frontier is wide enough, takes
its share, and the partial dicts merge with one all-gather
(``_distributed_merge``), after which every process holds the same dict.
"""

from __future__ import annotations

from collections import defaultdict
from itertools import product

import numpy as np
import torch

from hybridq_tpu_torch.circuit import Circuit, utils
from hybridq_tpu_torch.gate import Gate
from hybridq_tpu_torch.utils import kron, sort

__all__ = ['update_pauli_string', 'expectation_value']

_PAULI_NAMES = 'IXYZ'
_PAULIS = [Gate(g).matrix().astype('complex128') for g in _PAULI_NAMES]
_PAULI_BYTES = np.frombuffer(b'IXYZ', dtype=np.uint8)
_PAULI_BASIS_CACHE: dict = {}
_BACKENDS = ('torch', 'numpy')


def _pauli_basis(k: int) -> np.ndarray:
    """Stacked k-qubit Pauli basis [4^k, 2^k, 2^k] (cached)."""
    out = _PAULI_BASIS_CACHE.get(k)
    if out is None:
        out = np.stack([kron(*(_PAULIS[int(c)] for c in digits))
                        for digits in product(range(4), repeat=k)])
        _PAULI_BASIS_CACHE[k] = out
    return out


def _string_keys(codes: np.ndarray):
    """Pauli-string keys of a [B, n] uint8 code batch."""
    chars = _PAULI_BYTES[codes]
    return [row.tobytes().decode('ascii') for row in chars]


def _pauli_rows(U: np.ndarray, eps: float):
    """Sparse Pauli-transfer rows of a k-qubit gate.

    ``rows[s] = (codes_t, coeffs)`` with
    ``U^dagger P_s U = sum_t coeffs[t] P_t`` (reference ``_process_gate``,
    ``clifford.py:491-546``).  Coefficients are real for unitary gates;
    entries below ``eps`` are dropped (the branching cutoff).
    """
    dim = U.shape[0]
    k = int(round(np.log2(dim)))
    paulis = _pauli_basis(k)
    Ud = U.conj().T
    # M[s] = U^dagger P_s U, coeffs[s, t] = Re tr(P_t M_s) / dim
    M = np.einsum('ij,sjk,kl->sil', Ud, paulis, U, optimize=True)
    coeffs_all = np.real(np.einsum('tij,sji->st', paulis, M,
                                   optimize=True)) / dim
    rows = []
    for s in range(4**k):
        coeffs = coeffs_all[s]
        sel = np.abs(coeffs) > eps
        ts = np.nonzero(sel)[0].astype(np.int64)
        # Largest-weight first: deeper branches die sooner under
        # branch_atol (reference explores largest first).
        order = np.argsort(-np.abs(coeffs[sel]))
        rows.append((ts[order], coeffs[sel][order]))
    return rows, k


def _digits(vals, k):
    """4-ary digits of vals, most significant first: [len(vals), k]."""
    out = np.empty((len(vals), k), dtype=np.uint8)
    for j in range(k):
        out[:, k - 1 - j] = (vals >> (2 * j)) & 3
    return out


# -- the numpy backend ---------------------------------------------------

def _apply_gate_batch(codes, phases, gate, branch_atol):
    """Apply one gate's Pauli-transfer ``gate = (qs, rows, k)`` to the
    whole branch batch on the host."""
    qs, rows, k = gate
    # Local substring code: qs[0] is the most significant digit.
    local = np.zeros(len(codes), dtype=np.int64)
    for q in qs:
        local = (local << 2) | codes[:, q]

    out_codes = []
    out_phases = []
    for s in np.unique(local):
        mask = local == s
        ts, cs = rows[s]
        if len(ts) == 0:
            continue
        nb = int(mask.sum())
        nt = len(ts)
        rep = np.repeat(codes[mask], nt, axis=0)
        tdig = _digits(ts, k)
        for j, q in enumerate(qs):
            rep[:, q] = np.tile(tdig[:, j], nb)
        ph = (phases[mask][:, None] * cs[None, :]).ravel()
        out_codes.append(rep)
        out_phases.append(ph)

    if not out_codes:
        return codes[:0], phases[:0]
    codes = np.concatenate(out_codes)
    phases = np.concatenate(out_phases)
    if branch_atol:
        sel = np.abs(phases) > branch_atol
        if not sel.all():
            codes, phases = codes[sel], phases[sel]
    return codes, phases


def _merge_batch(codes, phases):
    """Sum phases of identical strings (linearity of the evolution)."""
    if len(codes) < 2:
        return codes, phases
    uniq, inv = np.unique(codes, axis=0, return_inverse=True)
    summed = np.zeros(len(uniq), dtype=phases.dtype)
    np.add.at(summed, inv.reshape(-1), phases)
    return uniq, summed


# -- the torch backend ---------------------------------------------------

def _torch_gate(gate, float_dtype, device):
    """Dense (padded) Pauli-transfer tables of ``gate = (qs, rows, k)`` on
    ``device``: ``(qs, qs tensor, ts_tab [4^k, nt] target codes, cs_tab
    [4^k, nt] coefficients (0 pads), digit weights 4^(k-1..0))``."""
    qs, rows, k = gate
    nt = max((len(ts) for ts, _ in rows), default=1) or 1
    ts_tab = np.zeros((4**k, nt), dtype=np.int64)
    cs_tab = np.zeros((4**k, nt), dtype=np.float64)
    for s, (ts, cs) in enumerate(rows):
        ts_tab[s, :len(ts)] = ts
        cs_tab[s, :len(cs)] = cs
    return (qs, torch.as_tensor(qs, dtype=torch.int64, device=device),
            torch.as_tensor(ts_tab, device=device),
            torch.as_tensor(cs_tab, dtype=float_dtype, device=device),
            4 ** torch.arange(k - 1, -1, -1, dtype=torch.int64,
                              device=device))


def _apply_gate_batch_torch(codes, phases, gate, branch_atol):
    """The torch counterpart of ``_apply_gate_batch`` (JAX's
    ``_jax_expand_kernel`` with its host compaction): every row expands
    by its local substring's row of the tables, and only the branches
    whose phase passes ``branch_atol`` are written out, in (row, term)
    order."""
    qs, qs_t, ts_tab, cs_tab, weights = gate
    k = len(qs)
    local = (codes[:, qs_t].to(torch.int64) * weights).sum(dim=1)
    new = phases[:, None] * cs_tab[local]                   # [B, nt]
    b, t = torch.nonzero(new.abs() > (branch_atol or 0.0), as_tuple=True)
    ts = ts_tab[local[b], t]                                # int64 codes
    out = codes[b]
    for j, q in enumerate(qs):
        out[:, q] = ((ts >> (2 * (k - 1 - j))) & 3).to(torch.uint8)
    return out, new[b, t]


def _merge_batch_torch(codes, phases):
    """``_merge_batch`` on the device: ``torch.unique`` of the rows and
    ``index_add_`` of their phases."""
    if len(codes) < 2:
        return codes, phases
    uniq, inv = torch.unique(codes, dim=0, return_inverse=True)
    summed = torch.zeros(len(uniq), dtype=phases.dtype,
                         device=phases.device)
    return uniq, summed.index_add_(0, inv, phases)


# -- the depth-first driver ----------------------------------------------

def _memory_percent() -> float:
    """The share of the host's memory in use, in percent, as
    ``psutil.virtual_memory().percent`` gives it (read from
    ``/proc/meminfo`` where psutil is not installed)."""
    try:
        import psutil
    except ImportError:
        info = {}
        with open('/proc/meminfo') as f:
            for line in f:
                key, val = line.split(':', 1)
                info[key] = int(val.split()[0])
        return 100.0 * (1 - info['MemAvailable'] / info['MemTotal'])
    return psutil.virtual_memory().percent


def _check_memory(max_virtual_memory):
    """Abort when system virtual memory use crosses the threshold
    (reference ``clifford.py:719-722``)."""
    if max_virtual_memory is None:
        return
    pct = _memory_percent()
    if pct > max_virtual_memory:
        raise MemoryError(
            f"Memory above threshold: {pct}% > {max_virtual_memory}%")


def _add_strings(db, codes, phases):
    """Add a merged batch's strings into the result dict ``db``."""
    if isinstance(codes, torch.Tensor):
        codes, phases = codes.cpu().numpy(), phases.cpu().numpy()
    for key, ph in zip(_string_keys(codes), phases):
        db[key] += float(ph)


def _dfs(gates, gi0, codes, phases, apply, merge, db, info, branch_atol,
         max_batch, merge_every, max_virtual_memory):
    """Evolve the batch from gate ``gi0`` depth first, batches above
    ``max_batch`` split in two, a merge every ``merge_every`` gates; each
    finished batch's strings are merged and added into ``db``, and
    ``info``'s counts updated."""
    stack = [(gi0, codes, phases)]
    while stack:
        gi, codes, phases = stack.pop()
        while gi < len(gates) and len(codes):
            codes, phases = apply(codes, phases, gates[gi], branch_atol)
            gi += 1
            if merge_every and gi % merge_every == 0:
                codes, phases = merge(codes, phases)
            info['largest_batch'] = max(info['largest_batch'], len(codes))
            _check_memory(max_virtual_memory)
            if len(codes) > max_batch:
                half = len(codes) // 2
                stack.append((gi, codes[half:], phases[half:]))
                codes, phases = codes[:half], phases[:half]
        if not len(codes):
            continue
        info['n_explored_branches'] += len(codes)
        # No atol cut here: batch contributions to the same string must
        # sum before the caller's final filter.
        _add_strings(db, *merge(codes, phases))


_WORKER_GATES = None


def _init_worker(gates):
    """Pool initializer: ship the preprocessed gate tables once per
    worker instead of once per task."""
    global _WORKER_GATES
    _WORKER_GATES = gates


def _dfs_chunk(args):
    """Worker: the numpy backend's depth-first evolution of one branch
    chunk; returns ``(dict, n_explored, largest_batch)``.  Top-level for
    pickling (reference Pool DFS, ``clifford.py:587-729``)."""
    gi0, codes, phases, branch_atol, max_batch, merge_every, max_vm = args
    db = defaultdict(float)
    info = {'n_explored_branches': 0, 'largest_batch': len(codes)}
    _dfs(_WORKER_GATES, gi0, codes, phases, _apply_gate_batch,
         _merge_batch, db, info, branch_atol, max_batch, merge_every,
         max_vm)
    return dict(db), info['n_explored_branches'], info['largest_batch']


def _pool_dfs(gates, gi0, codes, phases, n_workers, db, info, branch_atol,
              max_batch, merge_every, max_vm):
    """The numpy backend over ``n_workers`` processes: breadth first
    until the frontier is wide enough to split, then the chunks depth
    first in a pool, their dicts merged (reference
    ``clifford.py:549-729, 1227-1386``).  The workers start from a fresh
    interpreter (``spawn``) and run numpy only, so that a caller that
    holds a CUDA context can use them."""
    import multiprocessing as mp

    gi = gi0
    while gi < len(gates) and len(codes) and len(codes) < 4 * n_workers:
        codes, phases = _apply_gate_batch(codes, phases, gates[gi],
                                          branch_atol)
        gi += 1
        codes, phases = _merge_batch(codes, phases)
        info['largest_batch'] = max(info['largest_batch'], len(codes))
    if gi >= len(gates) or not len(codes):
        info['n_explored_branches'] += len(codes)
        _add_strings(db, *_merge_batch(codes, phases))
        return
    idx = np.array_split(np.arange(len(codes)),
                         max(1, min(4 * n_workers, len(codes))))
    tasks = [(gi, codes[ix], phases[ix], branch_atol, max_batch,
              merge_every, max_vm) for ix in idx if len(ix)]
    with mp.get_context('spawn').Pool(
            n_workers, initializer=_init_worker,
            initargs=(gates,)) as pool:
        for part, n_exp, largest in pool.imap_unordered(_dfs_chunk, tasks):
            for key, val in part.items():
                db[key] += val
            info['n_explored_branches'] += n_exp
            info['largest_batch'] = max(info['largest_batch'], largest)


def _distributed_merge(db, n):
    """Sum the partial dicts of the group's processes (JAX's
    ``_distributed_merge``): each process encodes its strings as padded
    (codes, phases) arrays, one ``all_gather`` over the group's backend
    (CUDA tensors under NCCL, CPU tensors under gloo) replicates them,
    and every process returns the same merged dict.  Without a group
    (``use_mpi=True`` on one process) the dict is returned as it is."""
    import torch.distributed as dist

    from hybridq_tpu_torch.parallel import _group
    from hybridq_tpu_torch.parallel.mesh import _collective_device

    if not _group():
        return db
    cdev = _collective_device()
    world = dist.get_world_size()

    def all_gather(x):
        x = torch.as_tensor(x, device=cdev)
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        return torch.stack(parts).cpu().numpy()

    keys = sorted(db)
    sizes = all_gather(np.asarray([len(keys)], np.int64)).reshape(-1)
    m = max(int(sizes.max()), 1)
    codes = np.zeros((m, n), np.int32)
    for i, key in enumerate(keys):
        codes[i] = [_PAULI_NAMES.index(c) for c in key]
    phases = np.zeros((m,), np.float64)
    phases[:len(keys)] = [db[key] for key in keys]
    all_codes, all_phases = all_gather(codes), all_gather(phases)
    out = defaultdict(float)
    for p in range(world):
        cnt = int(sizes[p])
        for key, ph in zip(_string_keys(all_codes[p][:cnt].astype(np.uint8)),
                           all_phases[p][:cnt]):
            out[key] += float(ph)
    return out


def update_pauli_string(circuit, pauli_string, phase: float = 1,
                        parallel=False, return_info: bool = False,
                        use_mpi=None, compress: int = 4,
                        simplify: bool = True,
                        remove_id_gates: bool = True,
                        float_type='float32', verbose: bool = False,
                        backend: str = 'torch', device=None, **kwargs):
    """Expand ``C^dagger P C`` in Pauli strings.

    Returns a dict mapping Pauli strings (over the sorted circuit qubits)
    to real amplitudes; with ``return_info=True`` also an info dict.

    ``backend='torch'`` (default) runs on ``device`` (``None`` means
    ``'cuda'``, which raises without a card; ``device='cpu'`` runs the
    same backend on the host) in ``float_type``; ``backend='numpy'`` runs
    JAX's host backend.  ``parallel`` (numpy backend only, ignored by
    'torch' as JAX's 'jax' backend ignores it): False/1 = one process,
    True = all cores, int = that many worker processes.  ``use_mpi``:
    None splits the branches across the processes of an initialized
    group (``parallel.initialize``), True always (one process without a
    group), False never.

    ``max_virtual_memory`` (default 80): abort with ``MemoryError``
    when the host's memory use exceeds this percentage (reference
    ``clifford.py:719-722``).
    """
    if backend == 'jax':
        raise ValueError("backend='jax' is the JAX package's; the port's "
                         "device backend is backend='torch'")
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, "
                         f"got {backend!r}")
    if backend == 'torch':
        from hybridq_tpu_torch.simulation._device import resolve_device

        device = resolve_device(device, 'update_pauli_string()')

    float_type = np.dtype(float_type)
    kwargs.setdefault('eps',
                      1e-7 if float_type == np.dtype('float32') else 1e-8)
    kwargs.setdefault('atol',
                      1e-8 if float_type == np.dtype('float32') else 1e-12)
    kwargs.setdefault('branch_atol', kwargs['atol'])
    kwargs.setdefault('max_breadth_first_branches', 2**18)
    kwargs.setdefault('merge_interval', 4)
    kwargs.setdefault('max_virtual_memory', 80)

    circuit = utils.flatten(Circuit(circuit))
    if remove_id_gates:
        circuit = Circuit(g for g in circuit if g.name != 'I')

    # A plain token string means a single Pauli string with unit phase.
    if isinstance(pauli_string, str):
        pauli_string = {pauli_string: 1.0}

    # Determine qubits (circuit plus Pauli support).
    if isinstance(pauli_string, dict):
        pauli_qubits = []
    else:
        pauli_string = Circuit(pauli_string)
        pauli_qubits = pauli_string.all_qubits
    qubits = sort(set(circuit.all_qubits) | set(pauli_qubits))
    n = len(qubits)
    qubit_index = {q: i for i, q in enumerate(qubits)}

    # Initial branches.
    if isinstance(pauli_string, dict):
        codes0 = []
        phases0 = []
        for key, ph in pauli_string.items():
            key = str(key).upper()
            if len(key) != n or set(key) - set(_PAULI_NAMES):
                raise ValueError(f"'{key}' is not a valid Pauli string.")
            codes0.append([_PAULI_NAMES.index(c) for c in key])
            phases0.append(ph * phase)
        codes = np.asarray(codes0, dtype=np.uint8)
        phases = np.asarray(phases0, dtype=float_type)
    else:
        code = np.zeros(n, dtype=np.uint8)
        for g in pauli_string:
            if g.name not in _PAULI_NAMES:
                raise ValueError(
                    "'pauli_string' must contain only Pauli gates.")
            (q,) = g.qubits
            code[qubit_index[q]] = _PAULI_NAMES.index(g.name)
        codes = code[None]
        phases = np.asarray([phase], dtype=float_type)

    # Preprocess circuit: simplify then lightcone-prune against the Pauli
    # support (gates outside the cone cancel between C^dagger and C;
    # reference ``clifford.py:1056-1081``).
    if simplify and len(circuit):
        support = [qubits[i] for i in range(n)
                   if np.any(codes[:, i] != 0)]
        circuit = utils.simplify(circuit, remove_id_gates=remove_id_gates)
        if support:
            circuit = utils.popright(Circuit(circuit),
                                     pinned_qubits=support)

    # Compress and precompute Pauli-transfer rows.  Heisenberg evolution
    # C^dagger P C applies the LAST gate's transfer first (the reference
    # iterates ``reversed(circuit)``, ``clifford.py:1104``); each block's
    # transfer U^dagger P U is exact as a unit, so only the block order
    # reverses.
    blocks = utils.compress(circuit, compress) if compress else \
        [Circuit([g]) for g in circuit]
    gates = []
    for b in reversed(blocks):
        g = utils.to_matrix_gate(b, complex_type='complex128') \
            if len(b) > 1 else b[0]
        if not g.provides('matrix'):
            raise NotImplementedError(
                f"Gate '{g.name}' not supported by the Clifford engine.")
        rows, k = _pauli_rows(np.asarray(g.matrix(), dtype='complex128'),
                              kwargs['eps'])
        gates.append((tuple(qubit_index[q] for q in g.qubits), rows, k))

    db = defaultdict(float)
    info = {'n_explored_branches': 0, 'largest_batch': len(codes)}
    run = (kwargs['branch_atol'], int(kwargs['max_breadth_first_branches']),
           int(kwargs['merge_interval']), kwargs['max_virtual_memory'])

    # Worker count: True = all cores, int = that many, False/1 = serial.
    if parallel is True:
        import os
        n_workers = os.cpu_count() or 1
    else:
        n_workers = max(int(parallel or 1), 1)

    # Cross-process branch split (JAX's, ``clifford.py:455-484``): every
    # process runs the same breadth-first expansion until the frontier is
    # wide enough to split, then takes its share of it.
    from hybridq_tpu_torch import parallel
    distributed = parallel.is_distributed() if use_mpi is None \
        else bool(use_mpi)
    gi0 = 0
    if distributed:
        pid, nproc = parallel.process_index(), parallel.process_count()
        while gi0 < len(gates) and len(codes) and \
                len(codes) < 4 * nproc * n_workers:
            codes, phases = _apply_gate_batch(codes, phases, gates[gi0],
                                              run[0])
            gi0 += 1
            codes, phases = _merge_batch(codes, phases)
            info['largest_batch'] = max(info['largest_batch'], len(codes))
        share = np.array_split(np.arange(len(codes)), nproc)[pid]
        codes, phases = codes[share], phases[share]

    if backend == 'torch':
        dtype = torch.float64 if float_type == np.dtype('float64') \
            else torch.float32
        gates = [_torch_gate(g, dtype, device) for g in gates]
        _dfs(gates, gi0, torch.as_tensor(codes, device=device),
             torch.as_tensor(phases, dtype=dtype, device=device),
             _apply_gate_batch_torch, _merge_batch_torch, db, info, *run)
    elif n_workers > 1 and len(gates):
        _pool_dfs(gates, gi0, codes, phases, n_workers, db, info, *run)
    else:
        _dfs(gates, gi0, codes, phases, _apply_gate_batch, _merge_batch,
             db, info, *run)

    # Every process's partial sums merge before the atol filter, so that
    # the contributions of all processes to one string add up first.
    if distributed:
        db = _distributed_merge(db, n)

    # Drop negligible strings.
    atol = kwargs['atol']
    for key in [k for k, v in db.items() if abs(v) < atol]:
        del db[key]

    info['n_strings'] = len(db)
    return (db, info) if return_info else db


def expectation_value(circuit, op, initial_state: str, **kwargs):
    """<psi| C^dagger op C |psi> with psi a product state given by tokens
    '01+-' (reference ``clifford.py:1403-1556``); ``kwargs`` go to
    ``update_pauli_string`` (``backend=``, ``device=``, ...)."""
    return_info = kwargs.pop('return_info', False)
    circuit = Circuit(circuit)
    qubits = circuit.all_qubits
    if len(initial_state) == 1:
        initial_state = initial_state * len(qubits)
    if len(initial_state) != len(qubits):
        raise ValueError("'initial_state' has the wrong number of qubits.")

    # Prepend the state-preparation circuit so the expectation reduces to
    # counting X/Y-free strings on |0...0>.
    prep = Circuit()
    for q, s in zip(qubits, initial_state):
        if s == '0':
            pass
        elif s == '1':
            prep.append(Gate('X', [q]))
        elif s == '+':
            prep.append(Gate('H', [q]))
        elif s == '-':
            prep.extend([Gate('X', [q]), Gate('H', [q])])
        else:
            raise ValueError(f"Unexpected token '{s}'")

    out = update_pauli_string(prep + circuit, op, return_info=return_info,
                              **kwargs)
    db, info = out if return_info else (out, None)
    value = sum(v for k, v in db.items() if not set(k) & set('XY'))
    return (value, info) if return_info else value
