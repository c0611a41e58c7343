"""Native (C++) path-search components, loaded via ctypes.

A copy of ``hybridq_tpu/native``: the C++ sources (``hgpart.cpp``,
``tnopt.cpp``, ``tree_anneal.cpp``) are the same bytes, and this loader
differs only in where the library goes.  Native code covers the host-side
combinatorics of tensor-network path search — the multilevel hypergraph
bipartitioner (the role KaHyPar plays for cotengra in the reference,
``simulation.py:920-983``), the exact subtree DP and the tree and slice
annealers; the card runs only the contractions.

The shared library is compiled with the system ``g++`` at first use into
``hybridq_tpu_torch/_build/`` (gitignored), named by the hash of the
sources and flags, so an edited source is rebuilt.  Everything degrades
gracefully: callers check ``hgp_available()`` and fall back to
pure-Python heuristics; a failed build warns once with the compiler's
output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import warnings
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ['hgp_available', 'bipartition', 'optimal_subpath',
           'anneal_tree', 'slice_anneal_tree', 'joint_anneal_tree',
           'reconfigure_tree']

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), '_build')
_SRCS = [os.path.join(_DIR, 'hgpart.cpp'), os.path.join(_DIR, 'tnopt.cpp'),
         os.path.join(_DIR, 'tree_anneal.cpp')]
_FLAGS = ['-O3', '-march=native', '-std=c++17', '-shared', '-fPIC']


def _library_path() -> str:
    """``_build/libhqnative-<hash>.so``: the hash covers the C++ sources
    and the flags, so a stale library is never loaded."""
    h = hashlib.sha256(' '.join(_FLAGS).encode())
    for s in _SRCS:
        with open(s, 'rb') as f:
            h.update(f.read())
    return os.path.join(_BUILD_DIR, f'libhqnative-{h.hexdigest()[:16]}.so')


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build(so: str) -> bool:
    """Compile into a temporary name and rename, so that a concurrent
    loader never sees half a library; warn with g++'s output on
    failure."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f'{so}.{os.getpid()}.tmp'
    cmd = ['g++'] + _FLAGS + _SRCS + ['-o', tmp]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=180)
    except (OSError, subprocess.TimeoutExpired) as e:
        warnings.warn(f"hybridq_tpu_torch.native: g++ did not run ({e}); "
                      "path search falls back to pure Python")
        return False
    if r.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        warnings.warn("hybridq_tpu_torch.native: g++ failed "
                      f"(exit {r.returncode}); path search falls back to "
                      f"pure Python:\n{r.stderr[-4000:]}")
        return False
    os.replace(tmp, so)
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get('HYBRIDQ_TPU_DISABLE_NATIVE'):
            return None
        so = _library_path()
        if not os.path.exists(so) and not _build(so):
            return None
        try:
            lib = ctypes.cdll.LoadLibrary(so)
        except OSError:
            return None
        fn = lib.hgp_bipartition
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_int, ctypes.c_int,
            np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS'),
            np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS'),
            np.ctypeslib.ndpointer(np.float64, flags='C_CONTIGUOUS'),
            np.ctypeslib.ndpointer(np.int64, flags='C_CONTIGUOUS'),
            ctypes.c_double, ctypes.c_int, ctypes.c_uint,
            np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS'),
            ctypes.POINTER(ctypes.c_double),
        ]
        fn3 = lib.tn_anneal
        fn3.restype = ctypes.c_int
        fn3.argtypes = [
            ctypes.c_int, ctypes.c_int,
            np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS'),
            np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS'),
            np.ctypeslib.ndpointer(np.float64, flags='C_CONTIGUOUS'),
            np.ctypeslib.ndpointer(np.uint8, flags='C_CONTIGUOUS'),
            np.ctypeslib.ndpointer(np.uint8, flags='C_CONTIGUOUS'),
            np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS'),
            ctypes.c_int, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_uint, ctypes.c_int,
            np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS'),
            np.ctypeslib.ndpointer(np.float64, flags='C_CONTIGUOUS'),
        ]
        fn4 = lib.tn_slice_anneal
        fn4.restype = ctypes.c_int
        fn4.argtypes = [
            ctypes.c_int, ctypes.c_int,
            np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS'),
            np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS'),
            np.ctypeslib.ndpointer(np.float64, flags='C_CONTIGUOUS'),
            np.ctypeslib.ndpointer(np.uint8, flags='C_CONTIGUOUS'),
            np.ctypeslib.ndpointer(np.uint8, flags='C_CONTIGUOUS'),
            np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS'),
            ctypes.c_double, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_uint, ctypes.c_int,
            np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS'),
            np.ctypeslib.ndpointer(np.uint8, flags='C_CONTIGUOUS'),
            np.ctypeslib.ndpointer(np.float64, flags='C_CONTIGUOUS'),
        ]
        fn5 = lib.tn_joint_anneal
        fn5.restype = ctypes.c_int
        fn5.argtypes = [
            ctypes.c_int, ctypes.c_int,
            np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS'),
            np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS'),
            np.ctypeslib.ndpointer(np.float64, flags='C_CONTIGUOUS'),
            np.ctypeslib.ndpointer(np.uint8, flags='C_CONTIGUOUS'),
            np.ctypeslib.ndpointer(np.uint8, flags='C_CONTIGUOUS'),
            np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS'),
            ctypes.c_double, ctypes.c_int, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_int,
            ctypes.c_uint, ctypes.c_int, ctypes.c_int,
            np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS'),
            np.ctypeslib.ndpointer(np.uint8, flags='C_CONTIGUOUS'),
            np.ctypeslib.ndpointer(np.float64, flags='C_CONTIGUOUS'),
        ]
        fn6 = lib.tn_reconfigure
        fn6.restype = ctypes.c_int
        fn6.argtypes = [
            ctypes.c_int, ctypes.c_int,
            np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS'),
            np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS'),
            np.ctypeslib.ndpointer(np.float64, flags='C_CONTIGUOUS'),
            np.ctypeslib.ndpointer(np.uint8, flags='C_CONTIGUOUS'),
            np.ctypeslib.ndpointer(np.uint8, flags='C_CONTIGUOUS'),
            np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS'),
            ctypes.c_double, ctypes.c_double, ctypes.c_int,
            ctypes.c_int, ctypes.c_double,
            np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS'),
            np.ctypeslib.ndpointer(np.float64, flags='C_CONTIGUOUS'),
        ]
        fn2 = lib.tn_optimal_path
        fn2.restype = ctypes.c_int
        fn2.argtypes = [
            ctypes.c_int, ctypes.c_int,
            np.ctypeslib.ndpointer(np.uint32, flags='C_CONTIGUOUS'),
            np.ctypeslib.ndpointer(np.uint8, flags='C_CONTIGUOUS'),
            np.ctypeslib.ndpointer(np.float64, flags='C_CONTIGUOUS'),
            np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS'),
        ]
        _lib = lib
        return _lib


def hgp_available() -> bool:
    """True iff the native partitioner compiled and loaded."""
    return _load() is not None


def bipartition(nets: Sequence[Sequence[int]],
                net_weights: Sequence[float], n_nodes: int,
                node_weights: Optional[Sequence[int]] = None,
                eps: float = 0.1, n_runs: int = 4,
                seed: int = 0) -> Tuple[np.ndarray, float]:
    """Balanced min-cut bipartition of a hypergraph.

    ``nets[e]`` is the list of node ids pinned by net ``e``;
    ``net_weights[e]`` its weight.  Returns ``(labels, cut)`` where
    ``labels`` is an int array of 0/1 per node.  Raises ``RuntimeError``
    if the native library is unavailable (callers should check
    ``hgp_available()`` first).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native hgpart library unavailable")
    xpins = np.zeros(len(nets) + 1, dtype=np.int32)
    for e, ps in enumerate(nets):
        xpins[e + 1] = xpins[e] + len(ps)
    pins = np.fromiter((p for ps in nets for p in ps), dtype=np.int32,
                       count=int(xpins[-1]))
    w = np.ascontiguousarray(net_weights, dtype=np.float64)
    nw = (np.ones(n_nodes, dtype=np.int64) if node_weights is None
          else np.ascontiguousarray(node_weights, dtype=np.int64))
    out = np.zeros(n_nodes, dtype=np.int32)
    cut = ctypes.c_double(0.0)
    r = lib.hgp_bipartition(n_nodes, len(nets), xpins, pins, w, nw,
                            float(eps), int(n_runs),
                            int(seed) & 0xffffffff, out,
                            ctypes.byref(cut))
    if r != 0:
        raise RuntimeError(f"hgp_bipartition failed (code {r})")
    return out, float(cut.value)


def optimal_subpath(inputs: Sequence[Sequence[str]],
                    output: Sequence[str],
                    size_dict) -> list:
    """Exact-optimal (min total flops) contraction order for ≤ 16
    tensors via the native bitmask DP.  Returns an SSA pair list
    ``[(a, b), ...]`` with new ids allocated from ``len(inputs)``
    upward; raises ``RuntimeError`` when unavailable or infeasible
    (callers fall back to the greedy path).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native tnopt library unavailable")
    n = len(inputs)
    if not 2 <= n <= 16:
        raise RuntimeError(f"tn_optimal_path supports 2..16 tensors "
                           f"(got {n})")
    import math

    ind_ids = {}
    for inds in inputs:
        for i in inds:
            ind_ids.setdefault(i, len(ind_ids))
    pin = np.zeros(len(ind_ids), dtype=np.uint32)
    is_out = np.zeros(len(ind_ids), dtype=np.uint8)
    logw = np.zeros(len(ind_ids), dtype=np.float64)
    for t, inds in enumerate(inputs):
        for i in inds:
            pin[ind_ids[i]] |= np.uint32(1 << t)
    for i in output:
        if i in ind_ids:
            is_out[ind_ids[i]] = 1
    for i, k in ind_ids.items():
        logw[k] = math.log2(size_dict[i])
    pairs = np.zeros(2 * (n - 1), dtype=np.int32)
    r = lib.tn_optimal_path(n, len(ind_ids), pin, is_out, logw, pairs)
    if r != 0:
        raise RuntimeError(f"tn_optimal_path failed (code {r})")
    return [(int(pairs[2 * k]), int(pairs[2 * k + 1]))
            for k in range(n - 1)]


def _marshal_tree(inputs, output, size_dict, ssa_pairs, sliced):
    import math

    n = len(inputs)
    ind_ids = {}
    for inds in inputs:
        for i in inds:
            ind_ids.setdefault(i, len(ind_ids))
    xinds = np.zeros(n + 1, dtype=np.int32)
    for t, inds in enumerate(inputs):
        xinds[t + 1] = xinds[t] + len(inds)
    flat = np.fromiter((ind_ids[i] for inds in inputs for i in inds),
                       dtype=np.int32, count=int(xinds[-1]))
    logw = np.zeros(len(ind_ids), dtype=np.float64)
    is_out = np.zeros(len(ind_ids), dtype=np.uint8)
    is_sl = np.zeros(len(ind_ids), dtype=np.uint8)
    for i, k in ind_ids.items():
        logw[k] = math.log2(size_dict[i])
    for i in output:
        if i in ind_ids:
            is_out[ind_ids[i]] = 1
    for i in sliced:
        if i in ind_ids:
            is_sl[ind_ids[i]] = 1
    ssa_in = np.asarray(ssa_pairs, dtype=np.int32).reshape(-1)
    if ssa_in.size != 2 * (n - 1):
        raise ValueError("ssa_pairs must contain n-1 pairs")
    return ind_ids, xinds, flat, logw, is_out, is_sl, ssa_in


def anneal_tree(inputs: Sequence[Sequence[str]], output: Sequence[str],
                size_dict, ssa_pairs: Sequence[Tuple[int, int]],
                sliced: Sequence[str] = (), n_sweeps: int = 2000,
                t0: float = 2.0, t1: float = 0.02,
                width_target: float = 1e9, width_lambda: float = 1.0,
                excess_lambda: float = 0.0, seed: int = 0,
                patience: int = 0) -> Tuple[list, float, float]:
    """Simulated annealing over the contraction tree (native).

    ``ssa_pairs`` is the starting tree; returns
    ``(ssa_pairs, log2_total_flops, log2_max_size)`` of the best tree
    found, where the cost treats ``sliced`` indices as size 1.  Raises
    ``RuntimeError`` when the native library is unavailable.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native tree_anneal library unavailable")
    n = len(inputs)
    ind_ids, xinds, flat, logw, is_out, is_sl, ssa_in = _marshal_tree(
        inputs, output, size_dict, ssa_pairs, sliced)
    ssa_out = np.zeros(2 * (n - 1), dtype=np.int32)
    stats = np.zeros(2, dtype=np.float64)
    r = lib.tn_anneal(n, len(ind_ids), xinds, flat, logw, is_out, is_sl,
                      ssa_in, int(n_sweeps), float(t0), float(t1),
                      float(width_target), float(width_lambda),
                      float(excess_lambda),
                      int(seed) & 0xffffffff, int(patience), ssa_out,
                      stats)
    if r != 0:
        raise RuntimeError(f"tn_anneal failed (code {r})")
    pairs = [(int(ssa_out[2 * k]), int(ssa_out[2 * k + 1]))
             for k in range(n - 1)]
    return pairs, float(stats[0]), float(stats[1])


def slice_anneal_tree(inputs: Sequence[Sequence[str]],
                      output: Sequence[str], size_dict,
                      ssa_pairs: Sequence[Tuple[int, int]],
                      target_size: float,
                      sliced: Sequence[str] = (),
                      sweeps_per_slice: int = 3000,
                      final_sweeps: int = 20000, t0: float = 1.0,
                      t1: float = 0.05, width_lambda: float = 1.0,
                      seed: int = 0, max_slices: int = 120
                      ) -> Tuple[list, list, float, float]:
    """Native slice-and-anneal descent: greedily slice (total-flops
    scored, from the largest intermediate) and re-anneal between cuts
    until the width target is met.  Returns
    ``(ssa_pairs, sliced_names, log2_residual_flops, log2_width)``.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native tree_anneal library unavailable")
    import math

    n = len(inputs)
    ind_ids, xinds, flat, logw, is_out, is_sl, ssa_in = _marshal_tree(
        inputs, output, size_dict, ssa_pairs, sliced)
    ssa_out = np.zeros(2 * (n - 1), dtype=np.int32)
    out_sl = np.zeros(len(ind_ids), dtype=np.uint8)
    stats = np.zeros(3, dtype=np.float64)
    r = lib.tn_slice_anneal(
        n, len(ind_ids), xinds, flat, logw, is_out, is_sl, ssa_in,
        math.log2(max(target_size, 1)), int(sweeps_per_slice),
        int(final_sweeps), float(t0), float(t1), float(width_lambda),
        int(seed) & 0xffffffff, int(max_slices), ssa_out, out_sl, stats)
    if r == 7:
        raise RuntimeError("Slicing did not converge.")
    if r != 0:
        raise RuntimeError(f"tn_slice_anneal failed (code {r})")
    names = list(ind_ids)
    sliced_names = [names[i] for i in range(len(ind_ids)) if out_sl[i]]
    pairs = [(int(ssa_out[2 * k]), int(ssa_out[2 * k + 1]))
             for k in range(n - 1)]
    return pairs, sliced_names, float(stats[0]), float(stats[1])


def reconfigure_tree(inputs: Sequence[Sequence[str]],
                     output: Sequence[str], size_dict,
                     ssa_pairs: Sequence[Tuple[int, int]],
                     target_size: float,
                     sliced: Sequence[str] = (),
                     width_lambda: float = 2.0, max_subtree: int = 12,
                     max_passes: int = 10, budget_ms: float = 0.0
                     ) -> Tuple[list, float, float]:
    """Strictly-improving exact-DP subtree-reconfiguration descent on a
    (tree, slice set) — cotengra's final ``subtree_reconfigure`` polish
    as one budgeted native call.  Slices are FIXED; only the tree
    restructures.  Returns ``(ssa_pairs, log2_residual_flops,
    log2_width)``; never worse than the input under the joint
    objective."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native tree_anneal library unavailable")
    import math

    n = len(inputs)
    ind_ids, xinds, flat, logw, is_out, is_sl, ssa_in = _marshal_tree(
        inputs, output, size_dict, ssa_pairs, sliced)
    ssa_out = np.zeros(2 * (n - 1), dtype=np.int32)
    stats = np.zeros(3, dtype=np.float64)
    r = lib.tn_reconfigure(
        n, len(ind_ids), xinds, flat, logw, is_out, is_sl, ssa_in,
        math.log2(max(target_size, 1)), float(width_lambda),
        int(max_subtree), int(max_passes), float(budget_ms),
        ssa_out, stats)
    if r != 0:
        raise RuntimeError(f"tn_reconfigure failed (code {r})")
    pairs = [(int(ssa_out[2 * k]), int(ssa_out[2 * k + 1]))
             for k in range(n - 1)]
    return pairs, float(stats[0]), float(stats[1])


def joint_anneal_tree(inputs: Sequence[Sequence[str]],
                      output: Sequence[str], size_dict,
                      ssa_pairs: Sequence[Tuple[int, int]],
                      target_size: float,
                      sliced: Sequence[str] = (),
                      n_sweeps: int = 20000, t0: float = 1.0,
                      t1: float = 0.02, width_lambda: float = 2.0,
                      excess_lambda: float = 0.0,
                      slice_moves_per_sweep: int = 2, seed: int = 0,
                      max_slices: int = 120, patience: int = 0
                      ) -> Tuple[list, list, float, float]:
    """Native joint annealing over (tree, slice set).

    The slice set is itself a Metropolis move, so the tree co-optimizes
    with the cuts under the true total sliced cost (slicing-aware
    hyper-optimization, the reference's cotengra ``SliceFinder`` +
    hyper search, ``simulation.py:1037-1048``).  ``sliced`` seeds the
    starting slice set (all seeded indices may be un-sliced).  Returns
    ``(ssa_pairs, sliced_names, log2_residual_flops, log2_width)``.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native tree_anneal library unavailable")
    import math

    n = len(inputs)
    ind_ids, xinds, flat, logw, is_out, is_sl, ssa_in = _marshal_tree(
        inputs, output, size_dict, ssa_pairs, sliced)
    ssa_out = np.zeros(2 * (n - 1), dtype=np.int32)
    out_sl = np.zeros(len(ind_ids), dtype=np.uint8)
    stats = np.zeros(3, dtype=np.float64)
    r = lib.tn_joint_anneal(
        n, len(ind_ids), xinds, flat, logw, is_out, is_sl, ssa_in,
        math.log2(max(target_size, 1)), int(n_sweeps), float(t0),
        float(t1), float(width_lambda), float(excess_lambda),
        int(slice_moves_per_sweep),
        int(seed) & 0xffffffff, int(max_slices), int(patience),
        ssa_out, out_sl, stats)
    if r != 0:
        raise RuntimeError(f"tn_joint_anneal failed (code {r})")
    names = list(ind_ids)
    sliced_names = [names[i] for i in range(len(ind_ids)) if out_sl[i]]
    pairs = [(int(ssa_out[2 * k]), int(ssa_out[2 * k + 1]))
             for k in range(n - 1)]
    return pairs, sliced_names, float(stats[0]), float(stats[1])
