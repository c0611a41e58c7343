"""Slice finding: cut indices until every intermediate fits in memory.

Replacement for cotengra's ``SliceFinder`` (reference
``simulation.py:1037-1048``): fixing ("slicing") an index turns one big
contraction into ``prod(sliced dims)`` independent small ones summed at
the end — the unit of batching on the card and of checkpoints (the
reference distributes slices over MPI ranks).

Two entry points:

* ``find_slices`` — greedy: repeatedly slice the cheapest index among
  those appearing in the largest intermediate (monotone progress on the
  max size, candidates scored by total-flops overhead);
* ``slice_and_reconfigure`` — the quality path (cotengra's
  ``slicing_reconf``): alternate a few greedy slices with subtree
  reconfiguration under the sliced metric, so the tree re-shapes itself
  around the cuts.  This is where most of the sliced-contraction
  efficiency comes from.
"""

from __future__ import annotations

from typing import FrozenSet, Tuple

from hybridq_tpu_torch.simulation.tn.path import (ContractionTree, anneal,
                                            reconfigure)

__all__ = ['find_slices', 'SliceCost', 'slice_and_reconfigure']


class SliceCost:
    """Cost summary after slicing (mirrors cotengra's ContractionCosts)."""

    def __init__(self, tree: ContractionTree, sliced: FrozenSet[str]):
        self.sliced = frozenset(sliced)
        self.nslices = 1
        for i in self.sliced:
            self.nslices *= tree.size_dict[i]
        self.sliced_flops = tree.total_flops(self.sliced)
        self.total_flops = self.nslices * self.sliced_flops
        self.max_size = tree.max_size(self.sliced)


def _next_slice(tree: ContractionTree, sliced: set, target_size: float,
                max_candidates: int = 32):
    """The cheapest single index to slice next, drawn from the largest
    intermediates (progress on max size is guaranteed), or None."""
    out_set = set(tree.output)
    nodes = list(tree.children) + list(range(tree.n_leaves))
    max_size = max(tree.node_size(v, sliced) for v in nodes)
    if max_size <= target_size:
        return None
    # Candidates must hit *the* largest node so progress is guaranteed;
    # the total-flops score then prefers indices shared by many other
    # large intermediates.
    largest = max(nodes, key=lambda v: tree.node_size(v, sliced))
    cand = set(tree.node_inds[largest]) - sliced - out_set
    if not cand:
        return None
    if len(cand) > max_candidates:
        # Pre-trim by how many nodes each index touches (shared indices
        # shrink more intermediates per cut), largest dimension first.
        counts = {i: 0 for i in cand}
        for v in nodes:
            for i in tree.node_inds[v]:
                if i in counts:
                    counts[i] += 1
        cand = set(sorted(
            cand, key=lambda i: (-counts[i], -tree.size_dict[i], i)
        )[:max_candidates])
    best_i, best_c = None, None
    for i in sorted(cand):
        c = SliceCost(tree, frozenset(sliced | {i}))
        key = (c.total_flops, c.max_size)
        if best_c is None or key < best_c:
            best_i, best_c = i, key
    return best_i


def _drop_redundant(tree: ContractionTree, sliced: set,
                    target_size: float) -> set:
    """Un-slice indices no longer needed after reconfiguration."""
    for i in sorted(sliced):
        trial = set(sliced) - {i}
        if tree.max_size(frozenset(trial)) <= target_size:
            sliced = trial
    return set(sliced)


def find_slices(tree: ContractionTree, target_size: float,
                max_candidates: int = 32) -> Tuple[FrozenSet[str],
                                                   SliceCost]:
    """Greedily pick indices to slice until ``max_size <= target_size``.

    Output indices are never sliced (they must remain open).
    """
    sliced: set = set()
    while True:
        i = _next_slice(tree, sliced, target_size, max_candidates)
        if i is None:
            break
        sliced.add(i)
        if len(sliced) > 100:
            raise RuntimeError("Slicing did not converge.")
    return frozenset(sliced), SliceCost(tree, frozenset(sliced))


def _improve(tree: ContractionTree, sliced, seconds: float,
             target_size: float, max_subtree: int, seed: int,
             verbose: bool) -> ContractionTree:
    """Slice-aware tree improvement: hot simulated annealing when the
    native optimizer is built (it restructures the tree around the cuts
    so subsequent slices are cheap), else subtree reconfiguration."""
    from hybridq_tpu_torch import native

    if native.hgp_available() and tree.n_leaves >= 4:
        # Warm (not hot) annealing: per-batch budgets are seconds, and
        # a hot chain that fails to re-converge gets rejected anyway.
        return anneal(tree, sliced=frozenset(sliced),
                      time_budget=seconds, t0=1.0, t1=0.05,
                      width_target=target_size, width_lambda=1.0,
                      seed=seed, verbose=False)
    reconfigure(tree, max_subtree=max_subtree, sliced=frozenset(sliced),
                time_budget=seconds, verbose=verbose)
    return tree


def _joint_anneal_native(tree: ContractionTree, target_size: float,
                         time_budget: float, verbose: bool,
                         seed: int = 0):
    """Joint (tree, slice-set) annealing: the slice set is itself a
    Metropolis move and a sliceability pressure (sum of oversized-node
    excess) shapes the tree, so cuts and structure co-optimize under the
    true total sliced cost — the fix for flop-optimal trees slicing
    catastrophically (reference: cotengra slicing-aware hyper-search,
    ``simulation.py:1037-1048``).  Two annealing chains run on two
    threads (the native call releases the GIL); best feasible wins.
    Returns None when the native library is unavailable."""
    import math as _m
    import time as _t
    from concurrent.futures import ThreadPoolExecutor

    from hybridq_tpu_torch import native
    from hybridq_tpu_torch.simulation.tn.path import (_ssa_to_linear,
                                                tree_to_ssa)

    if not native.hgp_available() or tree.n_leaves < 4:
        return None
    if tree.max_size() <= target_size:
        return tree, frozenset(), SliceCost(tree, frozenset())

    ssa0 = tree_to_ssa(tree)
    t_start = _t.time()
    # Greedy preslice to a feasible starting slice set (no annealing —
    # the joint chains will rebuild the set anyway).
    try:
        ssa_pre, sl0, _, _ = native.slice_anneal_tree(
            tree.inputs, tree.output, tree.size_dict, ssa0,
            target_size=target_size, sweeps_per_slice=0,
            final_sweeps=0, seed=seed, max_slices=400)
    except RuntimeError:
        return None

    # Calibrate the sweep rate (the calibration chain's result is kept
    # as a candidate), then run iterated rounds of two concurrent
    # chains, each round re-seeded from the best sliced state so far —
    # cotengra's ``slice_and_reconfigure`` restart policy, which beats
    # independent restarts from the unsliced optimum.
    cal = 2000
    t0c = _t.time()
    cal_out = native.joint_anneal_tree(
        tree.inputs, tree.output, tree.size_dict, ssa_pre,
        target_size=target_size, sliced=sl0, n_sweeps=cal,
        t0=0.7, t1=0.01, width_lambda=2.0, excess_lambda=0.1,
        slice_moves_per_sweep=6, seed=seed)
    rate = cal / max(_t.time() - t0c, 1e-3)

    def polish(out, budget_ms):
        """Strictly-improving DP subtree-reconfiguration descent on a
        chain's best state (slices fixed) — cheap, bounded, never
        worse under the joint objective."""
        ssa, sl, resid, width = out
        try:
            ssa2, fl, wd = native.reconfigure_tree(
                tree.inputs, tree.output, tree.size_dict, ssa,
                target_size=target_size, sliced=sl,
                budget_ms=budget_ms)
            return (ssa2, sl, fl, wd)
        except RuntimeError:
            return out

    def score(out):
        ssa, sl, _, _ = out
        new = ContractionTree(tree.inputs, tree.output, tree.size_dict,
                              _ssa_to_linear(ssa, tree.n_leaves))
        sl = _drop_redundant(new, set(sl), target_size)
        c = SliceCost(new, frozenset(sl))
        feasible = c.max_size <= target_size
        return (not feasible, c.total_flops), new, frozenset(sl), c, out

    best = score(polish(cal_out, 2000))
    seed_ssa, seed_sl = ssa_pre, sl0
    rounds = 2
    for r in range(rounds):
        remaining = max(time_budget - (_t.time() - t_start), 1.0)
        sweeps = max(2000, int(rate * (remaining / (rounds - r)) * 0.45))

        def chain(s):
            return native.joint_anneal_tree(
                tree.inputs, tree.output, tree.size_dict, seed_ssa,
                target_size=target_size, sliced=seed_sl, n_sweeps=sweeps,
                t0=0.7 if r == 0 else 0.35, t1=0.01, width_lambda=2.0,
                excess_lambda=0.1, slice_moves_per_sweep=6, seed=s)

        with ThreadPoolExecutor(2) as ex:
            results = list(ex.map(chain, [seed + 1 + 31 * r,
                                          seed + 7919 + 31 * r]))
        remaining = max(time_budget - (_t.time() - t_start), 1.0)
        pol_ms = max(1000.0, min(8000.0, remaining * 150))
        for out in results:
            cand = score(polish(out, pol_ms))
            if cand[0] < best[0]:
                best = cand
        # Re-seed the next round from the best state found so far.
        seed_ssa, seed_sl = best[4][0], best[4][1]
        if _t.time() - t_start > time_budget:
            break
    _, new, sl, c, _ = best
    if c.max_size > target_size:
        return None  # fall back to the greedy descent
    if verbose:
        import sys
        print(f"# joint slice anneal {_t.time()-t_start:.0f}s: "
              f"{len(sl)} sliced, total "
              f"2^{_m.log2(max(c.total_flops, 1)):.1f}",
              file=sys.stderr, flush=True)
    return new, sl, c


def _slice_reconf_native(tree: ContractionTree, target_size: float,
                         time_budget: float, verbose: bool,
                         max_subtree: int = 10):
    """cotengra's ``slice_and_reconfigure``: greedily slice the index
    whose removal least inflates total flops, then run the strictly-
    improving native DP reconfiguration under the NEW weights, repeat
    until the width target is met.  Reconfiguration (not annealing)
    between cuts preserves tree quality at every slicing level — the
    hot re-anneal variant measured 2^151 total flops on sycamore-53
    d20 where this descent lands ~2^70.  Returns None when the native
    library is unavailable."""
    import math as _m
    import time as _t

    from hybridq_tpu_torch import native
    from hybridq_tpu_torch.simulation.tn.path import (_ssa_to_linear,
                                                tree_to_ssa)

    if not native.hgp_available() or tree.n_leaves < 4:
        return None
    if tree.max_size() <= target_size:
        return tree, frozenset(), SliceCost(tree, frozenset())

    t_start = _t.time()
    need = max(1.0, _m.log2(max(tree.max_size(), 1)) -
               _m.log2(max(target_size, 1)))
    per_ms = max(500.0, time_budget * 1000.0 / (need * 1.4))

    sliced: set = set()
    while True:
        c = SliceCost(tree, frozenset(sliced))
        if c.max_size <= target_size:
            break
        i = _next_slice(tree, sliced, target_size)
        if i is None:
            break
        sliced.add(i)
        if len(sliced) > 120:
            return None
        remaining_ms = max(
            0.0, (time_budget - (_t.time() - t_start)) * 1000.0)
        # Per-level width target = the width ACHIEVED by this cut, with
        # a steep penalty: reconfiguration must minimize flops subject
        # to never re-widening, else every flop-gaining splice undoes
        # the cut and the descent spirals (measured: 66 slices, 2^103).
        level_width = max(SliceCost(tree, frozenset(sliced)).max_size,
                          target_size)
        try:
            ssa, _, _ = native.reconfigure_tree(
                tree.inputs, tree.output, tree.size_dict,
                tree_to_ssa(tree), target_size=level_width,
                sliced=sliced, width_lambda=16.0,
                max_subtree=max_subtree,
                budget_ms=min(per_ms, remaining_ms))
            tree = ContractionTree(tree.inputs, tree.output,
                                   tree.size_dict,
                                   _ssa_to_linear(ssa, tree.n_leaves))
        except RuntimeError:
            return None
    sliced = _drop_redundant(tree, sliced, target_size)
    c = SliceCost(tree, frozenset(sliced))
    if c.max_size > target_size:
        return None
    if verbose:
        import sys
        print(f"# slice+reconfigure descent {_t.time()-t_start:.0f}s: "
              f"{len(sliced)} sliced, total "
              f"2^{_m.log2(max(c.total_flops, 1)):.1f}",
              file=sys.stderr, flush=True)
    return tree, frozenset(sliced), c


def _slice_anneal_native(tree: ContractionTree, target_size: float,
                         time_budget: float, verbose: bool):
    """Full descent in native code: greedy slice + re-anneal between
    cuts with zero Python per-batch overhead.  Returns None when the
    native library is unavailable."""
    import math as _m
    import time as _t

    from hybridq_tpu_torch import native
    from hybridq_tpu_torch.simulation.tn.path import (_ANNEAL_RATE_CACHE,
                                                _ssa_to_linear,
                                                tree_to_ssa)

    if not native.hgp_available() or tree.n_leaves < 4:
        return None
    if tree.max_size() <= target_size:
        return tree, frozenset(), SliceCost(tree, frozenset())

    # Sweep rate from the anneal cache (populated by the search phase);
    # conservative default otherwise.
    rate_key = (tree.n_leaves // 64, len(tree.size_dict) // 128)
    rate = _ANNEAL_RATE_CACHE.get(rate_key, 300.0)
    need = max(1.0, _m.log2(max(tree.max_size(), 1)) -
               _m.log2(max(target_size, 1)))
    sweeps_per_slice = max(500, int(rate * 0.6 * time_budget /
                                    (1.5 * need)))
    final_sweeps = max(2000, int(rate * 0.3 * time_budget))

    t_start = _t.time()
    ssa = tree_to_ssa(tree)
    try:
        ssa, sliced_names, resid, width = native.slice_anneal_tree(
            tree.inputs, tree.output, tree.size_dict, ssa,
            target_size=target_size, sweeps_per_slice=sweeps_per_slice,
            final_sweeps=final_sweeps)
    except RuntimeError as e:
        if 'did not converge' in str(e):
            raise
        return None
    new = ContractionTree(tree.inputs, tree.output, tree.size_dict,
                          _ssa_to_linear(ssa, tree.n_leaves))
    sliced = set(sliced_names)
    sliced = _drop_redundant(new, sliced, target_size)
    if verbose:
        import sys
        c = SliceCost(new, frozenset(sliced))
        print(f"# native slice descent {_t.time()-t_start:.0f}s: "
              f"{len(sliced)} sliced, total "
              f"2^{_m.log2(max(c.total_flops, 1)):.1f}",
              file=sys.stderr, flush=True)
    return new, frozenset(sliced), SliceCost(new, frozenset(sliced))


def slice_and_reconfigure(tree: ContractionTree, target_size: float,
                          time_budget: float = 60.0, step: int = 1,
                          max_subtree: int = 12,
                          verbose: bool = False
                          ) -> Tuple[ContractionTree, FrozenSet[str],
                                     SliceCost]:
    """Alternate greedy slicing with slice-aware restructuring
    (annealing / subtree reconfiguration).  May mutate ``tree``
    (callers deepcopy user-held plans first).
    """
    import time as _t

    out = _joint_anneal_native(tree, target_size, time_budget, verbose)
    if out is not None:
        return out
    out = _slice_anneal_native(tree, target_size, time_budget, verbose)
    if out is not None:
        return out

    t0 = _t.time()
    # Estimate how many slices are needed so the per-batch improvement
    # budget spreads over the whole descent.
    import math as _m

    need = max(1.0, (_m.log2(max(tree.max_size(), 1)) -
                     _m.log2(max(target_size, 1))))
    per_batch = max(1.0, 0.7 * time_budget / need * step)

    sliced: set = set()
    seed = 0
    while True:
        made = 0
        for _ in range(step):
            i = _next_slice(tree, sliced, target_size)
            if i is None:
                break
            sliced.add(i)
            made += 1
        if made == 0:
            break
        if len(sliced) > 100:
            raise RuntimeError("Slicing did not converge.")
        remaining = time_budget - (_t.time() - t0)
        if remaining > 1.0:
            seed += 1
            tree = _improve(tree, sliced, min(per_batch, remaining),
                            target_size, max_subtree, seed, verbose)
    sliced = _drop_redundant(tree, sliced, target_size)
    # Final polish under the settled slice set.
    remaining = time_budget - (_t.time() - t0)
    if remaining > 1.0:
        tree = _improve(tree, sliced, remaining, target_size,
                        max_subtree, seed + 1, verbose)
        sliced = _drop_redundant(tree, sliced, target_size)
    return tree, frozenset(sliced), SliceCost(tree, frozenset(sliced))
