"""Contraction-path search and cost accounting (host side).

A copy of ``hybridq_tpu/simulation/tn/path.py`` without opt_einsum:

  * ``ContractionTree`` — a binary contraction tree with per-node index
    sets, sizes, and flop counts (the data structure the slicer and the
    executor consume);
  * ``find_path`` — best-of-N path search combining a greedy and a
    randomised greedy (this module's ``_greedy_ssa``, with opt_einsum's
    ``greedy`` cost) with a KaHyPar-style recursive graph bisection on
    the native partitioner (networkx Kernighan–Lin without it),
    minimizing ``flops`` / ``size`` / ``combo``;
  * ``anneal`` / ``reconfigure`` — tree restructuring in the native
    library (``hybridq_tpu_torch.native``).

Path search is host-side CPU combinatorics; the card only runs the
contractions.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = ['ContractionTree', 'find_path', 'PathInfo', 'reconfigure',
           'anneal', 'tree_to_ssa']

_ANNEAL_RATE_CACHE: dict = {}


class ContractionTree:
    """Binary contraction tree over ``n`` leaf tensors.

    Built from an opt_einsum-style SSA path (pairs over a shrinking
    list).  Nodes are integers: 0..n-1 are leaves; internal nodes are
    appended.  ``children[v] = (a, b)``.
    """

    def __init__(self, inputs: Sequence[Tuple[str, ...]],
                 output: Sequence[str], size_dict: Dict[str, int],
                 path: Sequence[Tuple[int, int]]):
        self.inputs = [tuple(x) for x in inputs]
        self.output = tuple(output)
        self.size_dict = dict(size_dict)
        n = len(self.inputs)
        self.n_leaves = n

        # Convert shrinking-list path to SSA ids.
        avail = list(range(n))
        self.children: Dict[int, Tuple[int, int]] = {}
        nxt = n
        for pair in path:
            if len(pair) == 1:
                continue  # single-tensor "contraction" is a no-op
            i, j = pair
            a = avail[i]
            b = avail[j]
            for k in sorted((i, j), reverse=True):
                avail.pop(k)
            self.children[nxt] = (a, b)
            avail.append(nxt)
            nxt += 1
        if len(avail) != 1:
            # Disconnected network: contract remaining subtrees pairwise.
            while len(avail) > 1:
                a = avail.pop(0)
                b = avail.pop(0)
                self.children[nxt] = (a, b)
                avail.append(nxt)
                nxt += 1
        self.root = avail[0]
        self._compute_inds()

    @classmethod
    def from_children(cls, inputs, output, size_dict, children,
                      root) -> 'ContractionTree':
        """The tree with exactly these nodes: ``children[v] = (a, b)``
        for every internal node ``v`` (ids and child order kept, so a
        ``ContractionPlan`` of it lists the same steps)."""
        tree = cls.__new__(cls)
        tree.inputs = [tuple(x) for x in inputs]
        tree.output = tuple(output)
        tree.size_dict = dict(size_dict)
        tree.n_leaves = len(tree.inputs)
        tree.children = {int(v): (int(a), int(b))
                         for v, (a, b) in children.items()}
        tree.root = int(root)
        tree._compute_inds()
        return tree

    def _compute_inds(self):
        """Per-node retained index sets (bottom-up)."""
        n = self.n_leaves
        # For each index: leaves it appears in.
        appears = defaultdict(set)
        for pos, inds in enumerate(self.inputs):
            for i in inds:
                appears[i].add(pos)
        out_set = set(self.output)

        # Leaf sets of each node.
        self.node_inds: Dict[int, Tuple[str, ...]] = {}
        self._leaf_sets: Dict[int, frozenset] = {}

        def leaves_of(v):
            if v < n:
                return frozenset((v,))
            a, b = self.children[v]
            return leaves_of(a) | leaves_of(b)

        order = self.topo_order()
        for v in order:
            if v < self.n_leaves:
                self._leaf_sets[v] = frozenset((v,))
                self.node_inds[v] = self.inputs[v]
            else:
                a, b = self.children[v]
                ls = self._leaf_sets[a] | self._leaf_sets[b]
                self._leaf_sets[v] = ls
                cand = []
                seen = set()
                for i in self.node_inds[a] + self.node_inds[b]:
                    if i in seen:
                        continue
                    seen.add(i)
                    # Keep the index if it appears outside this subtree
                    # or in the output.
                    if i in out_set or not appears[i] <= ls:
                        cand.append(i)
                self.node_inds[v] = tuple(cand)

    def topo_order(self) -> List[int]:
        """Children before parents."""
        order = []
        stack = [self.root]
        visited = set()
        while stack:
            v = stack.pop()
            if v in visited:
                continue
            if v < self.n_leaves:
                visited.add(v)
                order.append(v)
                continue
            a, b = self.children[v]
            if a in visited and b in visited:
                visited.add(v)
                order.append(v)
            else:
                stack.extend([v, a, b])
        return order

    # -- cost accounting (optionally with sliced indices removed) --------
    def node_size(self, v, sliced=frozenset()) -> float:
        return float(np.prod([self.size_dict[i]
                              for i in self.node_inds[v]
                              if i not in sliced], dtype=float))

    def node_flops(self, v, sliced=frozenset()) -> float:
        if v < self.n_leaves:
            return 0.0
        a, b = self.children[v]
        inds = set(self.node_inds[a]) | set(self.node_inds[b])
        return float(np.prod([self.size_dict[i] for i in inds
                              if i not in sliced], dtype=float))

    def total_flops(self, sliced=frozenset()) -> float:
        return sum(self.node_flops(v, sliced) for v in self.children)

    def max_size(self, sliced=frozenset()) -> float:
        return max(self.node_size(v, sliced)
                   for v in list(self.children) + list(
                       range(self.n_leaves)))

    def all_inds(self):
        s = set()
        for inds in self.inputs:
            s.update(inds)
        return s


class PathInfo:
    """Summary of a contraction path (mirrors the reference's use of
    opt_einsum PathInfo: ``opt_cost`` and ``largest_intermediate``)."""

    def __init__(self, tree: ContractionTree):
        self.tree = tree
        self.opt_cost = tree.total_flops()
        self.largest_intermediate = tree.max_size()

    def __repr__(self):
        return (f"PathInfo(flops=2^{math.log2(max(self.opt_cost, 1)):.2f}, "
                f"largest=2^"
                f"{math.log2(max(self.largest_intermediate, 1)):.2f})")


def _greedy_ssa(inputs, output, size_dict, rng=None):
    """One greedy contraction order as an SSA pair list.

    Among the pairs of tensors that share an index, contract the one
    with the least ``size(out) - size(a) - size(b)``, the cost of
    opt_einsum's ``'greedy'``, with its bookkeeping: tensors with the
    same indices are multiplied first, an index held by every tensor
    counts as an output, each tensor offers only its best partner, and
    an index stays on the result while a third tensor or the output
    holds it (hyperedges).  Tensors that share nothing are joined last,
    smallest first.  With ``rng`` the choice is randomised as
    opt_einsum's ``RandomGreedy`` does it: the operands' weight in the
    cost and a temperature are drawn once, every partner is offered, and
    each step picks among the best eight with Boltzmann weights.
    """
    import heapq

    keys = [frozenset(x) for x in inputs]
    out = frozenset(output) | frozenset.intersection(*keys)
    if rng is None:
        costmod, temperature = 1.0, 0.0
    else:
        costmod = float(rng.uniform(0.1, 4.0))
        temperature = float(np.exp(rng.uniform(np.log(1e-3), 0.0)))

    def size(k):
        return math.prod(size_dict[i] for i in k)

    ssa = []
    nxt = len(keys)
    remaining = {}              # index set -> ssa id
    for v, k in enumerate(keys):
        if k in remaining:      # same indices: multiply now
            ssa.append((remaining[k], v))
            remaining[k] = nxt
            nxt += 1
        else:
            remaining[k] = v
    holders = defaultdict(set)  # contractible index -> index sets
    for k in remaining:
        for i in k - out:
            holders[i].add(k)
    sizes = {k: size(k) for k in remaining}
    heap = []

    def candidate(k1, k2):
        either, two = k1 | k2, k1 & k2
        k12 = frozenset(i for i in either if i in out or len(holders[i])
                        > (2 if i in two else 1))
        cost = size(k12) - costmod * (sizes[k1] + sizes[k2])
        id1, id2 = remaining[k1], remaining[k2]
        if id1 > id2:
            k1, k2, id1, id2 = k2, k1, id2, id1
        return (cost, id2, id1), k1, k2, k12

    def offer(k1, k2s):
        cands = [candidate(k1, k2) for k2 in k2s]
        if rng is None:
            heapq.heappush(heap, min(cands))
        else:
            for c in cands:
                heapq.heappush(heap, c)

    for i, hs in holders.items():
        hs = sorted(hs, key=remaining.__getitem__)
        for x in range(len(hs) - 1):
            offer(hs[x], hs[x + 1:])

    while heap:
        if rng is None:
            c = heapq.heappop(heap)
            if c[1] not in remaining or c[2] not in remaining:
                continue
        else:
            cands = []
            while heap and len(cands) < 8:
                c = heapq.heappop(heap)
                if c[1] in remaining and c[2] in remaining:
                    cands.append(c)
            if not cands:
                continue
            cmin = cands[0][0][0]
            t = temperature * max(1.0, abs(cmin))
            w = np.exp(-(np.array([c[0][0] for c in cands]) - cmin) / t)
            c = cands.pop(int(rng.choice(len(cands), p=w / w.sum())))
            for other in cands:
                heapq.heappush(heap, other)
        _, k1, k2, k12 = c
        ssa.append((remaining.pop(k1), remaining.pop(k2)))
        for k in (k1, k2):
            for i in k - out:
                holders[i].discard(k)
        if k12 in remaining:    # same indices as a live tensor
            ssa.append((remaining[k12], nxt))
            nxt += 1
        else:
            for i in k12 - out:
                holders[i].add(k12)
        remaining[k12] = nxt
        nxt += 1
        sizes[k12] = size(k12)
        k2s = {k2 for i in k12 - out for k2 in holders[i]} - {k12}
        if k2s:
            offer(k12, sorted(k2s, key=remaining.__getitem__))

    # Disconnected components: outer products, smallest first.
    rest = [(size(k & out), v, k) for k, v in remaining.items()]
    heapq.heapify(rest)
    _, a, ka = heapq.heappop(rest)
    while rest:
        _, b, kb = heapq.heappop(rest)
        ssa.append((min(a, b), max(a, b)))
        k = (ka | kb) & out
        _, a, ka = heapq.heappushpop(rest, (size(k), nxt, k))
        nxt += 1
    return ssa


def _greedy_paths(inputs, output, size_dict, max_repeats, rng):
    """The greedy path, and the cheapest (in flops) of ``max_repeats``
    randomised greedy paths, as shrinking-list paths."""
    n = len(inputs)
    paths = [_ssa_to_linear(_greedy_ssa(inputs, output, size_dict), n)]
    if max_repeats > 1:
        best, best_f = None, None
        for _ in range(max_repeats):
            p = _ssa_to_linear(
                _greedy_ssa(inputs, output, size_dict, rng), n)
            f = ContractionTree(inputs, output, size_dict, p).total_flops()
            if best is None or f < best_f:
                best, best_f = p, f
        paths.append(best)
    return paths


def _split_group_native(group, appears, size_dict, rng):
    """Balanced min-cut split via the native multilevel hypergraph
    partitioner (``hybridq_tpu_torch.native``) — the KaHyPar-equivalent the
    reference reaches through cotengra (``simulation.py:920-983``).
    Returns None when the library is unavailable."""
    from hybridq_tpu_torch import native

    if not native.hgp_available():
        return None
    group = list(group)
    gset = set(group)
    idx_of = {p: i for i, p in enumerate(group)}
    nets, w = [], []
    for i, ps in appears.items():
        pins = [idx_of[p] for p in ps if p in gset]
        if len(pins) >= 2:
            nets.append(pins)
            w.append(math.log2(size_dict[i]))
    if not nets:
        return None
    # Sample the imbalance per trial (cotengra tunes it; we randomize).
    # High imbalance matters: good contraction trees for circuit
    # networks "peel" unbalanced space-time chunks, not 50/50 halves.
    eps = float(rng.choice([0.1, 0.33, 0.47, 0.6, 0.8, 0.9]))
    try:
        labels, _ = native.bipartition(nets, w, len(group), eps=eps,
                                       n_runs=4,
                                       seed=int(rng.integers(2**31)))
    except RuntimeError:
        return None
    half1 = {group[i] for i in range(len(group)) if labels[i] == 0}
    half2 = gset - half1
    if not half1 or not half2:
        return None
    return half1, half2


def _split_group(group, appears, size_dict, rng, refine: bool = True):
    """Split a group of tensors into two balanced halves with a small
    weighted cut: native multilevel hypergraph partitioner when built,
    else spectral (Fiedler vector) seed + Kernighan–Lin refinement."""
    native_split = _split_group_native(group, appears, size_dict, rng)
    if native_split is not None:
        return native_split

    import networkx as nx

    group = list(group)
    G = nx.Graph()
    G.add_nodes_from(group)
    gset = set(group)
    for i, ps in appears.items():
        ps = [p for p in ps if p in gset]
        w = math.log2(size_dict[i])
        for a in range(len(ps)):
            for b in range(a + 1, len(ps)):
                if G.has_edge(ps[a], ps[b]):
                    G[ps[a]][ps[b]]['weight'] += w
                else:
                    G.add_edge(ps[a], ps[b], weight=w)

    half1 = None
    if len(group) >= 8:
        try:
            import scipy.sparse.linalg as spl

            nodes = list(G.nodes)
            if rng.random() < 0.5:
                # Perturbed restart: jitter edge weights so repeated
                # trials explore different cuts.
                for _, _, d in G.edges(data=True):
                    d['weight'] *= float(np.exp(0.3 * rng.standard_normal()))
            L = nx.laplacian_matrix(G, nodelist=nodes,
                                    weight='weight').astype(float)
            k = min(2, len(nodes) - 1)
            _, vecs = spl.eigsh(L.asformat('csr'), k=k, sigma=-1e-6,
                                which='LM',
                                v0=rng.standard_normal(len(nodes)))
            fiedler = vecs[:, -1]
            order = np.argsort(fiedler)
            # Pick the cut point along the Fiedler ordering with the
            # smallest cut weight, allowing imbalance in [1/4, 3/4].
            pos_of = {nodes[i]: r for r, i in enumerate(order)}
            m = len(nodes)
            delta = np.zeros(m + 1)
            for u, v2, d in G.edges(data=True):
                a, b = sorted((pos_of[u], pos_of[v2]))
                # edge crosses every cut point in (a, b]
                delta[a + 1] += d['weight']
                delta[b + 1] -= d['weight']
            crossing = np.cumsum(delta)[:-1]  # crossing[c] = cut at c
            lo, hi = max(1, m // 4), min(m - 1, (3 * m) // 4)
            cut = lo + int(np.argmin(crossing[lo:hi + 1]))
            half1 = {nodes[i] for i in order[:cut]}
        except Exception:
            half1 = None
    if half1 is None:
        perm = list(group)
        rng.shuffle(perm)
        half1 = set(perm[:len(group) // 2])
    half2 = set(group) - half1

    if refine and len(group) >= 6:
        try:
            half1, half2 = nx.algorithms.community.kernighan_lin_bisection(
                G, partition=(half1, half2), weight='weight',
                seed=int(rng.integers(2**31)))
        except Exception:
            pass
    if not half1 or not half2:
        half1 = set(group[:len(group) // 2])
        half2 = set(group) - half1
    return half1, half2


def _bisection_path(inputs, output, size_dict, rng, dp_cutoff: int = 10):
    """KaHyPar-style recursive bisection: build the contraction tree
    top-down by repeatedly splitting the tensor graph into two balanced
    halves with a small weighted cut, contracting each half first.
    Groups of ≤ ``dp_cutoff`` leaves are finished with an exact DP
    subpath (cotengra's partition+DP hybrid)."""
    n = len(inputs)
    appears = defaultdict(set)
    for pos, inds in enumerate(inputs):
        for i in inds:
            appears[i].add(pos)
    out_set = set(output)

    children = {}
    nxt = [n]

    def build_dp(group):
        """Exact-optimal subtree over the leaves in ``group``; returns
        the subtree root id, or None if DP fails."""
        inputs_g = [inputs[p] for p in group]
        leafset = set(group)
        seen = set()
        out_g = []
        for inds in inputs_g:
            for i in inds:
                if i in seen:
                    continue
                seen.add(i)
                if i in out_set or not appears[i] <= leafset:
                    out_g.append(i)
        try:
            path = _optimal_subpath(inputs_g, out_g, size_dict)
        except Exception:
            return None
        avail = list(group)
        local = {}
        nid = nxt[0]
        for pair in path:
            if len(pair) != 2:
                return None  # nothing merged into `children` yet
            i, j = pair
            a, b = avail[i], avail[j]
            for k in sorted((i, j), reverse=True):
                avail.pop(k)
            local[nid] = (a, b)
            avail.append(nid)
            nid += 1
        while len(avail) > 1:  # disconnected group
            a = avail.pop(0)
            b = avail.pop(0)
            local[nid] = (a, b)
            avail.append(nid)
            nid += 1
        children.update(local)
        nxt[0] = nid
        return avail[0]

    def build(group):
        group = list(group)
        if len(group) == 1:
            return group[0]
        if len(group) == 2:
            v = nxt[0]
            nxt[0] += 1
            children[v] = (group[0], group[1])
            return v
        if len(group) <= dp_cutoff:
            root = build_dp(group)
            if root is not None:
                return root
        half1, half2 = _split_group(group, appears, size_dict, rng)
        a = build(half1)
        b = build(half2)
        v = nxt[0]
        nxt[0] += 1
        children[v] = (a, b)
        return v

    build(range(n))
    ssa_path = [children[v] for v in sorted(children)]
    return _ssa_to_linear(ssa_path, n)


def _ssa_to_linear(ssa_path, n):
    """SSA pair list -> shrinking-list path (opt_einsum convention)."""
    ids = list(range(n))
    out = []
    nxt = n
    for (a, b) in ssa_path:
        i, j = ids.index(a), ids.index(b)
        out.append((min(i, j), max(i, j)))
        for k in sorted((i, j), reverse=True):
            ids.pop(k)
        ids.append(nxt)
        nxt += 1
    return out


def _frontier(tree: ContractionTree, v: int, max_leaves: int):
    """Collect a ≤max_leaves frontier of super-leaves under node ``v``:
    repeatedly expand the frontier node with the most leaves beneath it."""
    if v not in tree.children:
        return [v]
    frontier = list(tree.children[v])
    while len(frontier) < max_leaves:
        cands = [(len(tree._leaf_sets[u]), i, u)
                 for i, u in enumerate(frontier) if u in tree.children]
        if not cands:
            break
        _, i, u = max(cands)
        frontier.pop(i)
        frontier.extend(tree.children[u])
    return frontier


def _optimal_subpath(inputs, output, size_dict):
    """Optimal (min total flops) contraction path for a small set of
    effective tensors by the native bitmask DP; past 16 tensors, or
    without the native library, the greedy path."""
    if 2 <= len(inputs) <= 16:
        from hybridq_tpu_torch import native
        try:
            ssa = native.optimal_subpath(inputs, output, size_dict)
            return _ssa_to_linear(ssa, len(inputs))
        except RuntimeError:
            pass
    return _ssa_to_linear(_greedy_ssa(inputs, output, size_dict),
                          len(inputs))


def reconfigure(tree: ContractionTree, max_subtree: int = 12,
                rounds: int = 40, sliced=frozenset(),
                time_budget: float = 60.0,
                verbose: bool = False) -> ContractionTree:
    """Subtree reconfiguration (the core cotengra refinement): repeatedly
    take the most expensive small subtrees and replace them with the
    exact-optimal contraction of their super-leaves.  ``sliced`` indices
    are treated as size-1 so slicing and reconfiguration can alternate.
    """
    import time as _t

    sl = frozenset(sliced)

    # Native full-tree descent when available: whole passes run in C++
    # (the per-node Python/ctypes loop below is ~100x slower per node).
    from hybridq_tpu_torch import native
    if native.hgp_available() and tree.n_leaves >= 4:
        try:
            ssa, _, _ = native.reconfigure_tree(
                tree.inputs, tree.output, tree.size_dict,
                tree_to_ssa(tree), target_size=1e300, sliced=sl,
                max_subtree=max_subtree, max_passes=rounds,
                budget_ms=time_budget * 1000.0)
            return ContractionTree(tree.inputs, tree.output,
                                   tree.size_dict,
                                   _ssa_to_linear(ssa, tree.n_leaves))
        except RuntimeError:
            pass

    eff_sizes = {i: (1 if i in sl else d)
                 for i, d in tree.size_dict.items()}
    t0 = _t.time()
    next_id = max(list(tree.children) + [tree.n_leaves]) + 1

    for _ in range(rounds):
        # Nodes by descending contraction cost.
        nodes = sorted(tree.children,
                       key=lambda v: -tree.node_flops(v, sl))
        changed = False
        for v in nodes:
            if _t.time() - t0 > time_budget:
                break
            frontier = _frontier(tree, v, max_subtree)
            if len(frontier) < 3:
                continue
            inputs = [tuple(tree.node_inds[u]) for u in frontier]
            output = tuple(tree.node_inds[v])
            try:
                path = _optimal_subpath(
                    inputs, output,
                    {i: eff_sizes[i] for inds in inputs for i in inds})
            except Exception:
                continue
            # Cost of the current subtree (internal nodes between v and
            # the frontier).
            internal = []
            stack = [v]
            fr = set(frontier)
            while stack:
                u = stack.pop()
                if u in fr:
                    continue
                internal.append(u)
                a, b = tree.children[u]
                stack.extend([a, b])
            old_cost = sum(tree.node_flops(u, sl) for u in internal)

            # Build candidate sub-tree.
            avail = list(frontier)
            new_children = {}
            nid = next_id
            ok = True
            for pair in path:
                if len(pair) != 2:
                    ok = False
                    break
                i, j = pair
                a = avail[i]
                b = avail[j]
                for kk in sorted((i, j), reverse=True):
                    avail.pop(kk)
                new_children[nid] = (a, b)
                avail.append(nid)
                nid += 1
            if not ok or len(avail) != 1:
                continue
            # Splice: remove old internal nodes, rewire v (rename the new
            # root to v so v's parent stays valid).
            saved = {u: tree.children[u] for u in internal}
            for u in internal:
                del tree.children[u]
            root_new = avail[0]
            a, b = new_children.pop(root_new)
            new_children[v] = (a, b)
            tree.children.update(new_children)
            next_id = nid + 1
            tree._compute_inds()
            new_cost = sum(tree.node_flops(u, sl)
                           for u in [v] + [u for u in new_children
                                           if u != v])
            if new_cost > old_cost:
                # branch-2 fallback can regress: revert.
                for u in new_children:
                    del tree.children[u]
                tree.children.update(saved)
                tree._compute_inds()
            else:
                changed = True
        if not changed or _t.time() - t0 > time_budget:
            break
    return tree


def tree_to_ssa(tree: ContractionTree):
    """Children-pairs of ``tree`` as an SSA pair list (ids 0..n-1 are
    leaves, new ids allocated in topological order)."""
    n = tree.n_leaves
    ssa_of = {v: v for v in range(n)}
    pairs = []
    for v in tree.topo_order():
        if v < n:
            continue
        a, b = tree.children[v]
        pairs.append((ssa_of[a], ssa_of[b]))
        ssa_of[v] = n + len(pairs) - 1
    return pairs


def anneal(tree: ContractionTree, sliced=frozenset(),
           time_budget: float = 30.0, t0: float = 2.0, t1: float = 0.02,
           width_target: float = None, width_lambda: float = 1.0,
           seed: int = 0, verbose: bool = False) -> ContractionTree:
    """Simulated-annealing restructuring of the tree (native
    ``tree_anneal``; no-op when the library is unavailable).  Treats
    ``sliced`` indices as size 1.  Returns a new tree (does not mutate).
    """
    import time as _t

    from hybridq_tpu_torch import native

    if not native.hgp_available() or tree.n_leaves < 4:
        return tree
    inputs = tree.inputs
    wt = math.log2(width_target) if width_target else 1e9

    ssa = tree_to_ssa(tree)
    t_start = _t.time()
    rng = np.random.default_rng(seed)

    # Sweeps/second depends on tree size only — calibrate once per size
    # class and cache, so short-budget calls (the slicer's per-batch
    # improvements) don't burn their budget re-measuring.
    rate_key = (tree.n_leaves // 64, len(tree.size_dict) // 128)
    rate = _ANNEAL_RATE_CACHE.get(rate_key)
    best_ssa, best_f = ssa, tree.total_flops(sliced)
    best_f = math.log2(max(best_f, 1.0))
    if rate is None:
        cal = 200
        t0_cal = _t.time()
        best_ssa, best_f, _ = native.anneal_tree(
            inputs, tree.output, tree.size_dict, ssa, sliced=sliced,
            n_sweeps=cal, t0=t0, t1=t0 * 0.8, width_target=wt,
            width_lambda=width_lambda, seed=seed)
        rate = cal / max(_t.time() - t0_cal, 1e-3)
        _ANNEAL_RATE_CACHE[rate_key] = rate

    remaining = time_budget - (_t.time() - t_start)
    if remaining > 0:
        # One full cooling run on most of the budget; patience only
        # prunes a genuinely dead cold tail (SA plateaus during the hot
        # phase are normal, not convergence).
        sweeps = max(200, int(rate * remaining * 0.7))
        out_ssa, f, w = native.anneal_tree(
            inputs, tree.output, tree.size_dict, best_ssa,
            sliced=sliced, n_sweeps=sweeps, t0=t0, t1=t1,
            width_target=wt, width_lambda=width_lambda,
            seed=int(rng.integers(2**31)),
            patience=max(10000, sweeps // 2))
        if f < best_f:
            best_ssa, best_f = out_ssa, f
        # Cold polish with whatever remains.
        remaining = time_budget - (_t.time() - t_start)
        if remaining > 0.5:
            sweeps = max(200, int(rate * remaining))
            out_ssa, f, w = native.anneal_tree(
                inputs, tree.output, tree.size_dict, best_ssa,
                sliced=sliced, n_sweeps=sweeps, t0=max(t1 * 10, 0.2),
                t1=t1, width_target=wt, width_lambda=width_lambda,
                seed=int(rng.integers(2**31)),
                patience=max(10000, sweeps // 2))
            if f < best_f:
                best_ssa, best_f = out_ssa, f
    new = ContractionTree(inputs, tree.output, tree.size_dict,
                          _ssa_to_linear(best_ssa, tree.n_leaves))

    def _obj(t):
        # Same penalized objective the annealer optimizes — comparing
        # raw flops alone would let width creep back up between slices.
        o = math.log2(max(t.total_flops(sliced), 1.0))
        w = math.log2(max(t.max_size(sliced), 1.0))
        if w > wt:
            o += width_lambda * (w - wt)
        return o

    old_o, new_o = _obj(tree), _obj(new)
    if verbose:
        import sys
        print(f"# anneal: obj {old_o:.1f} -> {new_o:.1f}",
              file=sys.stderr)
    return new if new_o <= old_o else tree


def find_path(inputs, output, size_dict, methods=('greedy', 'bisection'),
              max_repeats: int = 16, minimize: str = 'combo', seed=None,
              parallel=None, verbose: bool = False) -> ContractionTree:
    """Best-of-N contraction tree for the given network.

    ``parallel``: number of worker threads for the bisection restarts
    (True = all cores).  The native partitioner releases the GIL, so
    restarts scale across host cores — the analog of the reference's
    per-rank optimizer Pool (``simulation_mpi.py:267-304``).
    """
    rng = np.random.default_rng(seed)
    if len(inputs) <= 2:
        return ContractionTree(inputs, output, size_dict,
                               [(0, 1)] if len(inputs) == 2 else [])
    candidates = []
    if 'greedy' in methods or 'kahypar' in methods:
        for p in _greedy_paths(inputs, output, size_dict, max_repeats,
                               rng):
            candidates.append(p)
    if ('bisection' in methods or 'kahypar' in methods) and \
            len(inputs) > 3:
        from hybridq_tpu_torch import native
        # The native partitioner is fast enough for a full restart
        # budget; the pure-Python spectral fallback gets fewer trials.
        reps = max_repeats if native.hgp_available() else \
            max(1, max_repeats // 4)
        if parallel is True:
            import os as _os
            parallel = _os.cpu_count() or 1
        n_workers = max(int(parallel or 1), 1)
        if n_workers > 1 and native.hgp_available():
            from concurrent.futures import ThreadPoolExecutor

            rngs = [np.random.default_rng(rng.integers(2**31))
                    for _ in range(reps)]

            def one(r):
                try:
                    return _bisection_path(inputs, output, size_dict, r)
                except Exception:
                    return None

            with ThreadPoolExecutor(n_workers) as ex:
                for p in ex.map(one, rngs):
                    if p is not None:
                        candidates.append(p)
        else:
            for _ in range(reps):
                try:
                    candidates.append(
                        _bisection_path(inputs, output, size_dict, rng))
                except Exception:
                    pass
    if not candidates:
        # trivial left-to-right path
        candidates.append([(0, 1)] * (len(inputs) - 1))

    def score(tree):
        f, s = tree.total_flops(), tree.max_size()
        if minimize == 'flops':
            return (f, s)
        if minimize == 'size':
            return (s, f)
        return (math.log2(max(f, 1)) + math.log2(max(s, 1)), f)

    best = None
    best_score = None
    for p in candidates:
        try:
            tree = ContractionTree(inputs, output, size_dict, p)
        except Exception:
            continue
        sc = score(tree)
        if best is None or sc < best_score:
            best, best_score = tree, sc
    if best is None:
        raise RuntimeError("No valid contraction path found.")
    return best
