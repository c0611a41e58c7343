// tree_anneal — simulated annealing over contraction trees (C++17).
//
// Local-rotation annealing on the binary contraction tree, the
// restructuring engine that closes the gap between partition-based
// candidate trees and state-of-the-art paths on circuit-shaped tensor
// networks (cf. cotengra's `simulated_anneal`; the reference reaches
// comparable quality through cotengra's Bayesian hyper-optimization,
// hybridq/circuit/simulation/simulation.py:920-983).
//
// Three entry points:
//   tn_anneal        — anneal a tree under fixed sliced weights;
//   tn_slice_anneal  — slice-and-anneal descent: greedily slice the
//                      cheapest index (total-flops scored) from the
//                      largest intermediate, re-anneal, repeat until the
//                      width target is met (cotengra's slicing_reconf,
//                      reference slicing at simulation.py:1037-1076);
//   tn_joint_anneal  — joint annealing over (tree, slice set): the
//                      slice set itself is a Metropolis move, so tree
//                      structure and cuts co-optimize under the true
//                      total sliced cost (the fix for flop-optimal
//                      trees slicing catastrophically).
//
// Tree model matches path.py:ContractionTree exactly:
//   inds(v)  = indices under v retained (appear outside v or in output)
//   flops(v) = prod of sizes of union(inds(left), inds(right))
//   total    = sum over internal nodes of flops(v)
// Sliced indices have zero log-weight (they are fixed, not contracted).
//
// Move: pick internal v with children (A, B), B internal = (C, D);
// propose ((A,C),D) or ((A,D),C).  Only node B changes:
//   inds(B') = (inds(A) | inds(C)) & (inds(v) | inds(D))
// (an index under B' is retained iff it reaches outside B', and outside
// B' within-the-tree means subtree D or outside v, plus the output —
// both captured by inds(v) | inds(D)).
//
// Objective: log2(total flops) + width_lambda * max(0, width - target).
// Metropolis acceptance with geometric cooling, best-tree tracking.
// Proposal sizes are hard-capped and the running total is exactly
// resummed periodically (incremental updates across vastly different
// magnitudes otherwise suffer catastrophic cancellation).

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <random>
#include <set>
#include <vector>

// Exact bitmask-DP subpath (tnopt.cpp, same shared library) — the inner
// loop of subtree reconfiguration.
extern "C" int tn_optimal_path(int n_tensors, int n_inds,
                               const uint32_t* pinmask,
                               const uint8_t* is_out, const double* logw,
                               int* out_pairs);

namespace {

using std::vector;

struct Bits {
    vector<uint64_t> w;
    explicit Bits(int words = 0) : w(words, 0) {}
    void set(int i) { w[i >> 6] |= uint64_t{1} << (i & 63); }
    bool get(int i) const {
        return (w[i >> 6] >> (i & 63)) & 1;
    }
};

inline void bits_or(const Bits& a, const Bits& b, Bits& out) {
    const size_t n = a.w.size();
    for (size_t k = 0; k < n; k++) out.w[k] = a.w[k] | b.w[k];
}

inline void bits_or_and(const Bits& a, const Bits& b, const Bits& c,
                        const Bits& d, Bits& out) {
    // out = (a | b) & (c | d)
    const size_t n = a.w.size();
    for (size_t k = 0; k < n; k++)
        out.w[k] = (a.w[k] | b.w[k]) & (c.w[k] | d.w[k]);
}

struct Anneal {
    int n = 0;  // leaves; nodes: 2n-1
    int n_inds = 0;
    int words = 0;
    vector<int> left, right, parent;
    int root = 0;
    vector<Bits> inds;
    vector<double> logflops;   // internal nodes
    vector<double> logsize;
    vector<double> lw;         // effective per-index log2 weights
    vector<double> base_lw;    // original weights (for un-slicing)
    vector<char> sliced;       // current slice set (joint anneal)
    double slice_bits = 0;     // sum of base_lw over sliced indices
    Bits out_mask{0};
    std::multiset<double> sizes;
    double total = 0;
    // Sliceability pressure: sum over nodes of max(0, logsize - target).
    // Minimizing the *count/depth* of oversized nodes (not just the max)
    // drives the tree toward structures whose width collapses with few
    // sliced indices.
    double excess_target = 1e9;
    double excess_lambda = 0.0;
    double sum_excess = 0;
    std::mt19937 rng;

    double excess_of(double ls) const {
        return ls > excess_target ? ls - excess_target : 0.0;
    }

    double weight_of(const Bits& m) const {
        double s = 0;
        for (int k = 0; k < words; k++) {
            uint64_t x = m.w[k];
            while (x) {
                const int b = __builtin_ctzll(x);
                s += lw[64 * k + b];
                x &= x - 1;
            }
        }
        return s;
    }

    // Build from leaf index lists + SSA pairs.  Returns 0 on success.
    int init(int n_tensors, int n_inds_, const int* xinds,
             const int* ind_ids, const double* logw,
             const uint8_t* is_out, const uint8_t* is_sliced,
             const int* ssa_in, unsigned seed) {
        n = n_tensors;
        n_inds = n_inds_;
        words = (n_inds + 63) / 64;
        rng.seed(seed);
        const int total_nodes = 2 * n - 1;
        lw.assign(n_inds, 0.0);
        for (int i = 0; i < n_inds; i++)
            lw[i] = (is_sliced && is_sliced[i]) ? 0.0 : logw[i];
        left.assign(total_nodes, -1);
        right.assign(total_nodes, -1);
        parent.assign(total_nodes, -1);
        inds.assign(total_nodes, Bits(words));
        logflops.assign(total_nodes, 0.0);
        logsize.assign(total_nodes, 0.0);
        for (int v = 0; v < n - 1; v++) {
            const int a = ssa_in[2 * v], b = ssa_in[2 * v + 1];
            const int id = n + v;
            if (a < 0 || a >= id || b < 0 || b >= id || a == b) return 2;
            left[id] = a;
            right[id] = b;
            parent[a] = id;
            parent[b] = id;
        }
        root = total_nodes - 1;
        for (int v = 0; v < total_nodes; v++)
            if (parent[v] < 0 && v != root) return 3;

        out_mask = Bits(words);
        for (int i = 0; i < n_inds; i++)
            if (is_out[i]) out_mask.set(i);
        vector<Bits> U(total_nodes, Bits(words));
        for (int v = 0; v < n; v++)
            for (int k = xinds[v]; k < xinds[v + 1]; k++) {
                if (ind_ids[k] < 0 || ind_ids[k] >= n_inds) return 4;
                U[v].set(ind_ids[k]);
            }
        for (int v = n; v < total_nodes; v++)
            bits_or(U[left[v]], U[right[v]], U[v]);
        vector<Bits> uout(total_nodes, Bits(words));
        for (int v = total_nodes - 1; v >= n; v--) {
            bits_or(uout[v], U[right[v]], uout[left[v]]);
            bits_or(uout[v], U[left[v]], uout[right[v]]);
        }
        for (int v = 0; v < total_nodes; v++) {
            Bits keep(words);
            bits_or(out_mask, uout[v], keep);
            for (int k = 0; k < words; k++)
                inds[v].w[k] = U[v].w[k] & keep.w[k];
        }
        recompute_costs();
        return 0;
    }

    double node_flops_exp(int v) const {
        Bits u(words);
        bits_or(inds[left[v]], inds[right[v]], u);
        return weight_of(u);
    }

    // Recompute logsize/logflops/total/sizes from inds + lw.
    void recompute_costs() {
        const int total_nodes = 2 * n - 1;
        sizes.clear();
        total = 0;
        sum_excess = 0;
        for (int v = 0; v < total_nodes; v++) {
            logsize[v] = weight_of(inds[v]);
            sizes.insert(logsize[v]);
            sum_excess += excess_of(logsize[v]);
        }
        for (int v = n; v < total_nodes; v++) {
            logflops[v] = node_flops_exp(v);
            total += std::exp2(logflops[v]);
        }
        compute_leafcnt();
    }

    vector<int> leafcnt;  // leaves under each node

    void compute_leafcnt() {
        const int total_nodes = 2 * n - 1;
        leafcnt.assign(total_nodes, 1);
        vector<int> stack = {root}, post;
        while (!stack.empty()) {
            int v = stack.back();
            stack.pop_back();
            if (v < n) continue;
            post.push_back(v);
            stack.push_back(left[v]);
            stack.push_back(right[v]);
        }
        for (auto it = post.rbegin(); it != post.rend(); ++it)
            leafcnt[*it] = leafcnt[left[*it]] + leafcnt[right[*it]];
    }

    // ---- exact-DP subtree reconfiguration ---------------------------
    //
    // cotengra's `subtree_reconfigure` under the *current* (sliced)
    // weights: take the frontier of <= max_subtree super-leaves below an
    // expensive node, solve the sub-contraction exactly with the
    // bitmask DP, and splice the optimal subtree in when the full
    // objective improves.  Node ids are reused so best-state snapshots
    // (children arrays) stay valid.

    void frontier_of(int v, int K, vector<int>& fr) const {
        fr.clear();
        if (v < n) {
            fr.push_back(v);
            return;
        }
        fr.push_back(left[v]);
        fr.push_back(right[v]);
        while ((int)fr.size() < K) {
            int bi = -1, bl = 1;
            for (int i = 0; i < (int)fr.size(); i++) {
                const int u = fr[i];
                if (u >= n && leafcnt[u] > bl) {
                    bl = leafcnt[u];
                    bi = i;
                }
            }
            if (bi < 0) break;
            const int u = fr[bi];
            fr[bi] = left[u];
            fr.push_back(right[u]);
        }
    }

    // Try to reconfigure the subtree above node v.  Returns true if the
    // tree changed; cur_obj is updated in place.
    bool reconfigure_node(int v, int max_subtree, double width_target,
                          double width_lambda, bool joint,
                          double& cur_obj, vector<int>& fr,
                          vector<int>& region, vector<int>& ids,
                          vector<uint32_t>& pin, vector<uint8_t>& iso,
                          vector<double>& w, vector<int>& pairs) {
        if (v < n) return false;
        frontier_of(v, max_subtree, fr);
        const int m = (int)fr.size();
        if (m < 3 || m > 16) return false;

        // Internal nodes strictly inside the region (v included).
        region.clear();
        vector<int> stack = {v};
        while (!stack.empty()) {
            const int u = stack.back();
            stack.pop_back();
            bool is_frontier = false;
            for (int f : fr)
                if (f == u) {
                    is_frontier = true;
                    break;
                }
            if (is_frontier) continue;
            region.push_back(u);
            stack.push_back(left[u]);
            stack.push_back(right[u]);
        }
        if ((int)region.size() != m - 1) return false;  // inconsistent

        // Index ids appearing in any frontier member's retained set.
        ids.clear();
        {
            Bits all(words);
            for (int f : fr) bits_or(all, inds[f], all);
            for (int k = 0; k < words; k++) {
                uint64_t x = all.w[k];
                while (x) {
                    const int b = __builtin_ctzll(x);
                    ids.push_back(64 * k + b);
                    x &= x - 1;
                }
            }
        }
        const int ni = (int)ids.size();
        pin.assign(ni, 0);
        iso.assign(ni, 0);
        w.assign(ni, 0.0);
        for (int j = 0; j < ni; j++) {
            const int i = ids[j];
            for (int t = 0; t < m; t++)
                if (inds[fr[t]].get(i)) pin[j] |= uint32_t{1} << t;
            iso[j] = inds[v].get(i) ? 1 : 0;
            w[j] = lw[i];
        }
        pairs.assign(2 * (m - 1), -1);
        if (tn_optimal_path(m, ni, pin.data(), iso.data(), w.data(),
                            pairs.data()))
            return false;

        // Candidate internal nodes: local slot s (0..m-2) holds the
        // s-th DP pair; slot m-2 is the root (takes id v).
        // local node id t < m -> frontier member; t >= m -> slot t - m.
        vector<Bits> cu(m - 1, Bits(words));   // union of inds under slot
        vector<Bits> cinds(m - 1, Bits(words));
        vector<double> csize(m - 1), cflops(m - 1);
        Bits keep(words), tmp(words);
        // union over ALL frontier members (for the keep complement).
        Bits all(words);
        for (int f : fr) bits_or(all, inds[f], all);

        auto u_of = [&](int t) -> const Bits& {
            return t < m ? inds[fr[t]] : cu[t - m];
        };
        for (int s = 0; s < m - 1; s++) {
            const int a = pairs[2 * s], b = pairs[2 * s + 1];
            if (a < 0 || b < 0 || a >= m + s || b >= m + s) return false;
            bits_or(u_of(a), u_of(b), cu[s]);
            // keep = inds[v] | out | union(frontier not under s)
            //      = inds[v] | out | (all & ~cu[s]) | (parts of cu
            //        shared with outside)  — (all & ~under) suffices
            //        because any retained index under s that also
            //        appears outside s within the region is in `all`
            //        via that other member.
            for (int k = 0; k < words; k++) {
                // frontier members not under s contribute all-bits not
                // exclusively under s; exact complement needs per-member
                // test, so compute directly:
                keep.w[k] = inds[v].w[k] | out_mask.w[k];
            }
            // add inds[f] for frontier members NOT under slot s
            {
                // membership: walk local tree
                // mark members under s
                vector<char> under(m, 0);
                vector<int> st2 = {m + s};
                while (!st2.empty()) {
                    const int t = st2.back();
                    st2.pop_back();
                    if (t < m) {
                        under[t] = 1;
                        continue;
                    }
                    const int s2 = t - m;
                    st2.push_back(pairs[2 * s2]);
                    st2.push_back(pairs[2 * s2 + 1]);
                }
                for (int t = 0; t < m; t++)
                    if (!under[t]) bits_or(keep, inds[fr[t]], keep);
            }
            for (int k = 0; k < words; k++)
                cinds[s].w[k] = cu[s].w[k] & keep.w[k];
            csize[s] = weight_of(cinds[s]);
            bits_or((pairs[2 * s] < m ? inds[fr[pairs[2 * s]]]
                                      : cinds[pairs[2 * s] - m]),
                    (pairs[2 * s + 1] < m ? inds[fr[pairs[2 * s + 1]]]
                                          : cinds[pairs[2 * s + 1] - m]),
                    tmp);
            cflops[s] = weight_of(tmp);
        }
        // Root slot must reproduce inds[v] (same leafset, same keep).
        // Its retained set equals inds[v] by construction; trust but
        // keep v's stored inds (identical leaf coverage).

        // Objective delta: replace region's sizes/flops with candidate.
        double new_total = total;
        double new_excess = sum_excess;
        for (int u : region) {
            new_total -= std::exp2(logflops[u]);
            if (u != v) new_excess -= excess_of(logsize[u]);
        }
        for (int s = 0; s < m - 1; s++) {
            new_total += std::exp2(cflops[s]);
            if (s != m - 2) new_excess += excess_of(csize[s]);
        }
        // Width: update the multiset copy lazily — compute trial width.
        // Remove old non-v sizes, add new non-root sizes.
        for (int u : region)
            if (u != v) sizes.erase(sizes.find(logsize[u]));
        for (int s = 0; s < m - 2; s++) sizes.insert(csize[s]);
        const double new_width = width();
        const double new_obj =
            joint ? joint_obj(new_total, slice_bits, new_width,
                              width_target, width_lambda, new_excess)
                  : objective(new_total, new_width, width_target,
                              width_lambda, new_excess);
        if (new_obj >= cur_obj - 1e-12) {
            // revert multiset
            for (int s = 0; s < m - 2; s++)
                sizes.erase(sizes.find(csize[s]));
            for (int u : region)
                if (u != v) sizes.insert(logsize[u]);
            return false;
        }
        // Commit: assign slot ids (root -> v, others -> region ids).
        ids.clear();  // reuse as slot -> node id map
        ids.resize(m - 1);
        {
            int k = 0;
            for (int u : region)
                if (u != v) ids[k++] = u;
            ids[m - 2] = v;
        }
        auto node_of = [&](int t) { return t < m ? fr[t] : ids[t - m]; };
        for (int s = 0; s < m - 1; s++) {
            const int u = ids[s];
            const int a = node_of(pairs[2 * s]);
            const int b = node_of(pairs[2 * s + 1]);
            left[u] = a;
            right[u] = b;
            parent[a] = u;
            parent[b] = u;
            if (s != m - 2) {
                inds[u] = cinds[s];
                logsize[u] = csize[s];
            }
            logflops[u] = cflops[s];
            leafcnt[u] = leafcnt[a] + leafcnt[b];
        }
        total = new_total;
        sum_excess = new_excess;
        cur_obj = new_obj;
        return true;
    }

    // One reconfiguration pass over the most expensive nodes.
    // ``deadline`` (steady-clock, optional) bounds the pass.
    std::chrono::steady_clock::time_point reconf_deadline{};
    bool has_deadline = false;

    int reconfigure_pass(int max_subtree, double width_target,
                         double width_lambda, bool joint,
                         double& cur_obj, int max_nodes = 0) {
        const int total_nodes = 2 * n - 1;
        vector<std::pair<double, int>> order;
        order.reserve(n - 1);
        for (int v = n; v < total_nodes; v++)
            order.emplace_back(-logflops[v], v);
        std::sort(order.begin(), order.end());
        if (max_nodes <= 0) max_nodes = n - 1;
        vector<int> fr, region, ids, pairs;
        vector<uint32_t> pin;
        vector<uint8_t> iso;
        vector<double> w;
        int changed = 0;
        for (int k = 0; k < (int)order.size() && k < max_nodes; k++) {
            if (has_deadline && (k & 7) == 0 &&
                std::chrono::steady_clock::now() > reconf_deadline)
                break;
            if (reconfigure_node(order[k].second, max_subtree,
                                 width_target, width_lambda, joint,
                                 cur_obj, fr, region, ids, pin, iso, w,
                                 pairs))
                changed++;
        }
        return changed;
    }

    double width() const { return *sizes.rbegin(); }

    double objective(double tot, double w, double width_target,
                     double width_lambda, double excess) const {
        double o = std::log2(std::max(tot, 1.0));
        if (w > width_target) o += width_lambda * (w - width_target);
        o += excess_lambda * excess;
        return o;
    }

    // One annealing phase; keeps the best tree *in place* (the tree is
    // left at the best state found, not the last state).
    void run(int n_steps, double t0, double t1, double width_target,
             double width_lambda, int patience) {
        const int total_nodes = 2 * n - 1;
        double init_max_flops = 0;
        for (int v = n; v < total_nodes; v++)
            init_max_flops = std::max(init_max_flops, logflops[v]);
        const double cap = std::max(
            width_target < 1e8 ? width_target + 8.0 : 0.0,
            init_max_flops + 2.0);

        double cur_obj = objective(total, width(), width_target,
                                   width_lambda, sum_excess);
        vector<int> best_left(left), best_right(right);
        double best_obj = cur_obj;
        bool improved_since_snapshot = false;

        std::uniform_real_distribution<double> unif(0.0, 1.0);
        std::uniform_int_distribution<int> pick(n, total_nodes - 1);
        const double decay =
            (n_steps > 1) ? std::pow(t1 / std::max(t0, 1e-9),
                                     1.0 / (n_steps - 1))
                          : 1.0;
        double temp = t0;
        Bits newB(words), tmp(words);
        const int proposals = std::max(1, n - 1);
        std::uniform_real_distribution<double> tie(0.0, 1e-12);

        int last_improve = 0;
        for (int sweep = 0; sweep < n_steps; sweep++, temp *= decay) {
            if (patience > 0 && sweep - last_improve > patience) break;
            if ((sweep & 31) == 0) {
                total = 0;
                for (int v = n; v < total_nodes; v++)
                    total += std::exp2(logflops[v]);
                cur_obj = objective(total, width(), width_target,
                                    width_lambda, sum_excess);
            }
            for (int it = 0; it < proposals; it++) {
                const int v = pick(rng);
                int A = left[v], B = right[v];
                if (unif(rng) < 0.5) std::swap(A, B);
                if (B < n) {
                    if (A < n) continue;
                    std::swap(A, B);
                }
                int C = left[B], D = right[B];
                if (unif(rng) < 0.5) std::swap(C, D);
                bits_or_and(inds[A], inds[C], inds[v], inds[D], newB);
                const double szB = weight_of(newB);
                bits_or(inds[A], inds[C], tmp);
                const double fB = weight_of(tmp);
                if (fB > cap) continue;
                bits_or(newB, inds[D], tmp);
                const double fV = weight_of(tmp);
                if (fV > cap) continue;

                const double new_total = total -
                    std::exp2(logflops[B]) - std::exp2(logflops[v]) +
                    std::exp2(fB) + std::exp2(fV);
                auto itB = sizes.find(logsize[B]);
                sizes.erase(itB);
                sizes.insert(szB);
                const double new_excess = sum_excess -
                    excess_of(logsize[B]) + excess_of(szB);
                const double new_obj = objective(
                    new_total, width(), width_target, width_lambda,
                    new_excess);
                const double d = new_obj - cur_obj;
                if (d <= 0 ||
                    (temp > 0 && unif(rng) < std::exp(-d / temp))) {
                    left[v] = B;
                    right[v] = D;
                    left[B] = A;
                    right[B] = C;
                    parent[A] = B;
                    parent[C] = B;
                    parent[B] = v;
                    parent[D] = v;
                    inds[B] = newB;
                    sum_excess = new_excess;
                    logsize[B] = szB;
                    logflops[B] = fB;
                    logflops[v] = fV;
                    leafcnt[B] = leafcnt[A] + leafcnt[C];
                    total = new_total;
                    cur_obj = new_obj;
                    if (cur_obj < best_obj - 1e-12) {
                        best_obj = cur_obj;
                        best_left = left;
                        best_right = right;
                        improved_since_snapshot = true;
                        last_improve = sweep;
                    }
                } else {
                    auto itN = sizes.find(szB);
                    sizes.erase(itN);
                    sizes.insert(logsize[B]);
                }
            }
            // --- exact-DP subtree reconfiguration, interleaved ---
            // (cotengra's anneal alternates rotations with subtree
            // reconfigure; the DP escapes local minima rotations can't.)
            if (reconf_every > 0 &&
                (sweep % reconf_every) == reconf_every - 1) {
                if (reconfigure_pass(reconf_subtree, width_target,
                                     width_lambda, false, cur_obj,
                                     reconf_nodes) &&
                    cur_obj < best_obj - 1e-12) {
                    best_obj = cur_obj;
                    best_left = left;
                    best_right = right;
                    improved_since_snapshot = true;
                    last_improve = sweep;
                }
            }
        }
        // Restore the best tree and rebuild exact costs/ind sets.
        if (improved_since_snapshot || best_obj < cur_obj) {
            rebuild_from(best_left, best_right);
        }
    }

    // Interleaved-reconfiguration knobs (see run/run_joint), overridable
    // via env for tuning experiments.  OFF by default: a DP pass costs
    // ~1 ms/node vs ~0.2 ms per Metropolis sweep; measured on
    // sycamore-53 d20 the interleave starved the joint search and LOST
    // 9 bits of total flops at a fixed wall budget.  Reconfiguration
    // pays as a separate strictly-improving descent on the final tree
    // (``tn_reconfigure``), which the Python driver budgets explicitly.
    int reconf_every = env_int("HYBRIDQ_RECONF_EVERY", 0);
    int reconf_subtree = env_int("HYBRIDQ_RECONF_SUBTREE", 10);
    int reconf_nodes = env_int("HYBRIDQ_RECONF_NODES", 16);

    static int env_int(const char* name, int dflt) {
        const char* s = std::getenv(name);
        return s && *s ? std::atoi(s) : dflt;
    }

    // Reset structure to given children arrays; recompute inds + costs.
    void rebuild_from(const vector<int>& l, const vector<int>& r) {
        const int total_nodes = 2 * n - 1;
        left = l;
        right = r;
        for (int v = n; v < total_nodes; v++) {
            parent[left[v]] = v;
            parent[right[v]] = v;
        }
        // Recompute inds from leaves (leaf inds are invariant).
        vector<Bits> U(total_nodes, Bits(words));
        for (int v = 0; v < n; v++) U[v] = inds[v];  // leaves retained
        // NOTE: leaf inds(v) == leaf index sets (never change).
        vector<char> done(total_nodes, 0);
        // children-before-parents order via iterative post-order
        vector<int> stack = {root}, post;
        while (!stack.empty()) {
            int v = stack.back();
            stack.pop_back();
            if (v < n) continue;
            post.push_back(v);
            stack.push_back(left[v]);
            stack.push_back(right[v]);
        }
        std::reverse(post.begin(), post.end());
        for (int v : post) bits_or(U[left[v]], U[right[v]], U[v]);
        vector<Bits> uout(total_nodes, Bits(words));
        for (auto it = post.rbegin(); it != post.rend(); ++it) {
            const int v = *it;
            bits_or(uout[v], U[right[v]], uout[left[v]]);
            bits_or(uout[v], U[left[v]], uout[right[v]]);
        }
        for (int v = 0; v < total_nodes; v++) {
            Bits keep(words);
            bits_or(out_mask, uout[v], keep);
            for (int k = 0; k < words; k++)
                inds[v].w[k] = U[v].w[k] & keep.w[k];
        }
        recompute_costs();
    }

    // Emit the current tree as SSA pairs.
    int emit(int* ssa_out) const {
        const int total_nodes = 2 * n - 1;
        vector<int> ssa_id(total_nodes, -1);
        for (int v = 0; v < n; v++) ssa_id[v] = v;
        vector<int> stack = {root}, post;
        while (!stack.empty()) {
            int v = stack.back();
            stack.pop_back();
            if (v < n) continue;
            post.push_back(v);
            stack.push_back(left[v]);
            stack.push_back(right[v]);
        }
        std::reverse(post.begin(), post.end());
        int next_id = n, k = 0;
        for (int v : post) {
            ssa_out[2 * k] = ssa_id[left[v]];
            ssa_out[2 * k + 1] = ssa_id[right[v]];
            if (ssa_out[2 * k] < 0 || ssa_out[2 * k + 1] < 0) return 5;
            ssa_id[v] = next_id++;
            k++;
        }
        return (k == n - 1) ? 0 : 6;
    }

    // Greedily pick the next slice index: candidates are the non-output
    // non-sliced indices of the largest intermediate; score = total
    // flops after zeroing the index.  Returns -1 if none.
    int pick_slice(const vector<char>& sliced_flag) const {
        const int total_nodes = 2 * n - 1;
        int largest = 0;
        for (int v = 1; v < total_nodes; v++)
            if (logsize[v] > logsize[largest]) largest = v;
        double best_total = 0;
        int best = -1;
        for (int i = 0; i < n_inds; i++) {
            if (!inds[largest].get(i) || sliced_flag[i] ||
                out_mask.get(i) || lw[i] == 0.0)
                continue;
            double tot = 0;
            Bits u(words);
            for (int v = n; v < total_nodes; v++) {
                bits_or(inds[left[v]], inds[right[v]], u);
                const double f =
                    logflops[v] - (u.get(i) ? lw[i] : 0.0);
                tot += std::exp2(f);
            }
            if (best < 0 || tot < best_total) {
                best = i;
                best_total = tot;
            }
        }
        return best;
    }

    void apply_slice(int i) {
        lw[i] = 0.0;
        recompute_costs();
    }

    // ---- joint (tree + slice set) annealing ------------------------

    void init_joint(const double* logw, const uint8_t* is_sliced) {
        base_lw.assign(logw, logw + n_inds);
        sliced.assign(n_inds, 0);
        slice_bits = 0;
        for (int i = 0; i < n_inds; i++)
            if (is_sliced && is_sliced[i]) {
                sliced[i] = 1;
                slice_bits += base_lw[i];
            }
    }

    // Residual total + width + excess if index i toggles its state.
    void trial_slice(int i, bool to_sliced, double& new_total,
                     double& new_width, double& new_excess) const {
        const double w = base_lw[i] * (to_sliced ? -1.0 : 1.0);
        const int total_nodes = 2 * n - 1;
        double tot = 0, wmax = 0, exc = 0;
        for (int v = 0; v < total_nodes; v++) {
            double ls = logsize[v];
            if (inds[v].get(i)) ls += w;
            if (ls > wmax) wmax = ls;
            exc += excess_of(ls);
        }
        for (int v = n; v < total_nodes; v++) {
            double f = logflops[v];
            if (inds[left[v]].get(i) || inds[right[v]].get(i)) f += w;
            tot += std::exp2(f);
        }
        new_total = tot;
        new_width = wmax;
        new_excess = exc;
    }

    // Residual total/width/excess if sliced index i is released AND
    // unsliced index j is cut — one combined move, so the chain never
    // has to cross the infeasible intermediate state that blocks
    // sequential remove-then-add at low temperature.
    void trial_swap(int i, int j, double& new_total, double& new_width,
                    double& new_excess) const {
        const double wi = base_lw[i];  // released: weight returns
        const double wj = base_lw[j];  // cut: weight vanishes
        const int total_nodes = 2 * n - 1;
        double tot = 0, wmax = 0, exc = 0;
        for (int v = 0; v < total_nodes; v++) {
            double ls = logsize[v];
            if (inds[v].get(i)) ls += wi;
            if (inds[v].get(j)) ls -= wj;
            if (ls > wmax) wmax = ls;
            exc += excess_of(ls);
        }
        for (int v = n; v < total_nodes; v++) {
            double f = logflops[v];
            if (inds[left[v]].get(i) || inds[right[v]].get(i)) f += wi;
            if (inds[left[v]].get(j) || inds[right[v]].get(j)) f -= wj;
            tot += std::exp2(f);
        }
        new_total = tot;
        new_width = wmax;
        new_excess = exc;
    }

    void commit_slice(int i, bool to_sliced) {
        const double w = base_lw[i] * (to_sliced ? -1.0 : 1.0);
        lw[i] = to_sliced ? 0.0 : base_lw[i];
        const int total_nodes = 2 * n - 1;
        for (int v = 0; v < total_nodes; v++)
            if (inds[v].get(i)) {
                auto it = sizes.find(logsize[v]);
                sizes.erase(it);
                sum_excess -= excess_of(logsize[v]);
                logsize[v] += w;
                sizes.insert(logsize[v]);
                sum_excess += excess_of(logsize[v]);
            }
        total = 0;
        for (int v = n; v < total_nodes; v++) {
            if (inds[left[v]].get(i) || inds[right[v]].get(i))
                logflops[v] += w;
            total += std::exp2(logflops[v]);
        }
        sliced[i] = to_sliced;
        slice_bits += to_sliced ? base_lw[i] : -base_lw[i];
    }

    double joint_obj(double tot, double sl_bits, double w,
                     double target, double lambda,
                     double excess) const {
        double o = std::log2(std::max(tot, 1.0)) + sl_bits;
        if (w > target) o += lambda * (w - target);
        o += excess_lambda * excess;
        return o;
    }

    // Pick a slice-add candidate: a random non-output, non-sliced index
    // of the largest node (or of a random oversized node).
    int pick_add(double target) {
        const int total_nodes = 2 * n - 1;
        int v_big = 0;
        for (int v = 1; v < total_nodes; v++)
            if (logsize[v] > logsize[v_big]) v_big = v;
        int v_pick = v_big;
        if (std::uniform_real_distribution<double>(0, 1)(rng) < 0.5) {
            // any node above target, chosen by reservoir sampling
            int cnt = 0;
            std::uniform_real_distribution<double> u(0, 1);
            for (int v = 0; v < total_nodes; v++)
                if (logsize[v] > target) {
                    cnt++;
                    if (u(rng) < 1.0 / cnt) v_pick = v;
                }
        }
        vector<int> cand;
        for (int i = 0; i < n_inds; i++)
            if (inds[v_pick].get(i) && !sliced[i] && !out_mask.get(i) &&
                base_lw[i] > 0)
                cand.push_back(i);
        if (cand.empty()) return -1;
        return cand[std::uniform_int_distribution<int>(
            0, (int)cand.size() - 1)(rng)];
    }

    // Swap partner: an index to cut on the node that binds when sliced
    // index i is released (the largest node containing i), or on a
    // random i-containing node — the indices that can absorb i's job.
    int pick_swap_add(int i) {
        if (i < 0) return -1;
        const int total_nodes = 2 * n - 1;
        int v_pick = -1;
        if (std::uniform_real_distribution<double>(0, 1)(rng) < 0.5) {
            for (int v = 0; v < total_nodes; v++)
                if (inds[v].get(i) &&
                    (v_pick < 0 || logsize[v] > logsize[v_pick]))
                    v_pick = v;
        } else {
            int cnt = 0;
            std::uniform_real_distribution<double> u(0, 1);
            for (int v = 0; v < total_nodes; v++)
                if (inds[v].get(i)) {
                    cnt++;
                    if (u(rng) < 1.0 / cnt) v_pick = v;
                }
        }
        if (v_pick < 0) return -1;
        vector<int> cand;
        for (int j = 0; j < n_inds; j++)
            if (j != i && inds[v_pick].get(j) && !sliced[j] &&
                !out_mask.get(j) && base_lw[j] > 0)
                cand.push_back(j);
        if (cand.empty()) return -1;
        return cand[std::uniform_int_distribution<int>(
            0, (int)cand.size() - 1)(rng)];
    }

    int pick_remove() {
        vector<int> cand;
        for (int i = 0; i < n_inds; i++)
            if (sliced[i]) cand.push_back(i);
        if (cand.empty()) return -1;
        return cand[std::uniform_int_distribution<int>(
            0, (int)cand.size() - 1)(rng)];
    }

    // Joint annealing over (tree, slice set).  Objective:
    //   log2(2^slice_bits * residual_total) + lambda*max(0, width-target)
    // Tree rotations at fixed slices + Metropolis slice add/remove moves.
    // Ends at the best *feasible* (width <= target) state seen, falling
    // back to the best penalized state.
    void run_joint(int n_steps, double t0, double t1, double target,
                   double lambda, int slice_moves, int max_slices,
                   int patience) {
        const int total_nodes = 2 * n - 1;
        double init_max_flops = 0;
        for (int v = n; v < total_nodes; v++)
            init_max_flops = std::max(init_max_flops, logflops[v]);
        const double cap = std::max(target + 10.0, init_max_flops + 2.0);

        double cur_obj = joint_obj(total, slice_bits, width(), target,
                                   lambda, sum_excess);
        vector<int> best_left(left), best_right(right);
        vector<char> best_sliced(sliced);
        double best_obj = cur_obj;
        bool best_feasible = width() <= target + 1e-9;
        const bool have_best = true;  // start state is a valid fallback

        std::uniform_real_distribution<double> unif(0.0, 1.0);
        std::uniform_int_distribution<int> pick(n, total_nodes - 1);
        const double decay =
            (n_steps > 1) ? std::pow(t1 / std::max(t0, 1e-9),
                                     1.0 / (n_steps - 1))
                          : 1.0;
        double temp = t0;
        Bits newB(words), tmp(words);
        const int proposals = std::max(1, n - 1);
        int last_improve = 0;

        for (int sweep = 0; sweep < n_steps; sweep++, temp *= decay) {
            if (patience > 0 && sweep - last_improve > patience) break;
            if ((sweep & 31) == 0) {
                total = 0;
                for (int v = n; v < total_nodes; v++)
                    total += std::exp2(logflops[v]);
                cur_obj = joint_obj(total, slice_bits, width(), target,
                                    lambda, sum_excess);
            }
            // --- tree rotations (slices fixed) ---
            for (int it = 0; it < proposals; it++) {
                const int v = pick(rng);
                int A = left[v], B = right[v];
                if (unif(rng) < 0.5) std::swap(A, B);
                if (B < n) {
                    if (A < n) continue;
                    std::swap(A, B);
                }
                int C = left[B], D = right[B];
                if (unif(rng) < 0.5) std::swap(C, D);
                bits_or_and(inds[A], inds[C], inds[v], inds[D], newB);
                const double szB = weight_of(newB);
                bits_or(inds[A], inds[C], tmp);
                const double fB = weight_of(tmp);
                if (fB > cap) continue;
                bits_or(newB, inds[D], tmp);
                const double fV = weight_of(tmp);
                if (fV > cap) continue;

                const double new_total = total -
                    std::exp2(logflops[B]) - std::exp2(logflops[v]) +
                    std::exp2(fB) + std::exp2(fV);
                auto itB = sizes.find(logsize[B]);
                sizes.erase(itB);
                sizes.insert(szB);
                const double new_excess = sum_excess -
                    excess_of(logsize[B]) + excess_of(szB);
                const double new_obj = joint_obj(
                    new_total, slice_bits, width(), target, lambda,
                    new_excess);
                const double d = new_obj - cur_obj;
                if (d <= 0 ||
                    (temp > 0 && unif(rng) < std::exp(-d / temp))) {
                    left[v] = B;
                    right[v] = D;
                    left[B] = A;
                    right[B] = C;
                    parent[A] = B;
                    parent[C] = B;
                    parent[B] = v;
                    parent[D] = v;
                    inds[B] = newB;
                    sum_excess = new_excess;
                    logsize[B] = szB;
                    logflops[B] = fB;
                    logflops[v] = fV;
                    leafcnt[B] = leafcnt[A] + leafcnt[C];
                    total = new_total;
                    cur_obj = new_obj;
                } else {
                    auto itN = sizes.find(szB);
                    sizes.erase(itN);
                    sizes.insert(logsize[B]);
                    continue;
                }
                const bool feas = width() <= target + 1e-9;
                if ((feas && !best_feasible) ||
                    (feas == best_feasible &&
                     cur_obj < best_obj - 1e-12)) {
                    best_obj = cur_obj;
                    best_left = left;
                    best_right = right;
                    best_sliced = sliced;
                    best_feasible = feas;
                    last_improve = sweep;
                }
            }
            // --- slice add/remove/swap moves ---
            for (int sm = 0; sm < slice_moves; sm++) {
                int n_sl = 0;
                for (int i = 0; i < n_inds; i++) n_sl += sliced[i];
                // Swap (release one cut, make another) keeps the slice
                // count fixed and explores the set space directly.
                // Cold-phase only: at high temperature swaps churn the
                // cut set faster than the tree rotations can track
                // (measured +8 bits on sycamore-53 d20 when unga­ted).
                const bool infeasible = width() > target + 1e-9;
                const bool do_swap =
                    (!infeasible && n_sl > 0 && temp < 0.08 &&
                     unif(rng) < 0.3);
                if (do_swap) {
                    const int i = pick_remove();
                    const int j = pick_swap_add(i);
                    if (i < 0 || j < 0 || i == j) continue;
                    double new_total, new_width, new_excess;
                    trial_swap(i, j, new_total, new_width, new_excess);
                    const double new_bits =
                        slice_bits - base_lw[i] + base_lw[j];
                    const double new_obj = joint_obj(
                        new_total, new_bits, new_width, target, lambda,
                        new_excess);
                    const double d = new_obj - cur_obj;
                    if (d <= 0 ||
                        (temp > 0 && unif(rng) < std::exp(-d / temp))) {
                        commit_slice(i, false);
                        commit_slice(j, true);
                        cur_obj = new_obj;
                        const bool feas = new_width <= target + 1e-9;
                        if ((feas && !best_feasible) ||
                            (feas == best_feasible &&
                             cur_obj < best_obj - 1e-12)) {
                            best_obj = cur_obj;
                            best_left = left;
                            best_right = right;
                            best_sliced = sliced;
                            best_feasible = feas;
                            last_improve = sweep;
                        }
                    }
                    continue;
                }
                const bool do_add =
                    (infeasible || n_sl == 0 || unif(rng) < 0.5);
                int i = -1;
                bool to_sliced = true;
                if (do_add) {
                    if (n_sl >= max_slices) continue;
                    i = pick_add(target);
                } else {
                    i = pick_remove();
                    to_sliced = false;
                }
                if (i < 0) continue;
                double new_total, new_width, new_excess;
                trial_slice(i, to_sliced, new_total, new_width,
                            new_excess);
                const double new_bits = slice_bits +
                    (to_sliced ? base_lw[i] : -base_lw[i]);
                const double new_obj = joint_obj(
                    new_total, new_bits, new_width, target, lambda,
                    new_excess);
                const double d = new_obj - cur_obj;
                if (d <= 0 ||
                    (temp > 0 && unif(rng) < std::exp(-d / temp))) {
                    commit_slice(i, to_sliced);
                    cur_obj = new_obj;
                    const bool feas = new_width <= target + 1e-9;
                    if ((feas && !best_feasible) ||
                        (feas == best_feasible &&
                         cur_obj < best_obj - 1e-12)) {
                        best_obj = cur_obj;
                        best_left = left;
                        best_right = right;
                        best_sliced = sliced;
                        best_feasible = feas;
                        last_improve = sweep;
                    }
                }
            }
            // --- exact-DP subtree reconfiguration, interleaved ---
            if (reconf_every > 0 &&
                (sweep % reconf_every) == reconf_every - 1) {
                if (reconfigure_pass(reconf_subtree, target, lambda,
                                     true, cur_obj, reconf_nodes)) {
                    const bool feas = width() <= target + 1e-9;
                    if ((feas && !best_feasible) ||
                        (feas == best_feasible &&
                         cur_obj < best_obj - 1e-12)) {
                        best_obj = cur_obj;
                        best_left = left;
                        best_right = right;
                        best_sliced = sliced;
                        best_feasible = feas;
                        last_improve = sweep;
                    }
                }
            }
        }
        // Restore the best state seen.
        if (have_best) {
            for (int i = 0; i < n_inds; i++) {
                sliced[i] = best_sliced[i];
                lw[i] = sliced[i] ? 0.0 : base_lw[i];
            }
            slice_bits = 0;
            for (int i = 0; i < n_inds; i++)
                if (sliced[i]) slice_bits += base_lw[i];
            rebuild_from(best_left, best_right);
        }
    }
};

}  // namespace

extern "C" {

// Anneal a contraction tree (see header comment).  out_stats[2] =
// {log2 total flops, log2 max size} of the returned tree.
int tn_anneal(int n_tensors, int n_inds, const int* xinds,
              const int* ind_ids, const double* logw,
              const uint8_t* is_out, const uint8_t* is_sliced,
              const int* ssa_in, int n_steps, double t0, double t1,
              double width_target, double width_lambda,
              double excess_lambda, unsigned seed,
              int patience, int* ssa_out, double* out_stats) {
    if (n_tensors < 3 || n_inds <= 0) return 1;
    Anneal a;
    int rc = a.init(n_tensors, n_inds, xinds, ind_ids, logw, is_out,
                    is_sliced, ssa_in, seed);
    if (rc) return rc;
    if (excess_lambda > 0) {
        a.excess_target = width_target;
        a.excess_lambda = excess_lambda;
        a.recompute_costs();
    }
    a.run(n_steps, t0, t1, width_target, width_lambda, patience);
    rc = a.emit(ssa_out);
    if (rc) return rc;
    if (out_stats) {
        out_stats[0] = std::log2(std::max(a.total, 1.0));
        out_stats[1] = a.width();
    }
    return 0;
}

// Slice-and-anneal descent.
//   sweeps_per_slice: annealing sweeps between consecutive slices
//   max_slices:       hard cap (error 7 if exceeded)
//   out_sliced:       n_inds flags (includes any input is_sliced)
//   out_stats[3]:     {log2 residual flops, log2 width, n_sliced}
int tn_slice_anneal(int n_tensors, int n_inds, const int* xinds,
                    const int* ind_ids, const double* logw,
                    const uint8_t* is_out, const uint8_t* is_sliced,
                    const int* ssa_in, double target_log2_width,
                    int sweeps_per_slice, int final_sweeps, double t0,
                    double t1, double width_lambda, unsigned seed,
                    int max_slices, int* ssa_out, uint8_t* out_sliced,
                    double* out_stats) {
    if (n_tensors < 3 || n_inds <= 0) return 1;
    Anneal a;
    int rc = a.init(n_tensors, n_inds, xinds, ind_ids, logw, is_out,
                    is_sliced, ssa_in, seed);
    if (rc) return rc;

    vector<char> sliced_flag(n_inds, 0);
    int n_sliced = 0;
    for (int i = 0; i < n_inds; i++)
        if (is_sliced && is_sliced[i]) sliced_flag[i] = 1;

    while (a.width() > target_log2_width + 1e-9) {
        const int i = a.pick_slice(sliced_flag);
        if (i < 0) break;  // only output legs remain oversized
        sliced_flag[i] = 1;
        n_sliced++;
        if (n_sliced > max_slices) return 7;
        a.apply_slice(i);
        a.run(sweeps_per_slice, t0, t1, target_log2_width,
              width_lambda, std::max(1000, sweeps_per_slice / 2));
    }
    if (final_sweeps > 0)
        a.run(final_sweeps, t0 / 2, t1, target_log2_width,
              width_lambda, std::max(10000, final_sweeps / 2));

    rc = a.emit(ssa_out);
    if (rc) return rc;
    for (int i = 0; i < n_inds; i++) out_sliced[i] = sliced_flag[i];
    if (out_stats) {
        out_stats[0] = std::log2(std::max(a.total, 1.0));
        out_stats[1] = a.width();
        out_stats[2] = n_sliced;
    }
    return 0;
}

// Strictly-improving exact-DP subtree reconfiguration descent on a
// (tree, slice set) under the joint sliced objective — cotengra's
// ``subtree_reconfigure`` polish as a standalone budgeted call (the
// Python driver runs it ONCE on the anneal's final best state; running
// it inside every annealing chain starved the Metropolis search).
//   max_subtree:   frontier size solved exactly (<= 16)
//   max_passes:    descent passes (stops earlier at a fixpoint)
//   budget_ms:     wall-clock bound (0 = unbounded)
//   out_stats[3] = {log2 residual flops, log2 width, slice_bits}
int tn_reconfigure(int n_tensors, int n_inds, const int* xinds,
                   const int* ind_ids, const double* logw,
                   const uint8_t* is_out, const uint8_t* is_sliced,
                   const int* ssa_in, double target_log2_width,
                   double width_lambda, int max_subtree, int max_passes,
                   double budget_ms, int* ssa_out, double* out_stats) {
    if (n_tensors < 3 || n_inds <= 0) return 1;
    Anneal a;
    int rc = a.init(n_tensors, n_inds, xinds, ind_ids, logw, is_out,
                    is_sliced, ssa_in, 0);
    if (rc) return rc;
    a.init_joint(logw, is_sliced);
    if (budget_ms > 0) {
        a.has_deadline = true;
        a.reconf_deadline = std::chrono::steady_clock::now() +
            std::chrono::milliseconds((long)budget_ms);
    }
    double cur = a.joint_obj(a.total, a.slice_bits, a.width(),
                             target_log2_width, width_lambda,
                             a.sum_excess);
    if (max_subtree < 4) max_subtree = 4;
    if (max_subtree > 16) max_subtree = 16;
    for (int pass = 0; pass < max_passes; pass++) {
        if (a.has_deadline &&
            std::chrono::steady_clock::now() > a.reconf_deadline)
            break;
        if (!a.reconfigure_pass(max_subtree, target_log2_width,
                                width_lambda, true, cur, 0))
            break;
    }
    rc = a.emit(ssa_out);
    if (rc) return rc;
    if (out_stats) {
        out_stats[0] = std::log2(std::max(a.total, 1.0));
        out_stats[1] = a.width();
        out_stats[2] = a.slice_bits;
    }
    return 0;
}

// Joint annealing over (tree, slice set): tree rotations + Metropolis
// slice add/remove moves under the true sliced-cost objective
//   log2(2^slice_bits * residual_flops) + lambda*max(0, width - target).
// is_sliced seeds the starting slice set (all seeded indices are free to
// be un-sliced).  Returns the best feasible state seen.
//   out_stats[3] = {log2 residual flops, log2 width, slice_bits}
int tn_joint_anneal(int n_tensors, int n_inds, const int* xinds,
                    const int* ind_ids, const double* logw,
                    const uint8_t* is_out, const uint8_t* is_sliced,
                    const int* ssa_in, double target_log2_width,
                    int n_steps, double t0, double t1,
                    double width_lambda, double excess_lambda,
                    int slice_moves_per_sweep,
                    unsigned seed, int max_slices, int patience,
                    int* ssa_out, uint8_t* out_sliced,
                    double* out_stats) {
    if (n_tensors < 3 || n_inds <= 0) return 1;
    Anneal a;
    int rc = a.init(n_tensors, n_inds, xinds, ind_ids, logw, is_out,
                    is_sliced, ssa_in, seed);
    if (rc) return rc;
    if (excess_lambda > 0) {
        a.excess_target = target_log2_width;
        a.excess_lambda = excess_lambda;
        a.recompute_costs();
    }
    a.init_joint(logw, is_sliced);
    a.run_joint(n_steps, t0, t1, target_log2_width, width_lambda,
                slice_moves_per_sweep, max_slices, patience);
    rc = a.emit(ssa_out);
    if (rc) return rc;
    for (int i = 0; i < n_inds; i++) out_sliced[i] = a.sliced[i];
    if (out_stats) {
        out_stats[0] = std::log2(std::max(a.total, 1.0));
        out_stats[1] = a.width();
        out_stats[2] = a.slice_bits;
    }
    return 0;
}

}  // extern "C"
