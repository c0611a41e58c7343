// hgpart — multilevel hypergraph bipartitioner (C++17, no deps).
//
// TPU-native stand-in for KaHyPar, which the reference uses through
// cotengra for tensor-network contraction-path search
// (hybridq/circuit/simulation/simulation.py:920-983: methods=['kahypar',
// 'greedy']).  Path search is host-CPU combinatorics in the reference
// too; this library provides the quality-critical inner loop — balanced
// min-cut hypergraph bisection — as native code, driven from Python via
// ctypes (hybridq_tpu/native/__init__.py).
//
// Algorithm (standard multilevel scheme):
//   1. coarsen: heavy-connectivity pair matching until the graph is
//      small (score(u,v) = sum over shared nets of w(e)/(|e|-1));
//   2. initial partition: repeated greedy region growth + FM;
//   3. uncoarsen: project and refine with Fiduccia–Mattheyses passes
//      (gain heaps, best-prefix rollback, balance constraint).
// Several independent V-cycles run per call; the best balanced cut wins.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <queue>
#include <random>
#include <unordered_map>
#include <vector>

namespace {

using std::vector;

struct HG {
    int n = 0;                    // number of nodes
    vector<int> xpins;            // net -> pin-range offsets (m+1)
    vector<int> pins;             // concatenated node ids
    vector<double> w;             // net weights
    vector<int64_t> nw;           // node weights
    vector<int> xnets, nets;      // node -> incident nets (CSR)

    int m() const { return static_cast<int>(xpins.size()) - 1; }

    void build_incidence() {
        xnets.assign(n + 1, 0);
        for (int p : pins) xnets[p + 1]++;
        for (int i = 0; i < n; i++) xnets[i + 1] += xnets[i];
        nets.resize(pins.size());
        vector<int> fill(xnets.begin(), xnets.end() - 1);
        for (int e = 0; e < m(); e++)
            for (int k = xpins[e]; k < xpins[e + 1]; k++)
                nets[fill[pins[k]]++] = e;
    }
};

double cut_value(const HG& g, const vector<int8_t>& part) {
    double cut = 0;
    for (int e = 0; e < g.m(); e++) {
        bool s0 = false, s1 = false;
        for (int k = g.xpins[e]; k < g.xpins[e + 1]; k++)
            (part[g.pins[k]] ? s1 : s0) = true;
        if (s0 && s1) cut += g.w[e];
    }
    return cut;
}

// ---------------------------------------------------------------- FM --
// 2-way Fiduccia–Mattheyses with lazy max-heaps and best-prefix
// rollback.  Respects per-side weight ceilings.  Returns the cut.
double fm_refine(const HG& g, vector<int8_t>& part, int64_t max_w[2],
                 std::mt19937& rng, int max_passes = 6) {
    const int n = g.n, m = g.m();
    vector<int> cnt0(m), cnt1(m);
    int64_t W[2] = {0, 0};
    for (int u = 0; u < n; u++) W[part[u]] += g.nw[u];
    auto recount = [&]() {
        std::fill(cnt0.begin(), cnt0.end(), 0);
        std::fill(cnt1.begin(), cnt1.end(), 0);
        for (int e = 0; e < m; e++)
            for (int k = g.xpins[e]; k < g.xpins[e + 1]; k++)
                (part[g.pins[k]] ? cnt1[e] : cnt0[e])++;
    };
    recount();
    double cut = cut_value(g, part);
    double best_overall = cut;

    vector<double> gain(n);
    vector<int> version(n, 0);
    vector<int8_t> locked(n);
    std::uniform_real_distribution<double> tie(0.0, 1e-9);

    auto compute_gain = [&](int u) {
        double gn = 0;
        const int8_t p = part[u];
        for (int k = g.xnets[u]; k < g.xnets[u + 1]; k++) {
            const int e = g.nets[k];
            const int same = p ? cnt1[e] : cnt0[e];
            const int other = p ? cnt0[e] : cnt1[e];
            if (same == 1) gn += g.w[e];       // net becomes uncut
            if (other == 0) gn -= g.w[e];      // net becomes cut
        }
        return gn;
    };

    struct QEntry {
        double gain;
        int node, ver;
        bool operator<(const QEntry& o) const { return gain < o.gain; }
    };

    for (int pass = 0; pass < max_passes; pass++) {
        std::fill(locked.begin(), locked.end(), 0);
        std::priority_queue<QEntry> heap;
        for (int u = 0; u < n; u++) {
            gain[u] = compute_gain(u) + tie(rng);
            heap.push({gain[u], u, version[u]});
        }
        double run_cut = cut, best_cut = cut;
        int moved = 0, best_moved = 0;
        vector<int> move_seq;
        move_seq.reserve(n);

        while (!heap.empty()) {
            QEntry top = heap.top();
            heap.pop();
            const int u = top.node;
            if (locked[u] || top.ver != version[u]) continue;
            const int8_t from = part[u], to = 1 - from;
            if (W[to] + g.nw[u] > max_w[to]) continue;  // keep balance
            // apply move
            locked[u] = 1;
            run_cut -= gain[u] - 0.0;  // tie noise is negligible
            W[from] -= g.nw[u];
            W[to] += g.nw[u];
            part[u] = to;
            move_seq.push_back(u);
            moved++;
            // update net counts + neighbor gains
            for (int k = g.xnets[u]; k < g.xnets[u + 1]; k++) {
                const int e = g.nets[k];
                if (from == 0) { cnt0[e]--; cnt1[e]++; }
                else           { cnt1[e]--; cnt0[e]++; }
                for (int kk = g.xpins[e]; kk < g.xpins[e + 1]; kk++) {
                    const int v = g.pins[kk];
                    if (!locked[v]) {
                        gain[v] = compute_gain(v) + tie(rng);
                        version[v]++;
                        heap.push({gain[v], v, version[v]});
                    }
                }
            }
            if (run_cut < best_cut - 1e-12) {
                best_cut = run_cut;
                best_moved = moved;
            }
        }
        // rollback to best prefix
        for (int i = moved - 1; i >= best_moved; i--) {
            const int u = move_seq[i];
            const int8_t from = part[u], to = 1 - from;
            W[from] -= g.nw[u];
            W[to] += g.nw[u];
            part[u] = to;
        }
        recount();
        cut = cut_value(g, part);
        if (cut >= best_overall - 1e-12) break;  // converged
        best_overall = cut;
    }
    return cut;
}

// ---------------------------------------------------------- coarsening --
// Heavy-connectivity matching; returns the coarse graph and fills
// coarse_of (fine node -> coarse node).
HG coarsen(const HG& g, vector<int>& coarse_of, std::mt19937& rng) {
    const int n = g.n;
    vector<int> order(n);
    std::iota(order.begin(), order.end(), 0);
    std::shuffle(order.begin(), order.end(), rng);

    vector<int> match(n, -1);
    vector<double> score(n, 0.0);
    vector<int> touched;
    const int64_t total_w =
        std::accumulate(g.nw.begin(), g.nw.end(), int64_t{0});
    const int64_t max_cluster = std::max<int64_t>(2, total_w / 16);

    for (int u : order) {
        if (match[u] >= 0) continue;
        touched.clear();
        for (int k = g.xnets[u]; k < g.xnets[u + 1]; k++) {
            const int e = g.nets[k];
            const int sz = g.xpins[e + 1] - g.xpins[e];
            if (sz > 64) continue;  // huge nets carry no locality signal
            const double c = g.w[e] / (sz - 1);
            for (int p = g.xpins[e]; p < g.xpins[e + 1]; p++) {
                const int v = g.pins[p];
                if (v == u || match[v] >= 0) continue;
                if (g.nw[u] + g.nw[v] > max_cluster) continue;
                if (score[v] == 0.0) touched.push_back(v);
                score[v] += c;
            }
        }
        int best = -1;
        double bs = -1;
        for (int v : touched) {
            if (score[v] > bs) { bs = score[v]; best = v; }
            score[v] = 0.0;
        }
        if (best >= 0) { match[u] = best; match[best] = u; }
        else match[u] = u;
    }

    coarse_of.assign(n, -1);
    int nc = 0;
    for (int u = 0; u < n; u++) {
        if (coarse_of[u] >= 0) continue;
        coarse_of[u] = nc;
        if (match[u] != u && match[u] >= 0) coarse_of[match[u]] = nc;
        nc++;
    }

    HG c;
    c.n = nc;
    c.nw.assign(nc, 0);
    for (int u = 0; u < n; u++) c.nw[coarse_of[u]] += g.nw[u];

    // Rebuild nets: map pins, dedupe within net, drop size<2, merge
    // duplicate nets (summing weights) via hashing.
    std::unordered_map<uint64_t, vector<int>> buckets;
    vector<vector<int>> net_pins;
    vector<double> net_w;
    vector<int> tmp;
    for (int e = 0; e < g.m(); e++) {
        tmp.clear();
        for (int k = g.xpins[e]; k < g.xpins[e + 1]; k++)
            tmp.push_back(coarse_of[g.pins[k]]);
        std::sort(tmp.begin(), tmp.end());
        tmp.erase(std::unique(tmp.begin(), tmp.end()), tmp.end());
        if (tmp.size() < 2) continue;
        uint64_t h = 1469598103934665603ull;
        for (int x : tmp) {
            h ^= static_cast<uint64_t>(x) + 0x9e3779b97f4a7c15ull;
            h *= 1099511628211ull;
        }
        bool merged = false;
        for (int idx : buckets[h]) {
            if (net_pins[idx] == tmp) {
                net_w[idx] += g.w[e];
                merged = true;
                break;
            }
        }
        if (!merged) {
            buckets[h].push_back(static_cast<int>(net_pins.size()));
            net_pins.push_back(tmp);
            net_w.push_back(g.w[e]);
        }
    }
    c.xpins.assign(1, 0);
    for (auto& ps : net_pins) {
        c.pins.insert(c.pins.end(), ps.begin(), ps.end());
        c.xpins.push_back(static_cast<int>(c.pins.size()));
    }
    c.w = std::move(net_w);
    c.build_incidence();
    return c;
}

// ---------------------------------------------------- initial partition --
// Greedy region growth from a random seed node + FM; several tries.
double initial_partition(const HG& g, vector<int8_t>& part,
                         int64_t max_w[2], std::mt19937& rng,
                         int tries = 8) {
    const int n = g.n;
    const int64_t total_w =
        std::accumulate(g.nw.begin(), g.nw.end(), int64_t{0});
    double best_cut = -1;
    vector<int8_t> best_part(n);
    vector<double> conn(n);
    std::uniform_int_distribution<int> pick(0, n - 1);

    for (int t = 0; t < tries; t++) {
        vector<int8_t> p(n, 1);
        std::fill(conn.begin(), conn.end(), 0.0);
        int64_t w0 = 0;
        int start = pick(rng);
        auto add = [&](int u) {
            p[u] = 0;
            w0 += g.nw[u];
            for (int k = g.xnets[u]; k < g.xnets[u + 1]; k++) {
                const int e = g.nets[k];
                for (int kk = g.xpins[e]; kk < g.xpins[e + 1]; kk++) {
                    const int v = g.pins[kk];
                    if (p[v]) conn[v] += g.w[e];
                }
            }
        };
        add(start);
        while (2 * w0 < total_w) {
            int best = -1;
            double bs = -1;
            for (int v = 0; v < n; v++)
                if (p[v] && conn[v] > bs &&
                    w0 + g.nw[v] <= max_w[0]) {
                    bs = conn[v];
                    best = v;
                }
            if (best < 0) break;
            add(best);
        }
        double cut = fm_refine(g, p, max_w, rng, 4);
        if (best_cut < 0 || cut < best_cut) {
            best_cut = cut;
            best_part = p;
        }
    }
    part = best_part;
    return best_cut;
}

// --------------------------------------------------------------- driver --
double vcycle(const HG& g0, vector<int8_t>& part, double eps,
              std::mt19937& rng) {
    const int64_t total_w =
        std::accumulate(g0.nw.begin(), g0.nw.end(), int64_t{0});
    int64_t max_w[2];
    max_w[0] = max_w[1] = static_cast<int64_t>(
        std::ceil((1.0 + eps) * 0.5 * static_cast<double>(total_w)));

    // coarsening chain
    vector<HG> levels;
    vector<vector<int>> maps;
    levels.push_back(g0);
    while (levels.back().n > 96) {
        vector<int> cmap;
        HG c = coarsen(levels.back(), cmap, rng);
        if (c.n >= static_cast<int>(0.95 * levels.back().n)) break;
        levels.push_back(std::move(c));
        maps.push_back(std::move(cmap));
    }

    vector<int8_t> p;
    initial_partition(levels.back(), p, max_w, rng);

    for (int lvl = static_cast<int>(levels.size()) - 2; lvl >= 0; lvl--) {
        vector<int8_t> fine(levels[lvl].n);
        for (int u = 0; u < levels[lvl].n; u++)
            fine[u] = p[maps[lvl][u]];
        p = std::move(fine);
        fm_refine(levels[lvl], p, max_w, rng, lvl == 0 ? 8 : 4);
    }
    part = p;
    return cut_value(g0, part);
}

}  // namespace

extern "C" {

// Bipartition a hypergraph.  Returns 0 on success.
//   n_nodes, n_nets:   sizes
//   xpins[n_nets+1]:   net -> pin offsets
//   pins[...]:         node ids, concatenated per net
//   net_w[n_nets]:     net weights (e.g. log2 of index dimension)
//   node_w[n_nodes]:   node weights (or NULL for unit weights)
//   eps:               allowed imbalance (max side <= (1+eps)/2 * total)
//   n_runs:            independent V-cycles; best balanced cut wins
//   seed:              RNG seed
//   out_part[n_nodes]: 0/1 side per node
//   out_cut:           cut weight of the returned partition (or NULL)
int hgp_bipartition(int n_nodes, int n_nets, const int* xpins,
                    const int* pins, const double* net_w,
                    const int64_t* node_w, double eps, int n_runs,
                    unsigned seed, int* out_part, double* out_cut) {
    if (n_nodes <= 0 || n_nets < 0 || !xpins || !pins || !net_w ||
        !out_part)
        return 1;
    HG g;
    g.n = n_nodes;
    g.xpins.assign(xpins, xpins + n_nets + 1);
    g.pins.assign(pins, pins + xpins[n_nets]);
    g.w.assign(net_w, net_w + n_nets);
    if (node_w) g.nw.assign(node_w, node_w + n_nodes);
    else g.nw.assign(n_nodes, 1);
    for (int p : g.pins)
        if (p < 0 || p >= n_nodes) return 2;
    g.build_incidence();

    std::mt19937 rng(seed);
    double best_cut = -1;
    vector<int8_t> best, part;
    for (int r = 0; r < std::max(1, n_runs); r++) {
        double cut = vcycle(g, part, eps, rng);
        if (best_cut < 0 || cut < best_cut) {
            best_cut = cut;
            best = part;
        }
    }
    for (int u = 0; u < n_nodes; u++) out_part[u] = best[u];
    if (out_cut) *out_cut = best_cut;
    return 0;
}

}  // extern "C"
