// tnopt — exact-optimal contraction path for small tensor sets
// (bitmask dynamic programming, C++17, no deps).
//
// This is the inner loop of subtree reconfiguration
// (hybridq_tpu/simulation/tn/path.py:reconfigure), the refinement that
// the reference obtains through cotengra's `subtree_reconfigure`
// (driven from hybridq/circuit/simulation/simulation.py:920-983).  The
// Python fallback (opt_einsum 'dp') costs ~1 s per 12-tensor call; this
// DP runs in microseconds, so reconfiguration can afford thousands of
// subtree re-optimizations per search.
//
// Model: minimize total flops, where contracting A with B costs
// prod(sizes of union(inds(A), inds(B))) and a node's retained indices
// are those reaching outside its subtree or the output — identical to
// ContractionTree.node_flops / node_inds in path.py.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

using std::vector;

constexpr int kMaxWords = 4;  // up to 256 grouped indices

struct Mask {
    uint64_t w[kMaxWords] = {0, 0, 0, 0};
    void set(int i) { w[i >> 6] |= uint64_t{1} << (i & 63); }
    Mask operator|(const Mask& o) const {
        Mask r;
        for (int k = 0; k < kMaxWords; k++) r.w[k] = w[k] | o.w[k];
        return r;
    }
};

}  // namespace

extern "C" {

// Exact-optimal contraction order for <= 16 tensors.
//   n_tensors:  number of tensors (2..16)
//   n_inds:     number of distinct indices
//   pinmask:    per index, bitmask over tensors containing it
//   is_out:     per index, 1 if the index must remain open (output /
//               reaches outside the subproblem)
//   logw:       per index, log2 of its dimension
//   out_pairs:  (n_tensors-1) SSA pairs (a, b); new ids are allocated
//               from n_tensors upward
// Returns 0 on success, >0 on error (caller falls back to Python).
int tn_optimal_path(int n_tensors, int n_inds, const uint32_t* pinmask,
                    const uint8_t* is_out, const double* logw,
                    int* out_pairs) {
    if (n_tensors < 2 || n_tensors > 16 || n_inds < 0 || !pinmask ||
        !is_out || !logw || !out_pairs)
        return 1;
    const uint32_t full = (n_tensors == 32)
                              ? ~uint32_t{0}
                              : ((uint32_t{1} << n_tensors) - 1);

    // Group indices with identical (pinmask, is_out): their weights add.
    std::unordered_map<uint64_t, int> group_of;
    vector<uint32_t> gpin;
    vector<uint8_t> gout;
    vector<double> gw;
    for (int i = 0; i < n_inds; i++) {
        if ((pinmask[i] & full) == 0) continue;
        const uint64_t key =
            (uint64_t(pinmask[i] & full) << 1) | (is_out[i] ? 1 : 0);
        auto it = group_of.find(key);
        if (it == group_of.end()) {
            group_of.emplace(key, static_cast<int>(gpin.size()));
            gpin.push_back(pinmask[i] & full);
            gout.push_back(is_out[i] ? 1 : 0);
            gw.push_back(logw[i]);
        } else {
            gw[it->second] += logw[i];
        }
    }
    const int G = static_cast<int>(gpin.size());
    if (G > 64 * kMaxWords) return 2;

    const uint32_t n_sets = uint32_t{1} << n_tensors;

    // inds[S]: grouped-index mask retained by subset S;
    // a group is retained iff it touches S and (is_out or touches ~S).
    vector<Mask> inds(n_sets);
    for (uint32_t S = 1; S < n_sets; S++) {
        Mask m;
        for (int g = 0; g < G; g++) {
            if ((gpin[g] & S) && (gout[g] || (gpin[g] & full & ~S)))
                m.set(g);
        }
        inds[S] = m;
    }

    auto weight_of = [&](const Mask& m) {
        double s = 0;
        for (int k = 0; k < kMaxWords; k++) {
            uint64_t x = m.w[k];
            while (x) {
                const int b = __builtin_ctzll(x);
                s += gw[64 * k + b];
                x &= x - 1;
            }
        }
        return s;
    };

    constexpr double kInf = 1e300;
    vector<double> cost(n_sets, kInf);
    vector<uint32_t> choice(n_sets, 0);
    for (int t = 0; t < n_tensors; t++) cost[uint32_t{1} << t] = 0.0;

    // Subsets in increasing popcount order (subsets enumerate before
    // supersets anyway with numeric order since A < S for A subset of S
    // when A != S; numeric order suffices).
    for (uint32_t S = 1; S < n_sets; S++) {
        if (__builtin_popcount(S) < 2) continue;
        const uint32_t low = S & ~(S - 1);  // canonical: A contains low
        double best = kInf;
        uint32_t best_a = 0;
        // Enumerate proper submasks A of S containing `low`.
        const uint32_t rest = S ^ low;
        for (uint32_t sub = rest; ; sub = (sub - 1) & rest) {
            const uint32_t A = sub | low;
            if (A != S) {
                const uint32_t B = S ^ A;
                const double ca = cost[A], cb = cost[B];
                if (ca < kInf && cb < kInf) {
                    const double base = ca + cb;
                    if (base < best) {
                        const double f =
                            std::exp2(weight_of(inds[A] | inds[B]));
                        const double tot = base + f;
                        if (tot < best) {
                            best = tot;
                            best_a = A;
                        }
                    }
                }
            }
            if (sub == 0) break;
        }
        cost[S] = best;
        choice[S] = best_a;
    }
    if (cost[full] >= kInf) return 3;

    // Reconstruct SSA pairs (children before parents).
    int next_id = n_tensors;
    int n_out = 0;
    vector<int> node_of(n_sets, -1);
    for (int t = 0; t < n_tensors; t++)
        node_of[uint32_t{1} << t] = t;
    // Iterative post-order over the split tree.
    vector<uint32_t> stack = {full};
    vector<uint32_t> post;
    while (!stack.empty()) {
        const uint32_t S = stack.back();
        stack.pop_back();
        if (__builtin_popcount(S) < 2) continue;
        post.push_back(S);
        stack.push_back(choice[S]);
        stack.push_back(S ^ choice[S]);
    }
    std::reverse(post.begin(), post.end());
    for (uint32_t S : post) {
        const uint32_t A = choice[S], B = S ^ A;
        out_pairs[2 * n_out] = node_of[A];
        out_pairs[2 * n_out + 1] = node_of[B];
        node_of[S] = next_id++;
        n_out++;
    }
    return (n_out == n_tensors - 1) ? 0 : 4;
}

}  // extern "C"
