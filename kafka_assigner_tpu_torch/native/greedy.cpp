// Native greedy assignment oracle.
//
// Same five-phase semantics as the Python oracle (solvers/greedy.py) and the
// reference algorithm (KafkaAssignmentStrategy.java:40-63), operating in
// dense index space (node row = rank of broker id ascending, rack ids
// factorized, partitions row-major ascending). Exists so the BASELINE
// comparison at headline scale (5k brokers / 200k partitions) measures the
// TPU solver against a serious single-thread native implementation of the
// reference's algorithm, not against interpreted Python.
//
// Exposed via a C ABI for ctypes (no pybind11 in this image).
//
// Phase map (reference line numbers):
//   capacity  ceil(P*RF/N)                KafkaAssignmentStrategy.java:65-71
//   sticky    slot-major round-robin      KafkaAssignmentStrategy.java:101-131
//   orphans   deficit per partition       KafkaAssignmentStrategy.java:133-160
//   spread    first-fit in rotated order  KafkaAssignmentStrategy.java:162-200
//   leaders   least-seen counter ordering KafkaAssignmentStrategy.java:202-302

#include <cstddef>
#include <cstdint>
#include <climits>
#include <vector>

namespace {

struct Topic {
    int n;           // nodes
    int p;           // partitions
    int rf;          // replicas to place (deficit target, capacity input)
    int out_w;       // slot width of acc/ordered rows; == rf clamps sticky
                     // retention to rf (default), > rf (== historical width)
                     // reproduces the reference's unbounded retention on an
                     // RF decrease (KafkaAssignmentStrategy.java:320-324)
    int cap;         // per-node capacity
    const int32_t* rack_of;  // (n) factorized rack id per node
    int n_racks;
};

// Membership tracking: per node a small flat list of held partitions (loads
// are bounded by cap, typically 1-16), per (rack, partition) a bitfield.
struct State {
    std::vector<std::vector<int>> node_parts;  // per node
    std::vector<uint8_t> rack_has;             // n_racks * p
    std::vector<int> acc_count;                // per partition
    std::vector<int> acc_nodes;                // p * rf, -1 empty

    State(const Topic& t)
        : node_parts(t.n),
          rack_has(static_cast<size_t>(t.n_racks) * t.p, 0),
          acc_count(t.p, 0),
          acc_nodes(static_cast<size_t>(t.p) * t.out_w, -1) {}
};

inline bool node_holds(const State& s, int node, int part) {
    for (int q : s.node_parts[node])
        if (q == part) return true;
    return false;
}

inline bool can_accept(const Topic& t, const State& s, int node, int part) {
    return !node_holds(s, node, part) &&
           static_cast<int>(s.node_parts[node].size()) < t.cap &&
           !s.rack_has[static_cast<size_t>(t.rack_of[node]) * t.p + part];
}

inline void accept(const Topic& t, State& s, int node, int part) {
    s.node_parts[node].push_back(part);
    s.rack_has[static_cast<size_t>(t.rack_of[node]) * t.p + part] = 1;
    int c = s.acc_count[part]++;
    s.acc_nodes[static_cast<size_t>(part) * t.out_w + c] = node;
}

// One partition's preference-list ordering (computePreferenceLists,
// KafkaAssignmentStrategy.java:202-302): for slot r over m remaining
// candidates, take the first strict minimum of counter[node][r] scanning the
// remaining set in rotated order == argmin of (count * m + rotated_pos).
// Shared by the full native solve and the standalone ka_order_many pass run
// over device-placed batches; counters stride is rf.
inline void order_partition(
    const int32_t* cand, int m_all, int rf, int64_t jhash_abs,
    int32_t* counters, int* remaining, int32_t* out_row) {
    int n_rem = 0;
    for (int i = 0; i < m_all; ++i) remaining[n_rem++] = cand[i];
    for (int r = 0; r < m_all; ++r) {
        int m = n_rem;
        int rot_start = static_cast<int>(jhash_abs % m);
        int64_t best_key = INT64_MAX;
        int best_i = -1;
        for (int i = 0; i < n_rem; ++i) {
            int node = remaining[i];
            // rank among remaining by node index ascending
            int k = 0;
            for (int j = 0; j < n_rem; ++j)
                if (remaining[j] < node) ++k;
            int pos = (k + rot_start) % m;
            int64_t key =
                static_cast<int64_t>(counters[static_cast<size_t>(node) * rf + r]) * m + pos;
            if (key < best_key) {
                best_key = key;
                best_i = i;
            }
        }
        int chosen = remaining[best_i];
        remaining[best_i] = remaining[--n_rem];
        out_row[r] = chosen;
    }
    for (int r = m_all; r < rf; ++r) out_row[r] = -1;
    for (int r = 0; r < m_all; ++r)
        ++counters[static_cast<size_t>(out_row[r]) * rf + r];
}

}  // namespace

extern "C" {

// Returns 0 on success; (partition_row + 1) when that partition cannot be
// fully assigned (the reference's hard failure, :183-184).
//
// current: (p x width) node indices or -1. counters: (n x out_width)
// leadership counters, updated in place. out_ordered: (p x out_width)
// preference lists. out_width == rf clamps sticky retention to rf (the
// documented default divergence); out_width == max(rf, width) reproduces
// the reference's unbounded RF-decrease retention (KA_RF_DECREASE_COMPAT).
int32_t ka_solve_topic(
    int32_t n, const int32_t* rack_of, int32_t n_racks,
    int32_t p, const int32_t* current, int32_t width,
    int32_t rf, int32_t out_width, int64_t jhash_abs,
    int32_t* counters, int32_t* out_ordered) {
    Topic t;
    t.n = n;
    t.p = p;
    t.rf = rf;
    t.out_w = out_width;
    t.cap = static_cast<int>((static_cast<int64_t>(p) * rf + n - 1) / n);
    t.rack_of = rack_of;
    t.n_racks = n_racks;

    State s(t);

    // Sticky fill: slot-major round-robin, ascending partitions within a
    // pass — replica i of every partition is offered before any replica i+1.
    // The retention bound is the slot width: == rf clamps (the TPU solver's
    // documented default divergence), > rf never binds (the reference's
    // canAccept has no per-partition limit, :320-324).
    for (int s_idx = 0; s_idx < width; ++s_idx) {
        for (int part = 0; part < p; ++part) {
            int cand = current[static_cast<size_t>(part) * width + s_idx];
            if (cand < 0 || s.acc_count[part] >= t.out_w) continue;
            if (can_accept(t, s, cand, part)) accept(t, s, cand, part);
        }
    }

    // Orphan spread: ascending partitions; nodes probed in topic-rotated
    // order starting at abs(hash) % n, greedy first-fit.
    int start = static_cast<int>(jhash_abs % n);
    for (int part = 0; part < p; ++part) {
        int deficit = rf - s.acc_count[part];
        if (deficit <= 0) continue;
        for (int k = 0; k < n && deficit > 0; ++k) {
            // rotated iteration: position i holds sorted node (i - start mod n)
            int node = (k + (n - start)) % n;
            if (can_accept(t, s, node, part)) {
                accept(t, s, node, part);
                --deficit;
            }
        }
        if (deficit != 0) return part + 1;
    }

    // Leadership ordering (shared helper; see order_partition above).
    std::vector<int> remaining(t.out_w);
    for (int part = 0; part < p; ++part) {
        order_partition(
            &s.acc_nodes[static_cast<size_t>(part) * t.out_w],
            s.acc_count[part], t.out_w, jhash_abs, counters,
            remaining.data(),
            out_ordered + static_cast<size_t>(part) * t.out_w);
    }
    return 0;
}

// Standalone leadership pass over device-placed batches: the heterogeneous
// split the TPU solver uses by default. Placement (sticky + waves) is the
// parallel tensor phase and runs on the accelerator; this ordering pass is an
// inherently sequential 200k-step scalar chain (each partition reads counters
// the previous one wrote, across topics via the shared Context slab) whose
// consumers — decode and Context updates — live on the host anyway. A scalar
// chain runs at ~ns/step here vs ~us/step as an XLA scan
// (KafkaAssignmentStrategy.java:202-302 for the semantics being reproduced).
//
// acc_nodes: (n_topics, p_pad, rf) node index or -1, acceptance order.
// acc_count: (n_topics, p_pad); rows past p_reals[i] must be 0 (inert).
// counters:  (*, rf) leadership slab, updated in place; row stride rf.
// out_ordered: (n_topics, p_pad, rf) preference lists; -1 for empty slots
// and padded rows — byte-identical to the device leadership_order output.
void ka_order_many(
    int32_t n_topics, int32_t p_pad, int32_t rf,
    const int32_t* acc_nodes, const int32_t* acc_count,
    const int64_t* jhashes, const int32_t* p_reals,
    int32_t* counters, int32_t* out_ordered) {
    std::vector<int> remaining(rf);
    for (int32_t t = 0; t < n_topics; ++t) {
        const size_t base = static_cast<size_t>(t) * p_pad;
        for (int32_t part = 0; part < p_pad; ++part) {
            const size_t row = (base + part) * rf;
            if (part < p_reals[t]) {
                order_partition(
                    acc_nodes + row, acc_count[base + part], rf, jhashes[t],
                    counters, remaining.data(), out_ordered + row);
            } else {
                for (int r = 0; r < rf; ++r) out_ordered[row + r] = -1;
            }
        }
    }
}

// Multi-topic entry: the reference's serial topic loop
// (KafkaAssignmentGenerator.java:173-176) run entirely in native code with
// the leadership counters shared across topics. Topics are concatenated:
// currents at current_offsets[i] with shape (p_counts[i] x widths[i]),
// outputs at ordered_offsets[i] with shape (p_counts[i] x out_width).
// counters stride is out_width (== rf by default; see ka_solve_topic).
//
// Returns 0 on success; on infeasibility returns (topic_index + 1) and
// writes the failing partition row to *fail_part.
int32_t ka_solve_many(
    int32_t n, const int32_t* rack_of, int32_t n_racks,
    int32_t n_topics,
    const int32_t* p_counts, const int32_t* widths, const int64_t* jhashes,
    const int32_t* currents_concat, const int64_t* current_offsets,
    int32_t rf, int32_t out_width,
    int32_t* counters,
    int32_t* ordered_concat, const int64_t* ordered_offsets,
    int32_t* fail_part) {
    for (int32_t i = 0; i < n_topics; ++i) {
        int32_t rc = ka_solve_topic(
            n, rack_of, n_racks,
            p_counts[i], currents_concat + current_offsets[i], widths[i],
            rf, out_width, jhashes[i],
            counters, ordered_concat + ordered_offsets[i]);
        if (rc != 0) {
            *fail_part = rc - 1;
            return i + 1;
        }
    }
    return 0;
}

}  // extern "C"
