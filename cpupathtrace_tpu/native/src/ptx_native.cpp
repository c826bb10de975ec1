// Native runtime components for cpupathtrace_tpu.
//
// The device compute path is JAX/XLA; this library provides the
// host-side runtime pieces that the C++ reference also implements natively
// and that dominate scene-build time for multi-million-triangle meshes:
//
//   * ptx_build_bvh  — flat-array BVH construction with the reference's
//     policy (median split on box minima, split axis minimizing summed
//     child surface area, left<=2*right rebalance; behavioral spec:
//     reference src/scene/scene.cpp:12-102) — same tree as the Python
//     builder in accel/build.py, ~50x faster.
//   * ptx_parse_obj  — OBJ v/f parser with the reference's tolerant
//     semantics (spec: reference src/scene/mesh.cpp:11-271).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 dependency).
#include <algorithm>
#include <atomic>
#include <cctype>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <utility>
#include <vector>

namespace {

struct BvhTask { int node; int begin; int end; int depth; };

// Processes tasks LIFO with the reference split policy (median of box
// minima per axis, axis minimizing summed child surface areas,
// left<=2*right rebalance — behavioral spec: reference
// src/scene/scene.cpp:12-102). `next_node` allocates child node ids in
// the serial scheme. When `frontier` is non-null, a popped task of
// size <= defer_below is NOT processed: it is recorded together with its
// would-be id base and `next_node` advances by its exact subtree
// allocation (a k-primitive subtree allocates 2k-2 child ids, and LIFO
// order makes that block contiguous), so phase-2 workers can build the
// deferred subtrees in parallel while reproducing the single-threaded
// node numbering BIT-IDENTICALLY.
void bvh_process_stack(const float* prim_lo, const float* prim_hi,
                       int32_t* idx, float* lo, float* hi, int32_t* left,
                       int32_t* right, int32_t* prim,
                       std::vector<BvhTask>& stack, int& next_node,
                       int& max_depth, int defer_below,
                       std::vector<std::pair<BvhTask, int>>* frontier,
                       int32_t* node_begin, int32_t* node_size) {
    std::vector<float> axmin;
    while (!stack.empty()) {
        BvhTask t = stack.back();
        stack.pop_back();
        const int k = t.end - t.begin;
        if (frontier && k > 1 && k <= defer_below) {
            frontier->push_back({t, next_node});
            next_node += 2 * k - 2;
            continue;
        }
        max_depth = std::max(max_depth, t.depth);
        if (node_begin) {
            // Subtree range in the final DFS leaf order: since every leaf
            // holds one primitive, t.begin IS the node's first-leaf DFS
            // rank and k its subtree primitive count (consumed by the
            // cluster-cut in accel/cluster.py without any tree sweeps).
            node_begin[t.node] = t.begin;
            node_size[t.node] = k;
        }

        // Node bounds over the range.
        float blo[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
        float bhi[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
        for (int i = t.begin; i < t.end; i++) {
            const float* l = prim_lo + 3 * idx[i];
            const float* h = prim_hi + 3 * idx[i];
            for (int a = 0; a < 3; a++) {
                blo[a] = std::min(blo[a], l[a]);
                bhi[a] = std::max(bhi[a], h[a]);
            }
        }
        std::memcpy(lo + 3 * t.node, blo, sizeof blo);
        std::memcpy(hi + 3 * t.node, bhi, sizeof bhi);

        if (k == 1) {
            prim[t.node] = idx[t.begin];
            left[t.node] = right[t.node] = -1;
            continue;
        }
        prim[t.node] = -1;

        // Median of box minima per axis ((k/2-1)-th order statistic,
        // reference nth_element policy), then pick the axis whose
        // low<=median partition minimizes summed child surface areas.
        if (static_cast<int>(axmin.size()) < k) axmin.resize(k);
        double best_cost = 0.0;
        int best_axis = -1;
        float best_median = 0.0f;
        for (int axis = 0; axis < 3; axis++) {
            for (int i = 0; i < k; i++)
                axmin[i] = prim_lo[3 * idx[t.begin + i] + axis];
            const int m_pos = std::max(k / 2 - 1, 0);
            std::nth_element(axmin.begin(), axmin.begin() + m_pos,
                             axmin.begin() + k);
            const float median = axmin[m_pos];

            float l_lo[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
            float l_hi[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
            float r_lo[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
            float r_hi[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
            int n_l = 0;
            for (int i = t.begin; i < t.end; i++) {
                const float* l = prim_lo + 3 * idx[i];
                const float* h = prim_hi + 3 * idx[i];
                const bool go_left = l[axis] <= median;
                float* tlo = go_left ? l_lo : r_lo;
                float* thi = go_left ? l_hi : r_hi;
                for (int a = 0; a < 3; a++) {
                    tlo[a] = std::min(tlo[a], l[a]);
                    thi[a] = std::max(thi[a], h[a]);
                }
                n_l += go_left;
            }
            double cost;
            if (n_l == 0 || n_l == k) {
                cost = HUGE_VAL;  // degenerate split; avoid
            } else {
                const double dl0 = l_hi[0] - l_lo[0], dl1 = l_hi[1] - l_lo[1],
                             dl2 = l_hi[2] - l_lo[2];
                const double dr0 = r_hi[0] - r_lo[0], dr1 = r_hi[1] - r_lo[1],
                             dr2 = r_hi[2] - r_lo[2];
                cost = 2.0 * (dl0 * dl1 + dl1 * dl2 + dl0 * dl2) +
                       2.0 * (dr0 * dr1 + dr1 * dr2 + dr0 * dr2);
            }
            if (best_axis < 0 || cost < best_cost) {
                best_cost = cost;
                best_axis = axis;
                best_median = median;
            }
        }

        // Stable partition by low[axis] <= median (reference stable_partition).
        std::stable_partition(
            idx + t.begin, idx + t.end,
            [&](int32_t p) { return prim_lo[3 * p + best_axis] <= best_median; });
        int n_left = 0;
        for (int i = t.begin; i < t.end; i++)
            n_left += prim_lo[3 * idx[i] + best_axis] <= best_median;

        // n_left >= 1 always (the median is one of the lows); n_left == k
        // is handled by the rebalance below, exactly like the Python path.

        // Rebalance: move trailing-left entries right until left <= 2*right.
        // Exactly replicates the Python builder (accel/build.py:112-119):
        // the moved block is appended at the END of the right range,
        // reversed.
        int move = 0;
        while (n_left - move > 1 &&
               (n_left - move) > 2 * ((k - n_left) + move))
            move++;
        if (move) {
            int32_t* s = idx + t.begin + n_left - move;
            int32_t* m = idx + t.begin + n_left;
            int32_t* e = idx + t.end;
            std::rotate(s, m, e);           // block now at the end, in order
            std::reverse(e - move, e);      // ... reversed, like Python
            n_left -= move;
        }

        const int cl = next_node++;
        const int cr = next_node++;
        left[t.node] = cl;
        right[t.node] = cr;
        stack.push_back({cr, t.begin + n_left, t.end, t.depth + 1});
        stack.push_back({cl, t.begin, t.begin + n_left, t.depth + 1});
    }
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// BVH builder
// ---------------------------------------------------------------------------
// prim_lo/prim_hi: [n,3] float32 primitive bounds.
// Outputs (caller-allocated, capacity 2n-1 nodes):
//   lo/hi: [2n-1,3] f32, left/right/prim: [2n-1] i32.
// Returns node count; *out_depth receives the max depth (root = 1).
// node_begin/node_size/out_idx may be null: per-node first-leaf DFS rank,
// subtree primitive count, and the final primitive DFS order [n].
int ptx_build_bvh(const float* prim_lo, const float* prim_hi, int n,
                  float* lo, float* hi, int32_t* left, int32_t* right,
                  int32_t* prim, int32_t* out_depth, int32_t* node_begin,
                  int32_t* node_size, int32_t* out_idx) {
    if (n <= 0) return 0;

    std::vector<int32_t> idx(n);
    for (int i = 0; i < n; i++) idx[i] = i;

    int next_node = 0;
    int max_depth = 0;
    std::vector<BvhTask> stack;
    stack.push_back({next_node++, 0, n, 1});

    unsigned hw = std::thread::hardware_concurrency();
    const int n_threads = static_cast<int>(hw ? hw : 1);
    if (n_threads <= 1 || n < 65536) {
        // Small builds: the serial path (thread spawn overhead dominates).
        bvh_process_stack(prim_lo, prim_hi, idx.data(), lo, hi, left, right,
                          prim, stack, next_node, max_depth, 0, nullptr,
                          node_begin, node_size);
        if (out_idx) std::memcpy(out_idx, idx.data(), n * sizeof(int32_t));
        *out_depth = max_depth;
        return next_node;
    }

    // Phase 1 (serial): split top levels, DEFERRING every popped task of
    // <= defer_below primitives to the frontier with its precomputed node
    // id base (see bvh_process_stack). Phase 2: build the deferred
    // subtrees on worker threads — disjoint idx ranges, disjoint node id
    // blocks, no locks; output bit-identical to the serial build.
    const int defer_below =
        std::max(n / (8 * n_threads), 4096);
    std::vector<std::pair<BvhTask, int>> frontier;
    bvh_process_stack(prim_lo, prim_hi, idx.data(), lo, hi, left, right,
                      prim, stack, next_node, max_depth, defer_below,
                      &frontier, node_begin, node_size);

    std::atomic<size_t> cursor{0};
    std::vector<int> depths(n_threads, 0);
    auto worker = [&](int wi) {
        std::vector<BvhTask> wstack;
        int wdepth = 0;
        for (;;) {
            const size_t j = cursor.fetch_add(1);
            if (j >= frontier.size()) break;
            wstack.clear();
            wstack.push_back(frontier[j].first);
            int wnext = frontier[j].second;
            bvh_process_stack(prim_lo, prim_hi, idx.data(), lo, hi, left,
                              right, prim, wstack, wnext, wdepth, 0,
                              nullptr, node_begin, node_size);
        }
        depths[wi] = wdepth;
    };
    std::vector<std::thread> threads;
    threads.reserve(n_threads - 1);
    for (int i = 1; i < n_threads; i++) threads.emplace_back(worker, i);
    worker(0);
    for (auto& t : threads) t.join();
    for (int d : depths) max_depth = std::max(max_depth, d);

    if (out_idx) std::memcpy(out_idx, idx.data(), n * sizeof(int32_t));
    *out_depth = max_depth;
    return next_node;
}

// ---------------------------------------------------------------------------
// Mesh pipeline: face validation + smooth vertex normals
// ---------------------------------------------------------------------------
// The exact post-parse pipeline of scene/mesh.py mesh_from_arrays
// (behavioral spec: reference src/scene/mesh.cpp:127-267): reject faces
// with out-of-range indices, duplicate vertices, or collinear vertices
// (NaN coordinates fail the > 0 checks, like the numpy comparisons);
// optionally average normalized incident face normals per vertex. Float
// ops mirror the numpy pass order exactly (compiled -ffp-contract=off),
// so outputs are BIT-IDENTICAL to the Python path.
// verts: [n_v, 3] f64 (already transformed). faces: [n_f, 3] i64.
// Outputs (capacity n_f rows each): a/b/c vertex positions, na/nb/nc
// per-vertex normals. Returns the kept-face count; kept faces are packed
// in input order.
int64_t ptx_mesh_pipeline(const double* verts, int64_t n_v,
                          const int64_t* faces, int64_t n_f, int smooth,
                          double* out_a, double* out_b, double* out_c,
                          double* out_na, double* out_nb, double* out_nc) {
    if (n_f <= 0 || n_v <= 0) return 0;
    std::vector<double> fn_unit(static_cast<size_t>(n_f) * 3);
    std::vector<uint8_t> keep(n_f, 0);

    unsigned hw = std::thread::hardware_concurrency();
    const int n_threads = static_cast<int>(std::max<int64_t>(
        1, std::min<int64_t>(hw ? hw : 1, n_f / 16384)));

    auto validate_range = [&](int64_t begin, int64_t end) {
        for (int64_t f = begin; f < end; f++) {
            const int64_t i0 = faces[3 * f + 0];
            const int64_t i1 = faces[3 * f + 1];
            const int64_t i2 = faces[3 * f + 2];
            if (i0 < 0 || i0 >= n_v || i1 < 0 || i1 >= n_v || i2 < 0 ||
                i2 >= n_v)
                continue;
            const double* a = verts + 3 * i0;
            const double* b = verts + 3 * i1;
            const double* c = verts + 3 * i2;
            const double ab0 = b[0] - a[0], ab1 = b[1] - a[1],
                         ab2_ = b[2] - a[2];
            const double ac0 = c[0] - a[0], ac1 = c[1] - a[1],
                         ac2_ = c[2] - a[2];
            const double bc0 = c[0] - b[0], bc1 = c[1] - b[1],
                         bc2_ = c[2] - b[2];
            const double d_ab = ab0 * ab0 + ab1 * ab1 + ab2_ * ab2_;
            const double d_ac = ac0 * ac0 + ac1 * ac1 + ac2_ * ac2_;
            const double d_bc = bc0 * bc0 + bc1 * bc1 + bc2_ * bc2_;
            if (!(d_ab > 0.0) || !(d_ac > 0.0) || !(d_bc > 0.0)) continue;
            const double fx = ab1 * ac2_ - ab2_ * ac1;
            const double fy = ab2_ * ac0 - ab0 * ac2_;
            const double fz = ab0 * ac1 - ab1 * ac0;
            const double len2 = fx * fx + fy * fy + fz * fz;
            if (!(len2 > 0.0)) continue;
            keep[f] = 1;
            const double len = std::max(std::sqrt(len2), 1e-300);
            fn_unit[3 * f + 0] = fx / len;
            fn_unit[3 * f + 1] = fy / len;
            fn_unit[3 * f + 2] = fz / len;
        }
    };
    {
        std::vector<std::thread> threads;
        const int64_t chunk = (n_f + n_threads - 1) / n_threads;
        for (int i = 1; i < n_threads; i++) {
            const int64_t b = i * chunk, e = std::min(n_f, b + chunk);
            if (b < e) threads.emplace_back(validate_range, b, e);
        }
        validate_range(0, std::min(n_f, chunk));
        for (auto& t : threads) t.join();
    }

    // Kept-face list in input order (stable compaction).
    std::vector<int64_t> kept;
    kept.reserve(n_f);
    for (int64_t f = 0; f < n_f; f++)
        if (keep[f]) kept.push_back(f);
    const int64_t n_k = static_cast<int64_t>(kept.size());

    std::vector<double> v_unit;
    std::vector<uint8_t> v_ok;
    if (smooth && n_k) {
        // Accumulation ORDER matters for float equality with numpy's
        // np.add.at loop (k outer, faces inner) — run it serially the
        // same way (~0.2 s at 7.2M faces).
        std::vector<double> v_norm(static_cast<size_t>(n_v) * 3, 0.0);
        for (int k = 0; k < 3; k++) {
            for (int64_t j = 0; j < n_k; j++) {
                const int64_t f = kept[j];
                const int64_t v = faces[3 * f + k];
                v_norm[3 * v + 0] += fn_unit[3 * f + 0];
                v_norm[3 * v + 1] += fn_unit[3 * f + 1];
                v_norm[3 * v + 2] += fn_unit[3 * f + 2];
            }
        }
        v_unit.resize(static_cast<size_t>(n_v) * 3);
        v_ok.assign(n_v, 0);
        auto norm_range = [&](int64_t begin, int64_t end) {
            for (int64_t v = begin; v < end; v++) {
                const double x = v_norm[3 * v], y = v_norm[3 * v + 1],
                             z = v_norm[3 * v + 2];
                const double l2 = x * x + y * y + z * z;
                if (l2 > 0.0) {
                    v_ok[v] = 1;
                    // Divide (not reciprocal-multiply): matches numpy's
                    // v_norm / sqrt(...) rounding bit-for-bit.
                    const double len = std::sqrt(std::max(l2, 1e-300));
                    v_unit[3 * v] = x / len;
                    v_unit[3 * v + 1] = y / len;
                    v_unit[3 * v + 2] = z / len;
                } else {
                    v_unit[3 * v] = v_unit[3 * v + 1] = v_unit[3 * v + 2] =
                        0.0;
                }
            }
        };
        std::vector<std::thread> threads;
        const int64_t chunk = (n_v + n_threads - 1) / n_threads;
        for (int i = 1; i < n_threads; i++) {
            const int64_t b = i * chunk, e = std::min(n_v, b + chunk);
            if (b < e) threads.emplace_back(norm_range, b, e);
        }
        norm_range(0, std::min(n_v, chunk));
        for (auto& t : threads) t.join();
    }

    auto emit_range = [&](int64_t begin, int64_t end) {
        for (int64_t j = begin; j < end; j++) {
            const int64_t f = kept[j];
            const int64_t i0 = faces[3 * f], i1 = faces[3 * f + 1],
                          i2 = faces[3 * f + 2];
            std::memcpy(out_a + 3 * j, verts + 3 * i0, 3 * sizeof(double));
            std::memcpy(out_b + 3 * j, verts + 3 * i1, 3 * sizeof(double));
            std::memcpy(out_c + 3 * j, verts + 3 * i2, 3 * sizeof(double));
            const double* fu = fn_unit.data() + 3 * f;
            const int64_t vi[3] = {i0, i1, i2};
            double* outs[3] = {out_na + 3 * j, out_nb + 3 * j,
                               out_nc + 3 * j};
            for (int k = 0; k < 3; k++) {
                if (smooth && n_k && v_ok[vi[k]]) {
                    std::memcpy(outs[k], v_unit.data() + 3 * vi[k],
                                3 * sizeof(double));
                } else {
                    std::memcpy(outs[k], fu, 3 * sizeof(double));
                }
            }
        }
    };
    {
        std::vector<std::thread> threads;
        const int64_t chunk = (n_k + n_threads - 1) / n_threads;
        for (int i = 1; i < n_threads; i++) {
            const int64_t b = i * chunk, e = std::min(n_k, b + chunk);
            if (b < e) threads.emplace_back(emit_range, b, e);
        }
        emit_range(0, std::min(n_k, chunk));
        for (auto& t : threads) t.join();
    }
    return n_k;
}

// ---------------------------------------------------------------------------
// OBJ parser
// ---------------------------------------------------------------------------
// Parses `v`/`f` records from text[0..len). Face tokens keep only the
// position index before any '/'. Outputs are caller-allocated with
// capacities n_verts_cap*3 and n_faces_cap*3 obtained from ptx_count_obj.
// Unparseable floats become NaN; unparseable/short faces get index -1
// (the Python layer then applies the reference's face-validation rules).
void ptx_count_obj(const char* text, int64_t len, int64_t* n_verts,
                   int64_t* n_faces) {
    int64_t v = 0, f = 0;
    int64_t i = 0;
    while (i < len) {
        while (i < len && text[i] == ' ') i++;
        if (i + 1 < len && text[i + 1] == ' ') {
            if (text[i] == 'v') v++;
            else if (text[i] == 'f') f++;
        }
        while (i < len && text[i] != '\n') i++;
        i++;
    }
    *n_verts = v;
    *n_faces = f;
}

// Space-only skip: MUST match ptx_count_obj's whitespace predicate (and the
// reference's space-only eatSpace, ref: src/scene/mesh.cpp:31-36) so the
// count pass and the parse pass agree on which lines are records. A tab- or
// CR-indented line is neither counted nor parsed.
static inline const char* skip_spaces(const char* p, const char* end) {
    while (p < end && *p == ' ') p++;
    return p;
}

void ptx_parse_obj(const char* text, int64_t len, float* verts,
                   int64_t n_verts_cap, int64_t* faces, int64_t n_faces_cap) {
    const char* p = text;
    const char* end = text + len;
    int64_t vi = 0, fi = 0;
    while (p < end) {
        const char* line_end = static_cast<const char*>(
            memchr(p, '\n', static_cast<size_t>(end - p)));
        if (!line_end) line_end = end;
        const char* q = skip_spaces(p, line_end);
        if (q + 1 < line_end && q[1] == ' ') {
            // Defense in depth: never write past the counted capacities even
            // if the two passes ever disagree again.
            if (*q == 'v' && vi >= n_verts_cap) {
            } else if (*q == 'f' && fi >= n_faces_cap) {
            } else if (*q == 'v') {
                q += 2;
                for (int c = 0; c < 3; c++) {
                    q = skip_spaces(q, line_end);
                    char* after = nullptr;
                    float val = strtof(q, &after);
                    if (after == q || after > line_end) {
                        val = NAN;
                        while (q < line_end && *q != ' ') q++;
                    } else {
                        q = after;
                    }
                    verts[3 * vi + c] = val;
                }
                vi++;
            } else if (*q == 'f') {
                q += 2;
                for (int c = 0; c < 3; c++) {
                    q = skip_spaces(q, line_end);
                    char* after = nullptr;
                    long val = strtol(q, &after, 10);
                    if (after == q || after > line_end) {
                        val = 0;  // becomes -1 after the 1-based shift
                        while (q < line_end && *q != ' ' && *q != '/') q++;
                    } else {
                        q = after;
                    }
                    // Skip texture/normal refs: a/b/c -> a.
                    while (q < line_end && *q != ' ') q++;
                    faces[3 * fi + c] = val - 1;
                }
                fi++;
            }
        }
        p = line_end + 1;
    }
}

}  // extern "C"
