// tem_native: sequential graph algorithms for the host side of the pipeline.
//
// The port's own copy of the JAX package's tem_native.cpp, with the same
// semantics: rebuilds of the compiled dependencies torch-em leans on
// (SURVEY.md §2.9): elf.segmentation.mutex_watershed / watershed (C++ via
// nifty) and skimage.segmentation.watershed. These are sequential
// union-find / priority-flood algorithms; they run on the host during
// validation and decoding, so they are implemented natively for speed.
//
// Exposed via ctypes (plain C ABI), built with g++ -O3 at first use by
// ops/native/__init__.py into torch_em_tpu_torch/_build/.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <queue>
#include <random>
#include <unordered_map>
#include <unordered_set>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Union-find with path compression + union by size
// ---------------------------------------------------------------------------
namespace {

struct UnionFind {
    std::vector<int64_t> parent;
    std::vector<int64_t> size;

    explicit UnionFind(int64_t n) : parent(n), size(n, 1) {
        for (int64_t i = 0; i < n; ++i) parent[i] = i;
    }

    int64_t find(int64_t x) {
        int64_t root = x;
        while (parent[root] != root) root = parent[root];
        while (parent[x] != root) {
            int64_t next = parent[x];
            parent[x] = root;
            x = next;
        }
        return root;
    }

    // returns the new root (assumes a != b are roots)
    int64_t merge_roots(int64_t a, int64_t b) {
        if (size[a] < size[b]) std::swap(a, b);
        parent[b] = a;
        size[a] += size[b];
        return a;
    }
};

inline int64_t flat_index(const int64_t* coord, const int64_t* shape, int ndim) {
    int64_t idx = 0;
    for (int d = 0; d < ndim; ++d) idx = idx * shape[d] + coord[d];
    return idx;
}

}  // namespace

// ---------------------------------------------------------------------------
// Seeded watershed: priority flood from seeds on a height map.
// labels: in/out (uint32) — nonzero entries are seeds.
// mask: uint8 (1 = inside) or nullptr.
// Functional spec: skimage.segmentation.watershed (connectivity 1).
// ---------------------------------------------------------------------------
void watershed(const float* hmap, uint32_t* labels, const uint8_t* mask,
               const int64_t* shape, int ndim) {
    int64_t n = 1;
    for (int d = 0; d < ndim; ++d) n *= shape[d];

    // strides for neighbor computation
    int64_t strides[8];
    strides[ndim - 1] = 1;
    for (int d = ndim - 2; d >= 0; --d) strides[d] = strides[d + 1] * shape[d + 1];

    struct QEntry {
        float value;
        int64_t age;
        int64_t index;
    };
    struct Cmp {
        bool operator()(const QEntry& a, const QEntry& b) const {
            if (a.value != b.value) return a.value > b.value;  // min-heap on value
            return a.age > b.age;                              // FIFO tie-break
        }
    };
    std::priority_queue<QEntry, std::vector<QEntry>, Cmp> queue;
    std::vector<uint8_t> in_queue(n, 0);

    int64_t age = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (labels[i] != 0 && (!mask || mask[i])) {
            queue.push({hmap[i], age++, i});
            in_queue[i] = 1;
        }
    }

    std::vector<int64_t> coord(ndim);
    while (!queue.empty()) {
        QEntry e = queue.top();
        queue.pop();
        int64_t idx = e.index;
        uint32_t lab = labels[idx];

        // decode coordinate
        int64_t rem = idx;
        for (int d = 0; d < ndim; ++d) {
            coord[d] = rem / strides[d];
            rem = rem % strides[d];
        }
        for (int d = 0; d < ndim; ++d) {
            for (int step = -1; step <= 1; step += 2) {
                int64_t c = coord[d] + step;
                if (c < 0 || c >= shape[d]) continue;
                int64_t nidx = idx + step * strides[d];
                if (in_queue[nidx] || labels[nidx] != 0) continue;
                if (mask && !mask[nidx]) continue;
                labels[nidx] = lab;
                queue.push({hmap[nidx], age++, nidx});
                in_queue[nidx] = 1;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// Mutex watershed (Wolf et al.): Kruskal over attractive (short-range) and
// repulsive (long-range) edges with mutex constraints.
//
// affinities: (n_offsets, *shape) float32 in the DISAFFINITY convention
// (1 = boundary). The first `ndim` offsets are attractive (merge priority
// 1 - aff), the rest repulsive (separation priority aff) — the convention of
// elf.segmentation.mutex_watershed (reference util/segmentation.py:15,81).
// strides subsample the repulsive edges; mask (uint8, may be null) restricts
// the segmentation domain. out: uint32 labels (consecutive from 1; 0 outside
// the mask).
// ---------------------------------------------------------------------------
void mutex_watershed(const float* affinities, const int64_t* offsets, int n_offsets,
                     const int64_t* shape, int ndim, const int64_t* strides,
                     int randomize_strides, uint64_t seed, const uint8_t* mask,
                     uint32_t* out) {
    int64_t n = 1;
    for (int d = 0; d < ndim; ++d) n *= shape[d];

    int64_t ax_strides[8];
    ax_strides[ndim - 1] = 1;
    for (int d = ndim - 2; d >= 0; --d) ax_strides[d] = ax_strides[d + 1] * shape[d + 1];

    struct Edge {
        float weight;     // priority (higher first)
        int64_t u, v;
        uint8_t repulsive;
    };
    std::vector<Edge> edges;
    edges.reserve(static_cast<size_t>(n) * 2);

    int64_t stride_prod = 1;
    for (int d = 0; d < ndim; ++d) stride_prod *= strides[d];
    std::mt19937_64 rng(seed);
    std::uniform_real_distribution<double> uniform(0.0, 1.0);
    const double keep_prob = 1.0 / static_cast<double>(stride_prod);

    std::vector<int64_t> coord(ndim);
    for (int64_t idx = 0; idx < n; ++idx) {
        if (mask && !mask[idx]) continue;
        int64_t rem = idx;
        for (int d = 0; d < ndim; ++d) {
            coord[d] = rem / ax_strides[d];
            rem = rem % ax_strides[d];
        }
        for (int c = 0; c < n_offsets; ++c) {
            bool repulsive = c >= ndim;
            // neighbor coordinate
            bool inside = true;
            int64_t nidx = idx;
            for (int d = 0; d < ndim; ++d) {
                int64_t nc = coord[d] + offsets[c * ndim + d];
                if (nc < 0 || nc >= shape[d]) { inside = false; break; }
                nidx += offsets[c * ndim + d] * ax_strides[d];
            }
            if (!inside) continue;
            if (mask && !mask[nidx]) continue;
            if (repulsive && stride_prod > 1) {
                if (randomize_strides) {
                    if (uniform(rng) >= keep_prob) continue;
                } else {
                    bool on_grid = true;
                    for (int d = 0; d < ndim; ++d) {
                        if (coord[d] % strides[d] != 0) { on_grid = false; break; }
                    }
                    if (!on_grid) continue;
                }
            }
            float aff = affinities[c * n + idx];
            float weight = repulsive ? aff : (1.0f - aff);
            edges.push_back({weight, idx, nidx, static_cast<uint8_t>(repulsive)});
        }
    }

    std::stable_sort(edges.begin(), edges.end(),
                     [](const Edge& a, const Edge& b) { return a.weight > b.weight; });

    UnionFind uf(n);
    // mutex constraints between cluster roots
    std::unordered_map<int64_t, std::unordered_set<int64_t>> mutexes;

    auto check_mutex = [&](int64_t ra, int64_t rb) -> bool {
        auto it = mutexes.find(ra);
        return it != mutexes.end() && it->second.count(rb) > 0;
    };
    auto add_mutex = [&](int64_t ra, int64_t rb) {
        mutexes[ra].insert(rb);
        mutexes[rb].insert(ra);
    };
    auto merge_mutexes = [&](int64_t root, int64_t merged) {
        auto it = mutexes.find(merged);
        if (it == mutexes.end()) return;
        auto& target = mutexes[root];
        for (int64_t partner : it->second) {
            auto pit = mutexes.find(partner);
            if (pit != mutexes.end()) {
                pit->second.erase(merged);
                pit->second.insert(root);
            }
            target.insert(partner);
        }
        mutexes.erase(merged);
    };

    for (const Edge& e : edges) {
        int64_t ru = uf.find(e.u);
        int64_t rv = uf.find(e.v);
        if (ru == rv) continue;
        if (e.repulsive) {
            if (!check_mutex(ru, rv)) add_mutex(ru, rv);
        } else {
            if (check_mutex(ru, rv)) continue;
            int64_t new_root = uf.merge_roots(ru, rv);
            int64_t merged = (new_root == ru) ? rv : ru;
            merge_mutexes(new_root, merged);
        }
    }

    // consecutive labels from 1 (0 = outside mask)
    std::unordered_map<int64_t, uint32_t> root_to_label;
    uint32_t next_label = 1;
    for (int64_t i = 0; i < n; ++i) {
        if (mask && !mask[i]) {
            out[i] = 0;
            continue;
        }
        int64_t r = uf.find(i);
        auto it = root_to_label.find(r);
        if (it == root_to_label.end()) {
            root_to_label.emplace(r, next_label);
            out[i] = next_label++;
        } else {
            out[i] = it->second;
        }
    }
}

// ---------------------------------------------------------------------------
// Connected components on a label image (same nonzero id + adjacency)
// connectivity 1. out gets consecutive ids from 1.
// ---------------------------------------------------------------------------
void connected_components_labels(const uint32_t* seg, const int64_t* shape, int ndim,
                                 uint32_t* out) {
    int64_t n = 1;
    for (int d = 0; d < ndim; ++d) n *= shape[d];
    int64_t strides[8];
    strides[ndim - 1] = 1;
    for (int d = ndim - 2; d >= 0; --d) strides[d] = strides[d + 1] * shape[d + 1];

    UnionFind uf(n);
    std::vector<int64_t> coord(ndim);
    for (int64_t idx = 0; idx < n; ++idx) {
        if (seg[idx] == 0) continue;
        int64_t rem = idx;
        for (int d = 0; d < ndim; ++d) {
            coord[d] = rem / strides[d];
            rem = rem % strides[d];
        }
        for (int d = 0; d < ndim; ++d) {
            if (coord[d] + 1 >= shape[d]) continue;
            int64_t nidx = idx + strides[d];
            if (seg[nidx] == seg[idx]) {
                int64_t ru = uf.find(idx), rv = uf.find(nidx);
                if (ru != rv) uf.merge_roots(ru, rv);
            }
        }
    }
    std::unordered_map<int64_t, uint32_t> root_to_label;
    uint32_t next_label = 1;
    for (int64_t i = 0; i < n; ++i) {
        if (seg[i] == 0) {
            out[i] = 0;
            continue;
        }
        int64_t r = uf.find(i);
        auto it = root_to_label.find(r);
        if (it == root_to_label.end()) {
            root_to_label.emplace(r, next_label);
            out[i] = next_label++;
        } else {
            out[i] = it->second;
        }
    }
}

}  // extern "C"
