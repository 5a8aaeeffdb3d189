// HDBSCAN, as scikit-learn's sklearn.cluster.HDBSCAN computes it with its defaults (euclidean
// distance, min_samples = min_cluster_size, alpha 1, the excess-of-mass selection, no single
// cluster), in float64, so that the labels equal sklearn's id for id:
//
// - tem_hdbscan_mst: each point's core distance (the distance to its min_samples-th nearest
//   point, itself included), then Prim's algorithm over the mutual reachability
//   max(core_a, core_b, |a - b|) from point 0, as sklearn's _linkage.pyx:mst_from_data_matrix
//   runs it: among equal distances the lowest index joins. Distances are summed over the
//   dimensions in order and rooted, as sklearn's EuclideanDistance64; this file is built with
//   -ffp-contract=off so that no fused multiply-add changes a rounding. Both passes split the
//   points over threads; Prim's threads meet at a barrier once per joined point.
// - the caller orders the edges by weight (numpy's argsort, the same call as sklearn's
//   hdbscan.py:_process_mst, whose order of equal weights decides ties);
// - tem_hdbscan_labels: the single-linkage tree (_linkage.pyx:make_single_linkage), the condensed
//   tree, the stabilities, the excess-of-mass selection with cluster_selection_epsilon and the
//   labelling (_tree.pyx), which numbers the selected clusters in the order of their ids in the
//   condensed tree and gives noise -1.
//
// Built with g++ into a shared library at first use (ops/native/__init__.py) and called through
// ctypes, which releases the GIL for the call.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <limits>
#include <set>
#include <thread>
#include <vector>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();

inline double squared_distance(const double* a, const double* b, int64_t d) {
  double sum = 0.0;
  for (int64_t k = 0; k < d; ++k) {
    const double t = a[k] - b[k];
    sum += t * t;
  }
  return sum;
}

// Run body(t) for t in [0, threads) on threads - 1 new threads and this one.
template <class Body>
void parallel(int threads, Body body) {
  std::vector<std::thread> pool;
  for (int t = 1; t < threads; ++t) pool.emplace_back(body, t);
  body(0);
  for (auto& th : pool) th.join();
}

struct Best {
  double value = std::numeric_limits<double>::max();  // sklearn starts from DBL_MAX
  int64_t index = 0;
};

// bfs_from_hierarchy: node, then its children level by level, left before right.
void bfs(const std::vector<int64_t>& left, const std::vector<int64_t>& right, int64_t n, int64_t root,
         std::vector<int64_t>& out) {
  out.clear();
  std::vector<int64_t> queue{root}, next;
  while (!queue.empty()) {
    out.insert(out.end(), queue.begin(), queue.end());
    next.clear();
    for (int64_t x : queue) {
      if (x >= n) {
        next.push_back(left[x - n]);
        next.push_back(right[x - n]);
      }
    }
    queue.swap(next);
  }
}

struct Row {
  int64_t parent, child;
  double lambda;
  int64_t size;
};

}  // namespace

extern "C" {

// Core distances and the minimum spanning tree of the mutual reachability of the n points x
// (n x d, row-major). Writes the n - 1 edges in the order Prim's algorithm adds them: src[i] ->
// dst[i] at weight[i]. Returns 0, or -1 when min_samples is not in [1, n].
int tem_hdbscan_mst(const double* x, int64_t n, int64_t d, int64_t min_samples, int threads, int64_t* src,
                    int64_t* dst, double* weight) {
  if (n < 2 || min_samples < 1 || min_samples > n) return -1;
  threads = std::max(1, std::min<int>(threads, static_cast<int>(n)));
  const int64_t chunk = (n + threads - 1) / threads;

  // the min_samples smallest squared distances of each point in a max-heap; the root of the
  // largest is the core distance (the root is monotone, so it commutes with the selection)
  std::vector<double> core(n);
  parallel(threads, [&](int t) {
    std::vector<double> heap;
    for (int64_t i = t * chunk; i < std::min(n, (t + 1) * chunk); ++i) {
      heap.clear();
      for (int64_t j = 0; j < n; ++j) {
        const double sq = squared_distance(x + i * d, x + j * d, d);
        if (static_cast<int64_t>(heap.size()) < min_samples) {
          heap.push_back(sq);
          std::push_heap(heap.begin(), heap.end());
        } else if (sq < heap.front()) {
          std::pop_heap(heap.begin(), heap.end());
          heap.back() = sq;
          std::push_heap(heap.begin(), heap.end());
        }
      }
      core[i] = std::sqrt(heap.front());
    }
  });

  std::vector<uint8_t> in_tree(n, 0);
  std::vector<double> min_reach(n, kInf);
  std::vector<int64_t> sources(n, 1);  // as sklearn's np.ones; every point's source is set before it joins
  std::vector<Best> best(threads);
  std::atomic<int64_t> round{0};
  std::atomic<int> done{0};
  int64_t current = 0;

  auto scan = [&](int t) {
    const double* xc = x + current * d;
    const double core_c = core[current];
    Best b;
    for (int64_t j = t * chunk; j < std::min(n, (t + 1) * chunk); ++j) {
      if (in_tree[j]) continue;
      double candidate = min_reach[j];
      const double cores = std::max(core_c, core[j]);
      if (cores < candidate) {  // else the reach, at least cores, cannot lower the candidate
        const double reach = std::max(cores, std::sqrt(squared_distance(xc, x + j * d, d)));
        if (reach < candidate) {
          min_reach[j] = candidate = reach;
          sources[j] = current;
        }
      }
      if (candidate < b.value) {
        b.value = candidate;
        b.index = j;
      }
    }
    best[t] = b;
  };

  std::vector<std::thread> workers;
  for (int t = 1; t < threads; ++t) {
    workers.emplace_back([&, t] {
      for (int64_t seen = 0;;) {
        int64_t r;
        while ((r = round.load(std::memory_order_acquire)) == seen) std::this_thread::yield();
        if (r < 0) return;
        seen = r;
        scan(t);
        done.fetch_add(1, std::memory_order_acq_rel);
      }
    });
  }
  for (int64_t i = 0; i < n - 1; ++i) {
    in_tree[current] = 1;
    done.store(0, std::memory_order_relaxed);
    round.store(i + 1, std::memory_order_release);
    scan(0);
    while (done.load(std::memory_order_acquire) != threads - 1) std::this_thread::yield();
    Best b;
    for (const Best& c : best) {
      if (c.value < b.value) b = c;  // chunks in index order: the lowest index among equals
    }
    src[i] = sources[b.index];
    dst[i] = b.index;
    weight[i] = b.value;
    current = b.index;
  }
  round.store(-1, std::memory_order_release);
  for (auto& th : workers) th.join();
  return 0;
}

// Labels (-1 for noise) of the n points from the n - 1 edges of their minimum spanning tree,
// sorted by weight. Returns 0, or -1 when min_cluster_size < 2.
int tem_hdbscan_labels(const int64_t* src, const int64_t* dst, const double* weight, int64_t n,
                       int64_t min_cluster_size, double epsilon, int64_t* labels) {
  if (n < 2 || min_cluster_size < 2) return -1;
  const int64_t m = min_cluster_size;

  // single linkage: merge i joins the clusters of its two ends into node n + i
  std::vector<int64_t> uf_parent(2 * n - 1, -1), uf_size(2 * n - 1, 0);
  std::fill(uf_size.begin(), uf_size.begin() + n, 1);
  auto find = [&](int64_t a) {
    int64_t root = a;
    while (uf_parent[root] != -1) root = uf_parent[root];
    while (uf_parent[a] != -1 && uf_parent[a] != root) {
      const int64_t next = uf_parent[a];
      uf_parent[a] = root;
      a = next;
    }
    return root;
  };
  std::vector<int64_t> left(n - 1), right(n - 1), size(n - 1);
  std::vector<double> value(n - 1);
  for (int64_t i = 0; i < n - 1; ++i) {
    const int64_t a = find(src[i]), b = find(dst[i]);
    left[i] = a;
    right[i] = b;
    value[i] = weight[i];
    size[i] = uf_size[a] + uf_size[b];
    uf_parent[a] = uf_parent[b] = n + i;
    uf_size[n + i] = size[i];
  }

  // the condensed tree (_condense_tree)
  const int64_t root = 2 * (n - 1);
  std::vector<int64_t> nodes, sub;
  bfs(left, right, n, root, nodes);
  std::vector<int64_t> relabel(root + 1, 0);
  std::vector<uint8_t> ignore(root + 1, 0);
  relabel[root] = n;
  int64_t next_label = n + 1;
  std::vector<Row> rows;
  auto drop = [&](int64_t from, int64_t subtree, double lambda) {  // the points of a small subtree fall out
    bfs(left, right, n, subtree, sub);
    for (int64_t s : sub) {
      if (s < n) rows.push_back({relabel[from], s, lambda, 1});
      ignore[s] = 1;
    }
  };
  for (int64_t node : nodes) {
    if (ignore[node] || node < n) continue;
    const int64_t i = node - n, l = left[i], r = right[i];
    const double lambda = value[i] > 0.0 ? 1.0 / value[i] : kInf;
    const int64_t lc = l >= n ? size[l - n] : 1, rc = r >= n ? size[r - n] : 1;
    if (lc >= m && rc >= m) {
      relabel[l] = next_label++;
      rows.push_back({relabel[node], relabel[l], lambda, lc});
      relabel[r] = next_label++;
      rows.push_back({relabel[node], relabel[r], lambda, rc});
    } else if (lc < m && rc < m) {
      drop(node, l, lambda);
      drop(node, r, lambda);
    } else if (lc < m) {
      relabel[r] = relabel[node];
      drop(node, l, lambda);
    } else {
      relabel[l] = relabel[node];
      drop(node, r, lambda);
    }
  }

  // stabilities (_compute_stability), summed in the rows' order
  const int64_t n_nodes = next_label;  // points, then the clusters n .. next_label - 1
  std::vector<double> births(n_nodes, std::numeric_limits<double>::quiet_NaN());
  for (const Row& row : rows) births[row.child] = row.lambda;
  births[n] = 0.0;
  std::vector<double> stability(n_nodes, 0.0);
  for (const Row& row : rows) stability[row.parent] += (row.lambda - births[row.parent]) * double(row.size);

  // excess of mass (_get_clusters), from the last cluster to the root's children
  std::vector<std::vector<int64_t>> children(n_nodes);
  std::vector<int64_t> cluster_parent(n_nodes, -1);
  for (const Row& row : rows) {
    if (row.size > 1) {
      children[row.parent].push_back(row.child);
      cluster_parent[row.child] = row.parent;
    }
  }
  auto descendants = [&](int64_t node, std::vector<int64_t>& out) {  // bfs_from_cluster_tree, node first
    out.assign(1, node);
    for (size_t k = 0; k < out.size(); ++k)
      for (int64_t c : children[out[k]]) out.push_back(c);
  };
  std::vector<uint8_t> is_cluster(n_nodes, 0);
  for (int64_t c = n + 1; c < n_nodes; ++c) is_cluster[c] = 1;
  for (int64_t node = n_nodes - 1; node > n; --node) {
    double subtree = 0.0;
    for (int64_t c : children[node]) subtree += stability[c];
    if (subtree > stability[node]) {
      is_cluster[node] = 0;
      stability[node] = subtree;
    } else {
      descendants(node, sub);
      for (size_t k = 1; k < sub.size(); ++k) is_cluster[sub[k]] = 0;
    }
  }
  if (epsilon != 0.0 && n_nodes > n + 1) {  // epsilon_search over the EOM clusters
    auto eps_of = [&](int64_t c) { return 1.0 / births[c]; };
    std::set<int64_t> selected;
    std::vector<uint8_t> processed(n_nodes, 0);
    for (int64_t leaf = n + 1; leaf < n_nodes; ++leaf) {
      if (!is_cluster[leaf]) continue;
      if (eps_of(leaf) < epsilon) {
        if (processed[leaf]) continue;
        int64_t node = leaf;  // traverse_upwards
        while (true) {
          const int64_t parent = cluster_parent[node];
          if (parent == n) break;
          if (eps_of(parent) > epsilon) {
            node = parent;
            break;
          }
          node = parent;
        }
        selected.insert(node);
        descendants(node, sub);
        for (size_t k = 1; k < sub.size(); ++k) processed[sub[k]] = 1;
      } else {
        selected.insert(leaf);
      }
    }
    for (int64_t c = n + 1; c < n_nodes; ++c) is_cluster[c] = selected.count(c) ? 1 : 0;
  }

  // labelling (_do_labelling): a point takes its nearest selected ancestor, numbered in id order
  std::vector<int64_t> label_of(n_nodes, -1);
  int64_t k = 0;
  for (int64_t c = n + 1; c < n_nodes; ++c)
    if (is_cluster[c]) label_of[c] = k++;
  std::vector<int64_t> owner(n_nodes, n);
  for (const Row& row : rows) owner[row.child] = is_cluster[row.child] ? row.child : owner[row.parent];
  for (int64_t p = 0; p < n; ++p) labels[p] = owner[p] == n ? -1 : label_of[owner[p]];
  return 0;
}

}  // extern "C"
