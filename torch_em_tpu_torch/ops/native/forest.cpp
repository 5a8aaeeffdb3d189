// Random forests of classification trees, grown as scikit-learn 1.9's RandomForestClassifier grows
// them with its dense best splitter and depth-first builder, so that every tree equals sklearn's
// node for node: the same node order, features, thresholds (bitwise), children, class fractions,
// impurities and sample counts.
//
// The caller (shallow2deep/forest.py) draws what sklearn draws from numpy's RandomState: each
// tree's bootstrap counts (the sample weights of _forest.py:_parallel_build_trees) and its
// splitter's seed (_splitter.pyx:Splitter.init). This file grows the trees:
//
// - the samples of positive weight, in index order (Splitter.init);
// - the depth-first builder (_tree.pyx:DepthFirstTreeBuilder.build): a stack, the right child
//   pushed before the left, a node a leaf when it is too deep, holds fewer than
//   min_samples_split or 2 min_samples_leaf samples or less than 2 min_weight_leaf weight, or its
//   impurity is at most EPSILON; after a split search, when no split was found or its
//   improvement plus EPSILON is below min_impurity_decrease;
// - the split search (_splitter.pyx:node_split_best): features drawn without replacement by
//   Fisher-Yates from sklearn's xorshift generator (_random.pxd:our_rand_r), the features found
//   constant carried to the children, each drawn feature's values sorted, the positions between
//   values more than FEATURE_THRESHOLD (float32) apart scanned from the left, a candidate replacing
//   the best only when its proxy improvement is strictly larger, the threshold the midpoint
//   a / 2 + b / 2 in float64;
// - Gini and entropy (_criterion.pyx), entropy with log(x) = ln(x) / ln(2).
//
// The class sums are sums of integer weights, exact in float64, so the order of samples with equal
// values (sklearn's introsort is not stable) changes no sum: any sort gives sklearn's trees. This
// file is built with -ffp-contract=off so that no fused multiply-add changes a rounding. The trees
// are grown on a pool of threads, each tree by one thread; the trees do not depend on their number.
//
// Built with g++ into a shared library at first use (ops/native/__init__.py) and called through
// ctypes, which releases the GIL for the call.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <new>
#include <thread>
#include <vector>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();
constexpr double kEpsilon = std::numeric_limits<double>::epsilon();  // _tree.pyx: np.finfo('double').eps
const float kFeatureThreshold = static_cast<float>(1e-7);           // _partitioner.pxd, a float32
constexpr int64_t kLeaf = -1;                                        // _tree.pyx: TREE_LEAF
constexpr int64_t kUndefined = -2;                                   // TREE_UNDEFINED
constexpr uint32_t kRandRMax = 2147483647u;                          // _random.pxd: RAND_R_MAX

// _random.pxd:our_rand_r, a 32-bit xorshift
inline uint32_t our_rand_r(uint32_t* seed) {
  if (*seed == 0) *seed = 1;
  *seed ^= static_cast<uint32_t>(*seed << 13);
  *seed ^= static_cast<uint32_t>(*seed >> 17);
  *seed ^= static_cast<uint32_t>(*seed << 5);
  return *seed % (kRandRMax + 1u);
}

// _utils.pyx:rand_int, in [low, high)
inline int64_t rand_int(int64_t low, int64_t high, uint32_t* seed) {
  return low + static_cast<int64_t>(our_rand_r(seed)) % (high - low);
}

// _utils.pyx:log
inline double log2_of(double x) { return std::log(x) / std::log(2.0); }

struct Params {
  int64_t n_samples, n_features, n_classes;
  int criterion;  // 0 Gini, 1 entropy
  int64_t max_features, max_depth, min_samples_split, min_samples_leaf;
  double min_weight_leaf, min_impurity_decrease;
};

struct TreeOut {
  std::vector<int64_t> feature, left, right, n_node_samples;
  std::vector<double> threshold, impurity, weighted_n_node_samples, value;
};

struct Split {
  int64_t pos, feature;
  double threshold, improvement, impurity_left, impurity_right;
};

struct StackRecord {
  int64_t start, end, depth, parent;
  bool is_left;
  double impurity;
  int64_t n_constant_features;
};

struct ValueIndex {
  float value;
  int64_t sample;
};

class TreeBuilder {
 public:
  TreeBuilder(const Params& p, const float* X, const int32_t* y)
      : p_(p), X_(X), y_(y), sum_total_(p.n_classes), sum_left_(p.n_classes), sum_right_(p.n_classes) {}

  void build(const int32_t* counts, uint32_t seed, TreeOut& out) {
    const int64_t n = p_.n_samples, k = p_.n_classes;
    rand_r_state_ = seed;
    // Splitter.init: the samples of positive weight in index order; the total weight of all
    weight_.assign(n, 1.0);
    samples_.clear();
    weighted_n_samples_ = 0.0;
    for (int64_t i = 0; i < n; ++i) {
      if (counts != nullptr) weight_[i] = static_cast<double>(counts[i]);
      if (weight_[i] != 0.0) samples_.push_back(i);
      weighted_n_samples_ += weight_[i];
    }
    features_.resize(p_.n_features);
    for (int64_t f = 0; f < p_.n_features; ++f) features_[f] = f;
    constant_features_.assign(p_.n_features, 0);
    feature_values_.resize(n);
    sort_buffer_.resize(n);

    std::vector<StackRecord> stack;
    stack.push_back({0, static_cast<int64_t>(samples_.size()), 0, kUndefined, false, kInf, 0});
    bool first = true;
    Split split{};
    while (!stack.empty()) {
      const StackRecord rec = stack.back();
      stack.pop_back();
      const int64_t start = rec.start, end = rec.end, n_node_samples = end - start;
      double impurity = rec.impurity;
      int64_t n_constant_features = rec.n_constant_features;
      node_reset(start, end);
      bool is_leaf = rec.depth >= p_.max_depth || n_node_samples < p_.min_samples_split ||
                     n_node_samples < 2 * p_.min_samples_leaf || weighted_n_node_samples_ < 2 * p_.min_weight_leaf;
      if (first) {
        impurity = node_impurity();
        first = false;
      }
      is_leaf = is_leaf || impurity <= kEpsilon;
      if (!is_leaf) {
        node_split(start, end, impurity, &n_constant_features, &split);
        is_leaf = split.pos >= end || split.improvement + kEpsilon < p_.min_impurity_decrease;
      }
      const int64_t node_id = static_cast<int64_t>(out.feature.size());
      if (rec.parent != kUndefined) (rec.is_left ? out.left : out.right)[rec.parent] = node_id;
      out.feature.push_back(is_leaf ? kUndefined : split.feature);
      out.threshold.push_back(is_leaf ? static_cast<double>(kUndefined) : split.threshold);
      out.left.push_back(kLeaf);
      out.right.push_back(kLeaf);
      out.impurity.push_back(impurity);
      out.n_node_samples.push_back(n_node_samples);
      out.weighted_n_node_samples.push_back(weighted_n_node_samples_);
      // ClassificationCriterion.node_value: the class fractions
      for (int64_t c = 0; c < k; ++c) out.value.push_back(sum_total_[c] / weighted_n_node_samples_);
      if (!is_leaf) {
        stack.push_back({split.pos, end, rec.depth + 1, node_id, false, split.impurity_right, n_constant_features});
        stack.push_back({start, split.pos, rec.depth + 1, node_id, true, split.impurity_left, n_constant_features});
      }
    }
  }

 private:
  // ClassificationCriterion.init over samples[start:end]
  void node_reset(int64_t start, int64_t end) {
    std::fill(sum_total_.begin(), sum_total_.end(), 0.0);
    weighted_n_node_samples_ = 0.0;
    for (int64_t q = start; q < end; ++q) {
      const int64_t i = samples_[q];
      sum_total_[y_[i]] += weight_[i];
      weighted_n_node_samples_ += weight_[i];
    }
  }

  double impurity_of(const std::vector<double>& sums, double weight) const {
    if (p_.criterion == 0) {  // Gini
      double sq_count = 0.0;
      for (int64_t c = 0; c < p_.n_classes; ++c) sq_count += sums[c] * sums[c];
      return 1.0 - sq_count / (weight * weight);
    }
    double entropy = 0.0;
    for (int64_t c = 0; c < p_.n_classes; ++c) {
      double count_k = sums[c];
      if (count_k > 0.0) {
        count_k /= weight;
        entropy -= count_k * log2_of(count_k);
      }
    }
    return entropy;
  }

  double node_impurity() const { return impurity_of(sum_total_, weighted_n_node_samples_); }

  // the left child's sums from samples[start:pos]; the right child's by difference
  void update(int64_t start, int64_t pos) {
    std::fill(sum_left_.begin(), sum_left_.end(), 0.0);
    weighted_n_left_ = 0.0;
    for (int64_t q = start; q < pos; ++q) {
      const int64_t i = samples_[q];
      sum_left_[y_[i]] += weight_[i];
      weighted_n_left_ += weight_[i];
    }
    weighted_n_right_ = weighted_n_node_samples_ - weighted_n_left_;
    for (int64_t c = 0; c < p_.n_classes; ++c) sum_right_[c] = sum_total_[c] - sum_left_[c];
  }

  // moves samples[pos:new_pos] to the left child (Criterion.update from a position scanned before)
  void advance(int64_t pos, int64_t new_pos) {
    for (int64_t q = pos; q < new_pos; ++q) {
      const int64_t i = samples_[q];
      sum_left_[y_[i]] += weight_[i];
      weighted_n_left_ += weight_[i];
    }
    weighted_n_right_ = weighted_n_node_samples_ - weighted_n_left_;
    for (int64_t c = 0; c < p_.n_classes; ++c) sum_right_[c] = sum_total_[c] - sum_left_[c];
  }

  void children_impurity(double* left, double* right) const {
    *left = impurity_of(sum_left_, weighted_n_left_);
    *right = impurity_of(sum_right_, weighted_n_right_);
  }

  // DensePartitioner.sort_samples_and_feature_values, without missing values
  void sort_by(int64_t feature, int64_t start, int64_t end) {
    const float* column = X_ + feature * p_.n_samples;
    for (int64_t q = start; q < end; ++q) sort_buffer_[q] = {column[samples_[q]], samples_[q]};
    std::sort(sort_buffer_.begin() + start, sort_buffer_.begin() + end,
              [](const ValueIndex& a, const ValueIndex& b) { return a.value < b.value; });
    for (int64_t q = start; q < end; ++q) {
      feature_values_[q] = sort_buffer_[q].value;
      samples_[q] = sort_buffer_[q].sample;
    }
  }

  // _splitter.pyx:node_split_best on dense data without missing values
  void node_split(int64_t start, int64_t end, double impurity, int64_t* n_constant_features, Split* split) {
    int64_t* features = features_.data();
    int64_t* constant_features = constant_features_.data();
    const float* fv = feature_values_.data();
    Split best{end, 0, 0.0, -kInf, kInf, kInf};
    Split current = best;
    double best_proxy_improvement = -kInf;
    int64_t f_i = p_.n_features, n_visited_features = 0, n_found_constants = 0, n_drawn_constants = 0;
    const int64_t n_known_constants = *n_constant_features;
    int64_t n_total_constants = n_known_constants;

    while (f_i > n_total_constants &&
           (n_visited_features < p_.max_features || n_visited_features <= n_found_constants + n_drawn_constants)) {
      ++n_visited_features;
      int64_t f_j = rand_int(n_drawn_constants, f_i - n_found_constants, &rand_r_state_);
      if (f_j < n_known_constants) {
        std::swap(features[n_drawn_constants], features[f_j]);
        ++n_drawn_constants;
        continue;
      }
      f_j += n_found_constants;
      current.feature = features[f_j];
      sort_by(current.feature, start, end);
      if (fv[end - 1] <= fv[start] + kFeatureThreshold) {
        std::swap(features[f_j], features[n_total_constants]);
        ++n_found_constants;
        ++n_total_constants;
        continue;
      }
      --f_i;
      std::swap(features[f_i], features[f_j]);

      update(start, start);  // Criterion.reset
      int64_t p = start, scanned = start;
      while (p < end) {
        // DensePartitioner.next_p
        ++p;
        while (p < end && fv[p] <= fv[p - 1] + kFeatureThreshold) ++p;
        const int64_t p_prev = p - 1;
        if (p == end) continue;
        const int64_t n_left = p - start, n_right = end - p;
        if (n_left < p_.min_samples_leaf || n_right < p_.min_samples_leaf) continue;
        current.pos = p;
        advance(scanned, p);
        scanned = p;
        if (weighted_n_left_ < p_.min_weight_leaf || weighted_n_right_ < p_.min_weight_leaf) continue;
        double impurity_left, impurity_right;
        children_impurity(&impurity_left, &impurity_right);
        // Criterion.proxy_impurity_improvement
        const double proxy = -weighted_n_right_ * impurity_right - weighted_n_left_ * impurity_left;
        if (proxy > best_proxy_improvement) {
          best_proxy_improvement = proxy;
          current.threshold = fv[p_prev] / 2.0 + fv[p] / 2.0;
          best = current;
        }
      }
    }

    if (best.pos < end) {
      // DensePartitioner.partition_samples_final
      const float* column = X_ + best.feature * p_.n_samples;
      int64_t lo = start, hi = end;
      while (lo < hi) {
        if (static_cast<double>(column[samples_[lo]]) <= best.threshold) {
          ++lo;
        } else {
          --hi;
          std::swap(samples_[lo], samples_[hi]);
        }
      }
      update(start, best.pos);
      children_impurity(&best.impurity_left, &best.impurity_right);
      // Criterion.impurity_improvement
      best.improvement = (weighted_n_node_samples_ / weighted_n_samples_) *
                         (impurity - (weighted_n_right_ / weighted_n_node_samples_ * best.impurity_right) -
                          (weighted_n_left_ / weighted_n_node_samples_ * best.impurity_left));
    }
    // the known constants keep their order for the siblings and children; the new ones follow them
    std::memcpy(features, constant_features, sizeof(int64_t) * n_known_constants);
    std::memcpy(constant_features + n_known_constants, features + n_known_constants,
                sizeof(int64_t) * n_found_constants);
    *n_constant_features = n_total_constants;
    *split = best;
  }

  const Params& p_;
  const float* X_;
  const int32_t* y_;
  uint32_t rand_r_state_ = 0;
  std::vector<double> weight_, sum_total_, sum_left_, sum_right_;
  std::vector<int64_t> samples_, features_, constant_features_;
  std::vector<float> feature_values_;
  std::vector<ValueIndex> sort_buffer_;
  double weighted_n_samples_ = 0.0, weighted_n_node_samples_ = 0.0, weighted_n_left_ = 0.0,
         weighted_n_right_ = 0.0;
};

struct Forest {
  std::vector<TreeOut> trees;
};

}  // namespace

extern "C" {

// Grow n_trees trees on threads threads. X is feature-major float32 (n_features, n_samples), y the
// classes encoded as 0..n_classes-1, counts (n_trees, n_samples) each tree's bootstrap counts or
// null for weight 1 everywhere, seeds each tree's splitter seed. Returns a handle for
// tem_forest_sizes / tem_forest_copy / tem_forest_free, or null when memory ran out.
void* tem_forest_fit(const float* X, const int32_t* y, int64_t n_samples, int64_t n_features, int64_t n_classes,
                     int64_t n_trees, const int32_t* counts, const uint32_t* seeds, int criterion,
                     int64_t max_features, int64_t max_depth, int64_t min_samples_split, int64_t min_samples_leaf,
                     double min_weight_leaf, double min_impurity_decrease, int threads) {
  const Params params{n_samples, n_features, n_classes, criterion, max_features, max_depth,
                      min_samples_split, min_samples_leaf, min_weight_leaf, min_impurity_decrease};
  Forest* forest = new (std::nothrow) Forest;
  if (forest == nullptr) return nullptr;
  std::atomic<int64_t> next{0};
  std::atomic<bool> failed{false};
  try {
    forest->trees.resize(n_trees);
    auto work = [&]() {
      try {
        TreeBuilder builder(params, X, y);
        for (int64_t t = next++; t < n_trees && !failed; t = next++) {
          builder.build(counts == nullptr ? nullptr : counts + t * n_samples, seeds[t], forest->trees[t]);
        }
      } catch (const std::bad_alloc&) {
        failed = true;
      }
    };
    std::vector<std::thread> pool;
    for (int t = 1; t < std::max(1, threads); ++t) pool.emplace_back(work);
    work();
    for (auto& th : pool) th.join();
  } catch (const std::exception&) {
    failed = true;
  }
  if (failed) {
    delete forest;
    return nullptr;
  }
  return forest;
}

// each tree's node count
void tem_forest_sizes(void* handle, int64_t* node_counts) {
  const Forest* forest = static_cast<Forest*>(handle);
  for (size_t t = 0; t < forest->trees.size(); ++t) {
    node_counts[t] = static_cast<int64_t>(forest->trees[t].feature.size());
  }
}

// the trees' node arrays, concatenated in tree order (value: n_classes per node)
void tem_forest_copy(void* handle, int64_t n_classes, int64_t* feature, double* threshold, int64_t* left,
                     int64_t* right, double* value, double* impurity, int64_t* n_node_samples,
                     double* weighted_n_node_samples) {
  const Forest* forest = static_cast<Forest*>(handle);
  int64_t at = 0;
  for (const TreeOut& tree : forest->trees) {
    const size_t n = tree.feature.size();
    std::copy(tree.feature.begin(), tree.feature.end(), feature + at);
    std::copy(tree.threshold.begin(), tree.threshold.end(), threshold + at);
    std::copy(tree.left.begin(), tree.left.end(), left + at);
    std::copy(tree.right.begin(), tree.right.end(), right + at);
    std::copy(tree.value.begin(), tree.value.end(), value + at * n_classes);
    std::copy(tree.impurity.begin(), tree.impurity.end(), impurity + at);
    std::copy(tree.n_node_samples.begin(), tree.n_node_samples.end(), n_node_samples + at);
    std::copy(tree.weighted_n_node_samples.begin(), tree.weighted_n_node_samples.end(),
              weighted_n_node_samples + at);
    at += static_cast<int64_t>(n);
  }
}

void tem_forest_free(void* handle) { delete static_cast<Forest*>(handle); }

}  // extern "C"
