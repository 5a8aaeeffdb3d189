// Random forests of classification trees, grown as scikit-learn 1.9's RandomForestClassifier grows
// them with its dense best splitter, so that every tree equals sklearn's node for node: the same
// node order, features, thresholds (bitwise), children, class fractions, impurities, sample counts
// and missing-value directions.
//
// The caller (shallow2deep/forest.py) draws what sklearn draws from numpy's RandomState: each
// tree's sample weights (the bootstrap counts of _forest.py:_parallel_build_trees, times the class
// weights where there are any) and its splitter's seed (_splitter.pyx:Splitter.init). This file
// grows the trees:
//
// - the samples of nonzero weight, in index order (Splitter.init);
// - the depth-first builder (_tree.pyx:DepthFirstTreeBuilder.build): a stack, the right child
//   pushed before the left, a node a leaf when it is too deep, holds fewer than
//   min_samples_split or 2 min_samples_leaf samples or less than 2 min_weight_leaf weight, or its
//   impurity is at most EPSILON; after a split search, when no split was found or its
//   improvement plus EPSILON is below min_impurity_decrease;
// - with max_leaf_nodes, the best-first builder (BestFirstTreeBuilder.build): a node's split is
//   searched when the node is added (so the node ids and the splitter's draws follow the order
//   of adding, the left child before the right), the frontier is a heap (std::push_heap /
//   pop_heap on the improvement, as sklearn's), and once max_leaf_nodes - 1 nodes are split every
//   node popped becomes a leaf;
// - the split search (_splitter.pyx:node_split_best): features drawn without replacement by
//   Fisher-Yates from sklearn's xorshift generator (_random.pxd:our_rand_r), the features found
//   constant carried to the children (depth-first only), each drawn feature's values sorted by
//   sklearn's introsort (utils/_sorting.pyx:introsort_3way with median3, heapsort and insertion
//   sort, whose order of equal values is its own), the positions between values more than
//   FEATURE_THRESHOLD (float32) apart scanned from the left, a candidate replacing the best only
//   when its proxy improvement is strictly larger, the threshold the midpoint a / 2 + b / 2 in
//   float64;
// - the criterion (_criterion.pyx:ClassificationCriterion): the class sums of a candidate's left
//   child updated from the last position forward or from the end backward, whichever is shorter,
//   as sklearn sums them; Gini and entropy, entropy with log(x) = ln(x) / ln(2). With class
//   weights the sample weights are not integers, so the sums depend on this order;
// - monotonic constraints (binary classes; the caller flips their signs, as sklearn does, to
//   constrain the negative class): a candidate whose children's values break the constraint or
//   the node's bounds is skipped, the bounds pass to the children through the middle value, and
//   each node's value is clipped to its bounds;
// - with ccp_alpha > 0, minimal cost-complexity pruning (_tree.pyx:_cost_complexity_prune and
//   _build_pruned_tree), the pruned tree rebuilt in its own depth-first node order.
//
// This file is built with -ffp-contract=off so that no fused multiply-add changes a rounding. The
// trees are grown on a pool of threads, each tree by one thread; the trees do not depend on their
// number.
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

// utils/_sorting.pyx: simultaneous_sort with the three-way partition, line for line
inline void swap_pair(float* values, int64_t* indices, int64_t i, int64_t j) {
  std::swap(values[i], values[j]);
  std::swap(indices[i], indices[j]);
}

inline float median3(const float* values, int64_t n) {
  const float a = values[0], b = values[n / 2], c = values[n - 1];
  if (a < b) {
    if (b < c) return b;
    if (a < c) return c;
    return a;
  }
  if (b < c) {
    if (a < c) return a;
    return c;
  }
  return b;
}

void insertion_sort(float* values, int64_t* indices, int64_t n) {
  for (int64_t i = 1; i < n; ++i) {
    const float temp_val = values[i];
    const int64_t temp_idx = indices[i];
    int64_t j = i;
    while (j > 0 && values[j - 1] > temp_val) {
      values[j] = values[j - 1];
      indices[j] = indices[j - 1];
      --j;
    }
    values[j] = temp_val;
    indices[j] = temp_idx;
  }
}

void sift_down(float* values, int64_t* indices, int64_t start, int64_t end) {
  int64_t root = start;
  while (true) {
    const int64_t child = root * 2 + 1;
    int64_t maxind = root;
    if (child < end && values[maxind] < values[child]) maxind = child;
    if (child + 1 < end && values[maxind] < values[child + 1]) maxind = child + 1;
    if (maxind == root) break;
    swap_pair(values, indices, root, maxind);
    root = maxind;
  }
}

void heapsort(float* values, int64_t* indices, int64_t n) {
  int64_t start = (n - 2) / 2;
  while (true) {
    sift_down(values, indices, start, n);
    if (start == 0) break;
    --start;
  }
  for (int64_t end = n - 1; end > 0; --end) {
    swap_pair(values, indices, 0, end);
    sift_down(values, indices, 0, end);
  }
}

void introsort_3way(float* values, int64_t* indices, int64_t n, int64_t maxd) {
  while (n > 15) {
    if (maxd <= 0) {
      heapsort(values, indices, n);
      return;
    }
    --maxd;
    const float pivot = median3(values, n);
    int64_t i = 0, l = 0, r = n;
    while (i < r) {
      if (values[i] < pivot) {
        swap_pair(values, indices, i, l);
        ++i;
        ++l;
      } else if (values[i] > pivot) {
        --r;
        swap_pair(values, indices, i, r);
      } else {
        ++i;
      }
    }
    introsort_3way(values, indices, l, maxd);
    values += r;
    indices += r;
    n -= r;
  }
  insertion_sort(values, indices, n);
}

void simultaneous_sort(float* values, int64_t* indices, int64_t n) {
  if (n == 0) return;
  introsort_3way(values, indices, n, 2 * static_cast<int64_t>(std::log2(static_cast<double>(n))));
}

struct Params {
  int64_t n_samples, n_features, n_classes;
  int criterion;  // 0 Gini, 1 entropy
  int64_t max_features, max_depth, min_samples_split, min_samples_leaf, max_leaf_nodes;  // max_leaf_nodes < 0: none
  double min_impurity_decrease, ccp_alpha;
  const int8_t* monotonic_cst;  // null: none
};

struct TreeOut {
  std::vector<int64_t> feature, left, right, n_node_samples;
  std::vector<double> threshold, impurity, weighted_n_node_samples, value;
  std::vector<uint8_t> missing_go_to_left;
};

struct Split {
  int64_t pos, feature;
  double threshold, improvement, impurity_left, impurity_right;
  bool missing_go_to_left;
};

// _splitter.pyx: ParentInfo
struct Parent {
  double impurity, lower_bound, upper_bound;
  int64_t n_constant_features;
};

struct StackRecord {
  int64_t start, end, depth, parent;
  bool is_left;
  double impurity;
  int64_t n_constant_features;
  double lower_bound, upper_bound;
};

// _tree.pyx: FrontierRecord
struct FrontierRecord {
  int64_t node_id, start, end, pos, depth;
  bool is_leaf;
  double impurity, impurity_left, impurity_right, improvement, lower_bound, upper_bound, middle_value;
};

bool compare_records(const FrontierRecord& a, const FrontierRecord& b) { return a.improvement < b.improvement; }

class TreeBuilder {
 public:
  TreeBuilder(const Params& p, const float* X, const int32_t* y)
      : p_(p), X_(X), y_(y), sum_total_(p.n_classes), sum_left_(p.n_classes), sum_right_(p.n_classes) {}

  void build(const double* weights, double min_weight_leaf, uint32_t seed, TreeOut& out) {
    const int64_t n = p_.n_samples;
    rand_r_state_ = seed;
    min_weight_leaf_ = min_weight_leaf;
    // Splitter.init: the samples of nonzero weight in index order; the total weight of all
    weight_.assign(n, 1.0);
    samples_.clear();
    weighted_n_samples_ = 0.0;
    for (int64_t i = 0; i < n; ++i) {
      if (weights != nullptr) weight_[i] = weights[i];
      if (weights == nullptr || weight_[i] != 0.0) samples_.push_back(i);
      weighted_n_samples_ += weight_[i];
    }
    features_.resize(p_.n_features);
    for (int64_t f = 0; f < p_.n_features; ++f) features_[f] = f;
    constant_features_.assign(p_.n_features, 0);
    feature_values_.resize(n);
    if (p_.max_leaf_nodes < 0) {
      build_depth_first(out);
    } else {
      build_best_first(out);
    }
    if (p_.ccp_alpha > 0.0) prune(out);
  }

 private:
  // --- ClassificationCriterion ---------------------------------------------------------------

  void criterion_init(int64_t start, int64_t end) {
    start_ = start;
    end_ = end;
    std::fill(sum_total_.begin(), sum_total_.end(), 0.0);
    weighted_n_node_samples_ = 0.0;
    for (int64_t q = start; q < end; ++q) {
      const int64_t i = samples_[q];
      sum_total_[y_[i]] += weight_[i];
      weighted_n_node_samples_ += weight_[i];
    }
    reset();
  }

  void reset() {
    pos_ = start_;
    std::fill(sum_left_.begin(), sum_left_.end(), 0.0);
    sum_right_ = sum_total_;
    weighted_n_left_ = 0.0;
    weighted_n_right_ = weighted_n_node_samples_;
  }

  void reverse_reset() {
    pos_ = end_;
    std::fill(sum_right_.begin(), sum_right_.end(), 0.0);
    sum_left_ = sum_total_;
    weighted_n_right_ = 0.0;
    weighted_n_left_ = weighted_n_node_samples_;
  }

  // moves samples[pos:new_pos] to the left child, summing from whichever side is shorter
  void update(int64_t new_pos) {
    if (new_pos - pos_ <= end_ - new_pos) {
      for (int64_t q = pos_; q < new_pos; ++q) {
        const int64_t i = samples_[q];
        sum_left_[y_[i]] += weight_[i];
        weighted_n_left_ += weight_[i];
      }
    } else {
      reverse_reset();
      for (int64_t q = end_ - 1; q > new_pos - 1; --q) {
        const int64_t i = samples_[q];
        sum_left_[y_[i]] -= weight_[i];
        weighted_n_left_ -= weight_[i];
      }
    }
    weighted_n_right_ = weighted_n_node_samples_ - weighted_n_left_;
    for (int64_t c = 0; c < p_.n_classes; ++c) sum_right_[c] = sum_total_[c] - sum_left_[c];
    pos_ = new_pos;
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

  void children_impurity(double* left, double* right) const {
    *left = impurity_of(sum_left_, weighted_n_left_);
    *right = impurity_of(sum_right_, weighted_n_right_);
  }

  // the node's class fractions, clipped to its bounds under monotonic constraints
  void node_value(double lower_bound, double upper_bound, TreeOut& out) const {
    const size_t at = out.value.size();
    for (int64_t c = 0; c < p_.n_classes; ++c) out.value.push_back(sum_total_[c] / weighted_n_node_samples_);
    if (p_.monotonic_cst != nullptr) {
      double* dest = out.value.data() + at;
      if (dest[0] < lower_bound) {
        dest[0] = lower_bound;
      } else if (dest[0] > upper_bound) {
        dest[0] = upper_bound;
      }
      if (p_.n_classes > 1) dest[1] = 1 - dest[0];  // one class: sklearn writes past the node
    }
  }

  double middle_value() const {
    return sum_left_[0] / (2 * weighted_n_left_) + sum_right_[0] / (2 * weighted_n_right_);
  }

  bool check_monotonicity(int8_t cst, double lower_bound, double upper_bound) const {
    const double value_left = sum_left_[0] / weighted_n_left_;
    const double value_right = sum_right_[0] / weighted_n_right_;
    const bool check_lower = (value_left >= lower_bound) & (value_right >= lower_bound);
    const bool check_upper = (value_left <= upper_bound) & (value_right <= upper_bound);
    const bool check_cst = (value_left - value_right) * cst <= 0;
    return check_lower & check_upper & check_cst;
  }

  // --- the splitter ----------------------------------------------------------------------------

  // DensePartitioner.sort_samples_and_feature_values, without missing values
  void sort_by(int64_t feature, int64_t start, int64_t end) {
    const float* column = X_ + feature * p_.n_samples;
    for (int64_t q = start; q < end; ++q) feature_values_[q] = column[samples_[q]];
    simultaneous_sort(feature_values_.data() + start, samples_.data() + start, end - start);
  }

  // _splitter.pyx:node_split_best on dense data without missing values
  void node_split(int64_t start, int64_t end, Parent* parent, Split* split) {
    int64_t* features = features_.data();
    int64_t* constant_features = constant_features_.data();
    const float* fv = feature_values_.data();
    const double impurity = parent->impurity;
    Split best{end, 0, 0.0, -kInf, kInf, kInf, false};
    Split current = best;
    double best_proxy_improvement = -kInf;
    int64_t f_i = p_.n_features, n_visited_features = 0, n_found_constants = 0, n_drawn_constants = 0;
    const int64_t n_known_constants = parent->n_constant_features;
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
      const int8_t cst = p_.monotonic_cst == nullptr ? 0 : p_.monotonic_cst[current.feature];

      reset();
      int64_t p = start;
      while (p < end) {
        // DensePartitioner.next_p
        ++p;
        while (p < end && fv[p] <= fv[p - 1] + kFeatureThreshold) ++p;
        const int64_t p_prev = p - 1;
        if (p == end) continue;
        const int64_t n_left = p - start, n_right = end - p;
        if (n_left < p_.min_samples_leaf || n_right < p_.min_samples_leaf) continue;
        current.pos = p;
        update(p);
        if (cst != 0 && !check_monotonicity(cst, parent->lower_bound, parent->upper_bound)) continue;
        if (weighted_n_left_ < min_weight_leaf_ || weighted_n_right_ < min_weight_leaf_) continue;
        double impurity_left, impurity_right;
        children_impurity(&impurity_left, &impurity_right);
        // Criterion.proxy_impurity_improvement
        const double proxy = -weighted_n_right_ * impurity_right - weighted_n_left_ * impurity_left;
        if (proxy > best_proxy_improvement) {
          best_proxy_improvement = proxy;
          current.threshold = fv[p_prev] / 2.0 + fv[p] / 2.0;
          current.missing_go_to_left = n_left > n_right;
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
      reset();
      update(best.pos);
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
    parent->n_constant_features = n_total_constants;
    *split = best;
  }

  // --- the tree ----------------------------------------------------------------------------------

  // Tree._add_node: a leaf's feature and threshold are undefined and its children TREE_LEAF; a split
  // node's children are set when they are added
  int64_t add_node(TreeOut& out, int64_t parent, bool is_left, bool is_leaf, const Split& split, double impurity,
                   int64_t n_node_samples) {
    const int64_t node_id = static_cast<int64_t>(out.feature.size());
    if (parent != kUndefined) (is_left ? out.left : out.right)[parent] = node_id;
    out.feature.push_back(is_leaf ? kUndefined : split.feature);
    out.threshold.push_back(is_leaf ? static_cast<double>(kUndefined) : split.threshold);
    out.missing_go_to_left.push_back(is_leaf ? 0 : static_cast<uint8_t>(split.missing_go_to_left));
    out.left.push_back(kLeaf);
    out.right.push_back(kLeaf);
    out.impurity.push_back(impurity);
    out.n_node_samples.push_back(n_node_samples);
    out.weighted_n_node_samples.push_back(weighted_n_node_samples_);
    return node_id;
  }

  bool too_small(int64_t depth, int64_t n_node_samples) const {
    return depth >= p_.max_depth || n_node_samples < p_.min_samples_split ||
           n_node_samples < 2 * p_.min_samples_leaf || weighted_n_node_samples_ < 2 * min_weight_leaf_;
  }

  // the children's bounds of a split on feature (DepthFirstTreeBuilder / BestFirstTreeBuilder)
  void child_bounds(int64_t feature, double lower, double upper, double middle, double* left_min, double* left_max,
                    double* right_min, double* right_max) const {
    const int8_t cst = p_.monotonic_cst == nullptr ? 0 : p_.monotonic_cst[feature];
    *left_min = *right_min = lower;
    *left_max = *right_max = upper;
    if (cst == 1) {
      *right_min = *left_max = middle;
    } else if (cst == -1) {
      *left_min = *right_max = middle;
    }
  }

  void build_depth_first(TreeOut& out) {
    std::vector<StackRecord> stack;
    stack.push_back({0, static_cast<int64_t>(samples_.size()), 0, kUndefined, false, kInf, 0, -kInf, kInf});
    bool first = true;
    Split split{};
    while (!stack.empty()) {
      const StackRecord rec = stack.back();
      stack.pop_back();
      const int64_t start = rec.start, end = rec.end, n_node_samples = end - start;
      Parent parent{rec.impurity, rec.lower_bound, rec.upper_bound, rec.n_constant_features};
      criterion_init(start, end);
      bool is_leaf = too_small(rec.depth, n_node_samples);
      if (first) {
        parent.impurity = node_impurity();
        first = false;
      }
      is_leaf = is_leaf || parent.impurity <= kEpsilon;
      if (!is_leaf) {
        node_split(start, end, &parent, &split);
        is_leaf = split.pos >= end || split.improvement + kEpsilon < p_.min_impurity_decrease;
      }
      const int64_t node_id = add_node(out, rec.parent, rec.is_left, is_leaf, split, parent.impurity, n_node_samples);
      node_value(parent.lower_bound, parent.upper_bound, out);
      if (!is_leaf) {
        double left_min, left_max, right_min, right_max;
        const bool constrained = p_.monotonic_cst != nullptr && p_.monotonic_cst[split.feature] != 0;
        child_bounds(split.feature, parent.lower_bound, parent.upper_bound, constrained ? middle_value() : 0.0,
                     &left_min, &left_max, &right_min, &right_max);
        stack.push_back({split.pos, end, rec.depth + 1, node_id, false, split.impurity_right,
                         parent.n_constant_features, right_min, right_max});
        stack.push_back({start, split.pos, rec.depth + 1, node_id, true, split.impurity_left,
                         parent.n_constant_features, left_min, left_max});
      }
    }
  }

  // BestFirstTreeBuilder._add_split_node
  FrontierRecord add_split_node(TreeOut& out, int64_t start, int64_t end, bool is_first, bool is_left,
                                int64_t parent_id, int64_t depth, Parent* parent) {
    Split split{};
    criterion_init(start, end);
    parent->n_constant_features = 0;
    if (is_first) parent->impurity = node_impurity();
    const int64_t n_node_samples = end - start;
    bool is_leaf = too_small(depth, n_node_samples) || parent->impurity <= kEpsilon;
    if (!is_leaf) {
      node_split(start, end, parent, &split);
      is_leaf = split.pos >= end || split.improvement + kEpsilon < p_.min_impurity_decrease;
    }
    FrontierRecord res{};
    res.node_id = add_node(out, parent_id, is_left, is_leaf, split, parent->impurity, n_node_samples);
    node_value(parent->lower_bound, parent->upper_bound, out);
    res.start = start;
    res.end = end;
    res.depth = depth;
    res.impurity = parent->impurity;
    res.lower_bound = parent->lower_bound;
    res.upper_bound = parent->upper_bound;
    res.middle_value = p_.monotonic_cst != nullptr && !is_leaf ? middle_value() : 0.0;
    res.is_leaf = is_leaf;
    res.pos = is_leaf ? end : split.pos;
    res.improvement = is_leaf ? 0.0 : split.improvement;
    res.impurity_left = is_leaf ? parent->impurity : split.impurity_left;
    res.impurity_right = is_leaf ? parent->impurity : split.impurity_right;
    return res;
  }

  void build_best_first(TreeOut& out) {
    std::vector<FrontierRecord> frontier;
    int64_t max_split_nodes = p_.max_leaf_nodes - 1;
    Parent parent{kInf, -kInf, kInf, 0};
    frontier.push_back(add_split_node(out, 0, static_cast<int64_t>(samples_.size()), true, true, kUndefined, 0,
                                      &parent));
    std::push_heap(frontier.begin(), frontier.end(), compare_records);
    while (!frontier.empty()) {
      std::pop_heap(frontier.begin(), frontier.end(), compare_records);
      const FrontierRecord record = frontier.back();
      frontier.pop_back();
      const int64_t node = record.node_id;
      if (record.is_leaf || max_split_nodes <= 0) {
        out.left[node] = out.right[node] = kLeaf;
        out.feature[node] = kUndefined;
        out.threshold[node] = static_cast<double>(kUndefined);
        continue;
      }
      double left_min, left_max, right_min, right_max;
      child_bounds(out.feature[node], record.lower_bound, record.upper_bound, record.middle_value, &left_min,
                   &left_max, &right_min, &right_max);
      --max_split_nodes;
      parent = {record.impurity_left, left_min, left_max, 0};
      const FrontierRecord left = add_split_node(out, record.start, record.pos, false, true, node,
                                                 record.depth + 1, &parent);
      parent = {record.impurity_right, right_min, right_max, 0};
      const FrontierRecord right = add_split_node(out, record.pos, record.end, false, false, node,
                                                  record.depth + 1, &parent);
      frontier.push_back(left);
      std::push_heap(frontier.begin(), frontier.end(), compare_records);
      frontier.push_back(right);
      std::push_heap(frontier.begin(), frontier.end(), compare_records);
    }
  }

  // _tree.pyx:_cost_complexity_prune with _AlphaPruner, then _build_pruned_tree
  void prune(TreeOut& tree) const {
    const int64_t n_nodes = static_cast<int64_t>(tree.feature.size());
    const std::vector<int64_t>& child_l = tree.left;
    const std::vector<int64_t>& child_r = tree.right;
    const double total_sum_weights = tree.weighted_n_node_samples[0];
    std::vector<double> r_node(n_nodes), r_branch(n_nodes, 0.0);
    std::vector<int64_t> parent(n_nodes, 0), n_leaves(n_nodes, 0);
    std::vector<uint8_t> leaves_in_subtree(n_nodes, 0), candidate(n_nodes), in_subtree(n_nodes, 1);
    for (int64_t i = 0; i < n_nodes; ++i) {
      r_node[i] = tree.weighted_n_node_samples[i] * tree.impurity[i] / total_sum_weights;
    }
    parent[0] = kUndefined;
    for (int64_t i = 0; i < n_nodes; ++i) {
      if (child_l[i] == kLeaf) {
        leaves_in_subtree[i] = 1;
      } else {
        parent[child_l[i]] = parent[child_r[i]] = i;
      }
    }
    for (int64_t leaf = 0; leaf < n_nodes; ++leaf) {
      if (!leaves_in_subtree[leaf]) continue;
      r_branch[leaf] = r_node[leaf];
      const double current_r = r_node[leaf];
      for (int64_t idx = leaf; idx != 0;) {
        const int64_t up = parent[idx];
        r_branch[up] += current_r;
        n_leaves[up] += 1;
        idx = up;
      }
    }
    for (int64_t i = 0; i < n_nodes; ++i) candidate[i] = !leaves_in_subtree[i];
    std::vector<int64_t> stack;
    while (candidate[0]) {
      double effective_alpha = std::numeric_limits<double>::max();
      int64_t pruned = 0;
      for (int64_t i = 0; i < n_nodes; ++i) {
        if (!candidate[i]) continue;
        const double subtree_alpha = (r_node[i] - r_branch[i]) / static_cast<double>(n_leaves[i] - 1);
        if (subtree_alpha < effective_alpha) {
          effective_alpha = subtree_alpha;
          pruned = i;
        }
      }
      if (p_.ccp_alpha < effective_alpha) break;
      stack.push_back(pruned);
      while (!stack.empty()) {
        const int64_t idx = stack.back();
        stack.pop_back();
        if (!in_subtree[idx]) continue;
        candidate[idx] = leaves_in_subtree[idx] = in_subtree[idx] = 0;
        if (child_l[idx] != kLeaf) {
          stack.push_back(child_l[idx]);
          stack.push_back(child_r[idx]);
        }
      }
      leaves_in_subtree[pruned] = in_subtree[pruned] = 1;
      const int64_t n_pruned_leaves = n_leaves[pruned] - 1;
      n_leaves[pruned] = 0;
      const double r_diff = r_node[pruned] - r_branch[pruned];
      r_branch[pruned] = r_node[pruned];
      for (int64_t idx = parent[pruned]; idx != kUndefined; idx = parent[idx]) {
        n_leaves[idx] -= n_pruned_leaves;
        r_branch[idx] += r_diff;
      }
    }

    // _build_pruned_tree: depth first from the root, the left child first
    TreeOut out;
    const int64_t k = p_.n_classes;
    struct Record {
      int64_t orig, parent;
      bool is_left;
    };
    std::vector<Record> records{{0, kUndefined, false}};
    while (!records.empty()) {
      const Record rec = records.back();
      records.pop_back();
      const int64_t o = rec.orig;
      const bool is_leaf = leaves_in_subtree[o];
      const int64_t node_id = static_cast<int64_t>(out.feature.size());
      if (rec.parent != kUndefined) (rec.is_left ? out.left : out.right)[rec.parent] = node_id;
      out.feature.push_back(is_leaf ? kUndefined : tree.feature[o]);
      out.threshold.push_back(is_leaf ? static_cast<double>(kUndefined) : tree.threshold[o]);
      out.missing_go_to_left.push_back(is_leaf ? 0 : tree.missing_go_to_left[o]);
      out.left.push_back(kLeaf);
      out.right.push_back(kLeaf);
      out.impurity.push_back(tree.impurity[o]);
      out.n_node_samples.push_back(tree.n_node_samples[o]);
      out.weighted_n_node_samples.push_back(tree.weighted_n_node_samples[o]);
      out.value.insert(out.value.end(), tree.value.begin() + o * k, tree.value.begin() + (o + 1) * k);
      if (!is_leaf) {
        records.push_back({child_r[o], node_id, false});
        records.push_back({child_l[o], node_id, true});
      }
    }
    tree = std::move(out);
  }

  const Params& p_;
  const float* X_;
  const int32_t* y_;
  uint32_t rand_r_state_ = 0;
  double min_weight_leaf_ = 0.0;
  std::vector<double> weight_, sum_total_, sum_left_, sum_right_;
  std::vector<int64_t> samples_, features_, constant_features_;
  std::vector<float> feature_values_;
  int64_t start_ = 0, end_ = 0, pos_ = 0;
  double weighted_n_samples_ = 0.0, weighted_n_node_samples_ = 0.0, weighted_n_left_ = 0.0,
         weighted_n_right_ = 0.0;
};

struct Forest {
  std::vector<TreeOut> trees;
};

}  // namespace

extern "C" {

// Grow n_trees trees on threads threads. X is feature-major float32 (n_features, n_samples), y the
// classes encoded as 0..n_classes-1; weights holds each tree's sample weights, weight_stride apart
// (0: one row for every tree), or is null for weight 1 everywhere; min_weight_leaf and seeds are
// each tree's min_weight_leaf and splitter seed. max_leaf_nodes < 0 grows depth first;
// monotonic_cst (n_features, signs already flipped) or null. Returns a handle for tem_forest_sizes /
// tem_forest_copy / tem_forest_free, or null when memory ran out.
void* tem_forest_fit(const float* X, const int32_t* y, int64_t n_samples, int64_t n_features, int64_t n_classes,
                     int64_t n_trees, const double* weights, int64_t weight_stride, const double* min_weight_leaf,
                     const uint32_t* seeds, int criterion, int64_t max_features, int64_t max_depth,
                     int64_t min_samples_split, int64_t min_samples_leaf, double min_impurity_decrease,
                     int64_t max_leaf_nodes, double ccp_alpha, const int8_t* monotonic_cst, int threads) {
  const Params params{n_samples, n_features, n_classes, criterion, max_features, max_depth,
                      min_samples_split, min_samples_leaf, max_leaf_nodes, min_impurity_decrease,
                      ccp_alpha, monotonic_cst};
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
          builder.build(weights == nullptr ? nullptr : weights + t * weight_stride, min_weight_leaf[t], seeds[t],
                        forest->trees[t]);
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
                     double* weighted_n_node_samples, uint8_t* missing_go_to_left) {
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
    std::copy(tree.missing_go_to_left.begin(), tree.missing_go_to_left.end(), missing_go_to_left + at);
    at += static_cast<int64_t>(n);
  }
}

void tem_forest_free(void* handle) { delete static_cast<Forest*>(handle); }

}  // extern "C"
