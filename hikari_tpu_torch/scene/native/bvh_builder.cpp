// Native scene-compiler kernels: binned-SAH BVH build + stackless
// entry/exit flatten, and alias-table construction.
//
// A copy of hikari_tpu/scene/native/bvh_builder.cpp (same algorithm, same
// output) for the PyTorch port. Replaces the reference renderer's host-side
// hot loops: the Rust `bvh` crate's `BVH::build` + `flatten_custom`
// (reference src/mesh_material/mod.rs:458-459, instance.rs:365-371,
// :422-428) and the alias-table pour loop (mod.rs:330-376). Output contract
// matches hikari_tpu_torch/scene/bvh.py (the numpy builder): DFS-preorder
// node array, internal entry = first child index, leaf entry = -(prim+1),
// exit = index just past the subtree; exit == node_count means "leave".
//
// Built with g++ -O3 -shared -fPIC; bound via ctypes (see native/__init__.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int kBins = 16;

struct V3 {
  float x, y, z;
};

static inline V3 vmin(const V3 &a, const V3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline V3 vmax(const V3 &a, const V3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
static inline float axis_of(const V3 &v, int a) {
  return a == 0 ? v.x : (a == 1 ? v.y : v.z);
}
static inline float half_area(const V3 &mn, const V3 &mx) {
  float dx = std::max(0.f, mx.x - mn.x);
  float dy = std::max(0.f, mx.y - mn.y);
  float dz = std::max(0.f, mx.z - mn.z);
  return dx * dy + dy * dz + dz * dx;
}

struct Builder {
  const float *mins, *maxs;
  std::vector<V3> cent;
  // Output (DFS preorder).
  std::vector<V3> node_min, node_max;
  std::vector<int32_t> entry, exit_;

  V3 pmin(int64_t i) const { return {mins[3 * i], mins[3 * i + 1], mins[3 * i + 2]}; }
  V3 pmax(int64_t i) const { return {maxs[3 * i], maxs[3 * i + 1], maxs[3 * i + 2]}; }

  // Build + flatten the subtree over prims[lo, hi); appends nodes DFS.
  // Iterative with an explicit stack to survive arbitrarily deep trees.
  void build(std::vector<int64_t> &prims) {
    struct Task {
      int64_t lo, hi;   // range in prims
      int32_t parent;   // node index to patch exit after subtree, or -1
      bool is_exit_fix; // sentinel: patch exit of node `parent` to current size
    };
    std::vector<Task> stack;
    stack.push_back({0, (int64_t)prims.size(), -1, false});

    while (!stack.empty()) {
      Task t = stack.back();
      stack.pop_back();
      if (t.is_exit_fix) {
        exit_[t.parent] = (int32_t)entry.size();
        continue;
      }
      int64_t n = t.hi - t.lo;
      int32_t node_idx = (int32_t)entry.size();

      V3 bb_min = pmin(prims[t.lo]), bb_max = pmax(prims[t.lo]);
      V3 cb_min = cent[prims[t.lo]], cb_max = cent[prims[t.lo]];
      for (int64_t i = t.lo + 1; i < t.hi; ++i) {
        bb_min = vmin(bb_min, pmin(prims[i]));
        bb_max = vmax(bb_max, pmax(prims[i]));
        cb_min = vmin(cb_min, cent[prims[i]]);
        cb_max = vmax(cb_max, cent[prims[i]]);
      }
      node_min.push_back(bb_min);
      node_max.push_back(bb_max);

      if (n == 1) {
        entry.push_back(-(int32_t)(prims[t.lo] + 1));
        exit_.push_back(node_idx + 1);
        continue;
      }

      // Choose split axis = widest centroid extent.
      V3 ext = {cb_max.x - cb_min.x, cb_max.y - cb_min.y, cb_max.z - cb_min.z};
      int axis = 0;
      if (ext.y > axis_of(ext, axis)) axis = 1;
      if (ext.z > axis_of(ext, axis)) axis = 2;
      float extent = axis_of(ext, axis);

      int64_t mid;
      if (extent <= 1e-12f) {
        mid = t.lo + n / 2; // degenerate: split by index
      } else {
        // Binned SAH.
        float cmin = axis_of(cb_min, axis);
        float scale = kBins * (1.0f - 1e-6f) / extent;
        int64_t counts[kBins] = {0};
        V3 bmin[kBins], bmax[kBins];
        for (int b = 0; b < kBins; ++b) {
          bmin[b] = {INFINITY, INFINITY, INFINITY};
          bmax[b] = {-INFINITY, -INFINITY, -INFINITY};
        }
        for (int64_t i = t.lo; i < t.hi; ++i) {
          int b = std::min((int)((axis_of(cent[prims[i]], axis) - cmin) * scale),
                           kBins - 1);
          counts[b]++;
          bmin[b] = vmin(bmin[b], pmin(prims[i]));
          bmax[b] = vmax(bmax[b], pmax(prims[i]));
        }
        // Suffix sweep.
        float rarea[kBins + 1];
        int64_t rcnt[kBins + 1];
        V3 smin = {INFINITY, INFINITY, INFINITY},
           smax = {-INFINITY, -INFINITY, -INFINITY};
        rarea[kBins] = 0;
        rcnt[kBins] = 0;
        for (int b = kBins - 1; b >= 0; --b) {
          if (counts[b]) {
            smin = vmin(smin, bmin[b]);
            smax = vmax(smax, bmax[b]);
          }
          rcnt[b] = rcnt[b + 1] + counts[b];
          rarea[b] = rcnt[b] ? half_area(smin, smax) : 0.f;
        }
        // Prefix sweep + best cost.
        double best_cost = std::numeric_limits<double>::infinity();
        int best = -1;
        V3 lmin = {INFINITY, INFINITY, INFINITY},
           lmax = {-INFINITY, -INFINITY, -INFINITY};
        int64_t lcnt = 0;
        for (int b = 0; b < kBins - 1; ++b) {
          if (counts[b]) {
            lmin = vmin(lmin, bmin[b]);
            lmax = vmax(lmax, bmax[b]);
          }
          lcnt += counts[b];
          if (lcnt == 0 || rcnt[b + 1] == 0) continue;
          double cost = (double)lcnt * half_area(lmin, lmax) +
                        (double)rcnt[b + 1] * rarea[b + 1];
          if (cost < best_cost) {
            best_cost = cost;
            best = b;
          }
        }
        if (best < 0) {
          // All prims in one bin: median split on the axis.
          mid = t.lo + n / 2;
          std::nth_element(prims.begin() + t.lo, prims.begin() + mid,
                           prims.begin() + t.hi, [&](int64_t a, int64_t b2) {
                             return axis_of(cent[a], axis) < axis_of(cent[b2], axis);
                           });
        } else {
          float cmin2 = cmin;
          float scale2 = scale;
          auto it = std::partition(
              prims.begin() + t.lo, prims.begin() + t.hi, [&](int64_t p) {
                int b = std::min(
                    (int)((axis_of(cent[p], axis) - cmin2) * scale2), kBins - 1);
                return b <= best;
              });
          mid = it - prims.begin();
          if (mid == t.lo || mid == t.hi) mid = t.lo + n / 2;
        }
      }

      entry.push_back(node_idx + 1);
      exit_.push_back(0); // patched by the exit-fix task
      // DFS order: push exit-fix first (runs last), then right, then left.
      stack.push_back({0, 0, node_idx, true});
      stack.push_back({mid, t.hi, -1, false});
      stack.push_back({t.lo, mid, -1, false});
    }
  }
};

} // namespace

extern "C" {

// Returns node count. Output arrays must hold >= 2n-1 nodes.
int64_t hikari_bvh_build(const float *mins, const float *maxs, int64_t n,
                         float *out_min, float *out_max, int32_t *out_entry,
                         int32_t *out_exit) {
  if (n <= 0) return 0;
  Builder b;
  b.mins = mins;
  b.maxs = maxs;
  b.cent.resize(n);
  for (int64_t i = 0; i < n; ++i) {
    b.cent[i] = {0.5f * (mins[3 * i] + maxs[3 * i]),
                 0.5f * (mins[3 * i + 1] + maxs[3 * i + 1]),
                 0.5f * (mins[3 * i + 2] + maxs[3 * i + 2])};
  }
  std::vector<int64_t> prims(n);
  for (int64_t i = 0; i < n; ++i) prims[i] = i;
  b.build(prims);

  int64_t count = (int64_t)b.entry.size();
  std::memcpy(out_min, b.node_min.data(), count * sizeof(V3));
  std::memcpy(out_max, b.node_max.data(), count * sizeof(V3));
  std::memcpy(out_entry, b.entry.data(), count * sizeof(int32_t));
  std::memcpy(out_exit, b.exit_.data(), count * sizeof(int32_t));
  return count;
}

// Many BVHs in one call: set s is the prims [offsets[s], offsets[s + 1])
// of mins/maxs, built as hikari_bvh_build builds it alone (prim ids local
// to the set). A set of n > 0 prims takes 2n - 1 nodes, written after the
// previous sets' nodes; an empty set takes none. Returns the node count.
int64_t hikari_bvh_build_many(const float *mins, const float *maxs, const int64_t *offsets,
                              int64_t num_sets, float *out_min, float *out_max,
                              int32_t *out_entry, int32_t *out_exit) {
  int64_t total = 0;
  for (int64_t s = 0; s < num_sets; ++s) {
    const int64_t p0 = offsets[s], n = offsets[s + 1] - offsets[s];
    total += hikari_bvh_build(mins + 3 * p0, maxs + 3 * p0, n, out_min + 3 * total,
                              out_max + 3 * total, out_entry + total, out_exit + total);
  }
  return total;
}

// Vose/"pour" alias table over triangle areas — same algorithm shape as the
// reference (src/mesh_material/mod.rs:330-376): prob[i] is the probability
// of redirecting to `index[i]` when bucket i is drawn.
void hikari_alias_table_build(const float *areas, int64_t n, float *out_prob,
                              int32_t *out_index) {
  double total = 0.0;
  for (int64_t i = 0; i < n; ++i) total += areas[i];
  if (total <= 0.0) {
    for (int64_t i = 0; i < n; ++i) {
      out_prob[i] = 0.f;
      out_index[i] = (int32_t)i;
    }
    return;
  }
  double mean = total / (double)n;
  std::vector<std::pair<int64_t, double>> over, under;
  over.reserve(n);
  under.reserve(n);
  for (int64_t i = 0; i < n; ++i) {
    double p = areas[i] / mean;
    out_prob[i] = 0.f;
    out_index[i] = (int32_t)i;
    if (p > 1.0)
      over.push_back({i, p});
    else if (p < 1.0)
      under.push_back({i, p});
  }
  while (!under.empty() && !over.empty()) {
    auto ob = over.back();
    over.pop_back();
    auto ub = under.back();
    under.pop_back();
    double delta = 1.0 - ub.second;
    ob.second -= delta;
    if (ob.second > 1.0)
      over.push_back(ob);
    else if (ob.second < 1.0)
      under.push_back(ob);
    out_prob[ub.first] = (float)delta;
    out_index[ub.first] = (int32_t)ob.first;
  }
}

} // extern "C"
