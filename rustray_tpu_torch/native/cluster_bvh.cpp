// Native BVH / triangle-cluster builder (host-side runtime component).
//
// TPU-native equivalent of the reference's acceleration structures: the
// `bvh` crate's scene BVH (reference src/scene.rs:1681-1688) and parry3d's
// per-TriMesh internal BVH (src/shape/mesh.rs:67).  Instead of a
// pointer-chasing node tree traversed per ray on a CPU, we build a binned
// SAH BVH top-down and CUT it at leaves of <= max_leaf triangles, emitting
//   * a triangle permutation that makes every leaf ("cluster") a contiguous
//     slab of the triangle pool, and
//   * per-cluster object-space AABBs.
// The device renderer culls ray blocks against cluster AABBs and runs dense
// MXU-tiled intersection inside surviving clusters — divergence-free
// traversal suited to a vector machine.
//
// C ABI (used from Python via ctypes; a NumPy fallback mirrors semantics):
//   int rr_build_clusters(const float* verts, int n_verts,
//                         const int*   tris,  int n_tris,
//                         int max_leaf,
//                         int*   perm_out,    // (n_tris)
//                         float* aabb_out,    // (max_clusters, 6) lo, hi
//                         int*   count_out,   // (max_clusters)
//                         int    max_clusters);
// Returns number of clusters, or -1 on overflow/error.

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct AABB {
  float lo[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
  float hi[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
  void grow(const float* p) {
    for (int k = 0; k < 3; ++k) {
      lo[k] = std::min(lo[k], p[k]);
      hi[k] = std::max(hi[k], p[k]);
    }
  }
  void grow(const AABB& b) {
    for (int k = 0; k < 3; ++k) {
      lo[k] = std::min(lo[k], b.lo[k]);
      hi[k] = std::max(hi[k], b.hi[k]);
    }
  }
  float half_area() const {
    float dx = std::max(0.0f, hi[0] - lo[0]);
    float dy = std::max(0.0f, hi[1] - lo[1]);
    float dz = std::max(0.0f, hi[2] - lo[2]);
    return dx * dy + dy * dz + dz * dx;
  }
};

struct BuildCtx {
  const float* verts;
  const int* tris;
  std::vector<AABB> tri_box;       // per triangle
  std::vector<float> centroid;     // (n, 3)
  std::vector<int> order;          // current permutation (triangle ids)
  int max_leaf;
  // outputs
  int* perm_out;
  float* aabb_out;
  int* count_out;
  int max_clusters;
  int n_clusters = 0;
  int n_emitted = 0;
  bool overflow = false;
};

constexpr int kBins = 16;

void emit_leaf(BuildCtx& c, int begin, int end, const AABB& box) {
  if (c.n_clusters >= c.max_clusters) {
    c.overflow = true;
    return;
  }
  int ci = c.n_clusters++;
  for (int i = begin; i < end; ++i) c.perm_out[c.n_emitted++] = c.order[i];
  for (int k = 0; k < 3; ++k) {
    c.aabb_out[ci * 6 + k] = box.lo[k];
    c.aabb_out[ci * 6 + 3 + k] = box.hi[k];
  }
  c.count_out[ci] = end - begin;
}

// Top-down binned-SAH build over [begin, end); leaves are emitted in
// depth-first order so spatially close clusters are close in the pool.
void build(BuildCtx& c, int begin, int end) {
  if (c.overflow) return;
  AABB box, cbox;
  for (int i = begin; i < end; ++i) {
    box.grow(c.tri_box[c.order[i]]);
    cbox.grow(&c.centroid[3 * c.order[i]]);
  }
  int n = end - begin;
  if (n <= c.max_leaf) {
    // SAH would rarely split below max_leaf profitably for our dense-tile
    // consumer (cost per surviving cluster is flat); always emit.
    emit_leaf(c, begin, end, box);
    return;
  }

  // Binned SAH over the widest centroid axis; fall back to median split on
  // degenerate extents (all centroids equal).
  int axis = 0;
  float ext[3];
  for (int k = 0; k < 3; ++k) ext[k] = cbox.hi[k] - cbox.lo[k];
  if (ext[1] > ext[axis]) axis = 1;
  if (ext[2] > ext[axis]) axis = 2;

  int mid = -1;
  if (ext[axis] > 1e-12f) {
    const float k1 = kBins / ext[axis];
    AABB bin_box[kBins];
    int bin_cnt[kBins] = {0};
    auto bin_of = [&](int tri) {
      int b = (int)((c.centroid[3 * tri + axis] - cbox.lo[axis]) * k1);
      return std::min(std::max(b, 0), kBins - 1);
    };
    for (int i = begin; i < end; ++i) {
      int b = bin_of(c.order[i]);
      bin_cnt[b]++;
      bin_box[b].grow(c.tri_box[c.order[i]]);
    }
    // sweep: cost(i) = A_left*n_left + A_right*n_right, split after bin i
    float right_area[kBins];
    AABB acc;
    int acc_cnt = 0;
    for (int i = kBins - 1; i >= 1; --i) {
      acc.grow(bin_box[i]);
      right_area[i] = acc.half_area();
    }
    float best_cost = FLT_MAX;
    int best_bin = -1;
    AABB lacc;
    int lcnt = 0;
    acc_cnt = 0;
    for (int i = 0; i < kBins - 1; ++i) {
      lacc.grow(bin_box[i]);
      lcnt += bin_cnt[i];
      int rcnt = n - lcnt;
      if (lcnt == 0 || rcnt == 0) continue;
      float cost = lacc.half_area() * lcnt + right_area[i + 1] * rcnt;
      if (cost < best_cost) {
        best_cost = cost;
        best_bin = i;
      }
    }
    if (best_bin >= 0) {
      auto it = std::partition(
          c.order.begin() + begin, c.order.begin() + end,
          [&](int tri) { return bin_of(tri) <= best_bin; });
      mid = (int)(it - c.order.begin());
      if (mid == begin || mid == end) mid = -1;
    }
  }
  if (mid < 0) {
    // median split on the widest axis
    mid = begin + n / 2;
    std::nth_element(c.order.begin() + begin, c.order.begin() + mid,
                     c.order.begin() + end, [&](int a, int b) {
                       return c.centroid[3 * a + axis] <
                              c.centroid[3 * b + axis];
                     });
  }
  build(c, begin, mid);
  build(c, mid, end);
}

}  // namespace

extern "C" {

int rr_build_clusters(const float* verts, int n_verts, const int* tris,
                      int n_tris, int max_leaf, int* perm_out,
                      float* aabb_out, int* count_out, int max_clusters) {
  (void)n_verts;
  if (n_tris <= 0 || max_leaf <= 0) return -1;
  BuildCtx c;
  c.verts = verts;
  c.tris = tris;
  c.max_leaf = max_leaf;
  c.perm_out = perm_out;
  c.aabb_out = aabb_out;
  c.count_out = count_out;
  c.max_clusters = max_clusters;
  c.tri_box.resize(n_tris);
  c.centroid.resize(3 * (size_t)n_tris);
  c.order.resize(n_tris);
  for (int i = 0; i < n_tris; ++i) {
    c.order[i] = i;
    AABB& b = c.tri_box[i];
    for (int v = 0; v < 3; ++v) b.grow(&verts[3 * (size_t)tris[3 * i + v]]);
    for (int k = 0; k < 3; ++k)
      c.centroid[3 * (size_t)i + k] = 0.5f * (b.lo[k] + b.hi[k]);
  }
  build(c, 0, n_tris);
  if (c.overflow) return -1;
  return c.n_clusters;
}

// Version marker so the Python side can detect stale shared objects.
int rr_abi_version() { return 1; }

}  // extern "C"
