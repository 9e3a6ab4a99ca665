// rfw_native — host-side native runtime components.
//
// The reference keeps its only native core in the Metal backend
// (backends/metal/cpp: renderer + buffer arenas, built by build.rs via cc).
// The TPU rebuild's native layer instead accelerates the *host* side of the
// render pipeline that cannot run on-device: BVH construction/refit for the
// per-frame BLAS rebuilds of skinned/deformed meshes (reference rtbvh
// BinnedSahBuilder + refit, gpu-rt/src/lib.rs:1345-1384).
//
// Exposed as a C ABI for ctypes (no pybind11 in the image). The node layout
// matches rfw_tpu_torch.accel.bvh_cpu.BvhNodes exactly:
//   internal: node_left = left child, node_right = right child, count = 0
//   leaf:     node_left = first index into prim_order, count = #prims
//
// The port's copy of rfw_tpu/native/src/bvh.cpp, the same code and C ABI.
// Built at first use by rfw_tpu_torch.native (g++ -O3 -march=native -fPIC
// -shared -std=c++17, into build/rfw_tpu_torch/<hash>/).

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <array>
#include <utility>
#include <vector>

namespace {

constexpr int kBins = 16;

struct Vec3 {
  float x, y, z;
};

static inline Vec3 vmin(const Vec3 &a, const Vec3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3 &a, const Vec3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
static inline float surface_area(const Vec3 &mn, const Vec3 &mx) {
  float ex = std::max(mx.x - mn.x, 0.f);
  float ey = std::max(mx.y - mn.y, 0.f);
  float ez = std::max(mx.z - mn.z, 0.f);
  return 2.f * (ex * ey + ey * ez + ez * ex);
}

struct Builder {
  const Vec3 *aabb_min;
  const Vec3 *aabb_max;
  std::vector<Vec3> centroid;
  int max_leaf;

  float *node_min;
  float *node_max;
  int32_t *node_left;
  int32_t *node_right;
  int32_t *node_count;
  int32_t *order;
  int n_nodes = 0;

  struct Item {
    int node, start, end;
  };

  int build(int n) {
    centroid.resize(n);
    for (int i = 0; i < n; i++) {
      centroid[i] = {0.5f * (aabb_min[i].x + aabb_max[i].x),
                     0.5f * (aabb_min[i].y + aabb_max[i].y),
                     0.5f * (aabb_min[i].z + aabb_max[i].z)};
    }
    n_nodes = 1;
    std::vector<Item> stack;
    stack.push_back({0, 0, n});
    while (!stack.empty()) {
      Item it = stack.back();
      stack.pop_back();
      process(it, stack);
    }
    return n_nodes;
  }

  void process(const Item &it, std::vector<Item> &stack) {
    const int node = it.node, start = it.start, end = it.end;
    const int count = end - start;

    Vec3 bmin = {FLT_MAX, FLT_MAX, FLT_MAX};
    Vec3 bmax = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
    Vec3 cmin = bmin, cmax = bmax;
    for (int i = start; i < end; i++) {
      int id = order[i];
      bmin = vmin(bmin, aabb_min[id]);
      bmax = vmax(bmax, aabb_max[id]);
      cmin = vmin(cmin, centroid[id]);
      cmax = vmax(cmax, centroid[id]);
    }
    std::memcpy(node_min + 3 * node, &bmin, 12);
    std::memcpy(node_max + 3 * node, &bmax, 12);

    if (count <= max_leaf) {
      node_left[node] = start;
      node_right[node] = 0;
      node_count[node] = count;
      return;
    }

    Vec3 ext = {cmax.x - cmin.x, cmax.y - cmin.y, cmax.z - cmin.z};
    int axis = 0;
    float best_ext = ext.x;
    if (ext.y > best_ext) { axis = 1; best_ext = ext.y; }
    if (ext.z > best_ext) { axis = 2; best_ext = ext.z; }

    int mid = -1;
    const float *cent_axis = &centroid[0].x;
    auto cval = [&](int id) { return (&centroid[id].x)[axis]; };
    float corigin = (&cmin.x)[axis];

    if (best_ext >= 1e-12f) {
      // binned SAH
      float scale = kBins * (1.0f - 1e-6f) / best_ext;
      int cnt[kBins] = {0};
      Vec3 bin_mn[kBins], bin_mx[kBins];
      for (int b = 0; b < kBins; b++) {
        bin_mn[b] = {FLT_MAX, FLT_MAX, FLT_MAX};
        bin_mx[b] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
      }
      for (int i = start; i < end; i++) {
        int id = order[i];
        int b = (int)((cval(id) - corigin) * scale);
        b = std::min(std::max(b, 0), kBins - 1);
        cnt[b]++;
        bin_mn[b] = vmin(bin_mn[b], aabb_min[id]);
        bin_mx[b] = vmax(bin_mx[b], aabb_max[id]);
      }
      // sweeps
      float la[kBins], ra[kBins];
      int lc[kBins], rc[kBins];
      Vec3 mn = {FLT_MAX, FLT_MAX, FLT_MAX}, mx = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
      int c = 0;
      for (int b = 0; b < kBins; b++) {
        mn = vmin(mn, bin_mn[b]);
        mx = vmax(mx, bin_mx[b]);
        c += cnt[b];
        la[b] = surface_area(mn, mx);
        lc[b] = c;
      }
      mn = {FLT_MAX, FLT_MAX, FLT_MAX};
      mx = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
      c = 0;
      for (int b = kBins - 1; b >= 0; b--) {
        mn = vmin(mn, bin_mn[b]);
        mx = vmax(mx, bin_mx[b]);
        c += cnt[b];
        ra[b] = surface_area(mn, mx);
        rc[b] = c;
      }
      float best_cost = FLT_MAX;
      int best_b = -1;
      for (int b = 0; b < kBins - 1; b++) {
        if (lc[b] == 0 || rc[b + 1] == 0) continue;
        float cost = la[b] * lc[b] + ra[b + 1] * rc[b + 1];
        if (cost < best_cost) {
          best_cost = cost;
          best_b = b;
        }
      }
      if (best_b >= 0) {
        // partition by bin <= best_b (stable not required)
        int i = start, j = end - 1;
        while (i <= j) {
          int id = order[i];
          int b = (int)((cval(id) - corigin) * scale);
          b = std::min(std::max(b, 0), kBins - 1);
          if (b <= best_b) {
            i++;
          } else {
            std::swap(order[i], order[j]);
            j--;
          }
        }
        if (i > start && i < end) mid = i;
      }
    }

    if (mid < 0) {
      // median split
      int half = start + count / 2;
      std::nth_element(order + start, order + half, order + end,
                       [&](int a, int b) { return cval(a) < cval(b); });
      mid = half;
    }

    int left = n_nodes;
    n_nodes += 2;
    node_left[node] = left;
    node_right[node] = left + 1;
    node_count[node] = 0;
    stack.push_back({left + 1, mid, end});
    stack.push_back({left, start, mid});
  }
};

}  // namespace

extern "C" {

// Returns node count. Output buffers must hold >= 2n nodes; prim_order n.
int rfw_build_bvh_sah(const float *aabb_min, const float *aabb_max, int n,
                      int max_leaf, float *node_min, float *node_max,
                      int32_t *node_left, int32_t *node_right,
                      int32_t *node_count, int32_t *prim_order) {
  if (n <= 0) return 0;
  for (int i = 0; i < n; i++) prim_order[i] = i;
  Builder b;
  b.aabb_min = reinterpret_cast<const Vec3 *>(aabb_min);
  b.aabb_max = reinterpret_cast<const Vec3 *>(aabb_max);
  b.max_leaf = max_leaf;
  b.node_min = node_min;
  b.node_max = node_max;
  b.node_left = node_left;
  b.node_right = node_right;
  b.node_count = node_count;
  b.order = prim_order;
  return b.build(n);
}

// Bottom-up refit: nodes must be in an order where children have higher
// indices than parents (true for both builders here).
void rfw_refit_bvh(int n_nodes, float *node_min, float *node_max,
                   const int32_t *node_left, const int32_t *node_right,
                   const int32_t *node_count, const int32_t *prim_order,
                   const float *aabb_min, const float *aabb_max) {
  for (int i = n_nodes - 1; i >= 0; i--) {
    if (node_count[i] > 0) {
      Vec3 mn = {FLT_MAX, FLT_MAX, FLT_MAX};
      Vec3 mx = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
      for (int k = 0; k < node_count[i]; k++) {
        int id = prim_order[node_left[i] + k];
        mn = vmin(mn, reinterpret_cast<const Vec3 *>(aabb_min)[id]);
        mx = vmax(mx, reinterpret_cast<const Vec3 *>(aabb_max)[id]);
      }
      std::memcpy(node_min + 3 * i, &mn, 12);
      std::memcpy(node_max + 3 * i, &mx, 12);
    } else {
      int l = node_left[i], r = node_right[i];
      Vec3 lmn, lmx, rmn, rmx;
      std::memcpy(&lmn, node_min + 3 * l, 12);
      std::memcpy(&lmx, node_max + 3 * l, 12);
      std::memcpy(&rmn, node_min + 3 * r, 12);
      std::memcpy(&rmx, node_max + 3 * r, 12);
      Vec3 mn = vmin(lmn, rmn), mx = vmax(lmx, rmx);
      std::memcpy(node_min + 3 * i, &mn, 12);
      std::memcpy(node_max + 3 * i, &mx, 12);
    }
  }
}

// Vectorized LBS skinning (reference SkinnedMesh3D::apply): one pass,
// positions only (normals are re-derived or skinned on device).
void rfw_skin_positions(int n_verts, const float *positions,
                        const int32_t *joints, const float *weights,
                        const float *joint_matrices /* (J,16) row-major */,
                        float *out_positions) {
  for (int v = 0; v < n_verts; v++) {
    float m[12] = {0};
    float wsum = 0.f;
    for (int k = 0; k < 4; k++) {
      float w = weights[4 * v + k];
      if (w == 0.f) continue;
      wsum += w;
      const float *jm = joint_matrices + 16 * joints[4 * v + k];
      for (int e = 0; e < 12; e++) m[e] += w * jm[e];
    }
    const float *p = positions + 3 * v;
    float *o = out_positions + 3 * v;
    if (wsum <= 1e-8f) {
      // all-zero weights keep the rest pose (glTF permits unweighted
      // vertices; blending a zero matrix would collapse them to the
      // origin — must match the device path's has_w guard)
      o[0] = p[0]; o[1] = p[1]; o[2] = p[2];
      continue;
    }
    o[0] = m[0] * p[0] + m[1] * p[1] + m[2] * p[2] + m[3];
    o[1] = m[4] * p[0] + m[5] * p[1] + m[6] * p[2] + m[7];
    o[2] = m[8] * p[0] + m[9] * p[1] + m[10] * p[2] + m[11];
  }
}

}  // extern "C"

// Wide supernode collapse (mirror of rfw_tpu_torch.render.pack.build_widen):
// per-frame hot path for skinned-mesh BLAS rebuilds. Same child encoding.
// `depth` binary levels collapse into one (1<<depth)-ary supernode
// (depth=3 -> 8-wide, the historical default; depth=4 -> 16-wide, whose
// 96 box + 16 code + 16 cnt rows fill one 128-row traversal column).
// `root` lets callers collapse a subtree of a merged node arena.
extern "C" int rfw_build_widen(
    int n_nodes, const float *node_min, const float *node_max,
    const int32_t *node_left, const int32_t *node_right,
    const int32_t *node_count, const int32_t *prim_order, int tlas,
    int leaf_base_offset, int depth, int root,
    // outputs sized for worst case n_nodes supers:
    float *box,     // (S, 6*arity)
    int32_t *code,  // (S, arity)
    int32_t *cnt)   // (S, arity)
{
  if (depth < 1 || depth > 5) return -1;
  const int arity = 1 << depth;
  const int bstride = 6 * arity;

  auto leaf_payload = [&](int n) -> int32_t {
    if (tlas) return prim_order[node_left[n]];
    return node_left[n] + leaf_base_offset;
  };

  auto empty_fill = [&](int si) {
    // +inf/-inf (not FLT_MAX) so empty children match the Python
    // fallback bit-for-bit — either never passes a slab test
    for (int k = 0; k < arity; k++) {
      for (int a = 0; a < 3; a++) {
        box[si * bstride + 6 * k + a] = HUGE_VALF;
        box[si * bstride + 6 * k + 3 + a] = -HUGE_VALF;
      }
      code[si * arity + k] = -1;
      cnt[si * arity + k] = 0;
    }
  };

  if (node_count[root] > 0) {  // root is a leaf
    empty_fill(0);
    for (int a = 0; a < 3; a++) {
      box[0 + a] = node_min[3 * root + a];
      box[3 + a] = node_max[3 * root + a];
    }
    code[0] = -(leaf_payload(root) + 1);
    cnt[0] = node_count[root];
    return 1;
  }

  std::vector<int32_t> super_of(n_nodes, -1);
  std::vector<int32_t> order;
  order.reserve(n_nodes / 4 + 1);
  std::vector<int32_t> queue;
  queue.reserve(n_nodes / 4 + 1);

  auto sid = [&](int b) -> int32_t {
    if (super_of[b] < 0) {
      super_of[b] = (int32_t)order.size();
      order.push_back(b);
      queue.push_back(b);
    }
    return super_of[b];
  };
  sid(root);

  struct Frame { int32_t n, dpt; };

  size_t qi = 0;
  while (qi < queue.size()) {
    int b = queue[qi++];
    int si = super_of[b];
    empty_fill(si);
    Frame frontier[64];
    int fp = 0;
    frontier[fp++] = {node_left[b], 1};
    frontier[fp++] = {node_right[b], 1};
    int k = 0;
    while (fp > 0) {
      Frame f = frontier[--fp];
      if (node_count[f.n] > 0 || f.dpt >= depth) {
        for (int a = 0; a < 3; a++) {
          box[si * bstride + 6 * k + a] = node_min[3 * f.n + a];
          box[si * bstride + 6 * k + 3 + a] = node_max[3 * f.n + a];
        }
        if (node_count[f.n] > 0) {
          code[si * arity + k] = -(leaf_payload(f.n) + 1);
          cnt[si * arity + k] = node_count[f.n];
        } else {
          code[si * arity + k] = sid(f.n);
          cnt[si * arity + k] = 0;
        }
        k++;
      } else {
        frontier[fp++] = {node_left[f.n], (int32_t)(f.dpt + 1)};
        frontier[fp++] = {node_right[f.n], (int32_t)(f.dpt + 1)};
      }
    }
  }
  return (int)order.size();
}

// Back-compat 8-wide entry (stale callers / old bindings).
extern "C" int rfw_build_wide8(
    int n_nodes, const float *node_min, const float *node_max,
    const int32_t *node_left, const int32_t *node_right,
    const int32_t *node_count, const int32_t *prim_order, int tlas,
    int leaf_base_offset, float *box, int32_t *code, int32_t *cnt)
{
  return rfw_build_widen(n_nodes, node_min, node_max, node_left, node_right,
                         node_count, prim_order, tlas, leaf_base_offset,
                         3, 0, box, code, cnt);
}
