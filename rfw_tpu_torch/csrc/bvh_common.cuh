// Shared device code of the traversal kernels (traverse.cu,
// traverse_items.cu, traverse_entries.cu): the scene encoding, the instance
// re-base, the slab test, the treelet leaf test, the persistent-warp ray
// fetch and launch shape, and the one nearest-first two-level walk that K1/K2
// (from the TLAS root) and K3/K5 (from an item's BLAS root) instantiate.
//
// Scene encoding (rfw_tpu_torch/ops/traverse.py::prepare_scene):
//   * 8-wide supernodes, one row of 64 int32 each: 48 box-float bit
//     patterns (child k = min3|max3 at 6k..6k+5), 8 child codes, 8 counts.
//     code >= 0 is an internal node, -1 is "pop", <= -2 a treelet leaf;
//     a TLAS leaf child enters roots[instance] in that instance's object
//     space (the ray is re-based through the instance's world->object
//     affine on every instance switch).
//   * treelet leaves of up to 64 triangles, each slot a precomputed Woop
//     world->unit-triangle 3x4 affine (16 floats per slot, 12 used). The
//     hit test: u,v >= -1e-7, u+v <= 1+1e-7, T_MIN < t < t_best; ties
//     within a treelet go to the lowest slot, a later treelet must be
//     strictly nearer; prim = treelet first + slot.
//   * the walk takes a node's children nearest first: the nearest child
//     hit is entered, the second nearest pushed last and the rest before
//     it, each with its entry t, and a popped entry whose box starts at or
//     past the best hit is dropped. The TPU kernels (and the plain torch
//     walks) enter the last child hit and push the earlier ones. The
//     closest t is the minimum over the same triangles either way, so only
//     an exact-t tie can change prim/inst/u/v, and only a box dropped at
//     the rounding edge (its entry t past a triangle inside it) can change
//     t; an any-hit flag does not depend on the order.
//
// The products and sums of the instance re-base and the leaf test are
// written with round-to-nearest intrinsics (__fmul_rn, __fadd_rn), which
// the compiler never contracts into multiply-adds: every operation rounds
// as in the plain torch walks (ops/traverse.py), in the same order, so the
// kernels match them bit for bit on the same visits. t = -o'_w / d'_w is an
// exact division.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rfw {

constexpr int kArity = 8;
constexpr int kNodeInts = 8 * kArity;  // 48 box bits + 8 codes + 8 counts
constexpr int kTreelet = 64;
constexpr int kTShift = 6;
constexpr int kStackDepth = 96;
// per-ray iteration cap: a malformed BVH yields a wrong but finite result
constexpr int kMaxIters = 1 << 19;
constexpr float kTMin = 1e-5f;
constexpr float kTMax = 1e26f;
constexpr int kBlock = 128;

// The persistent walks (K1-K5): block size and register cap chosen by
// measurement on K1 (PERF.md), and the idle lanes at which a warp
// fetches rays.
constexpr int kWalkBlock = 128;  // threads per block
constexpr int kMinBlocks = 8;    // resident blocks per SM: at most 64 registers
constexpr int kRefill = 16;      // idle lanes at which a warp fetches rays
constexpr unsigned kAllLanes = 0xffffffffu;
constexpr float kNone = 3.0e38f;  // no candidate: above every t (T_MAX is 1e26)

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

// a.x*x + a.y*y + a.z*z, summed left to right, each step rounded alone
__device__ __forceinline__ float dot3(float ax, float ay, float az,
                                      float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, x), __fmul_rn(ay, y)), __fmul_rn(az, z));
}

// a mod m in [0, m) for m > 0, as Python's and jnp's % (C's % truncates)
__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ float safe_inv(float x) {
  const float y = fabsf(x) < 1e-20f ? (x < 0.0f ? -1e-20f : 1e-20f) : x;
  return 1.0f / y;
}

// The world ray through the 3x4 affine of rows m0, m1, m2.
__device__ __forceinline__ Ray rebase(const float4& m0, const float4& m1, const float4& m2,
                                      float wox, float woy, float woz,
                                      float wdx, float wdy, float wdz) {
  Ray r;
  r.ox = __fadd_rn(dot3(m0.x, m0.y, m0.z, wox, woy, woz), m0.w);
  r.oy = __fadd_rn(dot3(m1.x, m1.y, m1.z, wox, woy, woz), m1.w);
  r.oz = __fadd_rn(dot3(m2.x, m2.y, m2.z, wox, woy, woz), m2.w);
  r.dx = dot3(m0.x, m0.y, m0.z, wdx, wdy, wdz);
  r.dy = dot3(m1.x, m1.y, m1.z, wdx, wdy, wdz);
  r.dz = dot3(m2.x, m2.y, m2.z, wdx, wdy, wdz);
  r.ix = safe_inv(r.dx);
  r.iy = safe_inv(r.dy);
  r.iz = safe_inv(r.dz);
  return r;
}

// Re-base the world ray into the object space of instance row `row`
// (world->object 3x4 affine, 16 floats per row; the last row is identity).
__device__ __forceinline__ Ray set_obj(const float4* __restrict__ insts, int row,
                                       float wox, float woy, float woz,
                                       float wdx, float wdy, float wdz) {
  return rebase(__ldg(insts + 4 * row + 0), __ldg(insts + 4 * row + 1),
                __ldg(insts + 4 * row + 2), wox, woy, woz, wdx, wdy, wdz);
}

// Slab test of the box (x0, y0, z0)-(x1, y1, z1): entry/exit t in (tn, tf).
// Returns true when the box has tn <= tf and tf > T_MIN.
__device__ __forceinline__ bool slab(float x0, float y0, float z0, float x1, float y1,
                                     float z1, const Ray& r, float* tn_out) {
  const float tx0 = (x0 - r.ox) * r.ix;
  const float tx1 = (x1 - r.ox) * r.ix;
  const float ty0 = (y0 - r.oy) * r.iy;
  const float ty1 = (y1 - r.oy) * r.iy;
  const float tz0 = (z0 - r.oz) * r.iz;
  const float tz1 = (z1 - r.oz) * r.iz;
  const float tn = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
  const float tf = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
  *tn_out = tn;
  return tn <= tf && tf > kTMin;
}

// The eight children of supernode row `row`, in pairs of three float4 box
// loads and one int4 each of codes and counts a quad: child(x0, y0, z0, x1,
// y1, z1, code, count) per child slot, in slot order.
template <class Child>
__device__ __forceinline__ void for_children(const int* __restrict__ row, Child& child) {
  const float4* box = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int4 cq = __ldg(reinterpret_cast<const int4*>(row + 6 * kArity) + q);
    const int4 nq = __ldg(reinterpret_cast<const int4*>(row + 7 * kArity) + q);
    const float4 a0 = __ldg(box + 6 * q + 0), a1 = __ldg(box + 6 * q + 1),
                 a2 = __ldg(box + 6 * q + 2);
    child(a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, cq.x, nq.x);
    child(a1.z, a1.w, a2.x, a2.y, a2.z, a2.w, cq.y, nq.y);
    const float4 b0 = __ldg(box + 6 * q + 3), b1 = __ldg(box + 6 * q + 4),
                 b2 = __ldg(box + 6 * q + 5);
    child(b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, cq.z, nq.z);
    child(b1.z, b1.w, b2.x, b2.y, b2.z, b2.w, cq.w, nq.w);
  }
}

// Woop test of one slot (rows a, b, c: u, v, w of the affine) against the
// object-space ray: (t, u, v), and whether it passes in (T_MIN, best).
__device__ __forceinline__ bool slot_hit(const float4& a, const float4& b, const float4& c,
                                         const Ray& r, float best, float& t, float& u,
                                         float& v) {
  const float opu = __fadd_rn(dot3(a.x, a.y, a.z, r.ox, r.oy, r.oz), a.w);
  const float opv = __fadd_rn(dot3(b.x, b.y, b.z, r.ox, r.oy, r.oz), b.w);
  const float opw = __fadd_rn(dot3(c.x, c.y, c.z, r.ox, r.oy, r.oz), c.w);
  const float dpu = dot3(a.x, a.y, a.z, r.dx, r.dy, r.dz);
  const float dpv = dot3(b.x, b.y, b.z, r.dx, r.dy, r.dz);
  const float dpw = dot3(c.x, c.y, c.z, r.dx, r.dy, r.dz);
  t = -opw / dpw;  // degenerate slots: NaN/inf, never pass
  u = __fadd_rn(opu, __fmul_rn(t, dpu));
  v = __fadd_rn(opv, __fmul_rn(t, dpv));
  return u >= -1e-7f && v >= -1e-7f && u + v <= 1.0000001f && t > kTMin && t < best;
}

// Test the `count` (>= 1) Woop slots of the treelet starting at triangle
// row `first` against the object-space ray. Closest hit: lowers `best` and
// sets (win, bu, bv) on a strictly nearer hit (lowest slot among ties).
// Any hit: returns true at the first slot that passes. The next slot's
// three loads (u, v, w rows) are issued before the current slot's test, so
// a slot's fetch latency hides behind its predecessor's arithmetic; the
// last slot reloads itself rather than read past `count`. The slots are
// tested in the same order either way, so the winner does not change.
template <bool kAnyHit>
__device__ __forceinline__ bool leaf_test(const float4* __restrict__ tris, int first,
                                          int count, const Ray& r, float& best,
                                          float& bu, float& bv, int& win) {
  const float4* slot = tris + 4 * static_cast<size_t>(first);
  float4 a = __ldg(slot + 0), b = __ldg(slot + 1), c = __ldg(slot + 2);
#pragma unroll 2
  for (int j = 0; j < count; ++j) {
    const float4* nx = slot + 4 * min(j + 1, count - 1);
    const float4 na = __ldg(nx + 0), nb = __ldg(nx + 1), nc = __ldg(nx + 2);
    float t, u, v;
    if (slot_hit(a, b, c, r, best, t, u, v)) {
      if (kAnyHit) return true;
      best = t;
      bu = u;
      bv = v;
      win = j;
    }
    a = na;
    b = nb;
    c = nc;
  }
  return false;
}

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// ---------------------------------------------------------------- persistent warps
// Persistent warps with dynamic ray fetch (Aila & Laine, HPG 2009): a full
// card of resident blocks; a warp takes the next rays of a global counter
// (one int32 the caller zeroes) for its idle lanes once kRefill of them are
// idle, so no lane idles long behind a warp's longest ray and no SM waits
// on another's tail. Within a fetch, while-while: a lane at a leaf waits
// while another lane of its warp holds an internal node, so the leaf tests,
// the long part of a walk, run with the warp's lanes together. The card
// serves the atomics on the one counter one after another, ~3 ns a fetch
// round, which bounds a call of short walks or of mostly empty slots (K4
// on the flagship, K5 on the heavy scene's 97% empty slots: PERF.md, §6);
// claiming larger windows per atomic was measured and lost more elsewhere.
//
// `lane` is one thread's walk: start(i) takes ray i (false: it has nothing
// to walk, and its outputs are written), pop() pops until the lane holds a
// node (false: done), at_leaf() says whether it holds a leaf, visit() makes
// one visit (false: done), finish(i) writes ray i's outputs. The counting
// instance (kStats) writes each warp's first and last %globaltimer to
// warp_ns (2 int64 per launched warp).
template <bool kStats, class Lane>
__device__ __forceinline__ void persistent(Lane& lane, int n, int* __restrict__ next,
                                           long long* __restrict__ warp_ns) {
  const int id = threadIdx.x & 31;
  const long long t0 = kStats ? global_ns() : 0;
  int ray = -1;
  bool pool = true;  // warp-uniform: rays may be left
  for (;;) {
    unsigned idle = __ballot_sync(kAllLanes, ray < 0);
    if (pool && __popc(idle) >= kRefill) {
      int base = 0;
      if (id == 0) base = atomicAdd(next, __popc(idle));
      base = __shfl_sync(kAllLanes, base, 0);
      if (base + __popc(idle) >= n) pool = false;
      if (ray < 0) {
        const int i = base + __popc(idle & ((1u << id) - 1u));
        if (i < n && lane.start(i)) ray = i;
      }
      idle = __ballot_sync(kAllLanes, ray < 0);
    }
    if (idle == kAllLanes) {
      if (!pool) break;
      continue;
    }
    for (;;) {
      if (ray >= 0 && !lane.pop()) {
        lane.finish(ray);
        ray = -1;
      }
      const bool at_leaf = ray >= 0 && lane.at_leaf();
      const bool inner = __any_sync(kAllLanes, ray >= 0 && !at_leaf);
      const bool wait = at_leaf && inner;
      if (ray >= 0 && !wait && !lane.visit()) {
        lane.finish(ray);
        ray = -1;
      }
      idle = __ballot_sync(kAllLanes, ray < 0);
      if (idle == kAllLanes || (pool && __popc(idle) >= kRefill)) break;
    }
  }
  if (kStats && id == 0) {
    const int gw = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    warp_ns[2 * gw + 0] = t0;
    warp_ns[2 * gw + 1] = global_ns();
  }
}

// The stack of (node, entry t) and, where the walk changes instance on a
// pop (kInst), the node's instance; in local memory, which L1 caches (a
// stack whose first entries sat in shared memory measured slower on K1).
// Overflow clamps as the plain walks do (the 96th entry is overwritten).
template <bool kInst>
struct Stack {
  int code[kStackDepth];
  int inst[kInst ? kStackDepth : 1];
  float tn[kStackDepth];
  int sp;

  __device__ __forceinline__ void push(int c, int i, float t) {
    const int k = min(sp, kStackDepth - 1);
    code[k] = c;
    if (kInst) inst[k] = i;
    tn[k] = t;
    sp = min(sp + 1, kStackDepth);
  }

  __device__ __forceinline__ void pop(int& c, int& i, float& t) {
    --sp;
    c = code[sp];
    if (kInst) i = inst[sp];
    t = tn[sp];
  }
};

// One ray's walk state.
struct Walker {
  float wox, woy, woz, wdx, wdy, wdz;  // the world ray
  float wix, wiy, wiz;                 // its reciprocals through the identity row
  Ray r;                               // the ray in the current instance's space
  float t, u, v;
  int prim, hinst;
  bool occ;
  int node, inst, cached, it;
  int nodes, boxes, leaves, tris;  // counts of the kStats instance
};

// How a K1/K2 lane starts ray i: at the TLAS root, in world space (inst
// -1). The walk keeps the ray's TLAS-space reciprocals, so a return to the
// TLAS re-bases with no loads and no divisions.
struct TlasEntry {
  static constexpr bool kTlas = true;
  int tlas_root;

  __device__ __forceinline__ bool operator()(int, int& node, int& inst) const {
    node = tlas_root;
    inst = -1;
    return true;
  }
};

// How a K3/K5 lane starts item i: at the BLAS root of the item's instance,
// in that instance (the first visit re-bases through its row); an empty
// slot (instance < 0) walks nothing. The walk never returns to the TLAS.
struct ItemEntry {
  static constexpr bool kTlas = false;
  const int* item_inst;
  const int* roots;
  int n_inst;

  __device__ __forceinline__ bool operator()(int i, int& node, int& inst) const {
    inst = item_inst[i];
    if (inst < 0) return false;
    node = __ldg(roots + min(inst, max(n_inst - 1, 0)));
    return true;
  }
};

// set_obj of the identity row (the TLAS), without its loads and divisions:
// the same products and sums with the row's constants, the reciprocals
// kept from the ray's start.
__device__ __forceinline__ Ray world_ray(const Walker& w) {
  Ray r;
  r.ox = __fadd_rn(dot3(1.0f, 0.0f, 0.0f, w.wox, w.woy, w.woz), 0.0f);
  r.oy = __fadd_rn(dot3(0.0f, 1.0f, 0.0f, w.wox, w.woy, w.woz), 0.0f);
  r.oz = __fadd_rn(dot3(0.0f, 0.0f, 1.0f, w.wox, w.woy, w.woz), 0.0f);
  r.dx = dot3(1.0f, 0.0f, 0.0f, w.wdx, w.wdy, w.wdz);
  r.dy = dot3(0.0f, 1.0f, 0.0f, w.wdx, w.wdy, w.wdz);
  r.dz = dot3(0.0f, 0.0f, 1.0f, w.wdx, w.wdy, w.wdz);
  r.ix = w.wix;
  r.iy = w.wiy;
  r.iz = w.wiz;
  return r;
}

// Start ray i as `entry` says; false (the walker then holds the empty
// result: t = min(t_limit, T_MAX), no hit, not occluded) when it walks
// nothing.
template <bool kInst, class Entry>
__device__ __forceinline__ bool start(Walker& w, Stack<kInst>& st, int i, const Entry& entry,
                                      const float* __restrict__ ray_o,
                                      const float* __restrict__ ray_d,
                                      const float* __restrict__ t_limit) {
  w.t = fminf(t_limit[i], kTMax);
  w.u = 0.0f;
  w.v = 0.0f;
  w.prim = -1;
  w.hinst = -1;
  w.occ = false;
  w.it = 0;
  w.nodes = w.boxes = w.leaves = w.tris = 0;
  st.sp = 0;
  if (!entry(i, w.node, w.inst)) return false;
  w.wox = ray_o[3 * i + 0];
  w.woy = ray_o[3 * i + 1];
  w.woz = ray_o[3 * i + 2];
  w.wdx = ray_d[3 * i + 0];
  w.wdy = ray_d[3 * i + 1];
  w.wdz = ray_d[3 * i + 2];
  if (Entry::kTlas) {
    w.wix = safe_inv(dot3(1.0f, 0.0f, 0.0f, w.wdx, w.wdy, w.wdz));
    w.wiy = safe_inv(dot3(0.0f, 1.0f, 0.0f, w.wdx, w.wdy, w.wdz));
    w.wiz = safe_inv(dot3(0.0f, 0.0f, 1.0f, w.wdx, w.wdy, w.wdz));
    w.r = world_ray(w);
    w.cached = -1;
  } else {
    w.cached = -2;  // no instance: the first visit re-bases
  }
  return true;
}

template <bool kAnyHit, bool kStats>
__device__ __forceinline__ void finish(const Walker& w, int i, float* __restrict__ out_t,
                                       int* __restrict__ out_prim, int* __restrict__ out_inst,
                                       float* __restrict__ out_u, float* __restrict__ out_v,
                                       bool* __restrict__ out_occluded,
                                       int4* __restrict__ out_stats) {
  if (kAnyHit) {
    out_occluded[i] = w.occ;
  } else {
    out_t[i] = w.t;
    out_prim[i] = w.prim;
    out_inst[i] = w.hinst;
    out_u[i] = w.u;
    out_v[i] = w.v;
  }
  if (kStats) out_stats[i] = make_int4(w.nodes, w.boxes, w.leaves, w.tris);
}

// Pop until the ray holds a node; false when its stack is empty. An entry
// whose box starts at or past the best hit is dropped.
template <bool kInst>
__device__ __forceinline__ bool pop(Walker& w, Stack<kInst>& st) {
  while (w.node == -1) {
    if (st.sp <= 0) return false;
    float tn;
    st.pop(w.node, w.inst, tn);
    if (!(tn < w.t)) w.node = -1;
  }
  return true;
}

// One visit (the node or leaf the ray holds). False when the ray is done:
// occluded (any hit) or at the iteration cap. kTlas: the walk may be in
// the TLAS (an instance leaf child enters that instance's BLAS).
template <bool kAnyHit, bool kStats, bool kTlas>
__device__ __forceinline__ bool visit(Walker& w, Stack<kTlas>& st,
                                      const int* __restrict__ nodes, int n_nodes,
                                      const float4* __restrict__ tris, int n_tri_rows,
                                      const float4* __restrict__ insts, int n_inst,
                                      const int* __restrict__ roots) {
  if (w.inst != w.cached) {
    const int row = (w.inst < 0 || w.inst >= n_inst) ? n_inst : w.inst;
    w.r = kTlas && row == n_inst
              ? world_ray(w)
              : set_obj(insts, row, w.wox, w.woy, w.woz, w.wdx, w.wdy, w.wdz);
    w.cached = w.inst;
  }

  if (w.node <= -2) {
    // ---- treelet leaf: test its `count` Woop slots
    const int lv = -w.node - 2;
    const int first = (lv >> kTShift) << kTShift;
    const int count = (lv & (kTreelet - 1)) + 1;
    w.node = -1;
    if (first + count <= n_tri_rows) {
      if (kStats) {
        ++w.leaves;
        w.tris += count;
      }
      float best = w.t, bu = 0.0f, bv = 0.0f;
      int win = -1;
      if (leaf_test<kAnyHit>(tris, first, count, w.r, best, bu, bv, win)) {
        w.occ = true;
        return false;
      }
      if (!kAnyHit && win >= 0) {
        w.t = best;
        w.prim = first + win;
        w.hinst = w.inst;
        w.u = bu;
        w.v = bv;
      }
    }
  } else if (w.node >= n_nodes) {  // malformed code: drop it
    w.node = -1;
  } else {
    // ---- internal supernode: slab-test the children; descend into the
    // nearest child hit, push the second nearest last and the others
    // before it, each with its entry t
    if (kStats) ++w.nodes;
    const int* row = nodes + static_cast<size_t>(w.node) * kNodeInts;
    const bool in_tlas = kTlas && w.inst < 0;
    int nx_code = -1, nx_inst = w.inst;
    float nx_tn = kNone;
    int sd_code = -1, sd_inst = w.inst;
    float sd_tn = kNone;
    auto child = [&](float x0, float y0, float z0, float x1, float y1, float z1, int code,
                     int cnt) {
      if (code < 0 && cnt == 0) return;  // empty slot
      if (kStats) ++w.boxes;
      float tn;
      if (!slab(x0, y0, z0, x1, y1, z1, w.r, &tn) || !(tn < w.t)) return;
      int e_code = code, e_inst = w.inst;
      if (code < 0) {
        const int payload = -code - 1;
        if (in_tlas) {  // instance leaf: enter its BLAS root
          const int iid = min(max(payload, 0), max(n_inst - 1, 0));
          e_code = __ldg(roots + iid);
          e_inst = payload;
        } else {  // triangle leaf: encode first + (count - 1)
          e_code = -(payload + min(cnt - 1, kTreelet - 1)) - 2;
        }
      }
      if (tn < nx_tn) {
        if (sd_tn != kNone) st.push(sd_code, sd_inst, sd_tn);
        sd_code = nx_code;
        sd_inst = nx_inst;
        sd_tn = nx_tn;
        nx_code = e_code;
        nx_inst = e_inst;
        nx_tn = tn;
      } else if (tn < sd_tn) {
        if (sd_tn != kNone) st.push(sd_code, sd_inst, sd_tn);
        sd_code = e_code;
        sd_inst = e_inst;
        sd_tn = tn;
      } else {
        st.push(e_code, e_inst, tn);
      }
    };
    for_children(row, child);
    if (sd_tn != kNone) st.push(sd_code, sd_inst, sd_tn);
    w.node = nx_code;
    w.inst = nx_inst;
  }
  return ++w.it < kMaxIters;
}

// One lane of the nearest-first walk for `persistent`: K1/K2 (TlasEntry)
// and K3/K5 (ItemEntry) instantiate it. The stack carries instances only
// where the walk can change instance (from the TLAS).
template <bool kAnyHit, bool kStats, class Entry>
struct WalkLane {
  Walker& w;
  Stack<Entry::kTlas>& st;
  Entry entry;
  const int* nodes;
  int n_nodes;
  const float4* tris;
  int n_tri_rows;
  const float4* insts;
  int n_inst;
  const int* roots;
  const float* ray_o;
  const float* ray_d;
  const float* t_limit;
  float* out_t;
  int* out_prim;
  int* out_inst;
  float* out_u;
  float* out_v;
  bool* out_occluded;
  int4* out_stats;

  __device__ __forceinline__ bool start(int i) {
    if (rfw::start(w, st, i, entry, ray_o, ray_d, t_limit)) return true;
    finish(i);  // an empty item: its outputs at once
    return false;
  }
  __device__ __forceinline__ bool pop() { return rfw::pop(w, st); }
  __device__ __forceinline__ bool at_leaf() const { return w.node <= -2; }
  __device__ __forceinline__ bool visit() {
    return rfw::visit<kAnyHit, kStats, Entry::kTlas>(w, st, nodes, n_nodes, tris, n_tri_rows,
                                                     insts, n_inst, roots);
  }
  __device__ __forceinline__ void finish(int i) {
    rfw::finish<kAnyHit, kStats>(w, i, out_t, out_prim, out_inst, out_u, out_v,
                                 out_occluded, out_stats);
  }
};

// The walk of n rays (K1/K2) or items (K3/K5) by persistent warps, each
// started as `entry` says.
template <bool kAnyHit, bool kStats, class Entry>
__device__ __forceinline__ void walk_rays(
    const Entry& entry, const int* __restrict__ nodes, int n_nodes,
    const float4* __restrict__ tris, int n_tri_rows, const float4* __restrict__ insts,
    int n_inst, const int* __restrict__ roots, const float* __restrict__ ray_o,
    const float* __restrict__ ray_d, const float* __restrict__ t_limit, int n,
    float* __restrict__ out_t, int* __restrict__ out_prim, int* __restrict__ out_inst,
    float* __restrict__ out_u, float* __restrict__ out_v, bool* __restrict__ out_occluded,
    int* __restrict__ next, int4* __restrict__ out_stats, long long* __restrict__ warp_ns) {
  Stack<Entry::kTlas> st;
  Walker w;
  WalkLane<kAnyHit, kStats, Entry> lane{w, st, entry, nodes, n_nodes, tris, n_tri_rows,
                                        insts, n_inst, roots, ray_o, ray_d, t_limit, out_t,
                                        out_prim, out_inst, out_u, out_v, out_occluded,
                                        out_stats};
  persistent<kStats>(lane, n, next, warp_ns);
}

// ---------------------------------------------------------------- launch shape
// Per device: SM count and, per kernel instance, resident blocks per SM of
// kWalkBlock threads.
struct Shape {
  int sms, per_sm;
};

template <auto kKernel>
cudaError_t shape(Shape* out) {
  static Shape cache[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  Shape& s = cache[dev & 63];
  if (s.sms == 0) {
    e = cudaDeviceGetAttribute(&s.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&s.per_sm, kKernel, kWalkBlock, 0);
    if (e != cudaSuccess) {
      s.sms = 0;
      return e;
    }
  }
  *out = s;
  return cudaSuccess;
}

// Blocks launched for n rays: a full card of resident blocks (the warps
// persist and fetch rays), fewer where the rays would not fill them.
template <auto kKernel>
cudaError_t grid_for(int n, int* grid) {
  const int need = (n + kWalkBlock - 1) / kWalkBlock;
  Shape s;
  const cudaError_t e = shape<kKernel>(&s);
  if (e != cudaSuccess) return e;
  *grid = min(need, max(s.sms * s.per_sm, 1));
  return cudaSuccess;
}

// Launch a persistent kernel over n rays on stream s; cudaGetLastError().
template <auto kKernel, class... Args>
int launch_persistent(int n, cudaStream_t s, Args... args) {
  int grid = 0;
  const cudaError_t e = grid_for<kKernel>(n, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  kKernel<<<grid, kWalkBlock, 0, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// The launch shape of a persistent kernel for n rays, into out[8]: block
// threads, resident blocks per SM, SMs, registers per thread, local and
// static shared bytes per thread / block, threads per SM, blocks launched.
template <auto kKernel>
int info(int n, int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kKernel);
  Shape s = {0, 0};
  if (e == cudaSuccess) e = shape<kKernel>(&s);
  int grid = 0;
  if (e == cudaSuccess) e = grid_for<kKernel>(n, &grid);
  int dev = 0, per_sm_threads = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&per_sm_threads, cudaDevAttrMaxThreadsPerMultiProcessor, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = kWalkBlock;
  out[1] = s.per_sm;
  out[2] = s.sms;
  out[3] = a.numRegs;
  out[4] = static_cast<int>(a.localSizeBytes);
  out[5] = static_cast<int>(a.sharedSizeBytes);
  out[6] = per_sm_threads;
  out[7] = grid;
  return 0;
}

}  // namespace rfw
