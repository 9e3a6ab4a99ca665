// Shared device code of the traversal kernels (traverse.cu,
// traverse_items.cu, traverse_entries.cu): the scene encoding, the instance
// re-base, the slab test of one supernode child, the treelet leaf test and
// the stackful per-ray BVH walk of the items kernels (K1/K2 in traverse.cu
// walk with their own loop over the same helpers).
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
//   * children are visited in the TPU kernels' order: the last child hit
//     is taken next, earlier hits are pushed (popped in reverse).
//
// The products and sums of the instance re-base and the leaf test are
// written with round-to-nearest intrinsics (__fmul_rn, __fadd_rn), which
// the compiler never contracts into multiply-adds: every operation rounds
// as in the plain torch walks (ops/traverse.py), in the same order, so the
// kernels match them bit for bit. t = -o'_w / d'_w is an exact division.
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

// Slab test of child c of a supernode row (see slab).
__device__ __forceinline__ bool child_slab(const int* __restrict__ row, int c,
                                           const Ray& r, float* tn_out) {
  const float2* box = reinterpret_cast<const float2*>(row);
  const float2 b01 = __ldg(box + 3 * c + 0);  // min x, min y
  const float2 b23 = __ldg(box + 3 * c + 1);  // min z, max x
  const float2 b45 = __ldg(box + 3 * c + 2);  // max y, max z
  return slab(b01.x, b01.y, b23.x, b23.y, b45.x, b45.y, r, tn_out);
}

// A box stored inverted (min > max on some axis) marks an unused slot.
__device__ __forceinline__ bool child_box_valid(const int* __restrict__ row, int c) {
  const float* b = reinterpret_cast<const float*>(row) + 6 * c;
  return __ldg(b + 0) <= __ldg(b + 3) && __ldg(b + 1) <= __ldg(b + 4) &&
         __ldg(b + 2) <= __ldg(b + 5);
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

struct Hit {
  float t, u, v;
  int prim, inst;
  bool occluded;
};

// Stackful walk of one world ray (wo, wd) from supernode `node` in the
// space of instance `inst` (-1: the TLAS, in world space), with its own
// (node, inst) stack. Starting at the TLAS root walks both levels (the
// classic kernel); starting at an instance's BLAS root with that instance
// walks its BLAS alone (the two-phase items kernel).
template <bool kAnyHit>
__device__ __forceinline__ Hit walk(const int* __restrict__ nodes, int n_nodes,
                                    const float4* __restrict__ tris, int n_tri_rows,
                                    const float4* __restrict__ insts, int n_inst,
                                    const int* __restrict__ roots, int node, int inst,
                                    float wox, float woy, float woz,
                                    float wdx, float wdy, float wdz, float t_limit) {
  Hit h;
  h.t = fminf(t_limit, kTMax);
  h.prim = -1;
  h.inst = -1;
  h.u = 0.0f;
  h.v = 0.0f;
  h.occluded = false;

  int2 stack[kStackDepth];
  int sp = 0;
  int cached = -1;
  Ray r = set_obj(insts, n_inst, wox, woy, woz, wdx, wdy, wdz);

  for (int it = 0; it < kMaxIters; ++it) {
    if (node == -1) {
      if (sp <= 0) break;
      --sp;
      node = stack[sp].x;
      inst = stack[sp].y;
    }
    if (inst != cached) {
      const int row = (inst < 0 || inst >= n_inst) ? n_inst : inst;
      r = set_obj(insts, row, wox, woy, woz, wdx, wdy, wdz);
      cached = inst;
    }

    if (node <= -2) {
      // ---- treelet leaf: test its `count` Woop slots
      const int lv = -node - 2;
      const int first = (lv >> kTShift) << kTShift;
      const int count = (lv & (kTreelet - 1)) + 1;
      node = -1;
      if (first + count > n_tri_rows) continue;
      float best = h.t, bu = 0.0f, bv = 0.0f;
      int win = -1;
      if (leaf_test<kAnyHit>(tris, first, count, r, best, bu, bv, win)) {
        h.occluded = true;
        return h;
      }
      if (!kAnyHit && win >= 0) {
        h.t = best;
        h.prim = first + win;
        h.inst = inst;
        h.u = bu;
        h.v = bv;
      }
      continue;
    }
    if (node >= n_nodes) {  // malformed code: drop it
      node = -1;
      continue;
    }

    // ---- internal supernode: slab-test the children, push all hits but
    // the last, descend into the last
    const int* row = nodes + static_cast<size_t>(node) * kNodeInts;
    const int4 c0 = __ldg(reinterpret_cast<const int4*>(row + 6 * kArity));
    const int4 c1 = __ldg(reinterpret_cast<const int4*>(row + 6 * kArity + 4));
    const int4 n0 = __ldg(reinterpret_cast<const int4*>(row + 7 * kArity));
    const int4 n1 = __ldg(reinterpret_cast<const int4*>(row + 7 * kArity + 4));
    const int codes[kArity] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
    const int cnts[kArity] = {n0.x, n0.y, n0.z, n0.w, n1.x, n1.y, n1.z, n1.w};
    const bool in_tlas = inst < 0;
    int next_code = -1, next_inst = inst;
#pragma unroll
    for (int c = 0; c < kArity; ++c) {
      const int code = codes[c];
      const int cnt = cnts[c];
      if (code < 0 && cnt == 0) continue;  // empty slot
      float tn;
      if (!child_slab(row, c, r, &tn) || !(tn < h.t)) continue;
      int e_code = code, e_inst = inst;
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
      if (next_code != -1) {
        stack[min(sp, kStackDepth - 1)] = make_int2(next_code, next_inst);
        sp = min(sp + 1, kStackDepth);
      }
      next_code = e_code;
      next_inst = e_inst;
    }
    node = next_code;
    inst = next_inst;
  }
  return h;
}

}  // namespace rfw
