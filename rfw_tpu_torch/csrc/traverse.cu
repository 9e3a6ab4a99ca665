// Two-level BVH traversal for NVIDIA Hopper (sm_90a): closest hit and any hit.
//
// Replaces the TPU kernel rfw_tpu/ops/traverse.py::_traverse_kernel_factory
// in both of its forms: any_hit=False (closest hit: t, prim, inst, u, v) and
// any_hit=True (occlusion). It computes what that kernel computes over the
// same scene encoding (see rfw_tpu_torch/ops/traverse.py::prepare_scene):
//
//   * 8-wide supernodes, one row of 64 int32 each: 48 box-float bit
//     patterns (child k = min3|max3 at 6k..6k+5), 8 child codes, 8 counts.
//     code >= 0 is an internal node, -1 is "pop", <= -2 a treelet leaf;
//     a TLAS leaf child enters roots[instance] in that instance's object
//     space (the ray is re-based through the instance's world->object
//     affine on every instance switch).
//   * treelet leaves of up to 64 triangles, each slot a precomputed Woop
//     world->unit-triangle 3x4 affine (16 floats per slot, 12 used). The
//     hit test is the TPU kernel's: u,v >= -1e-7, u+v <= 1+1e-7,
//     T_MIN < t < t_best; ties within a treelet go to the lowest slot, a
//     later treelet must be strictly nearer; prim = treelet first + slot.
//   * children are visited in the TPU kernel's order: the last child hit
//     is taken next, earlier hits are pushed (popped in reverse).
//
// What differs, by design: one thread walks one ray with its own 96-deep
// (node, inst) stack in local memory — the reference GPU renderer's
// stackful per-ray walk — instead of the TPU's interleaved walks of 128-ray
// sub-tiles over a shared stack. A thread therefore visits only the nodes
// its own ray enters; results are the same up to exact-t ties. Empty child
// slots (code < 0 with count 0) are skipped: their inverted boxes pass the
// slab test, and on the TPU a TLAS empty slot re-enters instance 0, which
// changes no result. A leaf tests only its `count` slots (the TPU kernel
// tests all 64; the rest are all-zero affines that can never hit).
// t = -o'_w / d'_w is an exact division where the TPU used an approximate
// reciprocal plus one Newton step (whose own error is ~1.5e-5 relative).
// The products and sums of the instance re-base and the leaf test are
// written with round-to-nearest intrinsics (__fmul_rn, __fadd_rn), which
// the compiler never contracts into multiply-adds: every operation rounds
// as in the plain torch version of this walk (ops/traverse.py::_plain_walk),
// in the same order, and the kernel matches it bit for bit.
//
// What bounds it on an H100: latency of the dependent node and treelet
// fetches under warp divergence, not arithmetic or bandwidth. The scene
// arrays of the smoke scene (~26 MB) fit in the 50 MB L2, so the fetches
// are L2 hits after warm-up; the design keeps each node visit to 4 vector
// loads of codes/counts plus 3 per child box, and each triangle to 3
// float4 loads. Left for later: warp-coherent or persistent traversal,
// stacks in shared memory, compressed (quantized) nodes, nearest-first
// child order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ float safe_inv(float x) {
  const float y = fabsf(x) < 1e-20f ? (x < 0.0f ? -1e-20f : 1e-20f) : x;
  return 1.0f / y;
}

// Re-base the world ray into the object space of instance row `row`
// (world->object 3x4 affine, 16 floats per row; the last row is identity).
__device__ __forceinline__ Ray set_obj(const float4* __restrict__ insts, int row,
                                       float wox, float woy, float woz,
                                       float wdx, float wdy, float wdz) {
  const float4 m0 = __ldg(insts + 4 * row + 0);
  const float4 m1 = __ldg(insts + 4 * row + 1);
  const float4 m2 = __ldg(insts + 4 * row + 2);
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

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock) traverse_kernel(
    const int* __restrict__ nodes, int n_nodes,
    const float4* __restrict__ tris, int n_tri_rows,
    const float4* __restrict__ insts, int n_inst,
    const int* __restrict__ roots, int tlas_root,
    const float* __restrict__ ray_o, const float* __restrict__ ray_d,
    const float* __restrict__ t_limit, int n_rays,
    float* __restrict__ out_t, int* __restrict__ out_prim,
    int* __restrict__ out_inst, float* __restrict__ out_u,
    float* __restrict__ out_v, bool* __restrict__ out_occluded) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;

  const float wox = ray_o[3 * i + 0], woy = ray_o[3 * i + 1], woz = ray_o[3 * i + 2];
  const float wdx = ray_d[3 * i + 0], wdy = ray_d[3 * i + 1], wdz = ray_d[3 * i + 2];
  float t_best = fminf(t_limit[i], kTMax);
  int prim = -1, hit_inst = -1;
  float hit_u = 0.0f, hit_v = 0.0f;

  int2 stack[kStackDepth];
  int sp = 0;
  int node = tlas_root;
  int inst = -1;
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
      const float4* slot = tris + 4 * static_cast<size_t>(first);
      float best = t_best, bu = 0.0f, bv = 0.0f;
      int win = -1;
      for (int j = 0; j < count; ++j) {
        const float4 a = __ldg(slot + 4 * j + 0);  // u row
        const float4 b = __ldg(slot + 4 * j + 1);  // v row
        const float4 c = __ldg(slot + 4 * j + 2);  // w row
        const float opu = __fadd_rn(dot3(a.x, a.y, a.z, r.ox, r.oy, r.oz), a.w);
        const float opv = __fadd_rn(dot3(b.x, b.y, b.z, r.ox, r.oy, r.oz), b.w);
        const float opw = __fadd_rn(dot3(c.x, c.y, c.z, r.ox, r.oy, r.oz), c.w);
        const float dpu = dot3(a.x, a.y, a.z, r.dx, r.dy, r.dz);
        const float dpv = dot3(b.x, b.y, b.z, r.dx, r.dy, r.dz);
        const float dpw = dot3(c.x, c.y, c.z, r.dx, r.dy, r.dz);
        const float t = -opw / dpw;  // degenerate slots: NaN/inf, never pass
        const float u = __fadd_rn(opu, __fmul_rn(t, dpu));
        const float v = __fadd_rn(opv, __fmul_rn(t, dpv));
        if (u >= -1e-7f && v >= -1e-7f && u + v <= 1.0000001f && t > kTMin && t < best) {
          if (kAnyHit) {
            out_occluded[i] = true;
            return;
          }
          best = t;
          bu = u;
          bv = v;
          win = j;
        }
      }
      if (!kAnyHit && win >= 0) {
        t_best = best;
        prim = first + win;
        hit_inst = inst;
        hit_u = bu;
        hit_v = bv;
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
    const float2* box = reinterpret_cast<const float2*>(row);
    const bool in_tlas = inst < 0;
    int next_code = -1, next_inst = inst;
#pragma unroll
    for (int c = 0; c < kArity; ++c) {
      const int code = codes[c];
      const int cnt = cnts[c];
      if (code < 0 && cnt == 0) continue;  // empty slot
      const float2 b01 = __ldg(box + 3 * c + 0);  // min x, min y
      const float2 b23 = __ldg(box + 3 * c + 1);  // min z, max x
      const float2 b45 = __ldg(box + 3 * c + 2);  // max y, max z
      const float tx0 = (b01.x - r.ox) * r.ix;
      const float tx1 = (b23.y - r.ox) * r.ix;
      const float ty0 = (b01.y - r.oy) * r.iy;
      const float ty1 = (b45.x - r.oy) * r.iy;
      const float tz0 = (b23.x - r.oz) * r.iz;
      const float tz1 = (b45.y - r.oz) * r.iz;
      const float tn = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
      const float tf = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
      if (!(tn <= tf && tf > kTMin && tn < t_best)) continue;
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

  if (kAnyHit) {
    out_occluded[i] = false;
  } else {
    out_t[i] = t_best;
    out_prim[i] = prim;
    out_inst[i] = hit_inst;
    out_u[i] = hit_u;
    out_v[i] = hit_v;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream` and
// returns cudaGetLastError() of the launch (0 = success). It allocates
// nothing and does not synchronize.
extern "C" int rfw_traverse(
    int any_hit,
    const void* nodes, int n_nodes,
    const void* tris, int n_tri_rows,
    const void* insts, int n_inst,
    const void* roots, int tlas_root,
    const void* ray_o, const void* ray_d, const void* t_limit, int n_rays,
    void* out_t, void* out_prim, void* out_inst, void* out_u, void* out_v,
    void* out_occluded, void* stream) {
  if (n_rays <= 0) return 0;
  const dim3 grid((n_rays + kBlock - 1) / kBlock);
  const dim3 block(kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any_hit) {
    traverse_kernel<true><<<grid, block, 0, s>>>(
        static_cast<const int*>(nodes), n_nodes,
        static_cast<const float4*>(tris), n_tri_rows,
        static_cast<const float4*>(insts), n_inst,
        static_cast<const int*>(roots), tlas_root,
        static_cast<const float*>(ray_o), static_cast<const float*>(ray_d),
        static_cast<const float*>(t_limit), n_rays,
        nullptr, nullptr, nullptr, nullptr, nullptr,
        static_cast<bool*>(out_occluded));
  } else {
    traverse_kernel<false><<<grid, block, 0, s>>>(
        static_cast<const int*>(nodes), n_nodes,
        static_cast<const float4*>(tris), n_tri_rows,
        static_cast<const float4*>(insts), n_inst,
        static_cast<const int*>(roots), tlas_root,
        static_cast<const float*>(ray_o), static_cast<const float*>(ray_d),
        static_cast<const float*>(t_limit), n_rays,
        static_cast<float*>(out_t), static_cast<int*>(out_prim),
        static_cast<int*>(out_inst), static_cast<float*>(out_u),
        static_cast<float*>(out_v), nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}
