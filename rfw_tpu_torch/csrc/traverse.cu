// Two-level BVH traversal for NVIDIA Hopper (sm_90a): closest hit (K1) and
// any hit (K2).
//
// Replaces the TPU kernel rfw_tpu/ops/traverse.py::_traverse_kernel_factory
// (:335) in both of its forms: any_hit=False (closest hit: t, prim, inst,
// u, v) and any_hit=True (occlusion). It reads the same scene encoding and
// rounds every slab, Woop and re-base operation as the plain torch walk does
// (bvh_common.cuh: slab, leaf_test, rebase); the walk itself is this file's.
// The items kernels (K3/K5) keep bvh_common.cuh's walk.
//
// What bounds it on an H100: neither arithmetic nor bytes (the bound is a
// few percent of its time) but the latency of each ray's chain of dependent
// node and treelet fetches, ~240 cycles a step even on cached data (U1),
// with warps that wait for their longest ray. The scene arrays (8.1 MB at
// the flagship scale) stay in L2. What the design does about it:
//   * persistent warps with dynamic ray fetch (Aila & Laine, HPG 2009): a
//     full card of resident blocks; a warp takes the next rays of a global
//     counter (one int32 the caller zeroes) for its idle lanes once kRefill
//     of them are idle, so no lane idles long behind a warp's longest ray
//     and no SM waits on another's tail;
//   * while-while: a lane at a leaf waits while another lane of its warp
//     holds an internal node, so the leaf tests, the long part of a walk,
//     run with the warp's lanes together;
//   * nearest first: of a node's hit children the nearest is entered, the
//     second nearest pushed last and the rest before it, each entry with its
//     entry t; a popped entry whose box starts at or past the best hit is
//     dropped. The TPU kernels (and the plain walk) take the last child hit
//     next. For K1, t is the minimum over the same triangles, so only an
//     exact-t tie can change prim/inst/u/v, and only a box dropped at the
//     rounding edge (its entry t past a triangle inside it) can change t;
//     K2's flag does not depend on the order;
//   * bvh_common.cuh's leaf_test, shared with K3-K6 and U1, issues the
//     next slot's three loads before the current slot's test (the slot
//     order, so the winner, unchanged);
//   * the ray's TLAS-space reciprocals kept, so a return to the TLAS
//     re-bases with no loads and no divisions (bit for bit the identity
//     row's set_obj: the same operations on the same constants);
//   * child boxes loaded as float4 pairs; the stack in local memory, which
//     L1 caches (a stack whose first entries sat in shared memory measured
//     slower); block size and register cap chosen by measurement (PERF.md,
//     PR 4).
//
// The counting instance (kStats) also writes per ray the internal-node
// visits, child box tests, leaf visits and slot tests (a visited leaf's
// count, as the plain walk counts), and each warp's first and last
// %globaltimer; the default launch does not compile it in.

#include "bvh_common.cuh"

namespace {

using namespace rfw;

constexpr int kWalkBlock = 128;  // threads per block
constexpr int kMinBlocks = 8;    // resident blocks per SM: at most 64 registers
constexpr int kRefill = 16;      // idle lanes at which a warp fetches rays
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNone = 3.0e38f;  // no candidate: above every t (T_MAX is 1e26)

// The per-ray stack of (node, inst, entry t), in local memory (L1-cached).
// Overflow clamps as the plain walk does (the 96th entry is overwritten).
struct Stack {
  int code[kStackDepth];
  int inst[kStackDepth];
  float tn[kStackDepth];
  int sp;

  __device__ __forceinline__ void push(int c, int i, float t) {
    const int k = min(sp, kStackDepth - 1);
    code[k] = c;
    inst[k] = i;
    tn[k] = t;
    sp = min(sp + 1, kStackDepth);
  }

  __device__ __forceinline__ void pop(int& c, int& i, float& t) {
    --sp;
    c = code[sp];
    i = inst[sp];
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

__device__ __forceinline__ void start(Walker& w, Stack& st, int i, int tlas_root,
                                      const float* __restrict__ ray_o,
                                      const float* __restrict__ ray_d,
                                      const float* __restrict__ t_limit) {
  w.wox = ray_o[3 * i + 0];
  w.woy = ray_o[3 * i + 1];
  w.woz = ray_o[3 * i + 2];
  w.wdx = ray_d[3 * i + 0];
  w.wdy = ray_d[3 * i + 1];
  w.wdz = ray_d[3 * i + 2];
  w.wix = safe_inv(dot3(1.0f, 0.0f, 0.0f, w.wdx, w.wdy, w.wdz));
  w.wiy = safe_inv(dot3(0.0f, 1.0f, 0.0f, w.wdx, w.wdy, w.wdz));
  w.wiz = safe_inv(dot3(0.0f, 0.0f, 1.0f, w.wdx, w.wdy, w.wdz));
  w.r = world_ray(w);
  w.t = fminf(t_limit[i], kTMax);
  w.u = 0.0f;
  w.v = 0.0f;
  w.prim = -1;
  w.hinst = -1;
  w.occ = false;
  w.node = tlas_root;
  w.inst = -1;
  w.cached = -1;
  w.it = 0;
  w.nodes = w.boxes = w.leaves = w.tris = 0;
  st.sp = 0;
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
__device__ __forceinline__ bool pop(Walker& w, Stack& st) {
  while (w.node == -1) {
    if (st.sp <= 0) return false;
    float tn;
    st.pop(w.node, w.inst, tn);
    if (!(tn < w.t)) w.node = -1;
  }
  return true;
}

// One visit (the node or leaf the ray holds). False when the ray is done:
// occluded (any hit) or at the iteration cap.
template <bool kAnyHit, bool kStats>
__device__ __forceinline__ bool visit(Walker& w, Stack& st,
                                      const int* __restrict__ nodes, int n_nodes,
                                      const float4* __restrict__ tris, int n_tri_rows,
                                      const float4* __restrict__ insts, int n_inst,
                                      const int* __restrict__ roots) {
  if (w.inst != w.cached) {
    const int row = (w.inst < 0 || w.inst >= n_inst) ? n_inst : w.inst;
    w.r = row == n_inst ? world_ray(w)
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
    // ---- internal supernode: slab-test the children in pairs (three
    // float4 loads a pair); descend into the nearest child hit, push the
    // second nearest last and the others before it, each with its entry t
    if (kStats) ++w.nodes;
    const int* row = nodes + static_cast<size_t>(w.node) * kNodeInts;
    const float4* box = reinterpret_cast<const float4*>(row);
    const bool in_tlas = w.inst < 0;
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
    if (sd_tn != kNone) st.push(sd_code, sd_inst, sd_tn);
    w.node = nx_code;
    w.inst = nx_inst;
  }
  return ++w.it < kMaxIters;
}

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <bool kAnyHit, bool kStats>
__global__ void __launch_bounds__(kWalkBlock, kMinBlocks) traverse_kernel(
    const int* __restrict__ nodes, int n_nodes,
    const float4* __restrict__ tris, int n_tri_rows,
    const float4* __restrict__ insts, int n_inst,
    const int* __restrict__ roots, int tlas_root,
    const float* __restrict__ ray_o, const float* __restrict__ ray_d,
    const float* __restrict__ t_limit, int n_rays,
    float* __restrict__ out_t, int* __restrict__ out_prim,
    int* __restrict__ out_inst, float* __restrict__ out_u,
    float* __restrict__ out_v, bool* __restrict__ out_occluded,
    int* __restrict__ next_ray, int4* __restrict__ out_stats,
    long long* __restrict__ warp_ns) {
  Stack st;
  Walker w;

  // ---- persistent warps: a warp takes the next rays of the shared counter
  // for its idle lanes once kRefill of them are idle
  const int lane = threadIdx.x & 31;
  const long long t0 = kStats ? global_ns() : 0;
  int ray = -1;
  bool pool = true;  // warp-uniform: rays may be left
  for (;;) {
    unsigned idle = __ballot_sync(kFull, ray < 0);
    if (pool && __popc(idle) >= kRefill) {
      int base = 0;
      if (lane == 0) base = atomicAdd(next_ray, __popc(idle));
      base = __shfl_sync(kFull, base, 0);
      if (base + __popc(idle) >= n_rays) pool = false;
      if (ray < 0) {
        const int i = base + __popc(idle & ((1u << lane) - 1u));
        if (i < n_rays) {
          ray = i;
          start(w, st, i, tlas_root, ray_o, ray_d, t_limit);
        }
      }
      idle = __ballot_sync(kFull, ray < 0);
    }
    if (idle == kFull) {
      if (!pool) break;
      continue;
    }
    for (;;) {
      if (ray >= 0 && !pop(w, st)) {
        finish<kAnyHit, kStats>(w, ray, out_t, out_prim, out_inst, out_u, out_v,
                                out_occluded, out_stats);
        ray = -1;
      }
      // while-while: a lane at a leaf waits while another holds a node
      const bool at_leaf = ray >= 0 && w.node <= -2;
      const bool inner = __any_sync(kFull, ray >= 0 && !at_leaf);
      const bool wait = at_leaf && inner;
      if (ray >= 0 && !wait &&
          !visit<kAnyHit, kStats>(w, st, nodes, n_nodes, tris, n_tri_rows, insts,
                                             n_inst, roots)) {
        finish<kAnyHit, kStats>(w, ray, out_t, out_prim, out_inst, out_u, out_v,
                                out_occluded, out_stats);
        ray = -1;
      }
      idle = __ballot_sync(kFull, ray < 0);
      if (idle == kFull || (pool && __popc(idle) >= kRefill)) break;
    }
  }
  if (kStats && lane == 0) {
    const int gw = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    warp_ns[2 * gw + 0] = t0;
    warp_ns[2 * gw + 1] = global_ns();
  }
}

// Per device: SM count and, per kernel instance, resident blocks per SM.
struct Shape {
  int sms, per_sm;
};

template <bool kAnyHit, bool kStats>
cudaError_t shape(Shape* out) {
  static Shape cache[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  Shape& s = cache[dev & 63];
  if (s.sms == 0) {
    e = cudaDeviceGetAttribute(&s.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &s.per_sm, traverse_kernel<kAnyHit, kStats>, kWalkBlock, 0);
    if (e != cudaSuccess) {
      s.sms = 0;
      return e;
    }
  }
  *out = s;
  return cudaSuccess;
}

// Blocks launched for n_rays: a full card of resident blocks (the warps
// persist and fetch rays), fewer where the rays would not fill them.
template <bool kAnyHit, bool kStats>
cudaError_t grid_for(int n_rays, int* grid) {
  const int need = (n_rays + kWalkBlock - 1) / kWalkBlock;
  Shape s;
  const cudaError_t e = shape<kAnyHit, kStats>(&s);
  if (e != cudaSuccess) return e;
  *grid = min(need, max(s.sms * s.per_sm, 1));
  return cudaSuccess;
}

template <bool kAnyHit, bool kStats>
int launch(const void* nodes, int n_nodes, const void* tris, int n_tri_rows,
           const void* insts, int n_inst, const void* roots, int tlas_root,
           const void* ray_o, const void* ray_d, const void* t_limit, int n_rays,
           void* out_t, void* out_prim, void* out_inst, void* out_u, void* out_v,
           void* out_occluded, void* next_ray, void* out_stats, void* warp_ns,
           cudaStream_t s) {
  int grid = 0;
  const cudaError_t e = grid_for<kAnyHit, kStats>(n_rays, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  traverse_kernel<kAnyHit, kStats><<<grid, kWalkBlock, 0, s>>>(
      static_cast<const int*>(nodes), n_nodes,
      static_cast<const float4*>(tris), n_tri_rows,
      static_cast<const float4*>(insts), n_inst,
      static_cast<const int*>(roots), tlas_root,
      static_cast<const float*>(ray_o), static_cast<const float*>(ray_d),
      static_cast<const float*>(t_limit), n_rays,
      static_cast<float*>(out_t), static_cast<int*>(out_prim),
      static_cast<int*>(out_inst), static_cast<float*>(out_u),
      static_cast<float*>(out_v), static_cast<bool*>(out_occluded),
      static_cast<int*>(next_ray), static_cast<int4*>(out_stats),
      static_cast<long long*>(warp_ns));
  return static_cast<int>(cudaGetLastError());
}

template <bool kAnyHit, bool kStats>
int info(int n_rays, int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, traverse_kernel<kAnyHit, kStats>);
  Shape s = {0, 0};
  if (e == cudaSuccess) e = shape<kAnyHit, kStats>(&s);
  int grid = 0;
  if (e == cudaSuccess) e = grid_for<kAnyHit, kStats>(n_rays, &grid);
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

}  // namespace

// Plain C entry points (loaded with ctypes). rfw_traverse launches on
// `stream` and returns cudaGetLastError() of the launch (0 = success). It
// allocates nothing and does not synchronize; `next_ray` is one int32 that
// the caller zeroes, the warps' shared ray counter. With `out_stats`
// (int4 per ray: internal-node visits, child box tests, leaf visits, slot
// tests) it launches the counting instance, which also writes each warp's
// first and last %globaltimer to `warp_ns` (2 int64 per launched warp).
extern "C" int rfw_traverse(
    int any_hit,
    const void* nodes, int n_nodes,
    const void* tris, int n_tri_rows,
    const void* insts, int n_inst,
    const void* roots, int tlas_root,
    const void* ray_o, const void* ray_d, const void* t_limit, int n_rays,
    void* out_t, void* out_prim, void* out_inst, void* out_u, void* out_v,
    void* out_occluded, void* next_ray, void* out_stats, void* warp_ns, void* stream) {
  if (n_rays <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RFW_LAUNCH(A, S)                                                                 \
  launch<A, S>(nodes, n_nodes, tris, n_tri_rows, insts, n_inst, roots, tlas_root, ray_o, \
               ray_d, t_limit, n_rays, out_t, out_prim, out_inst, out_u, out_v,          \
               out_occluded, next_ray, out_stats, warp_ns, s)
  if (out_stats != nullptr) return any_hit ? RFW_LAUNCH(true, true) : RFW_LAUNCH(false, true);
  return any_hit ? RFW_LAUNCH(true, false) : RFW_LAUNCH(false, false);
#undef RFW_LAUNCH
}

// The launch shape of one kernel instance for n_rays, into out[8]: block
// threads, resident blocks per SM, SMs, registers per thread, local and
// static shared bytes per thread / block, threads per SM, blocks launched.
extern "C" int rfw_traverse_info(int any_hit, int stats, int n_rays, void* out) {
  int* o = static_cast<int*>(out);
  if (stats) return any_hit ? info<true, true>(n_rays, o) : info<false, true>(n_rays, o);
  return any_hit ? info<true, false>(n_rays, o) : info<false, false>(n_rays, o);
}
