// Two-level BVH traversal for NVIDIA Hopper (sm_90a): closest hit (K1) and
// any hit (K2).
//
// Replaces the TPU kernel rfw_tpu/ops/traverse.py::_traverse_kernel_factory
// (:335) in both of its forms: any_hit=False (closest hit: t, prim, inst,
// u, v) and any_hit=True (occlusion). It reads the same scene encoding and
// rounds every slab, Woop and re-base operation as the plain torch walk does
// (bvh_common.cuh: slab, leaf_test, rebase). The walk is bvh_common.cuh's
// walk_rays, entered at the TLAS root; the items kernels (K3/K5) enter the
// same walk at an instance's BLAS root.
//
// What bounds it on an H100: neither arithmetic nor bytes (the bound is a
// few percent of its time) but the latency of each ray's chain of dependent
// node and treelet fetches, ~240 cycles a step even on cached data (U1),
// with warps that wait for their longest ray. The scene arrays (8.1 MB at
// the flagship scale) stay in L2. What the design does about it
// (bvh_common.cuh):
//   * persistent warps with dynamic ray fetch: a full card of resident
//     blocks; a warp takes the next rays of a global counter (one int32 the
//     caller zeroes) for its idle lanes once kRefill of them are idle;
//   * while-while: a lane at a leaf waits while another lane of its warp
//     holds an internal node;
//   * nearest first with pop-time culling. For K1, t is the minimum over
//     the same triangles, so only an exact-t tie can change prim/inst/u/v,
//     and only a box dropped at the rounding edge can change t; K2's flag
//     does not depend on the order;
//   * leaf_test issues the next slot's three loads before the current
//     slot's test (the slot order, so the winner, unchanged);
//   * the ray's TLAS-space reciprocals kept, so a return to the TLAS
//     re-bases with no loads and no divisions (bit for bit the identity
//     row's set_obj: the same operations on the same constants);
//   * child boxes loaded as float4 pairs; the stack in local memory; block
//     size and register cap chosen by measurement (PERF.md).
//
// The scene's supernode arity A (8, 16 or 32, from the pack's
// RFW_WIDE_ARITY) is a template parameter: one instance per arity, picked
// by the prepared scene's. A wider node shortens the chain of dependent node
// fetches at more box tests a visit.
//
// The counting instance (kStats) also writes per ray the internal-node
// visits, child box tests, leaf visits and slot tests (a visited leaf's
// count, as the plain walk counts), each warp's first and last
// %globaltimer, and the count of pushes that found the stack full; the
// default launch does not compile it in.

#include "bvh_common.cuh"

namespace {

using namespace rfw;

template <bool kAnyHit, bool kStats, int A>
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
  walk_rays<kAnyHit, kStats, A>(TlasEntry{tlas_root}, nodes, n_nodes, tris, n_tri_rows, insts,
                                n_inst, roots, ray_o, ray_d, t_limit, n_rays, out_t, out_prim,
                                out_inst, out_u, out_v, out_occluded, next_ray, out_stats,
                                warp_ns);
}

template <bool kAnyHit, bool kStats, int A>
int launch(const void* nodes, int n_nodes, const void* tris, int n_tri_rows,
           const void* insts, int n_inst, const void* roots, int tlas_root,
           const void* ray_o, const void* ray_d, const void* t_limit, int n_rays,
           void* out_t, void* out_prim, void* out_inst, void* out_u, void* out_v,
           void* out_occluded, void* next_ray, void* out_stats, void* warp_ns,
           cudaStream_t s) {
  return launch_persistent<traverse_kernel<kAnyHit, kStats, A>>(
      n_rays, s, static_cast<const int*>(nodes), n_nodes,
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
}

}  // namespace

// Plain C entry points (loaded with ctypes). rfw_traverse launches the
// instance for the scene's supernode `arity` (8, 16 or 32) on `stream` and
// returns cudaGetLastError() of the launch (0 = success;
// cudaErrorInvalidValue for another arity). It allocates nothing and does
// not synchronize; `next_ray` is two int32 that the caller zeroes, the
// warps' shared ray counter and the counting instance's count of pushes
// that found the stack full. With `out_stats` (int4 per ray: internal-node
// visits, child box tests, leaf visits, slot tests) it launches the
// counting instance, which also writes each warp's first and last
// %globaltimer to `warp_ns` (2 int64 per launched warp).
extern "C" int rfw_traverse(
    int any_hit, int arity,
    const void* nodes, int n_nodes,
    const void* tris, int n_tri_rows,
    const void* insts, int n_inst,
    const void* roots, int tlas_root,
    const void* ray_o, const void* ray_d, const void* t_limit, int n_rays,
    void* out_t, void* out_prim, void* out_inst, void* out_u, void* out_v,
    void* out_occluded, void* next_ray, void* out_stats, void* warp_ns, void* stream) {
  if (n_rays <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_arity(arity, [&](auto a) {
    constexpr int A = decltype(a)::value;
#define RFW_LAUNCH(H, S)                                                                    \
  launch<H, S, A>(nodes, n_nodes, tris, n_tri_rows, insts, n_inst, roots, tlas_root, ray_o, \
                  ray_d, t_limit, n_rays, out_t, out_prim, out_inst, out_u, out_v,          \
                  out_occluded, next_ray, out_stats, warp_ns, s)
    if (out_stats != nullptr) return any_hit ? RFW_LAUNCH(true, true) : RFW_LAUNCH(false, true);
    return any_hit ? RFW_LAUNCH(true, false) : RFW_LAUNCH(false, false);
#undef RFW_LAUNCH
  });
}

// The launch shape of one kernel instance (any hit, counting, arity) for
// n_rays, into out[8]: block threads, resident blocks per SM, SMs,
// registers per thread, local and static shared bytes per thread / block,
// threads per SM, blocks launched.
extern "C" int rfw_traverse_info(int any_hit, int stats, int arity, int n_rays, void* out) {
  int* o = static_cast<int*>(out);
  return by_arity(arity, [&](auto a) {
    constexpr int A = decltype(a)::value;
    if (stats) {
      return any_hit ? info<traverse_kernel<true, true, A>>(n_rays, o)
                     : info<traverse_kernel<false, true, A>>(n_rays, o);
    }
    return any_hit ? info<traverse_kernel<true, false, A>>(n_rays, o)
                   : info<traverse_kernel<false, false, A>>(n_rays, o);
  });
}
