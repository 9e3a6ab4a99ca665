// Two-level BVH traversal for NVIDIA Hopper (sm_90a): closest hit and any hit.
//
// Replaces the TPU kernel rfw_tpu/ops/traverse.py::_traverse_kernel_factory
// in both of its forms: any_hit=False (closest hit: t, prim, inst, u, v) and
// any_hit=True (occlusion). It computes what that kernel computes over the
// same scene encoding; the encoding, the leaf test and the walk live in
// bvh_common.cuh, shared with the two-phase items kernel.
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
//
// What bounds it on an H100: latency of the dependent node and treelet
// fetches under warp divergence, not arithmetic or bandwidth. The scene
// arrays of the smoke scene (~26 MB) fit in the 50 MB L2, so the fetches
// are L2 hits after warm-up; the design keeps each node visit to 4 vector
// loads of codes/counts plus 3 per child box, and each triangle to 3
// float4 loads. Left for later: warp-coherent or persistent traversal,
// stacks in shared memory, compressed (quantized) nodes, nearest-first
// child order.

#include "bvh_common.cuh"

namespace {

using namespace rfw;

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
  const Hit h = walk<kAnyHit>(nodes, n_nodes, tris, n_tri_rows, insts, n_inst, roots,
                              tlas_root, -1, ray_o[3 * i + 0], ray_o[3 * i + 1],
                              ray_o[3 * i + 2], ray_d[3 * i + 0], ray_d[3 * i + 1],
                              ray_d[3 * i + 2], t_limit[i]);
  if (kAnyHit) {
    out_occluded[i] = h.occluded;
  } else {
    out_t[i] = h.t;
    out_prim[i] = h.prim;
    out_inst[i] = h.inst;
    out_u[i] = h.u;
    out_v[i] = h.v;
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
