// Microbenchmark U2 for NVIDIA Hopper (sm_90a): the fixed cost of K1's call
// shape with the walk stripped out.
//
// Replaces the TPU kernel of tools/ubench_grid.py (the in-file kernel of
// its pallas_call, `make_kernel`). It takes K1's operands (rfw_traverse in
// traverse.cu: the prepared scene arrays, the rays, their t_limit) and
// writes K1's five closest-hit outputs, one thread per ray in blocks of
// K1's width, with the walk replaced by:
//   trivial    t = min(t_limit, 1e30) (NaN stays), prim = inst = -1,
//              u = v = 0; reads t_limit alone
//   init       trivial, plus K1's prologue: the ray read and re-based
//              through the identity instance row n_inst by K1's own set_obj
//              (bvh_common.cuh)
//   whiletriv  init, then t *= 0.9999 (n_inst % 7 + 4) times
//   fetch8     init, then 8 dependent node-row fetches from row 0:
//              idx += 1 + (child code 0 of row idx % n_nodes) % 2 (floor
//              modulo)
// The TPU kernel discards the re-based ray and the fetch chain. Here they
// decide prim, so nvcc keeps them, by a rule that never fires on a finite
// ray or a valid scene: prim = -2 where the nine floats of the re-based
// ray sum to NaN, or where the last child code fetched is INT_MIN. The
// plain version (tools/ubench_grid.py::grid_plain) applies the same rule.
//
// What bounds it: bytes. trivial moves 24 B a ray (t_limit in, five
// outputs out), the others 48 B (the rays too); no variant touches the
// scene beyond one instance row and eight node rows, which every thread
// of a warp reads alike.

#include <climits>

#include "bvh_common.cuh"

namespace {

using namespace rfw;

constexpr int kTrivial = 0, kInit = 1, kWhileTriv = 2, kFetch8 = 3;

template <int kVariant>
__global__ void __launch_bounds__(kBlock) grid_kernel(
    const int* __restrict__ nodes, int n_nodes, const float4* __restrict__ insts, int n_inst,
    const float* __restrict__ ray_o, const float* __restrict__ ray_d,
    const float* __restrict__ t_limit, int n_rays, float* __restrict__ out_t,
    int* __restrict__ out_prim, int* __restrict__ out_inst, float* __restrict__ out_u,
    float* __restrict__ out_v) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const float tl = t_limit[i];
  float t = tl != tl ? tl : fminf(tl, 1e30f);
  int prim = -1;
  if (kVariant != kTrivial) {
    const Ray r = set_obj(insts, n_inst, ray_o[3 * i + 0], ray_o[3 * i + 1], ray_o[3 * i + 2],
                          ray_d[3 * i + 0], ray_d[3 * i + 1], ray_d[3 * i + 2]);
    float acc = __fadd_rn(__fadd_rn(__fadd_rn(r.ox, r.oy), r.oz), r.dx);
    acc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, r.dy), r.dz), r.ix), r.iy);
    acc = __fadd_rn(acc, r.iz);
    bool odd = acc != acc;
    if (kVariant == kWhileTriv) {
      const int n = floor_mod(n_inst, 7) + 4;
      for (int c = 0; c < n; ++c) t = __fmul_rn(t, 0.9999f);
    }
    if (kVariant == kFetch8) {
      int idx = 0, code = 0;
      for (int k = 0; k < 8; ++k) {
        code = __ldg(nodes + static_cast<size_t>(floor_mod(idx, n_nodes)) * kNodeInts +
                     6 * kArity);
        idx += 1 + floor_mod(code, 2);
      }
      odd = odd || code == INT_MIN;
    }
    if (odd) prim = -2;
  }
  out_t[i] = t;
  out_prim[i] = prim;
  out_inst[i] = -1;
  out_u[i] = 0.0f;
  out_v[i] = 0.0f;
}

}  // namespace

// Plain C entry point (loaded with ctypes), with rfw_traverse's arguments:
// `variant` in place of any_hit, no occlusion output (roots, tlas_root and
// the triangle arena are taken and not read, as the TPU kernel takes its
// scene refs). Launches on `stream` and returns cudaGetLastError() of the
// launch (0 = success). It allocates nothing and does not synchronize.
extern "C" int rfw_ubench_grid(
    int variant,
    const void* nodes, int n_nodes,
    const void* tris, int n_tri_rows,
    const void* insts, int n_inst,
    const void* roots, int tlas_root,
    const void* ray_o, const void* ray_d, const void* t_limit, int n_rays,
    void* out_t, void* out_prim, void* out_inst, void* out_u, void* out_v,
    void* stream) {
  (void)tris, (void)n_tri_rows, (void)roots, (void)tlas_root;
  if (n_nodes <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays <= 0) return 0;
  const dim3 grid((n_rays + kBlock - 1) / kBlock), block(kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* nd = static_cast<const int*>(nodes);
  const float4* in = static_cast<const float4*>(insts);
  const float* o = static_cast<const float*>(ray_o);
  const float* d = static_cast<const float*>(ray_d);
  const float* tl = static_cast<const float*>(t_limit);
  float* t = static_cast<float*>(out_t);
  int* prim = static_cast<int*>(out_prim);
  int* inst = static_cast<int*>(out_inst);
  float* u = static_cast<float*>(out_u);
  float* v = static_cast<float*>(out_v);
  switch (variant) {
    case kTrivial:
      grid_kernel<kTrivial><<<grid, block, 0, s>>>(nd, n_nodes, in, n_inst, o, d, tl, n_rays,
                                                   t, prim, inst, u, v);
      break;
    case kInit:
      grid_kernel<kInit><<<grid, block, 0, s>>>(nd, n_nodes, in, n_inst, o, d, tl, n_rays, t,
                                                prim, inst, u, v);
      break;
    case kWhileTriv:
      grid_kernel<kWhileTriv><<<grid, block, 0, s>>>(nd, n_nodes, in, n_inst, o, d, tl,
                                                     n_rays, t, prim, inst, u, v);
      break;
    case kFetch8:
      grid_kernel<kFetch8><<<grid, block, 0, s>>>(nd, n_nodes, in, n_inst, o, d, tl, n_rays,
                                                  t, prim, inst, u, v);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
