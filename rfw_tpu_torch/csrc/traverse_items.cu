// Two-phase traversal, phase B, for NVIDIA Hopper (sm_90a): per-item
// single-BLAS walks (closest hit and any hit) and the dense items tier.
//
// An item is one (ray, instance) pair from phase A: a world ray, its
// t_limit (-inf marks an empty slot) and the instance whose BLAS it walks.
//
// items_kernel<kAnyHit> replaces the TPU kernel
// rfw_tpu/ops/traverse_items.py::_items_kernel_factory (any_hit=False is
// K3, any_hit=True is K5). One thread per item re-bases the ray into the
// instance's object space and walks that instance's BLAS from its root —
// the same walk as the classic kernel (bvh_common.cuh::walk) entered below
// the TLAS, so an item rounds exactly like the classic kernel and the plain
// torch walk. The TPU kernel aligns same-instance items into STILE-sized
// runs so that one 128-lane stream walks one BLAS; a GPU thread carries its
// own instance, so the port keeps only the instance sort of phase A's glue
// (a warp then mostly walks one BLAS) and no alignment padding.
//
// dense_items_kernel<kAnyHit> replaces _dense_kernel_factory (K6): one
// thread per item tests every treelet of its instance mesh's range
// [tlo, thi) with the same leaf arithmetic, with no node walk and no stack.
// A later treelet must be strictly nearer, as in the walk.
//
// Both write every output row, empty slots included (t = min(t_limit,
// T_MAX), prim = inst = -1, u = v = 0; occluded = false).
//
// What bounds them on an H100: the latency of dependent node and treelet
// fetches (K3/K5) and of the treelet loads of the mesh range (K6), not
// bandwidth: the scene sits in the 50 MB L2 after warm-up and each item
// moves 52 bytes to and from device memory. Items sorted by instance keep
// a warp's fetches on one BLAS, which is what the design does about it;
// K6 trades the walk's dependent fetches for a fixed, independent run of
// treelet loads. Left for later: a warp-cooperative leaf test, persistent
// threads over the item list.

#include "bvh_common.cuh"

namespace {

using namespace rfw;

__device__ __forceinline__ void write_empty(int i, float t_limit, float* out_t,
                                            int* out_prim, int* out_inst,
                                            float* out_u, float* out_v,
                                            bool* out_occluded, bool any_hit) {
  if (any_hit) {
    out_occluded[i] = false;
  } else {
    out_t[i] = fminf(t_limit, kTMax);
    out_prim[i] = -1;
    out_inst[i] = -1;
    out_u[i] = 0.0f;
    out_v[i] = 0.0f;
  }
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock) items_kernel(
    const int* __restrict__ nodes, int n_nodes,
    const float4* __restrict__ tris, int n_tri_rows,
    const float4* __restrict__ insts, int n_inst,
    const int* __restrict__ roots, const int* __restrict__ item_inst,
    const float* __restrict__ ray_o, const float* __restrict__ ray_d,
    const float* __restrict__ t_limit, int n_items,
    float* __restrict__ out_t, int* __restrict__ out_prim,
    int* __restrict__ out_inst, float* __restrict__ out_u,
    float* __restrict__ out_v, bool* __restrict__ out_occluded) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_items) return;
  const int inst = item_inst[i];
  if (inst < 0) {
    write_empty(i, t_limit[i], out_t, out_prim, out_inst, out_u, out_v,
                out_occluded, kAnyHit);
    return;
  }
  const int root = __ldg(roots + min(inst, max(n_inst - 1, 0)));
  const Hit h = walk<kAnyHit>(nodes, n_nodes, tris, n_tri_rows, insts, n_inst, roots,
                              root, inst, ray_o[3 * i + 0], ray_o[3 * i + 1],
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

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock) dense_items_kernel(
    const float4* __restrict__ tris, int n_tri_rows,
    const float4* __restrict__ insts, int n_inst,
    const int* __restrict__ tlo, const int* __restrict__ thi,
    const int* __restrict__ item_inst,
    const float* __restrict__ ray_o, const float* __restrict__ ray_d,
    const float* __restrict__ t_limit, int n_items,
    float* __restrict__ out_t, int* __restrict__ out_prim,
    int* __restrict__ out_inst, float* __restrict__ out_u,
    float* __restrict__ out_v, bool* __restrict__ out_occluded) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_items) return;
  const int inst = item_inst[i];
  if (inst < 0) {
    write_empty(i, t_limit[i], out_t, out_prim, out_inst, out_u, out_v,
                out_occluded, kAnyHit);
    return;
  }
  const int row = inst >= n_inst ? n_inst : inst;
  const Ray r = set_obj(insts, row, ray_o[3 * i + 0], ray_o[3 * i + 1], ray_o[3 * i + 2],
                        ray_d[3 * i + 0], ray_d[3 * i + 1], ray_d[3 * i + 2]);
  const int iid = min(inst, max(n_inst - 1, 0));
  const int lo = __ldg(tlo + iid), hi = __ldg(thi + iid);
  float best = fminf(t_limit[i], kTMax);
  int prim = -1;
  float hu = 0.0f, hv = 0.0f;
  for (int tt = lo; tt < hi; ++tt) {
    const int first = tt << kTShift;
    if (first + kTreelet > n_tri_rows) break;
    float bu = 0.0f, bv = 0.0f;
    int win = -1;
    if (leaf_test<kAnyHit>(tris, first, kTreelet, r, best, bu, bv, win)) {
      out_occluded[i] = true;
      return;
    }
    if (!kAnyHit && win >= 0) {
      prim = first + win;
      hu = bu;
      hv = bv;
    }
  }
  if (kAnyHit) {
    out_occluded[i] = false;
  } else {
    out_t[i] = best;
    out_prim[i] = prim;
    out_inst[i] = prim >= 0 ? inst : -1;
    out_u[i] = hu;
    out_v[i] = hv;
  }
}

template <bool kAnyHit>
void launch_items(const void* nodes, int n_nodes, const void* tris, int n_tri_rows,
                  const void* insts, int n_inst, const void* roots,
                  const void* item_inst, const void* ray_o, const void* ray_d,
                  const void* t_limit, int n_items, void* out_t, void* out_prim,
                  void* out_inst, void* out_u, void* out_v, void* out_occluded,
                  cudaStream_t s) {
  const dim3 grid((n_items + kBlock - 1) / kBlock);
  items_kernel<kAnyHit><<<grid, kBlock, 0, s>>>(
      static_cast<const int*>(nodes), n_nodes,
      static_cast<const float4*>(tris), n_tri_rows,
      static_cast<const float4*>(insts), n_inst,
      static_cast<const int*>(roots), static_cast<const int*>(item_inst),
      static_cast<const float*>(ray_o), static_cast<const float*>(ray_d),
      static_cast<const float*>(t_limit), n_items,
      static_cast<float*>(out_t), static_cast<int*>(out_prim),
      static_cast<int*>(out_inst), static_cast<float*>(out_u),
      static_cast<float*>(out_v), static_cast<bool*>(out_occluded));
}

template <bool kAnyHit>
void launch_dense(const void* tris, int n_tri_rows, const void* insts, int n_inst,
                  const void* tlo, const void* thi, const void* item_inst,
                  const void* ray_o, const void* ray_d, const void* t_limit,
                  int n_items, void* out_t, void* out_prim, void* out_inst,
                  void* out_u, void* out_v, void* out_occluded, cudaStream_t s) {
  const dim3 grid((n_items + kBlock - 1) / kBlock);
  dense_items_kernel<kAnyHit><<<grid, kBlock, 0, s>>>(
      static_cast<const float4*>(tris), n_tri_rows,
      static_cast<const float4*>(insts), n_inst,
      static_cast<const int*>(tlo), static_cast<const int*>(thi),
      static_cast<const int*>(item_inst),
      static_cast<const float*>(ray_o), static_cast<const float*>(ray_d),
      static_cast<const float*>(t_limit), n_items,
      static_cast<float*>(out_t), static_cast<int*>(out_prim),
      static_cast<int*>(out_inst), static_cast<float*>(out_u),
      static_cast<float*>(out_v), static_cast<bool*>(out_occluded));
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on `stream` and
// returns cudaGetLastError() of the launch (0 = success). They allocate
// nothing and do not synchronize.
extern "C" int rfw_items(
    int any_hit,
    const void* nodes, int n_nodes,
    const void* tris, int n_tri_rows,
    const void* insts, int n_inst,
    const void* roots, const void* item_inst,
    const void* ray_o, const void* ray_d, const void* t_limit, int n_items,
    void* out_t, void* out_prim, void* out_inst, void* out_u, void* out_v,
    void* out_occluded, void* stream) {
  if (n_items <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any_hit) {
    launch_items<true>(nodes, n_nodes, tris, n_tri_rows, insts, n_inst, roots, item_inst,
                       ray_o, ray_d, t_limit, n_items, out_t, out_prim, out_inst, out_u,
                       out_v, out_occluded, s);
  } else {
    launch_items<false>(nodes, n_nodes, tris, n_tri_rows, insts, n_inst, roots, item_inst,
                        ray_o, ray_d, t_limit, n_items, out_t, out_prim, out_inst, out_u,
                        out_v, out_occluded, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rfw_dense_items(
    int any_hit,
    const void* tris, int n_tri_rows,
    const void* insts, int n_inst,
    const void* tlo, const void* thi, const void* item_inst,
    const void* ray_o, const void* ray_d, const void* t_limit, int n_items,
    void* out_t, void* out_prim, void* out_inst, void* out_u, void* out_v,
    void* out_occluded, void* stream) {
  if (n_items <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any_hit) {
    launch_dense<true>(tris, n_tri_rows, insts, n_inst, tlo, thi, item_inst, ray_o, ray_d,
                       t_limit, n_items, out_t, out_prim, out_inst, out_u, out_v,
                       out_occluded, s);
  } else {
    launch_dense<false>(tris, n_tri_rows, insts, n_inst, tlo, thi, item_inst, ray_o, ray_d,
                        t_limit, n_items, out_t, out_prim, out_inst, out_u, out_v,
                        out_occluded, s);
  }
  return static_cast<int>(cudaGetLastError());
}
