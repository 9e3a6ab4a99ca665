// Two-phase traversal, phase B, for NVIDIA Hopper (sm_90a): per-item
// single-BLAS walks (closest hit and any hit) and the dense items tier.
//
// An item is one (ray, instance) pair from phase A: a world ray, its
// t_limit (-inf marks an empty slot) and the instance whose BLAS it walks.
//
// items_kernel<kAnyHit, kStats> replaces the TPU kernel
// rfw_tpu/ops/traverse_items.py::_items_kernel_factory (any_hit=False is
// K3, any_hit=True is K5). It is K1/K2's walk (bvh_common.cuh::walk_rays)
// entered below the TLAS: a lane takes item i, starts at the BLAS root of
// the item's instance, and its first visit re-bases the ray through that
// instance's row, so an item rounds like K1 and the plain torch walk. The
// TPU kernel aligns same-instance items into STILE-sized runs so that one
// 128-lane stream walks one BLAS; a GPU lane carries its own instance, so
// the port keeps only the instance sort of phase A's glue (items are
// fetched in slot order, so a warp mostly walks one BLAS) and no alignment
// padding.
//
// What bounds K3/K5 on an H100: as K1, the latency of each item's chain of
// dependent node and treelet fetches (the bound by bytes and operations is
// a few percent of its time; the scene sits in the 50 MB L2), and warps
// that wait for their longest item. What the design does about it is K1's:
// persistent warps that fetch items from a zeroed counter once kRefill
// lanes are idle, while-while, nearest-first children with pop-time
// culling, the next slot's loads ahead, the stack in local memory (without
// instances: an item never leaves its BLAS). An empty slot is written when
// it is fetched and leaves its lane idle. The counting instance (kStats)
// writes K1's per-item counts and warp spans.
//
// dense_items_kernel<kAnyHit, kStats> replaces _dense_kernel_factory (K6):
// one thread per item slot takes the treelets of its instance mesh's range
// [tlo, thi) in order, with no node walk and no stack. The TPU kernel
// streams every treelet whole, because its vector unit wants a fixed run;
// here the treelets' boxes (prepare_scene's tbox) are read in one
// independent run and slab-tested with the walk's rule (tn <= tf, tf >
// T_MIN, tn < best), and a surviving treelet's leaf test runs over its real
// slots only (tcount; the slots past it are all-zero Woop rows, which never
// pass). best is re-checked just before each treelet, and a later treelet
// must be strictly nearer, as in the walk and in dense_items_plain, which
// tests every slot of every treelet in the same order: the culled treelets
// and padding slots hold no hit below best, so the two agree bit for bit
// (unless a box is dropped at the rounding edge, as in the walk). The any
// hit form culls against t_limit and stops at the first hit.
//
// What bounds K6 on an H100: instruction issue for its slot tests, whose
// products and sums round alone (bvh_common.cuh: no multiply-add forms, one
// fp32 instruction each); its loads are warp-broadcast L1 hits (items are
// sorted by instance, so a warp mostly tests one mesh). The design cuts slot
// tests (real slots only, culled treelets skipped: 24% of the plain
// version's on the heavy scene, PERF.md), but a lane whose cull fails waits
// while the others of its warp test the treelet, so a warp still pays for
// the union of its lanes' treelets. Measured and dropped (PERF.md): a
// warp-wide ballot that makes every lane test the union, K6's own slot loop
// without the shared prefetch (fewer registers), and 4 or 8 lanes sharing
// an item's slots. On meshes of at most 8 treelets the BLAS is one
// supernode whose children are the treelets, so K3's walk makes the same
// box tests, nearest first, with persistent warps: K6 does not beat it
// there. The counting instance (kStats) writes per item 0 node visits, the
// box tests, the leaf tests and the slot tests, and each warp's first and
// last %globaltimer.
//
// Both write every output row, empty slots included (t = min(t_limit,
// T_MAX), prim = inst = -1, u = v = 0; occluded = false).

#include "bvh_common.cuh"

namespace {

using namespace rfw;

template <bool kAnyHit, bool kStats>
__global__ void __launch_bounds__(kWalkBlock, kMinBlocks) items_kernel(
    const int* __restrict__ nodes, int n_nodes,
    const float4* __restrict__ tris, int n_tri_rows,
    const float4* __restrict__ insts, int n_inst,
    const int* __restrict__ roots, const int* __restrict__ item_inst,
    const float* __restrict__ ray_o, const float* __restrict__ ray_d,
    const float* __restrict__ t_limit, int n_items,
    float* __restrict__ out_t, int* __restrict__ out_prim,
    int* __restrict__ out_inst, float* __restrict__ out_u,
    float* __restrict__ out_v, bool* __restrict__ out_occluded,
    int* __restrict__ next_item, int4* __restrict__ out_stats,
    long long* __restrict__ warp_ns) {
  walk_rays<kAnyHit, kStats>(ItemEntry{item_inst, roots, n_inst}, nodes, n_nodes, tris,
                             n_tri_rows, insts, n_inst, roots, ray_o, ray_d, t_limit, n_items,
                             out_t, out_prim, out_inst, out_u, out_v, out_occluded, next_item,
                             out_stats, warp_ns);
}

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

// K6 for item slot i (an empty slot, instance < 0, writes the empty result).
template <bool kAnyHit, bool kStats>
__device__ __forceinline__ void dense_item(
    int i, const float4* __restrict__ tris, int n_tri_rows, const float4* __restrict__ insts,
    int n_inst, const int* __restrict__ tlo, const int* __restrict__ thi,
    const float4* __restrict__ tbox, const int* __restrict__ tcount,
    const int* __restrict__ item_inst, const float* __restrict__ ray_o,
    const float* __restrict__ ray_d, const float* __restrict__ t_limit,
    float* __restrict__ out_t, int* __restrict__ out_prim, int* __restrict__ out_inst,
    float* __restrict__ out_u, float* __restrict__ out_v, bool* __restrict__ out_occluded,
    int4* __restrict__ out_stats) {
  const int inst = item_inst[i];
  if (inst < 0) {
    write_empty(i, t_limit[i], out_t, out_prim, out_inst, out_u, out_v, out_occluded,
                kAnyHit);
    if (kStats) out_stats[i] = make_int4(0, 0, 0, 0);
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
  int boxes = 0, leaves = 0, slots = 0;
  for (int tt = lo; tt < hi; ++tt) {
    const int first = tt << kTShift;
    if (first + kTreelet > n_tri_rows) break;
    const int count = __ldg(tcount + tt);
    if (count == 0) continue;  // no leaf names it: 64 all-zero rows
    const float4 b0 = __ldg(tbox + 2 * tt), b1 = __ldg(tbox + 2 * tt + 1);
    if (kStats) ++boxes;
    float tn;
    if (!slab(b0.x, b0.y, b0.z, b1.x, b1.y, b1.z, r, &tn) || !(tn < best)) continue;
    if (kStats) {
      ++leaves;
      slots += count;
    }
    float bu = 0.0f, bv = 0.0f;
    int win = -1;
    if (leaf_test<kAnyHit>(tris, first, count, r, best, bu, bv, win)) {
      out_occluded[i] = true;
      if (kStats) out_stats[i] = make_int4(0, boxes, leaves, slots);
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
  if (kStats) out_stats[i] = make_int4(0, boxes, leaves, slots);
}

template <bool kAnyHit, bool kStats>
__global__ void __launch_bounds__(kBlock) dense_items_kernel(
    const float4* __restrict__ tris, int n_tri_rows,
    const float4* __restrict__ insts, int n_inst,
    const int* __restrict__ tlo, const int* __restrict__ thi,
    const float4* __restrict__ tbox, const int* __restrict__ tcount,
    const int* __restrict__ item_inst,
    const float* __restrict__ ray_o, const float* __restrict__ ray_d,
    const float* __restrict__ t_limit, int n_items,
    float* __restrict__ out_t, int* __restrict__ out_prim,
    int* __restrict__ out_inst, float* __restrict__ out_u,
    float* __restrict__ out_v, bool* __restrict__ out_occluded,
    int4* __restrict__ out_stats, long long* __restrict__ warp_ns) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const long long t0 = kStats ? global_ns() : 0;
  if (i < n_items) {
    dense_item<kAnyHit, kStats>(i, tris, n_tri_rows, insts, n_inst, tlo, thi, tbox, tcount,
                                item_inst, ray_o, ray_d, t_limit, out_t, out_prim, out_inst,
                                out_u, out_v, out_occluded, out_stats);
  }
  if (kStats) {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) {
      const int gw = i >> 5;
      warp_ns[2 * gw + 0] = t0;
      warp_ns[2 * gw + 1] = global_ns();
    }
  }
}

template <bool kAnyHit, bool kStats>
int launch_items(const void* nodes, int n_nodes, const void* tris, int n_tri_rows,
                 const void* insts, int n_inst, const void* roots, const void* item_inst,
                 const void* ray_o, const void* ray_d, const void* t_limit, int n_items,
                 void* out_t, void* out_prim, void* out_inst, void* out_u, void* out_v,
                 void* out_occluded, void* next_item, void* out_stats, void* warp_ns,
                 cudaStream_t s) {
  return launch_persistent<items_kernel<kAnyHit, kStats>>(
      n_items, s, static_cast<const int*>(nodes), n_nodes,
      static_cast<const float4*>(tris), n_tri_rows,
      static_cast<const float4*>(insts), n_inst,
      static_cast<const int*>(roots), static_cast<const int*>(item_inst),
      static_cast<const float*>(ray_o), static_cast<const float*>(ray_d),
      static_cast<const float*>(t_limit), n_items,
      static_cast<float*>(out_t), static_cast<int*>(out_prim),
      static_cast<int*>(out_inst), static_cast<float*>(out_u),
      static_cast<float*>(out_v), static_cast<bool*>(out_occluded),
      static_cast<int*>(next_item), static_cast<int4*>(out_stats),
      static_cast<long long*>(warp_ns));
}

template <bool kAnyHit, bool kStats>
int launch_dense(const void* tris, int n_tri_rows, const void* insts, int n_inst,
                 const void* tlo, const void* thi, const void* tbox, const void* tcount,
                 const void* item_inst, const void* ray_o, const void* ray_d,
                 const void* t_limit, int n_items, void* out_t, void* out_prim, void* out_inst,
                 void* out_u, void* out_v, void* out_occluded, void* out_stats, void* warp_ns,
                 cudaStream_t s) {
  const dim3 grid((n_items + kBlock - 1) / kBlock);
  dense_items_kernel<kAnyHit, kStats><<<grid, kBlock, 0, s>>>(
      static_cast<const float4*>(tris), n_tri_rows,
      static_cast<const float4*>(insts), n_inst,
      static_cast<const int*>(tlo), static_cast<const int*>(thi),
      static_cast<const float4*>(tbox), static_cast<const int*>(tcount),
      static_cast<const int*>(item_inst),
      static_cast<const float*>(ray_o), static_cast<const float*>(ray_d),
      static_cast<const float*>(t_limit), n_items,
      static_cast<float*>(out_t), static_cast<int*>(out_prim),
      static_cast<int*>(out_inst), static_cast<float*>(out_u),
      static_cast<float*>(out_v), static_cast<bool*>(out_occluded),
      static_cast<int4*>(out_stats), static_cast<long long*>(warp_ns));
  return static_cast<int>(cudaGetLastError());
}

// The launch shape of a dense items kernel instance for n_items, as info<>
// gives it, with the grid of its one thread per item slot.
template <auto kKernel>
int dense_info(int n_items, int* out) {
  static_assert(kBlock == kWalkBlock, "info<> sizes residency for kWalkBlock threads");
  const int rc = info<kKernel>(n_items, out);
  out[7] = (n_items + kBlock - 1) / kBlock;
  return rc;
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on `stream` and
// returns cudaGetLastError() of the launch (0 = success). They allocate
// nothing and do not synchronize. rfw_items' `next_item` is one int32 that
// the caller zeroes, the warps' shared item counter; with `out_stats` (int4
// per item: internal-node visits, child box tests, leaf visits, slot tests;
// zero for an empty slot) it launches the counting instance, which also
// writes each warp's first and last %globaltimer to `warp_ns` (2 int64 per
// launched warp).
extern "C" int rfw_items(
    int any_hit,
    const void* nodes, int n_nodes,
    const void* tris, int n_tri_rows,
    const void* insts, int n_inst,
    const void* roots, const void* item_inst,
    const void* ray_o, const void* ray_d, const void* t_limit, int n_items,
    void* out_t, void* out_prim, void* out_inst, void* out_u, void* out_v,
    void* out_occluded, void* next_item, void* out_stats, void* warp_ns, void* stream) {
  if (n_items <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RFW_LAUNCH(A, S)                                                                    \
  launch_items<A, S>(nodes, n_nodes, tris, n_tri_rows, insts, n_inst, roots, item_inst,     \
                     ray_o, ray_d, t_limit, n_items, out_t, out_prim, out_inst, out_u, out_v, \
                     out_occluded, next_item, out_stats, warp_ns, s)
  if (out_stats != nullptr) return any_hit ? RFW_LAUNCH(true, true) : RFW_LAUNCH(false, true);
  return any_hit ? RFW_LAUNCH(true, false) : RFW_LAUNCH(false, false);
#undef RFW_LAUNCH
}

// The launch shape of one items kernel instance for n_items, into out[8],
// as rfw_traverse_info.
extern "C" int rfw_items_info(int any_hit, int stats, int n_items, void* out) {
  int* o = static_cast<int*>(out);
  if (stats) {
    return any_hit ? info<items_kernel<true, true>>(n_items, o)
                   : info<items_kernel<false, true>>(n_items, o);
  }
  return any_hit ? info<items_kernel<true, false>>(n_items, o)
                 : info<items_kernel<false, false>>(n_items, o);
}

// rfw_dense_items: K6 as rfw_items, with the per-treelet tables tbox
// (float4 pairs) and tcount; one thread per item slot, no counter. With
// `out_stats` (int4 per item: 0, box tests, leaf tests, slot tests; zero for
// an empty slot) it launches the counting instance, which also writes each
// warp's first and last %globaltimer to `warp_ns` (2 int64 per warp of the
// grid).
extern "C" int rfw_dense_items(
    int any_hit,
    const void* tris, int n_tri_rows,
    const void* insts, int n_inst,
    const void* tlo, const void* thi, const void* tbox, const void* tcount,
    const void* item_inst,
    const void* ray_o, const void* ray_d, const void* t_limit, int n_items,
    void* out_t, void* out_prim, void* out_inst, void* out_u, void* out_v,
    void* out_occluded, void* out_stats, void* warp_ns, void* stream) {
  if (n_items <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RFW_LAUNCH(A, S)                                                                    \
  launch_dense<A, S>(tris, n_tri_rows, insts, n_inst, tlo, thi, tbox, tcount, item_inst,    \
                     ray_o, ray_d, t_limit, n_items, out_t, out_prim, out_inst, out_u, out_v, \
                     out_occluded, out_stats, warp_ns, s)
  if (out_stats != nullptr) return any_hit ? RFW_LAUNCH(true, true) : RFW_LAUNCH(false, true);
  return any_hit ? RFW_LAUNCH(true, false) : RFW_LAUNCH(false, false);
#undef RFW_LAUNCH
}

// The launch shape of one dense items kernel instance for n_items, into
// out[8], as rfw_traverse_info (the grid: one thread per item slot).
extern "C" int rfw_dense_items_info(int any_hit, int stats, int n_items, void* out) {
  int* o = static_cast<int*>(out);
  if (stats) {
    return any_hit ? dense_info<dense_items_kernel<true, true>>(n_items, o)
                   : dense_info<dense_items_kernel<false, true>>(n_items, o);
  }
  return any_hit ? dense_info<dense_items_kernel<true, false>>(n_items, o)
                 : dense_info<dense_items_kernel<false, false>>(n_items, o);
}
