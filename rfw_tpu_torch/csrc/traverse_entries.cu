// Two-phase traversal, phase A by tree, for NVIDIA Hopper (sm_90a): per
// ray, the K nearest TLAS instance entries.
//
// Replaces the TPU kernel
// rfw_tpu/ops/traverse_entries.py::_entries_kernel_factory (K4). A lane
// walks one world ray over the TLAS supernodes of the merged node array
// (prepare_scene offsets internal TLAS codes by the BLAS supernode count)
// and keeps the K nearest instance slab entries in registers by a strict
// sorted insert (K is a template parameter, at most 8). An instance leaf
// child inserts its clamped entry te = max(tn, 0); a child of either kind
// is culled unless te < min(K-th best, t_limit), so a dead lane (t_limit
// <= 0) emits nothing, as in the TPU kernel. Empty child slots (code < 0,
// count 0) are skipped, and an inverted (padding) box never inserts.
// Outputs: t_entry (R,K) ascending, +inf where there is none; inst (R,K),
// -1 where there is none.
//
// What bounds it on an H100: not bytes (each ray reads 28 B and writes 8K;
// the TLAS, a few hundred KB for 10k instances, stays in L2) and not
// operations, but the latency of each ray's chain of dependent TLAS node
// fetches, and warps that wait for their longest ray. What the design does
// about it (bvh_common.cuh):
//   * persistent warps: a full card of resident blocks; a warp takes rays
//     from a zeroed int32 counter once kRefill lanes are idle (a dead lane
//     is written at fetch and stays idle). There is no leaf to wait at, so
//     while-while does not apply;
//   * nearest first: of a node's internal children hit, the nearest is
//     entered, the second nearest pushed last and the rest before it, each
//     with its te; a popped entry is dropped unless te < min(K-th best,
//     t_limit). The TPU kernel enters the last child hit, so its K-list
//     fills with whatever it meets first and its culling bites late;
//   * child boxes loaded as float4 pairs; a leaf's padding test reads the
//     floats already in registers; the stack of (node, te) in local memory.
//
// Why the result does not depend on the order: boxes nest, and the slab
// arithmetic rounds monotonically, so a child's te is never below its
// parent's, and a node culled at te >= the K-th best holds no entry that
// could enter the list. The list is then the K smallest te of the same
// instance entries: t_entry is bit-identical to the plain walk's, and only
// the instance ids of entries with equal te can change places, or change
// which of them is kept at the K-th slot.
//
// The counting instance (kStats) also writes per ray the internal-node
// visits and child box tests (int4: nodes, boxes, 0, 0) and each warp's
// first and last %globaltimer.

#include "bvh_common.cuh"

namespace {

using namespace rfw;

// One ray's K-nearest walk, a lane of `persistent`.
template <int K, bool kStats>
struct EntryLane {
  Stack<false>& st;
  const int* nodes;
  int n_nodes;
  int tlas_root;
  const float* ray_o;
  const float* ray_d;
  const float* t_limit;
  float* out_t;
  int* out_inst;
  int4* out_stats;
  Ray r;
  float tlim;
  float ts[K];
  int ins[K];
  int node, it;
  int n_visits, n_boxes;  // counts of the kStats instance

  // The list's cull bound: min(K-th best, t_limit).
  __device__ __forceinline__ float bound() const { return fminf(ts[K - 1], tlim); }

  __device__ __forceinline__ bool start(int i) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      ts[j] = __int_as_float(0x7f800000);  // +inf
      ins[j] = -1;
    }
    n_visits = n_boxes = 0;
    tlim = t_limit[i];
    if (!(0.0f < tlim)) {  // a dead lane: no entry passes te < t_limit
      finish(i);
      return false;
    }
    r.ox = ray_o[3 * i + 0];
    r.oy = ray_o[3 * i + 1];
    r.oz = ray_o[3 * i + 2];
    r.dx = ray_d[3 * i + 0];
    r.dy = ray_d[3 * i + 1];
    r.dz = ray_d[3 * i + 2];
    r.ix = safe_inv(r.dx);
    r.iy = safe_inv(r.dy);
    r.iz = safe_inv(r.dz);
    node = tlas_root;
    it = 0;
    st.sp = 0;
    return true;
  }

  // Pop until the lane holds a node; false when its stack is empty.
  __device__ __forceinline__ bool pop() {
    while (node == -1) {
      if (st.sp <= 0) return false;
      int unused;
      float te;
      st.pop(node, unused, te);
      if (!(te < bound())) node = -1;
    }
    return true;
  }

  __device__ __forceinline__ bool at_leaf() const { return false; }

  __device__ __forceinline__ bool visit() {
    if (node < 0 || node >= n_nodes) {  // malformed code: drop it
      node = -1;
      return ++it < kMaxIters;
    }
    if (kStats) ++n_visits;
    const int* row = nodes + static_cast<size_t>(node) * kNodeInts;
    int nx_code = -1, sd_code = -1;
    float nx_te = kNone, sd_te = kNone;
    auto child = [&](float x0, float y0, float z0, float x1, float y1, float z1, int code,
                     int cnt) {
      if (code < 0 && cnt == 0) return;  // empty slot
      if (kStats) ++n_boxes;
      float tn;
      const bool hit = slab(x0, y0, z0, x1, y1, z1, r, &tn);
      const float te = fmaxf(tn, 0.0f);
      if (!hit || !(te < bound())) return;
      if (code < 0) {  // instance leaf: sorted insert of (te, instance)
        if (!(x0 <= x1 && y0 <= y1 && z0 <= z1)) return;  // padding box
        float tq = te;
        int iq = -code - 1;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          if (tq < ts[j]) {
            const float ot = ts[j];
            const int oi = ins[j];
            ts[j] = tq;
            ins[j] = iq;
            tq = ot;
            iq = oi;
          }
        }
        return;
      }
      if (te < nx_te) {
        if (sd_te != kNone) st.push(sd_code, 0, sd_te);
        sd_code = nx_code;
        sd_te = nx_te;
        nx_code = code;
        nx_te = te;
      } else if (te < sd_te) {
        if (sd_te != kNone) st.push(sd_code, 0, sd_te);
        sd_code = code;
        sd_te = te;
      } else {
        st.push(code, 0, te);
      }
    };
    for_children(row, child);
    if (sd_te != kNone) st.push(sd_code, 0, sd_te);
    node = nx_code;
    return ++it < kMaxIters;
  }

  __device__ __forceinline__ void finish(int i) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      out_t[static_cast<size_t>(i) * K + j] = ts[j];
      out_inst[static_cast<size_t>(i) * K + j] = ins[j];
    }
    if (kStats) out_stats[i] = make_int4(n_visits, n_boxes, 0, 0);
  }
};

template <int K, bool kStats>
__global__ void __launch_bounds__(kWalkBlock, kMinBlocks) entries_kernel(
    const int* __restrict__ nodes, int n_nodes, int tlas_root,
    const float* __restrict__ ray_o, const float* __restrict__ ray_d,
    const float* __restrict__ t_limit, int n_rays,
    float* __restrict__ out_t, int* __restrict__ out_inst,
    int* __restrict__ next_ray, int4* __restrict__ out_stats,
    long long* __restrict__ warp_ns) {
  Stack<false> st;
  EntryLane<K, kStats> lane{st,    nodes,         n_nodes, tlas_root, ray_o,
                            ray_d, t_limit,       out_t,   out_inst,  out_stats};
  persistent<kStats>(lane, n_rays, next_ray, warp_ns);
}

template <int K, bool kStats>
int launch(const void* nodes, int n_nodes, int tlas_root, const void* ray_o,
           const void* ray_d, const void* t_limit, int n_rays, void* out_t, void* out_inst,
           void* next_ray, void* out_stats, void* warp_ns, cudaStream_t s) {
  return launch_persistent<entries_kernel<K, kStats>>(
      n_rays, s, static_cast<const int*>(nodes), n_nodes, tlas_root,
      static_cast<const float*>(ray_o), static_cast<const float*>(ray_d),
      static_cast<const float*>(t_limit), n_rays, static_cast<float*>(out_t),
      static_cast<int*>(out_inst), static_cast<int*>(next_ray),
      static_cast<int4*>(out_stats), static_cast<long long*>(warp_ns));
}

// launch<K, kStats>, or info<entries_kernel<K, kStats>> with `query`, for K
// in 1..8.
template <bool kStats>
int dispatch(int K, bool query, int n_rays, int* shape, const void* nodes, int n_nodes,
             int tlas_root, const void* ray_o, const void* ray_d, const void* t_limit,
             void* out_t, void* out_inst, void* next_ray, void* out_stats, void* warp_ns,
             cudaStream_t s) {
#define RFW_K(k)                                                                           \
  case k:                                                                                  \
    return query ? info<entries_kernel<k, kStats>>(n_rays, shape)                          \
                 : launch<k, kStats>(nodes, n_nodes, tlas_root, ray_o, ray_d, t_limit,     \
                                     n_rays, out_t, out_inst, next_ray, out_stats, warp_ns, \
                                     s);
  switch (K) {
    RFW_K(1)
    RFW_K(2)
    RFW_K(3)
    RFW_K(4)
    RFW_K(5)
    RFW_K(6)
    RFW_K(7)
    RFW_K(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RFW_K
}

}  // namespace

// Plain C entry points (loaded with ctypes). rfw_tlas_entries launches on
// `stream` and returns cudaGetLastError() of the launch (0 = success), or
// cudaErrorInvalidValue for K outside 1..8. It allocates nothing and does
// not synchronize; `next_ray` is one int32 that the caller zeroes, the
// warps' shared ray counter. With `out_stats` (int4 per ray: internal-node
// visits, child box tests, 0, 0) it launches the counting instance, which
// also writes each warp's first and last %globaltimer to `warp_ns` (2 int64
// per launched warp).
extern "C" int rfw_tlas_entries(int K, const void* nodes, int n_nodes, int tlas_root,
                                const void* ray_o, const void* ray_d,
                                const void* t_limit, int n_rays, void* out_t,
                                void* out_inst, void* next_ray, void* out_stats,
                                void* warp_ns, void* stream) {
  if (n_rays <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_stats != nullptr
             ? dispatch<true>(K, false, n_rays, nullptr, nodes, n_nodes, tlas_root, ray_o,
                              ray_d, t_limit, out_t, out_inst, next_ray, out_stats, warp_ns, s)
             : dispatch<false>(K, false, n_rays, nullptr, nodes, n_nodes, tlas_root, ray_o,
                               ray_d, t_limit, out_t, out_inst, next_ray, out_stats, warp_ns,
                               s);
}

// The launch shape of the kernel instance for K (1..8) for n_rays, into
// out[8], as rfw_traverse_info.
extern "C" int rfw_tlas_entries_info(int K, int stats, int n_rays, void* out) {
  int* o = static_cast<int*>(out);
  const cudaStream_t s = nullptr;
  return stats ? dispatch<true>(K, true, n_rays, o, nullptr, 0, 0, nullptr, nullptr, nullptr,
                                nullptr, nullptr, nullptr, nullptr, nullptr, s)
               : dispatch<false>(K, true, n_rays, o, nullptr, 0, 0, nullptr, nullptr, nullptr,
                                 nullptr, nullptr, nullptr, nullptr, nullptr, s);
}
