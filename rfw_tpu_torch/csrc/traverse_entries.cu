// Two-phase traversal, phase A by tree, for NVIDIA Hopper (sm_90a): per
// ray, the K nearest TLAS instance entries.
//
// Replaces the TPU kernel
// rfw_tpu/ops/traverse_entries.py::_entries_kernel_factory (K4). One thread
// walks one world ray over the TLAS supernodes of the merged node array
// (prepare_scene offsets internal TLAS codes by the BLAS supernode count),
// with a private 96-deep stack, and keeps the K nearest instance slab
// entries in registers by a sorted insert (K is a template parameter, at
// most 8). An instance leaf child inserts its clamped entry max(tn, 0);
// a child of either kind is culled unless max(tn, 0) < min(K-th best,
// t_limit), so the walk sharpens as the list fills and a dead lane
// (t_limit 0) emits nothing, as in the TPU kernel. Empty child slots (code
// < 0, count 0) are skipped, and an inverted (padding) box never inserts.
// Children are visited in the TPU kernel's order (the last hit is taken
// next, earlier hits are pushed). Outputs: t_entry (R,K) ascending, +inf
// where there is none; inst (R,K), -1 where there is none.
//
// What bounds it on an H100: the latency of the dependent TLAS node
// fetches of each ray's walk; the TLAS (a few hundred KB for 10k
// instances) stays in L2. Inserting in registers keeps the list off
// memory; each ray writes its K entries once at the end.

#include "bvh_common.cuh"

namespace {

using namespace rfw;

template <int K>
__global__ void __launch_bounds__(kBlock) entries_kernel(
    const int* __restrict__ nodes, int n_nodes, int tlas_root,
    const float* __restrict__ ray_o, const float* __restrict__ ray_d,
    const float* __restrict__ t_limit, int n_rays,
    float* __restrict__ out_t, int* __restrict__ out_inst) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  Ray r;
  r.ox = ray_o[3 * i + 0];
  r.oy = ray_o[3 * i + 1];
  r.oz = ray_o[3 * i + 2];
  r.dx = ray_d[3 * i + 0];
  r.dy = ray_d[3 * i + 1];
  r.dz = ray_d[3 * i + 2];
  r.ix = safe_inv(r.dx);
  r.iy = safe_inv(r.dy);
  r.iz = safe_inv(r.dz);
  const float tlim = t_limit[i];

  float ts[K];
  int ins[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    ts[j] = __int_as_float(0x7f800000);  // +inf
    ins[j] = -1;
  }

  int stack[kStackDepth];
  int sp = 0;
  int node = tlas_root;
  for (int it = 0; it < kMaxIters; ++it) {
    if (node == -1) {
      if (sp <= 0) break;
      node = stack[--sp];
    }
    if (node < 0 || node >= n_nodes) {  // malformed code: drop it
      node = -1;
      continue;
    }
    const int* row = nodes + static_cast<size_t>(node) * kNodeInts;
    const int4 c0 = __ldg(reinterpret_cast<const int4*>(row + 6 * kArity));
    const int4 c1 = __ldg(reinterpret_cast<const int4*>(row + 6 * kArity + 4));
    const int4 n0 = __ldg(reinterpret_cast<const int4*>(row + 7 * kArity));
    const int4 n1 = __ldg(reinterpret_cast<const int4*>(row + 7 * kArity + 4));
    const int codes[kArity] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
    const int cnts[kArity] = {n0.x, n0.y, n0.z, n0.w, n1.x, n1.y, n1.z, n1.w};
    int next_code = -1;
#pragma unroll
    for (int c = 0; c < kArity; ++c) {
      const int code = codes[c];
      if (code < 0 && cnts[c] == 0) continue;  // empty slot
      float tn;
      const bool slab = child_slab(row, c, r, &tn);
      const float te = fmaxf(tn, 0.0f);
      if (!slab || !(te < fminf(ts[K - 1], tlim))) continue;
      if (code < 0) {  // instance leaf: sorted insert of (te, instance)
        if (!child_box_valid(row, c)) continue;
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
        continue;
      }
      if (next_code != -1) {
        stack[min(sp, kStackDepth - 1)] = next_code;
        sp = min(sp + 1, kStackDepth);
      }
      next_code = code;
    }
    node = next_code;
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    out_t[static_cast<size_t>(i) * K + j] = ts[j];
    out_inst[static_cast<size_t>(i) * K + j] = ins[j];
  }
}

template <int K>
void launch(const void* nodes, int n_nodes, int tlas_root, const void* ray_o,
            const void* ray_d, const void* t_limit, int n_rays, void* out_t,
            void* out_inst, cudaStream_t s) {
  const dim3 grid((n_rays + kBlock - 1) / kBlock);
  entries_kernel<K><<<grid, kBlock, 0, s>>>(
      static_cast<const int*>(nodes), n_nodes, tlas_root,
      static_cast<const float*>(ray_o), static_cast<const float*>(ray_d),
      static_cast<const float*>(t_limit), n_rays,
      static_cast<float*>(out_t), static_cast<int*>(out_inst));
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream` and
// returns cudaGetLastError() of the launch (0 = success), or
// cudaErrorInvalidValue for K outside 1..8. It allocates nothing and does
// not synchronize.
extern "C" int rfw_tlas_entries(int K, const void* nodes, int n_nodes, int tlas_root,
                                const void* ray_o, const void* ray_d,
                                const void* t_limit, int n_rays, void* out_t,
                                void* out_inst, void* stream) {
  if (n_rays <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: launch<1>(nodes, n_nodes, tlas_root, ray_o, ray_d, t_limit, n_rays, out_t, out_inst, s); break;
    case 2: launch<2>(nodes, n_nodes, tlas_root, ray_o, ray_d, t_limit, n_rays, out_t, out_inst, s); break;
    case 3: launch<3>(nodes, n_nodes, tlas_root, ray_o, ray_d, t_limit, n_rays, out_t, out_inst, s); break;
    case 4: launch<4>(nodes, n_nodes, tlas_root, ray_o, ray_d, t_limit, n_rays, out_t, out_inst, s); break;
    case 5: launch<5>(nodes, n_nodes, tlas_root, ray_o, ray_d, t_limit, n_rays, out_t, out_inst, s); break;
    case 6: launch<6>(nodes, n_nodes, tlas_root, ray_o, ray_d, t_limit, n_rays, out_t, out_inst, s); break;
    case 7: launch<7>(nodes, n_nodes, tlas_root, ray_o, ray_d, t_limit, n_rays, out_t, out_inst, s); break;
    case 8: launch<8>(nodes, n_nodes, tlas_root, ray_o, ray_d, t_limit, n_rays, out_t, out_inst, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
