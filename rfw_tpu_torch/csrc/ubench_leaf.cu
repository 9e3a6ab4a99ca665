// Microbenchmark U1 for NVIDIA Hopper (sm_90a): the cost of K1's treelet
// leaf test, stage by stage, against a chain of dependent loads.
//
// Replaces the TPU kernel of tools/ubench_leaf.py (the in-file kernel of
// its pallas_call; body `make_kernel`, chain `make_fetch_kernel`). It
// computes what that kernel computes: 1,024 rays (8 rows of 128, one
// thread each) run `iters` sequential steps over 64 treelets of 64
// synthetic Woop records; step j tests treelet (j*7 % 64)*8 + g, where the
// record group g = int(t0 of ray 0) % 8 is read once. Variants:
//   full      K1's own leaf_test<false> (bvh_common.cuh) on the 64 slots;
//             a hit sets t = t_best + u_best*1e-30
//   noselect  the same on group 0 (on the TPU it skipped an 8-way select;
//             here the group only moves the address)
//   madds     the six products per slot, then t += min over slots of
//             their sum * 1e-30 (no division, no compares)
//   epilogue  no products: each slot takes o' = o, d' = d and runs the
//             division, u/v, compares and best-slot update
//   fetch     a dependent chain: idx -> load record float 0 of treelet
//             (idx % 64)*8 -> idx = (idx*1103515245 + 12345 + int(v*0)) %
//             65521 (int32 wrap, floor modulo); t = t0 + 1
//   fused     as full, but leaf_test<false, true>: the slot test in the
//             reference tool's own arithmetic (slot_hit_fused: multiply-
//             adds, rcp.approx refined by one Newton step)
//   staged    fused's test in U1's own loop: the step's treelet (its 64
//             slots' u, v, w rows, 3 KB) is copied to shared memory by
//             cp.async while the block tests the previous one, and each
//             slot reads three broadcast LDS.128; slots unrolled by 16
// Every variant starts at t0 = |ox| * 100. aux gets the chain's last
// index for `fetch` and the group g for the others, so the chain is an
// output and nvcc cannot delete it.
//
// What bounds it: one block of 1,024 threads on one SM is latency-bound by
// design (the TPU tool's shape); `copies` independent blocks fill the card
// and read the leaf test's throughput. The records (2 MB) are read through
// the read-only cache and every thread of a warp reads the same slot, so a
// slot costs one broadcast load per warp, not bandwidth; but each load
// still writes 16 B to each of 32 lanes, 4 clocks of the SM's 128 B a
// clock into registers, so 3 loads a slot for 32 warps hold each slot of a
// step at 384 clocks or more whatever the arithmetic: that, not the
// instruction count, bounds full, fused and staged (PERF.md).
//
// Rounding as in the plain version (tools/ubench_leaf.py::leaf_plain):
// products and sums by __fmul_rn/__fadd_rn, exact division; in `fused`
// and `staged` the multiply-adds of slot_hit_fused, which the plain
// version rounds alike, and the approximate reciprocal, which it does not
// (the one source of a difference, held by tolerance). In `epilogue` each
// slot passes d_w through __shfl_sync with the thread's own lane (an
// identity): without it the 64 identical slot epilogues are loop-invariant
// and nvcc would compute one.

#include "bvh_common.cuh"

namespace {

using namespace rfw;

constexpr int kRays = 1024;  // 8 x 128, one block
constexpr int kGroups = 8;
constexpr int kBlocks = 64;  // fetch blocks of 8 groups
constexpr int kFull = 0, kNoSelect = 1, kMadds = 2, kEpilogue = 3, kFetch = 4, kFused = 5,
              kStaged = 6;
constexpr int kStagedUnroll = 16;  // slots a loop body: of 2, 8, 16 and 64 the fastest

// First triangle row of the treelet that step j tests in record group g.
__device__ __forceinline__ int step_first(int j, int g) {
  return ((j * 7) % kBlocks * kGroups + g) * kTreelet;
}

// Copy the u, v, w rows of the 64 slots of the treelet at triangle row
// `first` to buf (3 float4 a slot) by cp.async, one 16-byte row a thread,
// as one commit group.
__device__ __forceinline__ void stage(float4* buf, const float4* __restrict__ tris, int first) {
  const int i = threadIdx.x;
  if (i < 3 * kTreelet) {
    const int slot = i / 3;
    const float4* src = tris + 4 * (static_cast<size_t>(first) + slot) + (i - 3 * slot);
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(buf + i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// `staged`: `iters` steps of slot_hit_fused over the step's treelet read
// from shared memory, double-buffered: step j waits for its own copy,
// synchronises the block (so every thread is done with step j-1's buffer
// too) and starts step j+1's copy into that buffer before it tests. The
// slots are tested in order with leaf_test's best-slot rule. Returns t.
__device__ __forceinline__ float staged_steps(const float4* __restrict__ tris, int g,
                                              int iters, const Ray& r, float t) {
  __shared__ float4 buf[2][3 * kTreelet];
  if (iters > 0) stage(buf[0], tris, step_first(0, g));
  for (int j = 0; j < iters; ++j) {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();
    if (j + 1 < iters) stage(buf[(j + 1) & 1], tris, step_first(j + 1, g));
    const float4* s = buf[j & 1];
    float best = t, bu = 0.0f;
    int win = -1;
#pragma unroll kStagedUnroll
    for (int k = 0; k < kTreelet; ++k) {
      float tq, u, v;
      if (slot_hit_fused(s[3 * k], s[3 * k + 1], s[3 * k + 2], r, best, tq, u, v)) {
        best = tq;
        bu = u;
        win = k;
      }
    }
    if (win >= 0) t = __fadd_rn(best, __fmul_rn(bu, 1e-30f));
  }
  return t;
}

// t_best / u_best / slot of a hit in the (T_MIN, t) window, as leaf_test.
__device__ __forceinline__ void take(float tq, float u, float v, int j, float& best,
                                     float& bu, int& win) {
  if (u >= -1e-7f && v >= -1e-7f && u + v <= 1.0000001f && tq > kTMin && tq < best) {
    best = tq;
    bu = u;
    win = j;
  }
}

template <int kVariant>
__global__ void __launch_bounds__(kRays) leaf_kernel(const float4* __restrict__ tris,
                                                     const float* __restrict__ obj, int iters,
                                                     float* __restrict__ out_t,
                                                     int* __restrict__ out_aux) {
  const int ray = threadIdx.x;
  const int lane = ray & 31;
  Ray r;
  r.ox = obj[0 * kRays + ray];
  r.oy = obj[1 * kRays + ray];
  r.oz = obj[2 * kRays + ray];
  r.dx = obj[3 * kRays + ray];
  r.dy = obj[4 * kRays + ray];
  r.dz = obj[5 * kRays + ray];
  r.ix = r.iy = r.iz = 0.0f;  // the leaf test reads no inverse direction
  float t = __fmul_rn(fabsf(r.ox), 100.0f);
  const int g = floor_mod(static_cast<int>(__fmul_rn(fabsf(obj[0]), 100.0f)), kGroups);
  int aux = g;

  if (kVariant == kFetch) {
    const float* rec = reinterpret_cast<const float*>(tris);
    int idx = 1;
    for (int j = 0; j < iters; ++j) {
      const float v = __ldg(rec + static_cast<size_t>(floor_mod(idx, kBlocks)) * kGroups *
                                      kTreelet * 16);
      const uint32_t h = static_cast<uint32_t>(idx) * 1103515245u + 12345u +
                         static_cast<uint32_t>(static_cast<int>(__fmul_rn(v, 0.0f)));
      idx = floor_mod(static_cast<int>(h), 65521);
    }
    t = __fadd_rn(t, 1.0f);
    aux = idx;
  } else if (kVariant == kStaged) {
    t = staged_steps(tris, g, iters, r, t);
  } else {
    for (int j = 0; j < iters; ++j) {
      const int first = step_first(j, kVariant == kNoSelect ? 0 : g);
      float best = t, bu = 0.0f, bv = 0.0f;
      int win = -1;
      if (kVariant == kFull || kVariant == kNoSelect) {
        leaf_test<false>(tris, first, kTreelet, r, best, bu, bv, win);
      } else if (kVariant == kFused) {
        leaf_test<false, true>(tris, first, kTreelet, r, best, bu, bv, win);
      } else if (kVariant == kMadds) {
        const float4* slot = tris + 4 * static_cast<size_t>(first);
        float tmin = __int_as_float(0x7f800000);  // +inf
        for (int k = 0; k < kTreelet; ++k) {
          const float4 a = __ldg(slot + 4 * k + 0);
          const float4 b = __ldg(slot + 4 * k + 1);
          const float4 c = __ldg(slot + 4 * k + 2);
          const float opu = __fadd_rn(dot3(a.x, a.y, a.z, r.ox, r.oy, r.oz), a.w);
          const float opv = __fadd_rn(dot3(b.x, b.y, b.z, r.ox, r.oy, r.oz), b.w);
          const float opw = __fadd_rn(dot3(c.x, c.y, c.z, r.ox, r.oy, r.oz), c.w);
          const float dpu = dot3(a.x, a.y, a.z, r.dx, r.dy, r.dz);
          const float dpv = dot3(b.x, b.y, b.z, r.dx, r.dy, r.dz);
          const float dpw = dot3(c.x, c.y, c.z, r.dx, r.dy, r.dz);
          const float s = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(opu, opv), opw),
                                                        dpu), dpv), dpw);
          tmin = (s < tmin || s != s) ? s : tmin;  // a NaN stays, as torch.amin
        }
        t = __fadd_rn(t, __fmul_rn(tmin, 1e-30f));
        continue;
      } else {  // kEpilogue
        for (int k = 0; k < kTreelet; ++k) {
          const float dpw = __shfl_sync(0xffffffffu, r.dz, lane);
          const float tq = -r.oz / dpw;
          take(tq, __fadd_rn(r.ox, __fmul_rn(tq, r.dx)), __fadd_rn(r.oy, __fmul_rn(tq, r.dy)),
               k, best, bu, win);
        }
      }
      if (win >= 0) t = __fadd_rn(best, __fmul_rn(bu, 1e-30f));
    }
  }
  const size_t o = static_cast<size_t>(blockIdx.x) * kRays + ray;
  out_t[o] = t;
  out_aux[o] = aux;
}

}  // namespace

// Plain C entry point (loaded with ctypes): `copies` blocks each run the
// whole 1,024-ray problem on the same inputs into their own output rows.
// tris: (n_rows, 16) f32 records, n_rows >= 64*8*64; obj: (9, 8, 128) f32;
// out_t (copies, 8, 128) f32; out_aux (copies, 8, 128) i32. Launches on
// `stream` and returns cudaGetLastError() of the launch (0 = success).
extern "C" int rfw_ubench_leaf(int variant, const void* tris, int n_rows, const void* obj,
                               int iters, int copies, void* out_t, void* out_aux,
                               void* stream) {
  if (n_rows < kBlocks * kGroups * kTreelet || copies <= 0 || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float4* tr = static_cast<const float4*>(tris);
  const float* ob = static_cast<const float*>(obj);
  float* ot = static_cast<float*>(out_t);
  int* oa = static_cast<int*>(out_aux);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(copies), block(kRays);
  switch (variant) {
    case kFull: leaf_kernel<kFull><<<grid, block, 0, s>>>(tr, ob, iters, ot, oa); break;
    case kNoSelect: leaf_kernel<kNoSelect><<<grid, block, 0, s>>>(tr, ob, iters, ot, oa); break;
    case kMadds: leaf_kernel<kMadds><<<grid, block, 0, s>>>(tr, ob, iters, ot, oa); break;
    case kEpilogue: leaf_kernel<kEpilogue><<<grid, block, 0, s>>>(tr, ob, iters, ot, oa); break;
    case kFetch: leaf_kernel<kFetch><<<grid, block, 0, s>>>(tr, ob, iters, ot, oa); break;
    case kFused: leaf_kernel<kFused><<<grid, block, 0, s>>>(tr, ob, iters, ot, oa); break;
    case kStaged: leaf_kernel<kStaged><<<grid, block, 0, s>>>(tr, ob, iters, ot, oa); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
