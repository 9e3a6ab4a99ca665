// The Owen-scrambled Sobol draw for NVIDIA Hopper (sm_90a):
// render/sampler.py::sample_slot in one pass.
//
// Replaces no Pallas kernel. rfw_tpu/render/sampler.py is jnp, which XLA
// fuses into one pass over the lanes; the port's plain form of the same
// function (sample_slot_plain) runs each uint32 step as int64 torch
// operations and a mask to 32 bits: 432 elementwise launches a 2-uniform
// draw and 532 a 3-uniform one, each reading and writing every lane in
// int64. This kernel computes the same bits in registers.
//
// Per lane i, with pid = pixel_id[i] as uint32 and idx the lane's sample
// index (the scalar `index`, or index_lanes[i]):
//   seed = hash(pid * 0x9E3779B9 + slot * 0x85EBCA6B)
//   x    = owen(idx, hash(seed))
//   d0   = owen(brev(x), hash(seed ^ 0x68BC21EB))
//   d1   = owen(sobol_dim1(x), hash(seed ^ 0x02E5BE93))
//   d2   = brev(owen(idx, hash(seed ^ 0x94D049BB)))     (n = 3 only)
// where owen(x, s) = brev(laine_karras(brev(x), s)), every product and sum
// taken modulo 2^32 (uint32 wraps as the plain version's masks do), and
// out[i, k] = float(d_k) * 2^-32, the float conversion rounded to nearest
// even as torch's int64 -> float32 is (2^-32 is exact). The plain version
// and this kernel give the same bits for every input.
//
// What bounds it on an H100: integer operations, not bytes. A lane reads 4 B
// (8 with per-lane indices) and writes 4n B, 16 B at n = 3: 33.2 MB, 9.9 us
// at 3.35 TB/s over 2,073,600 lanes; its 162 counted 32-bit operations at
// n = 3 (139 at n = 2; chip_smoke.py::sobol_ops) take 20.1 us at the card's
// INT32 rate (64 a clock per SM, 132 SMs, 1.98 GHz: 16.7 Tops/s).
// What the design does about it:
//   * one lane a thread, all in uint32 registers: no int64 and no
//     intermediate ever goes to memory;
//   * __brev for each bit reversal (21 operations in the plain version);
//   * sobol_dim1's 32 direction numbers as compile-time constants
//     (Dim1<J>), so each bit of the index costs a test and an xor;
//   * the pixel id read once, each uniform written once.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

// direction number j of the second Sobol dimension: v_0 = 2^31,
// v_j = v_{j-1} ^ (v_{j-1} >> 1) (sampler.py::_sobol_dim1)
template <int J>
struct Dim1 {
  static constexpr uint32_t v = Dim1<J - 1>::v ^ (Dim1<J - 1>::v >> 1);
};
template <>
struct Dim1<0> {
  static constexpr uint32_t v = 0x80000000u;
};
static_assert(Dim1<1>::v == 0xC0000000u && Dim1<2>::v == 0xA0000000u &&
                  Dim1<31>::v == 0xFFFFFFFFu,
              "the direction numbers are the rows of Pascal's triangle mod 2");

template <int J = 0>
__device__ __forceinline__ uint32_t sobol_dim1(uint32_t x, uint32_t r = 0u) {
  if constexpr (J == 32) {
    return r;
  } else {
    return sobol_dim1<J + 1>(x, (x & (1u << J)) ? r ^ Dim1<J>::v : r);
  }
}

__device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t laine_karras(uint32_t x, uint32_t seed) {
  x += seed;
  x ^= x * 0x6C50B47Cu;
  x ^= x * 0xB82F1E52u;
  x ^= x * 0xC7AFE638u;
  x ^= x * 0x8D22F6E6u;
  return x;
}

__device__ __forceinline__ uint32_t owen_scramble(uint32_t x, uint32_t seed) {
  return __brev(laine_karras(__brev(x), seed));
}

__device__ __forceinline__ float to_unit(uint32_t x) {
  return __uint2float_rn(x) * 0x1p-32f;
}

template <int kN>
__global__ void __launch_bounds__(kBlock) sobol_slot_kernel(
    const int32_t* __restrict__ pixel_id, const uint32_t* __restrict__ index_lanes,
    uint32_t index, uint32_t slot, int n_lanes, float* __restrict__ out) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n_lanes) return;
  const uint32_t idx = index_lanes != nullptr ? index_lanes[i] : index;
  const uint32_t seed =
      hash_u32(static_cast<uint32_t>(pixel_id[i]) * 0x9E3779B9u + slot * 0x85EBCA6Bu);
  const uint32_t x = owen_scramble(idx, hash_u32(seed));
  const uint32_t d0 = owen_scramble(__brev(x), hash_u32(seed ^ 0x68BC21EBu));
  const uint32_t d1 = owen_scramble(sobol_dim1(x), hash_u32(seed ^ 0x02E5BE93u));
  float* o = out + static_cast<size_t>(i) * kN;
  if constexpr (kN == 2) {
    *reinterpret_cast<float2*>(o) = make_float2(to_unit(d0), to_unit(d1));
  } else {
    const uint32_t d2 = __brev(owen_scramble(idx, hash_u32(seed ^ 0x94D049BBu)));
    o[0] = to_unit(d0);
    o[1] = to_unit(d1);
    o[2] = to_unit(d2);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes): the (n_lanes, n) float32 uniforms
// of Sobol slot `slot` at sample `index` for the int32 pixel ids, row-major
// into `out`, n 2 or 3. `index_lanes`, when not null, holds one uint32
// sample index per lane and `index` is not read. Launches on `stream`,
// allocates nothing, does not synchronize, and returns cudaGetLastError()
// of the launch (cudaErrorInvalidValue for another n).
extern "C" int rfw_sobol_slot(int n, const void* pixel_id, const void* index_lanes,
                              unsigned int index, unsigned int slot, int n_lanes, void* out,
                              void* stream) {
  if (n != 2 && n != 3) return cudaErrorInvalidValue;
  if (n_lanes <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = (n_lanes + kBlock - 1) / kBlock;
  const auto* pid = static_cast<const int32_t*>(pixel_id);
  const auto* lanes = static_cast<const uint32_t*>(index_lanes);
  auto* o = static_cast<float*>(out);
  if (n == 2) {
    sobol_slot_kernel<2><<<grid, kBlock, 0, s>>>(pid, lanes, index, slot, n_lanes, o);
  } else {
    sobol_slot_kernel<3><<<grid, kBlock, 0, s>>>(pid, lanes, index, slot, n_lanes, o);
  }
  return cudaGetLastError();
}
