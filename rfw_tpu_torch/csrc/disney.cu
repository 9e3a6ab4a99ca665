// The Disney principled BSDF for NVIDIA Hopper (sm_90a): render/disney.py's
// eval, pdf and sample, one lane a thread, in two kernels.
//
// Replaces no Pallas kernel. rfw_tpu/render/disney.py is jnp, which XLA
// fuses into a few passes over the lanes; the port's plain form of the same
// functions (disney_eval_plain_c, disney_pdf_plain_c, disney_sample_plain_c)
// runs every float operation as an eager torch launch over the live prefix:
// about 300 launches for an eval and a pdf, about 540 for a sample with its
// own eval and pdf, so 300-840 a path vertex and 1,000-2,800 a frame. These
// kernels compute the same bits in registers, one launch a call site:
//
//   disney_eval_pdf_kernel   f(wo, wi) (3 planes) and, when asked, the pdf
//                            (the NEE site of wavefront.py::_shade_vertex);
//   disney_sample_kernel     wi (3), f (3), pdf and is_delta of a sampled
//                            direction, its eval and pdf inside.
//
// The arithmetic is the plain version's, operation for operation: every
// product, sum, quotient and square root is one IEEE round-to-nearest
// intrinsic (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn), which
// the compiler never contracts into an FMA, in the order torch evaluates the
// Python expression. Where torch on CUDA computes otherwise than the
// expression reads, so does this file:
//   * `x / c` by a Python float is x * (1.0f / float(c)) (torch's true
//     division by a CPU scalar multiplies by its float reciprocal);
//   * `1.0 / x` is Tensor.__rtruediv__, reciprocal(x) * 1.0;
//   * a Python float constant is the float nearest its double, as torch
//     casts a wrapped scalar;
//   * torch.clamp passes NaN through; torch.where picks one operand per lane,
//     so a lane computes only the lobe it selects.
// logf, sinf, cosf and powf are CUDA's, the functions torch's log, sin, cos
// and pow call for float tensors.
//
// What bounds it on an H100: bytes. A lane reads 20 float planes (14 of the
// material, wo, wi or the 3 uniforms) and writes 4 planes (eval and pdf) or
// 7 and a bool (sample): 96 or 109 B, 0.059 or 0.067 ms at 3.35 TB/s over
// 2,073,600 lanes; its float operations, some 200-450 a lane, take under
// 0.014 ms at 67 TFLOP/s. What the design does about it:
//   * one pass, registers only: no intermediate plane goes to memory;
//   * each input read once where it lies, through a pointer and an element
//     stride per plane passed by value: the material planes are column views
//     of wavefront.py::_fetch_material_c's gathered rows, the uniforms
//     columns of the (R, 3) draw, read without a copy or a packing launch;
//   * `features` (disney.FEAT_*) is a kernel argument, uniform over the
//     grid, so the skipped lobes cost one predicate and no template
//     instance.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

// feature bits (render/disney.py FEAT_*)
constexpr int kTransmission = 1;
constexpr int kClearcoat = 2;
constexpr int kSubsurface = 4;
constexpr int kSheen = 8;

// the input planes, in the order of render/disney.py::_planes
enum Plane {
  kBase = 0,  // 3 planes
  kMetallic = 3,
  kRoughness,
  kSpecularF,
  kSpecularTint,
  kSheenP,
  kSheenTint,
  kClearcoatP,
  kClearcoatGloss,
  kSubsurfaceP,
  kTransmissionP,
  kEtaRel,
  kWo,        // 3 planes
  kW = 17,    // wi, or the uniforms u0, u1, u2: 3 planes
  kPlanes = 20,
};

struct Planes {
  const float* p[kPlanes];
  long long stride[kPlanes];
};

// render/disney.py's PI; torch casts each Python float to the float nearest it
constexpr double kPi = 3.14159265358979;
#define F32(x) static_cast<float>(x)
constexpr float kPiF = F32(kPi);
constexpr float kTwoPiF = F32(2.0 * kPi);   // `2.0 * PI * u`: the product in Python
constexpr float kInvPiF = F32(1.0 / kPi);   // _gtr1's `1.0 / PI`, a Python float
constexpr float kDivPiF = 1.0f / kPiF;      // `x / PI`: torch's scalar reciprocal

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float sqrt_(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ float sqr(float a) { return mul(a, a); }
// `1.0 / x`: reciprocal(x) * 1.0
__device__ __forceinline__ float rcp(float a) { return mul(__fdiv_rn(1.0f, a), 1.0f); }
// torch.clamp(x, min=lo) and torch.clamp(x, lo, hi): NaN passes
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3_add(V3 a, V3 b) { return {add(a.x, b.x), add(a.y, b.y), add(a.z, b.z)}; }
__device__ __forceinline__ V3 v3_scale(V3 a, float s) { return {mul(a.x, s), mul(a.y, s), mul(a.z, s)}; }
__device__ __forceinline__ float v3_dot(V3 a, V3 b) {
  return add(add(mul(a.x, b.x), mul(a.y, b.y)), mul(a.z, b.z));
}
__device__ __forceinline__ V3 v3_normalize(V3 a) {
  return v3_scale(a, rcp(clamp_min(sqrt_(v3_dot(a, a)), F32(1e-12))));
}
__device__ __forceinline__ V3 reflect(V3 wo, V3 h) {
  const float k = mul(2.0f, v3_dot(wo, h));
  return {sub(mul(h.x, k), wo.x), sub(mul(h.y, k), wo.y), sub(mul(h.z, k), wo.z)};
}

struct Mat {
  float base[3], metallic, roughness, specular_f, specular_tint, sheen, sheen_tint,
      clearcoat, clearcoat_gloss, subsurface, transmission, eta_rel;
};

__device__ __forceinline__ float load(const Planes& P, int k, long long i) {
  return __ldg(P.p[k] + i * P.stride[k]);
}
__device__ __forceinline__ V3 load3(const Planes& P, int k, long long i) {
  return {load(P, k, i), load(P, k + 1, i), load(P, k + 2, i)};
}
__device__ __forceinline__ Mat load_mat(const Planes& P, long long i) {
  Mat m;
  for (int j = 0; j < 3; ++j) m.base[j] = load(P, kBase + j, i);
  m.metallic = load(P, kMetallic, i);
  m.roughness = load(P, kRoughness, i);
  m.specular_f = load(P, kSpecularF, i);
  m.specular_tint = load(P, kSpecularTint, i);
  m.sheen = load(P, kSheenP, i);
  m.sheen_tint = load(P, kSheenTint, i);
  m.clearcoat = load(P, kClearcoatP, i);
  m.clearcoat_gloss = load(P, kClearcoatGloss, i);
  m.subsurface = load(P, kSubsurfaceP, i);
  m.transmission = load(P, kTransmissionP, i);
  m.eta_rel = load(P, kEtaRel, i);
  return m;
}

// ------------------------------------------------------------- the lobes
__device__ __forceinline__ float schlick(float u) {
  const float m = clamp(sub(1.0f, u), 0.0f, 1.0f);
  return mul(sqr(sqr(m)), m);
}

__device__ __forceinline__ float gtr1(float ndh, float a) {
  const float a2 = sqr(a);
  const float t = add(mul(sub(a2, 1.0f), sqr(ndh)), 1.0f);
  return a >= 1.0f ? kInvPiF : div(sub(a2, 1.0f), mul(mul(kPiF, logf(a2)), t));
}

__device__ __forceinline__ float gtr2(float ndh, float a) {
  const float a2 = sqr(a);
  const float t = add(mul(sub(a2, 1.0f), sqr(ndh)), 1.0f);
  return div(a2, add(mul(kPiF, sqr(t)), F32(1e-12)));
}

// _smith_ggx(ndv, a) with a2 = a * a
__device__ __forceinline__ float smith_ggx(float ndv, float a2) {
  const float b = sqr(ndv);
  return rcp(add(add(ndv, sqrt_(sub(add(a2, b), mul(a2, b)))), F32(1e-12)));
}

__device__ __forceinline__ float a_clearcoat(const Mat& m) {
  return add(mul(F32(0.1), sub(1.0f, m.clearcoat_gloss)), mul(F32(0.001), m.clearcoat_gloss));
}

__device__ __forceinline__ float trans_share(const Mat& m) {
  return mul(clamp(m.transmission, 0.0f, 1.0f), sub(1.0f, m.metallic));
}

// _lobe_weights: the (specular, clearcoat) sampling weights; diffuse in *diff
__device__ __forceinline__ void lobe_weights(const Mat& m, int features, float* spec,
                                             float* cc, float* diff) {
  const float diff_w = mul(sub(1.0f, m.metallic), 0.5f);
  const float metal_w = add(mul(m.metallic, 0.5f), 0.5f);
  if (!(features & kClearcoat)) {
    const float total = add(add(metal_w, diff_w), F32(1e-8));
    *spec = div(metal_w, total);
    *cc = 0.0f;
    *diff = div(diff_w, total);
    return;
  }
  const float spec_w = mul(rcp(add(mul(m.clearcoat, 0.5f), 1.0f)), metal_w);
  const float cc_w = div(mul(m.clearcoat, 0.25f), add(mul(m.clearcoat, 0.25f), 1.0f));
  const float total = add(add(add(spec_w, cc_w), diff_w), F32(1e-8));
  *spec = div(spec_w, total);
  *cc = div(cc_w, total);
  *diff = div(diff_w, total);
}

// disney_eval_plain_c, h = normalize(wi + wo)
__device__ __forceinline__ V3 eval(const Mat& m, V3 wo, V3 wi, V3 h, int features) {
  const float ndv = wo.z, ndl = wi.z;
  const bool up = (ndv > F32(1e-6)) && (ndl > F32(1e-6));
  const float ndh = h.z;
  const float ldh = v3_dot(wi, h);

  // _tint_c
  const float lum = add(add(mul(F32(0.2126), m.base[0]), mul(F32(0.7152), m.base[1])),
                        mul(F32(0.0722), m.base[2]));
  const float inv_lum = rcp(clamp_min(lum, F32(1e-7)));
  float ctint[3];
  for (int j = 0; j < 3; ++j) ctint[j] = lum > 0.0f ? mul(m.base[j], inv_lum) : 1.0f;

  const float f0_base = mul(F32(0.08), m.specular_f);
  const float one_m_metal = sub(1.0f, m.metallic);

  // diffuse
  const float fl = schlick(ndl), fv = schlick(ndv);
  const float fd90_m1 = sub(add(mul(mul(2.0f, sqr(ldh)), m.roughness), 0.5f), 1.0f);
  const float fd = mul(add(mul(fd90_m1, fl), 1.0f), add(mul(fd90_m1, fv), 1.0f));
  float diffuse_w = fd;
  if ((features & kSubsurface) && m.subsurface > 0.0f) {
    const float fss90_m1 = sub(mul(sqr(ldh), m.roughness), 1.0f);
    const float fss = mul(add(mul(fss90_m1, fl), 1.0f), add(mul(fss90_m1, fv), 1.0f));
    const float ss = mul(
        1.25f, add(mul(fss, sub(rcp(clamp_min(add(ndl, ndv), F32(1e-6))), 0.5f)), 0.5f));
    diffuse_w = add(mul(sub(1.0f, m.subsurface), fd), mul(m.subsurface, ss));
  }
  const float diff_s = mul(diffuse_w, kDivPiF);

  // sheen, specular GTR2, clearcoat GTR1
  const float fh = schlick(ldh);
  const float alpha = clamp_min(sqr(m.roughness), F32(1e-3));
  const float a2 = sqr(alpha);
  const float dsgs = mul(gtr2(ndh, alpha), mul(smith_ggx(ndl, a2), smith_ggx(ndv, a2)));
  float f_cc = 0.0f;
  if (features & kClearcoat) {
    const float dr = gtr1(ndh, a_clearcoat(m));
    const float fr = add(mul(F32(0.96), fh), F32(0.04));
    const float gr = mul(smith_ggx(ndl, 0.0625f), smith_ggx(ndv, 0.0625f));
    f_cc = mul(mul(mul(mul(0.25f, m.clearcoat), dr), fr), gr);
  }

  float out[3];
  for (int j = 0; j < 3; ++j) {
    float f_diffuse = mul(m.base[j], diff_s);
    if (features & kSheen) {
      const float csheen = add(sub(1.0f, m.sheen_tint), mul(m.sheen_tint, ctint[j]));
      f_diffuse = add(f_diffuse, mul(mul(fh, m.sheen), csheen));
    }
    const float spec_lerp = add(sub(1.0f, m.specular_tint), mul(m.specular_tint, ctint[j]));
    const float cspec0 = add(mul(mul(f0_base, spec_lerp), one_m_metal), mul(m.base[j], m.metallic));
    const float fs = add(cspec0, mul(sub(1.0f, cspec0), fh));
    float f = add(add(mul(f_diffuse, one_m_metal), mul(dsgs, fs)), f_cc);
    if (features & kTransmission) f = mul(f, sub(1.0f, mul(clamp(m.transmission, 0.0f, 1.0f), one_m_metal)));
    out[j] = up ? f : 0.0f;
  }
  return {out[0], out[1], out[2]};
}

// disney_pdf_plain_c, h = normalize(wi + wo)
__device__ __forceinline__ float pdf(const Mat& m, V3 wo, V3 wi, V3 h, int features) {
  const float ndl = wi.z, ndv = wo.z;
  const bool up = (ndl > F32(1e-6)) && (ndv > F32(1e-6));
  const float ndh = clamp_min(h.z, F32(1e-6));
  const float ldh4 = mul(4.0f, clamp_min(v3_dot(wi, h), F32(1e-6)));
  float spec_w, cc_w, diff_w;
  lobe_weights(m, features, &spec_w, &cc_w, &diff_w);
  const float alpha = clamp_min(sqr(m.roughness), F32(1e-3));
  const float pdf_spec = div(mul(gtr2(ndh, alpha), ndh), ldh4);
  float p = add(mul(diff_w, mul(ndl, kDivPiF)), mul(spec_w, pdf_spec));
  if (features & kClearcoat) p = add(p, div(mul(mul(cc_w, gtr1(ndh, a_clearcoat(m))), ndh), ldh4));
  if (features & kTransmission) p = mul(p, sub(1.0f, trans_share(m)));
  return up ? p : 0.0f;
}

// ------------------------------------------------------------ the samplers
__device__ __forceinline__ V3 sample_cosine(float u1, float u2) {
  const float r = sqrt_(u1);
  const float phi = mul(u2, kTwoPiF);
  return {mul(r, cosf(phi)), mul(r, sinf(phi)), sqrt_(clamp_min(sub(1.0f, u1), 0.0f))};
}

__device__ __forceinline__ V3 sample_gtr2_h(float u1, float u2, float alpha) {
  const float phi = mul(u1, kTwoPiF);
  const float cos_t =
      sqrt_(clamp(div(sub(1.0f, u2), add(mul(sub(sqr(alpha), 1.0f), u2), 1.0f)), 0.0f, 1.0f));
  const float sin_t = sqrt_(clamp_min(sub(1.0f, sqr(cos_t)), 0.0f));
  return {mul(sin_t, cosf(phi)), mul(sin_t, sinf(phi)), cos_t};
}

__device__ __forceinline__ V3 sample_gtr1_h(float u1, float u2, float a) {
  const float a2 = sqr(a);
  const float phi = mul(u1, kTwoPiF);
  const float cos2 = div(sub(1.0f, powf(a2, sub(1.0f, u2))), clamp_min(sub(1.0f, a2), F32(1e-6)));
  const float cos_t = sqrt_(clamp(cos2, 0.0f, 1.0f));
  const float sin_t = sqrt_(clamp_min(sub(1.0f, cos2), 0.0f));
  return {mul(sin_t, cosf(phi)), mul(sin_t, sinf(phi)), cos_t};
}

// fresnel_dielectric
__device__ __forceinline__ float fresnel_dielectric(float cos_i, float eta) {
  cos_i = clamp(cos_i, 0.0f, 1.0f);
  const float sin2_t = mul(sqr(eta), sub(1.0f, sqr(cos_i)));
  if (sin2_t >= 1.0f) return 1.0f;
  const float cos_t = sqrt_(clamp_min(sub(1.0f, sin2_t), 0.0f));
  const float ec = mul(eta, cos_i), et = mul(eta, cos_t);
  const float r_par = div(sub(ec, cos_t), clamp_min(add(ec, cos_t), F32(1e-12)));
  const float r_perp = div(sub(cos_i, et), clamp_min(add(cos_i, et), F32(1e-12)));
  return clamp(mul(0.5f, add(sqr(r_par), sqr(r_perp))), 0.0f, 1.0f);
}

struct Sample {
  V3 wi, f;
  float pdf;
  bool is_delta;
};

// disney_sample_plain_c
__device__ __forceinline__ Sample sample(const Mat& m, V3 wo, float pick, float u1, float u2,
                                         int features) {
  const float alpha = clamp_min(sqr(m.roughness), F32(1e-3));
  float pick_r = pick, trans_w = 0.0f;
  if (features & kTransmission) {
    trans_w = trans_share(m);
    if (pick < trans_w) {
      // the delta-style transmission lobe on the GTR2 microfacet
      const V3 h = sample_gtr2_h(u1, u2, alpha);
      const float cos_i = v3_dot(wo, h);
      const float fr = fresnel_dielectric(cos_i, m.eta_rel);
      const float sin2_t = mul(sqr(m.eta_rel), sub(1.0f, sqr(cos_i)));
      const float pick_t = clamp(div(pick, clamp_min(trans_w, F32(1e-8))), 0.0f, 1.0f);
      const bool do_reflect = sin2_t >= 1.0f || pick_t < fr;
      V3 wi;
      if (do_reflect) {
        wi = reflect(wo, h);
      } else {  // _refract_c
        const float cos_t = sqrt_(clamp_min(sub(1.0f, sin2_t), 0.0f));
        const float k = sub(mul(m.eta_rel, cos_i), cos_t);
        wi = v3_normalize(v3_add(v3_scale({-wo.x, -wo.y, -wo.z}, m.eta_rel), v3_scale(h, k)));
      }
      const float abs_cos = clamp_min(fabsf(wi.z), F32(1e-6));
      const float inv_share = div(clamp_min(trans_w, F32(1e-8)), abs_cos);
      const V3 w = do_reflect ? V3{1.0f, 1.0f, 1.0f} : V3{m.base[0], m.base[1], m.base[2]};
      return {wi, v3_scale(w, inv_share), trans_w, true};
    }
    pick_r = clamp(div(sub(pick, trans_w), clamp_min(sub(1.0f, trans_w), F32(1e-8))), 0.0f, 1.0f);
  }
  float spec_w, cc_w, diff_w;
  lobe_weights(m, features, &spec_w, &cc_w, &diff_w);
  V3 wi;
  if (pick_r < spec_w) {
    wi = reflect(wo, sample_gtr2_h(u1, u2, alpha));
  } else if ((features & kClearcoat) && pick_r < add(spec_w, cc_w)) {
    wi = reflect(wo, sample_gtr1_h(u1, u2, a_clearcoat(m)));
  } else {
    wi = sample_cosine(u1, u2);
  }
  wi = v3_normalize(wi);
  const V3 h = v3_normalize(v3_add(wi, wo));
  return {wi, eval(m, wo, wi, h, features), pdf(m, wo, wi, h, features), false};
}

// ------------------------------------------------------------- the kernels
__global__ void __launch_bounds__(kBlock) disney_eval_pdf_kernel(Planes P, int features,
                                                                 int with_pdf, int n,
                                                                 float* __restrict__ out) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  const Mat m = load_mat(P, i);
  const V3 wo = load3(P, kWo, i), wi = load3(P, kW, i);
  const V3 h = v3_normalize(v3_add(wi, wo));
  const V3 f = eval(m, wo, wi, h, features);
  const size_t N = static_cast<size_t>(n);
  out[i] = f.x;
  out[N + i] = f.y;
  out[2 * N + i] = f.z;
  if (with_pdf) out[3 * N + i] = pdf(m, wo, wi, h, features);
}

__global__ void __launch_bounds__(kBlock) disney_sample_kernel(Planes P, int features, int n,
                                                               float* __restrict__ out,
                                                               bool* __restrict__ is_delta) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  const Mat m = load_mat(P, i);
  const V3 wo = load3(P, kWo, i);
  const Sample s = sample(m, wo, load(P, kW, i), load(P, kW + 1, i), load(P, kW + 2, i), features);
  const size_t N = static_cast<size_t>(n);
  out[i] = s.wi.x;
  out[N + i] = s.wi.y;
  out[2 * N + i] = s.wi.z;
  out[3 * N + i] = s.f.x;
  out[4 * N + i] = s.f.y;
  out[5 * N + i] = s.f.z;
  out[6 * N + i] = s.pdf;
  is_delta[i] = s.is_delta;
}

Planes planes_of(const void* planes, const void* strides) {
  Planes P;
  const auto* p = static_cast<const float* const*>(planes);
  const auto* s = static_cast<const long long*>(strides);
  for (int k = 0; k < kPlanes; ++k) {
    P.p[k] = p[k];
    P.stride[k] = s[k];
  }
  return P;
}

}  // namespace

// Plain C entry points (loaded with ctypes). `planes` is a host array of 20
// float32 device pointers in render/disney.py::_planes's order (base_color
// x3, metallic, roughness, specular_f, specular_tint, sheen, sheen_tint,
// clearcoat, clearcoat_gloss, subsurface, transmission, eta_rel, wo x3, then
// wi x3 or the uniforms u0, u1, u2), `strides` a host array of their 20
// element strides (int64; 0 broadcasts one value). Lane i of plane k is
// planes[k][i * strides[k]]. `out` is a (k, n) row-major float32 block:
// f x3 and, with `with_pdf`, the pdf (k = 4, else 3); or wi x3, f x3 and the
// pdf (k = 7) beside `is_delta`, (n,) bool. Each launches on `stream`,
// allocates nothing, does not synchronize, and returns cudaGetLastError() of
// the launch.
extern "C" int rfw_disney_eval_pdf(const void* planes, const void* strides, int features,
                                   int with_pdf, int n, void* out, void* stream) {
  if (n <= 0) return 0;
  disney_eval_pdf_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      planes_of(planes, strides), features, with_pdf, n, static_cast<float*>(out));
  return cudaGetLastError();
}

extern "C" int rfw_disney_sample(const void* planes, const void* strides, int features, int n,
                                 void* out, void* is_delta, void* stream) {
  if (n <= 0) return 0;
  disney_sample_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      planes_of(planes, strides), features, n, static_cast<float*>(out),
      static_cast<bool*>(is_delta));
  return cudaGetLastError();
}
