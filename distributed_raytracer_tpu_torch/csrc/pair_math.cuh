// Baldwin-Weber ray-triangle pair math shared by the traversal kernels
// (bsr_trace.cu: K1-K5) and the ring step kernels (ring_trace.cu: K6, K7).
//
// Triangle rows are 16 floats [nx ny nz w | kux kuy kuz w_u | kvx kvy kvz
// w_v | 0 0 0 0], read as float4 quads a, b, c. With a shared origin
// (kShared) they are the pack_tris_origin layout: the common ray origin is
// folded in, w = plane_d - n.o, w_u = ku.o + c_u, w_v = kv.o + c_v.
// Otherwise they are the static pack_tris layout (w = plane_d, w_u = c_u,
// w_v = c_v) and the ray's own origin is dotted in per pair.
//
// The operation order is _pair_math's (distributed_raytracer_tpu/ops/
// pallas/bsr_trace.py:236-248; ring_trace.py:123-140 is the same math).
// Built with -fmad=false and without --use_fast_math, every product and
// sum rounds on its own and the division is IEEE, so the result equals the
// plain PyTorch versions' bit for bit; a zero den (a dead ray's zero
// direction, a padding triangle) gives inf or NaN, which fails the test.

#pragma once

namespace {

// ops/intersect.py BARY_EPS, rounded as the Python float is rounded to f32.
constexpr float kEps = (float)1e-4;
constexpr float kOneEps = (float)(1.0 + 1e-4);

template <bool kShared>
__device__ __forceinline__ bool pair_math(const float4 a, const float4 b,
                                          const float4 c, float ox, float oy,
                                          float oz, float dx, float dy,
                                          float dz, float* t_out) {
  const float den = a.x * dx + a.y * dy + a.z * dz;
  float t, au, av;
  if (kShared) {
    t = a.w / den;
    au = b.w;
    av = c.w;
  } else {
    const float o_n = a.x * ox + a.y * oy + a.z * oz;
    t = (a.w - o_n) / den;
    au = (b.x * ox + b.y * oy + b.z * oz) + b.w;
    av = (c.x * ox + c.y * oy + c.z * oz) + c.w;
  }
  const float u = au + t * (b.x * dx + b.y * dy + b.z * dz);
  const float v = av + t * (c.x * dx + c.y * dy + c.z * dz);
  *t_out = t;
  const float uv = u + v;
  return (den != 0.0f) & (t >= 0.0f) & (u >= -kEps) & (u <= kOneEps) &
         (uv >= -kEps) & (uv <= kOneEps) & (v >= -kEps);
}

}  // namespace
