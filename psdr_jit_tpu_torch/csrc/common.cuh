// Per-lane arithmetic shared by K2 (megakernel.cu) and K3/K4 (shade.cu):
// the safe math of psdr_jit_tpu_torch/core/math.py, the sampler's pcg4d
// draw and the cosine-weighted hemisphere warp. Every function is written
// once here so that the kernels cannot drift apart; the plain PyTorch
// versions follow the same operation order. The functions compile for the
// host too (PSDR_HD), so their arithmetic can be exercised without a card.
#pragma once

#include <cmath>
#include <cstdint>

#ifdef __CUDACC__
#define PSDR_HD __host__ __device__ __forceinline__
#else
#define PSDR_HD inline
#endif

namespace psdr {

constexpr float kTiny = 1e-20f;
constexpr float kEpsilon = 1e-5f;
constexpr float kShadowEpsilon = 1e-3f;
constexpr float kInvPi = 0.318309886183790671538f;
constexpr float kPiOver4 = 0.785398163397448309616f;
constexpr uint32_t kSalt = 0x9E3779B9u;

struct V3 {
  float x, y, z;
};

PSDR_HD V3 add3(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
PSDR_HD V3 sub3(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
PSDR_HD V3 scale3(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
PSDR_HD float dot3(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
PSDR_HD V3 cross3(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
PSDR_HD float safe_div(float a, float b) { return fabsf(b) > kTiny ? a / b : 0.0f; }
PSDR_HD float safe_sqrt(float x) { return x > 0.0f ? sqrtf(fmaxf(x, kTiny)) : 0.0f; }
PSDR_HD float safe_rsqrt(float x) {
  return x > 0.0f ? 1.0f / sqrtf(fmaxf(x, kTiny)) : 0.0f;
}
PSDR_HD V3 normalize3(V3 v) { return scale3(v, safe_rsqrt(dot3(v, v))); }
PSDR_HD float mis_weight(float p1, float p2) {
  const float w1 = p1 * p1;
  const float w2 = p2 * p2;
  return safe_div(w1, w1 + w2);
}

struct F4 {
  float x, y, z, w;
};

// Four uniforms of draw `cnt`: pcg4d(lane, cnt, seed, salt), top 24 bits.
PSDR_HD F4 draw(uint32_t lane, uint32_t cnt, uint32_t seed) {
  uint32_t v0 = lane * 1664525u + 1013904223u;
  uint32_t v1 = cnt * 1664525u + 1013904223u;
  uint32_t v2 = seed * 1664525u + 1013904223u;
  uint32_t v3 = kSalt * 1664525u + 1013904223u;
  v0 += v1 * v3;
  v1 += v2 * v0;
  v2 += v0 * v1;
  v3 += v1 * v2;
  v0 ^= v0 >> 16;
  v1 ^= v1 >> 16;
  v2 ^= v2 >> 16;
  v3 ^= v3 >> 16;
  v0 += v1 * v3;
  v1 += v2 * v0;
  v2 += v0 * v1;
  v3 += v1 * v2;
  const float s = 1.0f / 16777216.0f;
  return {static_cast<float>(v0 >> 8) * s, static_cast<float>(v1 >> 8) * s,
          static_cast<float>(v2 >> 8) * s, static_cast<float>(v3 >> 8) * s};
}

// Concentric-disk cosine-weighted hemisphere sample (warp.py:30-51), with
// Cephes' single-precision sin/cos polynomials for |phi| <= pi/4.
PSDR_HD V3 cosine_hemisphere(float u0, float u1) {
  const float x = 2.0f * u0 - 1.0f;
  const float y = 2.0f * u1 - 1.0f;
  const bool q13 = fabsf(x) < fabsf(y);
  const float r = q13 ? y : x;
  const float rp = q13 ? x : y;
  const float phi = kPiOver4 * safe_div(rp, r);
  const float z = phi * phi;
  const float sn = ((-1.9515295891e-4f * z + 8.3321608736e-3f) * z -
                    1.6666654611e-1f) * z * phi + phi;
  const float cs = ((2.443315711809948e-5f * z - 1.388731625493765e-3f) * z +
                    4.166664568298827e-2f) * z * z - 0.5f * z + 1.0f;
  const float px = r * (q13 ? sn : cs);
  const float py = r * (q13 ? cs : sn);
  return {px, py, safe_sqrt(1.0f - px * px - py * py)};
}

}  // namespace psdr
