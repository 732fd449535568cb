// The closest-hit sweep: THE ray/triangle hit test and THE box slab test
// of the port, shared by K1 (intersect.cu), K2 (megakernel.cu), K5
// (intersect_super.cu) and K6 (bvh.cu) so that the epsilon, culling and tie
// policy cannot drift between them. Counterpart of sweep_block in
// psdr_jit_tpu/ops/intersect_pallas.py; its plain PyTorch version is
// sweep_plain in psdr_jit_tpu_torch/ops/intersect.py.
//
// Tables (one float per entry, component-major, staged in shared memory):
//   tri (9, f_pad):  p0.xyz, e1.xyz, e2.xyz of each triangle; f_pad is a
//                    multiple of kCluster, padded with degenerate triangles;
//   box (6, nc):     lower then upper corner of each 16-triangle cluster.
//
// Hit test (reference utils.h:83-93): Moller-Trumbore with |a| > 1e-12,
// u >= 0, v >= 0, u + v <= 1, t > RAY_EPSILON and t < best. Triangles are
// visited in ascending id and a hit must be strictly closer, so ties go to
// the lowest id, as in the plain version's argmin.
//
// Rounding. The cross and dot products are fused multiply-adds placed
// where the JAX package's CPU backend contracts the same expressions
// (LLVM fuses a * b + c where it can), so the port's hits are those of the
// reference bit for bit on the CPU; with plain multiply-adds about 10% of
// the t and 68% of the u values differed by an ulp there, and grazing
// self-intersection tests at RAY_EPSILON flipped on ~1% of the Cornell
// box's shadow rays. The plain version writes the same fmas.
//
// Culling. The TPU tests a cluster's box once for a tile of 8192 rays; here
// each ray tests it alone, which is stricter in two ways, and both are
// handled so that culling changes no hit:
//  * an axis-aligned ray has inv_d = +-inf, and (lo - o) * inv_d is NaN when
//    the origin lies on the slab plane; NaN would make tnear <= tfar false.
//    A NaN anywhere in the slab test therefore means "visit".
//  * f32 rounding of the slab test and of Moller-Trumbore's barycentrics
//    can put a reported hit a few ulps outside its cluster's box. Boxes are
//    widened by 1e-3 * (1 + |coordinate|) when they are staged.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace psdr {

constexpr float kInf = 1e30f;
constexpr float kRayEpsilon = 1e-3f;
constexpr int kCluster = 16;

struct Hit {
  float t;
  int id;
  float u;
  float v;
};

// Half-width added to each side of a box coordinate pair (lo, hi): the
// widening of the "Culling" note above. The plain versions widen their
// boxes with the same expression (ops/intersect.py widen_boxes).
__device__ __forceinline__ float box_margin(float lo, float hi) {
  return 1e-3f * (1.0f + fmaxf(fabsf(lo), fabsf(hi)));
}

// Cooperative copy of the triangle and (widened) box tables to shared
// memory. The caller synchronises the block afterwards.
__device__ __forceinline__ void stage_geometry(const float* __restrict__ tri_g,
                                               const float* __restrict__ box_g,
                                               int f_pad, float* s_tri,
                                               float* s_box) {
  const int nc = f_pad / kCluster;
  for (int k = threadIdx.x; k < 9 * f_pad; k += blockDim.x) s_tri[k] = tri_g[k];
  for (int k = threadIdx.x; k < 3 * nc; k += blockDim.x) {
    const float lo = box_g[k];
    const float hi = box_g[3 * nc + k];
    const float m = box_margin(lo, hi);
    s_box[k] = lo - m;
    s_box[3 * nc + k] = hi + m;
  }
}

// THE slab test of a (widened) box: may a hit closer than `best` lie in
// it? A NaN anywhere (origin on a slab plane of an axis-aligned ray)
// means "visit". inv = 1 / d per component.
__device__ __forceinline__ bool box_visit(float lox, float loy, float loz,
                                          float hix, float hiy, float hiz,
                                          float ox, float oy, float oz,
                                          float ix, float iy, float iz,
                                          float best) {
  const float tx0 = (lox - ox) * ix;
  const float tx1 = (hix - ox) * ix;
  const float ty0 = (loy - oy) * iy;
  const float ty1 = (hiy - oy) * iy;
  const float tz0 = (loz - oz) * iz;
  const float tz1 = (hiz - oz) * iz;
  const bool undecided = isnan(tx0) || isnan(tx1) || isnan(ty0) ||
                         isnan(ty1) || isnan(tz0) || isnan(tz1);
  const float tnear =
      fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
  const float tfar =
      fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
  return undecided || (tnear <= tfar && tfar > 0.0f && tnear < best);
}

// THE hit test of one triangle (p0, e1, e2): replaces h when it is hit
// strictly closer than h.t.
__device__ __forceinline__ void hit_test(Hit& h, int id, float p0x, float p0y,
                                         float p0z, float e1x, float e1y,
                                         float e1z, float e2x, float e2y,
                                         float e2z, float ox, float oy,
                                         float oz, float dx, float dy,
                                         float dz) {
  const float hx = fmaf(dy, e2z, -(dz * e2y));
  const float hy = fmaf(dz, e2x, -(dx * e2z));
  const float hz = fmaf(dx, e2y, -(dy * e2x));
  const float a = fmaf(e1z, hz, fmaf(e1x, hx, e1y * hy));
  const float f = 1.0f / a;  // inf at a = 0; masked by the test below
  const float sx = ox - p0x, sy = oy - p0y, sz = oz - p0z;
  const float u = f * fmaf(sz, hz, fmaf(sy, hy, sx * hx));
  const float qx = fmaf(sy, e1z, -(sz * e1y));
  const float qy = fmaf(sz, e1x, -(sx * e1z));
  const float qz = fmaf(sx, e1y, -(sy * e1x));
  const float v = f * fmaf(dz, qz, fmaf(dx, qx, dy * qy));
  const float t = f * fmaf(e2z, qz, fmaf(e2x, qx, e2y * qy));
  if (fabsf(a) > 1e-12f && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
      t > kRayEpsilon && t < h.t) {
    h.t = t;
    h.id = id;
    h.u = u;
    h.v = v;
  }
}

// Sweep a (9, stride) triangle table and its (6, stride / 16) box table,
// both staged, into the running hit h; triangle j has the id base + j.
__device__ __forceinline__ void sweep_into(Hit& h, const float* __restrict__ tri,
                                           const float* __restrict__ box,
                                           int stride, int base, float ox,
                                           float oy, float oz, float dx,
                                           float dy, float dz) {
  const int nc = stride / kCluster;
  const float ix = 1.0f / dx;
  const float iy = 1.0f / dy;
  const float iz = 1.0f / dz;
  for (int c = 0; c < nc; ++c) {
    if (!box_visit(box[c], box[nc + c], box[2 * nc + c], box[3 * nc + c],
                   box[4 * nc + c], box[5 * nc + c], ox, oy, oz, ix, iy, iz,
                   h.t))
      continue;
    for (int j = c * kCluster; j < (c + 1) * kCluster; ++j)
      hit_test(h, base + j, tri[j], tri[stride + j], tri[2 * stride + j],
               tri[3 * stride + j], tri[4 * stride + j], tri[5 * stride + j],
               tri[6 * stride + j], tri[7 * stride + j], tri[8 * stride + j],
               ox, oy, oz, dx, dy, dz);
  }
}

__device__ __forceinline__ Hit sweep(const float* __restrict__ tri,
                                     const float* __restrict__ box, int f_pad,
                                     float ox, float oy, float oz, float dx,
                                     float dy, float dz) {
  Hit h{kInf, -1, 0.0f, 0.0f};
  sweep_into(h, tri, box, f_pad, 0, ox, oy, oz, dx, dy, dz);
  if (!(h.t < kInf)) h.id = -1;
  return h;
}

}  // namespace psdr
