// The closest-hit sweep: THE ray/triangle hit test and THE box slab test
// of the port, shared by K2 (megakernel.cu) and by the walk of K1, K5 and
// K6 (bvh.cu) so that the epsilon, culling and tie policy cannot drift
// between them. Counterpart of sweep_block in
// psdr_jit_tpu/ops/intersect_pallas.py; the plain PyTorch version of the
// test is hit_test in psdr_jit_tpu_torch/ops/intersect.py, of the unculled
// sweep sweep_plain there. K2 runs its two culled sweeps (sweep_grouped,
// sweep_queued), the walk a tree.
//
// Tables of K2's sweeps: rows of three float4 a triangle and two float4 a
// box (see "K2's two-level sweep" below), staged in shared memory.
//
// Hit test (reference utils.h:83-93): Moller-Trumbore with |a| > 1e-12,
// u >= 0, v >= 0, u + v <= 1, t > RAY_EPSILON and t < best. K2's sweeps
// visit triangles in ascending id and a hit must be strictly closer, so
// ties go to the lowest id, as in the plain version's argmin. The walk,
// whose tree visits triangles in no fixed order, keeps the same hit with
// its own variants (hit_test_any_order, box_enter).
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
//    can put a reported hit a few ulps outside its box. Boxes are widened
//    by 1e-3 * (1 + |coordinate|) when they are built or staged.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace psdr {

constexpr float kInf = 1e30f;
constexpr float kRayEpsilon = 1e-3f;
constexpr int kCluster = 16;
constexpr int kWarp = 32;
constexpr unsigned kFullWarp = 0xffffffffu;

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

// Moller-Trumbore of one triangle (p0, e1, e2): true when the ray hits it
// at t > RAY_EPSILON, with (t, u, v) written out.
__device__ __forceinline__ bool triangle_hit(float p0x, float p0y, float p0z,
                                             float e1x, float e1y, float e1z,
                                             float e2x, float e2y, float e2z,
                                             float ox, float oy, float oz,
                                             float dx, float dy, float dz,
                                             float* t_out, float* u_out,
                                             float* v_out) {
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
  *t_out = t;
  *u_out = u;
  *v_out = v;
  return fabsf(a) > 1e-12f && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
         t > kRayEpsilon;
}

// THE hit test of one triangle (p0, e1, e2): replaces h when it is hit
// strictly closer than h.t.
__device__ __forceinline__ void hit_test(Hit& h, int id, float p0x, float p0y,
                                         float p0z, float e1x, float e1y,
                                         float e1z, float e2x, float e2y,
                                         float e2z, float ox, float oy,
                                         float oz, float dx, float dy,
                                         float dz) {
  float t, u, v;
  if (triangle_hit(p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z, ox, oy, oz, dx,
                   dy, dz, &t, &u, &v) &&
      t < h.t) {
    h.t = t;
    h.id = id;
    h.u = u;
    h.v = v;
  }
}

// K6's hit test, for a traversal that visits triangles in no fixed order:
// the hit replaces h when its (t, id) is lexicographically smaller. The
// ascending sweep with a strict t < best keeps the lowest id of equal
// distances; this rule picks the same hit whatever the order.
__device__ __forceinline__ void hit_test_any_order(
    Hit& h, int id, float p0x, float p0y, float p0z, float e1x, float e1y,
    float e1z, float e2x, float e2y, float e2z, float ox, float oy, float oz,
    float dx, float dy, float dz) {
  float t, u, v;
  if (triangle_hit(p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z, ox, oy, oz, dx,
                   dy, dz, &t, &u, &v) &&
      (t < h.t || (t == h.t && id < h.id))) {
    h.t = t;
    h.id = id;
    h.u = u;
    h.v = v;
  }
}

// K6's slab test: box_visit with tnear <= best, so that a box holding a
// hit at exactly `best` with a lower id is still entered, and with tnear
// reported through *tnear_out (-inf where the test is undecided) for the
// nearer-first order and for culling a stacked box against a later best.
__device__ __forceinline__ bool box_enter(float lox, float loy, float loz,
                                          float hix, float hiy, float hiz,
                                          float ox, float oy, float oz,
                                          float ix, float iy, float iz,
                                          float best, float* tnear_out) {
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
  *tnear_out = undecided ? __int_as_float(0xff800000) : tnear;  // -inf
  return undecided || (tnear <= tfar && tfar > 0.0f && tnear <= best);
}

// ---- K2's two-level sweep over a vector-loaded table ----------------------
//
// K2 stages its triangles as rows of three float4, (p0.x p0.y p0.z e1.x)
// (e1.y e1.z e2.x e2.y) (e2.z 0 0 0), read with three 128-bit shared loads
// a test, and its boxes as two float4, (lo.xyz 0) (hi.xyz 0), widened. Each
// 16-triangle cluster's box is tested, then inside a visited cluster the
// box of each run of G consecutive triangles (none at G = 16), then the
// run's triangles: in ascending id, with THE hit test and its strict
// t < best. All 32 lanes of a warp call it together, and the culling is
// decided for the warp: a box is entered when any lane that
// needs a hit enters it, so the warp never diverges on a box, and a lane
// may test triangles its own box test would have skipped. This pays where
// a warp's rays are coherent and skip most runs together (see
// csrc/megakernel.cu). Neither changes a hit: the widened boxes cull no
// hit, and an extra test finds none that the unculled sweep does not. The
// plain version is sweep_grouped_plain in psdr_jit_tpu_torch/ops/intersect.py.

// Widened box of rows [first, first + count) of a row-staged table, as
// group_boxes in psdr_jit_tpu_torch/ops/intersect.py computes it.
__device__ __forceinline__ void row_box(const float4* __restrict__ tri, int first,
                                        int count, float4* out) {
  float lo[3] = {kInf * 10.0f, kInf * 10.0f, kInf * 10.0f};
  float hi[3] = {-kInf * 10.0f, -kInf * 10.0f, -kInf * 10.0f};
  for (int k = first; k < first + count; ++k) {
    const float4 a = tri[3 * k], b = tri[3 * k + 1], c = tri[3 * k + 2];
    const float p0[3] = {a.x, a.y, a.z};
    const float e1[3] = {a.w, b.x, b.y};
    const float e2[3] = {b.z, b.w, c.x};
    for (int q = 0; q < 3; ++q) {
      const float v1 = p0[q] + e1[q];
      const float v2 = p0[q] + e2[q];
      lo[q] = fminf(lo[q], fminf(fminf(p0[q], v1), v2));
      hi[q] = fmaxf(hi[q], fmaxf(fmaxf(p0[q], v1), v2));
    }
  }
  float m[3];
  for (int q = 0; q < 3; ++q) m[q] = box_margin(lo[q], hi[q]);
  out[0] = make_float4(lo[0] - m[0], lo[1] - m[1], lo[2] - m[2], 0.0f);
  out[1] = make_float4(hi[0] + m[0], hi[1] + m[1], hi[2] + m[2], 0.0f);
}

// K2's table staged in shared memory from the packed (9, f_pad) triangle and
// (6, f_pad / 16) cluster-box tables of ops/intersect.py pack_triangles: each
// triangle as three float4 rows, each cluster's box and each G-triangle
// run's box (row_box), widened. Used by K2 (megakernel.cu) and by K1's
// sweep (intersect.cu); synchronises the block twice.
template <int G>
__device__ __forceinline__ void stage_table(const float* __restrict__ tri_g,
                                            const float* __restrict__ box_g, int f_pad,
                                            float4* s_tri, float4* s_cbox,
                                            float4* s_gbox) {
  const int nc = f_pad / kCluster;
  float* rows = reinterpret_cast<float*>(s_tri);
  for (int k = threadIdx.x; k < 12 * f_pad; k += blockDim.x) {
    const int j = k / 12, q = k % 12;
    rows[k] = q < 9 ? tri_g[q * f_pad + j] : 0.0f;
  }
  for (int k = threadIdx.x; k < nc; k += blockDim.x) {
    float lo[3], hi[3];
    for (int q = 0; q < 3; ++q) {
      lo[q] = box_g[q * nc + k];
      hi[q] = box_g[(3 + q) * nc + k];
      const float m = box_margin(lo[q], hi[q]);
      lo[q] -= m;
      hi[q] += m;
    }
    s_cbox[2 * k] = make_float4(lo[0], lo[1], lo[2], 0.0f);
    s_cbox[2 * k + 1] = make_float4(hi[0], hi[1], hi[2], 0.0f);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < f_pad / G; k += blockDim.x)
    row_box(s_tri, k * G, G, s_gbox + 2 * k);
  __syncthreads();
}

// box_visit of a staged box. `checked`: some ray of the warp has a
// non-finite origin or inverse direction (an axis-aligned ray has
// inv = +-inf); otherwise (lo - o) * inv is finite or infinite but never
// NaN, box_visit's NaN check cannot fire, and the test leaves it out: the
// same decision in fewer instructions.
__device__ __forceinline__ bool box_visit4(const float4* __restrict__ b, float ox,
                                           float oy, float oz, float ix, float iy,
                                           float iz, float best, bool checked) {
  const float4 lo = b[0], hi = b[1];
  if (checked)
    return box_visit(lo.x, lo.y, lo.z, hi.x, hi.y, hi.z, ox, oy, oz, ix, iy, iz, best);
  const float tx0 = (lo.x - ox) * ix;
  const float tx1 = (hi.x - ox) * ix;
  const float ty0 = (lo.y - oy) * iy;
  const float ty1 = (hi.y - oy) * iy;
  const float tz0 = (lo.z - oz) * iz;
  const float tz1 = (hi.z - oz) * iz;
  const float tnear =
      fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
  const float tfar =
      fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
  return tnear <= tfar && tfar > 0.0f && tnear < best;
}

// The `checked` of box_visit4 for a warp: does any lane that needs a hit
// have a non-finite origin or inverse direction?
__device__ __forceinline__ bool warp_checked(bool need, float ox, float oy, float oz,
                                             float ix, float iy, float iz) {
  return __any_sync(kFullWarp, need && !(isfinite(ix) && isfinite(iy) && isfinite(iz) &&
                                         isfinite(ox) && isfinite(oy) && isfinite(oz)));
}

// What one of K2's sweeps ran, for K2's counting build (PSDR_K2_COUNTS
// defined, csrc/megakernel.cu): the box tests and the (ray, triangle) tests
// the warp ran, the same in every lane. PSDR_TALLY adds to it there and
// does nothing, not even evaluate its arguments, in any other build.
struct Tally {
  unsigned box = 0;
  unsigned tri = 0;
};
#ifdef PSDR_K2_COUNTS
#define PSDR_TALLY(t, n_box, n_tri) ((t).box += (n_box), (t).tri += (n_tri))
#else
#define PSDR_TALLY(t, n_box, n_tri) ((void)(t))
#endif

template <int G>
__device__ __forceinline__ Hit sweep_grouped(const float4* __restrict__ tri,
                                             const float4* __restrict__ cbox,
                                             const float4* __restrict__ gbox, int nc,
                                             bool need, float ox, float oy, float oz,
                                             float dx, float dy, float dz, Tally& tally) {
  static_assert(kCluster % G == 0, "runs tile a cluster");
  constexpr int kRuns = kCluster / G;
  Hit h{kInf, -1, 0.0f, 0.0f};
  const float ix = 1.0f / dx;
  const float iy = 1.0f / dy;
  const float iz = 1.0f / dz;
  const bool checked = warp_checked(need, ox, oy, oz, ix, iy, iz);
  for (int c = 0; c < nc; ++c) {
    PSDR_TALLY(tally, __any_sync(kFullWarp, need) ? 1u : 0u, 0u);
    const bool in_c =
        need && box_visit4(cbox + 2 * c, ox, oy, oz, ix, iy, iz, h.t, checked);
    if (!__any_sync(kFullWarp, in_c)) continue;
#pragma unroll 1
    for (int j = c * kRuns; j < (c + 1) * kRuns; ++j) {
      PSDR_TALLY(tally, kRuns > 1 ? 1u : 0u, 0u);
      const bool in_j = kRuns == 1 || (need && box_visit4(gbox + 2 * j, ox, oy, oz, ix,
                                                          iy, iz, h.t, checked));
      if (!__any_sync(kFullWarp, in_j)) continue;
      PSDR_TALLY(tally, 0u, static_cast<unsigned>(G));
#pragma unroll
      for (int k = j * G; k < (j + 1) * G; ++k) {
        const float4 a = tri[3 * k], b = tri[3 * k + 1], e = tri[3 * k + 2];
        hit_test(h, k, a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, e.x, ox, oy, oz, dx,
                 dy, dz);
      }
    }
  }
  if (!(h.t < kInf) || !need) h = Hit{kInf, -1, 0.0f, 0.0f};
  return h;
}

// ---- K2's compacted sweep for scattered rays --------------------------------
//
// Where a warp's rays scatter, the warp-decided culling above tests nearly
// every run for every lane. Here each lane tests its own ray against the
// boxes (clusters, then the runs of a visited cluster, with no closest hit
// to cull against yet), and the warp queues the (ray, run) pairs the lanes
// enter and tests them 32 at a time, one pair a lane: the warp runs the
// tests its lanes need, not their union. A pair's closest hit goes into
// its ray's slot with an atomic minimum of the key (t bits, id), which is
// (t, id) in lexicographic order because t > 0: the least t, the lowest id
// at equal t, as the ascending sweep's strict t < best keeps. The winning
// triangle is then tested once more by its own lane for (t, u, v), the
// same arithmetic as the test that found it. Culling with widened boxes
// removes no hit, so the hits are the unculled sweep's bit for bit.

// One warp's scratch in shared memory.
struct WarpQueue {
  float4 ray[kWarp][2];            // origin, direction of each lane's ray
  unsigned long long best[kWarp];  // (t bits, id) of each ray's closest hit
  int item[2 * kWarp];             // queued (ray, run) pairs: lane << 8 | run
};

__device__ __forceinline__ unsigned long long hit_key(float t, int id) {
  return (static_cast<unsigned long long>(__float_as_uint(t)) << 32) |
         static_cast<unsigned>(id);
}

// Test the queued pairs [0, count), one a lane.
template <int G>
__device__ __forceinline__ void test_queued(const float4* __restrict__ tri, WarpQueue& q,
                                            int lane, int count) {
  if (lane < count) {
    const int item = q.item[lane];
    const int r = item >> 8, j = item & 255;
    const float4 o = q.ray[r][0], d = q.ray[r][1];
    Hit h{kInf, -1, 0.0f, 0.0f};
#pragma unroll
    for (int k = j * G; k < (j + 1) * G; ++k) {
      const float4 a = tri[3 * k], b = tri[3 * k + 1], e = tri[3 * k + 2];
      hit_test(h, k, a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, e.x, o.x, o.y, o.z, d.x,
               d.y, d.z);
    }
    if (h.id >= 0) atomicMin(&q.best[r], hit_key(h.t, h.id));
  }
  __syncwarp();
}

// All 32 lanes of the warp call it together; `need`: this lane's ray is
// swept (a lane that needs no hit gets a miss). Runs are numbered below
// 256 (f_pad / G <= 256).
template <int G>
__device__ __forceinline__ Hit sweep_queued(const float4* __restrict__ tri,
                                            const float4* __restrict__ cbox,
                                            const float4* __restrict__ gbox, int nc,
                                            WarpQueue& q, bool need, float ox, float oy,
                                            float oz, float dx, float dy, float dz,
                                            Tally& tally) {
  static_assert(kCluster % G == 0, "runs tile a cluster");
  constexpr int kRuns = kCluster / G;
  const int lane = threadIdx.x & (kWarp - 1);
  const unsigned below = (1u << lane) - 1u;
  q.ray[lane][0] = make_float4(ox, oy, oz, 0.0f);
  q.ray[lane][1] = make_float4(dx, dy, dz, 0.0f);
  q.best[lane] = ~0ull;
  __syncwarp();
  const float ix = 1.0f / dx;
  const float iy = 1.0f / dy;
  const float iz = 1.0f / dz;
  const bool checked = warp_checked(need, ox, oy, oz, ix, iy, iz);
  int pending = 0;  // the same in every lane
  for (int c = 0; c < nc; ++c) {
    PSDR_TALLY(tally, __any_sync(kFullWarp, need) ? 1u : 0u, 0u);
    const bool in_c =
        need && box_visit4(cbox + 2 * c, ox, oy, oz, ix, iy, iz, kInf, checked);
    if (!__any_sync(kFullWarp, in_c)) continue;
#pragma unroll 1
    for (int j = c * kRuns; j < (c + 1) * kRuns; ++j) {
      PSDR_TALLY(tally, kRuns > 1 ? 1u : 0u, 0u);
      const bool in_j = in_c && (kRuns == 1 || box_visit4(gbox + 2 * j, ox, oy, oz, ix,
                                                          iy, iz, kInf, checked));
      const unsigned m = __ballot_sync(kFullWarp, in_j);
      if (in_j) q.item[pending + __popc(m & below)] = lane << 8 | j;
      pending += __popc(m);
      __syncwarp();
      if (pending >= kWarp) {
        PSDR_TALLY(tally, 0u, static_cast<unsigned>(G));
        test_queued<G>(tri, q, lane, kWarp);
        pending -= kWarp;
        const int moved = lane < pending ? q.item[kWarp + lane] : 0;
        __syncwarp();
        if (lane < pending) q.item[lane] = moved;
        __syncwarp();
      }
    }
  }
  PSDR_TALLY(tally, 0u, pending > 0 ? static_cast<unsigned>(G) : 0u);
  test_queued<G>(tri, q, lane, pending);
  Hit h{kInf, -1, 0.0f, 0.0f};
  const unsigned long long key = q.best[lane];
  PSDR_TALLY(tally, 0u, __any_sync(kFullWarp, key != ~0ull) ? 1u : 0u);
  if (key != ~0ull) {
    const int k = static_cast<int>(key & 0xffffffffu);
    const float4 a = tri[3 * k], b = tri[3 * k + 1], e = tri[3 * k + 2];
    hit_test(h, k, a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, e.x, ox, oy, oz, dx, dy, dz);
  }
  __syncwarp();
  return h;
}

// A hit, or a miss, written to the outputs t, id, uv of ray i.
__device__ __forceinline__ void store_hit(const Hit& h, long long i, float* t, int* id,
                                          float* uv) {
  t[i] = h.t;
  id[i] = h.id;
  uv[2 * i] = h.u;
  uv[2 * i + 1] = h.v;
}

}  // namespace psdr
