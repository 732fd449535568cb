// The per-lane program of K7 (hit_rebuild.cu): the closest hit rebuilt from
// the closest-hit kernels' detached payload (tri_id, u, v), its forward-mode
// tangent and its adjoint. The plain PyTorch version is
// SceneData._rebuild_plain in psdr_jit_tpu_torch/scene/scene.py; forward
// AD and autograd of it are the plain versions of the tangent and the
// adjoint.
//
// The forward (rebuild<S, ...>) is written once, generic over its scalar:
// `float` gives the hit, `Dual` (a value and a tangent) the hit and its
// tangent along one direction of the tables and the rays. The float
// instance follows the plain version operation for operation (nvcc
// contracts nothing, -fmad=false), so the hit equals the plain version's bit
// for bit on the card. The one exception is `cross`: torch.linalg.cross
// evaluates a.y * b.z - a.z * b.y in one kernel that PyTorch's build lets
// nvcc contract, to fmaf(a.y, b.z, -(a.z * b.y)); cross() writes that fmaf.
//
// The adjoint (rebuild_adjoint) is the reverse sweep of the float program,
// written by hand with autograd's local derivatives:
//   safe_div(a, b)   -> 1 / b and -a / b^2 where |b| > 1e-20, else 0;
//   safe_sqrt(x)     -> 0.5 / sqrt(x) where x >= 1e-20, else 0;
//   safe_rsqrt(x)    -> -0.5 / sqrt(x)^3 where x >= 1e-20, else 0.
// The payload is detached: in path mode (u, v) are constants; in solid
// mode they are recomputed by Moller-Trumbore from the row and the ray and
// carry their derivatives. A miss (tri_id < 0) reads row 0, as the plain
// version's clamped gather does.
//
// Tables: `tab` (R, kCols) float rows p0, e1, e2, n0, n1, n2, face normal,
// face area; `ints` (R, kInts) int32 rows face-normal mask, mesh id, the
// face's three vertex ids in its mesh; `uvt` (R, 6) the face's corner UVs
// (scenes with UVs only), differentiable like `tab`.
#pragma once

#include "common.cuh"

namespace psdr {
namespace hit {

constexpr int kCols = 22;
constexpr int kP0 = 0, kE1 = 3, kE2 = 6, kN0 = 9, kN1 = 12, kN2 = 15, kFn = 18,
              kArea = 21;
constexpr int kInts = 5;

// A value and its tangent along one direction.
struct Dual {
  float v, d;
};
PSDR_HD Dual operator+(Dual a, Dual b) { return {a.v + b.v, a.d + b.d}; }
PSDR_HD Dual operator-(Dual a, Dual b) { return {a.v - b.v, a.d - b.d}; }
PSDR_HD Dual operator-(Dual a) { return {-a.v, -a.d}; }
PSDR_HD Dual operator*(Dual a, Dual b) { return {a.v * b.v, a.d * b.v + a.v * b.d}; }
PSDR_HD Dual operator/(Dual a, Dual b) {
  const float q = a.v / b.v;
  return {q, (a.d - q * b.d) / b.v};
}

PSDR_HD float val(float x) { return x; }
PSDR_HD float val(Dual x) { return x.v; }
template <class S>
PSDR_HD S cst(float x);
template <>
PSDR_HD float cst<float>(float x) { return x; }
template <>
PSDR_HD Dual cst<Dual>(float x) { return {x, 0.0f}; }
PSDR_HD float fma_(float a, float b, float c) { return fmaf(a, b, c); }
PSDR_HD Dual fma_(Dual a, Dual b, Dual c) {
  return {fmaf(a.v, b.v, c.v), a.d * b.v + a.v * b.d + c.d};
}
PSDR_HD float detach(float x) { return x; }
PSDR_HD Dual detach(Dual x) { return {x.v, 0.0f}; }

// safe_div, safe_sqrt, safe_rsqrt of core/math.py (common.cuh for floats)
PSDR_HD float sdiv(float a, float b) { return safe_div(a, b); }
PSDR_HD Dual sdiv(Dual a, Dual b) { return fabsf(b.v) > kTiny ? a / b : Dual{0.0f, 0.0f}; }
PSDR_HD float ssqrt(float x) { return safe_sqrt(x); }
PSDR_HD Dual ssqrt(Dual x) {
  if (!(x.v > 0.0f)) return {0.0f, 0.0f};
  const float s = sqrtf(fmaxf(x.v, kTiny));
  return {s, x.v >= kTiny ? x.d / (2.0f * s) : 0.0f};
}
PSDR_HD float srsqrt(float x) { return safe_rsqrt(x); }
PSDR_HD Dual srsqrt(Dual x) {
  if (!(x.v > 0.0f)) return {0.0f, 0.0f};
  const float s = sqrtf(fmaxf(x.v, kTiny));
  const float r = 1.0f / s;
  return {r, x.v >= kTiny ? -(x.d / (2.0f * s)) * r * r : 0.0f};
}

template <class S>
struct Vec {
  S x, y, z;
};
using V = Vec<float>;

template <class S>
PSDR_HD Vec<S> operator+(const Vec<S>& a, const Vec<S>& b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
template <class S>
PSDR_HD Vec<S> operator-(const Vec<S>& a, const Vec<S>& b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
template <class S>
PSDR_HD Vec<S> operator-(const Vec<S>& a) {
  return {-a.x, -a.y, -a.z};
}
template <class S>
PSDR_HD Vec<S> operator*(const Vec<S>& a, S s) {
  return {a.x * s, a.y * s, a.z * s};
}
template <class S>
PSDR_HD S dot(const Vec<S>& a, const Vec<S>& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
template <class S>
PSDR_HD Vec<S> cross(const Vec<S>& a, const Vec<S>& b) {
  return {fma_(a.y, b.z, -(a.z * b.y)), fma_(a.z, b.x, -(a.x * b.z)),
          fma_(a.x, b.y, -(a.y * b.x))};
}
template <class S>
PSDR_HD Vec<S> normalize(const Vec<S>& v) {
  return v * srsqrt(dot(v, v));
}
// p0 + e1 * u + e2 * v (core/math.py bilinear)
template <class S>
PSDR_HD Vec<S> bilinear(const Vec<S>& p0, const Vec<S>& e1, const Vec<S>& e2, S u, S v) {
  return (p0 + e1 * u) + e2 * v;
}
PSDR_HD void add_to(V& a, const V& b) { a = a + b; }
// the plain cross's adjoint: c = a x b gives a b x g and b g x a
PSDR_HD V cross_plain(const V& a, const V& b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

// One row of the float table, in S (with its tangent where S is Dual).
template <class S>
struct Row {
  Vec<S> p0, e1, e2, n0, n1, n2, fn;
  S area;
};

PSDR_HD V load3(const float* r, int c) { return {r[c], r[c + 1], r[c + 2]}; }

PSDR_HD Row<float> load_row(const float* r) {
  return {load3(r, kP0), load3(r, kE1), load3(r, kE2), load3(r, kN0),
          load3(r, kN1), load3(r, kN2), load3(r, kFn), r[kArea]};
}

// A row with its tangent row `rt` (nullptr: no tangent).
PSDR_HD Vec<Dual> dual3(const V& x, const float* rt, int c) {
  if (rt == nullptr) return {{x.x, 0.0f}, {x.y, 0.0f}, {x.z, 0.0f}};
  return {{x.x, rt[c]}, {x.y, rt[c + 1]}, {x.z, rt[c + 2]}};
}
PSDR_HD Row<Dual> dual_row(const float* r, const float* rt) {
  const Row<float> x = load_row(r);
  return {dual3(x.p0, rt, kP0), dual3(x.e1, rt, kE1), dual3(x.e2, rt, kE2),
          dual3(x.n0, rt, kN0), dual3(x.n1, rt, kN1), dual3(x.n2, rt, kN2),
          dual3(x.fn, rt, kFn), {x.area, rt == nullptr ? 0.0f : rt[kArea]}};
}

// A face's corner UVs (u0, v0, u1, v1, u2, v2), in S.
template <class S>
struct Corners {
  S c[6];
};

PSDR_HD Corners<float> load_corners(const float* r) {
  return {{r[0], r[1], r[2], r[3], r[4], r[5]}};
}
// with their tangents `rt` (nullptr: no tangent)
PSDR_HD Corners<Dual> dual_corners(const float* r, const float* rt) {
  Corners<Dual> x;
  for (int k = 0; k < 6; ++k) x.c[k] = {r[k], rt == nullptr ? 0.0f : rt[k]};
  return x;
}

// The rebuilt hit (Intersection's differentiable fields).
template <class S>
struct Hit {
  S t, J, u, v, iu, iv;  // (u, v): barycentrics; (iu, iv): texture coordinates
  Vec<S> p, s, tf, sn, wi, dpdu, dpdv;
};

// The hit of one lane: the row `r` (its face-normal mask `fn_mask`, corner
// UVs `uvt` where HasUV), the payload's barycentrics (pu, pv) and the ray
// (o, d; d is read in solid mode only).
template <class S, bool Solid, bool HasUV>
PSDR_HD Hit<S> rebuild(const Row<S>& r, bool fn_mask, const Corners<S>& uvt, float pu,
                       float pv, const Vec<S>& o, const Vec<S>& d) {
  Hit<S> h;
  Vec<S> wd;
  if (Solid) {
    // Moller-Trumbore on the hit row (core/math.py ray_intersect_triangle)
    const Vec<S> hh = cross(d, r.e2);
    const S a = dot(r.e1, hh);
    const S f = sdiv(cst<S>(1.0f), a);
    const Vec<S> s = o - r.p0;
    h.u = f * dot(s, hh);
    const Vec<S> q = cross(s, r.e1);
    h.v = f * dot(d, q);
    h.t = f * dot(r.e2, q);
    h.p = o + d * h.t;
    wd = -d;
    h.J = cst<S>(1.0f);
  } else {
    h.u = cst<S>(pu);
    h.v = cst<S>(pv);
    h.p = bilinear(r.p0, r.e1, r.e2, h.u, h.v);
    const Vec<S> dirv = h.p - o;
    h.t = ssqrt(dot(dirv, dirv));
    wd = -(dirv * sdiv(cst<S>(1.0f), h.t));
    h.J = sdiv(r.area, detach(r.area));
  }
  h.sn = fn_mask ? r.fn : normalize(bilinear(r.n0, r.n1 - r.n0, r.n2 - r.n0, h.u, h.v));
  // Frame.from_normal (types.py coordinate_system)
  const float sign = val(h.sn.z) >= 0.0f ? 1.0f : -1.0f;
  const S a = cst<S>(-1.0f) / (cst<S>(sign) + h.sn.z);
  const S b = (h.sn.x * h.sn.y) * a;
  h.s = {((cst<S>(sign) * h.sn.x) * h.sn.x) * a + cst<S>(1.0f), cst<S>(sign) * b,
         cst<S>(-sign) * h.sn.x};
  h.tf = {b, cst<S>(sign) + (h.sn.y * h.sn.y) * a, -h.sn.y};
  h.iu = h.iv = cst<S>(0.0f);
  const Vec<S> zero = {cst<S>(0.0f), cst<S>(0.0f), cst<S>(0.0f)};
  h.dpdu = h.dpdv = zero;
  if (HasUV) {
    const S* c = uvt.c;
    const S d0x = c[2] - c[0], d0y = c[3] - c[1];
    const S d1x = c[4] - c[0], d1y = c[5] - c[1];
    h.iu = (c[0] + d0x * h.u) + d1x * h.v;
    h.iv = (c[1] + d0y * h.u) + d1y * h.v;
    const S det = d0x * d1y - d0y * d1x;
    if (val(det) != 0.0f) {
      const S inv_det = sdiv(cst<S>(1.0f), det);
      h.dpdu = (r.e1 * d1y - r.e2 * d0y) * inv_det;
      h.dpdv = (r.e1 * (-d1x) + r.e2 * d0x) * inv_det;
      h.s = normalize(h.dpdu - h.sn * dot(h.sn, h.dpdu));
      h.tf = cross(h.sn, h.s);
    }
  }
  h.wi = {dot(wd, h.s), dot(wd, h.tf), dot(wd, h.sn)};
  return h;
}

// The cotangents of a hit's fields (zero where an output took none).
struct Cot {
  float t, J, u, v, iu, iv;
  V p, n, s, tf, sn, wi, dpdu, dpdv;
};

// d safe_rsqrt(x) / dx at x, whose root is s = sqrt(max(x, 1e-20)) and whose
// safe_rsqrt is r
PSDR_HD float rsqrt_slope(float x, float r) {
  if (!(x > 0.0f) || x < kTiny) return 0.0f;
  return -(r * r) / (2.0f * sqrtf(fmaxf(x, kTiny)));
}

// The adjoint of rebuild<float, Solid, HasUV> for the cotangents g: the
// row's cotangents into *gr (its fields zeroed first), the ray's into *go
// and *gd (gd in solid mode only), the corner UVs' into *gc where HasUV.
template <bool Solid, bool HasUV>
PSDR_HD void rebuild_adjoint(const Row<float>& r, bool fn_mask, const Corners<float>& uvt,
                             float pu, float pv, const V& o, const V& d, const Cot& g,
                             Row<float>* gr, V* go, V* gd, Corners<float>* gc) {
  const V zero = {0.0f, 0.0f, 0.0f};
  *gr = {zero, zero, zero, zero, zero, zero, zero, 0.0f};
  *go = zero;
  *gd = zero;
  *gc = Corners<float>{};
  // ---- forward, keeping what the sweep back needs
  float u, v, t, f = 0.0f, a_mt = 0.0f, du = 0.0f, dv = 0.0f, dt = 0.0f, inv = 0.0f,
                 sq = 0.0f;
  V hh = zero, s_ = zero, q = zero, dirv = zero, wd;
  if (Solid) {
    hh = cross(d, r.e2);
    a_mt = dot(r.e1, hh);
    f = safe_div(1.0f, a_mt);
    s_ = o - r.p0;
    du = dot(s_, hh);
    u = f * du;
    q = cross(s_, r.e1);
    dv = dot(d, q);
    v = f * dv;
    dt = dot(r.e2, q);
    t = f * dt;
    wd = -d;
  } else {
    u = pu;
    v = pv;
    dirv = bilinear(r.p0, r.e1, r.e2, u, v) - o;
    sq = dot(dirv, dirv);
    t = safe_sqrt(sq);
    inv = safe_div(1.0f, t);
    wd = -(dirv * inv);
  }
  const V dn1 = r.n1 - r.n0, dn2 = r.n2 - r.n0;
  const V shr = bilinear(r.n0, dn1, dn2, u, v);
  const float q2 = dot(shr, shr);
  const float rs = safe_rsqrt(q2);
  const V sn = fn_mask ? r.fn : shr * rs;
  const float sign = sn.z >= 0.0f ? 1.0f : -1.0f;
  const float a = -1.0f / (sign + sn.z);
  const float b = (sn.x * sn.y) * a;
  V s = {((sign * sn.x) * sn.x) * a + 1.0f, sign * b, -sign * sn.x};
  V tf = {b, sign + (sn.y * sn.y) * a, -sn.y};
  bool uv_frame = false;
  float d0x = 0.0f, d0y = 0.0f, d1x = 0.0f, d1y = 0.0f, det = 0.0f, inv_det = 0.0f, m = 0.0f,
        qw = 0.0f, rw = 0.0f;
  V dpdu = zero, w = zero;
  if (HasUV) {
    const float* c = uvt.c;
    d0x = c[2] - c[0];
    d0y = c[3] - c[1];
    d1x = c[4] - c[0];
    d1y = c[5] - c[1];
    det = d0x * d1y - d0y * d1x;
    uv_frame = det != 0.0f;
    if (uv_frame) {
      inv_det = safe_div(1.0f, det);
      dpdu = (r.e1 * d1y - r.e2 * d0y) * inv_det;
      m = dot(sn, dpdu);
      w = dpdu - sn * m;
      qw = dot(w, w);
      rw = safe_rsqrt(qw);
      s = w * rw;
      tf = cross(sn, s);
    }
  }
  // ---- the sweep back
  V g_s = g.s, g_tf = g.tf, g_sn = g.sn;
  const V g_wd = (s * g.wi.x + tf * g.wi.y) + sn * g.wi.z;
  add_to(g_s, wd * g.wi.x);
  add_to(g_tf, wd * g.wi.y);
  add_to(g_sn, wd * g.wi.z);
  float g_u = 0.0f, g_v = 0.0f;
  if (HasUV) {
    g_u += g.iu * d0x + g.iv * d0y;
    g_v += g.iu * d1x + g.iv * d1y;
    // iu = (u0 + d0x u) + d1x v, iv = (v0 + d0y u) + d1y v
    float g_d0x = g.iu * u, g_d0y = g.iv * u, g_d1x = g.iu * v, g_d1y = g.iv * v;
    if (uv_frame) {
      // tf = sn x s, s = w * rw, w = dpdu - sn * m, m = sn . dpdu
      add_to(g_sn, cross_plain(s, g_tf));
      const V g_s2 = g_s + cross_plain(g_tf, sn);
      V g_w = g_s2 * rw;
      add_to(g_w, w * (2.0f * dot(g_s2, w) * rsqrt_slope(qw, rw)));
      const float g_m = -dot(g_w, sn);
      add_to(g_sn, dpdu * g_m - g_w * m);
      const V g_dpdu = (g.dpdu + g_w) + sn * g_m;
      // dpdu = (e1 d1y - e2 d0y) inv_det, dpdv = (-e1 d1x + e2 d0x) inv_det
      gr->e1 = g_dpdu * (d1y * inv_det) + g.dpdv * (-d1x * inv_det);
      gr->e2 = g_dpdu * (-d0y * inv_det) + g.dpdv * (d0x * inv_det);
      g_s = g_tf = zero;
      // inv_det = safe_div(1, det), det = d0x d1y - d0y d1x
      const float g_inv = dot(g_dpdu, r.e1 * d1y - r.e2 * d0y) +
                          dot(g.dpdv, r.e2 * d0x - r.e1 * d1x);
      g_d1y += dot(g_dpdu, r.e1) * inv_det;
      g_d0y -= dot(g_dpdu, r.e2) * inv_det;
      g_d1x -= dot(g.dpdv, r.e1) * inv_det;
      g_d0x += dot(g.dpdv, r.e2) * inv_det;
      const float g_det = fabsf(det) > kTiny ? -g_inv * inv_det * inv_det : 0.0f;
      g_d0x += g_det * d1y;
      g_d1y += g_det * d0x;
      g_d0y -= g_det * d1x;
      g_d1x -= g_det * d0y;
    }
    // d0 = c1 - c0, d1 = c2 - c0
    *gc = {{(g.iu - g_d0x) - g_d1x, (g.iv - g_d0y) - g_d1y, g_d0x, g_d0y, g_d1x, g_d1y}};
  }
  if (!uv_frame) {
    // s, tf = coordinate_system(sn)
    const float g_b = sign * g_s.y + g_tf.x;
    const float g_a = g_s.x * ((sign * sn.x) * sn.x) + g_b * (sn.x * sn.y) +
                      g_tf.y * (sn.y * sn.y);
    add_to(g_sn, V{g_s.x * (2.0f * sign * sn.x * a) + g_b * (sn.y * a) - sign * g_s.z,
                   g_b * (sn.x * a) + g_tf.y * (2.0f * sn.y * a) - g_tf.z, g_a * (a * a)});
  }
  gr->fn = g.n;
  if (fn_mask) {
    add_to(gr->fn, g_sn);
  } else {
    V g_shr = g_sn * rs;
    add_to(g_shr, shr * (2.0f * dot(g_sn, shr) * rsqrt_slope(q2, rs)));
    gr->n0 = g_shr * ((1.0f - u) - v);
    gr->n1 = g_shr * u;
    gr->n2 = g_shr * v;
    g_u += dot(g_shr, dn1);
    g_v += dot(g_shr, dn2);
  }
  if (Solid) {
    g_u += g.u;
    g_v += g.v;
    // p = o + d t, wd = -d
    float g_t = g.t + dot(g.p, d);
    *go = g.p;
    *gd = g.p * t - g_wd;
    // u = f (s_ . hh), v = f (d . q), t = f (e2 . q)
    const float g_f = (g_u * du + g_v * dv) + g_t * dt;
    const float g_du = g_u * f, g_dv = g_v * f, g_dt = g_t * f;
    V g_s_ = hh * g_du;
    V g_hh = s_ * g_du;
    add_to(*gd, q * g_dv);
    const V g_q = d * g_dv + r.e2 * g_dt;
    add_to(gr->e2, q * g_dt);
    // q = s_ x e1
    add_to(g_s_, cross_plain(r.e1, g_q));
    add_to(gr->e1, cross_plain(g_q, s_));
    // f = safe_div(1, a_mt), a_mt = e1 . hh
    const float g_a = fabsf(a_mt) > kTiny ? -g_f * f * f : 0.0f;
    add_to(gr->e1, hh * g_a);
    add_to(g_hh, r.e1 * g_a);
    // s_ = o - p0
    add_to(*go, g_s_);
    gr->p0 = -g_s_;
    // hh = d x e2
    add_to(*gd, cross_plain(r.e2, g_hh));
    add_to(gr->e2, cross_plain(g_hh, d));
  } else {
    // wd = -(dirv * inv), inv = safe_div(1, t), t = safe_sqrt(sq)
    V g_dirv = g_wd * (-inv);
    const float g_inv = -dot(g_wd, dirv);
    float g_t = g.t;
    if (fabsf(t) > kTiny) g_t += g_inv * (-inv * inv);
    const float g_sq = (sq > 0.0f && sq >= kTiny) ? g_t / (2.0f * t) : 0.0f;
    add_to(g_dirv, dirv * (2.0f * g_sq));
    // dirv = p - o, p = p0 + e1 u + e2 v
    const V g_p = g.p + g_dirv;
    *go = -g_dirv;
    gr->p0 = g_p;
    add_to(gr->e1, g_p * u);
    add_to(gr->e2, g_p * v);
    // J = area / detach(area)
    gr->area = fabsf(r.area) > kTiny ? g.J / r.area : 0.0f;
  }
}

}  // namespace hit
}  // namespace psdr
