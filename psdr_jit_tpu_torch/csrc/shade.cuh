// The per-lane program of K3 (the attached interior Li) and of K4 (its
// adjoint, written by hand), shared by the kernels of shade.cu. The plain
// PyTorch version is li_attached_plain in psdr_jit_tpu_torch/ops/shade_mega.py
// (a transcription of _li_attached, psdr_jit_tpu/ops/shade_mega.py:208-387);
// the forward below follows it operation for operation, and the adjoint is
// the reverse sweep of that program with autograd's local derivatives:
//   safe_div(a, b)   -> a / b and -a / b^2 where |b| > 1e-20, else 0;
//   safe_sqrt(x)     -> 0.5 / sqrt(x) where x >= 1e-20, else 0;
//   safe_rsqrt(x)    -> -0.5 / sqrt(x)^3 where x >= 1e-20, else 0;
//   clamp(x, 0, 1)   -> 1 on [0, 1], else 0;  |x| -> sign(x), 0 at 0.
// Every stop_gradient of the JAX program is a constant here: the payload
// (hit ids, barycentrics) and the face-normal-mask and emitter flags, the
// light's area in the sampling Jacobian (mesh.py:407), the NEE pdf and its
// MIS weight (shade_mega.py:326-331), the bounce pdf (sg(g2), :355), the
// bounce's `wi_z > 0` test (:358) and the detached light pdf (misc[3],
// :230). Where such a quantity multiplies an attached one, only the
// attached factor receives a cotangent.
//
// Depth is a template parameter (0..3) of the adjoint: for each depth, last
// first, it recomputes that depth's inputs and locals (depth_forward) and
// sweeps back through them (depth_backward), then the camera hit.
//
// Tables: `table` (F, 30) row-major with the JAX package's ROW_* columns,
// `light` (12, L), `misc` (8). A miss reads row 0, as the JAX package's
// gather does; the masks keep it out of every value and cotangent.
#pragma once

#include "common.cuh"

namespace psdr {
namespace shade {

constexpr int kRows = 30;
constexpr int kLightRows = 12;
constexpr int kMisc = 8;
constexpr int kP0 = 0, kE1 = 3, kE2 = 6, kN0 = 9, kN1 = 12, kN2 = 15, kFn = 18;
constexpr int kArea = 21, kFnMask = 22, kAlb = 23, kEmit = 26, kIsEm = 29;

PSDR_HD V3 row3(const float* r, int c) { return {r[c], r[c + 1], r[c + 2]}; }
PSDR_HD V3 mul3(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
PSDR_HD float comp(V3 v, int k) { return k == 0 ? v.x : (k == 1 ? v.y : v.z); }
PSDR_HD void add_comp(V3& v, int k, float s) {
  if (k == 0) v.x += s; else if (k == 1) v.y += s; else v.z += s;
}
PSDR_HD float sgn(float x) { return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f); }

#ifdef __CUDA_ARCH__
// Sums s[] over `grp`, the lanes among the active lanes `act` of this warp
// that add to the same address, by a pointer jump along each group's lanes
// (log2 of the largest group's size steps, the same count in every lane of
// act, as the shuffles need): afterwards the lowest lane of grp holds the
// group's sums.
template <int N>
__device__ __forceinline__ void group_sum(unsigned act, unsigned grp, float (&s)[N]) {
  const int lane = static_cast<int>(threadIdx.x & 31u);
  const unsigned above = grp & ~((2u << lane) - 1u);
  int nxt = above != 0u ? __ffs(above) - 1 : -1;  // the group's next lane
  const unsigned most = __reduce_max_sync(act, static_cast<unsigned>(__popc(grp)));
  for (unsigned k = 1; k < most; k <<= 1) {
    const int src = nxt >= 0 ? nxt : lane;
#pragma unroll
    for (int c = 0; c < N; ++c) {
      const float w = __shfl_sync(act, s[c], src);
      if (nxt >= 0) s[c] += w;
    }
    const int far = __shfl_sync(act, nxt, src);
    nxt = nxt >= 0 ? far : -1;
  }
}
#endif

// Adds v[c] to p[c * stride]. On the card the active lanes of the warp that
// add to the same p (a pixel's 32 samples on their camera hit, NEE on one
// light triangle) are summed first, and each group's lowest lane adds the
// sums with one atomic an entry. A call where every lane adds zeros adds
// nothing.
template <int N>
PSDR_HD void group_add(float* p, int stride, const float (&v)[N]) {
#ifdef __CUDA_ARCH__
  const unsigned act = __activemask();
  bool nonzero = false;
#pragma unroll
  for (int c = 0; c < N; ++c) nonzero = nonzero || v[c] != 0.0f;
  if (!__any_sync(act, nonzero)) return;
  // the shared-memory partials lie in one window: the low 32 bits of the
  // address tell them apart
  const unsigned grp =
      __match_any_sync(act, static_cast<unsigned>(reinterpret_cast<uintptr_t>(p)));
  float s[N];
#pragma unroll
  for (int c = 0; c < N; ++c) s[c] = v[c];
  group_sum<N>(act, grp, s);
  if (static_cast<int>(threadIdx.x & 31u) != __ffs(grp) - 1) return;
#pragma unroll
  for (int c = 0; c < N; ++c) {
    if (s[c] != 0.0f) atomicAdd(&p[c * stride], s[c]);
  }
#else
  for (int c = 0; c < N; ++c) {
    if (v[c] != 0.0f) p[c * stride] += v[c];
  }
#endif
}

// Where the cotangents of the tables go (block partials in K4). Lanes that
// add into the same table row, light column or misc entry at the same call
// are summed across the warp first (group_add): the 32 samples of a pixel
// share their camera hit, and NEE hits fall on the same light triangles,
// so lane-by-lane shared-memory atomics on those addresses serialised.
struct Grads {
  float* table;
  float* light;
  float* misc;
  int n_light;
  // columns col .. col + N - 1 of a table row
  template <int N>
  PSDR_HD void tab_n(int row, int col, const float (&v)[N]) const {
    group_add<N>(&table[row * kRows + col], 1, v);
  }
  PSDR_HD void tab(int row, int col, float v) const {
    const float a[1] = {v};
    tab_n<1>(row, col, a);
  }
  PSDR_HD void tab3(int row, int col, V3 v) const {
    const float a[3] = {v.x, v.y, v.z};
    tab_n<3>(row, col, a);
  }
  // three consecutive 3-vectors from column col (p0, e1, e2 or n0, n1, n2)
  PSDR_HD void tab9(int row, int col, V3 a, V3 b, V3 c) const {
    const float v[9] = {a.x, a.y, a.z, b.x, b.y, b.z, c.x, c.y, c.z};
    tab_n<9>(row, col, v);
  }
  PSDR_HD void lig(int r, int j, float v) const {
    const float a[1] = {v};
    group_add<1>(&light[r * n_light + j], 1, a);
  }
  // light rows r .. r + 8 of column j (the sampled point's p0, e1, e2)
  PSDR_HD void lig9(int r, int j, V3 a, V3 b, V3 c) const {
    const float v[9] = {a.x, a.y, a.z, b.x, b.y, b.z, c.x, c.y, c.z};
    group_add<9>(&light[r * n_light + j], n_light, v);
  }
  PSDR_HD void mis(int k, float v) const {
    const float a[1] = {v};
    group_add<1>(&misc[k], 1, a);
  }
};

// One stashed hit: its table row (row 0 for a miss) and detached payload.
struct Hit {
  const float* r;
  int row;
  bool valid;
  float u, v;
  PSDR_HD bool fnmask() const { return r[kFnMask] > 0.5f; }
  PSDR_HD bool isem() const { return r[kIsEm] > 0.5f; }
};

PSDR_HD Hit load_hit(const float* table, int id, float u, float v) {
  const int row = id < 0 ? 0 : id;
  return {table + row * kRows, row, id >= 0, u, v};
}

// p0 + e1 * u + e2 * v (the path-space hit point)
PSDR_HD V3 hit_point(const Hit& h) {
  const V3 p0 = row3(h.r, kP0), e1 = row3(h.r, kE1), e2 = row3(h.r, kE2);
  return {p0.x + e1.x * h.u + e2.x * h.v, p0.y + e1.y * h.u + e2.y * h.v,
          p0.z + e1.z * h.u + e2.z * h.v};
}

// Interpolated shading normal before normalization.
PSDR_HD V3 raw_normal(const Hit& h, float u, float v) {
  const V3 n0 = row3(h.r, kN0), n1 = row3(h.r, kN1), n2 = row3(h.r, kN2);
  return {n0.x + (n1.x - n0.x) * u + (n2.x - n0.x) * v,
          n0.y + (n1.y - n0.y) * u + (n2.y - n0.y) * v,
          n0.z + (n1.z - n0.z) * u + (n2.z - n0.z) * v};
}

PSDR_HD V3 shading_normal(const Hit& h, float u, float v) {
  return h.fnmask() ? row3(h.r, kFn) : normalize3(raw_normal(h, u, v));
}

// Adjoint of shading_normal for the cotangent g; returns (du, dv) of the
// barycentrics through *du, *dv (camera hit only; the payload is detached).
PSDR_HD void shading_normal_bwd(const Hit& h, float u, float v, V3 g, const Grads& gr,
                                float* du, float* dv) {
  if (h.fnmask()) {
    gr.tab3(h.row, kFn, g);
    return;
  }
  const V3 n = raw_normal(h, u, v);
  const float n2 = dot3(n, n);
  const float inv = safe_rsqrt(n2);
  float d_n2 = 0.0f;
  if (n2 >= kTiny) d_n2 = dot3(g, n) * (-0.5f * inv * inv * inv);
  const V3 dn = add3(scale3(g, inv), scale3(n, 2.0f * d_n2));
  const float w0 = 1.0f - u - v;
  gr.tab9(h.row, kN0, scale3(dn, w0), scale3(dn, u), scale3(dn, v));
  if (du != nullptr) {
    const V3 n0 = row3(h.r, kN0);
    *du += dot3(dn, sub3(row3(h.r, kN1), n0));
    *dv += dot3(dn, sub3(row3(h.r, kN2), n0));
  }
}

// d safe_div(a, b) for the cotangent g: (da, db)
PSDR_HD void safe_div_bwd(float a, float b, float g, float* da, float* db) {
  if (fabsf(b) > kTiny && g != 0.0f) {
    if (da != nullptr) *da += g / b;
    if (db != nullptr) *db += -g * a / (b * b);
  }
}

PSDR_HD float safe_sqrt_bwd(float x, float g) {
  return (x >= kTiny && g != 0.0f) ? g * 0.5f / sqrtf(x) : 0.0f;
}

struct Scalars {
  float total_mass, total_area, sampling_weight, ps_pdf;
};

struct Lane {
  uint32_t lane, seed, cnt0;
  bool hide_emitters;
  const float* light;
  int n_light;
  Scalars m;
};

// The camera hit: the solid-angle formulation (scene.py:178-184).
struct Camera {
  Hit f0;
  V3 o, d, h, s, q;
  float a, f, udot, vdot, tdot, uu, vv, t0;
  V3 p, sh_n;
  float wi_z;
  bool active, ok_emit;
};

PSDR_HD Camera camera_forward(const Hit& f0, V3 o, V3 d, bool act, bool hide) {
  Camera c;
  c.f0 = f0;
  c.o = o;
  c.d = d;
  const V3 e1 = row3(f0.r, kE1), e2 = row3(f0.r, kE2);
  c.h = cross3(d, e2);
  c.a = dot3(e1, c.h);
  c.f = safe_div(1.0f, c.a);
  c.s = sub3(o, row3(f0.r, kP0));
  c.udot = dot3(c.s, c.h);
  c.uu = c.f * c.udot;
  c.q = cross3(c.s, e1);
  c.vdot = dot3(d, c.q);
  c.vv = c.f * c.vdot;
  c.tdot = dot3(e2, c.q);
  c.t0 = c.f * c.tdot;
  c.p = {o.x + c.t0 * d.x, o.y + c.t0 * d.y, o.z + c.t0 * d.z};
  c.sh_n = shading_normal(f0, c.uu, c.vv);
  c.wi_z = -dot3(c.sh_n, d);
  c.active = act && f0.valid;
  c.ok_emit = !hide && c.active && f0.isem() && c.wi_z > 0.0f;
  return c;
}

// What one depth reads from the depth before it (or the camera hit).
struct DepthIn {
  V3 p, sh_n, alb, thr;
  float wi_z;
  bool active, valid, isem;
};

// One depth's locals: next-event estimation, then the BSDF bounce.
struct DepthFwd {
  // NEE
  F4 un;
  int idxl;
  float scaled, lower, pmf, area_l, num, r, y, tq, b0, b1, ps_j;
  V3 e1l, e2l, w, wodn;
  float dist_sqr, dist, inv_dist;
  Hit f1;
  float cos_val, g_val, cos_o, sc1, sc2, bsdf_scale, weight1;
  bool ev_ok, ok_nee, le1_ok;
  // bounce
  Hit f2;
  V3 dv2, wo, thr2;
  float t2sq, t2, inv_t2, cos_val2, den2, g2r, j2, g2, pdf0, ipdf0, cos_o2,
      ev_scale, x, bvs, inva, e_pdf, weight2;
  bool active2, ev_ok2, tmask, le2_ok;
  V3 nee, bounce;  // the radiance this depth adds, in the plain version's order
  DepthIn next;
};

PSDR_HD DepthFwd depth_forward(const Lane& ln, const DepthIn& in, int i, const Hit& f1,
                               const Hit& f2) {
  DepthFwd s;
  const float* light = ln.light;
  const int nl = ln.n_light;
  s.un = draw(ln.lane, ln.cnt0 + 2 * i, ln.seed);
  const F4 ub = draw(ln.lane, ln.cnt0 + 2 * i + 1, ln.seed);
  // ---- NEE (path.py nee_contribution) ----
  s.scaled = s.un.x * ln.m.total_mass;
  int idx = 0;
  for (int j = 0; j < nl; ++j) idx += light[j] < s.scaled ? 1 : 0;
  s.idxl = idx < nl - 1 ? idx : nl - 1;
  const int j = s.idxl;
  s.lower = j > 0 ? light[j - 1] : 0.0f;
  s.pmf = light[nl + j];
  s.area_l = light[11 * nl + j];
  s.num = s.scaled - s.lower;
  s.r = safe_div(s.num, s.pmf);
  const float u0r = fminf(fmaxf(s.r, 0.0f), 1.0f);
  s.y = 1.0f - u0r;
  s.tq = safe_sqrt(s.y);
  s.b0 = 1.0f - s.tq;
  s.b1 = s.tq * s.un.y;
  const V3 p0l{light[2 * nl + j], light[3 * nl + j], light[4 * nl + j]};
  s.e1l = {light[5 * nl + j], light[6 * nl + j], light[7 * nl + j]};
  s.e2l = {light[8 * nl + j], light[9 * nl + j], light[10 * nl + j]};
  const V3 pl{p0l.x + s.e1l.x * s.b0 + s.e2l.x * s.b1,
              p0l.y + s.e1l.y * s.b0 + s.e2l.y * s.b1,
              p0l.z + s.e1l.z * s.b0 + s.e2l.z * s.b1};
  s.ps_j = safe_div(s.area_l, s.area_l);
  bool active_direct = in.active && !(in.valid && in.isem);
  s.w = sub3(pl, in.p);
  s.dist_sqr = dot3(s.w, s.w);
  s.dist = safe_sqrt(s.dist_sqr);
  s.inv_dist = safe_div(1.0f, s.dist);
  s.wodn = scale3(s.w, s.inv_dist);
  s.f1 = f1;
  const V3 dv1 = sub3(hit_point(f1), in.p);
  const float t1 = safe_sqrt(dot3(dv1, dv1));
  const V3 dirv1 = scale3(dv1, safe_div(1.0f, t1));
  const float wi1_z = -dot3(shading_normal(f1, f1.u, f1.v), dirv1);
  active_direct = active_direct && f1.valid && t1 > s.dist - kShadowEpsilon && f1.isem();
  s.cos_val = -dot3(row3(f1.r, kFn), s.wodn);
  s.g_val = safe_div(fabsf(s.cos_val), s.dist_sqr);
  s.le1_ok = in.active && f1.valid && f1.isem() && wi1_z > 0.0f;
  s.cos_o = dot3(in.sh_n, s.wodn);
  s.ev_ok = active_direct && in.wi_z > 0.0f && s.cos_o > 0.0f;
  s.sc1 = s.ev_ok ? kInvPi * s.cos_o : 0.0f;
  s.sc2 = s.g_val * s.ps_j * safe_div(1.0f, ln.m.ps_pdf);
  s.bsdf_scale = s.sc1 * s.sc2;
  const float pdf1 = (s.ev_ok ? kInvPi * s.cos_o : 0.0f) * s.g_val;
  s.ok_nee = active_direct && pdf1 != 0.0f;
  s.weight1 = mis_weight(ln.m.ps_pdf, pdf1);
  s.nee = {0.0f, 0.0f, 0.0f};
  if (s.ok_nee) {
    const V3 e1v = s.le1_ok ? row3(f1.r, kEmit) : V3{0.0f, 0.0f, 0.0f};
    s.nee = scale3(scale3(mul3(mul3(in.thr, e1v), in.alb), s.bsdf_scale), s.weight1);
  }
  // ---- BSDF bounce (path.py bsdf_bounce) ----
  const float lz = cosine_hemisphere(ub.y, ub.z).z;
  const float bs_pdf = kInvPi * lz;
  s.f2 = f2;
  const V3 p2 = hit_point(f2);
  s.dv2 = sub3(p2, in.p);
  s.t2sq = dot3(s.dv2, s.dv2);
  s.t2 = safe_sqrt(s.t2sq);
  s.inv_t2 = safe_div(1.0f, s.t2);
  s.wo = scale3(s.dv2, s.inv_t2);
  s.cos_val2 = -dot3(row3(f2.r, kFn), s.wo);
  s.den2 = s.t2 * s.t2;
  s.g2r = safe_div(fabsf(s.cos_val2), s.den2);
  s.j2 = f2.valid ? safe_div(f2.r[kArea], f2.r[kArea]) : 1.0f;
  s.g2 = f2.valid ? s.g2r : 1.0f;
  s.pdf0 = bs_pdf * s.g2;
  s.active2 = in.active && in.wi_z > 0.0f && f2.valid;
  s.cos_o2 = dot3(in.sh_n, s.wo);
  s.ev_ok2 = s.active2 && in.wi_z > 0.0f && s.cos_o2 > 0.0f;
  s.ev_scale = s.ev_ok2 ? kInvPi * s.cos_o2 : 0.0f;
  s.ipdf0 = safe_div(1.0f, s.pdf0);
  s.x = s.g2 * s.j2 * s.ipdf0;
  s.tmask = s.t2 < kEpsilon;
  s.bvs = s.tmask ? 0.0f : s.ev_scale * s.x;
  s.inva = safe_div(1.0f, ln.m.total_area);
  s.e_pdf = (s.active2 && f2.isem()) ? ln.m.sampling_weight * s.inva : 0.0f;
  s.weight2 = mis_weight(s.pdf0, s.e_pdf);
  s.thr2 = scale3(mul3(in.thr, in.alb), s.bvs);
  const V3 sh_n2 = shading_normal(f2, f2.u, f2.v);
  const float wi2_z = -dot3(sh_n2, s.wo);
  s.le2_ok = s.active2 && f2.isem() && wi2_z > 0.0f;
  s.bounce = {0.0f, 0.0f, 0.0f};
  if (s.active2) {
    const V3 e2v = s.le2_ok ? row3(f2.r, kEmit) : V3{0.0f, 0.0f, 0.0f};
    s.bounce = scale3(mul3(e2v, s.thr2), s.weight2);
  }
  s.next = {p2, sh_n2, row3(f2.r, kAlb), s.thr2, wi2_z, s.active2, f2.valid, f2.isem()};
  return s;
}

// Cotangents flowing into a depth's inputs.
struct DepthGrad {
  V3 p, sh_n, alb, thr;
};

// The adjoint of one depth: `ct` is the radiance cotangent, `out` the
// cotangents of the next depth's inputs (zero after the last depth).
PSDR_HD DepthGrad depth_backward(const Lane& ln, const DepthIn& in, const DepthFwd& s, V3 ct,
                                 const DepthGrad& out, const Grads& gr) {
  const int nl = ln.n_light;
  const int j = s.idxl;
  DepthGrad g{{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
  const Hit& f2 = s.f2;
  const Hit& f1 = s.f1;
  // ---- bounce, in reverse ----
  gr.tab3(f2.row, kAlb, out.alb);
  V3 g_thr2 = out.thr;
  float d_w2 = 0.0f;
  if (s.active2) {
    const V3 e2v = s.le2_ok ? row3(f2.r, kEmit) : V3{0.0f, 0.0f, 0.0f};
    V3 d_e2v{0.0f, 0.0f, 0.0f};
    for (int k = 0; k < 3; ++k) {
      const float dprod = comp(ct, k) * s.weight2;
      d_w2 += comp(ct, k) * (comp(e2v, k) * comp(s.thr2, k));
      add_comp(d_e2v, k, dprod * comp(s.thr2, k));
      add_comp(g_thr2, k, dprod * comp(e2v, k));
    }
    if (s.le2_ok) gr.tab3(f2.row, kEmit, d_e2v);
  }
  // weight2 = mis(pdf0, e_pdf): pdf0 is detached
  {
    const float w1 = s.pdf0 * s.pdf0;
    const float w2 = s.e_pdf * s.e_pdf;
    float d_den = 0.0f;
    safe_div_bwd(w1, w1 + w2, d_w2, nullptr, &d_den);
    const float d_epdf = 2.0f * s.e_pdf * d_den;
    if (s.active2 && f2.isem() && d_epdf != 0.0f) {
      gr.mis(2, d_epdf * s.inva);
      float d_ta = 0.0f;
      safe_div_bwd(1.0f, ln.m.total_area, d_epdf * ln.m.sampling_weight, nullptr, &d_ta);
      gr.mis(1, d_ta);
    }
  }
  // thr2 = (thr * alb) * bvs
  float d_bvs = 0.0f;
  for (int k = 0; k < 3; ++k) {
    const float gk = comp(g_thr2, k);
    d_bvs += gk * (comp(in.thr, k) * comp(in.alb, k));
    const float d_ta = gk * s.bvs;
    add_comp(g.thr, k, d_ta * comp(in.alb, k));
    add_comp(g.alb, k, d_ta * comp(in.thr, k));
  }
  if (s.tmask) d_bvs = 0.0f;
  const float d_ev = d_bvs * s.x;
  const float d_x = d_bvs * s.ev_scale;
  const float d_gj = d_x * s.ipdf0;
  const float d_g2 = d_gj * s.j2;
  const float d_j2 = d_gj * s.g2;
  V3 d_wo{0.0f, 0.0f, 0.0f};
  if (s.ev_ok2 && d_ev != 0.0f) {
    const float d_co2 = d_ev * kInvPi;
    g.sh_n = add3(g.sh_n, scale3(s.wo, d_co2));
    d_wo = add3(d_wo, scale3(in.sh_n, d_co2));
  }
  float d_t2 = 0.0f;
  if (f2.valid) {
    float d_area = 0.0f;
    safe_div_bwd(f2.r[kArea], f2.r[kArea], d_j2, &d_area, nullptr);
    gr.tab(f2.row, kArea, d_area);
    if (d_g2 != 0.0f && fabsf(s.den2) > kTiny) {
      const float d_abs = d_g2 / s.den2;
      const float d_den = -d_g2 * fabsf(s.cos_val2) / (s.den2 * s.den2);
      d_t2 += 2.0f * s.t2 * d_den;
      const float d_cv2 = d_abs * sgn(s.cos_val2);
      gr.tab3(f2.row, kFn, scale3(s.wo, -d_cv2));
      d_wo = add3(d_wo, scale3(row3(f2.r, kFn), -d_cv2));
    }
  }
  shading_normal_bwd(f2, f2.u, f2.v, out.sh_n, gr, nullptr, nullptr);
  V3 d_dv2 = scale3(d_wo, s.inv_t2);
  float d_inv_t2 = dot3(d_wo, s.dv2);
  safe_div_bwd(1.0f, s.t2, d_inv_t2, nullptr, &d_t2);
  const float d_t2sq = safe_sqrt_bwd(s.t2sq, d_t2);
  d_dv2 = add3(d_dv2, scale3(s.dv2, 2.0f * d_t2sq));
  const V3 d_p2 = add3(out.p, d_dv2);
  g.p = sub3(g.p, d_dv2);
  gr.tab9(f2.row, kP0, d_p2, scale3(d_p2, f2.u), scale3(d_p2, f2.v));
  // ---- NEE, in reverse ----
  float d_bs = 0.0f;
  if (s.ok_nee) {
    const V3 e1v = s.le1_ok ? row3(f1.r, kEmit) : V3{0.0f, 0.0f, 0.0f};
    V3 d_e1v{0.0f, 0.0f, 0.0f};
    for (int k = 0; k < 3; ++k) {
      const float gk = comp(ct, k) * s.weight1;
      const float a = comp(in.thr, k) * comp(e1v, k);
      const float b = a * comp(in.alb, k);
      d_bs += gk * b;
      const float d_b = gk * s.bsdf_scale;
      add_comp(g.alb, k, d_b * a);
      const float d_a = d_b * comp(in.alb, k);
      add_comp(g.thr, k, d_a * comp(e1v, k));
      add_comp(d_e1v, k, d_a * comp(in.thr, k));
    }
    if (s.le1_ok) gr.tab3(f1.row, kEmit, d_e1v);
  }
  if (d_bs == 0.0f) return g;
  const float d_sc1 = d_bs * s.sc2;
  const float d_sc2 = d_bs * s.sc1;
  const float d_gp = d_sc2 * safe_div(1.0f, ln.m.ps_pdf);
  const float d_gval = d_gp * s.ps_j;
  float d_area_l = 0.0f;
  safe_div_bwd(s.area_l, s.area_l, d_gp * s.g_val, &d_area_l, nullptr);
  gr.lig(11, j, d_area_l);
  V3 d_wodn{0.0f, 0.0f, 0.0f};
  if (s.ev_ok) {
    const float d_co = d_sc1 * kInvPi;
    g.sh_n = add3(g.sh_n, scale3(s.wodn, d_co));
    d_wodn = add3(d_wodn, scale3(in.sh_n, d_co));
  }
  float d_ds = 0.0f;
  if (d_gval != 0.0f && fabsf(s.dist_sqr) > kTiny) {
    const float d_abs = d_gval / s.dist_sqr;
    d_ds += -d_gval * fabsf(s.cos_val) / (s.dist_sqr * s.dist_sqr);
    const float d_cv = d_abs * sgn(s.cos_val);
    gr.tab3(f1.row, kFn, scale3(s.wodn, -d_cv));
    d_wodn = add3(d_wodn, scale3(row3(f1.r, kFn), -d_cv));
  }
  V3 d_w = scale3(d_wodn, s.inv_dist);
  float d_dist = 0.0f;
  safe_div_bwd(1.0f, s.dist, dot3(d_wodn, s.w), nullptr, &d_dist);
  d_ds += safe_sqrt_bwd(s.dist_sqr, d_dist);
  d_w = add3(d_w, scale3(s.w, 2.0f * d_ds));
  g.p = sub3(g.p, d_w);
  // pl = p0l + e1l * b0 + e2l * b1
  gr.lig9(2, j, d_w, scale3(d_w, s.b0), scale3(d_w, s.b1));
  const float d_b0 = dot3(d_w, s.e1l);
  const float d_b1 = dot3(d_w, s.e2l);
  const float d_tq = d_b1 * s.un.y - d_b0;
  const float d_u0r = -safe_sqrt_bwd(s.y, d_tq);
  const float d_r = (s.r >= 0.0f && s.r <= 1.0f) ? d_u0r : 0.0f;
  float d_num = 0.0f, d_pmf = 0.0f;
  safe_div_bwd(s.num, s.pmf, d_r, &d_num, &d_pmf);
  gr.lig(1, j, d_pmf);
  if (j > 0) gr.lig(0, j - 1, -d_num);
  gr.mis(0, d_num * s.un.x);
  (void)nl;
  return g;
}

// The attached Li of one lane (K3). hits: ids/us/vs of (1 + 2 depth, n).
PSDR_HD V3 lane_forward(const Lane& ln, const float* table, const int* ids, const float* us,
                        const float* vs, long long n, long long i, V3 o, V3 d, bool act,
                        int depth) {
  const Camera c = camera_forward(load_hit(table, ids[i], us[i], vs[i]), o, d, act,
                                  ln.hide_emitters);
  V3 res = c.ok_emit ? row3(c.f0.r, kEmit) : V3{0.0f, 0.0f, 0.0f};
  DepthIn in{c.p, c.sh_n, row3(c.f0.r, kAlb), {1.0f, 1.0f, 1.0f}, c.wi_z, c.active,
             c.f0.valid, c.f0.isem()};
  for (int k = 0; k < depth; ++k) {
    const long long a = (1 + 2 * k) * n + i, b = (2 + 2 * k) * n + i;
    const DepthFwd s = depth_forward(ln, in, k, load_hit(table, ids[a], us[a], vs[a]),
                                     load_hit(table, ids[b], us[b], vs[b]));
    res = add3(add3(res, s.nee), s.bounce);
    in = s.next;
  }
  return res;
}

// The adjoint of lane_forward for the cotangent ct (K4): table, light and
// misc cotangents into `gr`, the ray's into *d_o, *d_d.
template <int DEPTH>
PSDR_HD void lane_backward(const Lane& ln, const float* table, const int* ids, const float* us,
                           const float* vs, long long n, long long i, V3 o, V3 d, bool act,
                           V3 ct, const Grads& gr, V3* d_o, V3* d_d) {
  const Camera c = camera_forward(load_hit(table, ids[i], us[i], vs[i]), o, d, act,
                                  ln.hide_emitters);
  const DepthIn in0{c.p, c.sh_n, row3(c.f0.r, kAlb), {1.0f, 1.0f, 1.0f}, c.wi_z, c.active,
                    c.f0.valid, c.f0.isem()};
  // Depth k's inputs are recomputed from the camera hit before its adjoint
  // (k forwards) rather than kept for every depth: D (D + 1) / 2 forwards,
  // as many as keeping them and recomputing each depth's locals, with no
  // per-depth array in local memory.
  DepthGrad g{{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
  for (int k = DEPTH - 1; k >= 0; --k) {
    DepthIn in = in0;
    for (int m = 0; m < k; ++m) {
      const long long a = (1 + 2 * m) * n + i, b = (2 + 2 * m) * n + i;
      in = depth_forward(ln, in, m, load_hit(table, ids[a], us[a], vs[a]),
                         load_hit(table, ids[b], us[b], vs[b]))
               .next;
    }
    const long long a = (1 + 2 * k) * n + i, b = (2 + 2 * k) * n + i;
    const DepthFwd s = depth_forward(ln, in, k, load_hit(table, ids[a], us[a], vs[a]),
                                     load_hit(table, ids[b], us[b], vs[b]));
    g = depth_backward(ln, in, s, ct, g, gr);
  }
  // ---- camera hit, in reverse ----
  const Hit& f0 = c.f0;
  if (c.ok_emit) gr.tab3(f0.row, kEmit, ct);
  gr.tab3(f0.row, kAlb, g.alb);
  float d_uu = 0.0f, d_vv = 0.0f;
  shading_normal_bwd(f0, c.uu, c.vv, g.sh_n, gr, &d_uu, &d_vv);
  V3 go = g.p;
  V3 gd = scale3(g.p, c.t0);
  const float d_t0 = dot3(g.p, d);
  const V3 e1 = row3(f0.r, kE1), e2 = row3(f0.r, kE2);
  float d_f = d_t0 * c.tdot + d_vv * c.vdot + d_uu * c.udot;
  const float d_tdot = d_t0 * c.f;
  const float d_vdot = d_vv * c.f;
  const float d_udot = d_uu * c.f;
  V3 d_e2 = scale3(c.q, d_tdot);
  V3 d_q = add3(scale3(e2, d_tdot), scale3(d, d_vdot));
  gd = add3(gd, scale3(c.q, d_vdot));
  V3 d_s = add3(cross3(e1, d_q), scale3(c.h, d_udot));
  V3 d_e1 = cross3(d_q, c.s);
  V3 d_h = scale3(c.s, d_udot);
  go = add3(go, d_s);
  float d_a = 0.0f;
  safe_div_bwd(1.0f, c.a, d_f, nullptr, &d_a);
  d_e1 = add3(d_e1, scale3(c.h, d_a));
  d_h = add3(d_h, scale3(e1, d_a));
  gd = add3(gd, cross3(e2, d_h));
  d_e2 = add3(d_e2, cross3(d_h, d));
  gr.tab9(f0.row, kP0, scale3(d_s, -1.0f), d_e1, d_e2);
  *d_o = go;
  *d_d = gd;
}

}  // namespace shade
}  // namespace psdr
