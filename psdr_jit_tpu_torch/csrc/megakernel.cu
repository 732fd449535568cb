// K2: the detached PathTracer Li, one thread per sample lane, in one launch.
//
// Replaces the TPU kernel _mk_kernel / _li_mega_impl of
// psdr_jit_tpu/ops/megakernel.py in its three modes:
//  * single: Li of one ray per lane (renderC);
//  * pair:   Li(ray_n) - Li(ray_p), ray_n with draws cnt0 .. cnt0+2*depth-1
//            and ray_p with the next 2*depth (the primary-edge pass);
//  * stash:  Li plus the (tri_id, u, v) of all 1 + 2*depth hits (the
//            interior trace of the training step), with bounce origins at
//            the bilinear point p0 + e1*u + e2*v of the path-space
//            formulation instead of o + d*t; the camera hit keeps o + d*t.
// Per lane: the camera hit, emitted radiance, then for each depth
// next-event estimation on the area light with MIS and a cosine-weighted
// bounce in a Duff frame. The plain PyTorch versions are li_mega_plain,
// li_mega_pair_plain and li_mega_stash_plain in
// psdr_jit_tpu_torch/ops/megakernel.py; all follow eval_li of the TPU
// kernel operation for operation.
//
// What changed from the TPU kernel, and why:
//  * Tables (triangles, cluster boxes, 17 attribute rows, the light table,
//    two scalars) are staged in shared memory once per block: the
//    counterpart of SMEM scalar prefetch. At the 192-triangle limit they
//    take 31 KiB.
//  * Hit attributes are read by hit id. The TPU kernel re-swept the
//    triangles with masked selects because its lanes cannot index VMEM.
//  * The static depth/hide_emitters/n_light/mode of the TPU trace are
//    runtime arguments; depth is a loop; pair mode calls eval_li twice.
//  * The hit point p + d * t is one fmaf, rounded once, as in the plain
//    version and in the JAX package on the CPU (XLA contracts it): an ulp
//    in a secondary-ray origin flips grazing self-intersection tests
//    against RAY_EPSILON on about 1% of the Cornell box's lanes. The stash
//    mode's bilinear origin is two fmafs for the same reason.
//  * sin/cos of the bounce use the same short polynomials as the plain
//    version (common.cuh), so no device library routine differs between
//    the two.
//
// What bounds it on an H100: arithmetic and divergence. A lane does
// 1 + 2 * depth sweeps of ~30 f32 operations per visited triangle, reads
// 28 bytes and writes 12 (plus 12 per hit in stash mode, 24 more rays in
// pair mode). Lanes of a warp that miss, hit the light or cull different
// clusters diverge. This version keeps the simple one-lane-per-thread
// shape; path regeneration or compaction is later work.
#include "common.cuh"
#include "sweep.cuh"

namespace {

using psdr::V3;

constexpr int kAttrRows = 17;
constexpr int kLightRows = 14;
constexpr int kModeSingle = 0;
constexpr int kModePair = 1;
constexpr int kModeStash = 2;

struct Surface {
  V3 ns;     // unit shading normal
  V3 fn;     // unit face normal
  V3 alb;    // albedo
  V3 emit;   // emitted radiance
  bool is_em;
};

// Attributes of hit `id` at barycentrics (u, v); zeros for a miss.
__device__ __forceinline__ Surface resolve(const float* __restrict__ attr,
                                           const float* __restrict__ tri,
                                           int f_pad, int id, float u, float v) {
  Surface s{};
  if (id < 0) return s;
  const float e1x = tri[3 * f_pad + id], e1y = tri[4 * f_pad + id],
              e1z = tri[5 * f_pad + id];
  const float e2x = tri[6 * f_pad + id], e2y = tri[7 * f_pad + id],
              e2z = tri[8 * f_pad + id];
  s.fn = psdr::normalize3({e1y * e2z - e1z * e2y, e1z * e2x - e1x * e2z,
                           e1x * e2y - e1y * e2x});
  const float* a = attr + id;
  V3 n;
  if (a[9 * f_pad] > 0.5f) {
    n = s.fn;
  } else {
    n.x = a[0] + (a[3 * f_pad] - a[0]) * u + (a[6 * f_pad] - a[0]) * v;
    n.y = a[f_pad] + (a[4 * f_pad] - a[f_pad]) * u + (a[7 * f_pad] - a[f_pad]) * v;
    n.z = a[2 * f_pad] + (a[5 * f_pad] - a[2 * f_pad]) * u +
          (a[8 * f_pad] - a[2 * f_pad]) * v;
  }
  s.ns = psdr::normalize3(n);
  s.alb = {a[10 * f_pad], a[11 * f_pad], a[12 * f_pad]};
  s.emit = {a[13 * f_pad], a[14 * f_pad], a[15 * f_pad]};
  s.is_em = a[16 * f_pad] > 0.5f;
  return s;
}

// Uniform-area point on the light mesh with sample reuse
// (mesh.cpp sample_position, pmf.cpp:30-51).
__device__ __forceinline__ V3 sample_light(const float* __restrict__ light,
                                           int n_light, float total_mass,
                                           float u0, float u1) {
  const float scaled = u0 * total_mass;
  int idx = 0;
  for (int j = 0; j < n_light; ++j) idx += light[j] < scaled ? 1 : 0;
  idx = min(idx, n_light - 1);
  const float lower = idx > 0 ? light[idx - 1] : 0.0f;
  const float pmf = light[n_light + idx];
  const float u0r = fminf(fmaxf(psdr::safe_div(scaled - lower, pmf), 0.0f), 1.0f);
  const float tq = psdr::safe_sqrt(1.0f - u0r);
  const float b0 = 1.0f - tq;
  const float b1 = tq * u1;
  const float* r = light + idx;
  return {r[2 * n_light] + r[5 * n_light] * b0 + r[8 * n_light] * b1,
          r[3 * n_light] + r[6 * n_light] * b0 + r[9 * n_light] * b1,
          r[4 * n_light] + r[7 * n_light] * b0 + r[10 * n_light] * b1};
}

// Shared-memory tables of one block.
struct Tables {
  const float* tri;
  const float* box;
  const float* attr;
  const float* light;
  int f_pad;
  int n_light;
  float total_mass;
  float inv_area;
};

// Records hit `k` of lane `i` in stash mode (nullptr ids: not stashing).
struct Stash {
  int* ids;
  float* u;
  float* v;
  long long n;
  long long i;
  __device__ __forceinline__ void put(int k, const psdr::Hit& h) const {
    if (ids == nullptr) return;
    ids[k * n + i] = h.id;
    u[k * n + i] = h.u;
    v[k * n + i] = h.v;
  }
};

// The detached Li of one ray (eval_li of the TPU kernel).
__device__ V3 eval_li(const Tables& tb, V3 o, V3 d, bool active, uint32_t lane,
                      uint32_t cnt, uint32_t seed, int depth, bool hide_emitters,
                      const Stash& st) {
  using psdr::dot3;
  using psdr::safe_div;
  const int f_pad = tb.f_pad;
  psdr::Hit h = psdr::sweep(tb.tri, tb.box, f_pad, o.x, o.y, o.z, d.x, d.y, d.z);
  st.put(0, h);
  active = active && h.id >= 0;
  Surface its = resolve(tb.attr, tb.tri, f_pad, h.id, h.u, h.v);

  V3 res{0.0f, 0.0f, 0.0f};
  if (!hide_emitters && active && its.is_em && -dot3(its.ns, d) > 0.0f) res = its.emit;
  V3 thr{1.0f, 1.0f, 1.0f};
  V3 p{fmaf(d.x, h.t, o.x), fmaf(d.y, h.t, o.y), fmaf(d.z, h.t, o.z)};

  for (int k = 0; k < depth; ++k) {
    const float wiz_cam = -dot3(its.ns, d);

    // ---- next-event estimation (path.cpp:47-83) ----
    const psdr::F4 u_nee = psdr::draw(lane, cnt++, seed);
    const V3 pl = sample_light(tb.light, tb.n_light, tb.total_mass, u_nee.x, u_nee.y);
    const bool active_direct = active && !its.is_em;
    V3 wod = psdr::sub3(pl, p);
    const float dist_sqr = dot3(wod, wod);
    const float dist = psdr::safe_sqrt(dist_sqr);
    const float inv_dist = safe_div(1.0f, dist);
    wod = psdr::scale3(wod, inv_dist);
    const psdr::Hit h1 =
        psdr::sweep(tb.tri, tb.box, f_pad, p.x, p.y, p.z, wod.x, wod.y, wod.z);
    st.put(1 + 2 * k, h1);
    const Surface its1 = resolve(tb.attr, tb.tri, f_pad, h1.id, h1.u, h1.v);
    const bool hit_light = active_direct && h1.id >= 0 &&
                           h1.t > dist - psdr::kShadowEpsilon && its1.is_em;
    const float g_val = safe_div(fabsf(-dot3(its1.fn, wod)), dist_sqr);
    const bool le_ok = h1.id >= 0 && its1.is_em && -dot3(its1.ns, wod) > 0.0f;
    const V3 e = le_ok ? its1.emit : V3{0.0f, 0.0f, 0.0f};
    const float cos_o = dot3(its.ns, wod);
    const bool f_ok = wiz_cam > 0.0f && cos_o > 0.0f;
    const float f_scale = f_ok ? psdr::kInvPi * cos_o : 0.0f;
    const float w_nee = g_val * safe_div(1.0f, tb.inv_area);
    const float pdf1 = (f_ok ? psdr::kInvPi * cos_o : 0.0f) * g_val;
    const float weight1 = psdr::mis_weight(tb.inv_area, pdf1);
    const float scale = (hit_light && pdf1 != 0.0f) ? f_scale * w_nee * weight1 : 0.0f;
    res.x = res.x + thr.x * its.alb.x * e.x * scale;
    res.y = res.y + thr.y * its.alb.y * e.y * scale;
    res.z = res.z + thr.z * its.alb.z * e.z * scale;

    // ---- BSDF bounce (path.cpp:85-123) ----
    const psdr::F4 u_b = psdr::draw(lane, cnt++, seed);
    const V3 l = psdr::cosine_hemisphere(u_b.y, u_b.z);
    const float bs_pdf = psdr::kInvPi * l.z;
    const V3 n = its.ns;
    const float sign = n.z >= 0.0f ? 1.0f : -1.0f;
    const float fa = -1.0f / (sign + n.z);
    const float fb = n.x * n.y * fa;
    const V3 sf{sign * n.x * n.x * fa + 1.0f, sign * fb, -sign * n.x};
    const V3 tf{fb, sign + n.y * n.y * fa, -n.y};
    const V3 wo{sf.x * l.x + tf.x * l.y + n.x * l.z, sf.y * l.x + tf.y * l.y + n.y * l.z,
                sf.z * l.x + tf.z * l.y + n.z * l.z};
    const bool bs_valid = active && wiz_cam > 0.0f;
    const psdr::Hit h2 =
        psdr::sweep(tb.tri, tb.box, f_pad, p.x, p.y, p.z, wo.x, wo.y, wo.z);
    st.put(2 + 2 * k, h2);
    const bool valid2 = h2.id >= 0;
    active = bs_valid && valid2;
    const Surface its2 = resolve(tb.attr, tb.tri, f_pad, h2.id, h2.u, h2.v);
    const float g2 = valid2
        ? safe_div(fabsf(-dot3(its2.fn, wo)), fmaxf(h2.t * h2.t, psdr::kTiny))
        : 1.0f;
    const float pdf0 = bs_pdf * g2;
    const bool f2_ok = wiz_cam > 0.0f && l.z > 0.0f && h2.t >= psdr::kEpsilon;
    const float bw = (f2_ok && active) ? 1.0f : 0.0f;
    thr = {thr.x * its.alb.x * bw, thr.y * its.alb.y * bw, thr.z * its.alb.z * bw};
    const float e_pdf = (valid2 && its2.is_em) ? tb.inv_area : 0.0f;
    const float weight2 = psdr::mis_weight(pdf0, e_pdf);
    const float lscale =
        (active && its2.is_em && -dot3(its2.ns, wo) > 0.0f) ? weight2 : 0.0f;
    res.x = res.x + thr.x * its2.emit.x * lscale;
    res.y = res.y + thr.y * its2.emit.y * lscale;
    res.z = res.z + thr.z * its2.emit.z * lscale;

    if (st.ids != nullptr) {
      // bilinear point of the path-space formulation; zero for a miss
      const int j = h2.id;
      p = valid2 ? V3{fmaf(tb.tri[6 * f_pad + j], h2.v,
                           fmaf(tb.tri[3 * f_pad + j], h2.u, tb.tri[j])),
                      fmaf(tb.tri[7 * f_pad + j], h2.v,
                           fmaf(tb.tri[4 * f_pad + j], h2.u, tb.tri[f_pad + j])),
                      fmaf(tb.tri[8 * f_pad + j], h2.v,
                           fmaf(tb.tri[5 * f_pad + j], h2.u, tb.tri[2 * f_pad + j]))}
                 : V3{0.0f, 0.0f, 0.0f};
    } else {
      p = {fmaf(wo.x, h2.t, p.x), fmaf(wo.y, h2.t, p.y), fmaf(wo.z, h2.t, p.z)};
    }
    d = wo;
    its = its2;
  }
  return res;
}

__global__ void __launch_bounds__(256)
    li_mega_kernel(const float* __restrict__ tri_g, const float* __restrict__ box_g,
                   const float* __restrict__ attr_g,
                   const float* __restrict__ light_g,
                   const float* __restrict__ misc_g, int f_pad, int n_light,
                   const float* __restrict__ ray_o, const float* __restrict__ ray_d,
                   const float* __restrict__ ray_o2, const float* __restrict__ ray_d2,
                   const unsigned char* __restrict__ active_g,
                   const uint32_t* __restrict__ lane_g, uint32_t seed,
                   long long n, int depth, int cnt0, int hide_emitters, int mode,
                   float* __restrict__ out, int* __restrict__ stash_id,
                   float* __restrict__ stash_u, float* __restrict__ stash_v) {
  extern __shared__ float smem[];
  float* s_tri = smem;
  float* s_box = s_tri + 9 * f_pad;
  float* s_attr = s_box + 6 * (f_pad / psdr::kCluster);
  float* s_light = s_attr + kAttrRows * f_pad;
  __shared__ float s_misc[2];
  psdr::stage_geometry(tri_g, box_g, f_pad, s_tri, s_box);
  for (int k = threadIdx.x; k < kAttrRows * f_pad; k += blockDim.x) s_attr[k] = attr_g[k];
  for (int k = threadIdx.x; k < kLightRows * n_light; k += blockDim.x)
    s_light[k] = light_g[k];
  for (int k = threadIdx.x; k < 2; k += blockDim.x) s_misc[k] = misc_g[k];
  __syncthreads();

  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Tables tb{s_tri, s_box, s_attr, s_light, f_pad, n_light, s_misc[0], s_misc[1]};
  const Stash st{mode == kModeStash ? stash_id : nullptr, stash_u, stash_v, n, i};
  const bool active = active_g[i] != 0;
  const uint32_t lane = lane_g[i];
  V3 res = eval_li(tb, {ray_o[3 * i], ray_o[3 * i + 1], ray_o[3 * i + 2]},
                   {ray_d[3 * i], ray_d[3 * i + 1], ray_d[3 * i + 2]}, active, lane,
                   static_cast<uint32_t>(cnt0), seed, depth, hide_emitters != 0, st);
  if (mode == kModePair) {
    const V3 res_p =
        eval_li(tb, {ray_o2[3 * i], ray_o2[3 * i + 1], ray_o2[3 * i + 2]},
                {ray_d2[3 * i], ray_d2[3 * i + 1], ray_d2[3 * i + 2]}, active, lane,
                static_cast<uint32_t>(cnt0 + 2 * depth), seed, depth,
                hide_emitters != 0, Stash{nullptr, nullptr, nullptr, n, i});
    res = psdr::sub3(res, res_p);
  }
  out[3 * i] = res.x;
  out[3 * i + 1] = res.y;
  out[3 * i + 2] = res.z;
}

}  // namespace

// Tables as in psdr_jit_tpu_torch/ops/megakernel.py build_tables: tri
// (9, f_pad), box (6, f_pad / 16), attr (17, f_pad), light (14, n_light),
// misc (2); rays (n, 3), the second pair (ray_o2, ray_d2) read in pair mode
// only; active (n, bool); lane (n, u32). mode: 0 single, 1 pair, 2 stash.
// Writes out (n, 3) and, in stash mode, stash_id (1 + 2*depth, n) int32
// and stash_u, stash_v (1 + 2*depth, n). Launches on `stream` and returns
// cudaGetLastError().
extern "C" int psdr_li_mega(const float* tri, const float* box, const float* attr,
                            const float* light, const float* misc, int f_pad,
                            int n_light, const float* ray_o, const float* ray_d,
                            const float* ray_o2, const float* ray_d2,
                            const void* active, const void* lane, unsigned int seed,
                            long long n, int depth, int cnt0, int hide_emitters,
                            int mode, float* out, int* stash_id, float* stash_u,
                            float* stash_v, void* stream) {
  constexpr int kThreads = 256;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  const size_t smem = sizeof(float) * ((9 + kAttrRows) * f_pad +
                                       6 * (f_pad / psdr::kCluster) +
                                       kLightRows * n_light);
  li_mega_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      tri, box, attr, light, misc, f_pad, n_light, ray_o, ray_d, ray_o2, ray_d2,
      static_cast<const unsigned char*>(active), static_cast<const uint32_t*>(lane),
      seed, n, depth, cnt0, hide_emitters, mode, out, stash_id, stash_u, stash_v);
  return static_cast<int>(cudaGetLastError());
}
