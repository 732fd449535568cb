// K2: the detached PathTracer Li, one path a thread, in one launch.
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
//  * Tables (triangles, boxes, 17 attribute rows, the light table, two
//    scalars) are staged in shared memory once per block of a persistent
//    grid (as many blocks as the SMs hold, each looping over the lanes): the
//    counterpart of SMEM scalar prefetch. At the 192-triangle limit they
//    take at most 37 KiB, and each warp's sweep queue 1.5 KiB more.
//  * Hit attributes are read by hit id. The TPU kernel re-swept the
//    triangles with masked selects because its lanes cannot index VMEM.
//  * The static depth/hide_emitters/n_light/mode of the TPU trace are
//    runtime arguments; depth is a loop.
//  * The hit point p + d * t is one fmaf, rounded once, as in the plain
//    version and in the JAX package on the CPU (XLA contracts it): an ulp
//    in a secondary-ray origin flips grazing self-intersection tests
//    against RAY_EPSILON on about 1% of the Cornell box's lanes. The stash
//    mode's bilinear origin is two fmafs for the same reason.
//  * sin/cos of the bounce use the same short polynomials as the plain
//    version (common.cuh), so no device library routine differs between
//    the two.
//
// What bounds it on an H100: the closest-hit sweeps, 1 + 2 * depth a lane,
// most of its time (the rest is shading; PERF.md has the split): instruction
// issue and latency of ~55 f32 and shared-memory instructions a (ray,
// triangle) test and ~25-30 a box test, multiplied by divergence, since a
// warp runs a test when any of its lanes needs it. A pixel's 32 camera rays are coherent;
// its bounce rays and the rays after them scatter, and an edge sample's
// rays scatter from the start. The bytes are few (28 in and 12 out a lane,
// 12 more a hit in stash mode), far from the memory bound. The design:
//  * the tables' triangles as rows of three float4, three 128-bit shared
//    loads a test in place of nine 32-bit ones, and a box for each run of
//    kGroup = 2 triangles (a quad) inside each 16-triangle cluster, built
//    from the staged triangles; a box test leaves out the NaN check where
//    no ray of the warp can make one (sweep.cuh box_visit4);
//  * coherent sweeps (a path's first `coherent_sweeps`: camera and first
//    NEE in single and stash mode, none in pair mode) cull clusters and runs
//    for the whole warp (sweep.cuh sweep_grouped): the warp skips what no
//    lane needs;
//  * scattered sweeps queue each lane's own (ray, run) pairs and test them
//    32 at a time (sweep.cuh sweep_queued), so the warp runs the tests its
//    lanes need, not their union; a lane whose result is not used (a dead
//    path, NEE off an emitter, an invalid bounce; single and pair mode)
//    queues none, and a warp whose paths are all dead stops. Stash mode
//    sweeps every lane: K3 and K4 read all its hits;
//  * pair mode runs one path a thread: ray_n and ray_p of a lane on
//    neighbouring threads, the difference taken with a warp shuffle;
//  * one sweep site in the path loop, and 64 registers a thread (four
//    blocks of 256 an SM): latency, not issue alone, held the sweeps back.
// Every hit, and so every bit of the output, is the plain version's.
// Defining PSDR_K2_COUNTS makes a counting build (see count_sweep below),
// for the measurements; the package's build counts nothing.
// Hopper's tensor cores, wgmma and TMA do not apply: the hit test must stay
// f32 and bit-exact (TF32 would change the hits), and the only data a
// block copies is its tables.
#include "common.cuh"
#include "sweep.cuh"

namespace {

using psdr::V3;

constexpr int kAttrRows = 17;
constexpr int kLightRows = 14;
constexpr int kModeSingle = 0;
constexpr int kModePair = 1;
constexpr int kModeStash = 2;
// Triangles of one culling run inside a 16-triangle cluster (sweep.cuh):
// 2, a quad, was the fastest of 2, 4, 8 and 16 in every mode on the H100
// (PERF.md). Other sizes are measured on edited copies of this file.
constexpr int kGroup = 2;

struct Surface {
  V3 ns;     // unit shading normal
  V3 fn;     // unit face normal
  V3 alb;    // albedo
  V3 emit;   // emitted radiance
  bool is_em;
};

// Attributes of hit `id` at barycentrics (u, v); zeros for a miss.
__device__ __forceinline__ Surface resolve(const float* __restrict__ attr,
                                           const float4* __restrict__ tri,
                                           int f_pad, int id, float u, float v) {
  Surface s{};
  if (id < 0) return s;
  const float4 r0 = tri[3 * id], r1 = tri[3 * id + 1], r2 = tri[3 * id + 2];
  const float e1x = r0.w, e1y = r1.x, e1z = r1.y;
  const float e2x = r1.z, e2y = r1.w, e2z = r2.x;
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
  const float4* tri;   // (f_pad, 3) rows
  const float4* cbox;  // (f_pad / 16, 2), widened
  const float4* gbox;  // (f_pad / kGroup, 2), widened
  const float* attr;
  const float* light;
  int f_pad;
  int n_light;
  float total_mass;
  float inv_area;
};

// Records hit `k` of lane `i` in stash mode.
struct Stash {
  int* ids;
  float* u;
  float* v;
  long long n;
  long long i;
  __device__ __forceinline__ void put(int k, const psdr::Hit& h) const {
    ids[k * n + i] = h.id;
    u[k * n + i] = h.u;
    v[k * n + i] = h.v;
  }
};

// The closest hit of one ray against the block's tables, for all 32 lanes
// of a warp together; `need`: this lane's hit is used (else a miss);
// `coherent`: the warp's rays are coherent (the warp-decided culling),
// else they scatter (the compacted sweep).
__device__ __forceinline__ psdr::Hit closest_hit(const Tables& tb, psdr::WarpQueue& q,
                                                 bool coherent, bool need, V3 o, V3 d,
                                                 psdr::Tally& tally) {
  const int nc = tb.f_pad / psdr::kCluster;
  return coherent
             ? psdr::sweep_grouped<kGroup>(tb.tri, tb.cbox, tb.gbox, nc, need, o.x, o.y,
                                           o.z, d.x, d.y, d.z, tally)
             : psdr::sweep_queued<kGroup>(tb.tri, tb.cbox, tb.gbox, nc, q, need, o.x,
                                          o.y, o.z, d.x, d.y, d.z, tally);
}

#ifdef PSDR_K2_COUNTS
// The counting build: for each sweep of a path (slot s = 0 .. 2 * depth:
// camera, then NEE and bounce of each depth), summed over a launch, the
// warps that make it, the lanes whose hit is used (`need`), and the box
// tests and (ray, triangle) tests the warps run (sweep.cuh Tally);
// psdr_k2_counts reads and clears the sums. Its hits are the package's.
constexpr int kCountSlots = 16;
__device__ unsigned long long g_counts[kCountSlots][4];

__device__ __forceinline__ void count_sweep(int s, bool need, const psdr::Tally& t) {
  const unsigned used = __popc(__ballot_sync(psdr::kFullWarp, need));
  if ((threadIdx.x & (psdr::kWarp - 1)) == 0 && s < kCountSlots) {
    atomicAdd(&g_counts[s][0], 1ull);
    atomicAdd(&g_counts[s][1], static_cast<unsigned long long>(used));
    atomicAdd(&g_counts[s][2], static_cast<unsigned long long>(t.box));
    atomicAdd(&g_counts[s][3], static_cast<unsigned long long>(t.tri));
  }
}
#endif

// The detached Li of one ray (eval_li of the TPU kernel), called by all 32
// lanes of a warp together (`live`: the lane holds a ray). Its 1 + 2*depth
// sweeps (camera, then NEE and bounce of each depth) are the iterations of
// one loop with one sweep in it, so the sweep's code is in the kernel once.
// kStash: stash mode, every sweep of a live lane made and recorded;
// otherwise a lane sweeps only where its result is used, and the warp stops
// once all its paths are dead (see the note at the top). The first
// `coherent_sweeps` sweeps take the warp-decided culling, the rest the
// compacted sweep.
template <bool kStash>
__device__ V3 eval_li(const Tables& tb, psdr::WarpQueue& q, bool live, V3 o, V3 d,
                      bool active, uint32_t lane, uint32_t cnt, uint32_t seed, int depth,
                      bool hide_emitters, int coherent_sweeps, const Stash& st) {
  using psdr::dot3;
  using psdr::safe_div;
  const int f_pad = tb.f_pad;
  V3 res{0.0f, 0.0f, 0.0f};
  V3 thr{1.0f, 1.0f, 1.0f};
  Surface its{};  // the surface at p, hit by direction d
  V3 p = o;
  // what a slot computes before its sweep and uses after it
  float wiz_cam = 0.0f, dist_sqr = 0.0f, dist = 0.0f, lz = 0.0f;
  bool active_direct = false, bs_valid = false;
  for (int s = 0; s <= 2 * depth; ++s) {
    // a dead path adds 0 to every later term
    if (!kStash && !__any_sync(psdr::kFullWarp, active)) break;
    const bool nee = (s & 1) != 0;
    V3 ray_d = d;
    bool need = kStash ? live : active;
    if (s > 0 && nee) {
      // ---- next-event estimation (path.cpp:47-83) ----
      wiz_cam = -dot3(its.ns, d);
      const psdr::F4 u_nee = psdr::draw(lane, cnt++, seed);
      active_direct = active && !its.is_em;
      // off an emitter the NEE term is 0 whatever the sweep finds
      need = kStash ? live : active_direct;
      const V3 pl = sample_light(tb.light, tb.n_light, tb.total_mass, u_nee.x, u_nee.y);
      V3 wod = psdr::sub3(pl, p);
      dist_sqr = dot3(wod, wod);
      dist = psdr::safe_sqrt(dist_sqr);
      const float inv_dist = safe_div(1.0f, dist);
      ray_d = psdr::scale3(wod, inv_dist);
    } else if (s > 0) {
      // ---- BSDF bounce (path.cpp:85-123) ----
      bs_valid = active && wiz_cam > 0.0f;
      // an invalid bounce ends the path: its terms and all later ones are 0
      need = kStash ? live : bs_valid;
      const psdr::F4 u_b = psdr::draw(lane, cnt++, seed);
      const V3 l = psdr::cosine_hemisphere(u_b.y, u_b.z);
      lz = l.z;
      const V3 n = its.ns;
      const float sign = n.z >= 0.0f ? 1.0f : -1.0f;
      const float fa = -1.0f / (sign + n.z);
      const float fb = n.x * n.y * fa;
      const V3 sf{sign * n.x * n.x * fa + 1.0f, sign * fb, -sign * n.x};
      const V3 tf{fb, sign + n.y * n.y * fa, -n.y};
      ray_d = {sf.x * l.x + tf.x * l.y + n.x * l.z, sf.y * l.x + tf.y * l.y + n.y * l.z,
               sf.z * l.x + tf.z * l.y + n.z * l.z};
    }
    psdr::Tally tally;
    const psdr::Hit h = closest_hit(tb, q, s < coherent_sweeps, need, p, ray_d, tally);
#ifdef PSDR_K2_COUNTS
    count_sweep(s, need, tally);
#endif
    if (kStash && live) st.put(s, h);
    const Surface hs = resolve(tb.attr, tb.tri, f_pad, h.id, h.u, h.v);
    if (s == 0) {
      active = active && h.id >= 0;
      its = hs;
      if (!hide_emitters && active && its.is_em && -dot3(its.ns, d) > 0.0f)
        res = its.emit;
      p = {fmaf(d.x, h.t, o.x), fmaf(d.y, h.t, o.y), fmaf(d.z, h.t, o.z)};
    } else if (nee) {
      const V3 wod = ray_d;
      const bool hit_light = active_direct && h.id >= 0 &&
                             h.t > dist - psdr::kShadowEpsilon && hs.is_em;
      const float g_val = safe_div(fabsf(-dot3(hs.fn, wod)), dist_sqr);
      const bool le_ok = h.id >= 0 && hs.is_em && -dot3(hs.ns, wod) > 0.0f;
      const V3 e = le_ok ? hs.emit : V3{0.0f, 0.0f, 0.0f};
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
    } else {
      const V3 wo = ray_d;
      const float bs_pdf = psdr::kInvPi * lz;
      const bool valid2 = h.id >= 0;
      active = bs_valid && valid2;
      const float g2 = valid2
          ? safe_div(fabsf(-dot3(hs.fn, wo)), fmaxf(h.t * h.t, psdr::kTiny))
          : 1.0f;
      const float pdf0 = bs_pdf * g2;
      const bool f2_ok = wiz_cam > 0.0f && lz > 0.0f && h.t >= psdr::kEpsilon;
      const float bw = (f2_ok && active) ? 1.0f : 0.0f;
      thr = {thr.x * its.alb.x * bw, thr.y * its.alb.y * bw, thr.z * its.alb.z * bw};
      const float e_pdf = (valid2 && hs.is_em) ? tb.inv_area : 0.0f;
      const float weight2 = psdr::mis_weight(pdf0, e_pdf);
      const float lscale =
          (active && hs.is_em && -dot3(hs.ns, wo) > 0.0f) ? weight2 : 0.0f;
      res.x = res.x + thr.x * hs.emit.x * lscale;
      res.y = res.y + thr.y * hs.emit.y * lscale;
      res.z = res.z + thr.z * hs.emit.z * lscale;
      if (kStash) {
        // bilinear point of the path-space formulation; zero for a miss
        if (valid2) {
          const float4 r0 = tb.tri[3 * h.id], r1 = tb.tri[3 * h.id + 1],
                       r2 = tb.tri[3 * h.id + 2];
          p = {fmaf(r1.z, h.v, fmaf(r0.w, h.u, r0.x)),
               fmaf(r1.w, h.v, fmaf(r1.x, h.u, r0.y)),
               fmaf(r2.x, h.v, fmaf(r1.y, h.u, r0.z))};
        } else {
          p = {0.0f, 0.0f, 0.0f};
        }
      } else {
        p = {fmaf(wo.x, h.t, p.x), fmaf(wo.y, h.t, p.y), fmaf(wo.z, h.t, p.z)};
      }
      d = wo;
      its = hs;
    }
  }
  return res;
}

constexpr int kThreads = 256;
// Four blocks an SM: registers capped at 64 a thread, with some spill.
// Uncapped the kernel took up to 117 registers (two blocks an SM) and ran
// ~18% longer; with three blocks ~4% longer, with five or more longer
// again (PERF.md).
constexpr int kBlocksPerSm = 4;

// Shared memory of the tables, in bytes.
size_t table_bytes(int f_pad, int n_light) {
  return sizeof(psdr::WarpQueue) * (kThreads / psdr::kWarp) +
         sizeof(float4) *
             (3 * f_pad + 2 * (f_pad / psdr::kCluster) + 2 * (f_pad / kGroup)) +
         sizeof(float) * (kAttrRows * f_pad + kLightRows * n_light);
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    li_mega_kernel(const float* __restrict__ tri_g, const float* __restrict__ box_g,
                   const float* __restrict__ attr_g,
                   const float* __restrict__ light_g,
                   const float* __restrict__ misc_g, int f_pad, int n_light,
                   const float* __restrict__ ray_o, const float* __restrict__ ray_d,
                   const float* __restrict__ ray_o2, const float* __restrict__ ray_d2,
                   const unsigned char* __restrict__ active_g,
                   const uint32_t* __restrict__ lane_g, uint32_t seed,
                   long long n, int depth, int cnt0, int hide_emitters, int mode,
                   int coherent_sweeps, float* __restrict__ out, int* __restrict__ stash_id,
                   float* __restrict__ stash_u, float* __restrict__ stash_v) {
  extern __shared__ float4 smem4[];
  const int nc = f_pad / psdr::kCluster;
  auto* s_queue = reinterpret_cast<psdr::WarpQueue*>(smem4);
  float4* s_tri = reinterpret_cast<float4*>(s_queue + kThreads / psdr::kWarp);
  float4* s_cbox = s_tri + 3 * f_pad;
  float4* s_gbox = s_cbox + 2 * nc;
  float* s_attr = reinterpret_cast<float*>(s_gbox + 2 * (f_pad / kGroup));
  float* s_light = s_attr + kAttrRows * f_pad;
  __shared__ float s_misc[2];
  for (int k = threadIdx.x; k < kAttrRows * f_pad; k += blockDim.x) s_attr[k] = attr_g[k];
  for (int k = threadIdx.x; k < kLightRows * n_light; k += blockDim.x)
    s_light[k] = light_g[k];
  for (int k = threadIdx.x; k < 2; k += blockDim.x) s_misc[k] = misc_g[k];
  psdr::stage_table<kGroup>(tri_g, box_g, f_pad, s_tri, s_cbox, s_gbox);

  const Tables tb{s_tri, s_cbox, s_gbox, s_attr, s_light, f_pad, n_light, s_misc[0],
                  s_misc[1]};
  psdr::WarpQueue& q = s_queue[threadIdx.x / psdr::kWarp];
  const bool pair = mode == kModePair;
  const long long work = pair ? 2 * n : n;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  // The loop's trip count is the same for every thread of a block, so all
  // 32 lanes of a warp call eval_li together, as its sweeps need, and reach
  // the pair mode's shuffle; a lane past the end holds no ray.
  for (long long w0 = static_cast<long long>(blockIdx.x) * blockDim.x; w0 < work;
       w0 += stride) {
    const long long w = w0 + threadIdx.x;
    const bool live = w < work;
    // pair mode: thread 2i evaluates ray_n of lane i, thread 2i + 1 ray_p
    const long long i = live ? (pair ? w >> 1 : w) : 0;
    const int side = pair ? static_cast<int>(w & 1) : 0;
    const float* ro = side ? ray_o2 : ray_o;
    const float* rd = side ? ray_d2 : ray_d;
    const V3 o = live ? V3{ro[3 * i], ro[3 * i + 1], ro[3 * i + 2]} : V3{0.0f, 0.0f, 0.0f};
    const V3 d = live ? V3{rd[3 * i], rd[3 * i + 1], rd[3 * i + 2]} : V3{0.0f, 0.0f, 1.0f};
    const bool act = live && active_g[i] != 0;
    const uint32_t c0 = static_cast<uint32_t>(cnt0 + side * 2 * depth);
    V3 res = mode == kModeStash
                 ? eval_li<true>(tb, q, live, o, d, act, lane_g[i], c0, seed, depth,
                                    hide_emitters != 0, coherent_sweeps,
                                    Stash{stash_id, stash_u, stash_v, n, i})
                 : eval_li<false>(tb, q, live, o, d, act, lane_g[i], c0, seed, depth,
                                     hide_emitters != 0, coherent_sweeps, Stash{});
    if (pair) {
      const V3 res_p{__shfl_down_sync(0xffffffffu, res.x, 1),
                     __shfl_down_sync(0xffffffffu, res.y, 1),
                     __shfl_down_sync(0xffffffffu, res.z, 1)};
      res = psdr::sub3(res, res_p);
    }
    if (live && side == 0) {
      out[3 * i] = res.x;
      out[3 * i + 1] = res.y;
      out[3 * i + 2] = res.z;
    }
  }
}

// As many blocks as the SMs hold at once, no more than the lanes fill.
int launch(const float* tri, const float* box, const float* attr, const float* light,
           const float* misc, int f_pad, int n_light, const float* ray_o,
           const float* ray_d, const float* ray_o2, const float* ray_d2,
           const unsigned char* active, const uint32_t* lane, unsigned int seed,
           long long n, int depth, int cnt0, int hide_emitters, int mode,
           int coherent_sweeps, float* out, int* stash_id, float* stash_u, float* stash_v,
           cudaStream_t stream) {
  const size_t smem = table_bytes(f_pad, n_light);
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(li_mega_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, li_mega_kernel, kThreads,
                                                      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long work = mode == kModePair ? 2 * n : n;
  const long long needed = (work + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(n_sm) * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = static_cast<unsigned>(needed < most ? needed : most);
  li_mega_kernel<<<blocks, kThreads, smem, stream>>>(
      tri, box, attr, light, misc, f_pad, n_light, ray_o, ray_d, ray_o2, ray_d2, active,
      lane, seed, n, depth, cnt0, hide_emitters, mode, coherent_sweeps, out, stash_id,
      stash_u, stash_v);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Tables as in psdr_jit_tpu_torch/ops/megakernel.py build_tables: tri
// (9, f_pad), box (6, f_pad / 16), attr (17, f_pad), light (14, n_light),
// misc (2); rays (n, 3), the second pair (ray_o2, ray_d2) read in pair mode
// only; active (n, bool); lane (n, u32). mode: 0 single, 1 pair, 2 stash;
// coherent_sweeps: how many of a path's first sweeps take the warp-decided
// culling (the rest take the compacted sweep). Writes out (n, 3) and,
// in stash mode, stash_id (1 + 2*depth, n) int32 and stash_u, stash_v
// (1 + 2*depth, n). Launches on `stream` and returns cudaGetLastError().
extern "C" int psdr_li_mega(const float* tri, const float* box, const float* attr,
                            const float* light, const float* misc, int f_pad,
                            int n_light, const float* ray_o, const float* ray_d,
                            const float* ray_o2, const float* ray_d2,
                            const void* active, const void* lane, unsigned int seed,
                            long long n, int depth, int cnt0, int hide_emitters,
                            int mode, int coherent_sweeps, float* out,
                            int* stash_id, float* stash_u, float* stash_v, void* stream) {
  return launch(tri, box, attr, light, misc, f_pad, n_light, ray_o, ray_d, ray_o2, ray_d2,
                static_cast<const unsigned char*>(active), static_cast<const uint32_t*>(lane),
                seed, n, depth, cnt0, hide_emitters, mode, coherent_sweeps, out, stash_id,
                stash_u, stash_v, static_cast<cudaStream_t>(stream));
}

#ifdef PSDR_K2_COUNTS
// The counting build's sums since the last call, (16, 4) u64 as count_sweep
// describes them, into `out` (host memory); then clears them. Waits for the
// device. Returns the CUDA error code.
extern "C" int psdr_k2_counts(unsigned long long* out) {
  static const unsigned long long zero[kCountSlots][4] = {};
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(out, g_counts, sizeof(g_counts));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_counts, zero, sizeof(zero));
  return static_cast<int>(e);
}
#endif
