// K6: closest hit of N rays against F > 4096 triangles through a per-ray
// traversal of a binary tree over the Morton-ordered triangles: leaves of a
// few consecutive ids, each internal node holding its two children's widened
// boxes and links (built once per scene compile by
// psdr_jit_tpu_torch/ops/bvh.py build_bvh).
//
// Replaces the TPU kernel _kernel_indexed / _call_indexed of
// psdr_jit_tpu/ops/bvh.py (:253-353) and the machinery around it (ray sort,
// tile-versus-block interval test, fetch lists), which exists because TPU
// lanes cannot index memory per lane. Here one thread traces one ray.
//
// What bounds it on an H100: the tests a ray cannot avoid. A hierarchy of
// boxes must test at least the triangles whose own widened box the ray
// enters before its closest hit, ~46 f32 operations each, against 24 bytes
// read and 16 written a ray. The fixed block/cluster hierarchy this kernel
// replaced tested ~510 triangles a ray on the gallery: it walked every
// block box in id order, so the best hit shrank late, and the room's large
// triangles widened the 64-triangle clusters they sit in, which every ray
// then swept whole. The tree answers both: each ray descends into the
// nearer child first and stacks the farther one with its entry distance,
// culling it when popped if a closer hit was found since, and a large
// triangle widens only its own small leaf. Node boxes are read as float4
// pairs through the read-only cache (64 bytes a node, 1.6 MB at 102,412
// triangles, L2-resident). What is left is divergence: rays of a warp walk
// different paths (ray sorting and wider nodes are later work).
//
// Exactness: the visit order is the ray's own, so a hit replaces the best
// when its (t, id) is lexicographically smaller (hit_test_any_order) and a
// box is entered while tnear <= best (box_enter); with the widened boxes
// and the NaN-means-visit rule of sweep.cuh the result is the unculled
// sweep's bit for bit.
#include "sweep.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kStack = 32;  // ops/bvh.py STACK: the tree's depth at most

__device__ __forceinline__ int link_of(float w) { return __float_as_int(w); }

// kCount adds each ray's triangle tests and internal-node visits to
// `counts` (n, 2), for the measurements; the traversal is the same.
template <bool kCount>
__global__ void __launch_bounds__(kThreads)
    bvh_kernel(const float4* __restrict__ tri4, const float4* __restrict__ node,
               const float4* __restrict__ root, const float* __restrict__ ray_o,
               const float* __restrict__ ray_d, const bool* __restrict__ active,
               long long n, float* __restrict__ out_t, int* __restrict__ out_id,
               float* __restrict__ out_uv, int* __restrict__ counts) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  psdr::Hit h{psdr::kInf, -1, 0.0f, 0.0f};
  int n_tests = 0, n_visits = 0;
  if (active[i]) {
    const float ox = ray_o[3 * i], oy = ray_o[3 * i + 1], oz = ray_o[3 * i + 2];
    const float dx = ray_d[3 * i], dy = ray_d[3 * i + 1], dz = ray_d[3 * i + 2];
    const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
    // stacked children: link (a, b) and the box's entry distance
    int st_a[kStack], st_b[kStack];
    float st_t[kStack];
    int sp = 0;
    const float4 rlo = __ldg(&root[0]), rhi = __ldg(&root[1]);
    float tn;
    bool live = psdr::box_enter(rlo.x, rlo.y, rlo.z, rhi.x, rhi.y, rhi.z, ox, oy,
                                oz, ix, iy, iz, h.t, &tn);
    int a = link_of(rlo.w), b = link_of(rhi.w);
    while (true) {
      if (!live) {
        while (sp > 0) {
          --sp;
          if (st_t[sp] <= h.t) {
            a = st_a[sp];
            b = st_b[sp];
            live = true;
            break;
          }
        }
        if (!live) break;
      }
      if (b < 0) {  // a leaf: triangles a .. a - b - 1
        for (int j = a; j < a - b; ++j) {
          const float4 p = __ldg(&tri4[3 * j]);
          const float4 e = __ldg(&tri4[3 * j + 1]);
          const float4 g = __ldg(&tri4[3 * j + 2]);
          psdr::hit_test_any_order(h, j, p.x, p.y, p.z, p.w, e.x, e.y, e.z, e.w,
                                   g.x, ox, oy, oz, dx, dy, dz);
        }
        if (kCount) n_tests -= b;
        live = false;
        continue;
      }
      if (kCount) ++n_visits;
      const float4* nd = node + 4 * static_cast<long long>(a);
      const float4 l0 = __ldg(nd), l1 = __ldg(nd + 1);
      const float4 r0 = __ldg(nd + 2), r1 = __ldg(nd + 3);
      float tl, tr;
      const bool vl = psdr::box_enter(l0.x, l0.y, l0.z, l1.x, l1.y, l1.z, ox, oy,
                                      oz, ix, iy, iz, h.t, &tl);
      const bool vr = psdr::box_enter(r0.x, r0.y, r0.z, r1.x, r1.y, r1.z, ox, oy,
                                      oz, ix, iy, iz, h.t, &tr);
      int la = link_of(l0.w), lb = link_of(l1.w);
      int ra = link_of(r0.w), rb = link_of(r1.w);
      if (vl && vr) {
        if (tr < tl) {  // the right child first
          const int ta = la, tb = lb;
          const float tt = tl;
          la = ra;
          lb = rb;
          tl = tr;
          ra = ta;
          rb = tb;
          tr = tt;
        }
        st_a[sp] = ra;
        st_b[sp] = rb;
        st_t[sp] = tr;
        ++sp;
        a = la;
        b = lb;
      } else if (vl) {
        a = la;
        b = lb;
      } else if (vr) {
        a = ra;
        b = rb;
      } else {
        live = false;
      }
    }
    if (!(h.t < psdr::kInf)) h = psdr::Hit{psdr::kInf, -1, 0.0f, 0.0f};
  }
  out_t[i] = h.t;
  out_id[i] = h.id;
  out_uv[2 * i] = h.u;
  out_uv[2 * i + 1] = h.v;
  if (kCount) {
    counts[2 * i] = n_tests;
    counts[2 * i + 1] = n_visits;
  }
}

}  // namespace

// tri4 (F, 12), node (n_internal, 16), root (8): float32 device arrays in
// the layouts of ops/bvh.py BVH (links bit-cast into the w lanes); ray_o,
// ray_d (n, 3) float32; active (n) bool; outputs t (n), id (n, int32, -1 =
// miss), uv (n, 2); counts (n, 2) int32 or null. The tree must be at most
// 32 internal nodes deep (the wrapper checks). Launches on `stream` and
// returns cudaGetLastError().
extern "C" int psdr_bvh(const float* tri4, const float* node, const float* root,
                        const float* ray_o, const float* ray_d, const bool* active,
                        long long n, float* t, int* id, float* uv, int* counts,
                        void* stream) {
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* tri = reinterpret_cast<const float4*>(tri4);
  const auto* nd = reinterpret_cast<const float4*>(node);
  const auto* rt = reinterpret_cast<const float4*>(root);
  if (counts != nullptr) {
    bvh_kernel<true><<<blocks, kThreads, 0, s>>>(tri, nd, rt, ray_o, ray_d, active,
                                                 n, t, id, uv, counts);
  } else {
    bvh_kernel<false><<<blocks, kThreads, 0, s>>>(tri, nd, rt, ray_o, ray_d, active,
                                                  n, t, id, uv, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}
