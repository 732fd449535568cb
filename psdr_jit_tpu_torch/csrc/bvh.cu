// K1 above 192 triangles, K5 and K6: the closest hit of N rays through a
// per-ray walk of a binary tree over the triangles: leaves of a few
// consecutive ids, each internal node holding its two children's widened
// boxes and links (built once per scene compile by
// psdr_jit_tpu_torch/ops/bvh.py). K1 (192 < F <= 512) and K5 (512 < F <=
// 4096) walk a tree split by surface area with a triangle a leaf
// (build_sah_bvh; psdr_sah_build below builds it on the host for the card's
// route); K6 (F > 4096) one split at the middle of the Morton order, leaves
// of 4 (build_bvh). ops/bvh.py walk_cuda launches it under each name. K1
// up to 192 triangles is the sweep of intersect.cu.
//
// Replaces the TPU kernels _kernel_small / _call_small and _kernel_super /
// _call_super of psdr_jit_tpu/ops/intersect_pallas.py (a cluster-culled
// sweep of 64x128-ray tiles) and _kernel_indexed / _call_indexed of
// psdr_jit_tpu/ops/bvh.py (:253-353), with the machinery around them (ray
// sort, tile-versus-block interval test, fetch lists), which exists because
// TPU lanes cannot index memory per lane. Here one thread traces one ray.
//
// What bounds it on an H100: the tests a ray cannot avoid. A hierarchy of
// boxes must test at least the triangles whose own widened box the ray
// enters before its closest hit, ~46 f32 operations each, against 24 bytes
// read and 16 written a ray. A fixed sweep of clusters in id order tests far
// more as the scene grows: K1's old one-level sweep of 16-triangle clusters
// tested 68 triangles a ray at 492 triangles where ~2.2 were needed, after
// 31 cluster boxes a ray (PERF.md). The tree answers both: each ray
// descends into the nearer child first and stacks the farther one with its
// entry distance, culling it when popped if a closer hit was found since,
// and a large triangle widens only its own small leaf. Node boxes are read
// as float4 pairs through the read-only cache (64 bytes a node; at K1's
// sizes the whole tree is L1-resident). What is left is divergence: rays of
// a warp walk different paths, which is why a few dozen triangles are swept
// instead (intersect.cu).
//
// Dead lanes: a caller's inactive rays (a path that ended, a boundary sample
// that is not valid) report a miss and leave at once. Packing the active
// rays onto full warps first (a pass of its own) halved the dead lanes'
// share of the time on the secondary-edge stand-ins, but cost a frame of
// the 492-triangle gallery, whose launches keep 75-100% of their lanes,
// ~6% (PERF.md); grouping a block's rays by direction, reading them
// through shared memory in 128-bit loads and a "while-while" walk bought
// nothing there either.
//
// Exactness: the visit order is the ray's own, so a hit replaces the best
// when its (t, id) is lexicographically smaller (hit_test_any_order) and a
// box is entered while tnear <= best (box_enter); with the widened boxes
// and the NaN-means-visit rule of sweep.cuh the result is the unculled
// sweep's bit for bit.
#include <algorithm>
#include <cmath>
#include <cstring>
#include <vector>

#include "sweep.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kStack = 32;  // ops/bvh.py STACK: the tree's depth at most

__device__ __forceinline__ int link_of(float w) { return __float_as_int(w); }

// kCount adds each ray's triangle tests and internal-node visits to
// `counts` (n, 2), for the measurements; the walk is the same.
template <bool kCount>
__global__ void __launch_bounds__(kThreads)
    walk_kernel(const float4* __restrict__ tri4, const float4* __restrict__ node,
                const float4* __restrict__ root, const float* __restrict__ ray_o,
                const float* __restrict__ ray_d, const bool* __restrict__ active,
                long long n, float* __restrict__ out_t, int* __restrict__ out_id,
                float* __restrict__ out_uv, int* __restrict__ counts) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  if (!active[i]) {
    psdr::store_hit(psdr::Hit{psdr::kInf, -1, 0.0f, 0.0f}, i, out_t, out_id, out_uv);
    if (kCount) {
      counts[2 * i] = 0;
      counts[2 * i + 1] = 0;
    }
    return;
  }
  psdr::Hit h{psdr::kInf, -1, 0.0f, 0.0f};
  int n_tests = 0, n_visits = 0;
  const float ox = ray_o[3 * i], oy = ray_o[3 * i + 1], oz = ray_o[3 * i + 2];
  const float dx = ray_d[3 * i], dy = ray_d[3 * i + 1], dz = ray_d[3 * i + 2];
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
  // stacked children: link (a, b) and the box's entry distance
  int st_a[kStack], st_b[kStack];
  float st_t[kStack];
  int sp = 0;
  const float4 rlo = __ldg(&root[0]), rhi = __ldg(&root[1]);
  float tn;
  bool live = psdr::box_enter(rlo.x, rlo.y, rlo.z, rhi.x, rhi.y, rhi.z, ox, oy, oz, ix,
                              iy, iz, h.t, &tn);
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
        psdr::hit_test_any_order(h, j, p.x, p.y, p.z, p.w, e.x, e.y, e.z, e.w, g.x, ox,
                                 oy, oz, dx, dy, dz);
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
    const bool vl = psdr::box_enter(l0.x, l0.y, l0.z, l1.x, l1.y, l1.z, ox, oy, oz, ix,
                                    iy, iz, h.t, &tl);
    const bool vr = psdr::box_enter(r0.x, r0.y, r0.z, r1.x, r1.y, r1.z, ox, oy, oz, ix,
                                    iy, iz, h.t, &tr);
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
  psdr::store_hit(h, i, out_t, out_id, out_uv);
  if (kCount) {
    counts[2 * i] = n_tests;
    counts[2 * i + 1] = n_visits;
  }
}

// ---- the area-split tree, on the host -------------------------------------
//
// ops/bvh.py sah_topology and build_sah_bvh in C++, for the card's route:
// the same splits (float64, the same expressions in the same order), the
// same preorder numbering and the same f32 boxes, so the same tables bit
// for bit (the card's tests check it), in microseconds instead of numpy's
// milliseconds. Boxes are min/max of f32 values, exact in any order.

struct Box {
  float lo[3];
  float hi[3];
};

struct SahBuilder {
  const double* lo;  // (f, 3) triangle boxes, float64
  const double* hi;
  const Box* tri_box;  // the same boxes in float32
  int max_leaf;
  double node_cost;
  std::vector<int> child0, child1, height;  // internal nodes, preorder
  std::vector<Box> box;                      // internal nodes' boxes
  std::vector<int> run_first, run_count;     // leaves, in id order
  std::vector<Box> run_box;
  std::vector<double> left, right;            // scratch

  static double area(const double* a, const double* b) {
    const double e0 = b[0] - a[0], e1 = b[1] - a[1], e2 = b[2] - a[2];
    return e0 * e1 + e1 * e2 + e2 * e0;
  }

  static Box join(const Box& a, const Box& b) {
    Box c;
    for (int q = 0; q < 3; ++q) {
      c.lo[q] = std::fmin(a.lo[q], b.lo[q]);
      c.hi[q] = std::fmax(a.hi[q], b.hi[q]);
    }
    return c;
  }

  // A leaf is encoded -1 - its index until every internal node is numbered.
  int leaf(int first, int m, Box* out) {
    Box b = tri_box[first];
    for (int j = first + 1; j < first + m; ++j) b = join(b, tri_box[j]);
    run_first.push_back(first);
    run_count.push_back(m);
    run_box.push_back(b);
    *out = b;
    return -static_cast<int>(run_first.size());
  }

  // Triangles [first, end) -> node, its height and its box.
  int split(int first, int end, int budget, int* h, Box* out) {
    const int m = end - first;
    *h = 0;
    if (m == 1 || budget == 0) return leaf(first, m, out);
    double a[3], b[3];
    for (int q = 0; q < 3; ++q) {
      a[q] = lo[3 * first + q];
      b[q] = hi[3 * first + q];
    }
    left.resize(m);
    right.resize(m);
    for (int k = 1; k < m; ++k) {  // left[k]: the box of the first k
      left[k] = area(a, b);
      for (int q = 0; q < 3; ++q) {
        a[q] = std::fmin(a[q], lo[3 * (first + k) + q]);
        b[q] = std::fmax(b[q], hi[3 * (first + k) + q]);
      }
    }
    const double whole = area(a, b);
    for (int q = 0; q < 3; ++q) {
      a[q] = lo[3 * (end - 1) + q];
      b[q] = hi[3 * (end - 1) + q];
    }
    for (int k = m - 1; k >= 1; --k) {  // right[k]: the box of the last m - k
      right[k] = area(a, b);
      for (int q = 0; q < 3; ++q) {
        a[q] = std::fmin(a[q], lo[3 * (first + k - 1) + q]);
        b[q] = std::fmax(b[q], hi[3 * (first + k - 1) + q]);
      }
    }
    const long long cap = static_cast<long long>(max_leaf) << (budget - 1);
    int at = -1;
    double best = INFINITY;
    for (int k = 1; k < m; ++k) {
      const double cost = (k <= cap && m - k <= cap)
                              ? left[k] * static_cast<double>(k) +
                                    right[k] * static_cast<double>(m - k)
                              : INFINITY;
      if (at < 0 || cost < best) {
        best = cost;
        at = k;
      }
    }
    const double split_cost = node_cost + best / std::fmax(whole, 1e-30);
    if (m <= max_leaf && m <= split_cost) return leaf(first, m, out);
    const int me = static_cast<int>(child0.size());
    child0.push_back(0);
    child1.push_back(0);
    height.push_back(0);
    box.emplace_back();
    int h0, h1;
    Box b0, b1;
    const int c0 = split(first, first + at, budget - 1, &h0, &b0);
    const int c1 = split(first + at, end, budget - 1, &h1, &b1);
    child0[me] = c0;
    child1[me] = c1;
    height[me] = 1 + std::max(h0, h1);
    box[me] = join(b0, b1);
    *h = height[me];
    *out = box[me];
    return me;
  }
};

// The reference (lo.xyz, a, hi.xyz, b) of a node as 8 floats, links
// bit-cast: (internal node, 0) or, for a leaf, (first triangle, -count).
void put_ref(float* out, const Box& b, int a_link, int b_link) {
  for (int q = 0; q < 3; ++q) {
    out[q] = b.lo[q];
    out[4 + q] = b.hi[q];
  }
  std::memcpy(out + 3, &a_link, sizeof(int));
  std::memcpy(out + 7, &b_link, sizeof(int));
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
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* tri = reinterpret_cast<const float4*>(tri4);
  const auto* nd = reinterpret_cast<const float4*>(node);
  const auto* rt = reinterpret_cast<const float4*>(root);
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  if (counts != nullptr) {
    walk_kernel<true><<<blocks, kThreads, 0, s>>>(tri, nd, rt, ray_o, ray_d, active, n,
                                                  t, id, uv, counts);
  } else {
    walk_kernel<false><<<blocks, kThreads, 0, s>>>(tri, nd, rt, ray_o, ray_d, active, n,
                                                   t, id, uv, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

// Host memory: tri (f, 9) float32 rows p0, e1, e2. Builds the area-split
// tree of ops/bvh.py build_sah_bvh (leaves of at most max_leaf, at most
// `stack` internal nodes deep, node_cost = SAH_NODE_COST) into node
// (f - 1, 16) and root (8), float32 in the layouts of psdr_bvh; writes the
// internal nodes' count and the depth. Returns 0, or 1 if f < 1 or the
// triangles do not fit the depth.
extern "C" int psdr_sah_build(const float* tri, int f, int max_leaf, int stack,
                              double node_cost, float* node, float* root,
                              int* n_internal, int* depth) {
  if (f < 1 || static_cast<long long>(f) > (static_cast<long long>(max_leaf) << stack))
    return 1;
  // widened boxes: intersect.widen_boxes of bvh._triangle_boxes, in f32
  std::vector<Box> tb(f);
  std::vector<double> lo(3 * static_cast<size_t>(f)), hi(3 * static_cast<size_t>(f));
  for (int j = 0; j < f; ++j) {
    const float* r = tri + 9 * static_cast<size_t>(j);
    for (int q = 0; q < 3; ++q) {
      const float p = r[q], v1 = p + r[3 + q], v2 = p + r[6 + q];
      const float l = std::fmin(std::fmin(p, v1), v2);
      const float h = std::fmax(std::fmax(p, v1), v2);
      const float m = 1e-3f * (1.0f + std::fmax(std::fabs(l), std::fabs(h)));
      tb[j].lo[q] = l - m;
      tb[j].hi[q] = h + m;
      lo[3 * j + q] = tb[j].lo[q];
      hi[3 * j + q] = tb[j].hi[q];
    }
  }
  SahBuilder sb{lo.data(), hi.data(), tb.data(), max_leaf, node_cost};
  int h = 0;
  Box whole;
  const int top = sb.split(0, f, stack, &h, &whole);
  const int n_int = static_cast<int>(sb.child0.size());
  auto link = [&](int c, int* a, int* b) {  // a child's (a, b) and box
    if (c >= 0) {
      *a = c;
      *b = 0;
      return sb.box[c];
    }
    const int k = -1 - c;
    *a = sb.run_first[k];
    *b = -sb.run_count[k];
    return sb.run_box[k];
  };
  for (int k = 0; k < n_int; ++k) {
    int a, b;
    Box bx = link(sb.child0[k], &a, &b);
    put_ref(node + 16 * static_cast<size_t>(k), bx, a, b);
    bx = link(sb.child1[k], &a, &b);
    put_ref(node + 16 * static_cast<size_t>(k) + 8, bx, a, b);
  }
  int a, b;
  const Box rb = link(top, &a, &b);
  put_ref(root, rb, a, b);
  *n_internal = n_int;
  *depth = h;
  return 0;
}

extern "C" const char* psdr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
