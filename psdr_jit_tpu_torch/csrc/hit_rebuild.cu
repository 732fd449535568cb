// K7: the closest hit rebuilt from the closest-hit kernels' payload, with
// its forward-mode tangent (K7-jvp) and its adjoint (K7-vjp).
//
// SceneData.ray_intersect turns the payload (tri_id, valid, u, v) of K1, K5
// or K6 into an Intersection: the hit point, distance, face and shading
// normals, shading frame, incident direction in that frame, Jacobian,
// texture coordinates and UV tangents, mesh and vertex ids. Written in
// PyTorch that is ~80 elementwise launches over (N, 3) tensors a ray set,
// ~230-300 with forward-mode tangents, each a read and a write of the
// lanes. Here one thread rebuilds one lane (hit_rebuild.cuh), reading its
// payload, its ray and its face's rows and writing each field once.
//
// There is no TPU kernel behind it: the JAX package rebuilds the hit with
// XLA, which fuses the elementwise work itself.
//
// K7-vjp sums each lane's row cotangents (22 floats) into its face's row,
// as the plain version's gather backward does (ops/gather.py). Up to
// kSharedRows rows (ops/gather.py BINCOUNT_MAX_ROWS) each block of a
// persistent grid keeps its partial table in shared memory (45 KiB at 512
// rows): the lanes of a warp that add to the same row are summed with
// shuffles first (shade.cuh group_add), and one lane adds the sums; the
// block then adds its nonzero partials into the output with one global
// atomic an entry. Above, the warp sums go to global atomics directly, one
// launch block a 256 lanes. Where the corner UVs carry a derivative (a
// textured scene whose vertex UVs are optimised), their cotangents (6
// floats a row) go to global atomics the same way. The float sums are
// reordered from run to run, so their last bits vary, as K4's do.
//
// What bounds it on an H100: bytes. The forward reads 24 B a lane (36 in
// solid mode) and the face rows (L2-resident at the box's 32 rows), and
// writes 84 (more with UVs or per-vertex ids); nvcc contracts nothing.
#include <cuda_runtime.h>

#include "hit_rebuild.cuh"
#include "shade.cuh"

namespace {

namespace hr = psdr::hit;
using hr::V;

constexpr int kThreads = 256;
constexpr int kSharedRows = 512;

struct Tables {
  const float* tab;   // (rows, kCols)
  const int* ints;    // (rows, kInts)
  const float* uvt;   // (rows, 6), scenes with UVs
  const float* tab_t; // (rows, kCols) tangent or nullptr (K7-jvp)
  const float* uvt_t; // (rows, 6) tangent or nullptr (K7-jvp)
  int rows;
};

struct Lanes {
  const int* tri_id;  // (n,)
  const float* uv;    // (n, 2) the payload's barycentrics
  const float* o;     // (n, 3)
  const float* d;     // (n, 3), solid mode
  const float* o_t;   // tangents or nullptr (K7-jvp)
  const float* d_t;
  long long n;
};

// The differentiable fields, in the order of ops/hit_rebuild.py FIELDS;
// outputs of K7 and K7-jvp, cotangents (nullptr: none) of K7-vjp.
struct Fields {
  float *t, *p, *n, *s, *tf, *sn, *wi, *J, *bc, *iuv, *dpdu, *dpdv;
};
constexpr int kFields = 12;

__device__ __forceinline__ void put3(float* x, long long i, const V& v) {
  x[3 * i] = v.x;
  x[3 * i + 1] = v.y;
  x[3 * i + 2] = v.z;
}
__device__ __forceinline__ void put3d(float* x, long long i, const hr::Vec<hr::Dual>& v) {
  x[3 * i] = v.x.d;
  x[3 * i + 1] = v.y.d;
  x[3 * i + 2] = v.z.d;
}
__device__ __forceinline__ float get1(const float* x, long long i) {
  return x == nullptr ? 0.0f : x[i];
}
__device__ __forceinline__ V get3(const float* x, long long i) {
  if (x == nullptr) return {0.0f, 0.0f, 0.0f};
  return {x[3 * i], x[3 * i + 1], x[3 * i + 2]};
}
__device__ __forceinline__ int row_of(const int* tri_id, long long i) {
  const int id = tri_id[i];
  return id < 0 ? 0 : id;
}
template <bool HasUV>
__device__ __forceinline__ hr::Corners<float> corners(const Tables& T, int row) {
  return HasUV ? hr::load_corners(T.uvt + 6LL * row) : hr::Corners<float>{};
}

template <bool Solid, bool HasUV, bool HasPV>
__global__ void __launch_bounds__(kThreads)
    k7_kernel(Tables T, Lanes L, Fields F, int* __restrict__ mesh_id, int* __restrict__ fi) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= L.n) return;
  const int row = row_of(L.tri_id, i);
  const int* ri = T.ints + static_cast<long long>(row) * hr::kInts;
  const hr::Row<float> r = hr::load_row(T.tab + static_cast<long long>(row) * hr::kCols);
  const V o = get3(L.o, i);
  const V d = Solid ? get3(L.d, i) : V{0.0f, 0.0f, 0.0f};
  const hr::Hit<float> h = hr::rebuild<float, Solid, HasUV>(r, ri[0] != 0, corners<HasUV>(T, row),
                                                            L.uv[2 * i], L.uv[2 * i + 1], o, d);
  F.t[i] = h.t;
  put3(F.p, i, h.p);
  put3(F.n, i, r.fn);
  put3(F.s, i, h.s);
  put3(F.tf, i, h.tf);
  put3(F.sn, i, h.sn);
  put3(F.wi, i, h.wi);
  F.J[i] = h.J;
  if (Solid) {
    F.bc[2 * i] = h.u;
    F.bc[2 * i + 1] = h.v;
  }
  if (HasUV) {
    F.iuv[2 * i] = h.iu;
    F.iuv[2 * i + 1] = h.iv;
    put3(F.dpdu, i, h.dpdu);
    put3(F.dpdv, i, h.dpdv);
  }
  mesh_id[i] = ri[1];
  if (HasPV) {
    fi[3 * i] = ri[2];
    fi[3 * i + 1] = ri[3];
    fi[3 * i + 2] = ri[4];
  }
}

__device__ __forceinline__ hr::Vec<hr::Dual> dual3(const float* x, const float* x_t,
                                                   long long i) {
  const V v = get3(x, i), t = get3(x_t, i);
  return {{v.x, t.x}, {v.y, t.y}, {v.z, t.z}};
}

template <bool Solid, bool HasUV>
__global__ void __launch_bounds__(kThreads) k7_jvp_kernel(Tables T, Lanes L, Fields F) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= L.n) return;
  const int row = row_of(L.tri_id, i);
  const long long off = static_cast<long long>(row) * hr::kCols;
  const hr::Row<hr::Dual> r =
      hr::dual_row(T.tab + off, T.tab_t == nullptr ? nullptr : T.tab_t + off);
  const hr::Vec<hr::Dual> o = dual3(L.o, L.o_t, i);
  const hr::Vec<hr::Dual> d =
      Solid ? dual3(L.d, L.d_t, i) : hr::Vec<hr::Dual>{{0, 0}, {0, 0}, {0, 0}};
  const hr::Corners<hr::Dual> c =
      HasUV ? hr::dual_corners(T.uvt + 6LL * row, T.uvt_t == nullptr ? nullptr : T.uvt_t + 6LL * row)
            : hr::Corners<hr::Dual>{};
  const hr::Hit<hr::Dual> h = hr::rebuild<hr::Dual, Solid, HasUV>(
      r, T.ints[static_cast<long long>(row) * hr::kInts] != 0, c, L.uv[2 * i], L.uv[2 * i + 1],
      o, d);
  // a field no input tangent reaches has no output (ops/hit_rebuild.py
  // _tangent_shapes)
  if (F.t != nullptr) F.t[i] = h.t.d;
  if (F.p != nullptr) put3d(F.p, i, h.p);
  if (F.n != nullptr) put3d(F.n, i, r.fn);
  if (F.s != nullptr) put3d(F.s, i, h.s);
  if (F.tf != nullptr) put3d(F.tf, i, h.tf);
  if (F.sn != nullptr) put3d(F.sn, i, h.sn);
  if (F.wi != nullptr) put3d(F.wi, i, h.wi);
  if (F.J != nullptr) F.J[i] = h.J.d;
  if (F.bc != nullptr) {
    F.bc[2 * i] = h.u.d;
    F.bc[2 * i + 1] = h.v.d;
  }
  if (F.iuv != nullptr) {
    F.iuv[2 * i] = h.iu.d;
    F.iuv[2 * i + 1] = h.iv.d;
  }
  if (F.dpdu != nullptr) put3d(F.dpdu, i, h.dpdu);
  if (F.dpdv != nullptr) put3d(F.dpdv, i, h.dpdv);
}

// K7-vjp. Shared: a persistent grid whose blocks sum into a shared-memory
// copy of the row cotangents (rows <= kSharedRows) and flush it once.
// d_uvt (rows, 6): the corner UVs' cotangents, or nullptr.
template <bool Solid, bool HasUV, bool Shared>
__global__ void __launch_bounds__(kThreads)
    k7_vjp_kernel(Tables T, Lanes L, Fields G, float* __restrict__ d_tab,
                  float* __restrict__ d_o, float* __restrict__ d_d, float* __restrict__ d_uvt) {
  extern __shared__ float part[];
  const int n_part = Shared ? T.rows * hr::kCols : 0;
  if (Shared) {
    for (int k = threadIdx.x; k < n_part; k += blockDim.x) part[k] = 0.0f;
    __syncthreads();
  }
  float* sums = Shared ? part : d_tab;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < L.n;
       i += stride) {
    const int row = row_of(L.tri_id, i);
    const hr::Row<float> r = hr::load_row(T.tab + static_cast<long long>(row) * hr::kCols);
    const V o = get3(L.o, i);
    const V d = Solid ? get3(L.d, i) : V{0.0f, 0.0f, 0.0f};
    const hr::Cot g{get1(G.t, i),
                    get1(G.J, i),
                    Solid ? get1(G.bc, 2 * i) : 0.0f,
                    Solid ? get1(G.bc, 2 * i + 1) : 0.0f,
                    HasUV ? get1(G.iuv, 2 * i) : 0.0f,
                    HasUV ? get1(G.iuv, 2 * i + 1) : 0.0f,
                    get3(G.p, i),
                    get3(G.n, i),
                    get3(G.s, i),
                    get3(G.tf, i),
                    get3(G.sn, i),
                    get3(G.wi, i),
                    HasUV ? get3(G.dpdu, i) : V{0.0f, 0.0f, 0.0f},
                    HasUV ? get3(G.dpdv, i) : V{0.0f, 0.0f, 0.0f}};
    hr::Row<float> gr;
    V go, gd;
    hr::Corners<float> gc;
    hr::rebuild_adjoint<Solid, HasUV>(r, T.ints[static_cast<long long>(row) * hr::kInts] != 0,
                                      corners<HasUV>(T, row), L.uv[2 * i], L.uv[2 * i + 1], o, d,
                                      g, &gr, &go, &gd, &gc);
    put3(d_o, i, go);
    if (Solid) put3(d_d, i, gd);
    const float v[hr::kCols] = {gr.p0.x, gr.p0.y, gr.p0.z, gr.e1.x, gr.e1.y, gr.e1.z,
                                gr.e2.x, gr.e2.y, gr.e2.z, gr.n0.x, gr.n0.y, gr.n0.z,
                                gr.n1.x, gr.n1.y, gr.n1.z, gr.n2.x, gr.n2.y, gr.n2.z,
                                gr.fn.x, gr.fn.y, gr.fn.z, gr.area};
    psdr::shade::group_add<hr::kCols>(sums + static_cast<long long>(row) * hr::kCols, 1, v);
    if (HasUV && d_uvt != nullptr) psdr::shade::group_add<6>(d_uvt + 6LL * row, 1, gc.c);
  }
  if (Shared) {
    __syncthreads();
    for (int k = threadIdx.x; k < n_part; k += blockDim.x) {
      const float x = part[k];
      if (x != 0.0f) atomicAdd(&d_tab[k], x);
    }
  }
}

Fields fields_of(void* const* p) {
  float* f[kFields];
  for (int k = 0; k < kFields; ++k) f[k] = static_cast<float*>(p[k]);
  return {f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7], f[8], f[9], f[10], f[11]};
}

unsigned blocks_of(long long n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

template <bool Solid, bool HasUV, bool Shared>
int launch_vjp(const Tables& T, const Lanes& L, const Fields& G, float* d_tab, float* d_o,
               float* d_d, float* d_uvt, cudaStream_t s) {
  auto kernel = k7_vjp_kernel<Solid, HasUV, Shared>;
  const size_t smem = Shared ? sizeof(float) * T.rows * hr::kCols : 0;
  unsigned blocks = blocks_of(L.n);
  if (Shared) {
    int dev = 0, n_sm = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const long long most = static_cast<long long>(n_sm) * (per_sm > 0 ? per_sm : 1);
    if (blocks > most) blocks = static_cast<unsigned>(most);
  }
  kernel<<<blocks, kThreads, smem, s>>>(T, L, G, d_tab, d_o, d_d, d_uvt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tab (rows, 22), ints (rows, 5), uvt (rows, 6) or null: the face tables of
// ops/hit_rebuild.py hit_tables; tri_id (n) int32, uv (n, 2): the payload;
// o, d (n, 3) float32 (d read in solid mode only). `out` holds the 12
// fields' outputs (t, p, n, s, tf, sn, wi, J, bc, iuv, dpdu, dpdv; bc in
// solid mode, iuv, dpdu and dpdv with UVs, else unused), then mesh_id (n)
// and the face's vertex ids (n, 3) int32 (with has_pv). Launches on
// `stream` and returns the CUDA error code.
extern "C" int psdr_k7(const float* tab, const int* ints, const float* uvt, int rows,
                       const int* tri_id, const float* uv, const float* o, const float* d,
                       long long n, int solid, int has_uv, int has_pv, void* const* out,
                       void* stream) {
  const Tables T{tab, ints, uvt, nullptr, nullptr, rows};
  const Lanes L{tri_id, uv, o, d, nullptr, nullptr, n};
  const Fields F = fields_of(out);
  int* mesh_id = static_cast<int*>(out[kFields]);
  int* fi = static_cast<int*>(out[kFields + 1]);
  const auto s = static_cast<cudaStream_t>(stream);
  const unsigned b = blocks_of(n);
  const int key = (solid ? 4 : 0) | (has_uv ? 2 : 0) | (has_pv ? 1 : 0);
#define PSDR_K7(S, U, P) k7_kernel<S, U, P><<<b, kThreads, 0, s>>>(T, L, F, mesh_id, fi)
  switch (key) {
    case 0: PSDR_K7(false, false, false); break;
    case 1: PSDR_K7(false, false, true); break;
    case 2: PSDR_K7(false, true, false); break;
    case 3: PSDR_K7(false, true, true); break;
    case 4: PSDR_K7(true, false, false); break;
    case 5: PSDR_K7(true, false, true); break;
    case 6: PSDR_K7(true, true, false); break;
    default: PSDR_K7(true, true, true); break;
  }
#undef PSDR_K7
  return static_cast<int>(cudaGetLastError());
}

// The tangents of psdr_k7's 12 fields (into `out`, the same layout; a null
// output is not written) along tab_t (rows, 22), uvt_t (rows, 6), o_t and
// d_t (n, 3); a null tangent is zero.
extern "C" int psdr_k7_jvp(const float* tab, const float* tab_t, const int* ints,
                           const float* uvt, const float* uvt_t, int rows, const int* tri_id,
                           const float* uv, const float* o, const float* o_t, const float* d,
                           const float* d_t, long long n, int solid, int has_uv,
                           void* const* out, void* stream) {
  const Tables T{tab, ints, uvt, tab_t, uvt_t, rows};
  const Lanes L{tri_id, uv, o, d, o_t, d_t, n};
  const Fields F = fields_of(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const unsigned b = blocks_of(n);
  if (solid) {
    if (has_uv) k7_jvp_kernel<true, true><<<b, kThreads, 0, s>>>(T, L, F);
    else k7_jvp_kernel<true, false><<<b, kThreads, 0, s>>>(T, L, F);
  } else {
    if (has_uv) k7_jvp_kernel<false, true><<<b, kThreads, 0, s>>>(T, L, F);
    else k7_jvp_kernel<false, false><<<b, kThreads, 0, s>>>(T, L, F);
  }
  return static_cast<int>(cudaGetLastError());
}

// The adjoint of psdr_k7 for the cotangents `g` of its 12 fields (null:
// none): adds the row cotangents into d_tab (rows, 22) and, where d_uvt is
// not null, the corner UVs' into d_uvt (rows, 6), which the caller zeroes,
// and writes d_o and (solid mode) d_d (n, 3).
extern "C" int psdr_k7_vjp(const float* tab, const int* ints, const float* uvt, int rows,
                           const int* tri_id, const float* uv, const float* o, const float* d,
                           long long n, int solid, int has_uv, void* const* g, float* d_tab,
                           float* d_o, float* d_d, float* d_uvt, void* stream) {
  const Tables T{tab, ints, uvt, nullptr, nullptr, rows};
  const Lanes L{tri_id, uv, o, d, nullptr, nullptr, n};
  const Fields G = fields_of(g);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool shared = rows <= kSharedRows;
  const int key = (solid ? 4 : 0) | (has_uv ? 2 : 0) | (shared ? 1 : 0);
  switch (key) {
    case 0: return launch_vjp<false, false, false>(T, L, G, d_tab, d_o, d_d, d_uvt, s);
    case 1: return launch_vjp<false, false, true>(T, L, G, d_tab, d_o, d_d, d_uvt, s);
    case 2: return launch_vjp<false, true, false>(T, L, G, d_tab, d_o, d_d, d_uvt, s);
    case 3: return launch_vjp<false, true, true>(T, L, G, d_tab, d_o, d_d, d_uvt, s);
    case 4: return launch_vjp<true, false, false>(T, L, G, d_tab, d_o, d_d, d_uvt, s);
    case 5: return launch_vjp<true, false, true>(T, L, G, d_tab, d_o, d_d, d_uvt, s);
    case 6: return launch_vjp<true, true, false>(T, L, G, d_tab, d_o, d_d, d_uvt, s);
    default: return launch_vjp<true, true, true>(T, L, G, d_tab, d_o, d_d, d_uvt, s);
  }
}
