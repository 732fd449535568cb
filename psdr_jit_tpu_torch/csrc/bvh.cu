// K6: closest hit of N rays against F > 4096 triangles through a fixed
// two-level hierarchy over the Morton-ordered triangles: 512-triangle
// blocks of eight 64-triangle clusters, each with a widened AABB (built
// per call by psdr_jit_tpu_torch/ops/bvh.py build_bvh).
//
// Replaces the TPU kernel _kernel_indexed / _call_indexed of
// psdr_jit_tpu/ops/bvh.py (:253-353) and the machinery around it
// (ray sort, tile-versus-block interval test, fetch lists), which exists
// because TPU lanes cannot index memory per lane. Here one thread traces
// one ray: it tests the block boxes (staged in shared memory) in order;
// inside a block that may hold a hit closer than its best it tests the
// eight cluster boxes, and inside a cluster that may, the 64 triangles.
// Triangles are visited in ascending id with a strict t < best, and every
// box is widened, so the result is the unculled sweep's bit for bit.
//
// What bounds it on an H100: arithmetic, ~30 f32 operations per visited
// (ray, triangle) pair plus ~20 per box test, against 24 bytes read and 16
// written a ray. The triangle table (12 floats a triangle, three float4)
// and the cluster boxes stay in global memory, L2-resident (4.9 MB and
// 0.4 MB at 102,412 triangles) and read through the read-only cache; the
// block boxes (32 bytes a block) are read from shared memory by every
// thread. Rays of a warp that visit different clusters diverge; ray
// sorting, front-to-back block order and a per-ray tree are later work.
#include "sweep.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlock = 512;
constexpr int kBvhCluster = 64;
constexpr int kClustersPerBlock = kBlock / kBvhCluster;

__global__ void __launch_bounds__(kThreads)
    bvh_kernel(const float4* __restrict__ tri4, const float4* __restrict__ cbox,
               const float4* __restrict__ bbox, int n_blocks,
               const float* __restrict__ ray_o, const float* __restrict__ ray_d,
               const bool* __restrict__ active, long long n,
               float* __restrict__ out_t, int* __restrict__ out_id,
               float* __restrict__ out_uv) {
  extern __shared__ float4 s_bbox[];  // (n_blocks, 2): lo.xyz_, hi.xyz_
  for (int k = threadIdx.x; k < 2 * n_blocks; k += blockDim.x) s_bbox[k] = bbox[k];
  __syncthreads();
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  psdr::Hit h{psdr::kInf, -1, 0.0f, 0.0f};
  if (active[i]) {
    const float ox = ray_o[3 * i], oy = ray_o[3 * i + 1], oz = ray_o[3 * i + 2];
    const float dx = ray_d[3 * i], dy = ray_d[3 * i + 1], dz = ray_d[3 * i + 2];
    const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
    for (int b = 0; b < n_blocks; ++b) {
      const float4 lo = s_bbox[2 * b], hi = s_bbox[2 * b + 1];
      if (!psdr::box_visit(lo.x, lo.y, lo.z, hi.x, hi.y, hi.z, ox, oy, oz, ix,
                           iy, iz, h.t))
        continue;
      for (int c = b * kClustersPerBlock; c < (b + 1) * kClustersPerBlock; ++c) {
        const float4 clo = __ldg(&cbox[2 * c]), chi = __ldg(&cbox[2 * c + 1]);
        if (!psdr::box_visit(clo.x, clo.y, clo.z, chi.x, chi.y, chi.z, ox, oy,
                             oz, ix, iy, iz, h.t))
          continue;
        for (int j = c * kBvhCluster; j < (c + 1) * kBvhCluster; ++j) {
          const float4 a = __ldg(&tri4[3 * j]);
          const float4 e = __ldg(&tri4[3 * j + 1]);
          const float4 g = __ldg(&tri4[3 * j + 2]);
          psdr::hit_test(h, j, a.x, a.y, a.z, a.w, e.x, e.y, e.z, e.w, g.x, ox,
                         oy, oz, dx, dy, dz);
        }
      }
    }
    if (!(h.t < psdr::kInf)) h = psdr::Hit{psdr::kInf, -1, 0.0f, 0.0f};
  }
  out_t[i] = h.t;
  out_id[i] = h.id;
  out_uv[2 * i] = h.u;
  out_uv[2 * i + 1] = h.v;
}

}  // namespace

// tri4 (n_blocks * 512, 12), cbox (n_blocks * 8, 8), bbox (n_blocks, 8),
// ray_o/ray_d (n, 3): float32 device arrays (the layouts of
// ops/bvh.py BVH); active (n) bool; outputs t (n), id (n, int32, -1 =
// miss), uv (n, 2). The block boxes take 32 bytes a block of shared
// memory; above 48 KiB the launch opts in. Launches on `stream` and returns
// cudaGetLastError() (or the opt-in's error).
extern "C" int psdr_bvh(const float* tri4, const float* cbox, const float* bbox,
                        int n_blocks, const float* ray_o, const float* ray_d,
                        const bool* active, long long n, float* t, int* id,
                        float* uv, void* stream) {
  const size_t smem = sizeof(float4) * 2 * static_cast<size_t>(n_blocks);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bvh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  bvh_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(tri4), reinterpret_cast<const float4*>(cbox),
      reinterpret_cast<const float4*>(bbox), n_blocks, ray_o, ray_d, active, n,
      t, id, uv);
  return static_cast<int>(cudaGetLastError());
}
