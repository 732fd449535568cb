// K5: closest hit of N rays against 512 < F <= 4096 triangles, the table
// streamed through shared memory in 512-triangle super-blocks.
//
// Replaces the TPU kernel _kernel_super / _call_super of
// psdr_jit_tpu/ops/intersect_pallas.py (:198-264). There the grid's second
// dimension walks the super-blocks, staging each one's scalars in SMEM,
// and the closest hit persists across grid steps in revisited output
// blocks. Here a block of 256 threads (one ray each) walks the
// super-blocks in a loop: it stages each one's (9, 512) table and its 32
// widened 16-triangle cluster boxes (18.8 KB) cooperatively, synchronises,
// and sweeps it with each thread's running hit, which stays in registers.
//
// What bounds it on an H100: arithmetic, ~30 f32 operations per visited
// (ray, triangle) pair over every unculled cluster, against 24 bytes read
// and 16 written a ray; the table (at most 147 KB) is read once per block
// of rays from L2. Every thread of a warp reads the same staged triangle
// (a shared-memory broadcast); rays that cull different clusters diverge,
// which the design accepts for now, as K1 does.
#include "sweep.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSuper = 512;
constexpr int kSuperClusters = kSuper / psdr::kCluster;

__global__ void __launch_bounds__(kThreads)
    intersect_super_kernel(const float* __restrict__ tri_g,
                           const float* __restrict__ box_g, int f_pad,
                           const float* __restrict__ ray_o,
                           const float* __restrict__ ray_d,
                           const bool* __restrict__ active, long long n,
                           float* __restrict__ out_t, int* __restrict__ out_id,
                           float* __restrict__ out_uv) {
  __shared__ float s_tri[9 * kSuper];
  __shared__ float s_box[6 * kSuperClusters];
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = i < n && active[i];
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 1.0f;
  if (live) {
    ox = ray_o[3 * i];
    oy = ray_o[3 * i + 1];
    oz = ray_o[3 * i + 2];
    dx = ray_d[3 * i];
    dy = ray_d[3 * i + 1];
    dz = ray_d[3 * i + 2];
  }
  const int nc = f_pad / psdr::kCluster;
  psdr::Hit h{psdr::kInf, -1, 0.0f, 0.0f};
  for (int base = 0; base < f_pad; base += kSuper) {
    __syncthreads();  // the previous super-block's sweep is done
    for (int k = threadIdx.x; k < 9 * kSuper; k += blockDim.x)
      s_tri[k] = tri_g[(k / kSuper) * f_pad + base + k % kSuper];
    for (int k = threadIdx.x; k < 3 * kSuperClusters; k += blockDim.x) {
      const int at = (k / kSuperClusters) * nc + base / psdr::kCluster +
                     k % kSuperClusters;
      const float lo = box_g[at];
      const float hi = box_g[3 * nc + at];
      const float m = psdr::box_margin(lo, hi);
      s_box[k] = lo - m;
      s_box[3 * kSuperClusters + k] = hi + m;
    }
    __syncthreads();
    if (live)
      psdr::sweep_into(h, s_tri, s_box, kSuper, base, ox, oy, oz, dx, dy, dz);
  }
  if (i >= n) return;
  if (!(h.t < psdr::kInf)) h = psdr::Hit{psdr::kInf, -1, 0.0f, 0.0f};
  out_t[i] = h.t;
  out_id[i] = h.id;
  out_uv[2 * i] = h.u;
  out_uv[2 * i + 1] = h.v;
}

}  // namespace

// tri (9, f_pad) with f_pad a multiple of 512, box (6, f_pad / 16) (the
// clusters' lower then upper corners), ray_o/ray_d (n, 3): float32 device
// arrays; active (n) bool; outputs t (n), id (n, int32, -1 = miss),
// uv (n, 2). Launches on `stream` and returns cudaGetLastError().
extern "C" int psdr_intersect_super(const float* tri, const float* box,
                                    int f_pad,
                                    const float* ray_o, const float* ray_d,
                                    const bool* active, long long n, float* t,
                                    int* id, float* uv, void* stream) {
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  intersect_super_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tri, box, f_pad, ray_o, ray_d, active, n, t, id, uv);
  return static_cast<int>(cudaGetLastError());
}
