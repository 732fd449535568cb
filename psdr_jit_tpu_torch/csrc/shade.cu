// K3: the attached interior Li of the training step, one thread per lane;
// K4: its adjoint, written by hand.
//
// Replace the TPU kernel _mk_shade_kernel / _shade_call of
// psdr_jit_tpu/ops/shade_mega.py, forward (cts=None) and backward (in-kernel
// jax.vjp). The per-lane program is shade.cuh; the plain PyTorch version is
// li_attached_plain in psdr_jit_tpu_torch/ops/shade_mega.py, and autograd of
// it is the plain version of K4.
//
// What changed from the TPU kernels, and why:
//  * The TPU gathered 30 table rows per hit per lane into (30, rows, 128)
//    blocks before the kernel (one-hot MXU gathers), because its lanes
//    cannot index VMEM. Here the (F, 30) face table and the (12, L) light
//    table are staged in shared memory once per block (23 KB at the
//    192-triangle limit) and read by stashed hit id.
//  * K4 does not write per-lane row cotangents (840 B a lane at depth 3, 7 GB
//    at 8.4M lanes). Each thread adds its cotangents into a per-block copy
//    of the tables in shared memory; the lanes of a warp that add to the
//    same entry at the same point of the adjoint are summed with warp
//    shuffles first and one lane adds the sum (shade.cuh group_add). At the
//    end each block adds its nonzero partials into the output tables with
//    one global atomic per entry. On the TPU the sequential grid carried
//    the sums in place (`out_refs[...] +=`); Hopper's blocks run in no
//    order, so the float sums are reordered from run to run and their last
//    bits vary.
//  * K4 runs a persistent grid: as many blocks as the SMs hold (two of 256
//    threads an SM, its registers capped at 128), each looping over lanes,
//    so that each block stages, zeroes and flushes its tables once per
//    launch, not once per 256 lanes.
//  * Depth is a template parameter of K4 (0..3), and each depth's inputs
//    are recomputed before its adjoint rather than kept in an array, so no
//    array of the lane's state sits in local memory (what is left there is
//    spill at the 128-register cap).
//
// What bounds them on an H100: instructions. K3 reads 12 B per hit and 29 B
// per lane and writes 12, which a copy of its reads and writes moves in
// under half its time; the rest is issuing its instructions, a dozen for
// each IEEE division or square root (some twenty a depth; nvcc contracts
// nothing, so the plain version's bits hold). So K3's lanes leave the depth
// loop once their path is dead, the depths take the two lane-invariant
// reciprocals from Scalars and compute safe_div(a, a) without dividing,
// and five blocks share an SM (PERF.md). A persistent grid, an unrolled
// depth loop, loading the next depth's hits early and compacting a block's
// live paths through shared memory each made it slower. K4 recomputes the
// forward and sweeps back through it, adding up to ~60 cotangents a depth.
// Added lane by lane, those shared-memory atomics took 18 of K4's 21.8 ms a
// training step: a pixel's 32 samples (one warp) share their camera hit and
// NEE hits fall on the same light triangles, so the adds serialised on the
// same addresses, and one block an SM (161 registers) hid none of their
// latency (PERF.md). The warp sums and the second block answer that.
#include <cuda_runtime.h>

#include "shade.cuh"

namespace {

using psdr::V3;
namespace sh = psdr::shade;

constexpr int kThreads = 256;
// K3 caps its registers at 48 a thread so that five blocks fit an SM (a few
// bytes spill), K4 at 128 so that two do.
constexpr int kFwdBlocksPerSm = 5;
constexpr int kBwdBlocksPerSm = 2;

__device__ __forceinline__ void stage(const float* __restrict__ table_g,
                                      const float* __restrict__ light_g,
                                      const float* __restrict__ misc_g, int n_tab,
                                      int n_light, float* s_table, float* s_light,
                                      float* s_misc) {
  for (int k = threadIdx.x; k < n_tab * sh::kRows; k += blockDim.x) s_table[k] = table_g[k];
  for (int k = threadIdx.x; k < sh::kLightRows * n_light; k += blockDim.x)
    s_light[k] = light_g[k];
  for (int k = threadIdx.x; k < sh::kMisc; k += blockDim.x) s_misc[k] = misc_g[k];
}

__device__ __forceinline__ sh::Lane lane_of(const float* s_light, const sh::Scalars& m,
                                            int n_light, uint32_t lane, uint32_t seed,
                                            int cnt0, int hide_emitters) {
  return sh::Lane{lane, seed, static_cast<uint32_t>(cnt0), hide_emitters != 0, s_light,
                  n_light, m};
}

// K3: one thread a lane, one block for each kThreads lanes. A path that is
// no longer active adds nothing at the depths after (NEE and the bounce
// both require it), so its lane leaves the depth loop and reads none of
// their hits; a warp leaves when all its lanes have.
__global__ void __launch_bounds__(kThreads, kFwdBlocksPerSm)
    shade_fwd_kernel(const float* __restrict__ table_g, const float* __restrict__ light_g,
                     const float* __restrict__ misc_g, int n_tab, int n_light,
                     const int* __restrict__ ids, const float* __restrict__ us,
                     const float* __restrict__ vs, const float* __restrict__ ray_o,
                     const float* __restrict__ ray_d, const unsigned char* __restrict__ act,
                     const uint32_t* __restrict__ lanes, uint32_t seed, long long n,
                     int depth, int cnt0, int hide_emitters, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* s_table = smem;
  float* s_light = s_table + n_tab * sh::kRows;
  float* s_misc = s_light + sh::kLightRows * n_light;
  stage(table_g, light_g, misc_g, n_tab, n_light, s_table, s_light, s_misc);
  __syncthreads();
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const sh::Lane ln =
      lane_of(s_light, sh::scalars_of(s_misc), n_light, lanes[i], seed, cnt0, hide_emitters);
  const sh::Camera c = sh::camera_forward(sh::load_hit(s_table, ids[i], us[i], vs[i]),
                                          {ray_o[3 * i], ray_o[3 * i + 1], ray_o[3 * i + 2]},
                                          {ray_d[3 * i], ray_d[3 * i + 1], ray_d[3 * i + 2]},
                                          act[i] != 0, ln.hide_emitters);
  V3 res = sh::camera_emission(c);
  sh::DepthIn in = sh::camera_in(c);
  for (int k = 0; k < depth && in.active; ++k) {
    const sh::DepthFwd s =
        sh::depth_forward(ln, in, k, sh::nee_hit(s_table, ids, us, vs, n, i, k),
                          sh::bounce_hit(s_table, ids, us, vs, n, i, k));
    res = add3(add3(res, s.nee), s.bounce);
    in = s.next;
  }
  out[3 * i] = res.x;
  out[3 * i + 1] = res.y;
  out[3 * i + 2] = res.z;
}

// K4 runs a persistent grid: about as many blocks as the SMs hold, each
// looping over lanes, so that each block stages the tables, zeroes its
// partials and flushes them once per launch.
template <int DEPTH>
__global__ void __launch_bounds__(kThreads, kBwdBlocksPerSm)
    shade_bwd_kernel(const float* __restrict__ table_g, const float* __restrict__ light_g,
                     const float* __restrict__ misc_g, int n_tab, int n_light,
                     const int* __restrict__ ids, const float* __restrict__ us,
                     const float* __restrict__ vs, const float* __restrict__ ray_o,
                     const float* __restrict__ ray_d, const unsigned char* __restrict__ act,
                     const uint32_t* __restrict__ lanes, uint32_t seed, long long n, int cnt0,
                     int hide_emitters, const float* __restrict__ ct,
                     float* __restrict__ d_table, float* __restrict__ d_light,
                     float* __restrict__ d_misc, float* __restrict__ d_o,
                     float* __restrict__ d_d) {
  extern __shared__ float smem[];
  const int n_part = n_tab * sh::kRows + sh::kLightRows * n_light + sh::kMisc;
  float* s_table = smem;
  float* s_light = s_table + n_tab * sh::kRows;
  float* s_misc = s_light + sh::kLightRows * n_light;
  float* p_all = smem + n_part;  // this block's cotangent partials, same layout
  stage(table_g, light_g, misc_g, n_tab, n_light, s_table, s_light, s_misc);
  for (int k = threadIdx.x; k < n_part; k += blockDim.x) p_all[k] = 0.0f;
  __syncthreads();
  const sh::Grads gr{p_all, p_all + n_tab * sh::kRows,
                     p_all + n_tab * sh::kRows + sh::kLightRows * n_light, n_light};
  const sh::Scalars m = sh::scalars_of(s_misc);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const sh::Lane ln = lane_of(s_light, m, n_light, lanes[i], seed, cnt0, hide_emitters);
    V3 go, gd;
    sh::lane_backward<DEPTH>(ln, s_table, ids, us, vs, n, i,
                             {ray_o[3 * i], ray_o[3 * i + 1], ray_o[3 * i + 2]},
                             {ray_d[3 * i], ray_d[3 * i + 1], ray_d[3 * i + 2]},
                             act[i] != 0, {ct[3 * i], ct[3 * i + 1], ct[3 * i + 2]}, gr,
                             &go, &gd);
    d_o[3 * i] = go.x;
    d_o[3 * i + 1] = go.y;
    d_o[3 * i + 2] = go.z;
    d_d[3 * i] = gd.x;
    d_d[3 * i + 1] = gd.y;
    d_d[3 * i + 2] = gd.z;
  }
  __syncthreads();
  const int n_t = n_tab * sh::kRows;
  const int n_l = sh::kLightRows * n_light;
  for (int k = threadIdx.x; k < n_part; k += blockDim.x) {
    const float v = p_all[k];
    if (v == 0.0f) continue;
    if (k < n_t) {
      atomicAdd(&d_table[k], v);
    } else if (k < n_t + n_l) {
      atomicAdd(&d_light[k - n_t], v);
    } else {
      atomicAdd(&d_misc[k - n_t - n_l], v);
    }
  }
}

size_t table_bytes(int n_tab, int n_light) {
  return sizeof(float) *
         (static_cast<size_t>(n_tab) * sh::kRows + sh::kLightRows * n_light + sh::kMisc);
}

template <class K>
int launch_config(K kernel, size_t smem) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

}  // namespace

// table (n_tab, 30), light (12, n_light), misc (8): float32 device arrays;
// ids (1 + 2*depth, n) int32, us/vs (1 + 2*depth, n) float32: the stashed
// hits; ray_o/ray_d (n, 3); active (n, bool); lanes (n, u32). Writes out
// (n, 3). Launches on `stream` and returns cudaGetLastError().
extern "C" int psdr_shade_fwd(const float* table, const float* light, const float* misc,
                              int n_tab, int n_light, const int* ids, const float* us,
                              const float* vs, const float* ray_o, const float* ray_d,
                              const void* active, const void* lanes, unsigned int seed,
                              long long n, int depth, int cnt0, int hide_emitters,
                              float* out, void* stream) {
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  const size_t smem = table_bytes(n_tab, n_light);
  const int err = launch_config(shade_fwd_kernel, smem);
  if (err != 0) return err;
  shade_fwd_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      table, light, misc, n_tab, n_light, ids, us, vs, ray_o, ray_d,
      static_cast<const unsigned char*>(active), static_cast<const uint32_t*>(lanes), seed,
      n, depth, cnt0, hide_emitters, out);
  return static_cast<int>(cudaGetLastError());
}

// The adjoint of psdr_shade_fwd for the output cotangent ct (n, 3): adds
// into d_table (n_tab, 30), d_light (12, n_light) and d_misc (8), which the
// caller zeroes, and writes d_o and d_d (n, 3).
extern "C" int psdr_shade_bwd(const float* table, const float* light, const float* misc,
                              int n_tab, int n_light, const int* ids, const float* us,
                              const float* vs, const float* ray_o, const float* ray_d,
                              const void* active, const void* lanes, unsigned int seed,
                              long long n, int depth, int cnt0, int hide_emitters,
                              const float* ct, float* d_table, float* d_light,
                              float* d_misc, float* d_o, float* d_d, void* stream) {
  const size_t smem = 2 * table_bytes(n_tab, n_light);
  const auto* a = static_cast<const unsigned char*>(active);
  const auto* l = static_cast<const uint32_t*>(lanes);
  const auto s = static_cast<cudaStream_t>(stream);
  int dev = 0, n_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long lane_blocks = (n + kThreads - 1) / kThreads;
#define PSDR_SHADE_BWD(D)                                                              \
  do {                                                                                 \
    const int err = launch_config(shade_bwd_kernel<D>, smem);                          \
    if (err != 0) return err;                                                          \
    int per_sm = 0;                                                                    \
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, shade_bwd_kernel<D>,    \
                                                      kThreads, smem);                 \
    if (e != cudaSuccess) return static_cast<int>(e);                                  \
    const long long most = static_cast<long long>(n_sm) * (per_sm > 0 ? per_sm : 1);   \
    const unsigned blocks = static_cast<unsigned>(lane_blocks < most ? lane_blocks : most); \
    shade_bwd_kernel<D><<<blocks, kThreads, smem, s>>>(                                \
        table, light, misc, n_tab, n_light, ids, us, vs, ray_o, ray_d, a, l, seed, n,  \
        cnt0, hide_emitters, ct, d_table, d_light, d_misc, d_o, d_d);                  \
  } while (0)
  switch (depth) {
    case 0: PSDR_SHADE_BWD(0); break;
    case 1: PSDR_SHADE_BWD(1); break;
    case 2: PSDR_SHADE_BWD(2); break;
    case 3: PSDR_SHADE_BWD(3); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PSDR_SHADE_BWD
  return static_cast<int>(cudaGetLastError());
}
