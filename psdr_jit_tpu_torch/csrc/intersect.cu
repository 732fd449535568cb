// K1 up to 192 triangles: the closest hit of N rays against a table small
// enough to sweep. Above 192 triangles K1 is the tree walk of bvh.cu.
//
// Replaces the TPU kernel _kernel_small / _call_small of
// psdr_jit_tpu/ops/intersect_pallas.py (sweep_block over 64x128-ray tiles,
// triangle scalars in SMEM by scalar prefetch). Here: K2's sweep for
// scattered rays (sweep.cuh sweep_queued with runs of 2 triangles) over
// K2's table staged once a block of a persistent grid (stage_table), one
// active ray a thread.
//
// What bounds it on an H100: instruction issue. Each ray reads 24 bytes and
// writes 16 (the bytes bound), but tests each cluster box and each run box
// inside the clusters it enters (~15-18 a ray at 32 triangles), and every
// (ray, run) pair it enters. The old one-level sweep ran 16 tests for each
// cluster a ray entered, ~25 a ray at 32 triangles where ~2.2 were needed
// (PERF.md). The queue tests only the runs each lane enters, 32 pairs
// at a time, so scattered rays (bounces, shadow and boundary rays) keep the
// warp busy with useful tests. A tree walk diverges more than it saves at
// this size: on the Cornell box it took ~2x the sweep's time on scattered
// rays. On galleries of 92 to 412 triangles the walk overtakes the sweep
// near 130 triangles on camera and pick rays and near 300 on the
// secondary-edge stand-ins (PERF.md); the routing sweeps up to 192
// (intersect.SWEEP_MAX_TRIS), the most K2 stages.
//
// Dead lanes: each block takes tiles of kThreads rays in turn, writes a
// miss for each inactive ray and queues the active ones in shared memory
// (block_rank), and sweeps them kThreads at a time, so that its warps run
// full on active rays; a pass of its own before the sweep cost more than it
// saved at 32 triangles (PERF.md).
//
// Exactness: widened boxes cull no hit, and the queue keeps the least
// (t, id) of the tested hits, then retests the winner for (t, u, v): the
// unculled sweep's hits bit for bit (sweep.cuh).
#include "sweep.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 2;  // triangles of a culling run, K2's kGroup

// The rank of this thread among the block's threads with `on` set, in
// thread order, and through *total their count (the same in every thread).
// Synchronises the block once; the caller synchronises again before s_live
// is written anew.
__device__ __forceinline__ int block_rank(bool on, int* s_live, int* total) {
  constexpr int kWarps = kThreads / psdr::kWarp;
  const int lane = threadIdx.x & (psdr::kWarp - 1), warp = threadIdx.x / psdr::kWarp;
  const unsigned ballot = __ballot_sync(psdr::kFullWarp, on);
  if (lane == 0) s_live[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? s_live[w] : 0;
    all += s_live[w];
  }
  *total = all;
  return before + __popc(ballot & ((1u << lane) - 1u));
}

size_t table_bytes(int f_pad) {
  return sizeof(psdr::WarpQueue) * (kThreads / psdr::kWarp) +
         sizeof(float4) *
             (3 * f_pad + 2 * (f_pad / psdr::kCluster) + 2 * (f_pad / kRun));
}

// A persistent grid: block b takes tiles b, b + gridDim.x, ... of kThreads
// rays. All its threads run the same iterations (`pending` is the same in
// each), so each warp calls the queued sweep with all 32 lanes; a lane
// past the queued rays has no need.
__global__ void __launch_bounds__(kThreads)
    sweep_kernel(const float* __restrict__ tri_g, const float* __restrict__ box_g,
                 int f_pad, const float* __restrict__ ray_o,
                 const float* __restrict__ ray_d, const bool* __restrict__ active,
                 long long n, float* __restrict__ out_t, int* __restrict__ out_id,
                 float* __restrict__ out_uv) {
  extern __shared__ float4 smem4[];
  __shared__ int s_list[2 * kThreads];  // queued active rays
  __shared__ int s_live[kThreads / psdr::kWarp];
  const int nc = f_pad / psdr::kCluster;
  auto* s_queue = reinterpret_cast<psdr::WarpQueue*>(smem4);
  float4* s_tri = reinterpret_cast<float4*>(s_queue + kThreads / psdr::kWarp);
  float4* s_cbox = s_tri + 3 * f_pad;
  float4* s_gbox = s_cbox + 2 * nc;
  psdr::stage_table<kRun>(tri_g, box_g, f_pad, s_tri, s_cbox, s_gbox);
  psdr::WarpQueue& q = s_queue[threadIdx.x / psdr::kWarp];
  const long long n_tiles = (n + kThreads - 1) / kThreads;
  long long tile = blockIdx.x;
  int pending = 0;  // below kThreads between iterations
  while (true) {
    const bool more = tile < n_tiles;
    if (more) {  // queue the tile's active rays behind the pending ones
      const long long i = tile * kThreads + threadIdx.x;
      const bool on = i < n && active[i];
      if (i < n && !on)
        psdr::store_hit(psdr::Hit{psdr::kInf, -1, 0.0f, 0.0f}, i, out_t, out_id, out_uv);
      int total;
      const int rank = block_rank(on, s_live, &total);
      if (on) s_list[pending + rank] = static_cast<int>(i);
      pending += total;
      tile += gridDim.x;
      __syncthreads();
    }
    if (pending == 0) {
      if (more) continue;
      break;
    }
    if (pending < kThreads && tile < n_tiles) continue;  // fill the batch first
    const int m = pending < kThreads ? pending : kThreads;
    const bool need = static_cast<int>(threadIdx.x) < m;
    const long long i = need ? s_list[threadIdx.x] : 0;
    const float ox = need ? ray_o[3 * i] : 0.0f, oy = need ? ray_o[3 * i + 1] : 0.0f,
                oz = need ? ray_o[3 * i + 2] : 0.0f;
    const float dx = need ? ray_d[3 * i] : 0.0f, dy = need ? ray_d[3 * i + 1] : 0.0f,
                dz = need ? ray_d[3 * i + 2] : 1.0f;
    psdr::Tally tally;
    const psdr::Hit h = psdr::sweep_queued<kRun>(s_tri, s_cbox, s_gbox, nc, q, need, ox,
                                                 oy, oz, dx, dy, dz, tally);
    if (need) psdr::store_hit(h, i, out_t, out_id, out_uv);
    // move the rest (at most kThreads - 1 rays) to the front
    const int rest = pending - m;
    if (static_cast<int>(threadIdx.x) < rest)
      s_list[threadIdx.x] = s_list[kThreads + threadIdx.x];
    __syncthreads();
    pending = rest;
  }
}

}  // namespace

// tri (9, f_pad), box (6, f_pad / 16): the packed tables of ops/intersect.py
// pack_triangles, f_pad a multiple of 16 up to 512; ray_o, ray_d (n, 3)
// float32; active (n) bool; outputs t (n), id (n, int32, -1 = miss), uv
// (n, 2); n below 2^31 (the wrapper checks). Launches on `stream` and
// returns the CUDA error code.
extern "C" int psdr_sweep(const float* tri, const float* box, int f_pad,
                          const float* ray_o, const float* ray_d, const bool* active,
                          long long n, float* t, int* id, float* uv, void* stream) {
  const size_t smem = table_bytes(f_pad);
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(
      sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sweep_kernel, kThreads,
                                                      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // as many blocks as the SMs hold at once, no more than the tiles
  const long long needed = (n + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(n_sm) * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = static_cast<unsigned>(needed < most ? needed : most);
  sweep_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      tri, box, f_pad, ray_o, ray_d, active, n, t, id, uv);
  return static_cast<int>(cudaGetLastError());
}
