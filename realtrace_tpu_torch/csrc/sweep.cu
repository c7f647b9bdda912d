// Chunk sweep for Hopper (sm_90a), resident form: exact FP32 closest-hit /
// occlusion over per-tile front-to-back chunk lists.
//
// Replaces the TPU kernel realtrace_tpu/ops/pallas/trace.py::_kernel_resident
// (with _recenter, _live_max_t and _reduce_update). The plain PyTorch twin
// realtrace_tpu_torch/ops/sweep.py::sweep_reference defines the semantics.
//
// Work split: one thread block per 1024-ray tile, 256 threads, 4 rays per
// thread. For each listed chunk the block stages the chunk's C triangles'
// constants (16 floats each) in shared memory with plain loads between two
// barriers, re-centres its rays on the chunk centroid and runs the pair test
// of sweep_common.cuh, which also holds the rounding rules.
//
// Early exits, as block-wide votes (__syncthreads_or), never change the
// result: closest mode stops once the next list entry bound exceeds every
// live lane's best t (no later chunk can hold a closer hit), any mode once
// every live lane is occluded.
//
// What bounds it on the H100: the FP32 work per (ray, triangle) pair:
// 18 multiplies and 15 adds for the four forms, a division and ~8
// compares/selects, all on CUDA cores; the constants are read from shared
// memory as warp-wide broadcasts (every thread reads the same word), so
// memory is not the limit. The design keeps the pair work in registers,
// amortizes each shared-memory read over 4 rays per thread, and skips chunks
// with the early exits. Tensor cores (TF32) lack the precision for the
// closest test; making the kernel faster (3xTF32 wgmma for the forms,
// per-warp lists) is later work.
//
// The launch allocates nothing, runs on the caller's stream and returns
// cudaGetLastError(), so a refused launch is reported.

#include "sweep_common.cuh"

namespace {

using namespace rt;

template <bool kAny>
__global__ void __launch_bounds__(kThreads)
sweep_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
             const float* __restrict__ consts, const float* __restrict__ meta,
             const int* __restrict__ chunk_list, const int* __restrict__ counts,
             const float* __restrict__ entry, float* __restrict__ out_t,
             int* __restrict__ out_i, int* __restrict__ visits, int m_chunks, int c,
             Thresholds th) {
  extern __shared__ float4 s_tri4[];  // c * kCoef floats
  const float* s_tri = reinterpret_cast<const float*>(s_tri4);
  __shared__ float s_g[3];

  const int tile = blockIdx.x;
  const int n = counts[tile];
  const int* list = chunk_list + static_cast<size_t>(tile) * m_chunks;
  const float* ent = entry + static_cast<size_t>(tile) * m_chunks;

  Rays r;
  load_rays(r, ro, rd, tile);

  int j = 0;
  while (j < n) {
    const int m = list[j];
    __syncthreads();  // the previous chunk's constants are no longer read
    const float4* src = reinterpret_cast<const float4*>(consts + static_cast<size_t>(m) * c * kCoef);
    for (int i = threadIdx.x; i < c * kCoef / 4; i += kThreads) s_tri4[i] = src[i];
    if (threadIdx.x < 3) s_g[threadIdx.x] = meta[3 * m + threadIdx.x];
    __syncthreads();

    const bool more = j + 1 < n;
    const int go = sweep_chunk<kAny>(r, s_tri, c, m, s_g[0], s_g[1], s_g[2],
                                     more ? ent[j + 1] : 0.0f, th.det_eps, th.det_eps2,
                                     th.t_min);
    ++j;
    if (!more) break;                      // uniform across the block
    if (!__syncthreads_or(go)) break;
  }

  store_rays(r, out_t, out_i, tile);
  if (visits != nullptr && threadIdx.x == 0) visits[tile] = j;
}

}  // namespace

// visits may be null; otherwise it receives, per tile, the list positions
// the block swept before it stopped.
extern "C" int rt_sweep(const float* ro, const float* rd, const float* consts, const float* meta,
                        const int* chunk_list, const int* counts, const float* entry,
                        float* out_t, int* out_i, int* visits, int n_tiles, int m_chunks, int c,
                        double det_eps, double t_min, int any_mode, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_tiles == 0) return 0;
  const size_t smem = static_cast<size_t>(c) * kCoef * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Thresholds th(det_eps, t_min);
  if (any_mode) {
    sweep_kernel<true><<<n_tiles, kThreads, smem, s>>>(ro, rd, consts, meta, chunk_list, counts,
                                                       entry, out_t, out_i, visits, m_chunks, c,
                                                       th);
  } else {
    sweep_kernel<false><<<n_tiles, kThreads, smem, s>>>(ro, rd, consts, meta, chunk_list, counts,
                                                        entry, out_t, out_i, visits, m_chunks, c,
                                                        th);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
