// Chunk sweep for Hopper (sm_90a), streaming form: the same function as
// sweep.cu, with each listed chunk's constants copied into shared memory
// asynchronously, one list position ahead of the arithmetic.
//
// Replaces the TPU kernel realtrace_tpu/ops/pallas/trace.py::_kernel_stream,
// which kept the constant table in HBM and double-buffered per-chunk DMA
// into VMEM. The plain PyTorch twin is the resident kernel's:
// realtrace_tpu_torch/ops/sweep.py::sweep_reference.
//
// Work split as in sweep.cu: one block per 1024-ray tile, 256 threads, 4 rays
// per thread. Shared memory holds two stages of one chunk each (C * 16 floats
// plus the centroid). Before the block tests the chunk at list position j it
// starts the cp.async copies of position j+1 into the other stage (16 bytes
// per copy for the constants, 4 for each centroid component), then waits only
// for its own copies of stage j (cp.async.wait_group 1) and meets the block
// at a barrier so every thread's part of the stage is visible. The vote
// barrier at the end of a position (__syncthreads_or) is also what frees the
// stage that position j+1's prefetch overwrites. The last position prefetches
// nothing. An early exit leaves one copy group in flight; it is drained
// (cp.async.wait_all) before the block retires.
//
// What bounds it on the H100: as sweep.cu, the FP32 pair work on CUDA cores.
// At big-scene chunk sizes (C = 256: 16 KB per chunk) the synchronous load
// of sweep.cu leaves the block idle for a global/L2 round trip per list
// position; the prefetch hides that behind ~1M pair tests. The table is the
// port's (M, C, 16) layout, so a chunk is one contiguous 64*C-byte run,
// 16-byte aligned when the base is.
//
// Two stages are 2 * 64 * C bytes of dynamic shared memory; past 48 KB the
// launcher raises the kernel's limit first (cudaFuncSetAttribute) and reports
// its error if the card refuses.

#include <cuda_pipeline.h>

#include "sweep_common.cuh"

namespace {

using namespace rt;

// Start this thread's share of chunk m's copies into a stage and commit them
// as one group.
__device__ __forceinline__ void fetch_chunk(float4* __restrict__ stage, float* __restrict__ g,
                                            const float* __restrict__ consts,
                                            const float* __restrict__ meta, int m, int c) {
  const float4* src = reinterpret_cast<const float4*>(consts + static_cast<size_t>(m) * c * kCoef);
  for (int i = threadIdx.x; i < c * kCoef / 4; i += kThreads)
    __pipeline_memcpy_async(stage + i, src + i, sizeof(float4));
  if (threadIdx.x < 3)
    __pipeline_memcpy_async(g + threadIdx.x, meta + 3 * m + threadIdx.x, sizeof(float));
  __pipeline_commit();
}

template <bool kAny>
__global__ void __launch_bounds__(kThreads)
sweep_stream_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                    const float* __restrict__ consts, const float* __restrict__ meta,
                    const int* __restrict__ chunk_list, const int* __restrict__ counts,
                    const float* __restrict__ entry, float* __restrict__ out_t,
                    int* __restrict__ out_i, int* __restrict__ visits, int m_chunks, int c,
                    Thresholds th) {
  extern __shared__ float4 s_stage4[];  // 2 stages of c * kCoef floats
  __shared__ float s_g[2][4];
  const int stage_f4 = c * kCoef / 4;

  const int tile = blockIdx.x;
  const int n = counts[tile];
  const int* list = chunk_list + static_cast<size_t>(tile) * m_chunks;
  const float* ent = entry + static_cast<size_t>(tile) * m_chunks;

  Rays r;
  load_rays(r, ro, rd, tile);

  if (n > 0) fetch_chunk(s_stage4, s_g[0], consts, meta, list[0], c);
  int j = 0;
  while (j < n) {
    const int m = list[j];
    const int st = j & 1;
    const bool more = j + 1 < n;
    if (more) {
      // the other stage was last read at position j-1, before that
      // position's vote barrier
      fetch_chunk(s_stage4 + (st ^ 1) * stage_f4, s_g[st ^ 1], consts, meta, list[j + 1], c);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();  // every thread's copies of stage st have landed

    const int go = sweep_chunk<kAny>(r, reinterpret_cast<const float*>(s_stage4 + st * stage_f4),
                                     c, m, s_g[st][0], s_g[st][1], s_g[st][2],
                                     more ? ent[j + 1] : 0.0f, th.det_eps, th.det_eps2,
                                     th.t_min);
    ++j;
    if (!more) break;                      // uniform across the block
    if (!__syncthreads_or(go)) break;
  }
  __pipeline_wait_prior(0);  // an early exit leaves position j's copies in flight

  store_rays(r, out_t, out_i, tile);
  if (visits != nullptr && threadIdx.x == 0) visits[tile] = j;
}

template <bool kAny>
cudaError_t launch(const float* ro, const float* rd, const float* consts, const float* meta,
                   const int* chunk_list, const int* counts, const float* entry, float* out_t,
                   int* out_i, int* visits, int n_tiles, int m_chunks, int c, Thresholds th,
                   cudaStream_t s) {
  const size_t smem = 2 * static_cast<size_t>(c) * kCoef * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(sweep_stream_kernel<kAny>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  sweep_stream_kernel<kAny><<<n_tiles, kThreads, smem, s>>>(
      ro, rd, consts, meta, chunk_list, counts, entry, out_t, out_i, visits, m_chunks, c, th);
  return cudaGetLastError();
}

}  // namespace

// Same interface as rt_sweep (sweep.cu).
extern "C" int rt_sweep_stream(const float* ro, const float* rd, const float* consts,
                               const float* meta, const int* chunk_list, const int* counts,
                               const float* entry, float* out_t, int* out_i, int* visits,
                               int n_tiles, int m_chunks, int c, double det_eps, double t_min,
                               int any_mode, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Thresholds th(det_eps, t_min);
  err = any_mode ? launch<true>(ro, rd, consts, meta, chunk_list, counts, entry, out_t, out_i,
                                visits, n_tiles, m_chunks, c, th, s)
                 : launch<false>(ro, rd, consts, meta, chunk_list, counts, entry, out_t, out_i,
                                 visits, n_tiles, m_chunks, c, th, s);
  return static_cast<int>(err);
}
