// Chunk sweep for Hopper (sm_90a), resident form: exact FP32 closest-hit /
// occlusion over per-tile front-to-back chunk lists.
//
// Replaces the TPU kernel realtrace_tpu/ops/pallas/trace.py::_kernel_resident
// (with _recenter, _live_max_t and _reduce_update). The plain PyTorch twin
// realtrace_tpu_torch/ops/sweep.py::sweep_reference defines the semantics.
//
// The TPU kernel walked one list per 1024-lane tile, with no per-lane control
// flow, and stopped when every lane of the tile agreed. Here the work item is
// one warp of a tile (128 rays, 4 a lane; sweep_common.cuh has the map): it
// walks the tile's list on its own, leaves it by its own vote, and tests a
// chunk only if one of its own rays enters the chunk's box. Warps share
// nothing, so the list loop has no block barrier and the block size is free:
// four work items a block (one, two and eight measured 7-25% slower). A deep-level wavefront of 30 tiles is 240
// work items in 60 blocks, spread over 60 of the card's 132 SMs with one warp
// on each scheduler, where a block per tile left 102 SMs empty.
//
// This form serves small chunks (32 triangles, 2 KB). A warp copies the chunk
// it is about to test into its own slice of shared memory with cp.async,
// fenced with __syncwarp, and reads it back as warp-wide broadcasts. The
// other read path, every lane reading the table's 16-byte words where they
// lie through the read-only path, one triangle ahead of the arithmetic,
// measured 0-11% slower on the H100 (PERF.md has the numbers). List entries
// come 32 positions at a time, one per lane, and go round by shuffle.
//
// What bounds it on the H100: the FP32 work per (ray, triangle) pair on CUDA
// cores: 18 multiplies and 15 adds for the four forms, a division and some
// compares and selects; the constants come from L2 (the table is a few MB at
// most), so memory is not the limit. The design keeps the pair work in
// registers and spends it only on chunks a warp's own rays enter. Tensor
// cores (TF32) lack the precision for the closest test.
//
// The launch allocates nothing, runs on the caller's stream and returns
// cudaGetLastError(), so a refused launch is reported.

#include <cuda_pipeline.h>

#include "sweep_common.cuh"

namespace {

using namespace rt;

constexpr int kWarps = 4;   // work items (warps) a block; ops/sweep.py sizes the slices by it

template <bool kAny>
// three blocks of four warps an SM leave ptxas 168 registers: left to itself
// it aims at 128 and spills
__global__ void __launch_bounds__(kWarps * 32, 3)
sweep_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
             const float* __restrict__ consts, const float* __restrict__ meta,
             const float* __restrict__ lo, const float* __restrict__ hi,
             const int* __restrict__ chunk_list, const int* __restrict__ counts,
             const float* __restrict__ entry, float* __restrict__ out_t,
             int* __restrict__ out_i, int* __restrict__ tested, int n_tiles, int m_chunks, int c,
             Thresholds th) {
  extern __shared__ float4 s_slices[];  // kWarps slices of c * kCoef floats
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= n_tiles * kWarpsPerTile) return;   // whole warps only
  const int tile = item / kWarpsPerTile, warp = item % kWarpsPerTile;
  const int n = counts[tile];
  const int* list = chunk_list + static_cast<size_t>(tile) * m_chunks;
  const float* ent = entry + static_cast<size_t>(tile) * m_chunks;
  const float4* table = reinterpret_cast<const float4*>(consts);
  const int chunk_f4 = c * kCoef / 4;

  Rays r;
  load_rays(r, ro, rd, tile, warp, lane);

  int n_tested = 0;
  bool left = false;
  for (int j0 = 0; j0 < n && !left; j0 += 32) {
    const int mine = min(j0 + lane, n - 1);
    const int m_l = list[mine];
    const float e_l = ent[mine];
    const int span = min(32, n - j0);
    for (int jj = 0; jj < span; ++jj) {
      const int m = __shfl_sync(kFullWarp, m_l, jj);
      const float e = __shfl_sync(kFullWarp, e_l, jj);
      const int verdict = warp_verdict<kAny>(r, e, lo, hi, m);
      if (verdict == 0) { left = true; break; }
      if (verdict == 1) continue;
      const float gx = __ldg(meta + 3 * m), gy = __ldg(meta + 3 * m + 1),
                  gz = __ldg(meta + 3 * m + 2);
      const float4* src = table + static_cast<size_t>(m) * chunk_f4;
      float4* slice = s_slices + (threadIdx.x >> 5) * chunk_f4;
      __syncwarp();   // the previous chunk is no longer read
      for (int i = lane; i < chunk_f4; i += 32)
        __pipeline_memcpy_async(slice + i, src + i, sizeof(float4));
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncwarp();   // every lane's part of the slice is visible
      sweep_chunk<kAny>(r, slice, c, m, gx, gy, gz, th);
      ++n_tested;
    }
  }

  store_rays(r, out_t, out_i, tile, warp, lane);
  if (tested != nullptr && lane == 0) tested[item] = n_tested;
}

template <bool kAny>
cudaError_t launch(const float* ro, const float* rd, const float* consts, const float* meta,
                   const float* lo, const float* hi, const int* chunk_list, const int* counts,
                   const float* entry, float* out_t, int* out_i, int* tested, int n_tiles,
                   int m_chunks, int c, Thresholds th, cudaStream_t s) {
  const size_t smem = kWarps * static_cast<size_t>(c) * kCoef * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(sweep_kernel<kAny>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();   // reported here; do not leave it for the next launch to find
      return err;
    }
  }
  const int items = n_tiles * kWarpsPerTile;
  sweep_kernel<kAny><<<(items + kWarps - 1) / kWarps, kWarps * 32, smem, s>>>(
      ro, rd, consts, meta, lo, hi, chunk_list, counts, entry, out_t, out_i, tested, n_tiles,
      m_chunks, c, th);
  return cudaGetLastError();
}

}  // namespace

// lo and hi (the chunk boxes) may both be null: no chunk gate. tested may be
// null; otherwise it receives, per tile and warp, the list positions whose
// pair loop the warp ran. consts must be aligned to 16 bytes.
extern "C" int rt_sweep(const float* ro, const float* rd, const float* consts, const float* meta,
                        const float* lo, const float* hi, const int* chunk_list,
                        const int* counts, const float* entry, float* out_t, int* out_i,
                        int* tested, int n_tiles, int m_chunks, int c, double det_eps,
                        double t_min, int any_mode, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Thresholds th(det_eps, t_min);
  err = any_mode ? launch<true>(ro, rd, consts, meta, lo, hi, chunk_list, counts, entry, out_t,
                                out_i, tested, n_tiles, m_chunks, c, th, s)
                 : launch<false>(ro, rd, consts, meta, lo, hi, chunk_list, counts, entry, out_t,
                                 out_i, tested, n_tiles, m_chunks, c, th, s);
  return static_cast<int>(err);
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
