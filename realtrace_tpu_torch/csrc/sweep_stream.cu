// Chunk sweep for Hopper (sm_90a), streaming form: the same function as
// sweep.cu, for big chunks (128-512 triangles, 8-32 KB), which a block stages
// in a ring of shared-memory stages with bulk asynchronous copies.
//
// Replaces the TPU kernel realtrace_tpu/ops/pallas/trace.py::_kernel_stream,
// which kept the constant table in HBM and double-buffered per-chunk DMA
// into VMEM. The plain PyTorch twin is the resident kernel's:
// realtrace_tpu_torch/ops/sweep.py::sweep_reference.
//
// A block is four consumer warps of one 1024-ray tile, each owning 128 rays
// of the tile (sweep_common.cuh has the map and the votes), and one producer
// warp; a tile's eight warps are shared out between two blocks. The tile's list goes through in windows of 32 positions:
//   A. each consumer warp takes the votes of the window's positions with its
//      best hits as they stand (a verdict against a position only hardens as
//      best hits improve, so none is lost) and publishes a 32-bit mask; one
//      block barrier a window makes the masks visible;
//   B. the producer's elected lane fetches, in list order, every position some
//      warp's mask wants: one cp.async.bulk of the chunk's contiguous 64*C
//      bytes into the next stage of the ring, completing on that stage's
//      "full" mbarrier; it refills a stage once its "empty" mbarrier has
//      every consumer warp's arrival;
//   C. each consumer warp, for each fetched position, votes again with its
//      best hits as they are now (the twin's verdict), waits on the stage's
//      "full" barrier, runs the pair loop if the verdict says so, and arrives
//      on "empty" whether it tested the chunk or skipped it.
// No vote and no barrier spans the block within a window; a warp whose lanes
// are settled does no further pair work, it only passes the stages on. Every
// copy the producer starts is awaited by all consumers, so none is in flight
// when the block retires. The block stops at the first window in which every
// warp has left the list.
//
// What bounds it on the H100: as sweep.cu, the FP32 pair work on CUDA cores.
// The table (a few MB) sits in the 50 MB L2, so the ring hides L2 latency,
// not HBM bandwidth, and its depth made no difference that could be measured
// (2, 3, 4 and 6 stages within 2%): two stages, the least shared memory, so
// that blocks share an SM even at chunks of 512. Four consumer warps a block
// measured 4-6% faster than eight: two blocks share an SM, each waits for the slowest of four warps, not of eight,
// and fetches what four warps want, not eight. The design spends pair work
// only on chunks a warp's own rays enter and fetches only chunks some warp of
// the block wants. On tables that fit L2 the resident form (sweep.cu) is the
// faster of the two at every chunk size measured (PERF.md); where the
// boundary between them should lie on this card is open.
//
// The ring is 2 * 64 * C bytes of dynamic shared memory; past 48 KB the
// launcher raises the kernel's limit first (cudaFuncSetAttribute) and reports
// its error if the card refuses.

#include <cstdint>

#include "sweep_common.cuh"

namespace {

using namespace rt;

constexpr int kStages = 2;      // of the ring; ops/sweep.py sizes its check by it
// consumer warps a block; a tile is shared out among kWarpsPerTile / kConsumers blocks
constexpr int kConsumers = 4;
static_assert(kWarpsPerTile % kConsumers == 0, "whole blocks share out a tile");
constexpr int kParts = kWarpsPerTile / kConsumers;
constexpr int kThreads = (kConsumers + 1) * 32;      // the last warp produces

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Block until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <bool kAny>
// two blocks of four consumer warps an SM leave ptxas its registers; asked
// for three it spills
__global__ void __launch_bounds__(kThreads, 2)
sweep_stream_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                    const float* __restrict__ consts, const float* __restrict__ meta,
                    const float* __restrict__ lo, const float* __restrict__ hi,
                    const int* __restrict__ chunk_list, const int* __restrict__ counts,
                    const float* __restrict__ entry, float* __restrict__ out_t,
                    int* __restrict__ out_i, int* __restrict__ tested, int m_chunks, int c,
                    Thresholds th) {
  extern __shared__ __align__(128) float4 s_ring[];   // kStages * c * kCoef floats
  __shared__ __align__(8) uint64_t s_full[kStages], s_empty[kStages];
  __shared__ unsigned s_mask[2][kConsumers];
  __shared__ int s_left[2][kConsumers];

  const int lane = threadIdx.x & 31;
  const int slot = threadIdx.x >> 5;
  const bool producer = slot == kConsumers;
  const int tile = blockIdx.x / kParts;
  const int warp = (blockIdx.x % kParts) * kConsumers + slot;   // of the tile
  const int n = counts[tile];
  const int* list = chunk_list + static_cast<size_t>(tile) * m_chunks;
  const float* ent = entry + static_cast<size_t>(tile) * m_chunks;
  const int chunk_f4 = c * kCoef / 4;
  const uint32_t chunk_bytes = static_cast<uint32_t>(chunk_f4) * sizeof(float4);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&s_full[s], 1);                // the producer's arrive with the byte count
      mbar_init(&s_empty[s], kConsumers);      // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  Rays r;
  if (!producer) load_rays(r, ro, rd, tile, warp, lane);

  // position of the next fetch in the ring, the same in every warp: its
  // stage, and how many times the ring has gone round
  int stage = 0;
  uint32_t round = 0;
  int n_tested = 0;
  bool left = false;   // the warp has left the list (phase C, best hits as they are)
  bool gone = false;   // the same, as phase A sees it one window ahead
  for (int j0 = 0, win = 0; j0 < n; j0 += 32, ++win) {
    const int buf = win & 1;
    const int span = min(32, n - j0);
    const int mine = min(j0 + lane, n - 1);
    const int m_l = list[mine];
    float e_l = 0.0f;
    unsigned want = 0;
    if (!producer) {
      e_l = ent[mine];
      // A: the window's votes with the best hits as they stand
      gone = left;
      for (int jj = 0; jj < span && !gone; ++jj) {
        const int verdict = warp_verdict<kAny>(r, __shfl_sync(kFullWarp, e_l, jj), lo, hi,
                                               __shfl_sync(kFullWarp, m_l, jj));
        if (verdict == 0) gone = true;
        if (verdict == 2) want |= 1u << jj;
      }
      if (lane == 0) { s_mask[buf][slot] = want; s_left[buf][slot] = gone; }
    }
    __syncthreads();
    unsigned fetch = 0;
    int all_left = 1;
#pragma unroll
    for (int w = 0; w < kConsumers; ++w) { fetch |= s_mask[buf][w]; all_left &= s_left[buf][w]; }

    for (unsigned rest = fetch; rest != 0; rest &= rest - 1) {
      const int jj = __ffs(rest) - 1;
      const int m = __shfl_sync(kFullWarp, m_l, jj);
      if (producer) {
        // B: refill the stage once every consumer has passed it on
        if (lane == 0) {
          mbar_wait(&s_empty[stage], (round & 1) ^ 1);
          mbar_expect_tx(&s_full[stage], chunk_bytes);
          bulk_copy(s_ring + static_cast<size_t>(stage) * chunk_f4,
                    consts + static_cast<size_t>(m) * c * kCoef, chunk_bytes, &s_full[stage]);
        }
      } else {
        // C: the verdict with the best hits as they are now
        bool run = false;
        if (!left && ((want >> jj) & 1)) {
          const int verdict = warp_verdict<kAny>(r, __shfl_sync(kFullWarp, e_l, jj), lo, hi, m);
          left = verdict == 0;
          run = verdict == 2;
        }
        float gx = 0.0f, gy = 0.0f, gz = 0.0f;
        if (run) { gx = __ldg(meta + 3 * m); gy = __ldg(meta + 3 * m + 1); gz = __ldg(meta + 3 * m + 2); }
        mbar_wait(&s_full[stage], round & 1);
        if (run) {
          sweep_chunk<kAny>(r, s_ring + static_cast<size_t>(stage) * chunk_f4, c, m, gx,
                                   gy, gz, th);
          ++n_tested;
        }
        __syncwarp();   // every lane has read the stage
        if (lane == 0) mbar_arrive(&s_empty[stage]);
      }
      if (++stage == kStages) { stage = 0; ++round; }
    }
    left |= gone;          // what phase A saw holds all the more by now
    if (all_left) break;   // the same in every thread
  }

  if (!producer) {
    store_rays(r, out_t, out_i, tile, warp, lane);
    if (tested != nullptr && lane == 0) tested[tile * kWarpsPerTile + warp] = n_tested;
  }
}

template <bool kAny>
cudaError_t launch(const float* ro, const float* rd, const float* consts, const float* meta,
                   const float* lo, const float* hi, const int* chunk_list, const int* counts,
                   const float* entry, float* out_t, int* out_i, int* tested, int n_tiles,
                   int m_chunks, int c, Thresholds th, cudaStream_t s) {
  const size_t smem = kStages * static_cast<size_t>(c) * kCoef * sizeof(float);
  if (smem + 1024 > 48 * 1024) {   // with the kernel's static shared memory
    cudaError_t err = cudaFuncSetAttribute(sweep_stream_kernel<kAny>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();   // reported here; do not leave it for the next launch to find
      return err;
    }
  }
  sweep_stream_kernel<kAny><<<n_tiles * kParts, kThreads, smem, s>>>(
      ro, rd, consts, meta, lo, hi, chunk_list, counts, entry, out_t, out_i, tested, m_chunks, c,
      th);
  return cudaGetLastError();
}

}  // namespace

// Same interface as rt_sweep (sweep.cu).
extern "C" int rt_sweep_stream(const float* ro, const float* rd, const float* consts,
                               const float* meta, const float* lo, const float* hi,
                               const int* chunk_list, const int* counts, const float* entry,
                               float* out_t, int* out_i, int* tested, int n_tiles, int m_chunks,
                               int c, double det_eps, double t_min, int any_mode, int device,
                               void* stream) {
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
