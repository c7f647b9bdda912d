// Chunk masks for Hopper (sm_90a): each 1024-ray tile's conservative chunk
// list, sorted front to back, in one launch for all tiles of a query.
//
// Replaces the XLA code of realtrace_tpu/ops/pallas/trace.py::_chunk_mask and
// ::_compact_front_to_back (the JAX package has no Pallas kernel for them).
// The plain PyTorch twin realtrace_tpu_torch/ops/sweep.py::chunk_mask_reference
// defines the function; this kernel computes it bit for bit: lists, entries
// and counts.
//
// The function, per tile: the live lanes (origin x != 1e8) fall into eight
// direction octants by the signs of 1/rd. Per octant, the bounds
// [ro_min, ro_max] x [inv_min, inv_max] of its lanes interval-evaluate the
// slab test of every chunk box, which gives an optimistic entry (clamped at 0)
// and exit; the chunk passes the octant if exit * (1 + 1e-6) + 1e-6 >= entry.
// A chunk is listed if an octant passes it, and its entry is the least over
// the eight octants, an octant that does not pass it counting 1e30. The list
// holds the listed chunks by (entry in IEEE total order, chunk index), then
// the others in index order with entry 0.
//
// What bounds it on the H100: memory. The 1080p primary query reads its
// 2,088,960 rays once (24 bytes each, 50 MB) and writes 2,040 x 336 list
// positions (8 bytes each, 5.5 MB): about 17 us at 3.35 TB/s. The boxes
// (24 bytes a chunk) come from L2 to every block. The arithmetic, eight
// octants x 336 boxes x about 100 operations a tile, and the sort, a bitonic
// network of 45 steps over 512 keys a tile, are far from the card's limits.
// The twin took about 374 small launches a call.
//
// The design keeps the tile on one SM: one block a tile, 256 threads, four
// rays a thread (rays t, t + 256, ... of the tile, so loads coalesce). The
// octant bounds reduce by warp shuffles, then across the eight warps in
// shared memory; octants no lane takes are skipped. Each thread then tests
// chunks t, t + 256, ... against the occupied octants and packs
// (total-order key of the entry, chunk index) into a 64-bit key in shared
// memory. The pairs are unique, so a bitonic sort of the keys gives what a
// stable sort by entry gives. Only the rays, the boxes and the outputs touch
// device memory.
//
// Rounding and special values, as the twin: explicitly rounded __fsub_rn /
// __fmul_rn / __fadd_rn (no FMA contraction), 1/rd by __frcp_rn with 1e30
// where rd == 0 (-0.0 included), the four candidate products in the twin's
// order, NaN propagating through every min and max as torch.amin, amax,
// minimum and maximum do, the clamp at 0 keeping a NaN. Which zero a
// reduction returns on a tie of +0.0 and -0.0 depends on its order, so both
// the twin and this kernel turn a -0.0 entry into +0.0 (entry + 0.0) before
// the sort; no other result depends on the sign of a zero.
//
// The launch allocates nothing, runs on the caller's stream and returns
// cudaGetLastError(), so a refused launch is reported.

#include "sweep_common.cuh"

namespace {

using namespace rt;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRaysPerThread = kTile / kThreads;
constexpr int kOctants = 8;
// the octant bounds: ro_lo xyz, ro_hi xyz, inv_lo xyz, inv_hi xyz
constexpr int kBounds = 12;
// keys one block sorts: ops/sweep.py's MASK_SORT_CAPACITY
constexpr int kSortSlots = 2048;
// bit of a warp's or tile's octant set: some lane is parked (in no octant)
constexpr unsigned kParkedBit = 1u << kOctants;

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ bool is_nan(float x) { return x != x; }

__device__ __forceinline__ bool low_bound(int q) { return q % 6 < 3; }

// torch.minimum / torch.amin: a NaN wins
__device__ __forceinline__ float min_nan(float a, float b) {
  return is_nan(a) ? a : (is_nan(b) ? b : fminf(a, b));
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return is_nan(a) ? a : (is_nan(b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ float fold(int q, float a, float b) {
  return low_bound(q) ? min_nan(a, b) : max_nan(a, b);
}

// 1/rd as ops/sweep.py::_inv_dir computes it: torch.reciprocal, 1e30 where 0
__device__ __forceinline__ float reciprocal_dir(float d) {
  return d != 0.0f ? __frcp_rn(d) : kBig;
}

// the twin's plane_interval: the interval of (p - ro) * inv over the octant's
// bounds, from the four products in the twin's order
__device__ __forceinline__ void plane_interval(float p, const float* b, int ax, float& t_lo,
                                               float& t_hi) {
  const float a_lo = __fsub_rn(p, b[3 + ax]), a_hi = __fsub_rn(p, b[ax]);
  const float c0 = mul(a_lo, b[6 + ax]), c1 = mul(a_lo, b[9 + ax]);
  const float c2 = mul(a_hi, b[6 + ax]), c3 = mul(a_hi, b[9 + ax]);
  t_lo = min_nan(min_nan(min_nan(c0, c1), c2), c3);
  t_hi = max_nan(max_nan(max_nan(c0, c1), c2), c3);
}

// (ops/accel.py::total_order_key of x, index) as one unsigned 64-bit key that
// sorts as the pair does
__device__ __forceinline__ unsigned long long sort_key(float x, int index) {
  const int b = __float_as_int(x);
  const unsigned key = static_cast<unsigned>(b ^ ((b >> 31) & 0x7fffffff)) ^ 0x80000000u;
  return (static_cast<unsigned long long>(key) << 32) | static_cast<unsigned>(index);
}

__global__ void __launch_bounds__(kThreads)
chunk_mask_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                  const float* __restrict__ lo, const float* __restrict__ hi,
                  int* __restrict__ chunk_list, float* __restrict__ entry,
                  int* __restrict__ counts, int m_chunks, int slots) {
  __shared__ float s_part[kWarps][kOctants][kBounds];
  __shared__ float s_bound[kOctants][kBounds];
  __shared__ unsigned s_occ[kWarps];
  __shared__ unsigned long long s_key[kSortSlots];
  __shared__ float s_pay[kSortSlots];
  __shared__ int s_count;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t base = static_cast<size_t>(blockIdx.x) * kTile * 3;

  // this thread's rays: origin, 1/rd and octant (-1: parked)
  float v[kRaysPerThread][6];
  int oct[kRaysPerThread];
  unsigned occ = 0;
#pragma unroll
  for (int k = 0; k < kRaysPerThread; ++k) {
    const size_t at = base + 3 * static_cast<size_t>(tid + k * kThreads);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      v[k][c] = ro[at + c];
      v[k][3 + c] = reciprocal_dir(rd[at + c]);
    }
    const bool live = v[k][0] != kPark;
    oct[k] = live ? (v[k][3] < 0.0f) | (v[k][4] < 0.0f) << 1 | (v[k][5] < 0.0f) << 2 : -1;
    occ |= live ? 1u << oct[k] : kParkedBit;
  }
  occ = __reduce_or_sync(kFullWarp, occ);
  if (lane == 0) s_occ[warp] = occ;
  if (tid == 0) s_count = 0;

  // each octant's bounds over the warp's lanes in it
#pragma unroll
  for (int o = 0; o < kOctants; ++o) {
    if (!(occ >> o & 1u)) continue;   // the same for every lane of the warp
    float b[kBounds];
#pragma unroll
    for (int q = 0; q < kBounds; ++q) b[q] = low_bound(q) ? inf() : -inf();
#pragma unroll
    for (int k = 0; k < kRaysPerThread; ++k) {
      if (oct[k] != o) continue;
#pragma unroll
      for (int q = 0; q < kBounds; ++q) b[q] = fold(q, b[q], v[k][(q / 6) * 3 + q % 3]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int q = 0; q < kBounds; ++q)
        b[q] = fold(q, b[q], __shfl_xor_sync(kFullWarp, b[q], off));
    }
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < kBounds; ++q) s_part[warp][o][q] = b[q];
    }
  }
  __syncthreads();

  unsigned tile_occ = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) tile_occ |= s_occ[w];
  // ... and over the tile's warps. The twin reduces every lane of the tile,
  // a lane outside the octant (in another, or parked) as +-1e30.
  if (tid < kOctants * kBounds) {
    const int o = tid / kBounds, q = tid % kBounds;
    if (tile_occ >> o & 1u) {
      const bool others = (tile_occ & ~(1u << o)) != 0;
      float acc = low_bound(q) ? (others ? kBig : inf()) : (others ? -kBig : -inf());
      for (int w = 0; w < kWarps; ++w)
        if (s_occ[w] >> o & 1u) acc = fold(q, acc, s_part[w][o][q]);
      s_bound[o][q] = acc;
    }
  }
  __syncthreads();

  // every chunk against the occupied octants; slots past the chunks sort last
  const unsigned octs = tile_occ & ((1u << kOctants) - 1);
  for (int i = tid; i < slots; i += kThreads) {
    unsigned long long key = ~0ull;
    if (i < m_chunks) {
      float p_lo[3], p_hi[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        p_lo[c] = __ldg(lo + 3 * i + c);
        p_hi[c] = __ldg(hi + 3 * i + c);
      }
      bool listed = false;
      // an octant no lane takes passes nothing: it counts 1e30
      float ent = octs == (1u << kOctants) - 1 ? inf() : kBig;
      for (int o = 0; o < kOctants; ++o) {
        if (!(octs >> o & 1u)) continue;
        const float* b = s_bound[o];
        float tn = 0.0f, tf = 0.0f;
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) {
          float ta_lo, ta_hi, tb_lo, tb_hi;
          plane_interval(p_lo[ax], b, ax, ta_lo, ta_hi);
          plane_interval(p_hi[ax], b, ax, tb_lo, tb_hi);
          const float near = min_nan(ta_lo, tb_lo), far = max_nan(ta_hi, tb_hi);
          tn = ax == 0 ? near : max_nan(tn, near);
          tf = ax == 0 ? far : min_nan(tf, far);
        }
        const float e = is_nan(tn) ? tn : fmaxf(tn, 0.0f);   // torch.clamp(min=0.0)
        const bool pass = __fadd_rn(mul(tf, kPadMul), kPadAdd) >= e;
        listed |= pass;
        ent = fminf(ent, pass ? e : kBig);   // e is a number where the octant passes
      }
      ent = __fadd_rn(ent, 0.0f);            // -0.0 -> +0.0, as the twin
      key = sort_key(listed ? ent : inf(), i);
      s_pay[i] = listed ? ent : 0.0f;
      if (listed) atomicAdd(&s_count, 1);
    }
    s_key[i] = key;
  }
  __syncthreads();

  // bitonic sort of the slots (a power of two), ascending
  for (int k = 2; k <= slots; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = tid; t < slots / 2; t += kThreads) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const unsigned long long a = s_key[i], b = s_key[i + j];
        if ((a > b) == ((i & k) == 0)) {
          s_key[i] = b;
          s_key[i + j] = a;
        }
      }
      __syncthreads();
    }
  }

  const size_t row = static_cast<size_t>(blockIdx.x) * m_chunks;
  for (int j = tid; j < m_chunks; j += kThreads) {
    const int i = static_cast<int>(s_key[j] & 0xffffffffu);
    chunk_list[row + j] = i;
    entry[row + j] = s_pay[i];
  }
  if (tid == 0) counts[blockIdx.x] = s_count;
}

}  // namespace

// ro, rd: (n_tiles * 1024, 3); lo, hi: (m_chunks, 3); chunk_list, entry:
// (n_tiles, m_chunks); counts: (n_tiles,). m_chunks at most kSortSlots.
extern "C" int rt_chunk_mask(const float* ro, const float* rd, const float* lo, const float* hi,
                             int* chunk_list, float* entry, int* counts, int n_tiles,
                             int m_chunks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_tiles == 0) return 0;
  if (m_chunks < 0 || m_chunks > kSortSlots) return static_cast<int>(cudaErrorInvalidValue);
  int slots = 1;
  while (slots < m_chunks) slots <<= 1;
  chunk_mask_kernel<<<n_tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ro, rd, lo, hi, chunk_list, entry, counts, m_chunks, slots);
  return static_cast<int>(cudaGetLastError());
}
