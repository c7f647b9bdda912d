// Chunk sweep for Hopper (sm_90a): exact FP32 closest-hit / occlusion over
// per-tile front-to-back chunk lists.
//
// Replaces the TPU kernel realtrace_tpu/ops/pallas/trace.py::_kernel_resident
// (with _recenter, _live_max_t and _reduce_update). The plain PyTorch twin
// realtrace_tpu_torch/ops/sweep.py::sweep_reference defines the semantics.
//
// Work split: one thread block per 1024-ray tile, 256 threads, 4 rays per
// thread (ray r of the tile = threadIdx.x + k*256, so loads coalesce). For
// each listed chunk the block stages the chunk's C triangles' constants
// (16 floats each: n, d, c1, e2, c2, e1, relative to the chunk centroid G)
// in shared memory, re-centres its rays on G (ro' = ro - G, q' = q - rd x G
// with q = rd x ro) and evaluates per (ray, triangle) pair
//   det = n.rd   tnum = d - n.ro'   bnum = c1.rd - e2.q'   gnum = c2.rd + e1.q'
// Closest mode applies the divided validity tests (|det| >= eps, beta > 0,
// gamma > 0, beta + gamma < 1, t > t_min), keeps the first minimum within the
// chunk, and replaces the ray's best hit only when strictly closer, in list
// order. Any mode applies the division-free sign tests and records the first
// occluding chunk. Parked lanes (ro.x == PARK_DISTANCE) take part in the
// tests but not in the exit votes.
//
// Early exits, as block-wide votes (__syncthreads_or), never change the
// result: closest mode stops once the next list entry bound exceeds every
// live lane's best t (no later chunk can hold a closer hit), any mode once
// every live lane is occluded.
//
// Rounding: every product and sum is an explicitly rounded __fmul_rn /
// __fadd_rn / __fsub_rn (no FMA contraction), evaluated in the twin's order,
// so the kernel reproduces the twin bit for bit; a contracted FMA would flip
// rays that pass within an ulp of a triangle edge.
//
// What bounds it on the H100: the FP32 epilogue per (ray, triangle) pair:
// 19 multiplies and 15 adds for the four forms, a division and ~8
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

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;
constexpr int kThreads = 256;
constexpr int kRaysPerThread = kTile / kThreads;
constexpr int kCoef = 16;
constexpr float kBig = 1e30f;
constexpr float kPark = 1e8f;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// ((a.x*b.x + a.y*b.y) + a.z*b.z), each step rounded
__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by,
                                      float bz) {
  return __fadd_rn(__fadd_rn(mul(ax, bx), mul(ay, by)), mul(az, bz));
}

// a*b - c*d, each step rounded (one component of a cross product)
__device__ __forceinline__ float cross1(float a, float b, float c, float d) {
  return __fsub_rn(mul(a, b), mul(c, d));
}

template <bool kAny>
__global__ void __launch_bounds__(kThreads)
sweep_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
             const float* __restrict__ consts, const float* __restrict__ meta,
             const int* __restrict__ chunk_list, const int* __restrict__ counts,
             const float* __restrict__ entry, float* __restrict__ out_t,
             int* __restrict__ out_i, int m_chunks, int c, float det_eps, float det_eps2,
             float t_min) {
  extern __shared__ float4 s_tri4[];  // c * kCoef floats
  const float* s_tri = reinterpret_cast<const float*>(s_tri4);
  __shared__ float s_g[3];

  const int tile = blockIdx.x;
  const int n = counts[tile];
  const int* list = chunk_list + static_cast<size_t>(tile) * m_chunks;
  const float* ent = entry + static_cast<size_t>(tile) * m_chunks;

  float ox[kRaysPerThread], oy[kRaysPerThread], oz[kRaysPerThread];
  float dx[kRaysPerThread], dy[kRaysPerThread], dz[kRaysPerThread];
  float qx[kRaysPerThread], qy[kRaysPerThread], qz[kRaysPerThread];
  float best_t[kRaysPerThread];
  int best_i[kRaysPerThread];
  bool parked[kRaysPerThread];
#pragma unroll
  for (int k = 0; k < kRaysPerThread; ++k) {
    const size_t r = static_cast<size_t>(tile) * kTile + k * kThreads + threadIdx.x;
    ox[k] = ro[3 * r]; oy[k] = ro[3 * r + 1]; oz[k] = ro[3 * r + 2];
    dx[k] = rd[3 * r]; dy[k] = rd[3 * r + 1]; dz[k] = rd[3 * r + 2];
    qx[k] = cross1(dy[k], oz[k], dz[k], oy[k]);
    qy[k] = cross1(dz[k], ox[k], dx[k], oz[k]);
    qz[k] = cross1(dx[k], oy[k], dy[k], ox[k]);
    parked[k] = ox[k] == kPark;
    best_t[k] = kBig;
    best_i[k] = -1;
  }

  for (int j = 0; j < n; ++j) {
    const int m = list[j];
    __syncthreads();  // the previous chunk's constants are no longer read
    const float4* src = reinterpret_cast<const float4*>(consts + static_cast<size_t>(m) * c * kCoef);
    for (int i = threadIdx.x; i < c * kCoef / 4; i += kThreads) s_tri4[i] = src[i];
    if (threadIdx.x < 3) s_g[threadIdx.x] = meta[3 * m + threadIdx.x];
    __syncthreads();
    const float gx = s_g[0], gy = s_g[1], gz = s_g[2];

    float rx[kRaysPerThread], ry[kRaysPerThread], rz[kRaysPerThread];
    float px[kRaysPerThread], py[kRaysPerThread], pz[kRaysPerThread];
    float cmin[kRaysPerThread];
    int carg[kRaysPerThread];
    bool occ[kRaysPerThread];
#pragma unroll
    for (int k = 0; k < kRaysPerThread; ++k) {
      rx[k] = ox[k] - gx; ry[k] = oy[k] - gy; rz[k] = oz[k] - gz;
      px[k] = qx[k] - cross1(dy[k], gz, dz[k], gy);
      py[k] = qy[k] - cross1(dz[k], gx, dx[k], gz);
      pz[k] = qz[k] - cross1(dx[k], gy, dy[k], gx);
      cmin[k] = kBig;
      carg[k] = 0;
      occ[k] = false;
    }

    for (int i = 0; i < c; ++i) {
      const float* w = s_tri + i * kCoef;
      const float nx = w[0], ny = w[1], nz = w[2], d = w[3];
      const float c1x = w[4], c1y = w[5], c1z = w[6];
      const float e2x = w[7], e2y = w[8], e2z = w[9];
      const float c2x = w[10], c2y = w[11], c2z = w[12];
      const float e1x = w[13], e1y = w[14], e1z = w[15];
#pragma unroll
      for (int k = 0; k < kRaysPerThread; ++k) {
        const float det = dot3(nx, ny, nz, dx[k], dy[k], dz[k]);
        const float tnum = d - dot3(nx, ny, nz, rx[k], ry[k], rz[k]);
        const float bnum = dot3(c1x, c1y, c1z, dx[k], dy[k], dz[k])
                           - dot3(e2x, e2y, e2z, px[k], py[k], pz[k]);
        const float gnum = dot3(c2x, c2y, c2z, dx[k], dy[k], dz[k])
                           + dot3(e1x, e1y, e1z, px[k], py[k], pz[k]);
        if (kAny) {
          const float det2 = mul(det, det);
          const float m1 = mul(bnum, det), m2 = mul(gnum, det);
          occ[k] |= (det2 >= det_eps2) && (m1 > 0.0f) && (m2 > 0.0f) && (m1 + m2 < det2)
                    && (mul(tnum, det) > mul(t_min, det2));
        } else {
          const bool ok = fabsf(det) >= det_eps;
          const float invd = 1.0f / (ok ? det : 1.0f);
          const float t = mul(tnum, invd), beta = mul(bnum, invd), gamma = mul(gnum, invd);
          const bool valid = ok && (beta > 0.0f) && (gamma > 0.0f) && (beta + gamma < 1.0f)
                             && (t > t_min);
          if (valid && t < cmin[k]) { cmin[k] = t; carg[k] = i; }
        }
      }
    }

    // fold the chunk into the per-ray best, then vote on going on
    int go = 0;
    const bool more = j + 1 < n;
    const float next_entry = more ? ent[j + 1] : 0.0f;
#pragma unroll
    for (int k = 0; k < kRaysPerThread; ++k) {
      if (kAny) {
        if (occ[k] && best_i[k] < 0) best_i[k] = m * c;
        go |= !parked[k] && best_i[k] < 0;
      } else {
        if (cmin[k] < best_t[k]) { best_t[k] = cmin[k]; best_i[k] = m * c + carg[k]; }
        go |= (parked[k] ? 0.0f : best_t[k]) >= next_entry;
      }
    }
    if (!more) break;                      // uniform across the block
    if (!__syncthreads_or(go)) break;
  }

#pragma unroll
  for (int k = 0; k < kRaysPerThread; ++k) {
    const size_t r = static_cast<size_t>(tile) * kTile + k * kThreads + threadIdx.x;
    out_t[r] = best_t[k];
    out_i[r] = best_i[k];
  }
}

}  // namespace

extern "C" int rt_sweep(const float* ro, const float* rd, const float* consts, const float* meta,
                        const int* chunk_list, const int* counts, const float* entry,
                        float* out_t, int* out_i, int n_tiles, int m_chunks, int c,
                        double det_eps, double t_min, int any_mode, int device,
                        void* stream) {
  // the thresholds round to float as the twin's Python scalars do, and the
  // squared epsilon is squared in double first, as in the twin
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_tiles == 0) return 0;
  const size_t smem = static_cast<size_t>(c) * kCoef * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float eps = static_cast<float>(det_eps);
  const float eps2 = static_cast<float>(det_eps * det_eps);
  const float tmin = static_cast<float>(t_min);
  if (any_mode) {
    sweep_kernel<true><<<n_tiles, kThreads, smem, s>>>(ro, rd, consts, meta, chunk_list, counts,
                                                       entry, out_t, out_i, m_chunks, c,
                                                       eps, eps2, tmin);
  } else {
    sweep_kernel<false><<<n_tiles, kThreads, smem, s>>>(ro, rd, consts, meta, chunk_list, counts,
                                                        entry, out_t, out_i, m_chunks, c,
                                                        eps, eps2, tmin);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
