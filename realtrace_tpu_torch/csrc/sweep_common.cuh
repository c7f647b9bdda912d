// Arithmetic shared by the two chunk-sweep kernels (sweep.cu, the resident
// form, and sweep_stream.cu, the streaming form): the per-tile ray state, the
// exact FP32 (ray, triangle) test over one staged chunk, and the fold of a
// chunk into the per-ray best with the block's vote on going on.
//
// Both kernels compute the function that the plain PyTorch twin
// realtrace_tpu_torch/ops/sweep.py::sweep_reference defines; they differ only
// in how a chunk's constants reach shared memory. Keeping the arithmetic here
// keeps its rounding order the same in both.
//
// Rounding: every product and sum is an explicitly rounded __fmul_rn /
// __fadd_rn / __fsub_rn (no FMA contraction), evaluated in the twin's order,
// so the kernels reproduce the twin bit for bit; a contracted FMA would flip
// rays that pass within an ulp of a triangle edge.
#pragma once

#include <cuda_runtime.h>

namespace rt {

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

// One thread's rays of its tile (ray r of the tile = threadIdx.x + k*kThreads,
// so loads coalesce), with q = rd x ro and the running best hit.
struct Rays {
  float ox[kRaysPerThread], oy[kRaysPerThread], oz[kRaysPerThread];
  float dx[kRaysPerThread], dy[kRaysPerThread], dz[kRaysPerThread];
  float qx[kRaysPerThread], qy[kRaysPerThread], qz[kRaysPerThread];
  float best_t[kRaysPerThread];
  int best_i[kRaysPerThread];
  bool parked[kRaysPerThread];
};

__device__ __forceinline__ void load_rays(Rays& r, const float* __restrict__ ro,
                                          const float* __restrict__ rd, int tile) {
#pragma unroll
  for (int k = 0; k < kRaysPerThread; ++k) {
    const size_t i = static_cast<size_t>(tile) * kTile + k * kThreads + threadIdx.x;
    r.ox[k] = ro[3 * i]; r.oy[k] = ro[3 * i + 1]; r.oz[k] = ro[3 * i + 2];
    r.dx[k] = rd[3 * i]; r.dy[k] = rd[3 * i + 1]; r.dz[k] = rd[3 * i + 2];
    r.qx[k] = cross1(r.dy[k], r.oz[k], r.dz[k], r.oy[k]);
    r.qy[k] = cross1(r.dz[k], r.ox[k], r.dx[k], r.oz[k]);
    r.qz[k] = cross1(r.dx[k], r.oy[k], r.dy[k], r.ox[k]);
    r.parked[k] = r.ox[k] == kPark;
    r.best_t[k] = kBig;
    r.best_i[k] = -1;
  }
}

__device__ __forceinline__ void store_rays(const Rays& r, float* __restrict__ out_t,
                                           int* __restrict__ out_i, int tile) {
#pragma unroll
  for (int k = 0; k < kRaysPerThread; ++k) {
    const size_t i = static_cast<size_t>(tile) * kTile + k * kThreads + threadIdx.x;
    out_t[i] = r.best_t[k];
    out_i[i] = r.best_i[k];
  }
}

// Test this thread's rays against the c triangles staged at s_tri (16 floats
// each: n, d, c1, e2, c2, e1, relative to the chunk centroid g), fold the
// chunk (id m) into the per-ray best, and return this thread's vote on going
// on to the next list position, whose entry bound is next_entry:
//   det = n.rd   tnum = d - n.ro'   bnum = c1.rd - e2.q'   gnum = c2.rd + e1.q'
// with ro' = ro - g, q' = q - rd x g. Closest mode applies the divided
// validity tests, keeps the first minimum within the chunk and replaces the
// best hit only when strictly closer; it votes to go on while any live lane's
// best t is not below next_entry. Any mode applies the division-free sign
// tests, records the first occluding chunk, and votes to go on while any live
// lane is unoccluded. Parked lanes take part in the tests, not in the votes.
template <bool kAny>
__device__ __forceinline__ int sweep_chunk(Rays& r, const float* __restrict__ s_tri, int c,
                                           int m, float gx, float gy, float gz,
                                           float next_entry, float det_eps, float det_eps2,
                                           float t_min) {
  float rx[kRaysPerThread], ry[kRaysPerThread], rz[kRaysPerThread];
  float px[kRaysPerThread], py[kRaysPerThread], pz[kRaysPerThread];
  float cmin[kRaysPerThread];
  int carg[kRaysPerThread];
  bool occ[kRaysPerThread];
#pragma unroll
  for (int k = 0; k < kRaysPerThread; ++k) {
    rx[k] = r.ox[k] - gx; ry[k] = r.oy[k] - gy; rz[k] = r.oz[k] - gz;
    px[k] = r.qx[k] - cross1(r.dy[k], gz, r.dz[k], gy);
    py[k] = r.qy[k] - cross1(r.dz[k], gx, r.dx[k], gz);
    pz[k] = r.qz[k] - cross1(r.dx[k], gy, r.dy[k], gx);
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
      const float det = dot3(nx, ny, nz, r.dx[k], r.dy[k], r.dz[k]);
      const float tnum = d - dot3(nx, ny, nz, rx[k], ry[k], rz[k]);
      const float bnum = dot3(c1x, c1y, c1z, r.dx[k], r.dy[k], r.dz[k])
                         - dot3(e2x, e2y, e2z, px[k], py[k], pz[k]);
      const float gnum = dot3(c2x, c2y, c2z, r.dx[k], r.dy[k], r.dz[k])
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

  int go = 0;
#pragma unroll
  for (int k = 0; k < kRaysPerThread; ++k) {
    if (kAny) {
      if (occ[k] && r.best_i[k] < 0) r.best_i[k] = m * c;
      go |= !r.parked[k] && r.best_i[k] < 0;
    } else {
      if (cmin[k] < r.best_t[k]) { r.best_t[k] = cmin[k]; r.best_i[k] = m * c + carg[k]; }
      go |= (r.parked[k] ? 0.0f : r.best_t[k]) >= next_entry;
    }
  }
  return go;
}

// The thresholds as the kernels take them: rounded to float as the twin's
// Python scalars are, the squared epsilon squared in double first.
struct Thresholds {
  float det_eps, det_eps2, t_min;
  Thresholds(double eps, double tmin)
      : det_eps(static_cast<float>(eps)), det_eps2(static_cast<float>(eps * eps)),
        t_min(static_cast<float>(tmin)) {}
};

}  // namespace rt
