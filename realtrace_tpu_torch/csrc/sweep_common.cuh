// Arithmetic shared by the two chunk-sweep kernels (sweep.cu, the resident
// form, and sweep_stream.cu, the streaming form): a warp's ray state, the
// votes that decide which list positions a warp tests (exit and chunk gate),
// and the exact FP32 (ray, triangle) test over one chunk with its fold into
// the per-ray best.
//
// Both kernels compute the function that the plain PyTorch twin
// realtrace_tpu_torch/ops/sweep.py::sweep_reference defines; they differ only
// in how a chunk's constants reach the arithmetic. Keeping the arithmetic here
// keeps its rounding order the same in both.
//
// The unit of control is the warp. Warp w of a 1024-ray tile owns rays
// [128*w, 128*w + 128) of the tile, lane l the rays 128*w + l + 32*k, k = 0..3
// (so loads coalesce). At each list position of its tile, in list order, a warp
//   1. leaves the list if none of its live lanes still wants a chunk: closest
//      mode wants one while the lane's best t is not below the position's
//      entry bound (the list is sorted by entry, so nothing later can be
//      closer), any mode while the lane is unoccluded;
//   2. skips the position unless some live (any mode: and unoccluded) lane's
//      ray enters the chunk's box: the slab test of ops/sweep.py::_slab_hits,
//      same rounding, same pad, with the exit distance cut at the lane's best
//      t in closest mode (a chunk entered behind the best hit holds nothing
//      closer);
//   3. else runs the pair loop for all its lanes.
// Parked lanes (origin x == 1e8) take part in the pair loop, in no vote.
//
// Rounding: every product and sum is an explicitly rounded __fmul_rn /
// __fadd_rn / __fsub_rn (no FMA contraction), evaluated in the twin's order,
// so the kernels reproduce the twin bit for bit, results and verdicts; a
// contracted FMA would flip rays that pass within an ulp of a triangle edge.
#pragma once

#include <cuda_runtime.h>

namespace rt {

constexpr int kTile = 1024;
constexpr int kWarpsPerTile = 8;
constexpr int kRaysPerLane = 4;             // kTile / (kWarpsPerTile * 32)
constexpr int kWarpRays = 32 * kRaysPerLane;
constexpr int kCoef = 16;
constexpr float kBig = 1e30f;
constexpr float kPark = 1e8f;
constexpr unsigned kFullWarp = 0xffffffffu;
// the slab test's pad, as ops/sweep.py writes it: tf * (1 + 1e-6) + 1e-6 >= tn
constexpr float kPadMul = 1.000001f;
constexpr float kPadAdd = 1e-6f;

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

// 1/d as ops/sweep.py::_inv_dir: kBig where the component is 0
__device__ __forceinline__ float inv_dir(float d) { return d != 0.0f ? 1.0f / d : kBig; }

// One lane's rays, with q = rd x ro, 1/rd and the running best hit.
struct Rays {
  float ox[kRaysPerLane], oy[kRaysPerLane], oz[kRaysPerLane];
  float dx[kRaysPerLane], dy[kRaysPerLane], dz[kRaysPerLane];
  float qx[kRaysPerLane], qy[kRaysPerLane], qz[kRaysPerLane];
  float ix[kRaysPerLane], iy[kRaysPerLane], iz[kRaysPerLane];
  float best_t[kRaysPerLane];
  int best_i[kRaysPerLane];
  bool parked[kRaysPerLane];
};

__device__ __forceinline__ size_t ray_index(int tile, int warp, int lane, int k) {
  return static_cast<size_t>(tile) * kTile + warp * kWarpRays + k * 32 + lane;
}

__device__ __forceinline__ void load_rays(Rays& r, const float* __restrict__ ro,
                                          const float* __restrict__ rd, int tile, int warp,
                                          int lane) {
#pragma unroll
  for (int k = 0; k < kRaysPerLane; ++k) {
    const size_t i = ray_index(tile, warp, lane, k);
    r.ox[k] = ro[3 * i]; r.oy[k] = ro[3 * i + 1]; r.oz[k] = ro[3 * i + 2];
    r.dx[k] = rd[3 * i]; r.dy[k] = rd[3 * i + 1]; r.dz[k] = rd[3 * i + 2];
    r.qx[k] = cross1(r.dy[k], r.oz[k], r.dz[k], r.oy[k]);
    r.qy[k] = cross1(r.dz[k], r.ox[k], r.dx[k], r.oz[k]);
    r.qz[k] = cross1(r.dx[k], r.oy[k], r.dy[k], r.ox[k]);
    r.ix[k] = inv_dir(r.dx[k]); r.iy[k] = inv_dir(r.dy[k]); r.iz[k] = inv_dir(r.dz[k]);
    r.parked[k] = r.ox[k] == kPark;
    r.best_t[k] = kBig;
    r.best_i[k] = -1;
  }
}

__device__ __forceinline__ void store_rays(const Rays& r, float* __restrict__ out_t,
                                           int* __restrict__ out_i, int tile, int warp,
                                           int lane) {
#pragma unroll
  for (int k = 0; k < kRaysPerLane; ++k) {
    const size_t i = ray_index(tile, warp, lane, k);
    out_t[i] = r.best_t[k];
    out_i[i] = r.best_i[k];
  }
}

// Vote 1: does any of this lane's live rays still want a chunk whose entry
// bound is `entry`?
template <bool kAny>
__device__ __forceinline__ bool lane_wants(const Rays& r, float entry) {
  bool want = false;
#pragma unroll
  for (int k = 0; k < kRaysPerLane; ++k)
    want |= !r.parked[k] && (kAny ? r.best_i[k] < 0 : r.best_t[k] >= entry);
  return want;
}

// One axis of the slab test; a NaN (0 * inf) makes torch's minimum / maximum
// return NaN and the final comparison false, fminf / fmaxf would drop it.
__device__ __forceinline__ void slab_axis(float lo, float hi, float o, float inv, float& tn,
                                          float& tf, bool& nan) {
  const float ta = mul(__fsub_rn(lo, o), inv), tb = mul(__fsub_rn(hi, o), inv);
  nan |= (ta != ta) || (tb != tb);
  tn = fmaxf(tn, fminf(ta, tb));
  tf = fminf(tf, fmaxf(ta, tb));
}

// Vote 2: does any of this lane's live (any mode: unoccluded) rays enter the
// box [lo, hi]? Closest mode cuts the exit distance at the ray's best t.
template <bool kAny>
__device__ __forceinline__ bool lane_enters(const Rays& r, const float* lo, const float* hi) {
  bool enters = false;
#pragma unroll
  for (int k = 0; k < kRaysPerLane; ++k) {
    float tn = 0.0f, tf = kBig;
    bool nan = false;
    slab_axis(lo[0], hi[0], r.ox[k], r.ix[k], tn, tf, nan);
    slab_axis(lo[1], hi[1], r.oy[k], r.iy[k], tn, tf, nan);
    slab_axis(lo[2], hi[2], r.oz[k], r.iz[k], tn, tf, nan);
    if (!kAny) tf = fminf(tf, r.best_t[k]);
    const bool pass = !nan && __fadd_rn(mul(tf, kPadMul), kPadAdd) >= tn;
    enters |= pass && !r.parked[k] && (!kAny || r.best_i[k] < 0);
  }
  return enters;
}

// The thresholds as the kernels take them: rounded to float as the twin's
// Python scalars are, the squared epsilon squared in double first.
struct Thresholds {
  float det_eps, det_eps2, t_min;
  Thresholds(double eps, double tmin)
      : det_eps(static_cast<float>(eps)), det_eps2(static_cast<float>(eps * eps)),
        t_min(static_cast<float>(tmin)) {}
};

// Test this lane's rays against the c triangles at tri (four float4 each:
// n d | c1 e2.x | e2.yz c2.xy | c2.z e1, relative to the chunk centroid g) and
// fold the chunk (id m) into the per-ray best:
//   det = n.rd   tnum = d - n.ro'   bnum = c1.rd - e2.q'   gnum = c2.rd + e1.q'
// with ro' = ro - g, q' = q - rd x g. Closest mode applies the divided
// validity tests, keeps the first minimum within the chunk and replaces the
// best hit only when strictly closer. Any mode applies the division-free sign
// tests and records the first occluding chunk. All 32 lanes of the warp call
// this together; tri is shared memory, read as warp-wide broadcasts. The loop
// takes two triangles at a time: on the H100 that measured 7-8% faster than
// one; four gained 1-5% more in closest mode and lost 7-13% in any mode. A
// closest-mode vote that skips the division for a triangle whose numerators'
// signs no ray of the warp passes measured 17-49% slower than dividing
// (PERF.md), so every pair is divided.
template <bool kAny>
__device__ __forceinline__ void sweep_chunk(Rays& r, const float4* __restrict__ tri, int c,
                                            int m, float gx, float gy, float gz,
                                            const Thresholds& th) {
  float rx[kRaysPerLane], ry[kRaysPerLane], rz[kRaysPerLane];
  float px[kRaysPerLane], py[kRaysPerLane], pz[kRaysPerLane];
  float cmin[kRaysPerLane];
  int carg[kRaysPerLane];
  bool occ[kRaysPerLane];
#pragma unroll
  for (int k = 0; k < kRaysPerLane; ++k) {
    rx[k] = r.ox[k] - gx; ry[k] = r.oy[k] - gy; rz[k] = r.oz[k] - gz;
    px[k] = r.qx[k] - cross1(r.dy[k], gz, r.dz[k], gy);
    py[k] = r.qy[k] - cross1(r.dz[k], gx, r.dx[k], gz);
    pz[k] = r.qz[k] - cross1(r.dx[k], gy, r.dy[k], gx);
    cmin[k] = kBig;
    carg[k] = 0;
    occ[k] = false;
  }

#pragma unroll 2
  for (int i = 0; i < c; ++i) {
    const float4* cur = tri + 4 * i;
    const float4 a0 = cur[0], a1 = cur[1], a2 = cur[2], a3 = cur[3];
    const float nx = a0.x, ny = a0.y, nz = a0.z, d = a0.w;
    const float c1x = a1.x, c1y = a1.y, c1z = a1.z;
    const float e2x = a1.w, e2y = a2.x, e2z = a2.y;
    const float c2x = a2.z, c2y = a2.w, c2z = a3.x;
    const float e1x = a3.y, e1y = a3.z, e1z = a3.w;
    if (kAny) {
#pragma unroll
      for (int k = 0; k < kRaysPerLane; ++k) {
        const float det = dot3(nx, ny, nz, r.dx[k], r.dy[k], r.dz[k]);
        const float tnum = d - dot3(nx, ny, nz, rx[k], ry[k], rz[k]);
        const float bnum = dot3(c1x, c1y, c1z, r.dx[k], r.dy[k], r.dz[k])
                           - dot3(e2x, e2y, e2z, px[k], py[k], pz[k]);
        const float gnum = dot3(c2x, c2y, c2z, r.dx[k], r.dy[k], r.dz[k])
                           + dot3(e1x, e1y, e1z, px[k], py[k], pz[k]);
        const float det2 = mul(det, det);
        const float m1 = mul(bnum, det), m2 = mul(gnum, det);
        occ[k] |= (det2 >= th.det_eps2) && (m1 > 0.0f) && (m2 > 0.0f) && (m1 + m2 < det2)
                  && (mul(tnum, det) > mul(th.t_min, det2));
      }
    } else {
#pragma unroll
      for (int k = 0; k < kRaysPerLane; ++k) {
        const float det = dot3(nx, ny, nz, r.dx[k], r.dy[k], r.dz[k]);
        const float bnum = dot3(c1x, c1y, c1z, r.dx[k], r.dy[k], r.dz[k])
                           - dot3(e2x, e2y, e2z, px[k], py[k], pz[k]);
        const float gnum = dot3(c2x, c2y, c2z, r.dx[k], r.dy[k], r.dz[k])
                           + dot3(e1x, e1y, e1z, px[k], py[k], pz[k]);
        const bool ok = fabsf(det) >= th.det_eps;
        const float tnum = d - dot3(nx, ny, nz, rx[k], ry[k], rz[k]);
        const float invd = 1.0f / (ok ? det : 1.0f);
        const float t = mul(tnum, invd), beta = mul(bnum, invd), gamma = mul(gnum, invd);
        const bool valid = ok && (beta > 0.0f) && (gamma > 0.0f)
                           && (beta + gamma < 1.0f) && (t > th.t_min);
        if (valid && t < cmin[k]) { cmin[k] = t; carg[k] = i; }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kRaysPerLane; ++k) {
    if (kAny) {
      if (occ[k] && r.best_i[k] < 0) r.best_i[k] = m * c;
    } else {
      if (cmin[k] < r.best_t[k]) { r.best_t[k] = cmin[k]; r.best_i[k] = m * c + carg[k]; }
    }
  }
}

// A chunk's box (null pointers: no gate, every position is entered) and
// centroid, read by every lane of the warp from the same addresses.
struct ChunkBox {
  float lo[3], hi[3];
};

__device__ __forceinline__ ChunkBox load_box(const float* __restrict__ lo,
                                             const float* __restrict__ hi, int m) {
  ChunkBox b;
#pragma unroll
  for (int a = 0; a < 3; ++a) { b.lo[a] = __ldg(lo + 3 * m + a); b.hi[a] = __ldg(hi + 3 * m + a); }
  return b;
}

// Votes 1 and 2 of one list position for the whole warp. Returns 0 when the
// warp leaves the list, 1 when it skips the position, 2 when it tests it.
template <bool kAny>
__device__ __forceinline__ int warp_verdict(const Rays& r, float entry,
                                            const float* __restrict__ lo,
                                            const float* __restrict__ hi, int m) {
  if (!__any_sync(kFullWarp, lane_wants<kAny>(r, entry))) return 0;
  if (lo == nullptr) return 2;
  const ChunkBox b = load_box(lo, hi, m);
  return __any_sync(kFullWarp, lane_enters<kAny>(r, b.lo, b.hi)) ? 2 : 1;
}

}  // namespace rt
