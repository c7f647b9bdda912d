// The no-grad forward of one wavefront level of a triangle scene, in two
// kernels for Hopper (sm_90a): level_hits_kernel, the hit attributes of the
// level's closest hits, and level_shade_kernel, the level's colour and its
// child rays. The shadow query runs between the two: it needs the hit
// positions, and the colour needs its answer. Beside them, raygen_kernel makes
// the wavefront's first level, the tile-major primary rays of a pixel tile.
//
// Replaces no TPU kernel: the JAX package leaves these steps to XLA
// (realtrace_tpu/ops/intersect.py::hit_attributes and the shading of
// realtrace_tpu/render/shade.py). They were added because the PyTorch code
// launched about 116 small elementwise kernels a level for the hits and 155
// for the shading, and the host's time to launch them, not the card's time to
// run them, set the frame time. The PyTorch code stays: it is the twin and
// the autograd path. ops/level_kernels.py says when these kernels run.
//
// level_hits_kernel computes ops/intersect.py::hit_attributes for a scene of
// triangles alone with the sweep's sorted-space indices. level_shade_kernel
// computes render/shade.py::_shade_level given the hits: _children_geom (the
// reflect child and, in a scene with dielectrics, the refract child with
// the Fresnel-Schlick split, the exit-side Beer factor and the rules of total
// internal reflection; a child with no energy parked) and _local_contrib
// (Phong over the lights as light_shade, ambient, the shadow blend, the
// background of active misses), or on the last level the background the
// children's coefficients take.
//
// What bounds them on the H100: memory, and barely. One thread a lane; the
// hits kernel reads 40 bytes of rays and query results and gathers one
// 96-byte triangle row (from L2: the tables are under 1 MB at 10k
// triangles), and writes 73 bytes; the shading kernel reads 77 bytes and
// writes 48 (84 when the level branches). At bob-close's widest level (1.82M
// lanes) that is about 0.4 GB, 0.13 ms at 3.35 TB/s. The arithmetic, about
// 100 operations a lane, one powf a light and on glass two powf and three
// expf, is far below the FP32 rate.
//
// Rounding, as the PyTorch code computes on the card, bit for bit: each of
// its elementwise operations is one correctly rounded step, so here every
// product, sum, difference and quotient is an explicitly rounded __fmul_rn,
// __fadd_rn, __fsub_rn or __fdiv_rn, in the twin's order (no FMA is
// contracted); sqrt is __fsqrt_rn; pow and exp are libdevice's powf and expf,
// which torch.pow(x, e) and torch.exp call for float32 (pow(x, 2) and
// pow(x, 3) are products there, and here). torch.sum(a * b, dim=-1) over a
// last dimension of 3 adds as PyTorch's CUDA reduction does, (p0 + p2) + p1
// with two threads an output, and a sum over the lights with four
// accumulators a thread (dot3 and light_sum below); both start from +0.0, so
// a result of -0.0 comes out +0.0.
//
// raygen_kernel computes render/pipeline.py::_tiled_rays_reference: the
// camera's basis and focal length (render/camera.py::Camera.basis, _focal),
// then each slot's pixel and ray direction (Camera.ray_directions_at) in the
// same rounded steps. It replaces no TPU kernel (the JAX package leaves ray
// generation to XLA); it was added because the PyTorch code built the
// tile-major pixel maps on the host and uploaded 35 MB of them from pageable
// memory every 1080p frame, behind ~100 small launches. A slot's pixel is
// integer arithmetic on its index, so the kernel reads nothing but the
// camera's ten numbers. Bound: the writes, 28 bytes a slot (rd, ro and
// coeff), 58.5 MB at 1080p, 0.017 ms at 3.35 TB/s; each thread recomputes
// the basis, ~100 operations and one tanf, far below the FP32 rate. A division
// by a Python number is, as PyTorch's CUDA div does it, a product with the
// number's float reciprocal; `1.0 / x` is PyTorch's reciprocal, a true
// division.
//
// The launches allocate nothing, run on the caller's stream and return
// cudaGetLastError(), so a refused launch is reported.

#include "sweep_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kFewRows = 8;        // ops/intersect.py::FEW_ROWS
constexpr int kColumns = 25;       // the hit table: vertices 9, colours 9, materials 6, index 1
constexpr int kMaxLights = 8;      // ops/level_kernels.py::MAX_LIGHTS
constexpr long long kFamNone = 0;  // ops/intersect.py's family codes
constexpr long long kFamTri = 1;
constexpr int kTileSide = 32;      // render/pipeline.py: a wavefront tile is 32x32 pixels
constexpr int kTileRays = kTileSide * kTileSide;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float quo(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp(x, min=lo): a NaN stays
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* __restrict__ p, size_t i) {
  return {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}

__device__ __forceinline__ void store3(float* __restrict__ p, size_t i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

__device__ __forceinline__ float at(V3 v, int c) { return c == 0 ? v.x : (c == 1 ? v.y : v.z); }

__device__ __forceinline__ V3 sub3(V3 a, V3 b) { return {sub(a.x, b.x), sub(a.y, b.y), sub(a.z, b.z)}; }

__device__ __forceinline__ V3 neg3(V3 a) { return {-a.x, -a.y, -a.z}; }

__device__ __forceinline__ V3 scale3(V3 a, float s) { return {mul(a.x, s), mul(a.y, s), mul(a.z, s)}; }

__device__ __forceinline__ V3 select3(bool c, V3 a, V3 b) { return c ? a : b; }

// core/vec.py::dot, torch.sum(a * b, dim=-1)
__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return add(add(add(mul(a.x, b.x), mul(a.z, b.z)), mul(a.y, b.y)), 0.0f);
}

// core/vec.py::normalize: a * (1 / sqrt(|a|^2)), zero where |a|^2 is not above 0
__device__ __forceinline__ V3 normalize(V3 a) {
  const float n2 = dot3(a, a);
  return scale3(a, n2 > 0.0f ? quo(1.0f, __fsqrt_rn(n2)) : 0.0f);
}

// core/vec.py::reflect: i - 2 (n . i) n
__device__ __forceinline__ V3 reflect(V3 i, V3 n) {
  const float d2 = mul(2.0f, dot3(n, i));
  return sub3(i, scale3(n, d2));
}

// core/vec.py::refract: eta i - (eta (n . i) + sqrt(k)) n, zero and not ok where k < 0
__device__ __forceinline__ V3 refract(V3 i, V3 n, float eta, bool& ok) {
  const float ndi = dot3(n, i);
  const float k = sub(1.0f, mul(mul(eta, eta), sub(1.0f, mul(ndi, ndi))));
  ok = k >= 0.0f;
  const float sq = k > 0.0f ? __fsqrt_rn(k) : 0.0f;
  const V3 t = sub3(scale3(i, eta), scale3(n, add(mul(eta, ndi), sq)));
  return select3(ok, t, V3{0.0f, 0.0f, 0.0f});
}

// torch.pow(base, e) for an exponent e >= 0 given as a Python int
__device__ __forceinline__ float pow_int(float base, int e) {
  if (e == 0) return 1.0f;
  if (e == 1) return base;
  if (e == 2) return mul(base, base);
  if (e == 3) return mul(mul(base, base), base);
  return powf(base, static_cast<float>(e));
}

// render/shade.py::phong_pow
__device__ __forceinline__ float phong_pow(float d, int e) {
  return pow_int(e % 2 == 0 ? fabsf(d) : clamp_min(d, 0.0f), e);
}

// torch.sum(x, dim=1) over the lights: a thread's four accumulators take
// lights j, j + 4 in turn, then add up in order
__device__ __forceinline__ float light_sum(const float* x, int n) {
  float acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j] = j < n ? x[j] : 0.0f;
#pragma unroll
  for (int l = 4; l < kMaxLights; ++l)
    if (l < n) acc[l & 3] = add(acc[l & 3], x[l]);
  return add(add(add(add(acc[0], acc[1]), acc[2]), acc[3]), 0.0f);
}

// a column of the hit table's row of original triangle `row`
__device__ __forceinline__ float column(const float* __restrict__ tv, const float* __restrict__ tc,
                                        const float* const* mats, long long row, int q) {
  if (q < 9) return tv[9 * row + q];
  if (q < 18) return tc[9 * row + q - 9];
  return mats[q - 18][row];
}

struct Materials {
  const float* k[6];  // ka kd ks kr kt eta, one value a triangle
};

__global__ void __launch_bounds__(kThreads)
level_hits_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                  const long long* __restrict__ fam, const long long* __restrict__ idx,
                  const long long* __restrict__ perm, int n_perm, const float* __restrict__ tv,
                  const float* __restrict__ tc, const Materials mats, float* __restrict__ out,
                  long long* __restrict__ out_index, bool* __restrict__ out_valid, int n) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= n) return;
  const size_t i = lane, r = n;
  const long long f = fam[i];
  const bool valid = f != kFamNone;
  const bool m = valid && f == kFamTri;
  const V3 o = load3(ro, i), d = load3(rd, i);
  float t = rt::kBig;
  V3 nrm{0.0f, 0.0f, 0.0f}, col{0.0f, 0.0f, 0.0f};
  float mat[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  long long index = valid ? idx[i] : -1;
  if (m) {
    // the row of the permuted table at the sorted-space index: a gather, or
    // for a table of at most kFewRows rows the sum of the rows each masked by
    // whether it is the lane's (intersect.py::_rows), in the same order
    const long long j = idx[i];
    float g[kColumns];
    if (n_perm > kFewRows) {
      const long long row = perm[j];
#pragma unroll
      for (int q = 0; q < kColumns - 1; ++q) g[q] = column(tv, tc, mats.k, row, q);
      g[kColumns - 1] = __ll2float_rn(row);
    } else {
#pragma unroll
      for (int q = 0; q < kColumns; ++q) {
        float acc = 0.0f;
        for (int k = 0; k < n_perm; ++k) {
          const long long row = perm[k];
          const float x = q < kColumns - 1 ? column(tv, tc, mats.k, row, q) : __ll2float_rn(row);
          const float term = mul(j == k ? 1.0f : 0.0f, x);
          acc = k == 0 ? term : add(acc, term);
        }
        g[q] = acc;
      }
    }
    index = static_cast<long long>(g[kColumns - 1]);
    const float ax = g[0], ay = g[1], az = g[2], bx = g[3], by = g[4], bz = g[5];
    const float cx = g[6], cy = g[7], cz = g[8];
    const float e1x = sub(ax, bx), e1y = sub(ay, by), e1z = sub(az, bz);
    const float e2x = sub(ax, cx), e2y = sub(ay, cy), e2z = sub(az, cz);
    const float nx = sub(mul(e1y, e2z), mul(e1z, e2y));
    const float ny = sub(mul(e1z, e2x), mul(e1x, e2z));
    const float nz = sub(mul(e1x, e2y), mul(e1y, e2x));
    const float det = add(add(mul(d.x, nx), mul(d.y, ny)), mul(d.z, nz));
    const float det_safe = fabsf(det) > 0.0f ? det : 1.0f;
    const float sx = sub(ax, o.x), sy = sub(ay, o.y), sz = sub(az, o.z);
    t = quo(add(add(mul(sx, nx), mul(sy, ny)), mul(sz, nz)), det_safe);
    const float beta = quo(add(add(mul(d.x, sub(mul(sy, e2z), mul(sz, e2y))),
                                   mul(d.y, sub(mul(sz, e2x), mul(sx, e2z)))),
                               mul(d.z, sub(mul(sx, e2y), mul(sy, e2x)))),
                           det_safe);
    const float gamma = quo(add(add(mul(d.x, sub(mul(e1y, sz), mul(e1z, sy))),
                                    mul(d.y, sub(mul(e1z, sx), mul(e1x, sz)))),
                                mul(d.z, sub(mul(e1x, sy), mul(e1y, sx)))),
                            det_safe);
    const float alpha = sub(sub(1.0f, beta), gamma);
    col = {add(add(mul(alpha, g[9]), mul(beta, g[12])), mul(gamma, g[15])),
           add(add(mul(alpha, g[10]), mul(beta, g[13])), mul(gamma, g[16])),
           add(add(mul(alpha, g[11]), mul(beta, g[14])), mul(gamma, g[17]))};
    nrm = {nx, ny, nz};
#pragma unroll
    for (int k = 0; k < 6; ++k) mat[k] = g[18 + k];
  }
  // a hit of another family (none in a scene of triangles alone) keeps BIG
  const V3 pos = valid ? V3{add(o.x, mul(t, d.x)), add(o.y, mul(t, d.y)), add(o.z, mul(t, d.z))}
                       : V3{0.0f, 0.0f, 0.0f};
  out[i] = t;
  store3(out + r, i, pos);
  store3(out + 4 * r, i, nrm);
  store3(out + 7 * r, i, col);
#pragma unroll
  for (int k = 0; k < 6; ++k) out[(10 + k) * r + i] = mat[k];
  out_index[i] = index;
  out_valid[i] = valid;
}

struct ShadeArgs {
  const float *ro, *rd, *coeff;
  const bool* valid;
  const float *t, *pos, *nrm, *col, *ka, *kd, *ks, *kr, *kt, *eta;
  const bool* occ;  // null: no shadow blend
  const float *lp, *li;
  int n_lights;
  const float *ambient, *background;
  int phong_exp, legacy_diffuse, miss_background, last;
  float blend, keep, ray_offset;
  float neg_sigma[3];
  float* contrib;
  float* child;  // last level: (C, 3) backgrounds; else ro, rd, coeff blocks of (C, 3)
  int n;
};

__device__ __forceinline__ bool any_positive(V3 c) {
  return c.x > 0.0f || c.y > 0.0f || c.z > 0.0f;
}

// one child: parked where it carries no energy (shade.py::_park_dead), or
// on the last level the background its coefficient takes
__device__ __forceinline__ void store_child(const ShadeArgs& a, size_t c_rows, size_t row, V3 ro,
                                            V3 rd, V3 coeff) {
  if (a.last) {
    store3(a.child, row, V3{mul(coeff.x, a.background[0]), mul(coeff.y, a.background[1]),
                            mul(coeff.z, a.background[2])});
    return;
  }
  const bool live = any_positive(coeff);
  store3(a.child, row, live ? ro : V3{rt::kPark, rt::kPark, rt::kPark});
  store3(a.child + 3 * c_rows, row, live ? rd : V3{1.0f, 0.0f, 0.0f});
  store3(a.child + 6 * c_rows, row, coeff);
}

template <bool kBranching>
__global__ void __launch_bounds__(kThreads) level_shade_kernel(const ShadeArgs a) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= a.n) return;
  const size_t i = lane, r = a.n;
  const V3 d = load3(a.rd, i), cf = load3(a.coeff, i);
  const bool hit_valid = a.valid[i];
  const V3 pos = load3(a.pos, i), col = load3(a.col, i);
  const float kr = a.kr[i], kt = a.kt[i];

  // _children_geom
  const bool active = any_positive(cf);
  const bool valid = hit_valid && active;
  const V3 iv = normalize(d);
  const V3 n = normalize(load3(a.nrm, i));
  const bool is_diel = valid && kr > 0.0f && kt > 0.0f;
  const bool is_refl = valid && kr > 0.0f && !is_diel;
  const V3 r_dir = reflect(iv, n);
  const V3 ro_r = V3{add(pos.x, mul(a.ray_offset, r_dir.x)), add(pos.y, mul(a.ray_offset, r_dir.y)),
                     add(pos.z, mul(a.ray_offset, r_dir.z))};
  const V3 rd_r = normalize(r_dir);
  if constexpr (!kBranching) {
    store_child(a, r, i, ro_r, rd_r, scale3(cf, is_refl ? kr : 0.0f));
  } else {
    const float eta = a.eta[i], t = a.t[i];
    const bool entering = dot3(d, n) < 0.0f;
    bool ok_in, ok_out;
    const V3 t_in = refract(iv, n, eta, ok_in);
    const float c_in = -dot3(iv, n);
    const V3 t_out = refract(iv, neg3(n), quo(1.0f, eta != 0.0f ? eta : 1.0f), ok_out);
    const float c_out = dot3(t_out, n);
    V3 k{1.0f, 1.0f, 1.0f};
    if (!entering)   // Beer attenuation on exit
      k = {expf(mul(t, a.neg_sigma[0])), expf(mul(t, a.neg_sigma[1])),
           expf(mul(t, a.neg_sigma[2]))};
    const bool tir_exit = !entering && !ok_out;
    const float c = entering ? c_in : c_out;
    const float em1 = sub(eta, 1.0f), ep1 = add(eta, 1.0f);
    const float r0 = quo(mul(em1, em1), clamp_min(mul(ep1, ep1), 1e-30f));
    const float fres = add(r0, mul(sub(1.0f, r0), powf(sub(1.0f, c), 5.0f)));
    const V3 t_dir = entering ? t_in : t_out;
    const bool t_ok = entering ? ok_in : ok_out;
    const V3 ro_t = V3{add(pos.x, mul(a.ray_offset, t_dir.x)),
                       add(pos.y, mul(a.ray_offset, t_dir.y)),
                       add(pos.z, mul(a.ray_offset, t_dir.z))};
    const float w = is_diel ? (tir_exit ? 1.0f : fres) : (is_refl ? kr : 0.0f);
    const V3 kw = is_diel ? k : V3{1.0f, 1.0f, 1.0f};
    const V3 coeff_r{mul(mul(cf.x, w), kw.x), mul(mul(cf.y, w), kw.y), mul(mul(cf.z, w), kw.z)};
    const bool refracts = is_diel && t_ok && !tir_exit;
    const float tf = sub(1.0f, fres);
    const V3 coeff_t{mul(cf.x, refracts ? mul(k.x, tf) : 0.0f),
                     mul(cf.y, refracts ? mul(k.y, tf) : 0.0f),
                     mul(cf.z, refracts ? mul(k.z, tf) : 0.0f)};
    store_child(a, 2 * r, i, ro_r, rd_r, coeff_r);
    store_child(a, 2 * r, r + i, ro_t, normalize(t_dir), coeff_t);
  }

  // _local_contrib: light_shade, then ambient and the shadow blend
  const float kd = a.kd[i], ks = a.ks[i], ka = a.ka[i];
  float per_light[3][kMaxLights] = {};
  for (int l = 0; l < a.n_lights; ++l) {
    const V3 lp = load3(a.lp, l), li = load3(a.li, l);
    const V3 l_dir = normalize(sub3(lp, pos));
    const V3 refl = normalize(reflect(neg3(l_dir), n));
    const float diffuse = clamp_min(dot3(n, a.legacy_diffuse ? normalize(lp) : l_dir), 0.0f);
    const float spec = phong_pow(dot3(iv, refl), a.phong_exp);
    const float kdd = mul(kd, diffuse), kss = mul(ks, spec);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      per_light[c][l] = add(mul(mul(kdd, at(li, c)), at(col, c)), mul(kss, at(li, c)));
  }
  const bool shadowed = a.occ != nullptr && a.occ[i];
  const bool shade = valid && !is_diel;
  const bool background = a.miss_background && active && !hit_valid;
  float out[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float amb = mul(mul(a.ambient[c], at(col, c)), ka);
    float lc = add(light_sum(per_light[c], a.n_lights), amb);
    if (shadowed) lc = add(mul(lc, a.blend), mul(amb, a.keep));
    out[c] = shade ? mul(at(cf, c), lc) : 0.0f;
    if (a.miss_background) out[c] = add(out[c], background ? mul(at(cf, c), a.background[c]) : 0.0f);
  }
  store3(a.contrib, i, V3{out[0], out[1], out[2]});
}

// core/vec.py::cross, written out per component
__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
  return {sub(mul(a.y, b.z), mul(a.z, b.y)), sub(mul(a.z, b.x), mul(a.x, b.z)),
          sub(mul(a.x, b.y), mul(a.y, b.x))};
}

struct RaygenArgs {
  const float *position, *target, *up, *fovy;  // the camera: (3,), (3,), (3,), ()
  int width, height;                           // the camera's frame
  float aspect, half_w, half_h, deg;           // width / height, width / 2, height / 2, pi / 180
  int i0, j0, tile_w, tile_h, tiles_x;         // the pixel tile; 32x32 tiles in a padded row
  float park;                                  // core/types.py::PARK_DISTANCE
  float *ro, *rd, *coeff;                      // (n, 3), (n, 3), (n,); ro, coeff null: no pads
  int n;
};

__global__ void __launch_bounds__(kThreads) raygen_kernel(const RaygenArgs a) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= a.n) return;
  const int tile = s / kTileRays, in = s % kTileRays;
  const int ci = tile % a.tiles_x * kTileSide + in % kTileSide;   // column in the tile
  const int cj = tile / a.tiles_x * kTileSide + in / kTileSide;   // row from the bottom
  if (ci >= a.tile_w || cj >= a.tile_h) {                         // a pad slot, parked
    store3(a.ro, s, V3{a.park, a.park, a.park});
    store3(a.rd, s, V3{1.0f, 0.0f, 0.0f});
    a.coeff[s] = 0.0f;
    return;
  }
  const V3 pos = load3(a.position, 0);
  const V3 up = normalize(load3(a.up, 0));
  const V3 w = normalize(sub3(pos, load3(a.target, 0)));
  const V3 u = normalize(cross3(up, w));
  const V3 v = normalize(cross3(w, u));
  const float focal = quo(1.0f, mul(2.0f, tanf(mul(mul(*a.fovy, a.deg), 0.5f))));
  const float xw = mul(mul(add(sub(static_cast<float>(ci + a.i0), a.half_w), 0.5f), a.aspect),
                       quo(1.0f, static_cast<float>(a.width)));
  const float yw = mul(add(sub(static_cast<float>(cj + a.j0), a.half_h), 0.5f),
                       quo(1.0f, static_cast<float>(a.height)));
  const V3 fw = scale3(neg3(w), focal);
  const V3 d{add(add(fw.x, mul(u.x, xw)), mul(v.x, yw)), add(add(fw.y, mul(u.y, xw)), mul(v.y, yw)),
             add(add(fw.z, mul(u.z, xw)), mul(v.z, yw))};
  store3(a.rd, s, normalize(d));
  if (a.ro != nullptr) {
    store3(a.ro, s, pos);
    a.coeff[s] = 1.0f;
  }
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// ro, rd: (n, 3); fam, idx: (n,) int64; perm: (n_perm,) int64; tv, tc: (N, 3, 3);
// ka .. eta: (N,). out: 16 * n floats (t, position, normal, colour,
// the six materials, each block lane-major); out_index: (n,) int64; out_valid: (n,).
extern "C" int rt_level_hits(const float* ro, const float* rd, const long long* fam,
                             const long long* idx, const long long* perm, int n_perm,
                             const float* tv, const float* tc, const float* ka, const float* kd,
                             const float* ks, const float* kr, const float* kt, const float* eta,
                             float* out, long long* out_index, bool* out_valid, int n, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  const Materials mats{{ka, kd, ks, kr, kt, eta}};
  level_hits_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ro, rd, fam, idx, perm, n_perm, tv, tc, mats, out, out_index, out_valid, n);
  return static_cast<int>(cudaGetLastError());
}

// ro, rd, coeff: (n, 3); the hit's valid (n,), t (n,), position, normal,
// colour (n, 3), ka .. eta (n,); occ: (n,) or null; lp, li: (n_lights, 3);
// ambient, background: (3,). contrib: (n, 3); child: with C = 2n where the
// level branches, else n, on the last level (C, 3) backgrounds, else the
// children's ro, rd and coeff, each (C, 3), one after the other.
extern "C" int rt_level_shade(const float* ro, const float* rd, const float* coeff,
                              const bool* valid, const float* t, const float* pos,
                              const float* nrm, const float* col, const float* ka,
                              const float* kd, const float* ks, const float* kr, const float* kt,
                              const float* eta, const bool* occ, const float* lp, const float* li,
                              int n_lights, const float* ambient, const float* background,
                              int phong_exp, int legacy_diffuse, float blend, float keep,
                              float ray_offset, float neg_sigma_r, float neg_sigma_g,
                              float neg_sigma_b, int branching, int miss_background, int last,
                              float* contrib, float* child, int n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_lights < 0 || n_lights > kMaxLights || phong_exp < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const ShadeArgs a{ro, rd, coeff, valid, t, pos, nrm, col, ka, kd, ks, kr, kt, eta, occ, lp, li,
                    n_lights, ambient, background, phong_exp, legacy_diffuse, miss_background,
                    last, blend, keep, ray_offset, {neg_sigma_r, neg_sigma_g, neg_sigma_b},
                    contrib, child, n};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (branching)
    level_shade_kernel<true><<<blocks(n), kThreads, 0, s>>>(a);
  else
    level_shade_kernel<false><<<blocks(n), kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The tile-major rays of the pixel tile [i0, i0 + tile_w) x [j0, j0 + tile_h)
// of a width x height camera (position, target, up: (3,); fovy: ()): rd (n, 3)
// and, where the tile leaves pad slots (ro, coeff not null), ro (n, 3) and
// coeff (n,). n = the padded tile's slots, tiles_x * 32 columns wide.
extern "C" int rt_raygen(const float* position, const float* target, const float* up,
                         const float* fovy, int width, int height, float aspect, float half_w,
                         float half_h, float deg, int i0, int j0, int tile_w, int tile_h,
                         int tiles_x, float park, float* ro, float* rd, float* coeff, int n,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  if (tiles_x <= 0 || n % (tiles_x * kTileRays) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int wp = tiles_x * kTileSide, hp = n / wp;
  const bool pads = tile_w < wp || tile_h < hp;
  if (tile_w > wp || tile_h > hp || (ro != nullptr) != pads || (coeff != nullptr) != pads)
    return static_cast<int>(cudaErrorInvalidValue);
  const RaygenArgs a{position, target, up, fovy, width, height, aspect, half_w, half_h, deg,
                     i0, j0, tile_w, tile_h, tiles_x, park, ro, rd, coeff, n};
  raygen_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
