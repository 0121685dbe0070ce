// The ray-primitive tests and the Default-material shade of the three path
// kernels in path.cu, which trace with sweep.cuh; the inverse direction,
// Moller-Trumbore and the sphere-swept segment test are also K3's
// (brute.cu), K4's (inst.cu) and K5's (bvh.cu).
//
// Ports the math of raytracerfacility_tpu/ops/pallas_seg.py:254 _kernel
// and raytracerfacility_tpu/ops/pallas_fused.py:217 _kernel: the
// triangle test of the Morton-packed 20-column table, the shade step of
// pallas_seg.py:506-638 and the SingleLightSource shade of
// pallas_fused.py:424-639 around its shadow ray.
//
// Numerics. Build with -fmad=false: contracting a*b+c into an FMA changes
// the rounding of det, u, v and t and flips grazing accepts against the
// plain PyTorch versions and the JAX reference, which round every multiply
// and add. No fast-math intrinsics: 1.0f / sqrtf(x) where the reference
// has rsqrt (rsqrtf is approximate), IEEE division.
// The reciprocal forms of the reference are kept: 1 / (ok_det ? det : 1)
// and the inverse direction with its +-1e-20 clamp. cos and sin of the
// sample angle are taken in double and rounded to float, as the plain
// versions take them. The LCG runs in uint32_t, the same bits as the
// reference's int32 with wraparound.
#pragma once

#include <cstdint>

namespace rtf {

constexpr int kThreads = 128;  // threads per block (kernels.py THREADS)
constexpr int kCols = 20;       // table row: v0 e1 e2 | orig id | n0 dn1 dn2 | mat
constexpr int kBox = 8;         // AABB row: lo xyz, hi xyz, 2 pad
constexpr int kMat = 8;         // material row: albedo rgb, rough, metal, emit
constexpr float kDetEps = 1e-12f;
constexpr float kTMax = 1e20f;
constexpr float kHitMax = 1e19f;  // best t below this is a real hit
constexpr float kBounceTMin = 1e-3f;
constexpr float kNoHit = 999999.0f;  // ref CameraRendering.cu:48
constexpr float kNoId = 3.4e38f;
constexpr float kTwoPi = 6.2831853071795864769f;

// Path-state planes, in the order of ops/fused.py (OX ... RB).
enum Plane { OX, OY, OZ, DX, DY, DZ, ACT, TR, TG, TB, RR, RG, RB, NPLANES };

struct Scene {
  const float* tris;    // (rows, kCols)
  const float* subs;    // (rows / sub, kBox)
  const float* chunks;  // (>= nchunks, kBox)
  const float* mats;    // (M_pad, kMat)
  int nchunks, chunk, sub;
};

struct Path {
  float ox, oy, oz, dx, dy, dz;
  uint32_t rng;
  float act, tr, tg, tb, rr, rg, rb;
};

struct Aov {
  float nx, ny, nz, ar, ag, ab, px, py, pz;
};

struct Hit {
  float t, nx, ny, nz, mid, pid;
};

__device__ __forceinline__ float inv_dir(float d) {
  const float eps = 1e-20f;
  return 1.0f / (fabsf(d) < eps ? (d < 0.0f ? -eps : eps) : d);
}

// |inv_dir| of a direction component it holds at 1e-20 (ops/math3d.py
// HELD_INV), and the slab bound that stands for "every t" (ops/math3d.py
// PARALLEL_BIG)
constexpr float kHeldInv = 1.0f / 1e-20f;
constexpr float kParallelBig = 3.0e38f;

// The slab of an axis the ray runs parallel to (its inverse held): the ray
// is in it for every t or for none. (b - o) * 1e20 would give a ray that
// lies on the box's upper face an exit at t = 0, and the box would be
// culled with the hit on that face (a LiDAR beam along -z through a
// sphere's pole); the slab is closed: (-big, big) inside or on a face,
// (big, big), which no window enters, outside.
__device__ __forceinline__ void parallel_slab(float lo, float hi, float o,
                                              float iv, float& t1, float& t2) {
  if (fabsf(iv) >= kHeldInv) {
    t1 = (lo <= o && o <= hi) ? -kParallelBig : kParallelBig;
    t2 = kParallelBig;
  }
}

// Whether a ray runs parallel to some axis (an inverse held).
__device__ __forceinline__ bool any_parallel(float ivx, float ivy, float ivz) {
  return fabsf(ivx) >= kHeldInv || fabsf(ivy) >= kHeldInv ||
         fabsf(ivz) >= kHeldInv;
}

// Moller-Trumbore of one ray against a row whose columns 0-8 are v0, e1,
// e2 (both table layouts). True when det, the barycentrics and tmin
// accept; t, u, v are set either way.
__device__ __forceinline__ bool tri_test(const float* tri, float ox, float oy,
                                         float oz, float dx, float dy, float dz,
                                         float tmin, float& t, float& u,
                                         float& v) {
  const float e1x = tri[3], e1y = tri[4], e1z = tri[5];
  const float e2x = tri[6], e2y = tri[7], e2z = tri[8];
  const float pvx = dy * e2z - dz * e2y;
  const float pvy = dz * e2x - dx * e2z;
  const float pvz = dx * e2y - dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const bool ok_det = fabsf(det) > kDetEps;
  const float inv_det = 1.0f / (ok_det ? det : 1.0f);
  const float tvx = ox - tri[0];
  const float tvy = oy - tri[1];
  const float tvz = oz - tri[2];
  u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  v = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
  t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
  return ok_det && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > tmin;
}

// Sphere-swept segment test of a row whose columns 0-7 are p0 = v0,
// axis = e1, r0 = e2.x, dr = e2.y, term for term ops/curve.py::
// intersect_round_cone (and pallas_brute.py:311-368) with no upper bound on
// t: the callers bound t by their best t or tmax. Shared by K3 and K5.
__device__ __forceinline__ bool curve_test(const float* row, float ox, float oy,
                                           float oz, float dx, float dy,
                                           float dz, float tmin, float& t,
                                           float& u) {
  const float e1x = row[3], e1y = row[4], e1z = row[5];
  const float r0 = row[6];
  const float dr = row[7];
  const float rr = -dr;
  const float oax = ox - row[0];
  const float oay = oy - row[1];
  const float oaz = oz - row[2];
  const float m0 = e1x * e1x + e1y * e1y + e1z * e1z;
  const float m1 = oax * e1x + oay * e1y + oaz * e1z;
  const float m2 = dx * e1x + dy * e1y + dz * e1z;
  const float m3 = dx * oax + dy * oay + dz * oaz;
  const float m5 = oax * oax + oay * oay + oaz * oaz;
  const float d2 = m0 - rr * rr;
  const float k2 = d2 - m2 * m2;
  const float k1 = d2 * m3 - m1 * m2 + m2 * rr * r0;
  const float k0 = d2 * m5 - m1 * m1 + 2.0f * m1 * rr * r0 - m0 * r0 * r0;
  const float h = k1 * k1 - k0 * k2;
  const bool k2_ok = fabsf(k2) > kDetEps;
  const float safe_k2 = k2_ok ? k2 : 1.0f;
  const float t_body = (-sqrtf(fmaxf(h, 0.0f)) - k1) / safe_k2;
  const float y = m1 - r0 * rr + t_body * m2;
  const bool body_ok = h >= 0.0f && k2_ok && y > 0.0f && y < d2 && t_body > tmin;
  // sphere cap at p0
  const float disc0 = m3 * m3 - m5 + r0 * r0;
  const float t_cap0 = -m3 - sqrtf(fmaxf(disc0, 0.0f));
  const float y0 = m1 - r0 * rr + t_cap0 * m2;
  const bool cap0_ok = disc0 >= 0.0f && y0 <= 0.0f && t_cap0 > tmin;
  // sphere cap at p1
  const float r1 = r0 + dr;
  const float obx = oax - e1x;
  const float oby = oay - e1y;
  const float obz = oaz - e1z;
  const float m3b = dx * obx + dy * oby + dz * obz;
  const float m5b = obx * obx + oby * oby + obz * obz;
  const float disc1 = m3b * m3b - m5b + r1 * r1;
  const float t_cap1 = -m3b - sqrtf(fmaxf(disc1, 0.0f));
  const float y1 = m1 - r0 * rr + t_cap1 * m2;
  const bool cap1_ok = disc1 >= 0.0f && y1 >= d2 && t_cap1 > tmin;
  const float big = 3.4e38f;
  const float tb = body_ok ? t_body : big;
  const float t0c = cap0_ok ? t_cap0 : big;
  const float t1c = cap1_ok ? t_cap1 : big;
  t = fminf(fminf(tb, t0c), t1c);
  const float safe_d2 = fabsf(d2) > kDetEps ? d2 : 1.0f;
  const float u_body =
      fminf(fmaxf((m1 - r0 * rr + t * m2) / safe_d2, 0.0f), 1.0f);
  u = t == t0c ? 0.0f : (t == t1c ? 1.0f : u_body);
  return body_ok || cap0_ok || cap1_ok;
}

__device__ __forceinline__ uint32_t lcg(uint32_t s, float& val) {
  s = s * 1664525u + 1013904223u;
  val = (float)(s & 0xFFFFFFu) * (1.0f / 16777216.0f);
  return s;
}

__device__ __forceinline__ void no_hit_aov(Aov& a, float ar, float ag,
                                           float ab) {
  a.nx = a.ny = a.nz = 0.0f;
  a.ar = ar;
  a.ag = ag;
  a.ab = ab;
  a.px = a.py = a.pz = kNoHit;
}

// The direction at cos(theta) = cos_t and phi = 2 pi u_phi around axis a,
// in the tangent frame of RayTracerUtilities.cuh:110-133
// (ops/math3d.py::sample_hemisphere after its two draws).
__device__ __forceinline__ void frame_direction(float ax, float ay, float az,
                                                float cos_t, float u_phi,
                                                float& dx, float& dy, float& dz) {
  const float sin_t = sqrtf(fmaxf(0.0f, 1.0f - cos_t * cos_t));
  // cos and sin in double, rounded: the same float on every device
  // (ops/math3d.py::cos_sin)
  const double phi = (double)(kTwoPi * u_phi);
  const float lx = (float)cos(phi) * sin_t;
  const float ly = (float)sin(phi) * sin_t;
  const float lz = cos_t;
  const bool use_z = fabsf(ax) > 0.99f;
  const float hx = use_z ? 0.0f : 1.0f;
  const float hz = use_z ? 1.0f : 0.0f;
  float tx = ay * hz;
  float ty = az * hx - ax * hz;
  float tz = -ay * hx;
  const float tinv = 1.0f / sqrtf(fmaxf(tx * tx + ty * ty + tz * tz, 1e-20f));
  tx = tx * tinv;
  ty = ty * tinv;
  tz = tz * tinv;
  float bx = ay * tz - az * ty;
  float by = az * tx - ax * tz;
  float bz = ax * ty - ay * tx;
  const float binv = 1.0f / sqrtf(fmaxf(bx * bx + by * by + bz * bz, 1e-20f));
  bx = bx * binv;
  by = by * binv;
  bz = bz * binv;
  dx = tx * lx + bx * ly + ax * lz;
  dy = ty * lx + by * ly + ay * lz;
  dz = tz * lx + bz * ly + az * lz;
}

// Direction in the cone of concentration alpha around axis a: two LCG
// draws, cos(theta) then phi (ops/math3d.py::sample_hemisphere with
// alpha). Returns the advanced RNG state.
__device__ __forceinline__ uint32_t cone_sample(uint32_t rng, float ax, float ay,
                                                float az, float alpha, float& dx,
                                                float& dy, float& dz) {
  float u_cos, u_phi;
  rng = lcg(rng, u_cos);
  rng = lcg(rng, u_phi);
  const float one_minus = 1.0f - alpha;
  frame_direction(ax, ay, az, 1.0f - u_cos * one_minus * one_minus, u_phi, dx,
                  dy, dz);
  return rng;
}

// Normalize the hit's interpolated normal and flip it toward the
// incoming ray (ref RayDataDefinations.hpp:364-382).
__device__ __forceinline__ void facing_normal(const Path& p, const Hit& h,
                                              float& nx, float& ny, float& nz) {
  const float inv =
      1.0f / sqrtf(fmaxf(h.nx * h.nx + h.ny * h.ny + h.nz * h.nz, 1e-20f));
  nx = h.nx * inv;
  ny = h.ny * inv;
  nz = h.nz * inv;
  if (p.dx * nx + p.dy * ny + p.dz * nz > 0.0f) {
    nx = -nx;
    ny = -ny;
    nz = -nz;
  }
}

// Shade one live ray after its trace (ref pallas_seg.py:506-638). On a
// miss the path ends: the flat environment radiance is added, or, with
// kMissPlane (the reference's xla_env form, pallas_seg.py:511-525 and
// :572-579), nothing is added and the first-hit albedo stays 0, for the
// caller to add a ray-dependent environment from its miss plane; the
// origin, direction and throughput are left as they were either way. On a
// hit: emission, first-hit AOVs when `first`, and, when `has_cont`, a BRDF
// cone sample around the reflected direction with the energy weight.
template <bool kMissPlane = false>
__device__ __forceinline__ void shade(const Scene& s, const float* env,
                                      Path& p, const Hit& h, bool first,
                                      bool has_cont, Aov& aov) {
  if (!(h.t < kHitMax)) {
    if (kMissPlane) {
      if (first) no_hit_aov(aov, 0.0f, 0.0f, 0.0f);
    } else {
      // flat Scene environment (ref Environment.cuh:158-162)
      p.rr = p.rr + p.tr * env[0];
      p.rg = p.rg + p.tg * env[1];
      p.rb = p.rb + p.tb * env[2];
      if (first) no_hit_aov(aov, env[0], env[1], env[2]);
    }
    p.act = 0.0f;
    return;
  }
  const float* m = s.mats + (int)h.mid * kMat;
  const float ar = m[0], ag = m[1], ab = m[2], ro = m[3], me = m[4], em = m[5];

  float nx, ny, nz;
  facing_normal(p, h, nx, ny, nz);
  // emission (ref RayFunctions.cuh:168-171)
  p.rr = p.rr + p.tr * em * ar;
  p.rg = p.rg + p.tg * em * ag;
  p.rb = p.rb + p.tb * em * ab;

  const float hx = p.ox + h.t * p.dx;
  const float hy = p.oy + h.t * p.dy;
  const float hz = p.oz + h.t * p.dz;
  if (first) {  // first-hit AOVs (ref RayFunctions.cuh:163-167)
    aov.nx = nx;
    aov.ny = ny;
    aov.nz = nz;
    aov.ar = ar;
    aov.ag = ag;
    aov.ab = ab;
    aov.px = hx;
    aov.py = hy;
    aov.pz = hz;
  }
  if (!has_cont) {  // last segment: the path ends at this hit
    p.act = 0.0f;
    return;
  }

  // BRDF cone sample around the reflection about the flipped normal
  // (ref BSDF.cuh:6-13)
  const float dpf = p.dx * nx + p.dy * ny + p.dz * nz;
  const float rx = p.dx - 2.0f * dpf * nx;
  const float ry = p.dy - 2.0f * dpf * ny;
  const float rz = p.dz - 2.0f * dpf * nz;
  float ndx, ndy, ndz;
  const uint32_t rng = cone_sample(p.rng, rx, ry, rz, me, ndx, ndy, ndz);

  // energy weight (ref RayFunctions.cuh:152-161)
  const float f = me >= 0.0f ? (me + 2.0f) / (me + 1.0f) : 1.0f;
  const float ndotl = fabsf(nx * ndx + ny * ndy + nz * ndz);
  const float w = fminf(fmaxf(ndotl * ro + (1.0f - ro) * f, 0.0f), 1.0f);

  p.tr = p.tr * ar * w;
  p.tg = p.tg * ag * w;
  p.tb = p.tb * ab * w;
  p.ox = hx;
  p.oy = hy;
  p.oz = hz;
  p.dx = ndx;
  p.dy = ndy;
  p.dz = ndz;
  p.rng = rng;
  p.act = 1.0f;
}

// SingleLightSource shade of a camera ray after its trace (ref
// pallas_fused.py:424-639, RayFunctions.cuh:61-92), in two parts around
// the shadow ray's any-hit sweep. The path ends either way.
//
// sls_begin: on a miss the flat colour and the no-hit AOVs; on a hit
// emission, ambient, the first-hit AOVs and one sun-cone sample (alpha =
// env[9] around env[6:9], the RNG advanced as the reference does). Returns
// whether the shadow ray is cast: a hit whose facing normal has N.L > 0 with
// the sample, from the hit point (aov.px, py, pz) along (sdx, sdy, sdz).
__device__ __forceinline__ bool sls_begin(const Scene& s, const float* env,
                                          Path& p, const Hit& h, Aov& aov,
                                          float& sdx, float& sdy, float& sdz,
                                          float& ndl) {
  p.act = 0.0f;
  if (!(h.t < kHitMax)) {
    p.rr = p.rr + p.tr * env[0];
    p.rg = p.rg + p.tg * env[1];
    p.rb = p.rb + p.tb * env[2];
    no_hit_aov(aov, env[0], env[1], env[2]);
    return false;
  }
  const float* m = s.mats + (int)h.mid * kMat;
  const float ar = m[0], ag = m[1], ab = m[2], em = m[5];
  float nx, ny, nz;
  facing_normal(p, h, nx, ny, nz);
  aov.nx = nx;
  aov.ny = ny;
  aov.nz = nz;
  aov.ar = ar;
  aov.ag = ag;
  aov.ab = ab;
  aov.px = p.ox + h.t * p.dx;
  aov.py = p.oy + h.t * p.dy;
  aov.pz = p.oz + h.t * p.dz;
  p.rng = cone_sample(p.rng, env[6], env[7], env[8], env[9], sdx, sdy, sdz);
  ndl = nx * sdx + ny * sdy + nz * sdz;
  p.rr = p.rr + p.tr * em * ar;  // emission
  p.rg = p.rg + p.tg * em * ag;
  p.rb = p.rb + p.tb * em * ab;
  p.rr = p.rr + p.tr * env[3] * ar;  // ambient
  p.rg = p.rg + p.tg * env[4] * ag;
  p.rb = p.rb + p.tb * env[5] * ab;
  return ndl > 0.0f;
}

// sls_sun: the sun's flat colour times N.L and the hit's albedo, added
// when the shadow ray found no occluder.
__device__ __forceinline__ void sls_sun(const float* env, Path& p,
                                        const Aov& aov, float ndl) {
  p.rr = p.rr + p.tr * env[0] * ndl * aov.ar;
  p.rg = p.rg + p.tg * env[1] * ndl * aov.ag;
  p.rb = p.rb + p.tb * env[2] * ndl * aov.ab;
}

}  // namespace rtf
