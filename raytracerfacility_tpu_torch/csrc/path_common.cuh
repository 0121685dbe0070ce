// Per-ray trace and Default-material shade shared by the two path kernels
// in path.cu (one thread per ray).
//
// Ports the math of raytracerfacility_tpu/ops/pallas_seg.py:254 _kernel
// and raytracerfacility_tpu/ops/pallas_fused.py:217 _kernel (Scene
// lighting): closest hit over the Morton-packed 20-column table with
// chunk and 16-row sub-run box culling, then the shade step of
// pallas_seg.py:506-638.
//
// Numerics. Build with -fmad=false: contracting a*b+c into an FMA changes
// the rounding of det, u, v and t and flips grazing accepts against the
// plain PyTorch versions and the JAX reference, which round every multiply
// and add. No fast-math intrinsics: 1.0f / sqrtf(x) where the reference
// has rsqrt (rsqrtf is approximate), accurate sinf/cosf, IEEE division.
// The reciprocal forms of the reference are kept: 1 / (ok_det ? det : 1)
// and the inverse direction with its +-1e-20 clamp. The LCG runs in
// uint32_t, the same bits as the reference's int32 with wraparound.
#pragma once

#include <cstdint>

namespace rtf {

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

// Ray/box slab test; <= so a tie candidate on a box boundary is visited.
__device__ __forceinline__ bool slab(const float* b, const Path& p, float ivx,
                                     float ivy, float ivz, float tmin,
                                     float bt) {
  const float t1x = (b[0] - p.ox) * ivx;
  const float t2x = (b[3] - p.ox) * ivx;
  const float t1y = (b[1] - p.oy) * ivy;
  const float t2y = (b[4] - p.oy) * ivy;
  const float t1z = (b[2] - p.oz) * ivz;
  const float t2z = (b[5] - p.oz) * ivz;
  const float near = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                           fminf(t1z, t2z));
  const float far = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                          fmaxf(t1z, t2z));
  return near <= far && far > tmin && near <= bt;
}

// Closest hit. Ties in t go to the lowest original primitive id, which
// makes the result the lexicographic (t, id) min in any visit order.
__device__ __forceinline__ void trace(const Scene& s, const Path& p, float tmin,
                                      Hit& h) {
  h.t = kTMax;
  h.nx = h.ny = h.nz = 0.0f;
  h.mid = 0.0f;
  h.pid = kNoId;
  const float ivx = inv_dir(p.dx), ivy = inv_dir(p.dy), ivz = inv_dir(p.dz);
  const int runs = s.chunk / s.sub;
  for (int c = 0; c < s.nchunks; ++c) {
    if (!slab(s.chunks + c * kBox, p, ivx, ivy, ivz, tmin, h.t)) continue;
    for (int r = c * runs; r < (c + 1) * runs; ++r) {
      if (!slab(s.subs + r * kBox, p, ivx, ivy, ivz, tmin, h.t)) continue;
      const float* tri = s.tris + (size_t)r * s.sub * kCols;
      for (int k = 0; k < s.sub; ++k, tri += kCols) {
        const float e1x = tri[3], e1y = tri[4], e1z = tri[5];
        const float e2x = tri[6], e2y = tri[7], e2z = tri[8];
        const float pvx = p.dy * e2z - p.dz * e2y;
        const float pvy = p.dz * e2x - p.dx * e2z;
        const float pvz = p.dx * e2y - p.dy * e2x;
        const float det = e1x * pvx + e1y * pvy + e1z * pvz;
        const bool ok_det = fabsf(det) > kDetEps;
        const float inv_det = 1.0f / (ok_det ? det : 1.0f);
        const float tvx = p.ox - tri[0];
        const float tvy = p.oy - tri[1];
        const float tvz = p.oz - tri[2];
        const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
        const float qvx = tvy * e1z - tvz * e1y;
        const float qvy = tvz * e1x - tvx * e1z;
        const float qvz = tvx * e1y - tvy * e1x;
        const float v = (p.dx * qvx + p.dy * qvy + p.dz * qvz) * inv_det;
        const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
        const float jf = tri[9];
        if (ok_det && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > tmin &&
            (t < h.t || (t == h.t && jf < h.pid))) {
          h.t = t;
          h.nx = tri[10] + u * tri[13] + v * tri[16];
          h.ny = tri[11] + u * tri[14] + v * tri[17];
          h.nz = tri[12] + u * tri[15] + v * tri[18];
          h.mid = tri[19];
          h.pid = jf;
        }
      }
    }
  }
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

// Shade one live ray after its trace (ref pallas_seg.py:506-638). On a
// miss the flat environment radiance is added and the path ends. On a hit:
// emission, first-hit AOVs when `first`, and, when `has_cont`, a BRDF cone
// sample around the reflected direction with the energy weight.
__device__ __forceinline__ void shade(const Scene& s, const float* env,
                                      Path& p, const Hit& h, bool first,
                                      bool has_cont, Aov& aov) {
  if (!(h.t < kHitMax)) {
    // miss: flat Scene environment (ref Environment.cuh:158-162)
    p.rr = p.rr + p.tr * env[0];
    p.rg = p.rg + p.tg * env[1];
    p.rb = p.rb + p.tb * env[2];
    if (first) no_hit_aov(aov, env[0], env[1], env[2]);
    p.act = 0.0f;
    return;
  }
  const float* m = s.mats + (int)h.mid * kMat;
  const float ar = m[0], ag = m[1], ab = m[2], ro = m[3], me = m[4], em = m[5];

  // normalize + flip the interpolated normal (ref RayDataDefinations.hpp:364-382)
  const float inv =
      1.0f / sqrtf(fmaxf(h.nx * h.nx + h.ny * h.ny + h.nz * h.nz, 1e-20f));
  float nx = h.nx * inv, ny = h.ny * inv, nz = h.nz * inv;
  if (p.dx * nx + p.dy * ny + p.dz * nz > 0.0f) {
    nx = -nx;
    ny = -ny;
    nz = -nz;
  }
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
  // (ref BSDF.cuh:6-13; draw order cos_theta then phi)
  const float dpf = p.dx * nx + p.dy * ny + p.dz * nz;
  const float rx = p.dx - 2.0f * dpf * nx;
  const float ry = p.dy - 2.0f * dpf * ny;
  const float rz = p.dz - 2.0f * dpf * nz;
  float u_cos, u_phi;
  uint32_t rng = lcg(p.rng, u_cos);
  rng = lcg(rng, u_phi);
  const float one_minus = 1.0f - me;
  const float cos_t = 1.0f - u_cos * one_minus * one_minus;
  const float sin_t = sqrtf(fmaxf(0.0f, 1.0f - cos_t * cos_t));
  const float phi = kTwoPi * u_phi;
  const float lx = cosf(phi) * sin_t;
  const float ly = sinf(phi) * sin_t;
  const float lz = cos_t;
  // tangent frame around the reflected dir (RayTracerUtilities.cuh:110-120)
  const bool use_z = fabsf(rx) > 0.99f;
  const float hx_ = use_z ? 0.0f : 1.0f;
  const float hz_ = use_z ? 1.0f : 0.0f;
  float tx = ry * hz_;
  float ty = rz * hx_ - rx * hz_;
  float tz = -ry * hx_;
  const float tinv = 1.0f / sqrtf(fmaxf(tx * tx + ty * ty + tz * tz, 1e-20f));
  tx = tx * tinv;
  ty = ty * tinv;
  tz = tz * tinv;
  float bx = ry * tz - rz * ty;
  float by = rz * tx - rx * tz;
  float bz = rx * ty - ry * tx;
  const float binv = 1.0f / sqrtf(fmaxf(bx * bx + by * by + bz * bz, 1e-20f));
  bx = bx * binv;
  by = by * binv;
  bz = bz * binv;
  const float ndx = tx * lx + bx * ly + rx * lz;
  const float ndy = ty * lx + by * ly + ry * lz;
  const float ndz = tz * lx + bz * ly + rz * lz;

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

}  // namespace rtf
