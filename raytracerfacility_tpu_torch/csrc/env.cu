// The miss-radiance kernel, with a plain C interface for ctypes
// (raytracerfacility_tpu_torch/kernels.py builds and loads it;
// ops/environment.py::miss_radiance launches it).
//
// miss_radiance_kernel replaces no TPU kernel. It stands for the XLA glue
// the reference runs between its segment launches (raytracerfacility_tpu/
// ops/pallas_seg.py:1035-1060 add_env): calculate_environmental_light with a
// cubemap (ops/texture.py:94 sample_cubemap) or the Nishita sky
// (ops/environment.py:143 nishita_sky), for every ray, then the misses
// selected. Written as tensor ops the sky materialises (rays, 16, 8, 3)
// intermediates; here one thread takes one ray and marches in registers.
//
// For each ray i < n whose miss flag is set: the light along its direction
// (the cubemap's bilinear fetch, or the sky from its origin), times
// skylight, through the inverse gamma; radiance += throughput * light, and
// out = light when `out` is given (the segment-0 albedo AOV). A ray whose
// flag is not set returns at once and touches nothing.
//
// Bound on this card: the sky by its operations (16 view samples of 8
// light samples each, 336 exponentials a ray), the cubemap by its bytes
// (four texels a ray, gathered). The operation order is that of the plain
// version (ops/environment.py: sums in sample order, no fused multiply-add
// under -fmad=false, IEEE division and sqrtf); the float64 pow is the
// plain version's pow64.

#include <cuda_runtime.h>

namespace rtf {

constexpr int kEnvThreads = 128;
constexpr int kModeCubemap = 1, kModeSky = 2;
// path-state planes read (ops/fused.py OX ... TB)
constexpr int kOX = 0, kDX = 3, kTR = 7;
// the parameter vector (ops/environment.py env_params)
enum Param {
  kSky, kInvGamma, kColorR, kColorG, kColorB, kSunX, kSunY, kSunZ,
  kEarthKm, kAtmosphereKm, kHr, kHm, kMieG, kBetaR0, kBetaR1, kBetaR2,
  kBetaM, kBetaMExt, kPhaseR, kPhaseM, kTFar, kExpClamp
};

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

// Both distances to a sphere of radius r at the origin (ops/environment.py
// _ray_sphere_both): t0 <= t1, valid when the discriminant is >= 0.
__device__ __forceinline__ bool ray_sphere_both(float ox, float oy, float oz,
                                                float dx, float dy, float dz,
                                                float r, float& t0, float& t1) {
  const float a = dot3(dx, dy, dz, dx, dy, dz);
  const float b = 2.0f * dot3(dx, dy, dz, ox, oy, oz);
  const float c = dot3(ox, oy, oz, ox, oy, oz) - r * r;
  const float discr = b * b - 4.0f * a * c;
  const float sq = sqrtf(fmaxf(discr, 0.0f));
  const float q = b < 0.0f ? -0.5f * (b - sq) : -0.5f * (b + sq);
  const float x1 = q / (a == 0.0f ? 1.0f : a);
  const float x2 = c / (q == 0.0f ? 1.0f : q);
  t0 = fminf(x1, x2);
  t1 = fmaxf(x1, x2);
  return discr >= 0.0f;
}

__device__ __forceinline__ float pow64(float x, double e) {
  return (float)pow((double)x, e);
}

// The Nishita sky from (px, py, pz) along (dx, dy, dz) (ops/environment.py
// nishita_sky), before skylight.
__device__ void nishita(const float* prm, float px, float py, float pz,
                        float dx, float dy, float dz, int ns, int nl,
                        float rgb[3]) {
  const float er = prm[kEarthKm] * 1000.0f;
  const float ar = prm[kAtmosphereKm] * 1000.0f;
  const float hr = prm[kHr], hm = prm[kHm], g = prm[kMieG];
  const float sx = prm[kSunX], sy = prm[kSunY], sz = prm[kSunZ];
  const float clamp = prm[kExpClamp];
  const float beta_r[3] = {prm[kBetaR0], prm[kBetaR1], prm[kBetaR2]};
  const float beta_m = prm[kBetaM], beta_m_ext = prm[kBetaMExt];
  const float ox = px + 0.0f, oy = py + er, oz = pz + 0.0f;
  float t0, t1;
  const bool valid = ray_sphere_both(ox, oy, oz, dx, dy, dz, ar, t0, t1) &&
                     t1 >= 0.0f;
  const float tmin = t0 > 0.0f ? fmaxf(t0, 0.0f) : 0.0f;
  const float tmax = fminf(t1, prm[kTFar]);
  const float seg_len = (tmax - tmin) / (float)ns;
  const float mu = dot3(dx, dy, dz, sx, sy, sz);
  const float phase_r = prm[kPhaseR] * (1.0f + mu * mu);
  const float phase_m = prm[kPhaseM] * ((1.0f - g * g) * (1.0f + mu * mu)) /
                        ((2.0f + g * g) * pow64(1.0f + g * g - 2.0f * g * mu, 1.5));
  float optical_r = 0.0f, optical_m = 0.0f;
  float sum_r[3] = {0.0f, 0.0f, 0.0f}, sum_m[3] = {0.0f, 0.0f, 0.0f};
  for (int s = 0; s < ns; ++s) {
    const float t_mid = tmin + ((float)s + 0.5f) * seg_len;
    const float qx = ox + t_mid * dx, qy = oy + t_mid * dy, qz = oz + t_mid * dz;
    const float height = sqrtf(dot3(qx, qy, qz, qx, qy, qz)) - er;
    const float hr_i = expf(fminf(-height / hr, clamp)) * seg_len;
    const float hm_i = expf(fminf(-height / hm, clamp)) * seg_len;
    optical_r = optical_r + hr_i;
    optical_m = optical_m + hm_i;
    float l0, l1;
    ray_sphere_both(qx, qy, qz, sx, sy, sz, ar, l0, l1);
    const float seg_light = l1 / (float)nl;
    bool light_valid = true;
    float lr = 0.0f, lm = 0.0f;
    for (int j = 0; j < nl; ++j) {
      const float tl = ((float)j + 0.5f) * seg_light;
      const float lx = qx + tl * sx, ly = qy + tl * sy, lz = qz + tl * sz;
      const float hl = sqrtf(dot3(lx, ly, lz, lx, ly, lz)) - er;
      light_valid = light_valid && hl >= 0.0f;
      const float er_j = expf(fminf(-hl / hr, clamp));
      const float em_j = expf(fminf(-hl / hm, clamp));
      lr = j == 0 ? er_j : lr + er_j;
      lm = j == 0 ? em_j : lm + em_j;
    }
    const float od_r = optical_r + lr * seg_light;
    const float od_m = optical_m + lm * seg_light;
    for (int c = 0; c < 3; ++c) {
      const float att = expf(-(beta_r[c] * od_r + beta_m_ext * od_m));
      const float w_r = light_valid ? att * hr_i : 0.0f;
      const float w_m = light_valid ? att * hm_i : 0.0f;
      sum_r[c] = s == 0 ? w_r : sum_r[c] + w_r;
      sum_m[c] = s == 0 ? w_m : sum_m[c] + w_m;
    }
  }
  for (int c = 0; c < 3; ++c)
    rgb[c] = valid ? (sum_r[c] * beta_r[c] * phase_r +
                      sum_m[c] * beta_m * phase_m) * 20.0f
                   : 0.0f;
}

// Python's a mod m for m > 0 (jnp.mod, torch.remainder).
__device__ __forceinline__ int wrap(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

// The cubemap fetch along (dx, dy, dz) (ops/texture.py sample_cubemap):
// faces (6, h, w, 4) ordered +X, -X, +Y, -Y, +Z, -Z, a bilinear fetch with
// wrap addressing inside the face and half-texel centres.
__device__ void cubemap(const float* __restrict__ faces, int h, int w,
                        float dx, float dy, float dz, float rgb[3]) {
  const float ax = fabsf(dx), ay = fabsf(dy), az = fabsf(dz);
  const bool z_major = az >= ax && az >= ay;
  const bool y_major = !z_major && ay >= ax;
  const int face = z_major ? (dz < 0.0f ? 5 : 4)
                           : (y_major ? (dy < 0.0f ? 3 : 2) : (dx < 0.0f ? 1 : 0));
  const float ma = 0.5f / (z_major ? az : (y_major ? ay : ax));
  const float u = z_major ? (dz < 0.0f ? -dx : dx)
                          : (y_major ? dx : (dx < 0.0f ? dz : -dz));
  const float v = z_major ? -dy : (y_major ? (dy > 0.0f ? dz : -dz) : -dy);
  const float uu = u * ma + 0.5f, vv = v * ma + 0.5f;
  const float x = (uu - floorf(uu)) * (float)w - 0.5f;
  const float y = (vv - floorf(vv)) * (float)h - 0.5f;
  const float x0 = floorf(x), y0 = floorf(y);
  const float fx = x - x0, fy = y - y0;
  const int x0i = wrap((int)x0, w), x1i = wrap(x0i + 1, w);
  const int y0i = wrap((int)y0, h), y1i = wrap(y0i + 1, h);
  const float* f = faces + (size_t)face * h * w * 4;
  const float4 t00 = *reinterpret_cast<const float4*>(f + ((size_t)y0i * w + x0i) * 4);
  const float4 t10 = *reinterpret_cast<const float4*>(f + ((size_t)y0i * w + x1i) * 4);
  const float4 t01 = *reinterpret_cast<const float4*>(f + ((size_t)y1i * w + x0i) * 4);
  const float4 t11 = *reinterpret_cast<const float4*>(f + ((size_t)y1i * w + x1i) * 4);
  const float a00[3] = {t00.x, t00.y, t00.z}, a10[3] = {t10.x, t10.y, t10.z};
  const float a01[3] = {t01.x, t01.y, t01.z}, a11[3] = {t11.x, t11.y, t11.z};
  for (int c = 0; c < 3; ++c) {
    const float top = a00[c] * (1.0f - fx) + a10[c] * fx;
    const float bot = a01[c] * (1.0f - fx) + a11[c] * fx;
    rgb[c] = top * (1.0f - fy) + bot * fy;
  }
}

// st: path-state planes (rows OX ... TB read), plane stride st_stride;
// rad: (3, rad_stride) radiance planes, updated; miss: (n,); out: (3,
// out_stride) planes or null; faces: (6, h, w, 4) for the cubemap; prm:
// (24,) parameters.
template <int kMode>
__global__ void __launch_bounds__(kEnvThreads)
miss_radiance_kernel(const float* __restrict__ st, float* __restrict__ rad,
                     const float* __restrict__ miss, float* __restrict__ out,
                     const float* __restrict__ faces,
                     const float* __restrict__ prm, int n, int st_stride,
                     int rad_stride, int out_stride, int ns, int nl, int h,
                     int w) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !(miss[i] > 0.0f)) return;
  const float dx = st[(kDX + 0) * st_stride + i];
  const float dy = st[(kDX + 1) * st_stride + i];
  const float dz = st[(kDX + 2) * st_stride + i];
  float rgb[3];
  if (kMode == kModeSky) {
    nishita(prm, st[(kOX + 0) * st_stride + i], st[(kOX + 1) * st_stride + i],
            st[(kOX + 2) * st_stride + i], dx, dy, dz, ns, nl, rgb);
  } else {
    cubemap(faces, h, w, dx, dy, dz, rgb);
  }
  const double inv_gamma = (double)prm[kInvGamma];
  for (int c = 0; c < 3; ++c) {
    const float light =
        fmaxf(pow64(fmaxf(rgb[c] * prm[kSky], 0.0f), inv_gamma), 0.0f);
    rad[c * rad_stride + i] =
        rad[c * rad_stride + i] + st[(kTR + c) * st_stride + i] * light;
    if (out) out[c * out_stride + i] = light;
  }
}

}  // namespace rtf

extern "C" {

int rtf_miss_radiance(const void* st, void* rad, const void* miss, void* out,
                      const void* faces, const void* prm, int n, int st_stride,
                      int rad_stride, int out_stride, int mode, int ns, int nl,
                      int h, int w, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + rtf::kEnvThreads - 1) / rtf::kEnvThreads;
  auto launch = mode == rtf::kModeSky ? rtf::miss_radiance_kernel<rtf::kModeSky>
                                      : rtf::miss_radiance_kernel<rtf::kModeCubemap>;
  launch<<<blocks, rtf::kEnvThreads, 0, (cudaStream_t)stream>>>(
      (const float*)st, (float*)rad, (const float*)miss, (float*)out,
      (const float*)faces, (const float*)prm, n, st_stride, rad_stride,
      out_stride, ns, nl, h, w);
  return (int)cudaGetLastError();
}

const char* rtf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
