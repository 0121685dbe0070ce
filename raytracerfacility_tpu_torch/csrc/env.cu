// The miss-radiance kernels, with a plain C interface for ctypes
// (raytracerfacility_tpu_torch/kernels.py builds and loads them;
// ops/environment.py::miss_radiance launches them).
//
// They replace no TPU kernel. They stand for the XLA glue the reference
// runs between its segment launches (raytracerfacility_tpu/ops/
// pallas_seg.py:1035-1060 add_env): calculate_environmental_light with a
// cubemap (ops/texture.py:94 sample_cubemap) or the Nishita sky
// (ops/environment.py:143 nishita_sky), for every ray, then the misses
// selected. Written as tensor ops the sky materialises (rays, 16, 8, 3)
// intermediates; here the march runs in registers.
//
// For each ray i < n whose miss flag is set: the light along its direction
// (the cubemap's bilinear fetch, or the sky from its origin), times
// skylight, through the inverse gamma; radiance += throughput * light, and
// out = light when `out` is given (the segment-0 albedo AOV). A ray whose
// flag is not set is not touched.
//
// Two launches. miss_compact_kernel lists the missed lanes of [0, n): each
// warp counts its own (__ballot_sync, __popc for the lanes' offsets) and
// each block of 512 lanes takes its place in `list` with one atomicAdd on
// `count`, which stays in device memory (one atomic a warp, 64.8k on a
// 1080p launch, serialised on the one address: 0.04 ms). Given a `tally`,
// the block adds its count to that running int64 total too (one more
// atomicAdd a block with a missed lane), which also stays on the device
// until the host reads it outside the timed path. Then
// miss_radiance_kernel<mode> runs over the list alone, on a grid that fills
// the card and strides over the list, reading the count on the device: the
// host reads nothing between the launches. The list's order is that of the
// atomics and does not matter: each ray writes only its own radiance and
// out columns.
//
// What idled the first design (one thread a lane of [0, n)): the hook
// runs before the reorder, so the missed lanes lie scattered over the
// warps. On the sky's busiest 1080p segment 29% of the lanes missed, and
// every warp that held one missed lane ran the whole march (16 view
// samples of 8 light samples, 336 expf and about 290 IEEE divisions)
// with most of its lanes idle; in the late segments the few missed rays
// (45,018 in segment 8) filled a sixth of the card's warp slots.
//
// The sky is bound by its operations. It runs 16 lanes a missed ray (two
// rays a warp), lane s on view sample s (more samples in rounds of 16):
// its density weights and its light march. The running optical depths
// pass from lane to lane in sample order (__shfl_up_sync: lane s adds its
// weight to lane s - 1's total, lane 0 to the last round's). The
// attenuated weights go to shared memory, and lane q < 6 gathers quantity
// q (three Rayleigh, three Mie channels) in sample order. Every 16 turns
// the warp finishes its 32 rays one a lane: the phases, the channels and
// the inverse gamma, whose four float64 pows a ray would otherwise run
// on 3 of 16 lanes. So a missed ray's march runs on 16 busy lanes, and the
// late segments' few rays fill 16 times as many lanes. The cubemap is
// bound by its bytes (four texels a ray, gathered): one thread a missed
// ray.
//
// The operation order is that of the plain version (ops/environment.py:
// sums in sample order, no fused multiply-add under -fmad=false, IEEE
// division and sqrtf); the float64 pow is the plain version's pow64.

#include <cuda_runtime.h>

namespace rtf {

constexpr int kEnvThreads = 128;
constexpr int kSkyLanes = 16;  // lanes a missed ray under the sky
// a row of SkyWarp::w (16 lanes, padded), and a group's six rows padded so
// that the second group's rows start 16 banks on
constexpr int kRowStride = kSkyLanes + 1, kGroupStride = 112;
constexpr int kCompactThreads = 512;  // one atomic add a block of these
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kModeCubemap = 1, kModeSky = 2;
// path-state planes read (ops/fused.py OX ... TB)
constexpr int kOX = 0, kDX = 3, kTR = 7;
// the parameter vector (ops/environment.py env_params)
enum Param {
  kSky, kInvGamma, kColorR, kColorG, kColorB, kSunX, kSunY, kSunZ,
  kEarthKm, kAtmosphereKm, kInvHr, kInvHm, kMieG, kBetaR0, kBetaR1, kBetaR2,
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

// View sample s of the sky along (dx, dy, dz) from (ox, oy, oz), the
// origin lifted by the Earth's radius (ops/environment.py _nishita_terms):
// its density weights, its light march's optical depths, and whether
// every light sample lies at or above the ground.
struct ViewSample {
  float hr, hm, light_r, light_m;
  bool light_valid;
};

__device__ __forceinline__ ViewSample view_sample(const float* prm, float ox,
                                                  float oy, float oz, float dx,
                                                  float dy, float dz,
                                                  float tmin, float seg_len,
                                                  int s, int nl) {
  const float er = prm[kEarthKm] * 1000.0f;
  const float ar = prm[kAtmosphereKm] * 1000.0f;
  const float inv_hr = prm[kInvHr], inv_hm = prm[kInvHm], clamp = prm[kExpClamp];
  const float sx = prm[kSunX], sy = prm[kSunY], sz = prm[kSunZ];
  const float t_mid = tmin + ((float)s + 0.5f) * seg_len;
  const float qx = ox + t_mid * dx, qy = oy + t_mid * dy, qz = oz + t_mid * dz;
  const float height = sqrtf(dot3(qx, qy, qz, qx, qy, qz)) - er;
  ViewSample v;
  v.hr = expf(fminf(-height * inv_hr, clamp)) * seg_len;
  v.hm = expf(fminf(-height * inv_hm, clamp)) * seg_len;
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
    const float er_j = expf(fminf(-hl * inv_hr, clamp));
    const float em_j = expf(fminf(-hl * inv_hm, clamp));
    lr = j == 0 ? er_j : lr + er_j;
    lm = j == 0 ? em_j : lm + em_j;
  }
  v.light_r = lr * seg_light;
  v.light_m = lm * seg_light;
  v.light_valid = light_valid;
  return v;
}

// Channel c of missed ray i: light = max(max(rgb * skylight, 0) ^ (1 /
// gamma), 0); radiance += throughput * light; out = light.
__device__ __forceinline__ void shade(const float* __restrict__ st,
                                      float* __restrict__ rad,
                                      float* __restrict__ out,
                                      const float* __restrict__ prm, int i,
                                      int c, float rgb, int st_stride,
                                      int rad_stride, int out_stride) {
  const float light = fmaxf(
      pow64(fmaxf(rgb * prm[kSky], 0.0f), (double)prm[kInvGamma]), 0.0f);
  rad[c * rad_stride + i] =
      rad[c * rad_stride + i] + st[(kTR + c) * st_stride + i] * light;
  if (out) out[c * out_stride + i] = light;
}

// A warp's shared memory under the sky: a round's attenuated weights of
// its two 16-lane groups, quantity by quantity (rows padded so that the
// two groups' lanes fall in different banks), and the sums of the missed
// rays it has marched but not yet finished.
struct SkyWarp {
  float w[2][kGroupStride];
  float sums[32][7];  // six sums and the atmosphere-hit flag a ray
  int ray[32];        // its lane, -1 for a half past the list
};

// The Nishita sky's sums from (px, py, pz) along (dx, dy, dz)
// (ops/environment.py nishita_sky) on the 16-lane group of lane s0, whose
// rows of SkyWarp::w are `w`: lane q < 6 returns the sum over the view
// samples of the attenuated weights, Rayleigh channel q (q < 3) or Mie
// channel q - 3, and every lane whether the ray hits the atmosphere. Every
// lane of the warp calls it with the same ns (the shuffles span the warp,
// 16 lanes wide).
__device__ float nishita_sums(const float* prm, float px, float py, float pz,
                              float dx, float dy, float dz, int ns, int nl,
                              int s0, float* w, bool& valid) {
  const float er = prm[kEarthKm] * 1000.0f;
  const float ar = prm[kAtmosphereKm] * 1000.0f;
  const float beta_m_ext = prm[kBetaMExt];
  const float ox = px + 0.0f, oy = py + er, oz = pz + 0.0f;
  float t0, t1;
  valid = ray_sphere_both(ox, oy, oz, dx, dy, dz, ar, t0, t1) && t1 >= 0.0f;
  const float tmin = t0 > 0.0f ? fmaxf(t0, 0.0f) : 0.0f;
  const float tmax = fminf(t1, prm[kTFar]);
  const float seg_len = (tmax - tmin) / (float)ns;
  // the optical depths through the last round, and lane q's sum so far
  float carry_r = 0.0f, carry_m = 0.0f, sum = 0.0f;
  for (int first = 0; first < ns; first += kSkyLanes) {
    const int lanes = min(kSkyLanes, ns - first);
    ViewSample v{0.0f, 0.0f, 0.0f, 0.0f, false};
    if (s0 < lanes)
      v = view_sample(prm, ox, oy, oz, dx, dy, dz, tmin, seg_len, first + s0, nl);
    // the running optical depths in sample order: lane 0 adds its weight
    // to the carry, lane j to lane j - 1's total once that is final
    float opt_r = s0 == 0 ? carry_r + v.hr : v.hr;
    float opt_m = s0 == 0 ? carry_m + v.hm : v.hm;
    for (int j = 1; j < lanes; ++j) {
      const float up_r = __shfl_up_sync(kFullMask, opt_r, 1, kSkyLanes);
      const float up_m = __shfl_up_sync(kFullMask, opt_m, 1, kSkyLanes);
      if (s0 == j) {
        opt_r = up_r + v.hr;
        opt_m = up_m + v.hm;
      }
    }
    carry_r = __shfl_sync(kFullMask, opt_r, lanes - 1, kSkyLanes);
    carry_m = __shfl_sync(kFullMask, opt_m, lanes - 1, kSkyLanes);
    const float od_r = opt_r + v.light_r, od_m = opt_m + v.light_m;
    __syncwarp();  // the last round's weights are read
    for (int c = 0; c < 3; ++c) {
      const float att = expf(-(prm[kBetaR0 + c] * od_r + beta_m_ext * od_m));
      w[c * kRowStride + s0] = v.light_valid ? att * v.hr : 0.0f;
      w[(3 + c) * kRowStride + s0] = v.light_valid ? att * v.hm : 0.0f;
    }
    __syncwarp();
    if (s0 < 6) {  // lane q gathers quantity q in sample order
      const float* row = w + s0 * kRowStride;
      for (int j = 0; j < lanes; ++j) sum = first + j == 0 ? row[j] : sum + row[j];
    }
  }
  return sum;
}

// Lane l finishes the l-th buffered missed ray (l < buffered): the
// phases, the channels as nishita_sky combines them, then shade.
__device__ void finish_sky(const SkyWarp& sw, int lane, int buffered,
                           const float* __restrict__ st, float* __restrict__ rad,
                           float* __restrict__ out, const float* __restrict__ prm,
                           int st_stride, int rad_stride, int out_stride) {
  __syncwarp();
  const int i = lane < buffered ? sw.ray[lane] : -1;
  if (i >= 0) {
    const float* q = sw.sums[lane];
    const float g = prm[kMieG];
    const float mu = dot3(st[(kDX + 0) * st_stride + i], st[(kDX + 1) * st_stride + i],
                          st[(kDX + 2) * st_stride + i], prm[kSunX], prm[kSunY],
                          prm[kSunZ]);
    const float phase_r = prm[kPhaseR] * (1.0f + mu * mu);
    const float phase_m = prm[kPhaseM] * ((1.0f - g * g) * (1.0f + mu * mu)) /
                          ((2.0f + g * g) * pow64(1.0f + g * g - 2.0f * g * mu, 1.5));
    for (int c = 0; c < 3; ++c) {
      const float rgb = q[6] > 0.0f ? (q[c] * prm[kBetaR0 + c] * phase_r +
                                       q[3 + c] * prm[kBetaM] * phase_m) * 20.0f
                                    : 0.0f;
      shade(st, rad, out, prm, i, c, rgb, st_stride, rad_stride, out_stride);
    }
  }
  __syncwarp();
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

// miss: (n,); list: (n,) int32, the missed lanes appended; count: the
// number appended (set to 0 before the launch); tally: a running int64
// total the count is added to, or null. Each warp counts its missed lanes
// (__ballot_sync, __popc), the block's first thread lays the warps out and
// takes the block's place in the list with one atomicAdd.
__global__ void __launch_bounds__(kCompactThreads)
miss_compact_kernel(const float* __restrict__ miss, int* __restrict__ list,
                    int* __restrict__ count,
                    unsigned long long* __restrict__ tally, int n) {
  __shared__ int warp_base[kCompactThreads / 32];
  __shared__ int block_base;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const bool missed = i < n && miss[i] > 0.0f;
  const unsigned ballot = __ballot_sync(kFullMask, missed);
  if (lane == 0) warp_base[warp] = __popc(ballot);
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int k = 0; k < kCompactThreads / 32; ++k) {
      const int c = warp_base[k];
      warp_base[k] = total;
      total += c;
    }
    block_base = total > 0 ? atomicAdd(count, total) : 0;
    if (total > 0 && tally != nullptr)
      atomicAdd(tally, (unsigned long long)total);
  }
  __syncthreads();
  if (missed)
    list[block_base + warp_base[warp] + __popc(ballot & ((1u << lane) - 1u))] = i;
}

// st: path-state planes (rows OX ... TB read), plane stride st_stride;
// rad: (3, rad_stride) radiance planes, updated; list, count: the missed
// lanes (miss_compact_kernel); out: (3, out_stride) planes or null; faces:
// (6, h, w, 4) for the cubemap; prm: (24,) parameters.
template <int kMode>
__global__ void __launch_bounds__(kEnvThreads)
miss_radiance_kernel(const float* __restrict__ st, float* __restrict__ rad,
                     const int* __restrict__ list,
                     const int* __restrict__ count, float* __restrict__ out,
                     const float* __restrict__ faces,
                     const float* __restrict__ prm, int st_stride,
                     int rad_stride, int out_stride, int ns, int nl, int h,
                     int w) {
  const int m = *count;
  const int thread = blockIdx.x * blockDim.x + threadIdx.x;
  const int threads = gridDim.x * blockDim.x;
  if constexpr (kMode == kModeSky) {
    __shared__ SkyWarp warps[kEnvThreads / 32];
    SkyWarp& sw = warps[threadIdx.x / 32];
    const int lane = threadIdx.x & 31;
    const int half = lane / kSkyLanes, s0 = lane % kSkyLanes;
    // two missed rays a warp a turn: both halves take the same turns (a
    // half past the list marches its partner's ray and is not finished);
    // every 16 turns the warp finishes its 32 rays, one a lane
    int buffered = 0;
    for (int pair = thread / 32 * 2; pair < m; pair += threads / kSkyLanes) {
      const int k = pair + half;
      const int i = list[k < m ? k : pair];
      bool valid;
      const float sum = nishita_sums(
          prm, st[(kOX + 0) * st_stride + i], st[(kOX + 1) * st_stride + i],
          st[(kOX + 2) * st_stride + i], st[(kDX + 0) * st_stride + i],
          st[(kDX + 1) * st_stride + i], st[(kDX + 2) * st_stride + i], ns, nl,
          s0, sw.w[half], valid);
      if (s0 < 6) sw.sums[buffered + half][s0] = sum;
      if (s0 == 0) {
        sw.sums[buffered + half][6] = valid ? 1.0f : 0.0f;
        sw.ray[buffered + half] = k < m ? i : -1;
      }
      buffered += 2;
      if (buffered == 32) {
        finish_sky(sw, lane, buffered, st, rad, out, prm, st_stride, rad_stride,
                   out_stride);
        buffered = 0;
      }
    }
    if (buffered > 0)
      finish_sky(sw, lane, buffered, st, rad, out, prm, st_stride, rad_stride,
                 out_stride);
  } else {
    for (int k = thread; k < m; k += threads) {
      const int i = list[k];
      float rgb[3];
      cubemap(faces, h, w, st[(kDX + 0) * st_stride + i],
              st[(kDX + 1) * st_stride + i], st[(kDX + 2) * st_stride + i], rgb);
      for (int c = 0; c < 3; ++c)
        shade(st, rad, out, prm, i, c, rgb[c], st_stride, rad_stride, out_stride);
    }
  }
}

// Blocks of `kernel` (mode `mode`) that fill the current card: its
// resident blocks an SM times the SMs, asked once a card and mode.
template <typename Kernel>
cudaError_t fill_blocks(Kernel kernel, int mode, int& blocks) {
  constexpr int kCards = 64;
  static int known[kCards][3];
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kCards && known[dev][mode] > 0) {
    blocks = known[dev][mode];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kEnvThreads, 0);
  blocks = sms * per_sm;
  if (err == cudaSuccess && dev < kCards) known[dev][mode] = blocks;
  return err;
}

}  // namespace rtf

extern "C" {

// tally: an int64 running total the count is added to, or null.
int rtf_miss_compact(const void* miss, void* list, void* count, void* tally,
                     int n, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int), s);
  if (err != cudaSuccess || n <= 0) return (int)err;
  const int blocks = (n + rtf::kCompactThreads - 1) / rtf::kCompactThreads;
  rtf::miss_compact_kernel<<<blocks, rtf::kCompactThreads, 0, s>>>(
      (const float*)miss, (int*)list, (int*)count,
      (unsigned long long*)tally, n);
  return (int)cudaGetLastError();
}

// n: the lanes compacted, a bound on the count (the grid never exceeds
// what n missed rays would fill).
int rtf_miss_radiance(const void* st, void* rad, const void* list,
                      const void* count, void* out, const void* faces,
                      const void* prm, int n, int st_stride, int rad_stride,
                      int out_stride, int mode, int ns, int nl, int h, int w,
                      void* stream) {
  if (n <= 0) return 0;
  const bool sky = mode == rtf::kModeSky;
  auto launch = sky ? rtf::miss_radiance_kernel<rtf::kModeSky>
                    : rtf::miss_radiance_kernel<rtf::kModeCubemap>;
  int blocks = 0;
  const cudaError_t err = rtf::fill_blocks(launch, sky ? rtf::kModeSky
                                                       : rtf::kModeCubemap, blocks);
  if (err != cudaSuccess) return (int)err;
  const long long lanes = (long long)n * (sky ? rtf::kSkyLanes : 1);
  const long long needed = (lanes + rtf::kEnvThreads - 1) / rtf::kEnvThreads;
  blocks = (int)(needed < blocks ? needed : blocks);
  launch<<<blocks, rtf::kEnvThreads, 0, (cudaStream_t)stream>>>(
      (const float*)st, (float*)rad, (const int*)list, (const int*)count,
      (float*)out, (const float*)faces, (const float*)prm, st_stride,
      rad_stride, out_stride, ns, nl, h, w);
  return (int)cudaGetLastError();
}

const char* rtf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
