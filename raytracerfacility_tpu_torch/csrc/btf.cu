// The MLVQ CompressedBTF decode kernel, with a plain C interface for ctypes
// (raytracerfacility_tpu_torch/kernels.py builds and loads it;
// ops/btf.py::btf_colors launches it).
//
// It replaces no TPU kernel. It stands for the XLA glue of the reference's
// wavefront segment (raytracerfacility_tpu/models/pathtracer.py:209-301
// _btf_colors over mlvq/btf.py:316 btf_get_value): for every lane of a BTF
// material that a segment accepted, the tangent-space angles of the view
// and illumination directions against the geometric normal and tangent,
// then the six-level PDF chain of the lane's material, then / 256. The
// reference compacts the decode lanes with a multi-operand sort and a
// five-way width cascade; written as tensor ops the chain is several
// hundred launches a segment.
//
// The work: a decoded lane reads about 125 table entries in a dependent
// chain (the texel's PDF6 entry, two PDF4 slices, four PDF3 entries, four
// PDF2 records, each with two Hermite windows of four and two IndexAB
// pairs of colours) and does a few hundred float operations and about
// fourteen float64 transcendental calls. The tables are small (kilobytes for a synthetic
// database, megabytes for a measured one) and stay in L2 and the read-only
// cache; the lanes' inputs and outputs are 64 bytes a lane. So the kernel
// is bound by the latency of its dependent gathers, not by the bytes it
// moves or its operations.
//
// The design: one thread a listed lane, the whole chain in registers. The
// lanes come from ops/environment.py's miss_compact_kernel over the
// segment's BTF mask (is_btf & accepted), so no warp carries lanes that
// are not decoded; the count stays on the device and the kernel reads it,
// on a grid that fills the card and strides over the list (as
// miss_radiance_kernel does). Every material of a scene lives in one float
// and one int buffer; a lane reads its material's descriptor (offsets and
// static parameters, ops/btf.py pack_btf_tables) once. Tables are read
// through the read-only path (__ldg).
//
// The operations and their order are those of the plain version
// (raytracerfacility_tpu_torch/mlvq/btf.py): no fused multiply-add under
// -fmad=false, IEEE division (also by a constant, the plain version's
// true_div), every transcendental function (sin, cos, asin, acos, atan2,
// exp, pow) in float64 rounded to float32 as the plain version takes it,
// fmodf, float-to-int conversions that truncate, clamps that pass NaN
// through as torch.clamp does, and the floored remainder of
// torch.remainder.

#include <cuda_runtime.h>

namespace rtf {

constexpr int kBtfThreads = 128;

// the int descriptor of a material (ops/btf.py IDESC)
enum IDesc {
  kPdf6Slices, kIndexAB, kPdf2Colors, kPdf2Slices, kIndexLumColor,
  kPdf3Slices, kPdf4Slices,  // offsets into the int buffer
  kPdf6Scales, kPdf1Basis, kColors, kPdf2Scales, kPdf3Scales, kPdf4Scales,
  kBetaAngles,  // offsets into the float buffer
  kNumBeta, kNumAlpha, kNumTheta, kNumPhi, kNumRows, kNumCols, kRowsOffset,
  kColsOffset, kUseCosBeta, kHdr, kCodeBtf, kIDescWidth = 32
};
// the float descriptor of a material (ops/btf.py FDESC)
enum FDesc {
  kHdrValue, kMultiplier, kTexCoordMultiplier, kGamma, kStepBeta, kStepAlpha,
  kStepTheta, kStepPhi, kOffR, kOffG, kOffB, kFDescWidth = 16
};

// float32 pi / 180, 180 / pi and 1 / 2.4 (the plain version's constants)
__device__ __forceinline__ float deg2rad() { return __int_as_float(0x3c8efa35); }
__device__ __forceinline__ float rad2deg() { return __int_as_float(0x42652ee1); }
__device__ __forceinline__ float inv_2_4() { return __int_as_float(0x3ed55555); }

// a transcendental function of float32 values taken in float64, rounded
__device__ __forceinline__ float sin64(float x) { return (float)sin((double)x); }
__device__ __forceinline__ float cos64(float x) { return (float)cos((double)x); }
__device__ __forceinline__ float asin64(float x) { return (float)asin((double)x); }
__device__ __forceinline__ float acos64(float x) { return (float)acos((double)x); }
__device__ __forceinline__ float exp64(float x) { return (float)exp((double)x); }
__device__ __forceinline__ float atan2_64(float y, float x) {
  return (float)atan2((double)y, (double)x);
}
__device__ __forceinline__ float pow64(float x, float e) {
  return (float)pow((double)x, (double)e);
}

// torch.clamp: a NaN passes through
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
__device__ __forceinline__ float max0(float x) { return x < 0.0f ? 0.0f : x; }
__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
// torch.remainder: floored
__device__ __forceinline__ float fmod_floor(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m = m + b;
  return m;
}
__device__ __forceinline__ int imod_floor(int a, int b) {
  int m = a % b;
  if (m != 0 && ((b < 0) != (m < 0))) m += b;
  return m;
}

struct Material {
  const float *pdf6_scales, *pdf1_basis, *colors, *pdf2_scales, *pdf3_scales,
      *pdf4_scales, *beta_angles;
  const int *pdf6_slices, *index_ab, *pdf2_colors, *pdf2_slices,
      *index_lum_color, *pdf3_slices, *pdf4_slices;
  int nb, na, nt, nphi, rows, cols, rows_offset, cols_offset;
  bool use_cos_beta, hdr, code_btf;
  float hdr_value, multiplier, tex_mult, gamma, step_beta, step_alpha,
      step_theta, step_phi, off_r, off_g, off_b;
};

__device__ __forceinline__ Material load_material(const float* __restrict__ fbuf,
                                                  const int* __restrict__ ibuf,
                                                  const int* __restrict__ idesc,
                                                  const float* __restrict__ fdesc,
                                                  int k) {
  const int* d = idesc + k * kIDescWidth;
  const float* f = fdesc + k * kFDescWidth;
  Material m;
  m.pdf6_slices = ibuf + __ldg(d + kPdf6Slices);
  m.index_ab = ibuf + __ldg(d + kIndexAB);
  m.pdf2_colors = ibuf + __ldg(d + kPdf2Colors);
  m.pdf2_slices = ibuf + __ldg(d + kPdf2Slices);
  m.index_lum_color = ibuf + __ldg(d + kIndexLumColor);
  m.pdf3_slices = ibuf + __ldg(d + kPdf3Slices);
  m.pdf4_slices = ibuf + __ldg(d + kPdf4Slices);
  m.pdf6_scales = fbuf + __ldg(d + kPdf6Scales);
  m.pdf1_basis = fbuf + __ldg(d + kPdf1Basis);
  m.colors = fbuf + __ldg(d + kColors);
  m.pdf2_scales = fbuf + __ldg(d + kPdf2Scales);
  m.pdf3_scales = fbuf + __ldg(d + kPdf3Scales);
  m.pdf4_scales = fbuf + __ldg(d + kPdf4Scales);
  m.beta_angles = fbuf + __ldg(d + kBetaAngles);
  m.nb = __ldg(d + kNumBeta);
  m.na = __ldg(d + kNumAlpha);
  m.nt = __ldg(d + kNumTheta);
  m.nphi = __ldg(d + kNumPhi);
  m.rows = __ldg(d + kNumRows);
  m.cols = __ldg(d + kNumCols);
  m.rows_offset = __ldg(d + kRowsOffset);
  m.cols_offset = __ldg(d + kColsOffset);
  m.use_cos_beta = __ldg(d + kUseCosBeta) != 0;
  m.hdr = __ldg(d + kHdr) != 0;
  m.code_btf = __ldg(d + kCodeBtf) != 0;
  m.hdr_value = __ldg(f + kHdrValue);
  m.multiplier = __ldg(f + kMultiplier);
  m.tex_mult = __ldg(f + kTexCoordMultiplier);
  m.gamma = __ldg(f + kGamma);
  m.step_beta = __ldg(f + kStepBeta);
  m.step_alpha = __ldg(f + kStepAlpha);
  m.step_theta = __ldg(f + kStepTheta);
  m.step_phi = __ldg(f + kStepPhi);
  m.off_r = __ldg(f + kOffR);
  m.off_g = __ldg(f + kOffG);
  m.off_b = __ldg(f + kOffB);
  return m;
}

// The lanes' interpolation cells (mlvq/btf.py btf_get_value)
struct Cells {
  int beta_low, alpha_low, theta_low, phi_low;
  float beta_w, alpha_w, theta_w, phi_w;
};

// (low, weight) on a uniform grid (mlvq/btf.py _cell)
__device__ __forceinline__ void cell(float x, float step, int hi, int& low,
                                     float& w) {
  low = clampi((int)(x / step), 0, hi);
  w = (x - (float)low * step) / step;
}

// PDF1 Hermite in beta over the padded basis (mlvq/btf.py _pdf1_hermite)
__device__ __forceinline__ float hermite(const Material& m, int slice,
                                         const Cells& c) {
  const int base = slice * m.nb + c.beta_low;
  const float pm1 = __ldg(m.pdf1_basis + base), p0 = __ldg(m.pdf1_basis + base + 1);
  const float p1 = __ldg(m.pdf1_basis + base + 2), p2 = __ldg(m.pdf1_basis + base + 3);
  const float m0 = c.beta_low == 0 ? p1 - p0 : 0.5f * (p1 - pm1);
  const float m1 = c.beta_low == m.nb - 2 ? p1 - p0 : 0.5f * (p2 - p0);
  const float w = c.beta_w;
  const float t2 = w * w;
  const float t3 = t2 * w;
  const float h01 = -2.0f * t3 + 3.0f * t2;
  const float h00 = 1.0f - h01;
  const float h11 = t3 - t2;
  const float h10 = h11 - t2 + w;
  return h00 * p0 + h10 * m0 + h01 * p1 + h11 * m1;
}

// IndexAB: the a-b pair lerped in beta (mlvq/btf.py _index_ab)
__device__ __forceinline__ void index_ab(const Material& m, int slice,
                                         const Cells& c, float& a, float& b) {
  const int base = slice * m.nb + c.beta_low;
  const int c0 = __ldg(m.index_ab + base) * 2, c1 = __ldg(m.index_ab + base + 1) * 2;
  const float w = c.beta_w;
  a = (1.0f - w) * __ldg(m.colors + c0) + w * __ldg(m.colors + c1);
  b = (1.0f - w) * __ldg(m.colors + c0 + 1) + w * __ldg(m.colors + c1 + 1);
}

// LogLuv to RGB (mlvq/btf.py _logluv_to_rgb)
__device__ void logluv_to_rgb(float l, float u, float v, bool normalized,
                              float rgb[3]) {
  float y;
  if (l < 98.381f)
    y = 0.056968f * l;
  else if (l < 1204.7f)
    y = 7.3014e-30f * pow64(max0(l + 884.17f), 9.9872f);
  else
    y = 32.994f * exp64(0.0047811f * (l > 4000.0f ? 4000.0f : l));
  float x = 0.0f, z = 0.0f;
  if (v > 0.0f) {
    x = 2.25f * u / v * y;
    z = y * (1230.0f / v - 5.0f) - x / 3.0f;
  }
  if (normalized) {
    x = x / 256.0f;
    y = y / 256.0f;
    z = z / 256.0f;
  }
  const float c[3] = {x * 3.2406f + y * -1.5372f + z * -0.4986f,
                      x * -0.9689f + y * 1.8758f + z * 0.0415f,
                      x * 0.0557f + y * -0.2040f + z * 1.0570f};
  for (int k = 0; k < 3; ++k) {
    const float ck = max0(c[k]);
    rgb[k] = ck > 0.0031308f ? 1.055f * pow64(ck, inv_2_4()) - 0.055f : 12.92f * ck;
  }
}

// PDF2DSeperate to RGB (mlvq/btf.py _pdf2 and _user_cm_to_rgb)
__device__ void pdf2(const Material& m, int idx, const Cells& c, float rgb[3]) {
  const int lum = __ldg(m.index_lum_color + idx * 2);
  const int col = __ldg(m.index_lum_color + idx * 2 + 1);
  const int cb = col * m.na + c.alpha_low;
  float a1, b1, a2, b2;
  index_ab(m, __ldg(m.pdf2_colors + cb), c, a1, b1);
  index_ab(m, __ldg(m.pdf2_colors + cb + 1), c, a2, b2);
  const float aw = c.alpha_w;
  const float cm1 = a1 * (1.0f - aw) + a2 * aw;
  const float cm2 = b1 * (1.0f - aw) + b2 * aw;
  const int lb = lum * m.na + c.alpha_low;
  const float l1 = __ldg(m.pdf2_scales + lb) * hermite(m, __ldg(m.pdf2_slices + lb), c);
  const float l2 =
      __ldg(m.pdf2_scales + lb + 1) * hermite(m, __ldg(m.pdf2_slices + lb + 1), c);
  const float cm0 = (1.0f - aw) * l1 + aw * l2;
  if (m.hdr) {
    logluv_to_rgb(cm0, cm1, cm2, m.code_btf, rgb);
    return;
  }
  rgb[0] = max0(cm0 * 1.1643828f + cm2 * 1.5960273f - m.off_r);
  rgb[1] = max0(cm0 * 1.1643828f - cm1 * 0.39176172f - cm2 * 0.81296875f + m.off_g);
  rgb[2] = max0(cm0 * 1.1643828f + cm1 * 2.0172344f - m.off_b);
}

// PDF3: theta interpolation of two PDF2 records (mlvq/btf.py pdf3_eval)
__device__ void pdf3(const Material& m, int idx, const Cells& c, float rgb[3]) {
  const int base = idx * m.nt + c.theta_low;
  float o1[3], o2[3];
  pdf2(m, __ldg(m.pdf3_slices + base), c, o1);
  pdf2(m, __ldg(m.pdf3_slices + base + 1), c, o2);
  const float s1 = __ldg(m.pdf3_scales + base) * (1.0f - c.theta_w);
  const float s2 = __ldg(m.pdf3_scales + base + 1) * c.theta_w;
  for (int k = 0; k < 3; ++k) rgb[k] = o1[k] * s1 + o2[k] * s2;
}

// Tangent-space (theta, phi) in degrees (mlvq/btf.py compute_angles)
__device__ __forceinline__ void compute_angles(float dx, float dy, float dz,
                                               float nx, float ny, float nz,
                                               float gx, float gy, float gz,
                                               float& theta, float& phi) {
  const float bx = ny * gz - nz * gy, by = nz * gx - nx * gz, bz = nx * gy - ny * gx;
  const float tx = gx * dx + gy * dy + gz * dz;
  const float ty = bx * dx + by * dy + bz * dz;
  const float tz = nx * dx + ny * dy + nz * dz;
  theta = acos64(clampf(tz, -1.0f, 1.0f)) * rad2deg();
  phi = atan2_64(ty, tx) * rad2deg() + 360.0f;
  if (phi > 360.0f) phi = phi - 360.0f;
  if (tz < 0.0f) {
    theta = 90.0f;
    phi = 0.0f;
  }
  if (!isfinite(tx)) {
    theta = 0.0f;
    phi = 0.0f;
  }
}

// BTFBase::GetValueDeg (mlvq/btf.py btf_get_value), then / 256
__device__ void get_value(const Material& m, float tu, float tv, float it,
                          float ip, float vt, float vp, float out[3]) {
  const float u = tu * m.tex_mult, v = tv * m.tex_mult;
  const int x = imod_floor((int)(u * (float)m.cols) - m.cols_offset, m.cols);
  const int y = imod_floor((int)(v * (float)m.rows) - m.rows_offset, m.rows);
  const float vphr = fmod_floor(360.0f - vp, 360.0f);
  const float iphr = fmod_floor((360.0f - ip) - (90.0f + vphr), 360.0f);
  const float it_rad = it * deg2rad(), ip_rad = iphr * deg2rad();
  const float sin_it = sin64(it_rad);
  const float xx = cos64(ip_rad) * sin_it;
  const float yy = sin64(ip_rad) * sin_it;
  const float beta_src = m.code_btf ? yy : xx;
  const float alpha_src = m.code_btf ? -xx : yy;
  float beta = asin64(clampf(beta_src, -1.0f, 1.0f));
  const float cos_beta = cos64(beta);
  float alpha = cos_beta < 0.001f
                    ? 0.0f
                    : asin64(clampf(alpha_src / (cos_beta < 0.001f ? 0.001f : cos_beta),
                                    -1.0f, 1.0f));
  beta = clampf(beta * rad2deg(), -90.0f, 90.0f);
  alpha = clampf(alpha * rad2deg(), -90.0f, 90.0f);
  const float theta = clampf(vt, 0.0f, 90.0f);
  const float phi = clampf(vphr, 0.0f, 360.0f);
  // out-of-hemisphere queries and NaN angles are black
  if (it > 90.0f || vt > 90.0f || !isfinite(beta) || !isfinite(alpha) ||
      !isfinite(vt) || !isfinite(phi)) {
    out[0] = out[1] = out[2] = 0.0f;
    return;
  }
  Cells c;
  if (m.use_cos_beta) {
    c.beta_low = clampi(
        (int)((sin64(beta * deg2rad()) + 1.0f) / 2.0f * (float)(m.nb - 1)), 0,
        m.nb - 2);
    const float b0 = __ldg(m.beta_angles + c.beta_low);
    const float b1 = __ldg(m.beta_angles + c.beta_low + 1);
    c.beta_w = (beta - b0) / (b1 - b0);
  } else {
    cell(beta + 90.0f, m.step_beta, m.nb - 2, c.beta_low, c.beta_w);
  }
  cell(alpha + 90.0f, m.step_alpha, m.na - 2, c.alpha_low, c.alpha_w);
  cell(theta, m.step_theta, m.nt - 2, c.theta_low, c.theta_w);
  cell(phi, m.step_phi, m.nphi - 1, c.phi_low, c.phi_w);

  const int texel = y * m.cols + x;
  const int p4 = __ldg(m.pdf6_slices + texel) - 1;
  const float scale6 = __ldg(m.pdf6_scales + texel);
  const int phi_hi = c.phi_low == m.nphi - 1 ? 0 : c.phi_low + 1;
  const int lo = p4 * m.nphi + c.phi_low, hi = p4 * m.nphi + phi_hi;
  float o1[3], o2[3];
  pdf3(m, __ldg(m.pdf4_slices + lo), c, o1);
  pdf3(m, __ldg(m.pdf4_slices + hi), c, o2);
  const float s1 = __ldg(m.pdf4_scales + lo) * (1.0f - c.phi_w);
  const float s2 = __ldg(m.pdf4_scales + hi) * c.phi_w;
  for (int k = 0; k < 3; ++k) {
    float o = (o1[k] * s1 + o2[k] * s2) * scale6;
    o = o * m.multiplier;
    if (m.hdr) o = o / m.hdr_value;
    out[k] = pow64(max0(o), m.gamma);
  }
}

// list, count: the lanes to decode (miss_compact_kernel over the mask);
// bidx: (n,) int32 BTF slot of each lane (a slot outside [0, n_mat) leaves
// the lane alone); uv (n, 2), view, illum, normal, tangent (n, 3); out
// (n, 3), written at the listed lanes.
__global__ void __launch_bounds__(kBtfThreads)
btf_decode_kernel(const int* __restrict__ list, const int* __restrict__ count,
                  const int* __restrict__ bidx, const float* __restrict__ uv,
                  const float* __restrict__ view, const float* __restrict__ illum,
                  const float* __restrict__ normal,
                  const float* __restrict__ tangent, float* __restrict__ out,
                  const float* __restrict__ fbuf, const int* __restrict__ ibuf,
                  const int* __restrict__ idesc, const float* __restrict__ fdesc,
                  int n_mat) {
  const int m_lanes = *count;
  const int threads = gridDim.x * blockDim.x;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < m_lanes; j += threads) {
    const int i = __ldg(list + j);
    const int k = __ldg(bidx + i);
    if (k < 0 || k >= n_mat) continue;
    const Material m = load_material(fbuf, ibuf, idesc, fdesc, k);
    const float nx = normal[3 * i], ny = normal[3 * i + 1], nz = normal[3 * i + 2];
    const float gx = tangent[3 * i], gy = tangent[3 * i + 1], gz = tangent[3 * i + 2];
    float vt, vp, it, ip;
    compute_angles(view[3 * i], view[3 * i + 1], view[3 * i + 2], nx, ny, nz, gx,
                   gy, gz, vt, vp);
    compute_angles(illum[3 * i], illum[3 * i + 1], illum[3 * i + 2], nx, ny, nz,
                   gx, gy, gz, it, ip);
    float rgb[3];
    get_value(m, uv[2 * i], uv[2 * i + 1], it, ip, vt, vp, rgb);
    for (int c = 0; c < 3; ++c) out[3 * i + c] = rgb[c] / 256.0f;
  }
}

}  // namespace rtf

extern "C" {

// n: the lanes compacted, a bound on the count (the grid never exceeds
// what n listed lanes would fill).
int rtf_btf_decode(const void* list, const void* count, const void* bidx,
                   const void* uv, const void* view, const void* illum,
                   const void* normal, const void* tangent, void* out,
                   const void* fbuf, const void* ibuf, const void* idesc,
                   const void* fdesc, int n, int n_mat, void* stream) {
  if (n <= 0) return 0;
  static int known[64];
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int fill = dev < 64 ? known[dev] : 0;
  if (fill == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, rtf::btf_decode_kernel, rtf::kBtfThreads, 0);
    if (err != cudaSuccess) return (int)err;
    fill = sms * per_sm;
    if (dev < 64) known[dev] = fill;
  }
  const int needed = (n + rtf::kBtfThreads - 1) / rtf::kBtfThreads;
  const int blocks = needed < fill ? needed : fill;
  rtf::btf_decode_kernel<<<blocks, rtf::kBtfThreads, 0, (cudaStream_t)stream>>>(
      (const int*)list, (const int*)count, (const int*)bidx, (const float*)uv,
      (const float*)view, (const float*)illum, (const float*)normal,
      (const float*)tangent, (float*)out, (const float*)fbuf, (const int*)ibuf,
      (const int*)idesc, (const float*)fdesc, n_mat);
  return (int)cudaGetLastError();
}

const char* rtf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
