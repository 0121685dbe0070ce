// The estimator's probe-ray kernel, with a plain C interface for ctypes
// (raytracerfacility_tpu_torch/kernels.py builds and loads it;
// ops/probe.py::probe_rays launches it).
//
// probe_ray_kernel replaces no TPU kernel: it replaces the XLA glue of
// raytracerfacility_tpu/models/illumination.py:120-147, the probe rays of
// the reference's __raygen__IE (ptx/IlluminationEstimation.cu:30-80): for
// each (probe, face, sample) of the pool its ray id, the TEA seed, two
// uniform barycentric draws, the blended position and normal, the normal
// negated on the back face, the uniform-cos hemisphere direction and the
// origin pushed along the normal. In plain PyTorch that is about 164
// dispatches a pool besides the TEA (aranges, int64 LCG draws, blends, the
// tangent frame, the float64 cos and sin) and a seed word copied to the
// device, which waits for the queue; here it is one launch, the seed, the
// probe offset, the samples and the push passed by value.
//
// Bound on this card by bytes: the six float3 of a probe read once (72
// bytes a probe) and 44 bytes a ray written (origin, direction and normal,
// the int64 RNG state). Its instructions (the TEA's 160 integer ones, a
// double cos and sin, two reciprocal square roots as IEEE divisions) sit
// under that bound at a full card of threads. One thread a ray, in the pool's
// row-major (probe, face, sample) order: the 2 * samples threads of a probe
// read its six float3 from the same lines, and neighbouring threads write
// neighbouring rays. The arithmetic is the plain version's operation for
// operation, built with -fmad=false: the LCG and the tangent frame are
// path_common.cuh's, which the path kernels' bounces use, the TEA is
// tea.cuh's, which tea_init_kernel runs.

#include <cuda_runtime.h>

#include <cstring>

#include "path_common.cuh"
#include "tea.cuh"

namespace rtf {

constexpr int kProbeThreads = 256;

// pos_*, nrm_*: (P, 3) float32, a probe's triangle corners and their
// normals; origin, direction, normal: (n, 3) float32 and rng: (n,) int64,
// n = P * 2 * samples rays in (probe, face, sample) order. Ray i's id is
// (i + id_base) mod 2**32, id_base = probe_offset * 2 * samples mod 2**32:
// the low 32 bits of the plain version's int64 id (probe + probe_offset) *
// 2 * samples + face * samples + sample, which wraps the same way.
__global__ void __launch_bounds__(kProbeThreads)
probe_ray_kernel(const float* __restrict__ pos_a, const float* __restrict__ pos_b,
                 const float* __restrict__ pos_c, const float* __restrict__ nrm_a,
                 const float* __restrict__ nrm_b, const float* __restrict__ nrm_c,
                 float* __restrict__ origin, float* __restrict__ direction,
                 float* __restrict__ normal, long long* __restrict__ rng_out,
                 int n, int samples, unsigned seed, unsigned id_base, float push) {
  const unsigned i = blockIdx.x * kProbeThreads + threadIdx.x;
  if (i >= (unsigned)n) return;
  const unsigned probe = i / (2u * (unsigned)samples);
  // face 0 = front (+normal), face 1 = back (-normal)
  const float side = ((i / (unsigned)samples) & 1u) ? -1.0f : 1.0f;
  uint32_t rng = tea_hash(i + id_base, seed);
  // uniform barycentric coords, not folded into the triangle
  // (IlluminationEstimation.cu:56-60 draws two raw uniforms)
  float ca, cb;
  rng = lcg(rng, ca);
  rng = lcg(rng, cb);
  const float w = (1.0f - ca) - cb;
  float p[3], nv[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const size_t j = 3 * (size_t)probe + k;
    p[k] = w * __ldg(pos_a + j) + ca * __ldg(pos_b + j) + cb * __ldg(pos_c + j);
    nv[k] = (w * __ldg(nrm_a + j) + ca * __ldg(nrm_b + j) + cb * __ldg(nrm_c + j)) *
            side;
  }
  // the uniform-cos hemisphere (RayTracerUtilities.cuh:135-145): cos(theta)
  // is the first draw itself
  float u_cos, u_phi, d[3];
  rng = lcg(rng, u_cos);
  rng = lcg(rng, u_phi);
  frame_direction(nv[0], nv[1], nv[2], u_cos, u_phi, d[0], d[1], d[2]);
  const size_t o = 3 * (size_t)i;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    origin[o + k] = p[k] + nv[k] * push;
    direction[o + k] = d[k];
    normal[o + k] = nv[k];
  }
  rng_out[i] = (long long)rng;
}

}  // namespace rtf

extern "C" {

// seed, id_base: uint32 words in int32; push_bits: the float32 push's bits.
int rtf_probe_rays(const void* pos_a, const void* pos_b, const void* pos_c,
                   const void* nrm_a, const void* nrm_b, const void* nrm_c,
                   void* origin, void* direction, void* normal, void* rng,
                   int n, int samples, int seed, int id_base, int push_bits,
                   void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + rtf::kProbeThreads - 1) / rtf::kProbeThreads;
  float push;
  memcpy(&push, &push_bits, sizeof push);
  rtf::probe_ray_kernel<<<blocks, rtf::kProbeThreads, 0, (cudaStream_t)stream>>>(
      (const float*)pos_a, (const float*)pos_b, (const float*)pos_c,
      (const float*)nrm_a, (const float*)nrm_b, (const float*)nrm_c,
      (float*)origin, (float*)direction, (float*)normal, (long long*)rng, n,
      samples, (unsigned)seed, (unsigned)id_base, push);
  return (int)cudaGetLastError();
}

const char* rtf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
