// The camera path kernels, one thread per ray, with a plain C interface
// for ctypes (raytracerfacility_tpu_torch/kernels.py builds and loads it).
//
// seg_segment_kernel (K1) replaces raytracerfacility_tpu/ops/pallas_seg.py:254
// _kernel: one trace+shade segment over SoA path state in device memory,
// updated in place, launched over the live prefix of a reordered pool.
//
// fused_path_kernel (K2) replaces raytracerfacility_tpu/ops/pallas_fused.py:217
// _kernel (Scene lighting): every segment of a ray in one thread, the path
// state in registers, then radiance, first-hit AOVs and a per-block count
// of live ray-segments.
//
// fused_sls_kernel (K2-SLS) replaces the SingleLightSource phase of the same
// TPU kernel (pallas_fused.py:424-639): the camera segment's trace, the sun
// cone sample, an any-hit shadow ray from the hit point (one thread walks
// its own shadow ray right after its closest hit, with its own chunk and
// sub-run culling) and the ambient + sun shade; outputs as K2's.
//
// All are bound by the table rows a ray loads while it traverses (80 bytes
// and about 40 flops per triangle visited, served from L1/L2 when a warp's
// rays visit the same rows). Per-ray chunk and 16-row sub-run culling keeps
// a ray from paying for its neighbours' boxes. Shared-memory staging of
// chunks, warp-level traversal and tensor-core work are left for later.

#include <cuda_runtime.h>

#include "path_common.cuh"

namespace rtf {

__device__ __forceinline__ void store_aov(float* aov, int stride, int i,
                                          const Aov& a) {
  aov[0 * stride + i] = a.nx;
  aov[1 * stride + i] = a.ny;
  aov[2 * stride + i] = a.nz;
  aov[3 * stride + i] = a.ar;
  aov[4 * stride + i] = a.ag;
  aov[5 * stride + i] = a.ab;
  aov[6 * stride + i] = a.px;
  aov[7 * stride + i] = a.py;
  aov[8 * stride + i] = a.pz;
}

// st: (NPLANES, stride) float planes, rng: (stride,) path RNG states, both
// updated in place for rays [0, n). aov: (9, n) planes, written when `first`.
__global__ void __launch_bounds__(kThreads)
seg_segment_kernel(float* __restrict__ st, int* __restrict__ rng,
                   float* __restrict__ aov, Scene s,
                   const float* __restrict__ env, int n, int stride,
                   int first, int has_cont) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Path p;
  p.act = st[ACT * stride + i];
  if (!(p.act > 0.0f)) {  // dead ray: state unchanged, no-hit AOVs
    if (first) {
      Aov a;
      no_hit_aov(a, 0.0f, 0.0f, 0.0f);
      store_aov(aov, n, i, a);
    }
    return;
  }
  p.ox = st[OX * stride + i];
  p.oy = st[OY * stride + i];
  p.oz = st[OZ * stride + i];
  p.dx = st[DX * stride + i];
  p.dy = st[DY * stride + i];
  p.dz = st[DZ * stride + i];
  p.tr = st[TR * stride + i];
  p.tg = st[TG * stride + i];
  p.tb = st[TB * stride + i];
  p.rr = st[RR * stride + i];
  p.rg = st[RG * stride + i];
  p.rb = st[RB * stride + i];
  p.rng = (uint32_t)rng[i];

  Hit h;
  trace(s, p, first ? env[10] : kBounceTMin, h);
  Aov a;
  shade(s, env, p, h, first != 0, has_cont != 0, a);

  st[OX * stride + i] = p.ox;
  st[OY * stride + i] = p.oy;
  st[OZ * stride + i] = p.oz;
  st[DX * stride + i] = p.dx;
  st[DY * stride + i] = p.dy;
  st[DZ * stride + i] = p.dz;
  st[ACT * stride + i] = p.act;
  st[TR * stride + i] = p.tr;
  st[TG * stride + i] = p.tg;
  st[TB * stride + i] = p.tb;
  st[RR * stride + i] = p.rr;
  st[RG * stride + i] = p.rg;
  st[RB * stride + i] = p.rb;
  rng[i] = (int)p.rng;
  if (first) store_aov(aov, n, i, a);
}

// A camera ray of the (7, n) planes: unit throughput, no radiance.
__device__ __forceinline__ void load_camera_ray(const float* rays,
                                                const int* rng, int n, int i,
                                                Path& p) {
  p.ox = rays[0 * n + i];
  p.oy = rays[1 * n + i];
  p.oz = rays[2 * n + i];
  p.dx = rays[3 * n + i];
  p.dy = rays[4 * n + i];
  p.dz = rays[5 * n + i];
  p.act = rays[6 * n + i];
  p.rng = (uint32_t)rng[i];
  p.tr = p.tg = p.tb = 1.0f;
  p.rr = p.rg = p.rb = 0.0f;
}

// counts[blockIdx.x] = the block's sum of `live`: warp sums, then one
// thread adds the warps. Every thread of the block must call it.
__device__ __forceinline__ void block_count(int live, int* counts) {
  for (int off = 16; off > 0; off >>= 1)
    live += __shfl_down_sync(0xffffffffu, live, off);
  __shared__ int warp_live[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_live[threadIdx.x >> 5] = live;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int w = 0; w < kThreads / 32; ++w) sum += warp_live[w];
    counts[blockIdx.x] = sum;
  }
}

// rays: (7, n) planes origin xyz, direction xyz, valid; rng: (n,).
// out: (12, n) planes radiance rgb, normal xyz, albedo rgb, position xyz.
// counts: (gridDim.x,) live ray-segments per block.
__global__ void __launch_bounds__(kThreads)
fused_path_kernel(const float* __restrict__ rays, const int* __restrict__ rng,
                  float* __restrict__ out, int* __restrict__ counts, Scene s,
                  const float* __restrict__ env, int n, int bounces) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int live = 0;
  if (i < n) {
    Path p;
    load_camera_ray(rays, rng, n, i, p);
    Aov a;
    no_hit_aov(a, 0.0f, 0.0f, 0.0f);
    float tmin = env[10];  // camera rays; bounce rays start at 1e-3
    for (int seg = 0; seg <= bounces && p.act > 0.0f; ++seg) {
      ++live;
      Hit h;
      trace(s, p, tmin, h);
      shade(s, env, p, h, seg == 0, seg < bounces, a);
      tmin = kBounceTMin;
    }
    out[0 * n + i] = p.rr;
    out[1 * n + i] = p.rg;
    out[2 * n + i] = p.rb;
    store_aov(out + 3 * n, n, i, a);
  }
  block_count(live, counts);
}

// K2-SLS: as fused_path_kernel, one segment with the SingleLightSource
// shade. rays, rng, out and counts as there.
__global__ void __launch_bounds__(kThreads)
fused_sls_kernel(const float* __restrict__ rays, const int* __restrict__ rng,
                 float* __restrict__ out, int* __restrict__ counts, Scene s,
                 const float* __restrict__ env, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int live = 0;
  if (i < n) {
    Path p;
    load_camera_ray(rays, rng, n, i, p);
    Aov a;
    no_hit_aov(a, 0.0f, 0.0f, 0.0f);
    if (p.act > 0.0f) {
      live = 1;
      Hit h;
      trace(s, p, env[10], h);
      shade_sls(s, env, p, h, a);
    }
    out[0 * n + i] = p.rr;
    out[1 * n + i] = p.rg;
    out[2 * n + i] = p.rb;
    store_aov(out + 3 * n, n, i, a);
  }
  block_count(live, counts);
}

}  // namespace rtf

extern "C" {

int rtf_seg_segment(void* st, void* rng, void* aov, const void* tris,
                    const void* subs, const void* chunks, const void* mats,
                    const void* env, int n, int stride, int nchunks, int chunk,
                    int sub, int first, int has_cont, void* stream) {
  const rtf::Scene s{(const float*)tris, (const float*)subs,
                     (const float*)chunks, (const float*)mats, nchunks, chunk,
                     sub};
  const int blocks = (n + rtf::kThreads - 1) / rtf::kThreads;
  rtf::seg_segment_kernel<<<blocks, rtf::kThreads, 0, (cudaStream_t)stream>>>(
      (float*)st, (int*)rng, (float*)aov, s, (const float*)env, n, stride,
      first, has_cont);
  return (int)cudaGetLastError();
}

int rtf_fused_path(const void* rays, const void* rng, void* out, void* counts,
                   const void* tris, const void* subs, const void* chunks,
                   const void* mats, const void* env, int n, int nchunks,
                   int chunk, int sub, int bounces, void* stream) {
  const rtf::Scene s{(const float*)tris, (const float*)subs,
                     (const float*)chunks, (const float*)mats, nchunks, chunk,
                     sub};
  const int blocks = (n + rtf::kThreads - 1) / rtf::kThreads;
  rtf::fused_path_kernel<<<blocks, rtf::kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)rays, (const int*)rng, (float*)out, (int*)counts, s,
      (const float*)env, n, bounces);
  return (int)cudaGetLastError();
}

int rtf_fused_sls(const void* rays, const void* rng, void* out, void* counts,
                  const void* tris, const void* subs, const void* chunks,
                  const void* mats, const void* env, int n, int nchunks,
                  int chunk, int sub, void* stream) {
  const rtf::Scene s{(const float*)tris, (const float*)subs,
                     (const float*)chunks, (const float*)mats, nchunks, chunk,
                     sub};
  const int blocks = (n + rtf::kThreads - 1) / rtf::kThreads;
  rtf::fused_sls_kernel<<<blocks, rtf::kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)rays, (const int*)rng, (float*)out, (int*)counts, s,
      (const float*)env, n);
  return (int)cudaGetLastError();
}

const char* rtf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
