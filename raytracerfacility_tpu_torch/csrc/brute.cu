// The wavefront trace kernel K3, one thread per ray, with a plain C
// interface for ctypes (raytracerfacility_tpu_torch/kernels.py builds and
// loads it; ops/brute.py::trace_planes launches it).
//
// brute_trace_kernel<any_hit> replaces raytracerfacility_tpu/ops/
// pallas_brute.py:201 _make_kernel(any_hit): closest hit (t, prim, u, v) or
// any-hit occlusion of rays against the Morton-packed 12-column table of
// triangles (kind 0) and sphere-swept linear curve segments (kind 1), with
// chunk and sub-run box culling. Ties go to the lowest original primitive
// id (column 9), so the closest hit is the lexicographic (t, id) minimum in
// any visit order.
//
// Bound on this card by the rows each ray tests after culling: 48 bytes and
// about 40 flops a triangle, about 90 a curve segment (a quadratic for the
// cone body and two sphere caps). The rows a warp's rays share come from
// L1/L2 (config 7's table is 233 KB). Each thread culls with its own best t
// against the 256-row chunk and 32-row run boxes, first the chunk, so a
// ray pays only for the runs its own slab enters (the TPU kernel culls per
// 8192-ray tile in a prefetched chunk order, which a per-ray cull makes
// unnecessary). Runs are kind-homogeneous, so the test is chosen once per
// run, not per row. Any-hit returns at the first accepted row. Launched
// over the live prefix of the wavefront engine's compacted pool, reading
// its state planes in place.

#include <cuda_runtime.h>

#include "path_common.cuh"

namespace rtf {

constexpr int kBruteCols = 12;  // v0 e1 e2 | orig id | kind | pad
constexpr float kDead = -3.0e38f;

struct TraceTable {
  const float* rows;    // (rows, kBruteCols)
  const float* subs;    // (rows / sub, kBox), column 6 the run's kind
  const float* chunks;  // (>= nchunks, kBox)
  int nchunks, chunk, sub;
};

// One ray's sweep over the table. Closest hit keeps the lexicographic
// (t, id) minimum in (tmin, tmax); any-hit returns at the first accept
// with t = kDead, as the TPU kernel poisons its best t.
template <bool kAnyHit>
__device__ __forceinline__ void sweep(const TraceTable& s, float ox, float oy,
                                      float oz, float dx, float dy, float dz,
                                      float tmin, float& bt, float& bid,
                                      float& bu, float& bv) {
  const float ivx = inv_dir(dx), ivy = inv_dir(dy), ivz = inv_dir(dz);
  const int runs = s.chunk / s.sub;
  for (int c = 0; c < s.nchunks; ++c) {
    if (!slab(s.chunks + c * kBox, ox, oy, oz, ivx, ivy, ivz, tmin, bt))
      continue;
    for (int r = c * runs; r < (c + 1) * runs; ++r) {
      const float* box = s.subs + r * kBox;
      if (!slab(box, ox, oy, oz, ivx, ivy, ivz, tmin, bt)) continue;
      const bool curves = box[6] >= 0.5f;
      const float* row = s.rows + (size_t)r * s.sub * kBruteCols;
      for (int k = 0; k < s.sub; ++k, row += kBruteCols) {
        float t, u, v = 0.0f;
        const bool ok =
            curves ? curve_test(row, ox, oy, oz, dx, dy, dz, tmin, t, u) &&
                         row[6] >= 0.0f  // curve pad rows carry r0 = -1
                   : tri_test(row, ox, oy, oz, dx, dy, dz, tmin, t, u, v);
        const float jf = row[9];
        if (ok && (t < bt || (t == bt && jf < bid))) {
          bid = jf;
          if (kAnyHit) {
            bt = kDead;
            return;
          }
          bt = t;
          bu = u;
          bv = v;
        }
      }
    }
  }
}

// planes o/d/tmin/tmax: (n,) each; out: (4, n) planes t, prim, u, v
// (t = tmax and prim = -1 on a miss).
template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
brute_trace_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                   const float* __restrict__ oz, const float* __restrict__ dx,
                   const float* __restrict__ dy, const float* __restrict__ dz,
                   const float* __restrict__ tmin,
                   const float* __restrict__ tmax, float* __restrict__ out,
                   TraceTable s, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float bt = tmax[i], bid = -1.0f, bu = 0.0f, bv = 0.0f;
  sweep<kAnyHit>(s, ox[i], oy[i], oz[i], dx[i], dy[i], dz[i], tmin[i], bt, bid,
                 bu, bv);
  out[0 * n + i] = bt;
  out[1 * n + i] = bid;
  out[2 * n + i] = bu;
  out[3 * n + i] = bv;
}

}  // namespace rtf

extern "C" {

int rtf_brute_trace(const void* ox, const void* oy, const void* oz,
                    const void* dx, const void* dy, const void* dz,
                    const void* tmin, const void* tmax, void* out,
                    const void* rows, const void* subs, const void* chunks,
                    int n, int nchunks, int chunk, int sub, int any_hit,
                    void* stream) {
  const rtf::TraceTable s{(const float*)rows, (const float*)subs,
                          (const float*)chunks, nchunks, chunk, sub};
  const int blocks = (n + rtf::kThreads - 1) / rtf::kThreads;
  auto launch = any_hit ? rtf::brute_trace_kernel<true>
                        : rtf::brute_trace_kernel<false>;
  launch<<<blocks, rtf::kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)ox, (const float*)oy, (const float*)oz, (const float*)dx,
      (const float*)dy, (const float*)dz, (const float*)tmin,
      (const float*)tmax, (float*)out, s, n);
  return (int)cudaGetLastError();
}

const char* rtf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
