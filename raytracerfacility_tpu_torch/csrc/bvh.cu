// The LBVH walker K5, one thread per ray, with a plain C interface for
// ctypes (raytracerfacility_tpu_torch/kernels.py builds and loads it;
// ops/traverse.py::trace_planes launches it).
//
// bvh_trace_kernel<any_hit> replaces raytracerfacility_tpu/ops/
// pallas_trace.py:61 _traversal_kernel: closest hit (t, prim, u, v), or the
// first accepted hit of an occlusion query, of rays walking the threaded
// preorder LBVH of ops/bvh.py. It computes what the reference's XLA walker
// (ops/traverse.py trace_closest_bvh / trace_any_bvh) computes, node for
// node: box hit on an internal node -> node + 1, else -> skip[node]; a
// leaf tests its rows in order; ties in t go to the lowest original prim;
// at most kMaxSteps node visits a ray. The TPU kernel's one-hot MXU
// gathers, 512-ray blocks, 4,096-step cap and float-encoded metadata are
// artefacts of Mosaic and are not carried over: a thread loads its own
// node and rows.
//
// Bound on this card by dependent node loads: each step's 32-byte node
// depends on the previous step's box test and skip link, and on a
// 1M-primitive scene the 66 MB node table does not fit the 50 MB L2, so a
// warp waits on memory latency. Rays of a warp also diverge in how many
// steps they take. This first kernel keeps the walk stackless (no local
// memory, few registers, so many warps hide the latency), loads a node as
// two float4 and a row as three, and stops each thread on its own. A
// wider BVH, node prefetch and warp-coherent ray order are later work.
// Built with -fmad=false so it equals the plain version bit for bit.

#include <cuda_runtime.h>

#include "path_common.cuh"

namespace rtf {

constexpr int kIntBias = 0x40000000;  // ops/bvh.py INT_BIAS
constexpr int kStartMask = (1 << 27) - 1;
constexpr int kMaxSteps = 8192;  // ops/traverse.py MAX_STEPS

__device__ __forceinline__ int decode_int(float f) {
  return __float_as_int(f) & (kIntBias - 1);
}

// nodes: (M, 8) float32 as 2M float4; tris: (N, 12) float32 as 3N float4.
// planes o/d/tmin/tmax: (n,) each; out: (3, n) planes t, u, v (t = tmax,
// u = v = 0 on a miss); prim: (n,) original prim, -1 on a miss; stats:
// (2, n) node visits and rows tested, or null (a render's launch) to skip.
template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
bvh_trace_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                 const float* __restrict__ oz, const float* __restrict__ dx,
                 const float* __restrict__ dy, const float* __restrict__ dz,
                 const float* __restrict__ tmin,
                 const float* __restrict__ tmax,
                 const float4* __restrict__ nodes,
                 const float4* __restrict__ tris, float* __restrict__ out,
                 int* __restrict__ prim, int* __restrict__ stats, int n,
                 int num_nodes, bool curves) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float rox = ox[i], roy = oy[i], roz = oz[i];
  const float rdx = dx[i], rdy = dy[i], rdz = dz[i];
  const float t_lo = tmin[i], t_hi = tmax[i];
  const float ivx = inv_dir(rdx), ivy = inv_dir(rdy), ivz = inv_dir(rdz);
  float bt = t_hi, bu = 0.0f, bv = 0.0f;
  int bp = -1, node = 0, steps = 0, tests = 0;
  while (node < num_nodes && steps < kMaxSteps) {
    ++steps;
    const float4 lo = __ldg(nodes + 2 * (size_t)node);
    const float4 hi = __ldg(nodes + 2 * (size_t)node + 1);
    // row: box min (lo.x, lo.y, lo.z), box max (lo.w, hi.x, hi.y), skip
    // link hi.z, leaf meta hi.w
    const float t1x = (lo.x - rox) * ivx;
    const float t2x = (lo.w - rox) * ivx;
    const float t1y = (lo.y - roy) * ivy;
    const float t2y = (hi.x - roy) * ivy;
    const float t1z = (lo.z - roz) * ivz;
    const float t2z = (hi.y - roz) * ivz;
    const float near = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                             fminf(t1z, t2z));
    const float far = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                            fmaxf(t1z, t2z));
    const bool box = fmaxf(near, t_lo) <= fminf(far, kAnyHit ? t_hi : bt);
    const int meta = decode_int(hi.w);
    const int count = meta >> 27;
    if (box && count == 0) {  // internal node entered: descend
      ++node;
      continue;
    }
    if (box) {  // leaf entered: its rows in order
      const float4* r = tris + 3 * (size_t)(meta & kStartMask);
      for (int k = 0; k < count; ++k, r += 3) {
        const float4 a = __ldg(r), b = __ldg(r + 1), c = __ldg(r + 2);
        const float row[12] = {a.x, a.y, a.z, a.w, b.x, b.y,
                               b.z, b.w, c.x, c.y, c.z, c.w};
        float t, u, v = 0.0f;
        ++tests;
        const bool ok =
            curves && decode_int(c.w) == 1
                ? curve_test(row, rox, roy, roz, rdx, rdy, rdz, t_lo, t, u)
                : tri_test(row, rox, roy, roz, rdx, rdy, rdz, t_lo, t, u, v);
        const int p = decode_int(c.y);
        if (kAnyHit ? ok && t < t_hi
                    : ok && (t < bt || (t == bt && p < bp))) {
          bt = t;
          bu = u;
          bv = v;
          bp = p;
          if (kAnyHit) break;
        }
      }
      if (kAnyHit && bp >= 0) break;
    }
    node = decode_int(hi.z);  // skip link
  }
  out[i] = bt;
  out[n + i] = bu;
  out[2 * n + i] = bv;
  prim[i] = bp;
  if (stats != nullptr) {
    stats[i] = steps;
    stats[n + i] = tests;
  }
}

}  // namespace rtf

extern "C" {

int rtf_bvh_trace(const void* ox, const void* oy, const void* oz,
                  const void* dx, const void* dy, const void* dz,
                  const void* tmin, const void* tmax, const void* nodes,
                  const void* tris, void* out, void* prim, void* stats, int n,
                  int num_nodes, int curves, int any_hit, void* stream) {
  const int blocks = (n + rtf::kThreads - 1) / rtf::kThreads;
  auto launch = any_hit ? rtf::bvh_trace_kernel<true>
                        : rtf::bvh_trace_kernel<false>;
  launch<<<blocks, rtf::kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)ox, (const float*)oy, (const float*)oz, (const float*)dx,
      (const float*)dy, (const float*)dz, (const float*)tmin,
      (const float*)tmax, (const float4*)nodes, (const float4*)tris,
      (float*)out, (int*)prim, (int*)stats, n, num_nodes, curves != 0);
  return (int)cudaGetLastError();
}

const char* rtf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
