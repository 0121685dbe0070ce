// The wavefront trace kernel K3 with a plain C interface for ctypes
// (raytracerfacility_tpu_torch/kernels.py builds and loads it;
// ops/brute.py::trace_planes launches it).
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
// 55 operations a triangle, 137 a curve segment (a quadratic for the cone
// body and two sphere caps), and a warp pays for the union of its lanes'
// rows. The sweep is sweep.cuh's: the warp visits the 256-row chunks its
// lanes enter front to back by their least entry, so near hits cull the
// far chunks and 32-row runs for the whole warp, as the TPU kernel's
// per-tile chunk order does; ballots skip what no lane enters; a run few
// lanes enter is tested as (ray, row) pairs over the whole warp; rows load
// as three float4. Runs are kind-homogeneous, so the test is chosen once
// per run. An any-hit lane leaves the sweep at its first accepted row. Launched
// over the live prefix of the wavefront engine's compacted pool, reading
// its state planes in place.

#include <cuda_runtime.h>

#include "path_common.cuh"
#include "sweep.cuh"

namespace rtf {

constexpr int kBruteCols = 12;  // v0 e1 e2 | orig id | kind | pad
constexpr float kDead = -3.0e38f;

struct TraceTable {
  const float* rows;    // (rows, kBruteCols)
  const float* subs;    // (rows / sub, kBox), column 6 the run's kind
  const float* chunks;  // (>= nchunks, kBox)
  int nchunks, chunk, sub;
};

// The best hit of a K3 lane: closest keeps the lexicographic (t, id)
// minimum in (tmin, tmax); any-hit stops at the first accept with
// t = kDead, as the TPU kernel poisons its best t.
struct BruteBest {
  float t, id, u, v;
};

// K3's rows: 12 columns, three float4 a row; a run of kind >= 0.5 holds
// curve segments (pad rows carry r0 = -1, which the guard rejects).
struct BruteRows {
  const float* rows;
  using Best = BruteBest;
  static constexpr bool kSkipInverted = false;
  static constexpr bool kChunkGroups = false;
  __device__ static float id(const BruteBest& b) { return b.id; }
  __device__ __forceinline__ bool probe(int row, float kind, const SweepRay& r,
                                        float& t, float& u, float& v,
                                        float& jf) const {
    float f[kBruteCols];
    load_row(rows + (size_t)row * kBruteCols, f);
    jf = f[9];
    v = 0.0f;
    return kind >= 0.5f
               ? curve_test(f, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, r.tmin, t, u) &&
                     f[6] >= 0.0f
               : tri_test(f, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, r.tmin, t, u, v);
  }
  template <bool kAnyHit>
  __device__ __forceinline__ void take(int, float t, float u, float v,
                                       float jf, BruteBest& b) const {
    b.id = jf;
    if (kAnyHit) {
      b.t = kDead;
    } else {
      b.t = t;
      b.u = u;
      b.v = v;
    }
  }
};

// planes o/d/tmin/tmax: (n,) each; out: (4, n) planes t, prim, u, v
// (t = tmax and prim = -1 on a miss). A lane whose window is empty
// (tmax <= tmin, DEAD among them) cannot hit and takes no part in the
// sweep. stats: (kStatPlanes, n) and warp_rows: (2, ceil(n / 32)), row
// then run iterations a warp, written with kStats. Dynamic shared memory:
// sweep_smem(s.nchunks).
// Blocks an SM holds: 8 caps a thread at 64 registers. The sweep's two
// instantiations (warp_sweep) took the closest hit to 70 registers and 7
// blocks uncapped, 6% slower on config 7 than the one sweep's 63. The
// sweep culls every run of a visited chunk (kRunPairs false, ops/brute.py
// RUN_PAIRS): with the run pairs config 7's closest hit and shadow rays
// ran no faster (K3 any-hit 2% slower) on an H100.
constexpr int kBruteBlocks = 8;

template <bool kAnyHit, bool kStats>
__global__ void __launch_bounds__(kThreads, kBruteBlocks)
brute_trace_kernel(const float* __restrict__ ox, const float* __restrict__ oy,
                   const float* __restrict__ oz, const float* __restrict__ dx,
                   const float* __restrict__ dy, const float* __restrict__ dz,
                   const float* __restrict__ tmin,
                   const float* __restrict__ tmax, float* __restrict__ out,
                   TraceTable s, int n, int* __restrict__ stats,
                   int* __restrict__ warp_rows) {
  extern __shared__ uint32_t sweep_lists[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < n;
  const float t0 = in ? tmin[i] : 0.0f;
  BruteBest b{in ? tmax[i] : kDead, -1.0f, 0.0f, 0.0f};
  const SweepRay ray = make_ray(in ? ox[i] : 0.0f, in ? oy[i] : 0.0f,
                                in ? oz[i] : 0.0f, in ? dx[i] : 0.0f,
                                in ? dy[i] : 0.0f, in ? dz[i] : 0.0f, t0);
  SweepStats ss = {};
  const Boxes bx{s.subs, s.chunks, s.nchunks, s.chunk / s.sub, s.sub};
  warp_sweep<BruteRows, kAnyHit, kStats, true, /*kRunPairs=*/false>(
      BruteRows{s.rows}, bx, ray, in && b.t > t0, b,
      sweep_lists + (threadIdx.x >> 5) * sweep_list(s.nchunks), ss);
  if (!in) return;  // after the last warp operation
  if (kStats) store_stats(ss, stats, warp_rows, n, i);
  out[0 * n + i] = b.t;
  out[1 * n + i] = b.id;
  out[2 * n + i] = b.u;
  out[3 * n + i] = b.v;
}

template <bool kAnyHit, bool kStats>
int launch_brute(const float* const* planes, float* out, const TraceTable& s,
                 int n, int* stats, int* warp_rows, cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  const size_t smem = sweep_smem(s.nchunks);
  auto kernel = brute_trace_kernel<kAnyHit, kStats>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, kThreads, smem, stream>>>(
      planes[0], planes[1], planes[2], planes[3], planes[4], planes[5],
      planes[6], planes[7], out, s, n, stats, warp_rows);
  return (int)cudaGetLastError();
}

}  // namespace rtf

extern "C" {

int rtf_brute_trace(const void* ox, const void* oy, const void* oz,
                    const void* dx, const void* dy, const void* dz,
                    const void* tmin, const void* tmax, void* out,
                    const void* rows, const void* subs, const void* chunks,
                    void* stats, void* warp_rows, int n, int nchunks,
                    int chunk, int sub, int any_hit, void* stream) {
  const rtf::TraceTable s{(const float*)rows, (const float*)subs,
                          (const float*)chunks, nchunks, chunk, sub};
  const float* planes[8] = {(const float*)ox, (const float*)oy,
                            (const float*)oz, (const float*)dx,
                            (const float*)dy, (const float*)dz,
                            (const float*)tmin, (const float*)tmax};
  int* st = (int*)stats;
  int* wr = (int*)warp_rows;
  cudaStream_t q = (cudaStream_t)stream;
  if (any_hit)
    return st ? rtf::launch_brute<true, true>(planes, (float*)out, s, n, st, wr, q)
              : rtf::launch_brute<true, false>(planes, (float*)out, s, n, st, wr, q);
  return st ? rtf::launch_brute<false, true>(planes, (float*)out, s, n, st, wr, q)
            : rtf::launch_brute<false, false>(planes, (float*)out, s, n, st, wr, q);
}

const char* rtf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
