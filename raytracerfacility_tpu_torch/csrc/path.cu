// The camera path kernels with a plain C interface for ctypes
// (raytracerfacility_tpu_torch/kernels.py builds and loads it).
//
// seg_segment_kernel (K1) replaces raytracerfacility_tpu/ops/pallas_seg.py:254
// _kernel: one trace+shade segment over SoA path state in device memory,
// updated in place, launched over the live prefix of a reordered pool. Its
// trace is the warp's front-to-back sweep of sweep.cuh: the keys of the
// chunks the warp enters, then visits in key order with per-lane chunk and
// 16-row sub-run culls against each lane's own best t, ballot skips of
// what no lane enters, (ray, row) pairs over the warp for runs few lanes
// enter, and rows read as float4. A dead ray (or a lane
// past n) takes part in the warp's sweep with nothing entered and leaves
// its state untouched. Its kMissPlane instantiation is the TPU kernel's
// xla_env form (pallas_seg.py:258): a miss adds no flat radiance, its
// segment-0 albedo stays 0 and a miss plane is written, for the miss hook
// (ops/seg.py, csrc/env.cu) to add a cubemap or the Nishita sky.
//
// fused_path_kernel (K2) replaces raytracerfacility_tpu/ops/pallas_fused.py:217
// _kernel (Scene lighting): every segment of a ray in one thread, the path
// state in registers, then radiance, first-hit AOVs and a per-block count
// of live ray-segments. Each segment is one warp_sweep over the 20-column
// table, so a warp's bounce rays, which scatter, share its chunk order,
// ballots and (ray, row) pairs as K1's do; the warp runs segments while
// any of its lanes is live, and a finished path idles in its warp (no
// reorder inside the kernel).
//
// fused_sls_kernel (K2-SLS) replaces the SingleLightSource phase of the same
// TPU kernel (pallas_fused.py:424-639): the camera segment's closest-hit
// warp_sweep, the sun cone sample, then an any-hit warp_sweep of the shadow
// rays from the hit points in chunk index order (lanes that missed or face
// away from the sun take part and enter nothing), and the ambient + sun
// shade; outputs as K2's.
//
// All are bound by the table rows a ray tests while it traverses (80 bytes
// and about 55 operations per triangle), and a warp pays for the union of
// its rays' rows: the warp order lets near hits cull the far chunks for
// the whole warp.

#include <cuda_runtime.h>

#include "path_common.cuh"
#include "sweep.cuh"

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

// K1's rows: the 20-column triangle table. A test reads the first three
// float4 (v0, e1, e2, id, n0.xy); the normal and material columns are
// read only for an accepted row.
struct TriRows20 {
  const float* rows;
  using Best = Hit;
  static constexpr bool kSkipInverted = false;
  static constexpr bool kChunkGroups = false;
  __device__ static float id(const Hit& h) { return h.pid; }
  __device__ __forceinline__ bool probe(int row, float, const SweepRay& r,
                                        float& t, float& u, float& v,
                                        float& jf) const {
    float f[12];
    load_row(rows + (size_t)row * kCols, f);
    jf = f[9];
    return tri_test(f, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, r.tmin, t, u, v);
  }
  template <bool kAnyHit>
  __device__ __forceinline__ void take(int row, float t, float u, float v,
                                       float jf, Hit& h) const {
    float g[12];  // columns 8-19: e2.z, id, n0, dn1, dn2, material
    load_row(rows + (size_t)row * kCols + 8, g);
    h.t = t;
    h.nx = g[2] + u * g[5] + v * g[8];
    h.ny = g[3] + u * g[6] + v * g[9];
    h.nz = g[4] + u * g[7] + v * g[10];
    h.mid = g[11];
    h.pid = jf;
  }
};

// K2-SLS's shadow rows: the same table, tested as TriRows20 tests it; an
// accept records only the occluder's id. A lane starts at t = kTMax with
// id -1, which no row's id (>= 0) is below, so a row accepts iff its t <
// kTMax (the reference's shadow window, pallas_fused.py:494-573). The
// padded cull (near - |near| / 512 <= kTMax) enters every box a strict
// near < kTMax would and maybe more, which only adds row tests: an
// any-hit answer depends on no visit order, so it does not change. The
// sweep visits the chunks in index order without keys: near first tested
// as many rows a 1080p shadow ray (chip_smoke.py's counters), so its keys
// only cost time.
struct ShadowRows {
  const float* rows;
  struct Best {
    float t, id;  // id >= 0 once a row occludes
  };
  static constexpr bool kSkipInverted = false;
  static constexpr bool kChunkGroups = false;
  __device__ static float id(const Best& b) { return b.id; }
  __device__ __forceinline__ bool probe(int row, float kind, const SweepRay& r,
                                        float& t, float& u, float& v,
                                        float& jf) const {
    return TriRows20{rows}.probe(row, kind, r, t, u, v, jf);
  }
  template <bool kAnyHit>
  __device__ __forceinline__ void take(int, float, float, float, float jf,
                                       Best& b) const {
    b.id = jf;
  }
};

// st: (NPLANES, stride) float planes, rng: (stride,) path RNG states, both
// updated in place for rays [0, n). aov: (9, n) planes, written when `first`.
// stats: (kStatPlanes, n) and warp_rows: (2, ceil(n / 32)), row then run
// iterations a warp, written with kStats. kMissPlane: the miss-plane form
// (ref pallas_seg.py:258 xla_env), which adds no flat radiance on a miss
// and writes miss: (n,), 1 for a live ray that missed, else 0. Dynamic
// shared memory: sweep_smem(s.nchunks).
template <bool kStats, bool kMissPlane>
__global__ void __launch_bounds__(kThreads)
seg_segment_kernel(float* __restrict__ st, int* __restrict__ rng,
                   float* __restrict__ aov, float* __restrict__ miss, Scene s,
                   const float* __restrict__ env, int n, int stride,
                   int first, int has_cont, int* __restrict__ stats,
                   int* __restrict__ warp_rows) {
  extern __shared__ uint32_t sweep_lists[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  Path p;
  p.act = i < n ? st[ACT * stride + i] : 0.0f;
  const bool live = p.act > 0.0f;
  p.ox = p.oy = p.oz = p.dx = p.dy = p.dz = 0.0f;
  if (live) {
    p.ox = st[OX * stride + i];
    p.oy = st[OY * stride + i];
    p.oz = st[OZ * stride + i];
    p.dx = st[DX * stride + i];
    p.dy = st[DY * stride + i];
    p.dz = st[DZ * stride + i];
  }
  Hit h;
  h.t = kTMax;
  h.nx = h.ny = h.nz = 0.0f;
  h.mid = 0.0f;
  h.pid = kNoId;
  SweepStats ss = {};
  const SweepRay ray = make_ray(p.ox, p.oy, p.oz, p.dx, p.dy, p.dz,
                                first ? env[10] : kBounceTMin);
  const Boxes bx{s.subs, s.chunks, s.nchunks, s.chunk / s.sub, s.sub};
  warp_sweep<TriRows20, false, kStats>(
      TriRows20{s.tris}, bx, ray, live, h,
      sweep_lists + (threadIdx.x >> 5) * sweep_list(s.nchunks), ss);
  if (i >= n) return;  // after the last warp operation
  if (kStats) store_stats(ss, stats, warp_rows, n, i);
  if (!live) {  // dead ray: state unchanged, no-hit AOVs
    if (kMissPlane) miss[i] = 0.0f;
    if (first) {
      Aov a;
      no_hit_aov(a, 0.0f, 0.0f, 0.0f);
      store_aov(aov, n, i, a);
    }
    return;
  }
  p.tr = st[TR * stride + i];
  p.tg = st[TG * stride + i];
  p.tb = st[TB * stride + i];
  p.rr = st[RR * stride + i];
  p.rg = st[RG * stride + i];
  p.rb = st[RB * stride + i];
  p.rng = (uint32_t)rng[i];

  Aov a;
  shade<kMissPlane>(s, env, p, h, first != 0, has_cont != 0, a);
  if (kMissPlane) miss[i] = h.t < kHitMax ? 0.0f : 1.0f;

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

// A camera ray of the (7, n) planes: unit throughput, no radiance; a lane
// past n gets a dead ray of zeros.
__device__ __forceinline__ void load_camera_ray(const float* rays,
                                                const int* rng, int n, int i,
                                                Path& p) {
  const bool in = i < n;
  p.ox = in ? rays[0 * n + i] : 0.0f;
  p.oy = in ? rays[1 * n + i] : 0.0f;
  p.oz = in ? rays[2 * n + i] : 0.0f;
  p.dx = in ? rays[3 * n + i] : 0.0f;
  p.dy = in ? rays[4 * n + i] : 0.0f;
  p.dz = in ? rays[5 * n + i] : 0.0f;
  p.act = in ? rays[6 * n + i] : 0.0f;
  p.rng = in ? (uint32_t)rng[i] : 0u;
  p.tr = p.tg = p.tb = 1.0f;
  p.rr = p.rg = p.rb = 0.0f;
}

__device__ __forceinline__ void no_hit(Hit& h) {
  h.t = kTMax;
  h.nx = h.ny = h.nz = 0.0f;
  h.mid = 0.0f;
  h.pid = kNoId;
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

__device__ __forceinline__ void store_out(float* out, int n, int i,
                                          const Path& p, const Aov& a) {
  out[0 * n + i] = p.rr;
  out[1 * n + i] = p.rg;
  out[2 * n + i] = p.rb;
  store_aov(out + 3 * n, n, i, a);
}

// Blocks an SM holds, which caps the registers: on an H100, at chip_smoke.py's
// pools (time_sweeps.py --alternate), 8 blocks (64 registers) ran K2 faster
// than the 72 registers ptxas picks, and 10 blocks (48 registers, with
// spills) K2-SLS faster than its 64: occupancy hides the trace's latency.
// K2-SLS's sweeps cull every run of a visited chunk (kRunPairs false,
// ops/fused.py SLS_RUN_PAIRS): under its 48 registers the run pairs'
// spills made its first 1080p launch 4-11% slower.
constexpr int kPathBlocks = 8;
constexpr int kSlsBlocks = 10;

// rays: (7, n) planes origin xyz, direction xyz, valid; rng: (n,).
// out: (12, n) planes radiance rgb, normal xyz, albedo rgb, position xyz.
// counts: (gridDim.x,) live ray-segments per block. stats: (kStatPlanes,
// n) and warp_rows: (2, ceil(n / 32)), the sweep counters summed over the
// segments, written with kStats. Dynamic shared memory:
// sweep_smem(s.nchunks).
template <bool kStats>
__global__ void __launch_bounds__(kThreads, kPathBlocks)
fused_path_kernel(const float* __restrict__ rays, const int* __restrict__ rng,
                  float* __restrict__ out, int* __restrict__ counts, Scene s,
                  const float* __restrict__ env, int n, int bounces,
                  int* __restrict__ stats, int* __restrict__ warp_rows) {
  extern __shared__ uint32_t sweep_lists[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  Path p;
  load_camera_ray(rays, rng, n, i, p);
  Aov a;
  no_hit_aov(a, 0.0f, 0.0f, 0.0f);
  SweepStats ss = {};
  const Boxes bx{s.subs, s.chunks, s.nchunks, s.chunk / s.sub, s.sub};
  uint32_t* list = sweep_lists + (threadIdx.x >> 5) * sweep_list(s.nchunks);
  int live = 0;
  float tmin = env[10];  // camera rays; bounce rays start at 1e-3
  // every lane of the warp runs the loop (a finished path and a lane past
  // n enter nothing), so the sweep's warp operations see all 32
  for (int seg = 0; seg <= bounces && __any_sync(kFullMask, p.act > 0.0f);
       ++seg) {
    const bool on = p.act > 0.0f;
    live += on;
    Hit h;
    no_hit(h);
    warp_sweep<TriRows20, false, kStats>(
        TriRows20{s.tris}, bx, make_ray(p.ox, p.oy, p.oz, p.dx, p.dy, p.dz, tmin),
        on, h, list, ss);
    if (on) shade(s, env, p, h, seg == 0, seg < bounces, a);
    tmin = kBounceTMin;
  }
  if (i < n) {
    store_out(out, n, i, p, a);
    if (kStats) store_stats(ss, stats, warp_rows, n, i);
  }
  block_count(live, counts);
}

// K2-SLS: as fused_path_kernel, one segment with the SingleLightSource
// shade. rays, rng, out and counts as there; stats: (2, kStatPlanes, n)
// and warp_rows: (2, 2, ceil(n / 32)), the closest-hit sweep's counters,
// then the shadow sweep's.
template <bool kStats>
__global__ void __launch_bounds__(kThreads, kSlsBlocks)
fused_sls_kernel(const float* __restrict__ rays, const int* __restrict__ rng,
                 float* __restrict__ out, int* __restrict__ counts, Scene s,
                 const float* __restrict__ env, int n,
                 int* __restrict__ stats, int* __restrict__ warp_rows) {
  extern __shared__ uint32_t sweep_lists[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  Path p;
  load_camera_ray(rays, rng, n, i, p);
  const bool live = p.act > 0.0f;
  Hit h;
  no_hit(h);
  SweepStats closest = {}, shadow = {};
  const Boxes bx{s.subs, s.chunks, s.nchunks, s.chunk / s.sub, s.sub};
  uint32_t* list = sweep_lists + (threadIdx.x >> 5) * sweep_list(s.nchunks);
  warp_sweep<TriRows20, false, kStats, true, /*kRunPairs=*/false>(
      TriRows20{s.tris}, bx, make_ray(p.ox, p.oy, p.oz, p.dx, p.dy, p.dz, env[10]),
      live, h, list, closest);
  Aov a;
  no_hit_aov(a, 0.0f, 0.0f, 0.0f);
  float sdx = 0.0f, sdy = 0.0f, sdz = 0.0f, ndl = 0.0f;
  const bool cast = live && sls_begin(s, env, p, h, a, sdx, sdy, sdz, ndl);
  ShadowRows::Best b{kTMax, -1.0f};
  warp_sweep<ShadowRows, true, kStats, /*kKeyed=*/false, /*kRunPairs=*/false>(
      ShadowRows{s.tris}, bx, make_ray(a.px, a.py, a.pz, sdx, sdy, sdz, kBounceTMin),
      cast, b, list, shadow);
  if (cast && b.id < 0.0f) sls_sun(env, p, a, ndl);
  if (i < n) {
    store_out(out, n, i, p, a);
    if (kStats) {
      store_stats(closest, stats, warp_rows, n, i);
      store_stats(shadow, stats + kStatPlanes * n, warp_rows + 2 * ((n + 31) / 32), n,
                  i);
    }
  }
  block_count(live, counts);
}

}  // namespace rtf

extern "C" {

int rtf_seg_segment(void* st, void* rng, void* aov, void* miss,
                    const void* tris, const void* subs, const void* chunks,
                    const void* mats, const void* env, void* stats,
                    void* warp_rows, int n, int stride, int nchunks, int chunk,
                    int sub, int first, int has_cont, void* stream) {
  const rtf::Scene s{(const float*)tris, (const float*)subs,
                     (const float*)chunks, (const float*)mats, nchunks, chunk,
                     sub};
  const int blocks = (n + rtf::kThreads - 1) / rtf::kThreads;
  const size_t smem = rtf::sweep_smem(nchunks);
  auto launch = stats ? (miss ? rtf::seg_segment_kernel<true, true>
                              : rtf::seg_segment_kernel<true, false>)
                      : (miss ? rtf::seg_segment_kernel<false, true>
                              : rtf::seg_segment_kernel<false, false>);
  const cudaError_t err = rtf::allow_smem(launch, smem);
  if (err != cudaSuccess) return (int)err;
  launch<<<blocks, rtf::kThreads, smem, (cudaStream_t)stream>>>(
      (float*)st, (int*)rng, (float*)aov, (float*)miss, s, (const float*)env,
      n, stride, first, has_cont, (int*)stats, (int*)warp_rows);
  return (int)cudaGetLastError();
}

int rtf_fused_path(const void* rays, const void* rng, void* out, void* counts,
                   const void* tris, const void* subs, const void* chunks,
                   const void* mats, const void* env, void* stats,
                   void* warp_rows, int n, int nchunks, int chunk, int sub,
                   int bounces, void* stream) {
  const rtf::Scene s{(const float*)tris, (const float*)subs,
                     (const float*)chunks, (const float*)mats, nchunks, chunk,
                     sub};
  const int blocks = (n + rtf::kThreads - 1) / rtf::kThreads;
  const size_t smem = rtf::sweep_smem(nchunks);
  auto launch = stats ? rtf::fused_path_kernel<true>
                      : rtf::fused_path_kernel<false>;
  const cudaError_t err = rtf::allow_smem(launch, smem);
  if (err != cudaSuccess) return (int)err;
  launch<<<blocks, rtf::kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)rays, (const int*)rng, (float*)out, (int*)counts, s,
      (const float*)env, n, bounces, (int*)stats, (int*)warp_rows);
  return (int)cudaGetLastError();
}

int rtf_fused_sls(const void* rays, const void* rng, void* out, void* counts,
                  const void* tris, const void* subs, const void* chunks,
                  const void* mats, const void* env, void* stats,
                  void* warp_rows, int n, int nchunks, int chunk, int sub,
                  void* stream) {
  const rtf::Scene s{(const float*)tris, (const float*)subs,
                     (const float*)chunks, (const float*)mats, nchunks, chunk,
                     sub};
  const int blocks = (n + rtf::kThreads - 1) / rtf::kThreads;
  const size_t smem = rtf::sweep_smem(nchunks);
  auto launch = stats ? rtf::fused_sls_kernel<true>
                      : rtf::fused_sls_kernel<false>;
  const cudaError_t err = rtf::allow_smem(launch, smem);
  if (err != cudaSuccess) return (int)err;
  launch<<<blocks, rtf::kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)rays, (const int*)rng, (float*)out, (int*)counts, s,
      (const float*)env, n, (int*)stats, (int*)warp_rows);
  return (int)cudaGetLastError();
}

const char* rtf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
