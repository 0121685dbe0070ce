// The shared-geometry instanced trace kernel K4 with a plain C interface
// for ctypes (raytracerfacility_tpu_torch/kernels.py builds and loads it;
// ops/inst.py::trace_planes launches it).
//
// inst_trace_kernel replaces raytracerfacility_tpu/ops/pallas_inst.py:248
// _make_inst_kernel: the closest hit (t, global prim, instance, u, v) of
// world rays against instances of shared object-space geometry. Each
// instance record holds the float32 world->object inverse of its transform
// (A in 0-8, c in 9-11); the ray moves into object space as o' = A.o + c,
// d' = A.d with A unnormalized, so t means the same in both spaces. The
// result is the lexicographic (t, instance, prim) minimum over rows accepted
// in (tmin, tmax), whatever the visit order, so culling only has to be
// conservative.
//
// Bound on this card by the rows each ray tests after culling: 48 bytes and
// about 55 operations a row. The TPU kernel walks a per-tile, front-to-back
// order of (instance, object chunk) steps; here the warp orders its own
// work at two levels, front to back at each, as sweep.cuh does for K1 and
// K3 (ops/inst_sweep.py replays it step for step, counters included):
//
// 1. Instances. The records are visited through inst_perm, their order by
//    the Morton code of their world boxes' centres, and each 32 records in
//    that order have a group box (ops/inst.py pack_instanced_tables). A
//    round keys whole groups while the warp's instance list has room for
//    them: every live lane tests a group's box; in a group some lane
//    enters, the lanes that enter it test each instance's world box, and an
//    instance some lane enters goes to the list as one word, the least
//    entry max(near, tmin) over those lanes above its sorted position.
// 2. Visits. The warp takes the least word left until the list is empty
//    or its key is past every live lane's best t. Each lane re-tests the
//    instance's box against its own best t; the lanes that enter it move
//    their rays into object space and the warp sweeps the geometry's
//    chunks, runs and rows with warp_sweep (sweep.cuh), those lanes live;
//    its keys first cull each 32 chunks by their group box.
//    A tie in t goes to the lower original instance, then the lower prim.
//    Runs of padding rows have inverted boxes and are skipped.
//
// Every cull pads the entry by |near|/512 (sweep.cuh kCullPad): the world
// boxes are float32 hulls of transformed corners. With kStats a lane counts
// group and instance slabs tested, instances entered, and warp_sweep's
// chunk slabs, chunks entered, run slabs, runs entered and rows tested
// over all its instances; lane 0 its warp's row and run iterations.
//
// Numerics as in path_common.cuh: built with -fmad=false, so the transform
// rounds each product and each sum, left to right, as the plain PyTorch
// version and the reference's oracle compute it.

#include <cuda_runtime.h>

#include "path_common.cuh"
#include "sweep.cuh"

namespace rtf {

constexpr int kInstCols = 12;  // v0 e1 e2 | geometry base + original prim | pad
constexpr int kInstRec = 16;   // A (row-major 3x3) | c | pad
constexpr int kGroup = 32;     // records a group box bounds (ops/inst.py GROUP)
// instance list words a warp: a round keys whole groups while they fit
constexpr int kInstCap = 512;  // ops/inst_sweep.py INST_CAP
constexpr int kInstStats = 3 + kStatPlanes;  // ops/inst_sweep.py STATS

struct InstTables {
  const float* rows;    // (rows, kInstCols) object space
  const float* subs;    // (rows / sub, kBox) object-space run boxes
  const float* chunks;  // (>= nchunks, kBox) object-space chunk boxes
  const float* inst;    // (ninst, kInstRec) world->object records
  const float* boxes;   // (ninst, kBox) world boxes
  const int* ranges;    // (ninst, 2) first object chunk, chunk count
  const float* groups;  // (ngroups, kBox) world boxes of 32 sorted records
  const int* perm;      // (ninst,) original record of each sorted position
  const float* cgroups;  // object-space boxes of each 32 chunks of a geometry
  const int* cgroup0;   // (ninst,) the geometry's first row of cgroups
  int ninst, ngroups, chunk, sub;
};

struct InstBest {
  float t, prim, inst, u, v;
};

// One instance's rows for warp_sweep: the geometry's rows from its first
// chunk, and the instance's original id, which ties order first.
struct InstRows {
  const float* rows;
  float kf;
  using Best = InstBest;
  static constexpr bool kSkipInverted = true;
  static constexpr bool kChunkGroups = true;
  __device__ __forceinline__ float id(const InstBest& b) const {
    const float inf = __int_as_float(0x7f800000);
    return b.inst < kf ? -inf : (b.inst > kf ? inf : b.prim);
  }
  __device__ __forceinline__ bool probe(int row, float, const SweepRay& r,
                                        float& t, float& u, float& v,
                                        float& jf) const {
    float f[kInstCols];
    load_row(rows + (size_t)row * kInstCols, f);
    jf = f[9];
    return tri_test(f, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, r.tmin, t, u, v);
  }
  template <bool kAnyHit>
  __device__ __forceinline__ void take(int, float t, float u, float v,
                                       float jf, InstBest& b) const {
    b.t = t;
    b.prim = jf;
    b.inst = kf;
    b.u = u;
    b.v = v;
  }
};

// Words of a warp's instance list.
__host__ __device__ inline int inst_words(int ninst) {
  return ninst < kInstCap ? ninst : kInstCap;
}

// planes o/d/tmin/tmax: (n,) each; out: (5, n) planes t, prim, instance, u,
// v (t = tmax, prim = instance = -1 on a miss); stats: (kInstStats, n) and
// warp_rows: (2, ceil(n / 32)), row then run iterations a warp, written
// with kStats. Dynamic shared memory:
// kThreads / 32 x (inst_words(ninst) + chunk_words) words, chunk_words =
// sweep_list(the most chunks of a geometry). 8 blocks an SM cap a thread
// at 64 registers: the sweep's run pairs took it from 64 to 80 registers
// and 6 blocks, and the canopy's primary rays up to 9% slower on an H100.
template <bool kStats>
__global__ void __launch_bounds__(kThreads, 8)
inst_trace_kernel(const float* __restrict__ pox, const float* __restrict__ poy,
                  const float* __restrict__ poz, const float* __restrict__ pdx,
                  const float* __restrict__ pdy, const float* __restrict__ pdz,
                  const float* __restrict__ ptmin,
                  const float* __restrict__ ptmax, float* __restrict__ out,
                  InstTables s, int n, int chunk_words, int* __restrict__ stats,
                  int* __restrict__ warp_rows) {
  extern __shared__ uint32_t lists[];
  const int lane = threadIdx.x & 31;
  const int iwords = inst_words(s.ninst);
  uint32_t* ilist = lists + (threadIdx.x >> 5) * (iwords + chunk_words);
  uint32_t* clist = ilist + iwords;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < n;
  const float tmin = in ? ptmin[i] : 0.0f;
  const float wox = in ? pox[i] : 0.0f, woy = in ? poy[i] : 0.0f,
              woz = in ? poz[i] : 0.0f;
  const float wdx = in ? pdx[i] : 0.0f, wdy = in ? pdy[i] : 0.0f,
              wdz = in ? pdz[i] : 0.0f;
  const SweepRay wr = make_ray(wox, woy, woz, wdx, wdy, wdz, tmin);
  // best hit; instance -1 so that nothing ties with the initial tmax
  InstBest b{in ? ptmax[i] : 0.0f, -1.0f, -1.0f, 0.0f, 0.0f};
  const bool live = in && b.t > tmin;
  SweepStats ss = {};
  int group_slabs = 0, inst_slabs = 0, inst_in = 0;
  const int runs = s.chunk / s.sub;
  const int bits = s.ninst > 1 ? 32 - __clz(s.ninst - 1) : 0;
  const uint32_t low = (1u << bits) - 1u;
  for (int g0 = 0; g0 < s.ngroups && __any_sync(kFullMask, live);) {
    // 1. keys of the instances the warp enters, whole groups a round
    int count = 0;
    int g = g0;
    for (; g < s.ngroups; ++g) {
      const int first = g * kGroup;
      const int size = min(kGroup, s.ninst - first);
      if (count + size > iwords) break;
      float near;
      const bool in_g = live && slab_pad(s.groups + g * kBox, wr, b.t, near);
      if (kStats && live) ++group_slabs;
      if (!__any_sync(kFullMask, in_g)) continue;
      for (int j = 0; j < size; ++j) {
        const int k = __ldg(s.perm + first + j);
        const bool in_k = in_g && slab_pad(s.boxes + k * kBox, wr, b.t, near);
        if (kStats && in_g) ++inst_slabs;
        if (!__any_sync(kFullMask, in_k)) continue;
        // + 0: a -0 entry keys as +0, whatever fmaxf returns for signed zeros
        const uint32_t key = in_k ? ord_bits(fmaxf(near, tmin) + 0.0f) : kNoWord;
        const uint32_t least = __reduce_min_sync(kFullMask, key);
        if (lane == 0) ilist[count] = ((least >> bits) << bits) | (uint32_t)(first + j);
        ++count;
      }
    }
    g0 = g;
    __syncwarp();
    // 2. visits, least key first
    for (;;) {
      uint32_t mine = kNoWord;
      int at = -1;
      for (int j = lane; j < count; j += 32) {
        const uint32_t w = ilist[j];
        if (w < mine) {
          mine = w;
          at = j;
        }
      }
      const uint32_t word = __reduce_min_sync(kFullMask, mine);
      if (word == kNoWord) break;
      const uint32_t reach = __reduce_max_sync(kFullMask, live ? ord_bits(b.t) : 0u);
      if ((word >> bits) > (reach >> bits)) break;
      if (mine == word) ilist[at] = kNoWord;
      __syncwarp();
      const int k = __ldg(s.perm + (int)(word & low));
      float near;
      const bool in_k = live && slab_pad(s.boxes + k * kBox, wr, b.t, near);
      if (kStats && live) {
        ++inst_slabs;
        inst_in += in_k;
      }
      if (__ballot_sync(kFullMask, in_k) == 0u) continue;
      const float* a = s.inst + k * kInstRec;
      const float ox = a[0] * wox + a[1] * woy + a[2] * woz + a[9];
      const float oy = a[3] * wox + a[4] * woy + a[5] * woz + a[10];
      const float oz = a[6] * wox + a[7] * woy + a[8] * woz + a[11];
      const float dx = a[0] * wdx + a[1] * wdy + a[2] * wdz;
      const float dy = a[3] * wdx + a[4] * wdy + a[5] * wdz;
      const float dz = a[6] * wdx + a[7] * wdy + a[8] * wdz;
      const int c0 = __ldg(s.ranges + 2 * k);
      const Boxes bx{s.subs + (size_t)c0 * runs * kBox, s.chunks + (size_t)c0 * kBox,
                     __ldg(s.ranges + 2 * k + 1), runs, s.sub,
                     s.cgroups + (size_t)__ldg(s.cgroup0 + k) * kBox};
      const InstRows rows{s.rows + (size_t)c0 * s.chunk * kInstCols, (float)k};
      warp_sweep<InstRows, false, kStats>(
          rows, bx, make_ray(ox, oy, oz, dx, dy, dz, tmin), in_k, b, clist, ss);
    }
    __syncwarp();
  }
  if (!in) return;  // after the last warp operation
  if (kStats) {
    stats[i] = group_slabs;
    stats[n + i] = inst_slabs;
    stats[2 * n + i] = inst_in;
    store_stats(ss, stats + 3 * n, warp_rows, n, i);
  }
  out[0 * n + i] = b.t;
  out[1 * n + i] = b.prim;
  out[2 * n + i] = b.inst;
  out[3 * n + i] = b.u;
  out[4 * n + i] = b.v;
}

template <bool kStats>
int launch_inst(const float* const* planes, float* out, const InstTables& s,
                int n, int chunk_words, int* stats, int* warp_rows,
                cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  const size_t smem = (size_t)(kThreads / 32) *
                      (size_t)(inst_words(s.ninst) + chunk_words) * sizeof(uint32_t);
  auto kernel = inst_trace_kernel<kStats>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, kThreads, smem, stream>>>(
      planes[0], planes[1], planes[2], planes[3], planes[4], planes[5],
      planes[6], planes[7], out, s, n, chunk_words, stats, warp_rows);
  return (int)cudaGetLastError();
}

}  // namespace rtf

extern "C" {

// max_chunks: the most object chunks of one geometry (the chunk list).
int rtf_inst_trace(const void* ox, const void* oy, const void* oz,
                   const void* dx, const void* dy, const void* dz,
                   const void* tmin, const void* tmax, void* out,
                   const void* rows, const void* subs, const void* chunks,
                   const void* inst, const void* boxes, const void* ranges,
                   const void* groups, const void* perm, const void* cgroups,
                   const void* cgroup0, void* stats, void* warp_rows, int n,
                   int ninst, int chunk, int sub, int max_chunks, void* stream) {
  const rtf::InstTables s{(const float*)rows,    (const float*)subs,
                          (const float*)chunks,  (const float*)inst,
                          (const float*)boxes,   (const int*)ranges,
                          (const float*)groups,  (const int*)perm,
                          (const float*)cgroups, (const int*)cgroup0,
                          ninst,                 (ninst + rtf::kGroup - 1) / rtf::kGroup,
                          chunk,                 sub};
  const float* planes[8] = {(const float*)ox, (const float*)oy,
                            (const float*)oz, (const float*)dx,
                            (const float*)dy, (const float*)dz,
                            (const float*)tmin, (const float*)tmax};
  const int words = rtf::sweep_list(max_chunks);
  int* st = (int*)stats;
  cudaStream_t q = (cudaStream_t)stream;
  return st ? rtf::launch_inst<true>(planes, (float*)out, s, n, words, st,
                                     (int*)warp_rows, q)
            : rtf::launch_inst<false>(planes, (float*)out, s, n, words, st,
                                      (int*)warp_rows, q);
}

const char* rtf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
