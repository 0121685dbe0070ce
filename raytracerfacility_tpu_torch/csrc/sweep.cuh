// The warp-cooperative front-to-back sweep over a Morton-packed primitive
// table, shared by K1, K2 and K2-SLS (path.cu, 20-column triangle rows), K3
// (brute.cu brute_trace_kernel, 12-column triangle and curve rows) and K4
// (inst.cu inst_trace_kernel, one instance's object-space rows a sweep).
// ops/sweep.py emulates it step for step (order "warp"; K2-SLS's unkeyed
// shadow sweep: order "index" with pairs), counters included.
//
// The TPU kernels these replace (pallas_seg.py:254, pallas_brute.py:201)
// visit a tile's chunks front to back (ops/chunk_order.py), so near hits
// shrink the best t early and the box culls drop most of the far scene.
// Here the warp is the unit that pays for the union of its rays' work, so
// the order is the warp's:
//
// 1. Keys. Every live lane tests the slab of every chunk at its initial
//    best t (a table with chunk-group boxes, K4's, first tests the group's
//    box, and only lanes that enter it test its chunks; a group no lane
//    enters is passed over). A chunk's key is the least entry max(near, tmin) over the
//    lanes that enter it (a warp min on orderable float bits). Entered
//    chunks go to the warp's list in shared memory as one word each: the
//    key's high bits over the chunk index, so an unsigned compare orders
//    by key, then by index.
// 2. Visits. The warp takes the least word left (each lane scans its
//    slice of the list, then a warp min) until the list is empty or the
//    next key is past every live lane's best t. Each lane re-tests the
//    chunk's slab against its own current best t; a chunk, then a run,
//    that no lane enters is skipped by a ballot without touching its
//    rows. Runs and rows each go one lane a ray when many lanes enter,
//    and as pairs spread over the warp when few do:
//    - Runs. When more than kPairLanes lanes enter the chunk, each culls
//      every run of it for its own ray. When fewer do, the warp culls
//      (ray, run) pairs: one lane a run box, 32 / runs rays an iteration
//      (fetched by shuffles), each entering lane keeping its ray's run
//      mask from the ballot; then it visits only the union of the masks,
//      in ascending run order, each lane re-culling its runs at its
//      current best t. An incoherent warp pays ceil(lanes x runs / 32)
//      iterations and the union for a chunk instead of every run. K2-SLS
//      and K3 sweep with kRunPairs false: each lane culls every run.
//    - Rows. When more than kPairLanes lanes enter a run, each tests the
//      run's rows for its own ray; when fewer do, the warp spreads their
//      (ray, row) pairs over all 32 lanes and reduces each ray's rows to
//      its least (t, id), or any-hit to its first accepted row, so it pays
//      ceil(lanes x rows / 32) iterations for a run instead of its rows.
//    Rows load as 16-byte vectors.
//
// Every cull compares near - |near| * kCullPad <= best t (and <= far): a
// grazing sphere-cap hit can round to before its run box's entry (the
// cap's sqrt of a discriminant near 0 turns float32 rounding into up to
// about sqrt(8 eps) |o - p0| = 7e-4 |o - p0| of t), and an unpadded cull
// skipped such a run on 3 config-7 rays. Culling less only adds work; the
// result is the lexicographic (t, original id) minimum over accepted rows
// in any visit order, which a row test decides alone.
//
// The wrappers pass boxes grown by 2^-18 times each box's largest
// |coordinate| along each axis it spans (ops/sweep.py grown_boxes; the
// tables keep the exact ones):
// a row test rounds too, and accepts a hit on a triangle's edge that lies
// outside the triangle by a few units in the last place of the
// coordinates. On a box whose face holds that edge, a ray that leaves the
// face's plane slowly (a bounce ray from the wall beside it, nearly
// parallel to it) exits the exact box at t = 0 and was culled: 1 ray in
// some 1080p segments past the first (4 in the config-2 path's 36
// launches) took the sky where brute force takes the edge of the wall
// ahead, outside it by 8e-9 to 1.3e-7.
//
// A ray parallel to an axis (its inverse held at 1e20 by inv_dir) lies in
// that axis's slab for every t or for none; a LiDAR beam on a box's upper
// face would otherwise leave the box at t = 0 (parallel_slab). A warp that
// holds such a ray sweeps with those slabs closed; the others with the
// plain test (warp_sweep).
//
// With kStats a lane counts chunk slabs tested (group slabs included),
// chunks entered, run slabs tested for its ray (a chunk culled as pairs:
// every run there, and each re-cull), runs entered and rows tested (an
// any-hit lane on its own stops at its accept), and lane 0 the row
// iterations and the run iterations (pair culls and runs visited) its
// warp executed. A lane that is not live (out of range, dead path, empty
// window, or an any-hit lane that has its hit) takes part in every warp
// operation and enters nothing.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "path_common.cuh"

namespace rtf {

constexpr float kCullPad = 1.0f / 512.0f;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr uint32_t kNoWord = 0xffffffffu;
constexpr int kStatPlanes = 5;  // ops/sweep.py STATS
// list words a warp: a table of more chunks is swept in rounds, each
// keying and visiting the next kListCap chunks the warp enters
constexpr int kListCap = 1024;  // ops/sweep.py LIST_CAP
// a run at most this many lanes enter is tested as (ray, row) pairs, and
// a chunk at most this many lanes enter has its runs culled as (ray, run)
// pairs, spread over the warp's lanes instead of one lane a ray
constexpr int kPairLanes = 16;  // ops/sweep.py PAIR_LANES
// chunks a chunk-group box bounds, for tables that have them
constexpr int kChunkGroup = 32;  // ops/sweep.py CHUNK_GROUP
struct SweepRay {
  float ox, oy, oz, dx, dy, dz, ivx, ivy, ivz, tmin;
  bool parallel;  // some axis's inverse is held (parallel_slab)
};

__device__ __forceinline__ SweepRay make_ray(float ox, float oy, float oz,
                                             float dx, float dy, float dz,
                                             float tmin) {
  const float ivx = inv_dir(dx), ivy = inv_dir(dy), ivz = inv_dir(dz);
  return SweepRay{ox, oy, oz, dx, dy, dz, ivx, ivy, ivz, tmin,
                  any_parallel(ivx, ivy, ivz)};
}

// Unsigned bits of x that order as the floats do (x not NaN).
__device__ __forceinline__ uint32_t ord_bits(float x) {
  const uint32_t b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// Padded slab test of box row b (lo xyz, hi xyz, kind, pad: two float4).
// Returns whether the ray enters before bt; near is the padded entry.
// kParallel closes the slabs of axes the ray runs parallel to
// (parallel_slab); warp_sweep takes it only for a warp that holds such a
// ray, so that the others keep the plain test's instructions.
template <bool kParallel = true>
__device__ __forceinline__ bool slab_pad(const float* b, const SweepRay& r,
                                         float bt, float& near) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(b));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(b) + 1);
  float t1x = (lo.x - r.ox) * r.ivx;
  float t2x = (lo.w - r.ox) * r.ivx;
  float t1y = (lo.y - r.oy) * r.ivy;
  float t2y = (hi.x - r.oy) * r.ivy;
  float t1z = (lo.z - r.oz) * r.ivz;
  float t2z = (hi.y - r.oz) * r.ivz;
  if (kParallel && r.parallel) {
    parallel_slab(lo.x, lo.w, r.ox, r.ivx, t1x, t2x);
    parallel_slab(lo.y, hi.x, r.oy, r.ivy, t1y, t2y);
    parallel_slab(lo.z, hi.y, r.oz, r.ivz, t1z, t2z);
  }
  const float n0 = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                         fminf(t1z, t2z));
  const float far = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                          fmaxf(t1z, t2z));
  near = n0 - fabsf(n0) * kCullPad;
  return near <= far && far > r.tmin && near <= bt;
}

template <int kC>
__device__ __forceinline__ void load_row(const float* p, float (&f)[kC]) {
  static_assert(kC % 4 == 0, "rows are whole float4");
  const float4* v = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int q = 0; q < kC / 4; ++q) {
    const float4 x = __ldg(v + q);
    f[4 * q] = x.x;
    f[4 * q + 1] = x.y;
    f[4 * q + 2] = x.z;
    f[4 * q + 3] = x.w;
  }
}

// The boxes of a sweep's table. Its rows come as a Rows type with a Best
// (whose field t is the lane's best t), probe(row, run kind, ray, t, u, v,
// id), which tests one row, take<kAnyHit>(row, t, u, v, id, best), which
// records an accepted row, id(best), the id a row's must be below to win a
// tie in t, kSkipInverted (whether runs with inverted boxes are padding)
// and kChunkGroups (whether the keys first cull by Boxes::groups).
struct Boxes {
  const float* subs;    // (rows / sub, kBox)
  const float* chunks;  // (>= nchunks, kBox)
  int nchunks, runs, sub;  // chunks, runs a chunk, rows a run
  // (ceil(nchunks / kChunkGroup), kBox): each kChunkGroup chunks' box,
  // read when Rows::kChunkGroups
  const float* groups;
};

// Per-lane counters of a kStats sweep (ops/sweep.py STATS order), and
// lane 0's of its warp (ops/sweep.py WARP_STATS): the row iterations and
// the run-cull iterations the warp executed.
struct SweepStats {
  int v[kStatPlanes];
  int warp_rows, warp_runs;
};

// The rows of run r for the lanes with in_run: a run more than kPairLanes
// lanes enter is tested one lane a ray, one fewer enter as (ray, row)
// pairs over the warp. An any-hit lane that accepts leaves (in_chunk and
// live false). Every lane of the warp must call it.
template <class Rows, bool kAnyHit, bool kStats>
__device__ __forceinline__ void sweep_rows(const Rows& rows, const Boxes& bx,
                                           const SweepRay& ray, int r,
                                           bool in_run, bool& in_chunk,
                                           bool& live, typename Rows::Best& best,
                                           SweepStats& st) {
  const int lane = threadIdx.x & 31;
  // a run's rows pack whole into lanes when bx.sub is a power of two <= 32
  const bool pairs_fit = bx.sub <= 32 && (bx.sub & (bx.sub - 1)) == 0;
  const int shift = __ffs(bx.sub) - 1;
  const float inf = __int_as_float(0x7f800000);
  const uint32_t m = __ballot_sync(kFullMask, in_run);
  if (m == 0u) return;
  const float kind = bx.subs[r * kBox + 6];
  const int k = __popc(m);
  if (pairs_fit && k <= kPairLanes) {
    // few lanes entered: the warp's lanes share their (ray, row) pairs
    const int pairs = k << shift;
    const int first = __popc(m & ((1u << lane) - 1u)) << shift;
    if (kStats && in_run) st.v[4] += bx.sub;
    for (int p0 = 0; p0 < pairs; p0 += 32) {
      if (kStats && lane == 0) ++st.warp_rows;
      const int p = p0 + lane;
      const int src = __fns(m, 0, (p < pairs ? p >> shift : 0) + 1);
      const int pos = p & (bx.sub - 1);
      SweepRay q = ray;
      q.ox = __shfl_sync(kFullMask, ray.ox, src);
      q.oy = __shfl_sync(kFullMask, ray.oy, src);
      q.oz = __shfl_sync(kFullMask, ray.oz, src);
      q.dx = __shfl_sync(kFullMask, ray.dx, src);
      q.dy = __shfl_sync(kFullMask, ray.dy, src);
      q.dz = __shfl_sync(kFullMask, ray.dz, src);
      q.tmin = __shfl_sync(kFullMask, ray.tmin, src);
      float t = 0.0f, u = 0.0f, v = 0.0f, jf = 0.0f;
      bool ok = p < pairs && rows.probe(r * bx.sub + pos, kind, q, t, u, v, jf);
      if (kAnyHit) {
        const float bt = __shfl_sync(kFullMask, best.t, src);
        const float bid = __shfl_sync(kFullMask, rows.id(best), src);
        ok = ok && (t < bt || (t == bt && jf < bid));
      }
      // the least row of each ray's group of bx.sub lanes: closest
      // hit by (t, id), any-hit by position (its first accept)
      float kt = ok ? (kAnyHit ? (float)pos : t) : inf;
      float kj = ok ? jf : inf;
      float ku = u, kv = v;
      int kp = pos;
      for (int off = bx.sub >> 1; off > 0; off >>= 1) {
        const float ot = __shfl_xor_sync(kFullMask, kt, off);
        const float oj = __shfl_xor_sync(kFullMask, kj, off);
        const float ou = __shfl_xor_sync(kFullMask, ku, off);
        const float ov = __shfl_xor_sync(kFullMask, kv, off);
        const int op = __shfl_xor_sync(kFullMask, kp, off);
        if (ot < kt || (ot == kt && oj < kj)) {
          kt = ot;
          kj = oj;
          ku = ou;
          kv = ov;
          kp = op;
        }
      }
      // each entering lane reads its group's least row
      const bool owns = in_run && first >= p0 && first < p0 + 32;
      const int from = owns ? first - p0 : lane;
      const float gt = __shfl_sync(kFullMask, kt, from);
      const float gj = __shfl_sync(kFullMask, kj, from);
      const float gu = __shfl_sync(kFullMask, ku, from);
      const float gv = __shfl_sync(kFullMask, kv, from);
      const int gp = __shfl_sync(kFullMask, kp, from);
      if (owns && gj != inf) {
        if (kAnyHit) {
          rows.template take<true>(r * bx.sub + gp, gt, gu, gv, gj, best);
          in_run = in_chunk = live = false;
        } else if (gt < best.t || (gt == best.t && gj < rows.id(best))) {
          rows.template take<false>(r * bx.sub + gp, gt, gu, gv, gj, best);
        }
      }
    }
    return;
  }
  for (int j = 0; j < bx.sub; ++j) {
    if (kStats && lane == 0) ++st.warp_rows;
    if (!in_run) continue;
    if (kStats) ++st.v[4];
    float t, u, v, jf;
    if (rows.probe(r * bx.sub + j, kind, ray, t, u, v, jf) &&
        (t < best.t || (t == best.t && jf < rows.id(best)))) {
      rows.template take<kAnyHit>(r * bx.sub + j, t, u, v, jf, best);
      if (kAnyHit) in_run = in_chunk = live = false;
    }
  }
}

// The runs of chunk c, entered by the lanes with in_chunk, in ascending
// order: each lane culls a run against its own best t, a ballot skips a
// run no lane enters, and sweep_rows tests the rows of the others. An
// any-hit lane that accepts leaves (live false). Every lane of the warp
// must call it.
//
// When more than kPairLanes lanes enter the chunk, each lane culls every
// run. When fewer do, and the chunk's runs pack whole into lanes (a power
// of two <= 32), the warp first culls them as (ray, run) pairs: each lane
// loads one run box once, an iteration takes 32 / runs entering lanes'
// rays by shuffles and tests each lane's box for one of them, and each
// entering lane keeps its ray's run mask from the ballot. The warp then
// visits only the union of the masks, where a lane with its bit re-culls
// the run at its current best t. The masks cull at the chunk's entry best
// t, which only shrinks after, so a lane enters the same runs as when it
// culls every run.
template <class Rows, bool kAnyHit, bool kStats, bool kParallel, bool kRunPairs>
__device__ __forceinline__ void sweep_runs(const Rows& rows, const Boxes& bx,
                                           const SweepRay& ray, int c,
                                           bool in_chunk, bool& live,
                                           typename Rows::Best& best,
                                           SweepStats& st) {
  const int lane = threadIdx.x & 31;
  float near;
  const uint32_t entered = __ballot_sync(kFullMask, in_chunk);
  if (!kRunPairs || bx.runs > 32 || (bx.runs & (bx.runs - 1)) != 0 ||
      __popc(entered) > kPairLanes) {
    for (int r = c * bx.runs; r < (c + 1) * bx.runs; ++r) {
      if (kStats && lane == 0) ++st.warp_runs;
      const float* box = bx.subs + r * kBox;
      // a table whose padding runs have inverted (empty) boxes, which the
      // slab test would take for the whole space, skips them
      const bool in_run = in_chunk && (!Rows::kSkipInverted || box[0] <= box[3]) &&
                          slab_pad<kParallel>(box, ray, best.t, near);
      if (kStats && in_chunk) {
        ++st.v[2];
        st.v[3] += in_run;
      }
      sweep_rows<Rows, kAnyHit, kStats>(rows, bx, ray, r, in_run, in_chunk, live,
                                        best, st);
    }
    return;
  }
  const int k = __popc(entered);
  const int shift = __ffs(bx.runs) - 1;
  const int per = 32 >> shift;  // rays an iteration
  const float* box = bx.subs + (c * bx.runs + (lane & (bx.runs - 1))) * kBox;
  // padding runs with inverted boxes stay out of the masks
  const bool open = !Rows::kSkipInverted || box[0] <= box[3];
  const int at = __popc(entered & ((1u << lane) - 1u));
  uint32_t mine = 0u;
  for (int i0 = 0; i0 < k; i0 += per) {
    if (kStats && lane == 0) ++st.warp_runs;
    const int i = i0 + (lane >> shift);
    const int src = __fns(entered, 0, (i < k ? i : 0) + 1);
    SweepRay q = ray;
    q.ox = __shfl_sync(kFullMask, ray.ox, src);
    q.oy = __shfl_sync(kFullMask, ray.oy, src);
    q.oz = __shfl_sync(kFullMask, ray.oz, src);
    q.ivx = __shfl_sync(kFullMask, ray.ivx, src);
    q.ivy = __shfl_sync(kFullMask, ray.ivy, src);
    q.ivz = __shfl_sync(kFullMask, ray.ivz, src);
    q.tmin = __shfl_sync(kFullMask, ray.tmin, src);
    if (kParallel) q.parallel = __shfl_sync(kFullMask, (int)ray.parallel, src) != 0;
    const float bt = __shfl_sync(kFullMask, best.t, src);
    const uint32_t b =
        __ballot_sync(kFullMask, i < k && open &&
                                     slab_pad<kParallel>(box, q, bt, near));
    if (in_chunk && at >= i0 && at < i0 + per) {
      mine = (b >> ((at - i0) << shift)) &
             (bx.runs == 32 ? kFullMask : (1u << bx.runs) - 1u);
    }
  }
  if (kStats && in_chunk) st.v[2] += bx.runs;
  for (uint32_t todo = __reduce_or_sync(kFullMask, mine); todo != 0u;
       todo &= todo - 1u) {
    if (kStats && lane == 0) ++st.warp_runs;
    const int j = __ffs(todo) - 1;
    const int r = c * bx.runs + j;
    bool in_run = in_chunk && ((mine >> j) & 1u);
    if (kStats && in_run) ++st.v[2];
    in_run = in_run && slab_pad<kParallel>(bx.subs + r * kBox, ray, best.t, near);
    if (kStats) st.v[3] += in_run;
    sweep_rows<Rows, kAnyHit, kStats>(rows, bx, ray, r, in_run, in_chunk, live, best,
                                      st);
  }
}

// list: this warp's kListCap words of shared memory (fewer when the
// table has fewer chunks; unused without kKeyed). kKeyed false visits the
// chunks in index order with no keys: each live lane tests each chunk's
// slab, a ballot skips a chunk no lane enters (an any-hit sweep, whose
// answer no order changes, saves the keys' slab tests and list).
// kRunPairs false culls every run of a visited chunk one lane a ray
// (sweep_runs): a kernel whose registers the pairs would crowd.
template <class Rows, bool kAnyHit, bool kStats, bool kKeyed, bool kParallel,
          bool kRunPairs>
__device__ __forceinline__ void warp_sweep_as(const Rows& rows, const Boxes& bx,
                                              const SweepRay& ray, bool live,
                                              typename Rows::Best& best,
                                              uint32_t* list, SweepStats& st) {
  static_assert(kKeyed || !Rows::kChunkGroups, "chunk groups cull the keys");
  if (!kKeyed) {
    for (int c = 0; c < bx.nchunks && __any_sync(kFullMask, live); ++c) {
      float near;
      const bool in_chunk =
          live && slab_pad<kParallel>(bx.chunks + c * kBox, ray, best.t, near);
      if (kStats && live) {
        ++st.v[0];
        st.v[1] += in_chunk;
      }
      if (__ballot_sync(kFullMask, in_chunk) == 0u) continue;
      sweep_runs<Rows, kAnyHit, kStats, kParallel, kRunPairs>(rows, bx, ray, c,
                                                              in_chunk, live, best, st);
    }
    return;
  }
  const int lane = threadIdx.x & 31;
  const int bits = bx.nchunks > 1 ? 32 - __clz(bx.nchunks - 1) : 0;
  const uint32_t low = (1u << bits) - 1u;
  for (int c0 = 0; c0 < bx.nchunks && __any_sync(kFullMask, live);) {
    // 1. keys of the next chunks the warp enters, at each lane's current
    // best t, until the list holds kListCap of them
    int count = 0;
    int c = c0;
    bool in_group = live;
    for (; c < bx.nchunks && count < kListCap; ++c) {
      float near;
      if (Rows::kChunkGroups && (c % kChunkGroup == 0 || c == c0)) {
        // a group no lane enters is passed over, its chunks untested
        in_group = live && slab_pad<kParallel>(bx.groups + (c / kChunkGroup) * kBox,
                                               ray, best.t, near);
        if (kStats && live) ++st.v[0];
        if (!__any_sync(kFullMask, in_group)) {
          c = min(c | (kChunkGroup - 1), bx.nchunks - 1);
          continue;
        }
      }
      if (Rows::kChunkGroups && kStats && in_group) ++st.v[0];
      const bool in =
          in_group && slab_pad<kParallel>(bx.chunks + c * kBox, ray, best.t, near);
      if (!__any_sync(kFullMask, in)) continue;
      // + 0: a -0 entry keys as +0, whatever fmaxf returns for signed zeros
      const uint32_t key = in ? ord_bits(fmaxf(near, ray.tmin) + 0.0f) : kNoWord;
      const uint32_t least = __reduce_min_sync(kFullMask, key);
      if (lane == 0) list[count] = ((least >> bits) << bits) | (uint32_t)c;
      ++count;
    }
    if (!Rows::kChunkGroups && kStats && live) st.v[0] += c - c0;
    c0 = c;
    __syncwarp();
    // 2. visits, least key first
    for (;;) {
      uint32_t mine = kNoWord;
      int at = -1;
      for (int j = lane; j < count; j += 32) {
        const uint32_t w = list[j];
        if (w < mine) {
          mine = w;
          at = j;
        }
      }
      const uint32_t word = __reduce_min_sync(kFullMask, mine);
      if (word == kNoWord) break;
      const uint32_t reach =
          __reduce_max_sync(kFullMask, live ? ord_bits(best.t) : 0u);
      if ((word >> bits) > (reach >> bits)) break;
      if (mine == word) list[at] = kNoWord;
      __syncwarp();
      const int c = (int)(word & low);
      float near;
      bool in_chunk =
          live && slab_pad<kParallel>(bx.chunks + c * kBox, ray, best.t, near);
      if (kStats && live) {
        ++st.v[0];
        st.v[1] += in_chunk;
      }
      if (__ballot_sync(kFullMask, in_chunk) == 0u) continue;
      sweep_runs<Rows, kAnyHit, kStats, kParallel, kRunPairs>(rows, bx, ray, c,
                                                              in_chunk, live, best, st);
    }
    __syncwarp();
  }
}

// The sweep of warp_sweep_as, its slab tests closing parallel slabs only
// in a warp that holds a ray parallel to an axis (slab_pad). Every lane of
// the warp must call it.
template <class Rows, bool kAnyHit, bool kStats, bool kKeyed = true,
          bool kRunPairs = true>
__device__ __forceinline__ void warp_sweep(const Rows& rows, const Boxes& bx,
                                           const SweepRay& ray, bool live,
                                           typename Rows::Best& best,
                                           uint32_t* list, SweepStats& st) {
  if (__any_sync(kFullMask, ray.parallel)) {
    warp_sweep_as<Rows, kAnyHit, kStats, kKeyed, true, kRunPairs>(rows, bx, ray, live,
                                                                  best, list, st);
  } else {
    warp_sweep_as<Rows, kAnyHit, kStats, kKeyed, false, kRunPairs>(rows, bx, ray, live,
                                                                   best, list, st);
  }
}

// Writes a kStats sweep's counters: stats (kStatPlanes, n) per ray, warp
// (2, ceil(n / 32)) per warp, row then run iterations (lane 0 writes;
// call for i < n).
__device__ __forceinline__ void store_stats(const SweepStats& st, int* stats,
                                            int* warp, int n, int i) {
#pragma unroll
  for (int q = 0; q < kStatPlanes; ++q) stats[q * n + i] = st.v[q];
  if ((threadIdx.x & 31) == 0) {
    warp[i >> 5] = st.warp_rows;
    warp[((n + 31) >> 5) + (i >> 5)] = st.warp_runs;
  }
}

// Words of a warp's list, and the shared memory of a sweep block.
__host__ __device__ inline int sweep_list(int nchunks) {
  return nchunks < kListCap ? nchunks : kListCap;
}
inline size_t sweep_smem(int nchunks) {
  return (size_t)(kThreads / 32) * (size_t)sweep_list(nchunks) * sizeof(uint32_t);
}

// Lets `kernel` take `smem` bytes of dynamic shared memory (above the
// 48 KB default only on request; at most 227 KB a block).
template <class K>
inline cudaError_t allow_smem(K* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace rtf
