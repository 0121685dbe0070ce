// The LBVH walker K5, one thread per ray, with a plain C interface for
// ctypes (raytracerfacility_tpu_torch/kernels.py builds and loads it;
// ops/traverse.py::trace_planes launches it).
//
// bvh_trace_kernel<any_hit> replaces raytracerfacility_tpu/ops/
// pallas_trace.py:61 _traversal_kernel: closest hit (t, prim, u, v), or the
// first accepted hit of an occlusion query, of rays through the threaded
// preorder LBVH of ops/bvh.py (tables unchanged).
//
// Closest hit: the (t, lowest original prim) minimum over accepted rows,
// whatever the visit order, so closest_walk goes near first instead
// of along the reference's skip links; ops/traverse.py::_walk_ordered
// replays it step for step, counters included. At an internal node p the
// children are p + 1 and skip[p + 1] (preorder: the right child follows
// the left subtree). Both boxes are tested; the thread descends into the
// entered child with the smaller entry (the left one on a tie) and pushes
// the other with its entry, so near hits shrink the best t before far
// subtrees are tested, and a pop drops an entry past the current best t.
// A leaf tests its rows in order. The stack is per thread in local memory:
// the radix tree is at most 63 levels deep (ops/bvh.py MAX_DEPTH_PASSES),
// so kStack = 64 entries always suffice; an entry holds an internal node,
// or a leaf's meta (as -1 - meta), and its entry.
//
// Loads. A node is 32 bytes; on config 6 the 66 MB node table does not fit
// the 50 MB L2, so each load waits on memory. The thread keeps, for the
// internal node it is at, its left child's row; the right child's index is
// that row's skip link. It loads the right child's row, the row after it
// and the left child's left child together, so whichever child it
// descends into has its own left child in hand: one memory round trip a
// level instead of one a node.
//
// Culls. A box is entered when max(near, tmin) <= far and
// max(near - |near|/512, tmin) <= best t (sweep.cuh's pad: a grazing curve
// cap or triangle edge can round to before its box's entry, and the visit
// order must not decide such a row). The terms without best t are the
// reference's, so the same leaves are reachable.
//
// Occlusion: any_walk follows the reference's order, node for node
// (box entered -> node + 1, else -> skip[node]), stackless, one thread a
// ray, and stops at the first accepted row; ops/traverse.py::_walk_plain
// is its replay. Two other orders lost on config 6's shadow rays (524,288
// lanes) on an H100. Near first saves a shadow ray no visits (130 against
// 126), and its stack and wider loads made the kernel slower. A walk
// uniform across the warp (the warp takes the lowest next node of its
// lanes, loads it once, and only the lanes standing on it test it; a skip
// walk moves only forward in preorder, so each lane keeps its own visits)
// cuts the node loads 4.9-fold, but a warp then steps once a node of the
// union of its lanes' walks, a median 757 steps against 285 visits of its
// longest lane, each step a dependent load: 1.48 ms against 0.51-0.55 for
// this walk, whose lanes keep up to 32 independent loads in flight.
// _walk_plain(..., warp_steps=True) replays the union's steps.
//
// With stats a thread counts node box tests (its "node visits": 1 + 2 per
// internal node entered near first, one a step on the skip walk) and row
// tests; at most kMaxSteps of them. Built with -fmad=false so it equals
// its plain versions bit for bit.

#include <cuda_runtime.h>

#include "path_common.cuh"

namespace rtf {

constexpr int kIntBias = 0x40000000;  // ops/bvh.py INT_BIAS
constexpr int kStartMask = (1 << 27) - 1;
constexpr int kMaxSteps = 8192;  // ops/traverse.py MAX_STEPS
constexpr int kStack = 64;       // ops/traverse.py STACK
constexpr float kNodePad = 1.0f / 512.0f;  // ops/traverse.py CULL_PAD

__device__ __forceinline__ int decode_int(float f) {
  return __float_as_int(f) & (kIntBias - 1);
}

struct Node {
  float4 lo, hi;  // box min (lo.x, lo.y, lo.z), box max (lo.w, hi.x, hi.y),
                  // skip link hi.z, leaf meta hi.w
};

__device__ __forceinline__ Node load_node(const float4* nodes, int k) {
  return Node{__ldg(nodes + 2 * (size_t)k), __ldg(nodes + 2 * (size_t)k + 1)};
}

struct WalkRay {
  float ox, oy, oz, dx, dy, dz, ivx, ivy, ivz, tmin, tmax;
  bool parallel;  // some axis's inverse is held (parallel_slab)
};

// Whether the ray enters node box b before the best t `bt` (padded);
// key: the padded entry that orders the children. kParallel, for a ray
// parallel to an axis, closes that axis's slab (parallel_slab; the skip
// walk of any_walk, the reference's, keeps it open).
template <bool kParallel>
__device__ __forceinline__ bool enter(const Node& b, const WalkRay& r,
                                      float bt, float& key) {
  float t1x = (b.lo.x - r.ox) * r.ivx;
  float t2x = (b.lo.w - r.ox) * r.ivx;
  float t1y = (b.lo.y - r.oy) * r.ivy;
  float t2y = (b.hi.x - r.oy) * r.ivy;
  float t1z = (b.lo.z - r.oz) * r.ivz;
  float t2z = (b.hi.y - r.oz) * r.ivz;
  if (kParallel) {
    parallel_slab(b.lo.x, b.lo.w, r.ox, r.ivx, t1x, t2x);
    parallel_slab(b.lo.y, b.hi.x, r.oy, r.ivy, t1y, t2y);
    parallel_slab(b.lo.z, b.hi.y, r.oz, r.ivz, t1z, t2z);
  }
  const float near = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                           fminf(t1z, t2z));
  const float far = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                          fmaxf(t1z, t2z));
  key = fmaxf(near - fabsf(near) * kNodePad, r.tmin);
  return fmaxf(near, r.tmin) <= far && key <= bt;
}

__device__ __forceinline__ int meta_of(const Node& b) {
  return decode_int(b.hi.w);
}

__device__ __forceinline__ WalkRay load_ray(
    const float* ox, const float* oy, const float* oz, const float* dx,
    const float* dy, const float* dz, const float* tmin, const float* tmax,
    int i) {
  WalkRay r;
  r.ox = ox[i];
  r.oy = oy[i];
  r.oz = oz[i];
  r.dx = dx[i];
  r.dy = dy[i];
  r.dz = dz[i];
  r.tmin = tmin[i];
  r.tmax = tmax[i];
  r.ivx = inv_dir(r.dx);
  r.ivy = inv_dir(r.dy);
  r.ivz = inv_dir(r.dz);
  r.parallel = any_parallel(r.ivx, r.ivy, r.ivz);
  return r;
}

// Test of row q (three float4) against the ray: accept with t > tmin.
__device__ __forceinline__ bool row_test(const float4* q, const WalkRay& r,
                                         bool curves, float& t, float& u,
                                         float& v, int& p) {
  const float4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2);
  const float row[12] = {a.x, a.y, a.z, a.w, b.x, b.y,
                         b.z, b.w, c.x, c.y, c.z, c.w};
  v = 0.0f;
  p = decode_int(c.y);
  return curves && decode_int(c.w) == 1
             ? curve_test(row, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, r.tmin, t, u)
             : tri_test(row, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, r.tmin, t, u, v);
}

// nodes: (M, 8) float32 as 2M float4; tris: (N, 12) float32 as 3N float4.
// planes o/d/tmin/tmax: (n,) each; out: (3, n) planes t, u, v (t = tmax,
// u = v = 0 on a miss); prim: (n,) original prim, -1 on a miss; stats:
// (2, n) node box tests and rows tested, or null (a render's launch).
#define RTF_WALK_ARGS                                                        \
  const float *__restrict__ ox, const float *__restrict__ oy,                \
      const float *__restrict__ oz, const float *__restrict__ dx,            \
      const float *__restrict__ dy, const float *__restrict__ dz,            \
      const float *__restrict__ tmin, const float *__restrict__ tmax,        \
      const float4 *__restrict__ nodes, const float4 *__restrict__ tris,     \
      float *__restrict__ out, int *__restrict__ prim,                       \
      int *__restrict__ stats, int n, int num_nodes, bool curves

template <bool kParallel>
__device__ __forceinline__ void closest_walk(RTF_WALK_ARGS, const WalkRay& r,
                                             int i) {
  float bt = r.tmax, bu = 0.0f, bv = 0.0f;
  int bp = -1, visits = 1, tests = 0, sp = 0;
  int stack_item[kStack];
  float stack_key[kStack];
  // item: an internal node (>= 0) with its left child's row in `left`, a
  // leaf as -1 - meta, or kDone to pop
  constexpr int kDone = 0x7fffffff;
  float key;
  Node left{};
  int item = kDone;
  {
    const Node root = load_node(nodes, 0);
    if (enter<kParallel>(root, r, bt, key)) {
      const int meta = meta_of(root);
      item = meta != 0 ? -1 - meta : 0;
      if (meta == 0) left = load_node(nodes, 1);
    }
  }
  for (;;) {
    if (item == kDone) {  // pop, dropping entries past the best t
      while (sp > 0) {
        --sp;
        if (stack_key[sp] <= bt) {
          item = stack_item[sp];
          break;
        }
      }
      if (item == kDone) break;
      if (item >= 0) left = load_node(nodes, item + 1);
    }
    if (item < 0) {  // a leaf: its rows in order
      const int meta = -1 - item;
      const int count = meta >> 27;
      const float4* q = tris + 3 * (size_t)(meta & kStartMask);
      for (int k = 0; k < count; ++k, q += 3) {
        float t, u, v;
        int p;
        ++tests;
        if (row_test(q, r, curves, t, u, v, p) &&
            (t < bt || (t == bt && p < bp))) {
          bt = t;
          bu = u;
          bv = v;
          bp = p;
        }
      }
      item = kDone;
      continue;
    }
    if (visits >= kMaxSteps) break;
    // an internal node: both children and the next level's left children,
    // three independent loads
    const int li = item + 1;
    const int ri = decode_int(left.hi.z);
    const int lmeta = meta_of(left);
    const Node right = load_node(nodes, ri);
    const Node right1 = load_node(nodes, min(ri + 1, num_nodes - 1));
    const Node left1 = lmeta == 0 ? load_node(nodes, li + 1) : left;
    visits += 2;
    float kl, kr;
    const bool el = enter<kParallel>(left, r, bt, kl);
    const bool er = enter<kParallel>(right, r, bt, kr);
    const int rmeta = meta_of(right);
    const int l_item = lmeta != 0 ? -1 - lmeta : li;
    const int r_item = rmeta != 0 ? -1 - rmeta : ri;
    if (el && er) {
      const bool r_first = kr < kl;
      stack_item[sp] = r_first ? l_item : r_item;
      stack_key[sp] = r_first ? kl : kr;
      ++sp;
      item = r_first ? r_item : l_item;
      left = r_first ? right1 : left1;
    } else if (el) {
      item = l_item;
      left = left1;
    } else if (er) {
      item = r_item;
      left = right1;
    } else {
      item = kDone;
    }
  }
  out[i] = bt;
  out[n + i] = bu;
  out[2 * n + i] = bv;
  prim[i] = bp;
  if (stats != nullptr) {
    stats[i] = visits;
    stats[n + i] = tests;
  }
}

__device__ __forceinline__ void any_walk(RTF_WALK_ARGS, int i) {
  const WalkRay r = load_ray(ox, oy, oz, dx, dy, dz, tmin, tmax, i);
  float bt = r.tmax, bu = 0.0f, bv = 0.0f;
  int bp = -1, node = 0, steps = 0, tests = 0;
  while (node < num_nodes && steps < kMaxSteps) {
    ++steps;
    const Node b = load_node(nodes, node);
    const float t1x = (b.lo.x - r.ox) * r.ivx;
    const float t2x = (b.lo.w - r.ox) * r.ivx;
    const float t1y = (b.lo.y - r.oy) * r.ivy;
    const float t2y = (b.hi.x - r.oy) * r.ivy;
    const float t1z = (b.lo.z - r.oz) * r.ivz;
    const float t2z = (b.hi.y - r.oz) * r.ivz;
    const float near = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                             fminf(t1z, t2z));
    const float far = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                            fmaxf(t1z, t2z));
    const bool box = fmaxf(near, r.tmin) <= fminf(far, r.tmax);
    const int meta = meta_of(b);
    const int count = meta >> 27;
    if (box && count == 0) {  // internal node entered: descend
      ++node;
      continue;
    }
    if (box) {  // leaf entered: its rows in order, to the first accept
      const float4* q = tris + 3 * (size_t)(meta & kStartMask);
      for (int k = 0; k < count; ++k, q += 3) {
        float t, u, v;
        int p;
        ++tests;
        if (row_test(q, r, curves, t, u, v, p) && t < r.tmax) {
          bt = t;
          bu = u;
          bv = v;
          bp = p;
          break;
        }
      }
      if (bp >= 0) break;
    }
    node = decode_int(b.hi.z);  // skip link
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

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads) bvh_trace_kernel(RTF_WALK_ARGS) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if constexpr (kAnyHit) {
    any_walk(ox, oy, oz, dx, dy, dz, tmin, tmax, nodes, tris, out, prim,
             stats, n, num_nodes, curves, i);
  } else {
    // a ray parallel to an axis walks with that slab closed
    const WalkRay r = load_ray(ox, oy, oz, dx, dy, dz, tmin, tmax, i);
    if (r.parallel) {
      closest_walk<true>(ox, oy, oz, dx, dy, dz, tmin, tmax, nodes, tris, out,
                         prim, stats, n, num_nodes, curves, r, i);
    } else {
      closest_walk<false>(ox, oy, oz, dx, dy, dz, tmin, tmax, nodes, tris, out,
                          prim, stats, n, num_nodes, curves, r, i);
    }
  }
}

#undef RTF_WALK_ARGS

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
