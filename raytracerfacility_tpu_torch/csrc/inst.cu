// The shared-geometry instanced trace kernel K4, one thread per ray, with a
// plain C interface for ctypes (raytracerfacility_tpu_torch/kernels.py
// builds and loads it; ops/inst.py::trace_planes launches it).
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
// about 55 operations a row (Moller-Trumbore and the accept tests). The TPU
// kernel walks a per-tile, front-to-back culled order of (instance, object
// chunk) steps from scalar-prefetched tables; here each thread culls for
// itself, against its own best t, at three levels: the instance's world box
// (the hull of its object chunk boxes' corners under its transform), then,
// in object space, the chunk box and the 32-row run boxes. Instances are
// visited in index order and the geometry's chunks in Morton order. The
// records and boxes that all threads of a warp read come from L1/L2.
//
// Numerics as in path_common.cuh: built with -fmad=false, so the transform
// rounds each product and each sum, left to right, as the plain PyTorch
// version and the reference's oracle compute it.

#include <cuda_runtime.h>

#include "path_common.cuh"

namespace rtf {

constexpr int kInstCols = 12;  // v0 e1 e2 | geometry base + original prim | pad
constexpr int kInstRec = 16;   // A (row-major 3x3) | c | pad

struct InstTables {
  const float* rows;    // (rows, kInstCols) object space
  const float* subs;    // (rows / sub, kBox) object-space run boxes
  const float* chunks;  // (>= nchunks, kBox) object-space chunk boxes
  const float* inst;    // (ninst, kInstRec) world->object records
  const float* boxes;   // (ninst, kBox) world boxes
  const int* ranges;    // (ninst, 2) first object chunk, chunk count
  int ninst, chunk, sub;
};

// planes o/d/tmin/tmax: (n,) each; out: (5, n) planes t, prim, instance, u,
// v (t = tmax, prim = instance = -1 on a miss).
__global__ void __launch_bounds__(kThreads)
inst_trace_kernel(const float* __restrict__ pox, const float* __restrict__ poy,
                  const float* __restrict__ poz, const float* __restrict__ pdx,
                  const float* __restrict__ pdy, const float* __restrict__ pdz,
                  const float* __restrict__ ptmin,
                  const float* __restrict__ ptmax, float* __restrict__ out,
                  InstTables s, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float wox = pox[i], woy = poy[i], woz = poz[i];
  const float wdx = pdx[i], wdy = pdy[i], wdz = pdz[i];
  const float tmin = ptmin[i];
  const float wivx = inv_dir(wdx), wivy = inv_dir(wdy), wivz = inv_dir(wdz);
  // best hit; instance -1 so that nothing ties with the initial tmax
  float bt = ptmax[i], bid = -1.0f, biid = -1.0f, bu = 0.0f, bv = 0.0f;
  const int runs = s.chunk / s.sub;
  for (int k = 0; k < s.ninst; ++k) {
    if (!slab(s.boxes + k * kBox, wox, woy, woz, wivx, wivy, wivz, tmin, bt))
      continue;
    const float* a = s.inst + k * kInstRec;
    const float ox = a[0] * wox + a[1] * woy + a[2] * woz + a[9];
    const float oy = a[3] * wox + a[4] * woy + a[5] * woz + a[10];
    const float oz = a[6] * wox + a[7] * woy + a[8] * woz + a[11];
    const float dx = a[0] * wdx + a[1] * wdy + a[2] * wdz;
    const float dy = a[3] * wdx + a[4] * wdy + a[5] * wdz;
    const float dz = a[6] * wdx + a[7] * wdy + a[8] * wdz;
    const float ivx = inv_dir(dx), ivy = inv_dir(dy), ivz = inv_dir(dz);
    const float kf = (float)k;
    const int c0 = s.ranges[2 * k];
    const int c1 = c0 + s.ranges[2 * k + 1];
    for (int c = c0; c < c1; ++c) {
      if (!slab(s.chunks + c * kBox, ox, oy, oz, ivx, ivy, ivz, tmin, bt))
        continue;
      for (int r = c * runs; r < (c + 1) * runs; ++r) {
        const float* box = s.subs + r * kBox;
        // a run of padding rows has an inverted (empty) box, which the slab
        // test would take for the whole space
        if (box[0] > box[3] ||
            !slab(box, ox, oy, oz, ivx, ivy, ivz, tmin, bt))
          continue;
        const float* row = s.rows + (size_t)r * s.sub * kInstCols;
        for (int j = 0; j < s.sub; ++j, row += kInstCols) {
          float t, u, v;
          const bool ok = tri_test(row, ox, oy, oz, dx, dy, dz, tmin, t, u, v);
          const float jf = row[9];
          if (ok && (t < bt || (t == bt && (kf < biid ||
                                            (kf == biid && jf < bid))))) {
            bt = t;
            bid = jf;
            biid = kf;
            bu = u;
            bv = v;
          }
        }
      }
    }
  }
  out[0 * n + i] = bt;
  out[1 * n + i] = bid;
  out[2 * n + i] = biid;
  out[3 * n + i] = bu;
  out[4 * n + i] = bv;
}

}  // namespace rtf

extern "C" {

int rtf_inst_trace(const void* ox, const void* oy, const void* oz,
                   const void* dx, const void* dy, const void* dz,
                   const void* tmin, const void* tmax, void* out,
                   const void* rows, const void* subs, const void* chunks,
                   const void* inst, const void* boxes, const void* ranges,
                   int n, int ninst, int chunk, int sub, void* stream) {
  const rtf::InstTables s{(const float*)rows,   (const float*)subs,
                          (const float*)chunks, (const float*)inst,
                          (const float*)boxes,  (const int*)ranges,
                          ninst,                chunk,
                          sub};
  const int blocks = (n + rtf::kThreads - 1) / rtf::kThreads;
  rtf::inst_trace_kernel<<<blocks, rtf::kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)ox, (const float*)oy, (const float*)oz, (const float*)dx,
      (const float*)dy, (const float*)dz, (const float*)tmin,
      (const float*)tmax, (float*)out, s, n);
  return (int)cudaGetLastError();
}

const char* rtf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
