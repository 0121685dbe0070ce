// The segmented engine's reorder kernels, with a plain C interface for
// ctypes (raytracerfacility_tpu_torch/kernels.py builds and loads them):
// the block-permutation kernel K6 (ops/seg.py::block_perm), and the exact
// reorder's key and gather kernels (ops/seg.py::reorder_key and
// ::reorder_gather), which run around the library's stable sort.
//
// block_perm_kernel replaces raytracerfacility_tpu/ops/pallas_seg.py:834
// _apply_block_perm (its body `kern`, :844): the segmented engine's block
// reorder. The ray pool is cut into blocks of `bsize` consecutive rays;
// destination block b of every plane is source block perm[b]. The planes
// are the 13 float32 path-state planes, the int32 RNG plane and the int64
// original-index plane, all moved by one launch into a second set of
// buffers (the engine swaps the two sets).
//
// Bound on this card by bytes: 64 bytes a ray, read once and written once.
// One CUDA block copies one (plane, destination block) pair with 16-byte
// vector loads and stores, neighbouring threads on neighbouring addresses;
// it reads its source block id from `perm` in device memory, so the host
// never reads the permutation. The TPU kernel did the same through a
// scalar-prefetch BlockSpec index map; here a block computes its own
// offsets.

#include <cuda_runtime.h>

namespace rtf {

constexpr int kPermThreads = 256;

// st_*: (nplanes, stride) float32; rng_*: (stride,) int32; orig_*:
// (stride,) int64; perm: (stride / bsize,) int32. Grid: (blocks, nplanes
// + 2); blockIdx.y picks the plane (nplanes = RNG, nplanes + 1 = original
// index). bsize * 4 bytes is a multiple of 16 and every plane starts on a
// 16-byte boundary (the wrapper checks both).
__global__ void __launch_bounds__(kPermThreads)
block_perm_kernel(const float* __restrict__ st_in, float* __restrict__ st_out,
                  const int* __restrict__ rng_in, int* __restrict__ rng_out,
                  const long long* __restrict__ orig_in,
                  long long* __restrict__ orig_out,
                  const int* __restrict__ perm, int nplanes, int stride,
                  int bsize) {
  const int b = blockIdx.x;
  const int plane = blockIdx.y;
  const int nblocks = stride / bsize;
  const int src = perm[b];
  if (src < 0 || src >= nblocks) return;  // not a permutation: copy nothing
  const char* in;
  char* out;
  size_t esize = 4;
  if (plane < nplanes) {
    in = reinterpret_cast<const char*>(st_in + (size_t)plane * stride);
    out = reinterpret_cast<char*>(st_out + (size_t)plane * stride);
  } else if (plane == nplanes) {
    in = reinterpret_cast<const char*>(rng_in);
    out = reinterpret_cast<char*>(rng_out);
  } else {
    in = reinterpret_cast<const char*>(orig_in);
    out = reinterpret_cast<char*>(orig_out);
    esize = 8;
  }
  const size_t block_bytes = (size_t)bsize * esize;
  const int4* s4 = reinterpret_cast<const int4*>(in + (size_t)src * block_bytes);
  int4* d4 = reinterpret_cast<int4*>(out + (size_t)b * block_bytes);
  const int nvec = (int)(block_bytes / 16);
  for (int i = threadIdx.x; i < nvec; i += kPermThreads) d4[i] = __ldg(s4 + i);
}

// The exact reorder (ops/seg.py::reorder) replaces XLA glue, not a TPU
// kernel: the reference's key (raytracerfacility_tpu/ops/pallas_seg.py:791
// _morton_key) and its multi-operand lax.sort carrying the ray state
// (pallas_seg.py:926 _reorder_at). Here the key is one kernel, the sort is
// torch.argsort(stable=True) on the key, and the state moves in one gather
// launch. Both kernels are bound by bytes: 32 a ray for the key (seven
// planes read, the key written) and 136 for the gather (the order, 15
// planes read, 15 written).

constexpr int kReorderThreads = 256;
constexpr int kDeadKey = 0x7fffffff;
// origin-cell bits per axis (ops/seg.py MORTON_BITS)
constexpr int kMortonBits = 4;
// rows of the path state (ops/fused.py): origin 0-2, direction 3-5, ACT,
// throughput 7-9, radiance 10-12
constexpr int kDir = 3;
constexpr int kAct = 6;
constexpr int kRadiance = 10;
// state slots a gather thread moves, loads before stores: of 1, 3, 5, 8
// and 15 a thread, 3 was the fastest at every 1080p and config-4 shape
// measured on the H100 (0.183 against 0.197-0.279 ms at 2,073,600 rays)
constexpr int kGatherGroup = 3;

// One thread a ray of the first m rays of st (nplanes x stride float32,
// read in place). key[i] is ops/seg.py::_morton_key's int32 key as torch
// computes it on this card: each axis as ((o - lo) * inv_extent) * 16,
// rounded to float32 at each step (the library builds with -fmad=false),
// truncated to int32 as a cast does here (saturating, NaN to 0), clamped
// to [0, 15], bit b to bit 3b + 2 - axis of the code; the direction octant
// above it; kDeadKey unless ACT > 0. Each block adds its live rays (a
// ballot a warp) to *live with one atomic; the host zeroes it first.
__global__ void __launch_bounds__(kReorderThreads)
reorder_key_kernel(const float* __restrict__ st, const float* __restrict__ lo,
                   const float* __restrict__ inv_extent, int* __restrict__ key,
                   int* __restrict__ live, int stride, int m) {
  __shared__ int warp_live[kReorderThreads / 32];
  const int i = blockIdx.x * kReorderThreads + threadIdx.x;
  bool alive = false;
  if (i < m) {
    alive = st[(size_t)kAct * stride + i] > 0.0f;
    int k = kDeadKey;
    if (alive) {
      int code = 0;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float t = (st[(size_t)a * stride + i] - lo[a]) * inv_extent[a];
        int q = __float2int_rz(t * (float)(1 << kMortonBits));
        q = min(max(q, 0), (1 << kMortonBits) - 1);
#pragma unroll
        for (int b = 0; b < kMortonBits; ++b) code |= ((q >> b) & 1) << (3 * b + 2 - a);
      }
      const int octant = (st[(size_t)kDir * stride + i] < 0.0f ? 4 : 0) |
                         (st[(size_t)(kDir + 1) * stride + i] < 0.0f ? 2 : 0) |
                         (st[(size_t)(kDir + 2) * stride + i] < 0.0f ? 1 : 0);
      k = (octant << (3 * kMortonBits)) | code;
    }
    key[i] = k;
  }
  const unsigned ballot = __ballot_sync(0xffffffffu, alive);
  if ((threadIdx.x & 31) == 0) warp_live[threadIdx.x >> 5] = __popc(ballot);
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kReorderThreads / 32; ++w) sum += warp_live[w];
    if (sum) atomicAdd(live, sum);
  }
}

// Slot s of a ray: float32 plane s below nplanes, then the int32 RNG, then
// the int64 original index, each as 64 bits.
__device__ __forceinline__ unsigned long long load_slot(
    const float* __restrict__ st, const int* __restrict__ rng,
    const long long* __restrict__ orig, int s, int nplanes, int stride,
    long long r) {
  if (s < nplanes) return __float_as_uint(__ldg(st + (size_t)s * stride + r));
  if (s == nplanes) return (unsigned)__ldg(rng + r);
  return (unsigned long long)__ldg(orig + r);
}

__device__ __forceinline__ void store_slot(float* __restrict__ st,
                                           int* __restrict__ rng,
                                           long long* __restrict__ orig, int s,
                                           int nplanes, int stride, int r,
                                           unsigned long long v) {
  if (s < nplanes) st[(size_t)s * stride + r] = __uint_as_float((unsigned)v);
  else if (s == nplanes) rng[r] = (int)(unsigned)v;
  else orig[r] = (long long)v;
}

// Output position i of the first m takes input ray order[i]. Grid: (rays /
// kReorderThreads, slot groups); blockIdx.y picks kGatherGroup consecutive
// slots of the nplanes + 2, so a group's source planes stay in L2 while its
// blocks run, and a thread loads its group's slots before it stores them.
// With radiance null every position is written. Otherwise only those below
// *live are; a position at or past it (a ray the key found dead) instead
// writes the ray's three radiance planes to its original column of
// radiance (3 x rad_stride), once, from the last slot group's blocks.
__global__ void __launch_bounds__(kReorderThreads)
reorder_gather_kernel(const float* __restrict__ st_in, float* __restrict__ st_out,
                      const int* __restrict__ rng_in, int* __restrict__ rng_out,
                      const long long* __restrict__ orig_in,
                      long long* __restrict__ orig_out,
                      const long long* __restrict__ order,
                      const int* __restrict__ live, float* __restrict__ radiance,
                      int nplanes, int in_stride, int out_stride, int rad_stride,
                      int m) {
  const int i = blockIdx.x * kReorderThreads + threadIdx.x;
  if (i >= m) return;
  const long long src = __ldg(order + i);
  if (src < 0 || src >= in_stride) return;  // not a permutation: copy nothing
  const int nslots = nplanes + 2;
  const int first = blockIdx.y * kGatherGroup;
  if (radiance == nullptr || i < __ldg(live)) {
    unsigned long long v[kGatherGroup];
#pragma unroll
    for (int g = 0; g < kGatherGroup; ++g)
      if (first + g < nslots)
        v[g] = load_slot(st_in, rng_in, orig_in, first + g, nplanes, in_stride, src);
#pragma unroll
    for (int g = 0; g < kGatherGroup; ++g)
      if (first + g < nslots)
        store_slot(st_out, rng_out, orig_out, first + g, nplanes, out_stride, i, v[g]);
  } else if (first + kGatherGroup >= nslots) {
    const long long col = __ldg(orig_in + src);
    if (col < 0 || col >= rad_stride) return;
    float rad[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      rad[c] = __ldg(st_in + (size_t)(kRadiance + c) * in_stride + src);
#pragma unroll
    for (int c = 0; c < 3; ++c) radiance[(size_t)c * rad_stride + col] = rad[c];
  }
}

}  // namespace rtf

extern "C" {

int rtf_block_perm(const void* st_in, void* st_out, const void* rng_in,
                   void* rng_out, const void* orig_in, void* orig_out,
                   const void* perm, int nplanes, int stride, int bsize,
                   void* stream) {
  const int nblocks = stride / bsize;
  if (nblocks == 0) return 0;
  const dim3 grid(nblocks, nplanes + 2);
  rtf::block_perm_kernel<<<grid, rtf::kPermThreads, 0, (cudaStream_t)stream>>>(
      (const float*)st_in, (float*)st_out, (const int*)rng_in, (int*)rng_out,
      (const long long*)orig_in, (long long*)orig_out, (const int*)perm,
      nplanes, stride, bsize);
  return (int)cudaGetLastError();
}

// key: (m,) int32; live: one int32, zeroed here before the launch.
int rtf_reorder_key(const void* st, const void* lo, const void* inv_extent,
                    void* key, void* live, int stride, int m, void* stream) {
  cudaError_t err = cudaMemsetAsync(live, 0, sizeof(int), (cudaStream_t)stream);
  if (err != cudaSuccess || m == 0) return (int)err;
  const int blocks = (m + rtf::kReorderThreads - 1) / rtf::kReorderThreads;
  rtf::reorder_key_kernel<<<blocks, rtf::kReorderThreads, 0, (cudaStream_t)stream>>>(
      (const float*)st, (const float*)lo, (const float*)inv_extent, (int*)key,
      (int*)live, stride, m);
  return (int)cudaGetLastError();
}

// order: (m,) int64; live: one int32 (read only when radiance is given).
int rtf_reorder_gather(const void* st_in, void* st_out, const void* rng_in,
                       void* rng_out, const void* orig_in, void* orig_out,
                       const void* order, const void* live, void* radiance,
                       int nplanes, int in_stride, int out_stride,
                       int rad_stride, int m, void* stream) {
  if (m == 0) return 0;
  const dim3 grid((m + rtf::kReorderThreads - 1) / rtf::kReorderThreads,
                  (nplanes + 2 + rtf::kGatherGroup - 1) / rtf::kGatherGroup);
  rtf::reorder_gather_kernel<<<grid, rtf::kReorderThreads, 0, (cudaStream_t)stream>>>(
      (const float*)st_in, (float*)st_out, (const int*)rng_in, (int*)rng_out,
      (const long long*)orig_in, (long long*)orig_out, (const long long*)order,
      (const int*)live, (float*)radiance, nplanes, in_stride, out_stride,
      rad_stride, m);
  return (int)cudaGetLastError();
}

const char* rtf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
