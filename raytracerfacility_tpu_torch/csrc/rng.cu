// The TEA seeding kernel, with a plain C interface for ctypes
// (raytracerfacility_tpu_torch/kernels.py builds and loads it;
// ops/rng.py::lcg_init launches it).
//
// tea_init_kernel replaces no TPU kernel: it replaces the XLA glue of
// raytracerfacility_tpu/ops/rng.py::lcg_init, the 16-round TEA hash of the
// reference's LinearCongruenceGenerator<16>::Init
// (LinearCongruenceGenerator.hpp:15-26) that seeds the RNG of every camera
// and probe ray. In plain PyTorch it is 386 int64 elementwise launches a
// pool (two masks, then 16 rounds of 24 operations, each add and shift
// followed by a mask); here it is one.
//
// Bound on this card by its integer instructions and its bytes alike: the
// hash's 160 instructions a word (tea.cuh) at 128 an SM a clock (the ALU
// pipe's shifts and logic beside the adds nvcc moves to the FMA pipe) take
// as long as its 16 bytes a word (the int64 word read, the int64 state
// written) at 3.35 TB/s. One thread a word runs tea.cuh's unrolled rounds
// in registers, one load and one store, and no mask. A full card of
// threads (2,048 an SM) hides the latency of each thread's chain of
// dependent instructions.

#include <cuda_runtime.h>

#include "tea.cuh"

namespace rtf {

constexpr int kTeaThreads = 256;

// val0: (n,) int64, word i's first value in its low 32 bits; val1: (n /
// run,) int64, word k seeding words [k * run, (k + 1) * run) (run = 1: one
// value a word; run = n: one value for all); out: (n,) int64, the state
// zero-extended.
__global__ void __launch_bounds__(kTeaThreads)
tea_init_kernel(const long long* __restrict__ val0,
                const long long* __restrict__ val1,
                long long* __restrict__ out, int n, int run) {
  const unsigned i = blockIdx.x * kTeaThreads + threadIdx.x;
  if (i >= (unsigned)n) return;
  const unsigned v0 = (unsigned)__ldg(val0 + i);
  const unsigned v1 = (unsigned)__ldg(val1 + (run == 1 ? i : i / (unsigned)run));
  out[i] = (long long)tea_hash(v0, v1);
}

}  // namespace rtf

extern "C" {

int rtf_tea_init(const void* val0, const void* val1, void* out, int n, int run,
                 void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + rtf::kTeaThreads - 1) / rtf::kTeaThreads;
  rtf::tea_init_kernel<<<blocks, rtf::kTeaThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)val0, (const long long*)val1, (long long*)out, n, run);
  return (int)cudaGetLastError();
}

const char* rtf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
