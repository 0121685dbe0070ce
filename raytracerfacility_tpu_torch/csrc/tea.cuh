// The 16-round TEA hash of the reference's LinearCongruenceGenerator<16>::Init
// (LinearCongruenceGenerator.hpp:15-26), which seeds the RNG of every camera
// and probe ray: rng.cu's tea_init_kernel and probe.cu's probe_ray_kernel
// run it, ops/rng.py::_lcg_init_plain is its plain version.
//
// Both halves are uint32 in registers, whose wrap is the plain version's
// `& 0xFFFFFFFF`; the 16 rounds are unrolled with their running sums folded
// to constants. A half of a round is 8 operations (2 shifts, 4 adds, 2
// xors), which the ISA encodes as 5 (a shift-left-add, LEA; a
// shift-right-add, LEA.HI; the add of the round's sum; a three-way xor,
// LOP3; the accumulating add): 160 integer instructions a word.
#pragma once

namespace rtf {

constexpr int kTeaRounds = 16;

// The hash of (v0, v1): the state the LCG starts from.
__device__ __forceinline__ unsigned tea_hash(unsigned v0, unsigned v1) {
  unsigned s0 = 0;
#pragma unroll
  for (int r = 0; r < kTeaRounds; ++r) {
    s0 += 0x9E3779B9u;
    v0 += ((v1 << 4) + 0xA341316Cu) ^ (v1 + s0) ^ ((v1 >> 5) + 0xC8013EA4u);
    v1 += ((v0 << 4) + 0xAD90777Du) ^ (v0 + s0) ^ ((v0 >> 5) + 0x7E95761Eu);
  }
  return v0;
}

}  // namespace rtf
