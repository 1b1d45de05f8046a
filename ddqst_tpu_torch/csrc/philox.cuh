// Philox4x32-10 (Salmon et al., SC'11; Random123), shared by the port's
// kernels. A counter-based generator: the four output words depend only on
// the 128-bit counter and the 64-bit key, so a kernel that derives its
// counter from the chain's index (never from the launch geometry) draws the
// same bits however it is launched, and the plain PyTorch version
// (ops/cuda_kernels.py:philox4x32_10) reproduces them bit for bit.
//
// A round is two 32x32 -> 64-bit products (one IMAD.WIDE.U32 each: both
// halves from one instruction) and two three-input XORs (one LOP3 each): 40
// integer instructions a call, half on the multiplier's pipe, half on the
// add/logic pipe. The ten round keys depend on the seed alone, so the host
// makes them once per launch (PhiloxKeys, a kernel parameter: the XORs read
// them straight from the constant bank) and no thread spends the 18 key
// additions of a call.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ddqst {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

// The key of round r: (k0 + r * W0, k1 + r * W1) mod 2^32.
struct PhiloxKeys {
  uint32_t k0[10];
  uint32_t k1[10];
};

inline PhiloxKeys philox_keys(unsigned long long seed) {
  PhiloxKeys keys;
  uint32_t k0 = static_cast<uint32_t>(seed & 0xFFFFFFFFull);
  uint32_t k1 = static_cast<uint32_t>(seed >> 32);
  for (int r = 0; r < 10; ++r) {
    keys.k0[r] = k0;
    keys.k1[r] = k1;
    k0 += kPhiloxW0;
    k1 += kPhiloxW1;
  }
  return keys;
}

__device__ __forceinline__ void philox_round(uint4& ctr, uint32_t k0,
                                             uint32_t k1) {
  const uint64_t p0 = static_cast<uint64_t>(kPhiloxM0) * ctr.x;
  const uint64_t p1 = static_cast<uint64_t>(kPhiloxM1) * ctr.z;
  ctr = make_uint4(static_cast<uint32_t>(p1 >> 32) ^ ctr.y ^ k0,
                   static_cast<uint32_t>(p1),
                   static_cast<uint32_t>(p0 >> 32) ^ ctr.w ^ k1,
                   static_cast<uint32_t>(p0));
}

// M independent calls, round by round: the rounds of one call depend on each
// other, those of different calls do not, so the multiplies of M calls are
// in flight together.
template <int M>
__device__ __forceinline__ void philox4x32_10(uint4 (&ctr)[M],
                                              const PhiloxKeys& keys) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
#pragma unroll
    for (int m = 0; m < M; ++m) philox_round(ctr[m], keys.k0[r], keys.k1[r]);
  }
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr,
                                               const PhiloxKeys& keys) {
  uint4 one[1] = {ctr};
  philox4x32_10<1>(one, keys);
  return one[0];
}

__device__ __forceinline__ uint32_t philox_word(const uint4& w, int k) {
  return k == 0 ? w.x : k == 1 ? w.y : k == 2 ? w.z : w.w;
}

// The draw is u = (word >> 8) * 2^-24, a uniform in [0, 1) from the top 24
// bits, exact in float32, and a bit is [u < p]. Scaling by 2^24 is exact, so
// u < p  <=>  (word >> 8) < p * 2^24  <=>  (word >> 8) < ceil(p * 2^24):
// one conversion of p replaces the int -> float and the multiply of every
// draw. p <= 0 and NaN give 0 (never), p >= 1 gives at least 2^24 (always),
// and the conversion saturates at 2^32 - 1, all as u < p answers.
__device__ __forceinline__ uint32_t philox_threshold(float p) {
  return __float2uint_ru(p * 16777216.0f);
}

__device__ __forceinline__ uint32_t philox_bit(uint32_t word, uint32_t thr) {
  return (word >> 8) < thr ? 1u : 0u;
}

}  // namespace ddqst
