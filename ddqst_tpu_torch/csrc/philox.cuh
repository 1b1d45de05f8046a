// Philox4x32-10 (Salmon et al., SC'11; Random123), shared by the port's
// kernels. A counter-based generator: the four output words depend only on
// the 128-bit counter and the 64-bit key, so a kernel that derives its
// counter from the chain's index (never from the launch geometry) draws the
// same bits however it is launched, and the plain PyTorch version
// (ops/cuda_kernels.py:philox4x32_10) reproduces them bit for bit.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ddqst {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

__device__ __forceinline__ void philox_round(uint4& ctr, uint32_t k0,
                                             uint32_t k1) {
  const uint32_t lo0 = kPhiloxM0 * ctr.x;
  const uint32_t hi0 = __umulhi(kPhiloxM0, ctr.x);
  const uint32_t lo1 = kPhiloxM1 * ctr.z;
  const uint32_t hi1 = __umulhi(kPhiloxM1, ctr.z);
  ctr = make_uint4(hi1 ^ ctr.y ^ k0, lo1, hi0 ^ ctr.w ^ k1, lo0);
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    philox_round(ctr, k0, k1);
  }
  return ctr;
}

__device__ __forceinline__ uint32_t philox_word(const uint4& w, int k) {
  return k == 0 ? w.x : k == 1 ? w.y : k == 2 ? w.z : w.w;
}

// A uniform in [0, 1) from the top 24 bits of a word: exact in float32.
__device__ __forceinline__ float philox_uniform(uint32_t word) {
  return static_cast<float>(word >> 8) * (1.0f / 16777216.0f);
}

}  // namespace ddqst
