// A measuring tool, not a kernel of the port: the rate at which one GPU
// issues 32-bit lane instructions of one kind, for the bounds that
// chip_smoke.py holds the port's kernels to.
//
// Every thread keeps 8 accumulators and runs `iters` times over an unrolled
// body of 4 x 8 instructions of the chosen kind. Each instruction reads its
// neighbours' accumulators, so every intermediate value is used and the
// assembler can neither fold two instructions into one nor drop any; the 8
// chains are independent enough (a value is needed again 7 instructions
// later) to cover the pipe's latency. A launch issues
// blocks x threads x iters x 32 lane instructions; chip_smoke.py times it
// with CUDA events and counts the loop body in the SASS as a check.
//
// Modes: 0 mad.lo.u32 (IMAD), 1 mul.wide.u32 (IMAD.WIDE.U32, the Philox
// multiply; it takes one product's low and another's high half, so both
// halves are used), 2 lop3.b32 (LOP3), 3 add.u32 (IADD3), 4 fma.rn.f32
// (FFMA, for comparison), 5 mul.wide.u32 and lop3.b32 in turns (Philox's own
// mix of multiplies and logic, to see whether the two kinds share one pipe),
// 6 mul.hi.u32 (IMAD.HI.U32, a product's high half alone).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kAcc = 8;
constexpr int kRounds = 4;  // kRounds x kAcc instructions a loop trip

template <int MODE>
__global__ void int_rate_kernel(uint32_t* __restrict__ out, int iters,
                                uint32_t salt) {
  const uint32_t tid = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t a[kAcc];
  uint64_t d[kAcc];
  float f[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    a[j] = tid * 2654435761u + salt * (j + 1);
    d[j] = (static_cast<uint64_t>(a[j]) << 32) | (a[j] ^ salt);
    f[j] = 1.0f + static_cast<float>((a[j] >> 9) & 1023u) * 1e-6f;
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
#pragma unroll
      for (int j = 0; j < kAcc; ++j) {
        const int j1 = (j + 1) % kAcc, j2 = (j + 2) % kAcc;
        if (MODE == 0) {
          asm volatile("mad.lo.u32 %0, %0, %1, %2;"
                       : "+r"(a[j]) : "r"(a[j1]), "r"(a[j2]));
        } else if (MODE == 1) {
          asm volatile("mul.wide.u32 %0, %1, %2;"
                       : "=l"(d[j])
                       : "r"(static_cast<uint32_t>(d[j1])),
                         "r"(static_cast<uint32_t>(d[j2] >> 32)));
        } else if (MODE == 2) {
          asm volatile("lop3.b32 %0, %0, %1, %2, 0x96;"
                       : "+r"(a[j]) : "r"(a[j1]), "r"(a[j2]));
        } else if (MODE == 3) {
          asm volatile("add.u32 %0, %0, %1;" : "+r"(a[j]) : "r"(a[j1]));
        } else if (MODE == 4) {
          asm volatile("fma.rn.f32 %0, %0, %1, %2;"
                       : "+f"(f[j]) : "f"(f[j1]), "f"(f[j2]));
        } else if (MODE == 6) {
          asm volatile("mul.hi.u32 %0, %1, %2;"
                       : "=r"(a[j]) : "r"(a[j1]), "r"(a[j2]));
        } else if (j % 2 == 0) {
          asm volatile("mul.wide.u32 %0, %1, %2;"
                       : "=l"(d[j])
                       : "r"(static_cast<uint32_t>(d[(j + 2) % kAcc])),
                         "r"(static_cast<uint32_t>(d[(j + 4) % kAcc] >> 32)));
        } else {
          asm volatile("lop3.b32 %0, %0, %1, %2, 0x96;"
                       : "+r"(a[j])
                       : "r"(a[(j + 2) % kAcc]), "r"(a[(j + 4) % kAcc]));
        }
      }
    }
  }
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    acc ^= a[j] ^ static_cast<uint32_t>(d[j]) ^
           static_cast<uint32_t>(d[j] >> 32) ^ __float_as_uint(f[j]);
  }
  out[tid] = acc;
}

}  // namespace

// Launches one measuring kernel on `stream` and returns cudaGetLastError().
// `out` holds blocks x threads words. The lane instructions issued are
// blocks x threads x iters x 32.
extern "C" int ddqst_int_rate(int mode, uint32_t* out, int blocks, int threads,
                              int iters, void* stream) {
  if (blocks < 1 || threads < 32 || threads > 1024 || iters < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DDQST_RATE_CASE(M)                                       \
  case M:                                                        \
    int_rate_kernel<M><<<blocks, threads, 0, s>>>(out, iters, 7u); \
    break
  switch (mode) {
    DDQST_RATE_CASE(0);
    DDQST_RATE_CASE(1);
    DDQST_RATE_CASE(2);
    DDQST_RATE_CASE(3);
    DDQST_RATE_CASE(4);
    DDQST_RATE_CASE(5);
    DDQST_RATE_CASE(6);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DDQST_RATE_CASE
  return static_cast<int>(cudaGetLastError());
}
