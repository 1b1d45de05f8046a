// A measuring tool, not a kernel of the port: variants of the chain walk's
// global-memory body (chain_walk.cu, chain_walk_global_kernel) at N = 10,
// each with one part of its work taken out or changed, so that chip_smoke.py
// can time what each part costs at the shadow route's shape. No profiler
// runs on the card's machine, so the split comes from these times and from
// the SASS of each variant's step loop.
//
// Modes (the Philox counter, the walk and the launch are the body's own):
//   0 Philox and bits only: no table is read; the thresholds are a shift
//     and an add of the state (so each step still depends on the last);
//   1 the loads without the conversion: the threshold is the low 24 bits of
//     the probability's float bits (no FMUL, no F2I);
//   2 the body as it stands: N 4-byte loads and N conversions;
//   3 N/2 8-byte loads (a row starts at x * N * 4 bytes, 8-byte aligned at
//     even N), then the conversions;
//   4 N/4 16-byte loads from a copy of the tables with rows padded to 12
//     words, then the conversions;
//   5 the loads and conversions alone: the bits come from one multiply of
//     the chain and step indices, not from Philox.
// Only mode 2 gives the walk's bits; the others exist to be timed.

#include <cstdint>
#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

constexpr int kN = 10;

template <int MODE>
__global__ void walk_ablation_kernel(const float* __restrict__ tables,
                                     const int32_t* __restrict__ init,
                                     int32_t* __restrict__ out, int t_steps,
                                     int c_rows, int s_chains,
                                     const __grid_constant__ ddqst::PhiloxKeys
                                         keys) {
  constexpr int kStride = MODE == 4 ? 12 : kN;  // words a table row
  constexpr int kSlice = (1 << kN) * kStride;
  const int c = blockIdx.y;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= s_chains) return;
  const int64_t row = static_cast<int64_t>(c) * s_chains + s;
  const int64_t step_stride = static_cast<int64_t>(c_rows) * kSlice;
  const float* slice = tables + static_cast<int64_t>(c) * kSlice;
  uint32_t x = static_cast<uint32_t>(__ldcs(init + row));
#pragma unroll 2
  for (int i = 0; i < t_steps; ++i, slice += step_stride) {
    const float* p1 = slice + x * kStride;
    uint32_t thr[kN];
    if constexpr (MODE == 0) {
#pragma unroll
      for (int q = 0; q < kN; ++q) thr[q] = (1u << 23) + (x << q);
    } else if constexpr (MODE == 1) {
#pragma unroll
      for (int q = 0; q < kN; ++q) {
        thr[q] = __float_as_uint(__ldg(p1 + q)) & 0xFFFFFFu;
      }
    } else if constexpr (MODE == 3) {
#pragma unroll
      for (int q = 0; q < kN; q += 2) {
        const float2 v = __ldg(reinterpret_cast<const float2*>(p1 + q));
        thr[q] = ddqst::philox_threshold(v.x);
        thr[q + 1] = ddqst::philox_threshold(v.y);
      }
    } else if constexpr (MODE == 4) {
#pragma unroll
      for (int q = 0; q < 12; q += 4) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(p1 + q));
        const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (q + k < kN) thr[q + k] = ddqst::philox_threshold(f[k]);
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < kN; ++q) {
        thr[q] = ddqst::philox_threshold(__ldg(p1 + q));
      }
    }
    uint32_t nx = 0u;
    if constexpr (MODE == 5) {
      const uint32_t h = (static_cast<uint32_t>(s) * 0x9E3779B9u) ^
                         (static_cast<uint32_t>(i) * 0x85EBCA6Bu);
#pragma unroll
      for (int q = 0; q < kN; ++q) {
        nx |= ddqst::philox_bit(h << (q & 7), thr[q]) << q;
      }
    } else {
#pragma unroll
      for (int qb = 0; qb < (kN + 3) / 4; ++qb) {
        const uint4 w = ddqst::philox4x32_10(
            make_uint4(static_cast<uint32_t>(s), static_cast<uint32_t>(c),
                       static_cast<uint32_t>(i), static_cast<uint32_t>(qb)),
            keys);
#pragma unroll
        for (int jq = 0; jq < 4; ++jq) {
          const int q = 4 * qb + jq;
          if (q < kN) {
            nx |= ddqst::philox_bit(ddqst::philox_word(w, jq), thr[q]) << q;
          }
        }
      }
    }
    x = nx;
  }
  __stcs(out + row, static_cast<int32_t>(x));
}

}  // namespace

// Launches one variant on `stream` over [T, C, 1024, 10] tables (rows of 12
// words for mode 4) and returns cudaGetLastError(). `init` and `out` are
// [C, S] int32.
extern "C" int ddqst_walk_ablation(int mode, const float* tables,
                                   const int32_t* init, int32_t* out,
                                   int t_steps, int c_rows, int s_chains,
                                   int threads, unsigned long long seed,
                                   void* stream) {
  if (t_steps < 1 || c_rows < 1 || c_rows > 65535 || s_chains < 1 ||
      threads < 32 || threads > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((s_chains + threads - 1) / threads, c_rows);
  const ddqst::PhiloxKeys keys = ddqst::philox_keys(seed);
#define DDQST_ABLATION_CASE(M)                                            \
  case M:                                                                 \
    walk_ablation_kernel<M><<<grid, threads, 0, st>>>(                    \
        tables, init, out, t_steps, c_rows, s_chains, keys);              \
    break
  switch (mode) {
    DDQST_ABLATION_CASE(0);
    DDQST_ABLATION_CASE(1);
    DDQST_ABLATION_CASE(2);
    DDQST_ABLATION_CASE(3);
    DDQST_ABLATION_CASE(4);
    DDQST_ABLATION_CASE(5);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DDQST_ABLATION_CASE
  return static_cast<int>(cudaGetLastError());
}
