// A measuring tool, not a kernel of the port: variants of the chain walk's
// global-memory body at N = 10 and N = 12, each with one part of its work
// taken out or changed, so that chip_smoke.py can time what each part costs
// at the shadow route's shape (T=100, C=100, S=5,000). No profiler runs on
// the card's machine, so the split comes from these times and from the SASS
// of each variant's step loop.
//
// Modes (the Philox counter, the walk and the launch are the body's own):
//   0 Philox and bits only: no table is read; the thresholds are a shift
//     and an add of the state (so each step still depends on the last);
//   1 the loads without the conversion: the threshold is the low 24 bits of
//     the probability's float bits (no FMUL, no F2I);
//   2 the plain global body (chain_walk.cu walked N = 8 to 16 with it
//     before the ring and gather bodies): N 4-byte loads and N conversions;
//   3 N/2 8-byte loads (a row starts at x * N * 4 bytes, 8-byte aligned at
//     even N), then the conversions;
//   4 16-byte loads from rows of kWide words (N rounded up to a multiple of
//     4: at N = 10 a copy of the tables padded to 12 words, at N = 12 the
//     tables as they are), then the conversions;
//   5 the loads and conversions of mode 2 alone: the bits come from one
//     multiply of the chain and step indices, not from Philox;
//   6 the loads and conversions of mode 4 alone, the bits as in mode 5;
//   7 mode 4 with an L2 prefetch: the blocks of a row split each step slice,
//     and each block's thread 0 asks the TMA unit, on reaching step i, to
//     bring its share of step i + 1 into L2;
//   8 mode 7 two steps ahead;
//   9 mode 7 with the 16-byte loads through L2 only (ld.global.cg).
// Modes 2, 3, 4, 7, 8 and 9 give the walk's bits; the others exist to be
// timed.

#include <cstdint>
#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

__device__ __forceinline__ void prefetch_l2(const void* p, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p),
               "r"(bytes)
               : "memory");
}

template <int N, int MODE>
__global__ void walk_ablation_kernel(const float* __restrict__ tables,
                                     const int32_t* __restrict__ init,
                                     int32_t* __restrict__ out, int t_steps,
                                     int c_rows, int s_chains,
                                     const __grid_constant__ ddqst::PhiloxKeys
                                         keys) {
  constexpr int kWide = (N + 3) / 4 * 4;
  constexpr bool kVector = MODE == 4 || MODE >= 6;
  constexpr int kStride = kVector ? kWide : N;  // words a table row
  constexpr int kSlice = (1 << N) * kStride;
  constexpr int kAhead = MODE == 8 ? 2 : (MODE == 7 || MODE == 9) ? 1 : 0;
  const int c = blockIdx.y;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= s_chains) return;
  const int64_t row = static_cast<int64_t>(c) * s_chains + s;
  const int64_t step_stride = static_cast<int64_t>(c_rows) * kSlice;
  const float* slice = tables + static_cast<int64_t>(c) * kSlice;
  // This block's share of a slice for the prefetch, in 16-byte units.
  constexpr uint32_t kSliceBytes = kSlice * 4u;
  const uint32_t share =
      (kSliceBytes / 16u + gridDim.x - 1u) / gridDim.x * 16u;
  const uint32_t share_lo = min(kSliceBytes, blockIdx.x * share);
  const uint32_t share_bytes = min(share, kSliceBytes - share_lo);
  auto ask = [&](int i) {
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(slice + i * step_stride) +
        share_lo;
    for (uint32_t off = 0; off < share_bytes; off += 48u * 1024u) {
      prefetch_l2(src + off, min(48u * 1024u, share_bytes - off));
    }
  };
  if (kAhead > 0 && threadIdx.x == 0) {
    for (int i = 0; i < min(kAhead, t_steps); ++i) ask(i);
  }
  uint32_t x = static_cast<uint32_t>(__ldcs(init + row));
#pragma unroll 2
  for (int i = 0; i < t_steps; ++i, slice += step_stride) {
    if (kAhead > 0 && threadIdx.x == 0 && i + kAhead < t_steps) ask(kAhead);
    const float* p1 = slice + x * kStride;
    uint32_t thr[N];
    if constexpr (MODE == 0) {
#pragma unroll
      for (int q = 0; q < N; ++q) thr[q] = (1u << 23) + (x << q);
    } else if constexpr (MODE == 1) {
#pragma unroll
      for (int q = 0; q < N; ++q) {
        thr[q] = __float_as_uint(__ldg(p1 + q)) & 0xFFFFFFu;
      }
    } else if constexpr (MODE == 3) {
#pragma unroll
      for (int q = 0; q < N; q += 2) {
        const float2 v = __ldg(reinterpret_cast<const float2*>(p1 + q));
        thr[q] = ddqst::philox_threshold(v.x);
        thr[q + 1] = ddqst::philox_threshold(v.y);
      }
    } else if constexpr (kVector) {
#pragma unroll
      for (int q = 0; q < kWide; q += 4) {
        const float4* src = reinterpret_cast<const float4*>(p1 + q);
        const float4 v = MODE == 9 ? __ldcg(src) : __ldg(src);
        const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (q + k < N) thr[q + k] = ddqst::philox_threshold(f[k]);
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < N; ++q) {
        thr[q] = ddqst::philox_threshold(__ldg(p1 + q));
      }
    }
    uint32_t nx = 0u;
    if constexpr (MODE == 5 || MODE == 6) {
      const uint32_t h = (static_cast<uint32_t>(s) * 0x9E3779B9u) ^
                         (static_cast<uint32_t>(i) * 0x85EBCA6Bu);
#pragma unroll
      for (int q = 0; q < N; ++q) {
        nx |= ddqst::philox_bit(h << (q & 7), thr[q]) << q;
      }
    } else {
#pragma unroll
      for (int qb = 0; qb < (N + 3) / 4; ++qb) {
        const uint4 w = ddqst::philox4x32_10(
            make_uint4(static_cast<uint32_t>(s), static_cast<uint32_t>(c),
                       static_cast<uint32_t>(i), static_cast<uint32_t>(qb)),
            keys);
#pragma unroll
        for (int jq = 0; jq < 4; ++jq) {
          const int q = 4 * qb + jq;
          if (q < N) {
            nx |= ddqst::philox_bit(ddqst::philox_word(w, jq), thr[q]) << q;
          }
        }
      }
    }
    x = nx;
  }
  __stcs(out + row, static_cast<int32_t>(x));
}

template <int N>
int launch(int mode, const dim3& grid, int threads, cudaStream_t st,
           const float* tables, const int32_t* init, int32_t* out,
           int t_steps, int c_rows, int s_chains,
           const ddqst::PhiloxKeys& keys) {
#define DDQST_ABLATION_CASE(M)                                            \
  case M:                                                                 \
    walk_ablation_kernel<N, M><<<grid, threads, 0, st>>>(                 \
        tables, init, out, t_steps, c_rows, s_chains, keys);              \
    break
  switch (mode) {
    DDQST_ABLATION_CASE(0);
    DDQST_ABLATION_CASE(1);
    DDQST_ABLATION_CASE(2);
    DDQST_ABLATION_CASE(3);
    DDQST_ABLATION_CASE(4);
    DDQST_ABLATION_CASE(5);
    DDQST_ABLATION_CASE(6);
    DDQST_ABLATION_CASE(7);
    DDQST_ABLATION_CASE(8);
    DDQST_ABLATION_CASE(9);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DDQST_ABLATION_CASE
  return static_cast<int>(cudaGetLastError());
}

// Lockstep variants at N = 12: a thread walks K chains of one row (s =
// (blockIdx.x * K + j) * blockDim.x + threadIdx.x), all in turn each step;
// with `barrier` the block's threads meet after every step, so its warps
// walk one slice at a time; `prefetch` 0 asks for nothing, 1 for this
// block's share of the next step's slice, 2 for the whole next slice, 3
// for the whole slice two steps ahead (thread 0, after the barrier).
template <int K>
__global__ void walk_lockstep_kernel(const float* __restrict__ tables,
                                     const int32_t* __restrict__ init,
                                     int32_t* __restrict__ out, int t_steps,
                                     int c_rows, int s_chains, int barrier,
                                     int prefetch,
                                     const __grid_constant__ ddqst::PhiloxKeys
                                         keys) {
  constexpr int N = 12;
  constexpr int kSlice = (1 << N) * N;
  constexpr uint32_t kSliceBytes = kSlice * 4u;
  const int c = blockIdx.y;
  const int64_t step_stride = static_cast<int64_t>(c_rows) * kSlice;
  const float* slice = tables + static_cast<int64_t>(c) * kSlice;
  int s[K];
  bool live[K];
  uint32_t x[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    s[j] = (blockIdx.x * K + j) * blockDim.x + threadIdx.x;
    live[j] = s[j] < s_chains;
    x[j] = live[j] ? static_cast<uint32_t>(
                         __ldcs(init + static_cast<int64_t>(c) * s_chains + s[j]))
                   : 0u;
  }
  const uint32_t share =
      (kSliceBytes / 16u + gridDim.x - 1u) / gridDim.x * 16u;
  const uint32_t lo = prefetch == 1 ? min(kSliceBytes, blockIdx.x * share) : 0u;
  const uint32_t bytes =
      prefetch == 1 ? min(share, kSliceBytes - lo) : kSliceBytes;
  const int ahead = prefetch == 3 ? 2 : 1;
  auto ask = [&](int i) {
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(slice + i * step_stride) + lo;
    for (uint32_t off = 0; off < bytes; off += 48u * 1024u) {
      prefetch_l2(src + off, min(48u * 1024u, bytes - off));
    }
  };
  if (prefetch > 0 && threadIdx.x == 0) {
    for (int i = 0; i < min(ahead, t_steps); ++i) ask(i);
  }
  for (int i = 0; i < t_steps; ++i, slice += step_stride) {
    if (barrier) __syncthreads();
    if (prefetch > 0 && threadIdx.x == 0 && i + ahead < t_steps) ask(ahead);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float* p1 = slice + x[j] * N;
      float p[N];
#pragma unroll
      for (int q = 0; q < N; q += 4) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(p1 + q));
        p[q] = v.x;
        p[q + 1] = v.y;
        p[q + 2] = v.z;
        p[q + 3] = v.w;
      }
      uint4 w[3];
#pragma unroll
      for (int qb = 0; qb < 3; ++qb) {
        w[qb] = make_uint4(static_cast<uint32_t>(s[j]),
                           static_cast<uint32_t>(c),
                           static_cast<uint32_t>(i),
                           static_cast<uint32_t>(qb));
      }
      ddqst::philox4x32_10<3>(w, keys);
      uint32_t nx = 0u;
#pragma unroll
      for (int q = 0; q < N; ++q) {
        nx |= ddqst::philox_bit(ddqst::philox_word(w[q / 4], q % 4),
                                ddqst::philox_threshold(p[q]))
              << q;
      }
      x[j] = nx;
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (live[j]) {
      __stcs(out + static_cast<int64_t>(c) * s_chains + s[j],
             static_cast<int32_t>(x[j]));
    }
  }
}

template <int K>
int launch_lockstep(const dim3& grid, int threads, int smem, int carveout,
                    cudaStream_t st, const float* tables, const int32_t* init,
                    int32_t* out, int t_steps, int c_rows, int s_chains,
                    int barrier, int prefetch, const ddqst::PhiloxKeys& keys,
                    int* resident) {
  const void* kernel = reinterpret_cast<const void*>(walk_lockstep_kernel<K>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, carveout);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, kernel,
                                                        threads, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  walk_lockstep_kernel<K><<<grid, threads, smem, st>>>(
      tables, init, out, t_steps, c_rows, s_chains, barrier, prefetch, keys);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The lockstep variants (N = 12, [T, C, 4096, 12] tables as they are): K =
// 1, 2 or 4 chains a thread, a block barrier a step or none, the prefetch
// modes above, `smem` bytes of unused dynamic shared memory a block (which
// bounds the blocks an SM holds) and the preferred shared-memory carveout
// in percent (-1: left to CUDA; 0: the most L1); the blocks an SM
// holds go to `resident`. Returns cudaGetLastError().
extern "C" int ddqst_walk_lockstep(int k, int barrier, int prefetch, int smem,
                                   int carveout, const float* tables,
                                   const int32_t* init, int32_t* out,
                                   int t_steps, int c_rows, int s_chains,
                                   int threads, unsigned long long seed,
                                   int* resident, void* stream) {
  if (t_steps < 1 || c_rows < 1 || c_rows > 65535 || s_chains < 1 ||
      threads < 32 || threads > 1024 || prefetch < 0 || prefetch > 3 ||
      smem < 0 || carveout < -1 || carveout > 100) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((s_chains + threads * k - 1) / (threads * k), c_rows);
  const ddqst::PhiloxKeys keys = ddqst::philox_keys(seed);
  switch (k) {
    case 1:
      return launch_lockstep<1>(grid, threads, smem, carveout, st, tables,
                                init, out, t_steps, c_rows, s_chains, barrier,
                                prefetch, keys, resident);
    case 2:
      return launch_lockstep<2>(grid, threads, smem, carveout, st, tables,
                                init, out, t_steps, c_rows, s_chains, barrier,
                                prefetch, keys, resident);
    case 4:
      return launch_lockstep<4>(grid, threads, smem, carveout, st, tables,
                                init, out, t_steps, c_rows, s_chains, barrier,
                                prefetch, keys, resident);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Launches one variant on `stream` over [T, C, 2^N, N] tables (rows of N
// rounded up to a multiple of 4 words for modes 4 and 6-9), N = 10 or 12,
// and returns cudaGetLastError(). `init` and `out` are [C, S] int32.
extern "C" int ddqst_walk_ablation(int n, int mode, const float* tables,
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
  if (n == 10) {
    return launch<10>(mode, grid, threads, st, tables, init, out, t_steps,
                      c_rows, s_chains, keys);
  }
  if (n == 12) {
    return launch<12>(mode, grid, threads, st, tables, init, out, t_steps,
                      c_rows, s_chains, keys);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
