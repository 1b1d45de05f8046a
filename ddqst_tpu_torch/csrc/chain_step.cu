// One reverse step of the exhaustive-grid D3PM sampler, for Hopper.
//
// Replaces the TPU kernel ddqst_tpu/ops/pallas_kernels.py::fused_chain_step
// (body _chain_step_kernel). For every chain b of the step:
//     row = rows[b]                 or, with row_base, row_base[b] + x[b]
//     p1  = table[row, :]                           (a gather of N floats)
//     u_q = (philox word >> 8) * 2^-24              (top 24 bits, exact in f32)
//     out[b] = sum_q [u_q < p1_q] << q
// The TPU gathered with a one-hot matrix product on its matrix unit and had
// XLA fuse the row update into the caller; here each thread reads its
// chains' rows straight from global memory through the read-only cache, and
// the row update is the kernel's own first instruction.
//
// Randomness is Philox4x32-10 from philox.cuh, keyed by the 64-bit seed
// with counter (b, step, q / 4, 0); bit q uses word q % 4. The output thus
// depends on neither the launch geometry nor a chain's place in a block,
// and the plain PyTorch version (ops/cuda_kernels.py:
// fused_chain_step_reference) reproduces it bit for bit.
//
// What bounds it on an H100 (3.35 TB/s; 132 SMs whose multiplier pipe and
// add/logic pipe each issue 64 int32 lane instructions a clock at 1.98 GHz,
// 16.7e12 a second each, a 32x32 -> 64-bit product taking two multiplier
// slots): at the circuit-conditioned evaluation shape (B = 6,750,000
// chains, N = 3, a 10,800 x 3 table of 130 KB) one step moves 54 MB in the
// rows form (rows in, outcomes out) and 81 MB with row_base: 16 and 24 us.
// A chain needs at least 18 products (36 multiplier slots) and 28 add/logic
// instructions: 15 us. So it is bound by bytes, with the multiplier close
// behind. The measured times stand in PERF.md.
//
// Design:
// - Four neighbouring chains a thread. Their ids (and bases) come in one
//   16-byte load each and leave in one 16-byte store; then all four rows'
//   gathers are issued before any is used, and the four Philox calls run
//   round by round together. The dependent load -> load chain of one chain
//   hides under the other three, and four independent multiply chains cover
//   the multiply's latency. A ragged end (B not a multiple of 4) or a
//   pointer that is not 16-byte aligned takes 4-byte accesses instead.
// - The compare is integer: each gathered probability becomes its threshold
//   ceil(p * 2^24) once, and a bit is (word >> 8) < threshold.
// - The ten Philox round keys come from the host as a kernel parameter, so
//   no thread adds them up.
// - N <= 8 is a template parameter, so the bit loop unrolls and the
//   thresholds stay in registers; a runtime-N body serves N up to 30.
// - The table is read with __ldg and left to the caches: at the evaluation
//   shape its 130 KB fit the SM's L1, and the chains of one (circuit, basis)
//   are neighbours, so a warp's gathers fall into a few lines. The chains'
//   ids, bases and outcomes are each touched once, so they go past the
//   caches with streaming loads and stores (__ldcs, __stcs) and leave the L1
//   to the table.
// - Blocks of 128 threads: many small blocks fill the SMs' last wave better
//   than few large ones.

#include <cstdint>
#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChains = 4;     // chains a thread
static_assert(kChains % 4 == 0, "chains are loaded four at a time");
constexpr int kMaxN = 30;      // out holds N bits in an int32
constexpr int kMaxUnrollN = 8;  // N up to here is a template parameter

// N_T > 0: N known at compile time. N_T == 0: N = n_rt at run time.
// BASE: `rows` holds the chain state x and the row id is row_base + x.
template <int N_T, bool BASE>
__global__ void __launch_bounds__(kThreads)
chain_step_kernel(const float* __restrict__ table,
                  const int32_t* __restrict__ rows,
                  const int32_t* __restrict__ row_base,
                  int32_t* __restrict__ out, int n_rt, long long b_chains,
                  uint32_t step, const __grid_constant__ ddqst::PhiloxKeys keys,
                  int aligned) {
  const int n = N_T > 0 ? N_T : n_rt;
  const long long b0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kChains;
  if (b0 >= b_chains) return;
  const bool vec = aligned && b0 + kChains <= b_chains;

  int32_t r[kChains];
  if (vec) {
#pragma unroll
    for (int v = 0; v < kChains / 4; ++v) {
      const int4 a = __ldcs(reinterpret_cast<const int4*>(rows + b0) + v);
      r[4 * v] = a.x, r[4 * v + 1] = a.y;
      r[4 * v + 2] = a.z, r[4 * v + 3] = a.w;
      if (BASE) {
        const int4 rb =
            __ldcs(reinterpret_cast<const int4*>(row_base + b0) + v);
        r[4 * v] += rb.x, r[4 * v + 1] += rb.y;
        r[4 * v + 2] += rb.z, r[4 * v + 3] += rb.w;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kChains; ++k) {
      const bool live = b0 + k < b_chains;  // a dead chain reads row 0
      r[k] = live ? __ldcs(rows + b0 + k) : 0;
      if (BASE) r[k] += live ? __ldcs(row_base + b0 + k) : 0;
    }
  }

  uint32_t x[kChains] = {};
  if constexpr (N_T > 0) {
    constexpr int kN = N_T;
    uint32_t thr[kChains][kN];
#pragma unroll
    for (int k = 0; k < kChains; ++k) {
      const float* p1 = table + static_cast<int64_t>(r[k]) * kN;
#pragma unroll
      for (int q = 0; q < kN; ++q) {
        thr[k][q] = ddqst::philox_threshold(__ldg(p1 + q));
      }
    }
#pragma unroll
    for (int qb = 0; qb < (kN + 3) / 4; ++qb) {
      uint4 w[kChains];
#pragma unroll
      for (int k = 0; k < kChains; ++k) {
        w[k] = make_uint4(static_cast<uint32_t>(b0 + k), step,
                          static_cast<uint32_t>(qb), 0u);
      }
      ddqst::philox4x32_10<kChains>(w, keys);
#pragma unroll
      for (int k = 0; k < kChains; ++k) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int q = 4 * qb + j;
          if (q < kN) {
            x[k] |= ddqst::philox_bit(ddqst::philox_word(w[k], j), thr[k][q])
                    << q;
          }
        }
      }
    }
  } else {
    for (int qb = 0; 4 * qb < n; ++qb) {
      uint4 w[kChains];
#pragma unroll
      for (int k = 0; k < kChains; ++k) {
        w[k] = make_uint4(static_cast<uint32_t>(b0 + k), step,
                          static_cast<uint32_t>(qb), 0u);
      }
      ddqst::philox4x32_10<kChains>(w, keys);
#pragma unroll
      for (int k = 0; k < kChains; ++k) {
        const float* p1 = table + static_cast<int64_t>(r[k]) * n;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int q = 4 * qb + j;
          if (q < n) {
            const uint32_t thr = ddqst::philox_threshold(__ldg(p1 + q));
            x[k] |= ddqst::philox_bit(ddqst::philox_word(w[k], j), thr) << q;
          }
        }
      }
    }
  }

  if (vec) {
#pragma unroll
    for (int v = 0; v < kChains / 4; ++v) {
      const int4 o = make_int4(
          static_cast<int>(x[4 * v]), static_cast<int>(x[4 * v + 1]),
          static_cast<int>(x[4 * v + 2]), static_cast<int>(x[4 * v + 3]));
      __stcs(reinterpret_cast<int4*>(out + b0) + v, o);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kChains; ++k) {
      if (b0 + k < b_chains) __stcs(out + b0 + k, static_cast<int32_t>(x[k]));
    }
  }
}

template <int N_T>
int launch(const float* table, const int32_t* rows, const int32_t* row_base,
           int32_t* out, int n, long long b_chains, uint32_t step,
           unsigned long long seed, cudaStream_t stream) {
  constexpr long long kPerBlock = static_cast<long long>(kThreads) * kChains;
  const unsigned int blocks =
      static_cast<unsigned int>((b_chains + kPerBlock - 1) / kPerBlock);
  const ddqst::PhiloxKeys keys = ddqst::philox_keys(seed);
  const uintptr_t bits = reinterpret_cast<uintptr_t>(rows) |
                         reinterpret_cast<uintptr_t>(row_base) |
                         reinterpret_cast<uintptr_t>(out);
  const int aligned = (bits & 15u) == 0;
  if (row_base != nullptr) {
    chain_step_kernel<N_T, true><<<blocks, kThreads, 0, stream>>>(
        table, rows, row_base, out, n, b_chains, step, keys, aligned);
  } else {
    chain_step_kernel<N_T, false><<<blocks, kThreads, 0, stream>>>(
        table, rows, row_base, out, n, b_chains, step, keys, aligned);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes. `row_base` is null (then `rows`
// holds row ids) or a [B] int32 array (then `rows` holds the chain state x
// and the row id is row_base + x). Launches on `stream` (PyTorch's current
// stream), does not synchronise, and returns cudaGetLastError()
// (0 = launched). The Python wrapper checks shapes, types and devices; row
// ids outside [0, G) are the caller's fault and are not checked here.
extern "C" int ddqst_fused_chain_step(const float* table, const int32_t* rows,
                                      const int32_t* row_base, int32_t* out,
                                      long long g_rows, int n,
                                      long long b_chains, unsigned int step,
                                      unsigned long long seed, void* stream) {
  if (n < 1 || n > kMaxN || g_rows < 1 || g_rows >= (1LL << 31) ||
      b_chains < 1 || b_chains > (1LL << 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static_assert(kMaxUnrollN == 8, "the switch below lists N = 1..8");
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DDQST_STEP_CASE(N)                                                  \
  case N:                                                                   \
    return launch<N>(table, rows, row_base, out, n, b_chains, step, seed, s)
  switch (n) {
    DDQST_STEP_CASE(1);
    DDQST_STEP_CASE(2);
    DDQST_STEP_CASE(3);
    DDQST_STEP_CASE(4);
    DDQST_STEP_CASE(5);
    DDQST_STEP_CASE(6);
    DDQST_STEP_CASE(7);
    DDQST_STEP_CASE(8);
    default:
      return launch<0>(table, rows, row_base, out, n, b_chains, step, seed, s);
  }
#undef DDQST_STEP_CASE
}
