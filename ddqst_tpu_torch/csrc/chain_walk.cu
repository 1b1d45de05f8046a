// Fused reverse chain walk of the exhaustive-grid D3PM sampler, for Hopper.
//
// Replaces the TPU kernel ddqst_tpu/ops/pallas_kernels.py::fused_chain_walk
// (body _chain_walk_kernel). It runs the whole T-step table walk in one
// launch: for every chain (c, s) and every step i = 0..T-1
//     p1 = tables[i, c, x, :]                       (i = 0 is t = T)
//     u_q = (philox word >> 8) * 2^-24              (top 24 bits, exact in f32)
//     x  <- sum_q [u_q < p1_q] << q
// starting from x = init[c, s]; out[c, s] is the final x.
//
// Randomness is counter-based Philox4x32-10 from philox.cuh (not curand),
// keyed by the 64-bit seed with counter (s, c, i, q / 4); bit q uses word
// q % 4. The output therefore does not depend on the launch geometry, and
// the plain PyTorch version (ops/cuda_kernels.py:fused_chain_walk_reference)
// reproduces it bit for bit.
//
// What bounds it on an H100 (3.35 TB/s; 132 SMs whose multiplier pipe and
// add/logic pipe each issue 64 int32 lane instructions a clock at 1.98 GHz,
// 16.7e12 a second each, a 32x32 -> 64-bit product taking two multiplier
// slots): at the main-path shape (T=100, C=27, 2^N=8, N=3, S=5,000) it
// moves 1.3 MB (init and out at 135,000 x 4 B each, plus the 259 KB of
// tables), 0.4 us, but each of its 13.5 M chain steps needs at least 17
// products (34 multiplier slots) beside 27 add/logic instructions: 27 us.
// It is bound by the integer multiplier, not by bytes. At the shadow
// route's shape (T=100, C=100 sampled bases, 2^N=1024, N=10, S=5,000) it
// moves 413.6 MB of tables, 0.124 ms, and its 1.5e8 Philox calls need
// 0.305 ms of multiplier slots: bound by operations again. The measured
// times stand in PERF.md.
//
// Design:
// - One thread per chain, the state x in a register across the T-step loop
//   (which takes the place of the TPU's sequential t grid axis), init read
//   once and out written once. A block walks a tile of one conditioning
//   row's chains and masks the ragged end of S itself.
// - The row's table slices ([2^N, N] floats a step) come into shared memory
//   ahead of use: one thread issues a 1-D bulk copy (cp.async.bulk, the TMA
//   unit) per step slice onto an mbarrier that counts the bytes. When all T
//   slices fit (9.6 KB at N=3, 64 KB at N=5, T=100) they are loaded at once
//   and the step loop holds no barrier at all. Otherwise (N = 6, 7) the
//   steps go through a ring of two chunks of at least 8 steps, the next
//   chunk in flight while this one is walked, one __syncthreads a chunk.
//   A slice of fewer than 16 bytes (N = 1) or a table pointer that is not
//   16-byte aligned takes plain loads into the same ring.
// - After a chunk lands, one pass turns each probability into its integer
//   threshold ceil(p * 2^24) in place; a step then shifts, compares and
//   ORs, with no conversion per chain and step.
// - The draws of step i+1 need only (s, c, i+1), not x. With no barrier in
//   the step loop and the loop unrolled by 4, the compiler issues the next
//   steps' Philox rounds under this step's shared-memory lookup.
// - The ten Philox round keys come from the host as a kernel parameter, and
//   the first round, which sees only the counter, is left to the compiler:
//   its products are loop-invariant or the same for a whole warp.
// - The block size (64 to 512 threads) is chosen per shape so that the
//   busiest SM's share of blocks, each costed as its chains' steps plus the
//   staging of its slices, is least: at the main shape 1,080 blocks of 128
//   threads (8.2 an SM) in place of 540 of 256 (4.1 an SM, a 5-against-4
//   tail); at 10^6 chains blocks of 512, which stage a row's slices for more
//   chains. The counter is the chain's index, so the output cannot depend
//   on the choice.
//
// N = 8 to 16 (2^N = 256 to 65,536 outcomes: the shadow route's tables at
// N = 10, and the full grid's at N = 8) take a second body that stages
// nothing. One step's slice is 2^N * N * 4 bytes, 8 KB at N = 8, 40 KB at
// N = 10, 192 KB at N = 12, so a ring of 8-step chunks no longer fits a
// block's 227 KB, and staging whole slices is the wrong trade anyway: a
// chain reads N * 4 bytes of its slice a step, and a block's 64-512 chains
// read a quarter to a half of what staging would copy. So each thread reads
// its chain's N probabilities straight from global memory through the
// read-only path (__ldg) and converts them with the same philox_threshold,
// so the bits are those of the staged body and of the plain version. A block
// walks a tile of one row's chains, and the blocks of one row read the same
// slice at about the same step, so a slice is fetched from memory about
// once and served from L2 (50 MB) to the rest. The loop is unrolled by 2:
// the next step's Philox calls do not depend on the state and run under
// this step's loads. The block size is the largest that still gives every
// SM a block: the fewer rows an SM's resident chains come from, the more of
// their reads its L1 serves. On an H100, 512-thread blocks took 0.79 ms at
// the shadow shape against 1.16 ms for 64-thread ones, and 2.67 ms against
// 2.91 ms at N = 8 over the full grid, where 319 chains a row leave 38% of
// a 512-thread block idle (PERF.md).

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

constexpr int kMaxStagedN = 7;   // N up to here stages its slices
constexpr int kMaxN = 16;        // N up to here reads them from global memory
constexpr int kFullBytes = 64 * 1024;   // up to here all T slices are staged
constexpr int kChunkBytes = 16 * 1024;  // a ring buffer's target size
constexpr int kMinChunkSteps = 8;
// The block-size model's units: what a Philox call, a bit and a staged table
// entry cost (the last fitted on an H100, see make_plan).
constexpr int kCallOps = 58;
constexpr int kBitOps = 3;
constexpr int kStageOps = 32;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// 1-D bulk copy global -> shared; the bytes are counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Shared memory: min(chunks, 2) buffers of `chunk` step slices each. `bulk`
// selects the TMA copies; without it the threads stage with plain loads.
template <int N>
__global__ void chain_walk_kernel(const float* __restrict__ tables,
                                  const int32_t* __restrict__ init,
                                  int32_t* __restrict__ out, int t_steps,
                                  int c_rows, int s_chains, int chunk,
                                  int bulk,
                                  const __grid_constant__ ddqst::PhiloxKeys
                                      keys) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[2];
  constexpr int kSlice = (1 << N) * N;  // table entries a step
  uint32_t* const smem = reinterpret_cast<uint32_t*>(smem_raw);
  const int c = blockIdx.y;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = s < s_chains;
  const int64_t row = static_cast<int64_t>(c) * s_chains + s;
  const int n_chunks = (t_steps + chunk - 1) / chunk;

  // Chunk j's slices, one bulk copy a step, into buffer j % 2.
  auto issue = [&](int j) {
    const int first = j * chunk;
    const int steps = min(chunk, t_steps - first);
    uint64_t* bar = &full_bar[j & 1];
    uint32_t* buf = smem + (j & 1) * chunk * kSlice;
    mbar_expect_tx(bar, static_cast<uint32_t>(steps) * kSlice * 4u);
    for (int k = 0; k < steps; ++k) {
      const int64_t slice = static_cast<int64_t>(first + k) * c_rows + c;
      bulk_load(buf + k * kSlice, tables + slice * kSlice, kSlice * 4u, bar);
    }
  };

  if (bulk) {
    if (threadIdx.x == 0) {
      mbar_init(&full_bar[0], 1);
      mbar_init(&full_bar[1], 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      issue(0);
    }
    __syncthreads();  // the barriers are initialised before anyone waits
  }

  uint32_t x = live ? static_cast<uint32_t>(init[row]) : 0u;
  for (int j = 0; j < n_chunks; ++j) {
    const int first = j * chunk;
    const int steps = min(chunk, t_steps - first);
    const int words = steps * kSlice;
    uint32_t* buf = smem + (j & 1) * chunk * kSlice;
    if (bulk) {
      mbar_wait(&full_bar[j & 1], (j >> 1) & 1);
      for (int k = threadIdx.x; k < words; k += blockDim.x) {
        buf[k] = ddqst::philox_threshold(__uint_as_float(buf[k]));
      }
    } else {
      for (int k = threadIdx.x; k < words; k += blockDim.x) {
        const int64_t slice =
            static_cast<int64_t>(first + k / kSlice) * c_rows + c;
        buf[k] = ddqst::philox_threshold(tables[slice * kSlice + k % kSlice]);
      }
    }
    // The one block barrier of a chunk: the thresholds are visible, and
    // every thread has left chunk j - 1, whose buffer chunk j + 1 reuses.
    __syncthreads();
    if (bulk && threadIdx.x == 0 && j + 1 < n_chunks) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(j + 1);
    }
    if (live) {
#pragma unroll 4
      for (int k = 0; k < steps; ++k) {
        const uint32_t* thr = buf + k * kSlice + x * N;
        uint32_t nx = 0u;
#pragma unroll
        for (int qb = 0; qb < (N + 3) / 4; ++qb) {
          const uint4 w = ddqst::philox4x32_10(
              make_uint4(static_cast<uint32_t>(s), static_cast<uint32_t>(c),
                         static_cast<uint32_t>(first + k),
                         static_cast<uint32_t>(qb)),
              keys);
#pragma unroll
          for (int jq = 0; jq < 4; ++jq) {
            const int q = 4 * qb + jq;
            if (q < N) {
              nx |= ddqst::philox_bit(ddqst::philox_word(w, jq), thr[q]) << q;
            }
          }
        }
        x = nx;
      }
    }
  }
  if (live) out[row] = static_cast<int32_t>(x);
}

// N >= 8: no staging; a chain's N probabilities of a step come straight from
// global memory. Same counter, same thresholds, same bits.
template <int N>
__global__ void chain_walk_global_kernel(const float* __restrict__ tables,
                                         const int32_t* __restrict__ init,
                                         int32_t* __restrict__ out,
                                         int t_steps, int c_rows, int s_chains,
                                         const __grid_constant__
                                             ddqst::PhiloxKeys keys) {
  constexpr int kSlice = (1 << N) * N;  // table entries a step
  const int c = blockIdx.y;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= s_chains) return;  // no block barrier below
  const int64_t row = static_cast<int64_t>(c) * s_chains + s;
  const int64_t step_stride = static_cast<int64_t>(c_rows) * kSlice;
  const float* slice = tables + static_cast<int64_t>(c) * kSlice;
  uint32_t x = static_cast<uint32_t>(__ldcs(init + row));
#pragma unroll 2
  for (int i = 0; i < t_steps; ++i, slice += step_stride) {
    const float* p1 = slice + x * N;
    uint32_t thr[N];
#pragma unroll
    for (int q = 0; q < N; ++q) thr[q] = ddqst::philox_threshold(__ldg(p1 + q));
    uint32_t nx = 0u;
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
    x = nx;
  }
  __stcs(out + row, static_cast<int32_t>(x));
}

struct Plan {
  int threads;  // block size
  int chunk;    // steps a shared-memory buffer holds
  int smem;     // dynamic shared memory, bytes
};

// The staging plan follows from the shape alone; the block size is the
// candidate whose busiest SM has least to do, counted in lane instructions:
// a block's chains' steps (kCallOps a Philox call, kBitOps a bit) plus the
// staging of its T slices (kStageOps an entry: the copies' latency, the
// conversion and the barrier, fitted to the times of all four block sizes
// at two shapes), times the blocks that SM gets. A candidate that leaves an
// SM under 768 resident threads pays for the latency it cannot hide. The
// global-memory body (N > kMaxStagedN) stages nothing (chunk and shared
// memory are 0) and takes the largest block size that fills every SM.
template <int N>
int make_plan(int t_steps, int c_rows, int s_chains, int threads_asked,
              Plan* plan) {
  constexpr bool kStaged = N <= kMaxStagedN;
  constexpr int kSliceBytes = (1 << N) * N * 4;
  const void* kernel;
  if constexpr (kStaged) {
    kernel = reinterpret_cast<const void*>(chain_walk_kernel<N>);
  } else {
    kernel = reinterpret_cast<const void*>(chain_walk_global_kernel<N>);
  }
  const long long total = static_cast<long long>(t_steps) * kSliceBytes;
  if (!kStaged) {
    plan->chunk = 0;
    plan->smem = 0;
  } else if (total <= kFullBytes) {
    plan->chunk = t_steps;
    plan->smem = static_cast<int>(total);
  } else {
    plan->chunk = std::max(kMinChunkSteps, kChunkBytes / kSliceBytes);
    plan->smem = 2 * plan->chunk * kSliceBytes;
  }
  if (plan->smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan->smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (!kStaged) {
    if (threads_asked == 0) {
      plan->threads = 64;
      for (int threads = 512; threads >= 64; threads /= 2) {
        const long long blocks =
            static_cast<long long>((s_chains + threads - 1) / threads) *
            c_rows;
        if (blocks >= sms) {
          plan->threads = threads;
          break;
        }
      }
      return 0;
    }
  }

  const double chain_ops =
      static_cast<double>(t_steps) * (((N + 3) / 4) * kCallOps + kBitOps * N);
  const double stage_ops =
      kStaged ? static_cast<double>(total / 4) * kStageOps : 0.0;
  double best = -1.0;
  plan->threads = 0;
  for (int threads = 64; threads <= 512; threads *= 2) {
    if (threads_asked > 0 && threads != threads_asked) continue;
    int active = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &active, kernel, threads, plan->smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (active < 1) continue;
    const long long blocks =
        static_cast<long long>((s_chains + threads - 1) / threads) * c_rows;
    const long long per_sm = (blocks + sms - 1) / sms;
    const double resident =
        static_cast<double>(std::min<long long>(active, per_sm)) * threads;
    const double cost = static_cast<double>(per_sm) *
                        (threads * chain_ops + stage_ops) *
                        std::max(1.0, 768.0 / resident);
    if (best < 0.0 || cost < best) {
      best = cost;
      plan->threads = threads;
    }
  }
  return plan->threads > 0 ? 0
                           : static_cast<int>(cudaErrorInvalidConfiguration);
}

template <int N>
int launch(const float* tables, const int32_t* init, int32_t* out, int t_steps,
           int c_rows, int s_chains, unsigned long long seed, int threads_asked,
           int* plan_out, cudaStream_t stream) {
  Plan plan;
  const int err = make_plan<N>(t_steps, c_rows, s_chains, threads_asked, &plan);
  if (err != 0) return err;
  if (plan_out != nullptr) {
    plan_out[0] = plan.threads;
    plan_out[1] = plan.chunk;
    plan_out[2] = plan.smem;
  }
  const dim3 grid((s_chains + plan.threads - 1) / plan.threads, c_rows);
  if constexpr (N <= kMaxStagedN) {
    constexpr int kSliceBytes = (1 << N) * N * 4;
    const int bulk = kSliceBytes % 16 == 0 &&
                     (reinterpret_cast<uintptr_t>(tables) & 15u) == 0;
    chain_walk_kernel<N><<<grid, plan.threads, plan.smem, stream>>>(
        tables, init, out, t_steps, c_rows, s_chains, plan.chunk, bulk,
        ddqst::philox_keys(seed));
  } else {
    chain_walk_global_kernel<N><<<grid, plan.threads, 0, stream>>>(
        tables, init, out, t_steps, c_rows, s_chains,
        ddqst::philox_keys(seed));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on `stream` (PyTorch's
// current stream), does not synchronise, and returns the first CUDA error of
// the set-up or cudaGetLastError() of the launch (0 = launched). Shapes are
// checked by the Python wrapper; this re-checks the limits the kernel's
// shared memory relies on. `threads` is 0 (the block size is chosen from the
// shape) or one of 64, 128, 256, 512; `plan_out`, if not null, receives
// {threads, steps a buffer, shared-memory bytes} (0 and 0 for N >= 8, which
// stages nothing). 1 <= N <= 16.
extern "C" int ddqst_fused_chain_walk(const float* tables, const int32_t* init,
                                      int32_t* out, int t_steps, int c_rows,
                                      int g, int n, int s_chains,
                                      unsigned long long seed, int threads,
                                      int* plan_out, void* stream) {
  if (n < 1 || n > kMaxN || (1 << n) != g || t_steps < 1 || c_rows < 1 ||
      c_rows > 65535 || s_chains < 1 ||
      (threads != 0 && threads != 64 && threads != 128 && threads != 256 &&
       threads != 512)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DDQST_WALK_CASE(N)                                                 \
  case N:                                                                  \
    return launch<N>(tables, init, out, t_steps, c_rows, s_chains, seed,   \
                     threads, plan_out, s)
  switch (n) {
    DDQST_WALK_CASE(1);
    DDQST_WALK_CASE(2);
    DDQST_WALK_CASE(3);
    DDQST_WALK_CASE(4);
    DDQST_WALK_CASE(5);
    DDQST_WALK_CASE(6);
    DDQST_WALK_CASE(7);
    DDQST_WALK_CASE(8);
    DDQST_WALK_CASE(9);
    DDQST_WALK_CASE(10);
    DDQST_WALK_CASE(11);
    DDQST_WALK_CASE(12);
    DDQST_WALK_CASE(13);
    DDQST_WALK_CASE(14);
    DDQST_WALK_CASE(15);
    DDQST_WALK_CASE(16);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DDQST_WALK_CASE
}
