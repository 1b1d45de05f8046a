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
// 0.305 ms of multiplier slots: bound by operations again. One call of the
// chunked sampler at N = 8 (3^8 rows of 319 chains) moves 5.4 GB of tables,
// 1.61 ms: bound by bytes; so does the shadow route at N = 12 (1.97 GB,
// 0.588 ms). From N = 13 at 5,000 chains a row the chains can reach at most
// S of a step's 2^N table rows, and only those count. The measured times
// stand in PERF.md.
//
// Three bodies walk the chains; each gives the same bits.
//
// The staged body, N = 1 to 7:
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
// A plain global-memory body (one thread a chain, N 4-byte loads of its
// row a step; csrc/walk_ablation.cu mode 2) takes 0.79 ms at the shadow
// shape (N = 10), its loads and conversions alone 0.75, its Philox and bits
// alone 0.44 (chip_smoke.py phase `ablation`): every lane of a warp reads
// another row of a 40 KB slice, so each of a step's ten 4-byte loads
// touches about 30 lines of 128 bytes, some 300 line requests a warp-step
// through L1.
//
// The ring body, N = 8 to 11, takes those line requests off L1:
// - A CTA walks up to 1,024 of one row's chains, one a thread, every warp
//   at its own pace. Each step's slice lands once a CTA in a ring of
//   shared-memory stages, 2 steps a stage up to N = 10 (two stages of 80 KB
//   at N = 10) and 1 at N = 11 (two of 88 KB): one bulk copy a slice onto
//   the stage's full barrier. A chain then reads its row from shared memory
//   (8- or 16-byte loads where N allows) and converts its N probabilities:
//   at 1,000 chains a CTA that is as many conversions as the slice has
//   entries, and a conversion pass would cost a block barrier and a second
//   trip of the slice through shared memory.
// - No block barrier runs in the step loop. A warp waits only on the full
//   barrier of its next stage. Its lane 0 counts it out of a stage it has
//   finished (an acquire-release atomic on a shared word), and the last
//   warp out refills the stage at once with the step `stages` loads ahead.
//   Fewer, larger bulk copies took less time than 16 KB pieces, and 2-step
//   stages less than 1-step ones (half the waits and counts).
// - Thread-block clusters were tried and left out: the CTAs of a row in a
//   cluster, one multicast bulk copy filling the stage of each, halve or
//   better the slice traffic out of L2, but on an H100 every cluster size
//   took longer (at the shadow shape 0.70 ms in clusters of 2 against 0.60
//   alone): the CTAs of a cluster wait for each other, and clusters of 5
//   leave SMs of a GPC idle (PERF.md).
// - The block size fills whole CTAs: S = 5,000 takes 5 CTAs of 1,024
//   threads a row (4 waves of 132), and the 319 chains of the N = 8 grid
//   one CTA of 320, three to an SM. The plan costs each candidate with the
//   card's own occupancy (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
// - Measured on an H100 (chip_smoke.py phase `kernel`): 0.58 ms at the
//   shadow shape, 1.9 x its bound, against the global body's 0.79; 1.76 ms
//   at the N = 8 grid, 1.09 x its byte bound, against 2.68; 0.65 ms at
//   N = 11 against 1.29. What is left at the shadow shape is the waits and
//   counts (the warps of a CTA stay within a stage of each other) and 2 GB
//   of slices out of L2, each copied once by each of a row's 5 CTAs.
//
// The gather body, N = 12 to 16: a slice of 192 KB or more cannot be
// double-buffered in a block's 227 KB, so a chain gathers its row from
// global memory, and the design keeps the slice close by other means.
// - At N = 12 (T=100, C=100, S=5,000: 1.97 GB of tables, a byte bound of
//   0.588 ms) the plain body takes 1.53 ms. Its loads alone take 1.11 and
//   its Philox alone 0.47; 16-byte loads alone take 1.15, the same as
//   4-byte ones: unlike at N = 10 the line requests do not set the pace,
//   the slices' trips from DRAM and L2 do (chip_smoke.py phase `ablation`).
// - So an SM walks one block at a time, all of one row's chains: 5 blocks
//   of 1,024 a row at that shape. Where the registers would let an SM hold
//   more blocks, the launch reserves a little shared memory and prefers the
//   most L1, which leaves room for no second block and keeps about 240 KB
//   of L1 for the row's slice. The same loads in blocks of 512, three an
//   SM, took 1.48 ms; one block of 1,024 an SM 0.90; one an SM with 114 KB
//   of shared memory reserved (so a smaller L1) 1.03.
// - A row's N probabilities come in 16-byte loads where every row starts
//   16-byte aligned (N = 12 and 16, an aligned table), 8-byte loads at N =
//   14, and otherwise as the 16-byte chunks that hold the row, each word
//   selected by the row's offset in its first chunk (odd N, or a table
//   that is not 16-byte aligned).
// - Tried and left out (csrc/walk_ablation.cu): asking the TMA unit to
//   bring the next step's slice into L2 (cp.async.bulk.prefetch.L2) took
//   longer in every form, by 0.1 to 1.0 ms at N = 12; so did loads through
//   L2 only, and a block barrier a step gained nothing.
// - Where a row's chains are fewer than its table rows (S < 2^N, N >= 13 at
//   S = 5,000) blocks of up to 512 took less time than 1,024s (N = 14: 0.50
//   ms against 0.58).
// - Measured on an H100 (chip_smoke.py --time-kernels, 5,000 chains a
//   row): 0.89-0.93 ms at N = 12 (1.5 x its bound) against the plain body's
//   1.52-1.53; 0.715 against 0.926 at N = 13, 0.498 against 0.506 at N =
//   14, 0.266 against 0.274 at N = 15 and 0.114 against 0.155 at N = 16
//   (PERF.md).

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

constexpr int kMaxStagedN = 7;  // N up to here: the staged body
constexpr int kMaxRingN = 11;   // N from 8 up to here: the ring body
constexpr int kMaxN = 16;       // N from 12 up to here: the gather body
constexpr int kFullBytes = 64 * 1024;   // up to here all T slices are staged
constexpr int kChunkBytes = 16 * 1024;  // a ring buffer's target size
constexpr int kMinChunkSteps = 8;
// The ring body: at most kMaxStages stages in at most kRingBytes; one bulk
// copy moves at most kPieceBytes (a whole slice up to N = 10: fewer, larger
// copies took less time on an H100).
constexpr int kMaxStages = 4;
constexpr int kRingBytes = 200 * 1024;
// After the ring, in the same dynamic shared memory: a full barrier and a
// count of warps out for each stage.
constexpr int kRingTailBytes = kMaxStages * (8 + 4);
constexpr uint32_t kPieceBytes = 48 * 1024;
// The block-size model's units: what a Philox call, a bit and a staged table
// entry cost (the last fitted on an H100, see make_plan).
constexpr int kCallOps = 58;
constexpr int kBitOps = 3;
constexpr int kStageOps = 32;
constexpr int kLandOps = 1;  // the ring body's landing of an entry
// The gather body: the unused shared memory a block reserves where its
// registers would let an SM hold more than one (with the system's 1 KB a
// block, more than half the smallest carveout, 16 KB, that fits it).
constexpr int kGatherReserveBytes = 9 * 1024;

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

// Add 1 to a shared word of this CTA; returns the old value. Acquire and
// release: what the warp read before comes before what the last to count
// does after.
__device__ __forceinline__ uint32_t atom_add_cta(uint32_t* p) {
  uint32_t old;
  asm volatile("atom.acq_rel.cta.shared::cta.add.u32 %0, [%1], 1;\n"
               : "=r"(old)
               : "r"(smem_addr(p))
               : "memory");
  return old;
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// The N probabilities of a row at `p` (shared memory), in the widest loads
// its alignment allows: a row starts at x * N words.
template <int N>
__device__ __forceinline__ void load_row(const float* p, float (&p1)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N; q += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + q);
      p1[q] = v.x;
      p1[q + 1] = v.y;
      p1[q + 2] = v.z;
      p1[q + 3] = v.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int q = 0; q < N; q += 2) {
      const float2 v = *reinterpret_cast<const float2*>(p + q);
      p1[q] = v.x;
      p1[q + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) p1[q] = p[q];
  }
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

// The N probabilities of the row at `p` (global memory) in the widest loads
// its alignment allows: kAlign words is the alignment every row's start is
// known to have. At 4 (16 bytes) the row is N / 4 16-byte loads, at 2 (8
// bytes) N / 2 8-byte loads. At 1 the row is read as the 16-byte chunks that
// hold it: it starts m = 0 to 3 words into its first chunk, a chunk past
// its last word is not read (so no read leaves the chunks the table's own
// words lie in), and each probability is selected from the chunks' words
// by m.
template <int N, int kAlign>
__device__ __forceinline__ void gather_row(const float* p, float (&p1)[N]) {
  if constexpr (kAlign == 4) {
#pragma unroll
    for (int q = 0; q < N; q += 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p + q));
      p1[q] = v.x;
      p1[q + 1] = v.y;
      p1[q + 2] = v.z;
      p1[q + 3] = v.w;
    }
  } else if constexpr (kAlign == 2) {
#pragma unroll
    for (int q = 0; q < N; q += 2) {
      const float2 v = __ldg(reinterpret_cast<const float2*>(p + q));
      p1[q] = v.x;
      p1[q + 1] = v.y;
    }
  } else {
    constexpr int kChunks = (N + 3 + 3) / 4;
    const int m = static_cast<int>(reinterpret_cast<uintptr_t>(p) >> 2) & 3;
    const float4* chunk = reinterpret_cast<const float4*>(p - m);
    float w[4 * kChunks];
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (4 * k < N || 4 * k < N + m) v = __ldg(chunk + k);
      w[4 * k] = v.x;
      w[4 * k + 1] = v.y;
      w[4 * k + 2] = v.z;
      w[4 * k + 3] = v.w;
    }
#pragma unroll
    for (int q = 0; q < N; ++q) {
      const float lo = (m & 1) ? w[q + 1] : w[q];
      const float hi = (m & 1) ? w[q + 3] : w[q + 2];
      p1[q] = (m & 2) ? hi : lo;
    }
  }
}

// The gather body (N = 12 to 16). One thread a chain, every warp at its own
// step, no block barrier and no shared memory: a chain reads its row of a
// step straight from global memory (gather_row) and converts its N
// probabilities as the ring body does. Threads past the end of S walk dead
// chains from row 0 and store nothing. The plan below launches blocks of up
// to 1,024 threads, one an SM, so a row's chains walk in few blocks and few
// rows are walked at once: a step slice, read from DRAM into L2 by its
// first gathers, serves the row's other chains before it is evicted. Same
// counter, same thresholds, same bits.
template <int N, int kAlign>
__global__ void chain_walk_gather_kernel(const float* __restrict__ tables,
                                         const int32_t* __restrict__ init,
                                         int32_t* __restrict__ out,
                                         int t_steps, int c_rows, int s_chains,
                                         const __grid_constant__
                                             ddqst::PhiloxKeys keys) {
  constexpr int kSlice = (1 << N) * N;  // table entries a step
  constexpr int kCalls = (N + 3) / 4;  // Philox calls a chain and step
  const int c = blockIdx.y;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = s < s_chains;
  const int64_t row = static_cast<int64_t>(c) * s_chains + s;
  const int64_t step_stride = static_cast<int64_t>(c_rows) * kSlice;
  const float* slice = tables + static_cast<int64_t>(c) * kSlice;
  uint32_t x = live ? static_cast<uint32_t>(__ldcs(init + row)) : 0u;
  for (int i = 0; i < t_steps; ++i, slice += step_stride) {
    float p1[N];
    gather_row<N, kAlign>(slice + x * N, p1);
    uint4 w[kCalls];
#pragma unroll
    for (int qb = 0; qb < kCalls; ++qb) {
      w[qb] = make_uint4(static_cast<uint32_t>(s), static_cast<uint32_t>(c),
                         static_cast<uint32_t>(i), static_cast<uint32_t>(qb));
    }
    ddqst::philox4x32_10<kCalls>(w, keys);
    uint32_t nx = 0u;
#pragma unroll
    for (int q = 0; q < N; ++q) {
      nx |= ddqst::philox_bit(ddqst::philox_word(w[q / 4], q % 4),
                              ddqst::philox_threshold(p1[q]))
            << q;
    }
    x = nx;
  }
  if (live) __stcs(out + row, static_cast<int32_t>(x));
}

// Steps a ring stage holds: two where two stages of two fit in kRingBytes
// (N <= 10), so a warp waits and counts itself out once every two steps.
template <int N>
constexpr int kRingChunk = 4 * (1 << N) * N * 4 <= kRingBytes ? 2 : 1;

// N = 8 to 11: the ring body. A CTA walks one conditioning row's chains,
// one chain a thread, every warp at its own pace. Step n's slice lands in
// ring stage n % stages: a bulk copy (the TMA unit) onto the stage's full
// barrier, which counts the bytes. A table pointer that is not 16-byte
// aligned takes plain loads by one warp instead (its 32 lanes arrive on the
// full barrier). A warp waits for its step's slice, reads each chain's N
// probabilities from shared memory and converts them as the gather body
// does. Then its lane 0 counts it out of the stage; the last warp of the CTA
// out refills the stage with step n + stages at once. So no block barrier
// runs in the step loop, and no warp waits for another except on a slice
// that has not landed. Threads past the end of S walk dead chains: every
// warp takes part in every step. The kernel has no static shared memory:
// the ring starts at the base of the CTA's shared memory and its barriers
// and counts follow it. On an H100 a ring placed after 48 bytes of static
// barriers and counts took markedly longer, most of all at N = 11.
template <int N>
__global__ void __launch_bounds__(1024, 1)
    chain_walk_ring_kernel(const float* __restrict__ tables,
                           const int32_t* __restrict__ init,
                           int32_t* __restrict__ out, int t_steps, int c_rows,
                           int s_chains, int stages, int bulk,
                           const __grid_constant__ ddqst::PhiloxKeys keys) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kSlice = (1 << N) * N;  // table entries a step
  constexpr uint32_t kSliceBytes = kSlice * 4u;
  constexpr int kCalls = (N + 3) / 4;  // Philox calls a chain and step
  constexpr int kChunk = kRingChunk<N>;
  float* const ring = reinterpret_cast<float*>(smem_raw);
  uint64_t* const full_bar =
      reinterpret_cast<uint64_t*>(smem_raw + stages * kChunk * kSliceBytes);
  uint32_t* const warps_out =  // this CTA's warps out of a stage, all uses
      reinterpret_cast<uint32_t*>(full_bar + kMaxStages);
  const int c = blockIdx.y;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = s < s_chains;
  const int64_t row = static_cast<int64_t>(c) * s_chains + s;
  const int64_t step_stride = static_cast<int64_t>(c_rows) * kSlice;
  const float* const row_tables = tables + static_cast<int64_t>(c) * kSlice;
  const uint32_t warps = blockDim.x / 32;
  const int lane = threadIdx.x & 31;

  const int units = (t_steps + kChunk - 1) / kChunk;  // stage loads
  // The bytes of load n: its steps' slices.
  auto unit_bytes = [&](int n) {
    return static_cast<uint32_t>(min(kChunk, t_steps - n * kChunk)) *
           kSliceBytes;
  };
  // One warp: load n (steps n * kChunk on) into stage k (= n % stages).
  auto issue = [&](int n, int k) {
    const int first = n * kChunk;
    const int steps = min(kChunk, t_steps - first);
    for (int i = 0; i < steps; ++i) {
      float* dst = ring + (k * kChunk + i) * kSlice;
      const float* src = row_tables + (first + i) * step_stride;
      if (bulk) {
        if (lane == 0) {
          for (uint32_t off = 0; off < kSliceBytes; off += kPieceBytes) {
            bulk_load(reinterpret_cast<unsigned char*>(dst) + off,
                      reinterpret_cast<const unsigned char*>(src) + off,
                      min(kPieceBytes, kSliceBytes - off), &full_bar[k]);
          }
        }
      } else {
#pragma unroll 8
        for (int e = lane; e < kSlice; e += 32) dst[e] = __ldg(src + e);
      }
    }
    if (!bulk) mbar_arrive(&full_bar[k]);
  };

  if (threadIdx.x == 0) {
    for (int k = 0; k < stages; ++k) {
      mbar_init(&full_bar[k], bulk ? 1 : 32);
      warps_out[k] = 0u;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers exist before the first copy
  if (threadIdx.x < 32) {
    for (int n = 0; n < min(stages, units); ++n) {
      if (bulk && lane == 0) mbar_expect_tx(&full_bar[n], unit_bytes(n));
      issue(n, n);
    }
  }

  uint32_t x = live ? static_cast<uint32_t>(__ldcs(init + row)) : 0u;
  auto draws = [&](int i, uint4 (&w)[kCalls]) {
#pragma unroll
    for (int qb = 0; qb < kCalls; ++qb) {
      w[qb] = make_uint4(static_cast<uint32_t>(s), static_cast<uint32_t>(c),
                         static_cast<uint32_t>(i), static_cast<uint32_t>(qb));
    }
    ddqst::philox4x32_10<kCalls>(w, keys);
  };
  // Step j from the slice at `slice`.
  auto walk = [&](int j, const float* slice) {
    float p1[N];
    load_row<N>(slice + x * N, p1);
    uint4 w[kCalls];
    draws(j, w);
    uint32_t nx = 0u;
#pragma unroll
    for (int q = 0; q < N; ++q) {
      nx |= ddqst::philox_bit(ddqst::philox_word(w[q / 4], q % 4),
                              ddqst::philox_threshold(p1[q]))
            << q;
    }
    x = nx;
  };
  // Stage k holds load n in its use number `use` (from 0), whose full
  // barrier phase has parity use & 1.
  int k = 0;
  uint32_t use = 0u;
  const float* stage = ring;
  for (int n = 0; n < units; ++n) {
    mbar_wait(&full_bar[k], use & 1u);
    const int j = n * kChunk;
    walk(j, stage);
    if (kChunk == 2 && j + 1 < t_steps) walk(j + 1, stage + kSlice);
    if (n + stages < units) {
      __syncwarp();  // the warp's reads of stage k are done
      uint32_t last = 0u;
      if (lane == 0) {
        last = atom_add_cta(&warps_out[k]) == (use + 1u) * warps - 1u;
        if (last && bulk) mbar_expect_tx(&full_bar[k], unit_bytes(n + stages));
      }
      if (__shfl_sync(0xFFFFFFFFu, last, 0)) issue(n + stages, k);
    }
    if (++k == stages) {
      k = 0, ++use, stage = ring;
    } else {
      stage += kChunk * kSlice;
    }
  }
  if (live) __stcs(out + row, static_cast<int32_t>(x));
}

// Which body walks the chains, as the plan reports it (from N alone).
enum Body { kBodyStaged = 1, kBodyRing = 2, kBodyGather = 3 };

struct Plan {
  int threads;  // block size
  int chunk;    // steps a shared-memory buffer (a ring stage) holds
  int stages;   // the ring body's stages
  int smem;     // dynamic shared memory, bytes
  int body;     // kBodyStaged, kBodyRing or kBodyGather
};

// The staged body's plan. The staging follows from the shape alone; the
// block size is the candidate whose busiest SM has least to do, counted in
// lane instructions: a block's chains' steps (kCallOps a Philox call,
// kBitOps a bit) plus the staging of its T slices (kStageOps an entry: the
// copies' latency, the conversion and the barrier, fitted to the times of
// all four block sizes at two shapes), times the blocks that SM gets. A
// candidate that leaves an SM under 768 resident threads pays for the
// latency it cannot hide.
template <int N>
int make_plan(int t_steps, int c_rows, int s_chains, int threads_asked,
              int sms, Plan* plan) {
  constexpr int kSliceBytes = (1 << N) * N * 4;
  const void* kernel = reinterpret_cast<const void*>(chain_walk_kernel<N>);
  plan->body = kBodyStaged;
  plan->stages = 0;
  const long long total = static_cast<long long>(t_steps) * kSliceBytes;
  if (total <= kFullBytes) {
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

  const double chain_ops =
      static_cast<double>(t_steps) * (((N + 3) / 4) * kCallOps + kBitOps * N);
  const double stage_ops = static_cast<double>(total / 4) * kStageOps;
  double best = -1.0;
  plan->threads = 0;
  for (int threads = 64; threads <= 512; threads *= 2) {
    if (threads_asked > 0 && threads != threads_asked) continue;
    int active = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
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

// The gather body's plan. Every row start is 16-byte aligned where N is a
// multiple of 4 and the table is, 8-byte aligned where N is even and the
// table is 8-byte aligned; otherwise 4-byte (gather_row's kAlign). An SM
// holds one block: where its registers would let it hold more, the launch
// reserves kGatherReserveBytes of (unused) shared memory and prefers the
// most L1 (carveout 0), so the SM's smallest shared-memory carveout that
// fits one block's reservation fits no second. The block then holds an SM's
// chains, all of one row, and L1 keeps their step slice. Where a row's
// chains outnumber its table rows (S >= 2^N) each slice serves many chains
// and blocks of up to 1,024 threads took least time on an H100, below that
// blocks of up to 512 (at the shadow shape, 100 rows of 5,000 chains: 0.91
// ms in 1,024-thread blocks at N = 12 against 1.10 in 512s; at N = 14, 25
// rows, 0.50 in 512s against 0.58 in 1,024s). The block size splits a
// row's chains evenly over k blocks, k from the fewest of that size up to
// as many as give every SM a block, and is the candidate whose busiest SM
// walks the fewest chains (its blocks times their threads, dead ones too);
// a tie goes to the fewer blocks. A block size asked for is taken as it
// is, one block an SM.
template <int N, int kAlign>
int make_gather_plan(int c_rows, int s_chains, int threads_asked, int sms,
                     int smem_per_sm, Plan* plan) {
  const void* kernel =
      reinterpret_cast<const void*>(chain_walk_gather_kernel<N, kAlign>);
  plan->body = kBodyGather;
  plan->chunk = 0;
  plan->stages = 0;
  plan->smem = 0;
  plan->threads = threads_asked;
  if (threads_asked == 0) {
    const int widest = s_chains >= (1 << N) ? 1024 : 512;
    const int fewest = (s_chains + widest - 1) / widest;
    const int most = std::max(fewest, (sms + c_rows - 1) / c_rows);
    long long best = -1;
    for (int k = fewest; k <= most; ++k) {
      const int threads =
          std::max(64, ((s_chains + k - 1) / k + 31) / 32 * 32);
      const long long blocks =
          static_cast<long long>((s_chains + threads - 1) / threads) * c_rows;
      const long long cost = (blocks + sms - 1) / sms * threads;
      if (best < 0 || cost < best) {
        best = cost;
        plan->threads = threads;
      }
    }
  }
  int active = 0;  // blocks an SM holds at once
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &active, kernel, plan->threads, 0);
  if (err != cudaSuccess || active == 1) return static_cast<int>(err);
  if (active > 1) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    plan->smem = kGatherReserveBytes;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &active, kernel, plan->threads, plan->smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (active > 1) {  // more than half the SM's shared memory a block
      plan->smem = smem_per_sm / 2;
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan->smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &active, kernel, plan->threads, plan->smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return active == 1 ? 0 : static_cast<int>(cudaErrorInvalidConfiguration);
}

// The ring body's plan. The ring holds kRingChunk<N> steps a stage and as
// many stages as fit in kRingBytes (2 to kMaxStages). The block size is the
// candidate that the card can place (cudaOccupancyMaxActiveBlocksPer-
// Multiprocessor) whose busiest SM has least to do, in lane instructions:
// each CTA a step walks its threads' chains (dead ones too) and lands a
// slice (kLandOps an entry), the card runs the CTAs in waves of as many as
// it holds at once, and an SM with fewer than 768 resident threads pays for
// the latency it cannot hide. The candidates split a row's chains evenly
// over 0 to 7 more CTAs than the fewest of 1,024 threads that hold them. A
// block size asked for is taken as it is.
template <int N>
int make_ring_plan(int c_rows, int s_chains, int threads_asked, int sms,
                   Plan* plan) {
  constexpr int kSliceBytes = (1 << N) * N * 4;
  constexpr int kSlice = (1 << N) * N;
  constexpr int kStageBytes = kRingChunk<N> * kSliceBytes;
  const void* kernel = reinterpret_cast<const void*>(chain_walk_ring_kernel<N>);
  plan->body = kBodyRing;
  plan->chunk = kRingChunk<N>;
  plan->stages = std::max(2, std::min(kMaxStages, kRingBytes / kStageBytes));
  plan->smem = plan->stages * kStageBytes + kRingTailBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan->smem);
  if (err != cudaSuccess) return static_cast<int>(err);

  const double chain_ops = ((N + 3) / 4) * kCallOps + kBitOps * N;
  const int fewest = (s_chains + 1023) / 1024;  // CTAs a row at 1,024 threads
  double best = -1.0;
  plan->threads = 0;
  for (int extra = 0; extra < 8; ++extra) {
    const int per_cta = (s_chains + fewest + extra - 1) / (fewest + extra);
    const int threads = threads_asked > 0
                            ? threads_asked
                            : std::max(64, (per_cta + 31) / 32 * 32);
    int active = 0;  // CTAs an SM holds at once
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&active, kernel,
                                                        threads, plan->smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (active >= 1) {
      const long long ctas =
          static_cast<long long>((s_chains + threads - 1) / threads) * c_rows;
      const long long waves = (ctas + 1LL * active * sms - 1) /
                              (1LL * active * sms);
      const double cost = static_cast<double>(waves) * active *
                          (threads * chain_ops + kSlice * kLandOps) *
                          std::max(1.0, 768.0 / (active * threads));
      if (best < 0.0 || cost < best) {
        best = cost;
        plan->threads = threads;
      }
    }
    if (threads_asked > 0) break;
  }
  return plan->threads > 0 ? 0
                           : static_cast<int>(cudaErrorInvalidConfiguration);
}

// The body follows from N alone: staged up to kMaxStagedN, the ring up to
// kMaxRingN, the gather body above (its alignment from N and the table's
// address).
template <int N>
int launch(const float* tables, const int32_t* init, int32_t* out, int t_steps,
           int c_rows, int s_chains, unsigned long long seed, int threads_asked,
           int* plan_out, cudaStream_t stream) {
  constexpr bool kRing = N > kMaxStagedN && N <= kMaxRingN;
  constexpr bool kGather = N > kMaxRingN;
  constexpr int kRowAlign = N % 4 == 0 ? 4 : N % 2 == 0 ? 2 : 1;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(tables);
  const bool aligned = (addr & 15u) == 0;
  // gather_row's kAlign: the row alignment N and the table's address give
  const bool natural = (addr & (4u * kRowAlign - 1u)) == 0;
  Plan plan;
  int status;
  if constexpr (kRing) {
    status = make_ring_plan<N>(c_rows, s_chains, threads_asked, sms, &plan);
  } else if constexpr (kGather) {
    int smem_per_sm = 0;
    err = cudaDeviceGetAttribute(
        &smem_per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    status = natural ? make_gather_plan<N, kRowAlign>(
                           c_rows, s_chains, threads_asked, sms, smem_per_sm,
                           &plan)
                     : make_gather_plan<N, 1>(c_rows, s_chains, threads_asked,
                                              sms, smem_per_sm, &plan);
  } else {
    status = make_plan<N>(t_steps, c_rows, s_chains, threads_asked, sms, &plan);
  }
  if (status != 0) return status;
  if (plan_out != nullptr) {
    plan_out[0] = plan.threads;
    plan_out[1] = plan.chunk;
    plan_out[2] = plan.smem;
    plan_out[3] = plan.body;
  }
  const ddqst::PhiloxKeys keys = ddqst::philox_keys(seed);
  const dim3 grid((s_chains + plan.threads - 1) / plan.threads, c_rows);
  if constexpr (N <= kMaxStagedN) {
    constexpr int kSliceBytes = (1 << N) * N * 4;
    const int bulk = kSliceBytes % 16 == 0 && aligned;
    chain_walk_kernel<N><<<grid, plan.threads, plan.smem, stream>>>(
        tables, init, out, t_steps, c_rows, s_chains, plan.chunk, bulk, keys);
  } else if constexpr (kRing) {
    // a slice is a multiple of 16 bytes from N = 8 on
    chain_walk_ring_kernel<N><<<grid, plan.threads, plan.smem, stream>>>(
        tables, init, out, t_steps, c_rows, s_chains, plan.stages,
        aligned ? 1 : 0, keys);
  } else if (natural) {
    chain_walk_gather_kernel<N, kRowAlign>
        <<<grid, plan.threads, plan.smem, stream>>>(
            tables, init, out, t_steps, c_rows, s_chains, keys);
  } else {
    chain_walk_gather_kernel<N, 1><<<grid, plan.threads, plan.smem, stream>>>(
        tables, init, out, t_steps, c_rows, s_chains, keys);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on `stream` (PyTorch's
// current stream), does not synchronise, and returns the first CUDA error of
// the set-up or of the launch (0 = launched). Shapes are checked by the
// Python wrapper; this re-checks the limits the kernels rely on. `threads`
// is 0 (chosen from the shape) or one of 64, 128, 256, 512. A shape the card
// cannot place returns its error (no other body is tried). `plan_out`, if
// not null, receives {threads, steps a buffer, shared-memory bytes, body}
// (body 1 staged, 2 ring, 3 gather). 1 <= N <= 16.
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
