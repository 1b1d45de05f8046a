// One reverse step of the exhaustive-grid D3PM sampler, for Hopper.
//
// Replaces the TPU kernel ddqst_tpu/ops/pallas_kernels.py::fused_chain_step
// (body _chain_step_kernel). For every chain b of the step:
//     p1  = table[rows[b], :]                       (a gather of N floats)
//     u_q = (philox word >> 8) * 2^-24              (top 24 bits, exact in f32)
//     out[b] = sum_q [u_q < p1_q] << q
// The TPU gathered with a one-hot matrix product on its matrix unit; here
// each thread reads its row id and then the row's N floats straight from
// global memory through the read-only cache.
//
// Randomness is Philox4x32-10 from philox.cuh, keyed by the 64-bit seed
// with counter (b, step, q / 4, 0); bit q uses word q % 4. The output thus
// depends on neither the launch geometry nor a chain's place in a block,
// and the plain PyTorch version (ops/cuda_kernels.py:
// fused_chain_step_reference) reproduces it bit for bit.
//
// What bounds it on an H100: at the circuit-conditioned evaluation shape
// (B = 6,750,000 chains, N = 3, a 10,800 x 3 table of 130 KB that stays in
// the 50 MB L2) one step moves about 54 MB, rows in and outcomes out at
// 4 B each: about 16 us at 3.35 TB/s. It also makes 6.75 M Philox4x32-10
// calls of ~100 integer operations plus ~6 operations per bit, about
// 0.80 G lane instructions: about 24 us at 33.5e12 a second. So it is
// bound by operations, with byte traffic close behind.
//
// Design: one thread per chain on a 1-D grid of ceil(B / 256) blocks, the
// ragged end masked (no padding of B to a tile, nor of N to 128 lanes).
// Reads of rows and writes of out are coalesced; the table gather is not,
// and relies on the L2.

#include <cstdint>
#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = 30;  // out holds N bits in an int32

__global__ void __launch_bounds__(kThreads)
chain_step_kernel(const float* __restrict__ table,
                  const int32_t* __restrict__ rows, int32_t* __restrict__ out,
                  int n, long long b_chains, uint32_t step, uint32_t k0,
                  uint32_t k1) {
  const long long b =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= b_chains) return;
  const float* p1 = table + static_cast<int64_t>(__ldg(rows + b)) * n;
  int x = 0;
  uint4 w = make_uint4(0u, 0u, 0u, 0u);
  for (int q = 0; q < n; ++q) {
    if ((q & 3) == 0) {
      w = ddqst::philox4x32_10(
          make_uint4(static_cast<uint32_t>(b), step,
                     static_cast<uint32_t>(q >> 2), 0u),
          k0, k1);
    }
    const float u = ddqst::philox_uniform(ddqst::philox_word(w, q & 3));
    x |= (u < __ldg(p1 + q)) ? (1 << q) : 0;
  }
  out[b] = x;
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on `stream` (PyTorch's
// current stream), does not synchronise, and returns cudaGetLastError()
// (0 = launched). The Python wrapper checks shapes, types and devices; row
// ids outside [0, G) are the caller's fault and are not checked here.
extern "C" int ddqst_fused_chain_step(const float* table, const int32_t* rows,
                                      int32_t* out, long long g_rows, int n,
                                      long long b_chains, unsigned int step,
                                      unsigned long long seed, void* stream) {
  if (n < 1 || n > kMaxN || g_rows < 1 || g_rows >= (1LL << 31) ||
      b_chains < 1 || b_chains > (1LL << 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (b_chains + kThreads - 1) / kThreads;
  chain_step_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      table, rows, out, n, b_chains, step,
      static_cast<uint32_t>(seed & 0xFFFFFFFFull),
      static_cast<uint32_t>(seed >> 32));
  return static_cast<int>(cudaGetLastError());
}
