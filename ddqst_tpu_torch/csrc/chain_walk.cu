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
// What bounds it on an H100: at the main-path shape (T=100, C=27, 2^N=8,
// N=3, S=5,000) it moves about 1.3 MB (init and out at 135,000 x 4 B each,
// plus the 259 KB table), about 0.4 us at 3.35 TB/s, but it makes about
// 13.5 M Philox4x32-10 calls of ~100 integer operations each. It is bound
// by integer arithmetic, not by bytes.
//
// Design: one thread per chain, the chain state x held in a register across
// the T-step loop (which takes the place of the TPU's sequential t grid
// axis), init read once and out written once. Blocks cover (chunk of S, c)
// and mask the ragged end of S themselves. Each step's [2^N, N] table slice
// (at most 128 x 7 x 4 B = 3.5 KB) is staged in shared memory, double
// buffered so one __syncthreads per step suffices.

#include <cstdint>
#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxG = 128;
constexpr int kMaxN = 7;

__global__ void __launch_bounds__(kThreads)
chain_walk_kernel(const float* __restrict__ tables,
                  const int32_t* __restrict__ init, int32_t* __restrict__ out,
                  int t_steps, int c_rows, int g, int n, int s_chains,
                  uint32_t k0, uint32_t k1) {
  __shared__ float tab[2][kMaxG * kMaxN];
  const int c = blockIdx.y;
  const int s = blockIdx.x * kThreads + threadIdx.x;
  const bool live = s < s_chains;
  const int slice = g * n;
  const int64_t row = static_cast<int64_t>(c) * s_chains + s;

  int x = live ? init[row] : 0;
  for (int i = 0; i < t_steps; ++i) {
    float* buf = tab[i & 1];
    const float* src =
        tables + (static_cast<int64_t>(i) * c_rows + c) * slice;
    for (int k = threadIdx.x; k < slice; k += kThreads) buf[k] = src[k];
    __syncthreads();
    if (live) {
      const float* p1 = buf + x * n;
      int nx = 0;
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      for (int q = 0; q < n; ++q) {
        if ((q & 3) == 0) {
          w = ddqst::philox4x32_10(
              make_uint4(static_cast<uint32_t>(s), static_cast<uint32_t>(c),
                         static_cast<uint32_t>(i),
                         static_cast<uint32_t>(q >> 2)),
              k0, k1);
        }
        const float u = ddqst::philox_uniform(ddqst::philox_word(w, q & 3));
        nx |= (u < p1[q]) ? (1 << q) : 0;
      }
      x = nx;
    }
  }
  if (live) out[row] = x;
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on `stream` (PyTorch's
// current stream), does not synchronise, and returns cudaGetLastError()
// (0 = launched). Shapes are checked by the Python wrapper; this re-checks
// the limits the kernel's shared memory relies on.
extern "C" int ddqst_fused_chain_walk(const float* tables, const int32_t* init,
                                      int32_t* out, int t_steps, int c_rows,
                                      int g, int n, int s_chains,
                                      unsigned long long seed, void* stream) {
  if (g < 1 || g > kMaxG || n < 1 || n > kMaxN || (1 << n) != g ||
      t_steps < 1 || c_rows < 1 || c_rows > 65535 || s_chains < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((s_chains + kThreads - 1) / kThreads, c_rows);
  chain_walk_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tables, init, out, t_steps, c_rows, g, n, s_chains,
      static_cast<uint32_t>(seed & 0xFFFFFFFFull),
      static_cast<uint32_t>(seed >> 32));
  return static_cast<int>(cudaGetLastError());
}
