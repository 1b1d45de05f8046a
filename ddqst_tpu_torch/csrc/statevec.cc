// Native statevector evolution engine (host side).
//
// The port's copy of ddqst_tpu/qsim/native/statevec.cc, with the same C
// interface and the same arithmetic: exact circuit evolution for the dataset
// builder. The device does everything batched (basis rotations, Born
// sampling); this engine runs the sequential gate chain of each circuit on
// the host.
//
// Conventions match ddqst_tpu_torch.qsim: qubit 0 is the least-significant
// bit of the amplitude index; a k-qubit gate matrix is little-endian in its
// own qubit list (first listed qubit = low bit of the matrix index).
//
// Complex numbers are interleaved float32 (re, im) pairs. Built at first use
// by ddqst_tpu_torch/ops/_build.py:
//   g++ -O3 -shared -fPIC -o libstatevec_<hash>.so statevec.cc

#include <cstdint>
#include <cstring>

namespace {

inline void cmul_acc(const float* a, const float* b, float* out) {
  // out += a * b (complex)
  out[0] += a[0] * b[0] - a[1] * b[1];
  out[1] += a[0] * b[1] + a[1] * b[0];
}

void apply_1q(float* psi, int n, int q, const float* m) {
  const int64_t dim = int64_t(1) << n;
  const int64_t bit = int64_t(1) << q;
  for (int64_t base = 0; base < dim; ++base) {
    if (base & bit) continue;
    float* a0 = psi + 2 * base;
    float* a1 = psi + 2 * (base | bit);
    float r0[2] = {0, 0}, r1[2] = {0, 0};
    cmul_acc(m + 0, a0, r0);  // m[0,0] * a0
    cmul_acc(m + 2, a1, r0);  // m[0,1] * a1
    cmul_acc(m + 4, a0, r1);  // m[1,0] * a0
    cmul_acc(m + 6, a1, r1);  // m[1,1] * a1
    a0[0] = r0[0]; a0[1] = r0[1];
    a1[0] = r1[0]; a1[1] = r1[1];
  }
}

void apply_2q(float* psi, int n, int q0, int q1, const float* m) {
  // Matrix index = b1 * 2 + b0 with b0 the bit of q0 (first listed qubit).
  const int64_t dim = int64_t(1) << n;
  const int64_t bit0 = int64_t(1) << q0;
  const int64_t bit1 = int64_t(1) << q1;
  for (int64_t base = 0; base < dim; ++base) {
    if (base & (bit0 | bit1)) continue;
    float* amp[4] = {
        psi + 2 * base,
        psi + 2 * (base | bit0),
        psi + 2 * (base | bit1),
        psi + 2 * (base | bit0 | bit1),
    };
    float in[8], out[8] = {0};
    for (int i = 0; i < 4; ++i) {
      in[2 * i] = amp[i][0];
      in[2 * i + 1] = amp[i][1];
    }
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j)
        cmul_acc(m + 2 * (4 * i + j), in + 2 * j, out + 2 * i);
    for (int i = 0; i < 4; ++i) {
      amp[i][0] = out[2 * i];
      amp[i][1] = out[2 * i + 1];
    }
  }
}

}  // namespace

extern "C" {

// Evolve one statevector in place through a gate program.
//   psi:         [2 * 2^n] float32, interleaved complex amplitudes.
//   num_gates:   program length.
//   ks:          [num_gates] gate arities (1 or 2).
//   qubits:      [num_gates * 2] target qubits (second slot unused for 1q).
//   mats:        concatenated little-endian matrices, interleaved complex.
//   mat_offsets: [num_gates] float-offsets of each matrix within `mats`.
void evolve(float* psi, int n, int num_gates, const int* ks,
            const int* qubits, const float* mats,
            const int64_t* mat_offsets) {
  for (int gi = 0; gi < num_gates; ++gi) {
    const float* m = mats + mat_offsets[gi];
    if (ks[gi] == 1) {
      apply_1q(psi, n, qubits[2 * gi], m);
    } else {
      apply_2q(psi, n, qubits[2 * gi], qubits[2 * gi + 1], m);
    }
  }
}

// Evolve `batch` statevectors, each with its own program slice.
//   gate_starts/gate_counts: [batch] slices into the program arrays.
//   All statevectors start as |0...0> (the function initialises them).
void evolve_batch_from_zero(float* psis, int n, int batch,
                            const int* gate_starts, const int* gate_counts,
                            const int* ks, const int* qubits,
                            const float* mats, const int64_t* mat_offsets) {
  const int64_t dim = int64_t(1) << n;
  for (int c = 0; c < batch; ++c) {
    float* psi = psis + 2 * dim * c;
    std::memset(psi, 0, sizeof(float) * 2 * dim);
    psi[0] = 1.0f;
    const int s = gate_starts[c];
    evolve(psi, n, gate_counts[c], ks + s, qubits + 2 * s, mats,
           mat_offsets + s);
  }
}

}  // extern "C"
