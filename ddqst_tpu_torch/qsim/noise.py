"""Noise channels: the reference's five noise models, qiskit-free.

The port's counterpart of ``ddqst_tpu/qsim/noise.py``:

- ``ideal``        — no noise.
- ``readout``      — symmetric per-qubit readout flip, p = 0.01.
- ``depolarizing`` — gate-level depolarizing, 1q p = 0.01, 2q p = 0.1.
- ``thermal``      — thermal relaxation with T1 = 50 µs, T2 = 70 µs, gate
  times 50 ns (1q) / 300 ns (2q).
- ``torino``       — a calibrated generic stand-in for IBM's FakeTorino
  snapshot: readout p ≈ 0.015, 1q depolarizing 2.5e-4, 2q 3e-3.

Gate-level channels need density-matrix simulation; ρ is at most 2^N x 2^N
at the full route's sizes, so evolution stays host-side numpy (as in the
JAX package). Readout noise acts as a confusion matrix on the Born
probabilities, a torch op on the caller's device, or bit by bit on shots
(``flip_bits``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ddqst_tpu_torch.qsim import gates as G
from ddqst_tpu_torch.qsim.states import Circuit, apply_gate_to, circuit_statevector


@dataclasses.dataclass(frozen=True)
class NoiseConfig:
    kind: str = "ideal"
    readout_p: float = 0.0
    depol_1q: float = 0.0
    depol_2q: float = 0.0
    t1_ns: float = 0.0  # 0 disables thermal relaxation
    t2_ns: float = 0.0
    gate_time_1q_ns: float = 50.0
    gate_time_2q_ns: float = 300.0

    @property
    def has_gate_noise(self) -> bool:
        return self.depol_1q > 0 or self.depol_2q > 0 or self.t1_ns > 0


_PRESETS = {
    "ideal": NoiseConfig(kind="ideal"),
    "readout": NoiseConfig(kind="readout", readout_p=0.01),
    "depolarizing": NoiseConfig(kind="depolarizing", depol_1q=0.01, depol_2q=0.1),
    "thermal": NoiseConfig(kind="thermal", t1_ns=50e3, t2_ns=70e3),
    "torino": NoiseConfig(
        kind="torino", readout_p=0.015, depol_1q=2.5e-4, depol_2q=3e-3
    ),
}


def get_noise_config(name: str) -> NoiseConfig:
    try:
        return _PRESETS[name]
    except KeyError:
        raise ValueError(
            f"unknown noise type {name!r}; options: {sorted(_PRESETS)}"
        ) from None


# --- Readout noise ----------------------------------------------------------


def confusion_matrix(num_qubits: int, p: float) -> np.ndarray:
    """``[d, d]`` symmetric readout confusion matrix (columns = true state)."""
    m1 = np.array([[1 - p, p], [p, 1 - p]], dtype=np.float32)
    m = m1
    for _ in range(num_qubits - 1):
        m = np.kron(m1, m)
    return m


def apply_readout_to_probs(
    probs: torch.Tensor, num_qubits: int, p: float
) -> torch.Tensor:
    """Push Born probabilities through the readout channel: p' = M p."""
    if p <= 0:
        return probs
    m = torch.from_numpy(confusion_matrix(num_qubits, p)).to(probs.device)
    return torch.einsum("ij,...j->...i", m, probs)


def flip_bits(generator: torch.Generator, bits: torch.Tensor,
              p: float) -> torch.Tensor:
    """Flip each bit independently with probability ``p`` (bit-level
    readout noise): an XOR with Bernoulli(p) draws from ``generator``, on
    ``bits``' device."""
    flips = torch.rand(bits.shape, generator=generator,
                       device=bits.device) < p
    return bits ^ flips.to(bits.dtype)


# --- Gate-level channels (host-side density-matrix simulation) --------------


def _dm_tensor(rho: np.ndarray, n: int) -> np.ndarray:
    return rho.reshape([2] * (2 * n))


def _apply_depolarizing(rho: np.ndarray, qubits, n: int, p: float) -> np.ndarray:
    """ρ → (1-p) ρ + p · (I/2^k on `qubits`) ⊗ tr_qubits(ρ).

    Integer-subscript einsums: bra axis of qubit q is tensor axis n-1-q with
    subscript q; ket axis is 2n-1-q with subscript n+q.
    """
    t = _dm_tensor(rho, n)
    k = len(qubits)
    gate_set = set(qubits)
    # Trace the gate qubits: reuse the bra subscript on the ket axis.
    sub_t = [0] * (2 * n)
    for q in range(n):
        sub_t[n - 1 - q] = q
        sub_t[2 * n - 1 - q] = q if q in gate_set else n + q
    out_traced = []
    for q in range(n - 1, -1, -1):
        if q not in gate_set:
            out_traced.append(q)
    for q in range(n - 1, -1, -1):
        if q not in gate_set:
            out_traced.append(n + q)
    traced = np.einsum(t, sub_t, out_traced)
    # Embed I/2^k ⊗ traced back into the full tensor.
    mixed = (np.eye(2**k, dtype=rho.dtype) / 2**k).reshape([2] * (2 * k))
    sub_m = [qubits[k - 1 - j] for j in range(k)] + [
        n + qubits[k - 1 - j] for j in range(k)
    ]
    out_full = [q for q in range(n - 1, -1, -1)] + [
        n + q for q in range(n - 1, -1, -1)
    ]
    full = np.einsum(mixed, sub_m, traced, out_traced, out_full)
    return (1 - p) * rho + p * full.reshape(rho.shape)


def _apply_thermal(rho: np.ndarray, qubit: int, n: int,
                   t1: float, t2: float, dt: float) -> np.ndarray:
    """Thermal relaxation superoperator on one qubit."""
    e1 = np.exp(-dt / t1)
    e2 = np.exp(-dt / t2)
    t = _dm_tensor(rho, n).copy()
    ab = n - 1 - qubit       # bra axis
    ak = 2 * n - 1 - qubit   # ket axis
    idx = [slice(None)] * (2 * n)

    def block(i, j):
        s = list(idx)
        s[ab], s[ak] = i, j
        return tuple(s)

    r00, r01 = t[block(0, 0)].copy(), t[block(0, 1)].copy()
    r10, r11 = t[block(1, 0)].copy(), t[block(1, 1)].copy()
    t[block(0, 0)] = r00 + (1 - e1) * r11
    t[block(1, 1)] = e1 * r11
    t[block(0, 1)] = e2 * r01
    t[block(1, 0)] = e2 * r10
    return t.reshape(rho.shape)


def simulate_density_matrix(circuit: Circuit, cfg: NoiseConfig) -> np.ndarray:
    """Density-matrix evolution with per-gate noise channels.

    After every gate, the configured channels act on that gate's qubits.
    """
    n = circuit.num_qubits
    d = 2**n
    rho = np.zeros((d, d), dtype=np.complex64)
    rho[0, 0] = 1.0
    for g in circuit.gates:
        u = G.gate_matrix(g.name, g.params)
        # ρ → U ρ U†, applied as column then row transforms.
        rho = apply_gate_to(rho, u, g.qubits, n)
        rho = apply_gate_to(rho.conj().T, u, g.qubits, n).conj().T
        k = len(g.qubits)
        p = cfg.depol_1q if k == 1 else cfg.depol_2q
        if p > 0:
            rho = _apply_depolarizing(rho, g.qubits, n, p)
        if cfg.t1_ns > 0:
            dt = cfg.gate_time_1q_ns if k == 1 else cfg.gate_time_2q_ns
            for q in g.qubits:
                rho = _apply_thermal(rho, q, n, cfg.t1_ns, cfg.t2_ns, dt)
    return rho


def noisy_state(circuit: Circuit, cfg: NoiseConfig):
    """Returns ("pure", psi) or ("mixed", rho) after gate-level noise.

    Readout noise is *not* applied here — it acts on measurement
    probabilities downstream (see :func:`apply_readout_to_probs`).
    """
    if cfg.has_gate_noise:
        return "mixed", simulate_density_matrix(circuit, cfg)
    return "pure", circuit_statevector(circuit)
