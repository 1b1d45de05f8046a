"""Quantum-state metrics in native complex64 PyTorch.

The port's counterpart of ``ddqst_tpu/ops/metrics.py``: fidelity, trace
distance, purity, von Neumann and entanglement entropy, Pauli expectations
and the Z-basis bias. Inputs are complex (or real) tensors or numpy arrays;
a 1-D input is a statevector. Entropies use log base 2.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ddqst_tpu_torch.ops.pauli import pauli_matrix


def as_complex(x, device=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t.to(device=device if device is not None else t.device,
                dtype=torch.complex64)


def _hermitian(h: torch.Tensor) -> torch.Tensor:
    return 0.5 * (h + h.mH)


def _clamp_fid(value: torch.Tensor, tol: float = 1e-3) -> torch.Tensor:
    """Absorb f32 rounding overshoot only: clamp F to 1 when within ``tol``.

    A value beyond 1 + tol is a broken estimator and passes through
    unclamped, so the fault surfaces instead of reading as a perfect 1.0.
    """
    return torch.where((value > 1.0) & (value <= 1.0 + tol),
                       torch.ones_like(value), value)


def _sqrtm_psd(h: torch.Tensor) -> torch.Tensor:
    w, v = torch.linalg.eigh(_hermitian(h))
    return (v * w.clamp_min(0.0).sqrt().to(v.dtype)) @ v.mH


def state_fidelity(rho, sigma) -> torch.Tensor:
    """Uhlmann fidelity F(ρ,σ) = (tr √(√ρ σ √ρ))², with the pure shortcuts
    |⟨ψ|φ⟩|² and ⟨ψ|σ|ψ⟩ where an argument is a statevector."""
    rho = as_complex(rho)
    sigma = as_complex(sigma, rho.device)
    if rho.dim() == 1 and sigma.dim() == 1:
        return _clamp_fid(torch.vdot(rho, sigma).abs().square())
    if rho.dim() == 1:
        return _clamp_fid(torch.vdot(rho, sigma @ rho).real)
    if sigma.dim() == 1:
        return _clamp_fid(torch.vdot(sigma, rho @ sigma).real)
    s = _sqrtm_psd(rho)
    evals = torch.linalg.eigvalsh(_hermitian(s @ sigma @ s))
    return _clamp_fid(evals.clamp_min(0.0).sqrt().sum().square())


def _pure_to_dm(psi: torch.Tensor) -> torch.Tensor:
    return torch.outer(psi, psi.conj())


def trace_distance(rho, sigma) -> torch.Tensor:
    """T(ρ,σ) = ½ Σ|λ_i(ρ−σ)|; statevectors are promoted to density matrices."""
    rho = as_complex(rho)
    sigma = as_complex(sigma, rho.device)
    if rho.dim() == 1:
        rho = _pure_to_dm(rho)
    if sigma.dim() == 1:
        sigma = _pure_to_dm(sigma)
    return 0.5 * torch.linalg.eigvalsh(_hermitian(rho - sigma)).abs().sum()


def purity(rho) -> torch.Tensor:
    """tr(ρ²) = Σ|ρ_ij|² for Hermitian ρ."""
    rho = as_complex(rho)
    return (rho.real.square() + rho.imag.square()).sum()


def von_neumann_entropy(rho) -> torch.Tensor:
    """S(ρ) = -Σ λ log2 λ."""
    evals = torch.linalg.eigvalsh(_hermitian(as_complex(rho))).clamp_min(0.0)
    logs = torch.where(evals > 0, torch.log(evals.clamp_min(1e-38)),
                       torch.zeros_like(evals))
    return -(evals * logs).sum() / math.log(2.0)


def partial_trace_keep_low(rho, num_keep: int) -> torch.Tensor:
    """Trace out the high qubits, keeping qubits 0..num_keep-1 (the LSBs)."""
    rho = as_complex(rho)
    d = rho.shape[-1]
    d_low = 2**num_keep
    d_high = d // d_low
    return torch.einsum("aiaj->ij", rho.reshape(d_high, d_low, d_high, d_low))


def entanglement_entropy(rho, num_qubits: int) -> torch.Tensor:
    """Entropy of the half-cut reduced state (keep qubits 0..N//2-1)."""
    return von_neumann_entropy(partial_trace_keep_low(rho, num_qubits // 2))


def get_metrics(rho, num_qubits: int):
    """(purity, von Neumann entropy, entanglement entropy)."""
    rho = as_complex(rho)
    return (
        purity(rho),
        von_neumann_entropy(rho),
        entanglement_entropy(rho, num_qubits),
    )


def pauli_expectations(rho, labels=None) -> dict[str, float]:
    """⟨P⟩ = Re tr(ρP) for Pauli strings (default: single-qubit X/Y/Z)."""
    rho = as_complex(rho)
    n = int(np.log2(rho.shape[-1]))
    if labels is None:
        labels = [
            "I" * q + c + "I" * (n - q - 1) for c in "XYZ" for q in range(n)
        ]
    out = {}
    for lab in labels:
        p = torch.from_numpy(pauli_matrix(lab)).to(rho.device)
        out[lab] = float((rho.real * p.real + rho.imag * p.imag).sum())
    return out


def z_bias(z_samples: torch.Tensor) -> torch.Tensor:
    """Fraction of zeros in computational-basis samples (0.5 = balanced)."""
    return (z_samples == 0).to(torch.float32).mean()
