"""Basis rotation + Born-rule sampling, batched on the caller's device.

The port's counterpart of ``ddqst_tpu/qsim/measure.py``. The rotated
probability vectors for every basis (and, for datasets, every circuit with
its own basis set) come from one complex64 einsum (TF32 is off: see the
package docstring), and all shots from one ``torch.multinomial`` call with
an explicit generator.

Measurement basis rotations: X → H, Y → S† then H (matrix H @ S†),
Z → identity.
"""

from __future__ import annotations

import numpy as np
import torch

from ddqst_tpu_torch.qsim import gates as G

_ROT1 = np.stack([G.H, G.H @ G.SDG, G.I])  # [3, 2, 2]: X, Y, Z


def rotation_unitary(basis_label) -> np.ndarray:
    """Full-space rotation for one basis label (ints 0=X, 1=Y, 2=Z; index q
    = qubit q), complex64 ``[2^N, 2^N]``."""
    return rotation_unitaries(np.asarray(basis_label)[None])[0]


def rotation_unitaries(basis_labels: np.ndarray) -> np.ndarray:
    """``[B, d, d]`` complex64 rotations for a stack of basis labels
    (ints 0=X, 1=Y, 2=Z; column q = qubit q)."""
    basis_labels = np.asarray(basis_labels)
    mats = _ROT1[basis_labels[:, 0]]
    for q in range(1, basis_labels.shape[1]):
        nxt = _ROT1[basis_labels[:, q]]
        mats = np.einsum("kab,kij->kaibj", nxt, mats).reshape(
            mats.shape[0], mats.shape[1] * 2, mats.shape[2] * 2
        )
    return mats


def measurement_probs(psi, basis_label) -> torch.Tensor:
    """Outcome probabilities ``[2^N]`` float32 of measuring ``psi`` (a
    complex statevector: a numpy array, or a tensor on any device) in one
    Pauli basis."""
    psi = torch.as_tensor(psi)
    u = torch.from_numpy(rotation_unitary(basis_label)).to(psi.device)
    phi = u @ psi.to(torch.complex64)
    return phi.real.square() + phi.imag.square()


def batched_probs_pure(psis: torch.Tensor, rots: torch.Tensor) -> torch.Tensor:
    """``[C, d]`` states x ``[B, d, d]`` rotations -> ``[C, B, d]`` probs."""
    phi = torch.einsum("bij,cj->cbi", rots, psis)
    p = phi.real.square() + phi.imag.square()
    return p / p.sum(dim=-1, keepdim=True)


def batched_probs_mixed(rhos: torch.Tensor, rots: torch.Tensor) -> torch.Tensor:
    """``[C, d, d]`` density matrices x ``[B, d, d]`` rotations -> ``[C, B, d]``.

    diag(U ρ U†)_i = Σ_k (Uρ)_ik conj(U)_ik; only the real part survives on
    the diagonal of a Hermitian product.
    """
    t = torch.einsum("bij,cjk->cbik", rots, rhos)  # U ρ
    p = torch.einsum("cbik,bik->cbi", t.real, rots.real) + torch.einsum(
        "cbik,bik->cbi", t.imag, rots.imag
    )
    p = p.clamp_min(0.0)
    return p / p.sum(dim=-1, keepdim=True)


def batched_probs_pure_per_circuit(
    psis: torch.Tensor, rots: torch.Tensor
) -> torch.Tensor:
    """``[C, d]`` states x per-circuit ``[C, B, d, d]`` rotations ->
    ``[C, B, d]`` (each state rotated by its own basis stack)."""
    phi = torch.einsum("cbij,cj->cbi", rots, psis)
    p = phi.real.square() + phi.imag.square()
    return p / p.sum(dim=-1, keepdim=True)


def batched_probs_mixed_per_circuit(
    rhos: torch.Tensor, rots: torch.Tensor
) -> torch.Tensor:
    """``[C, d, d]`` density matrices x ``[C, B, d, d]`` rotations ->
    ``[C, B, d]``."""
    t = torch.einsum("cbij,cjk->cbik", rots, rhos)
    p = torch.einsum("cbik,cbik->cbi", t.real, rots.real) + torch.einsum(
        "cbik,cbik->cbi", t.imag, rots.imag
    )
    p = p.clamp_min(0.0)
    return p / p.sum(dim=-1, keepdim=True)


def sample_outcomes(
    generator: torch.Generator, probs: torch.Tensor, shots: int
) -> torch.Tensor:
    """probs ``[..., d]`` -> ``[..., shots]`` int64 categorical outcomes,
    drawn with replacement per row from ``generator`` (on ``probs``'
    device)."""
    lead, d = probs.shape[:-1], probs.shape[-1]
    outcomes = torch.multinomial(
        probs.reshape(-1, d), shots, replacement=True, generator=generator
    )
    return outcomes.reshape(*lead, shots)


def sample_counts(
    generator: torch.Generator, probs: torch.Tensor, shots: int
) -> torch.Tensor:
    """probs ``[..., d]`` -> counts ``[..., d]`` int32 summing to ``shots``.

    A scatter-add histogram of :func:`sample_outcomes`: O(rows·shots) work
    and no ``[..., shots, d]`` one-hot.
    """
    d = probs.shape[-1]
    outcomes = sample_outcomes(generator, probs, shots).reshape(-1, shots)
    out = torch.zeros((outcomes.shape[0], d), dtype=torch.int32,
                      device=probs.device)
    out.scatter_add_(1, outcomes, torch.ones_like(outcomes, dtype=torch.int32))
    return out.reshape(*probs.shape[:-1], d)


def outcomes_to_bits(outcomes: torch.Tensor, num_qubits: int) -> torch.Tensor:
    """Unpack little-endian outcome indices into ``[..., N]`` bits (qubit 0 first)."""
    shifts = torch.arange(num_qubits, device=outcomes.device)
    return ((outcomes[..., None] >> shifts) & 1).to(torch.int8)


def sample_bits(
    generator: torch.Generator, probs: torch.Tensor, shots: int, num_qubits: int
) -> torch.Tensor:
    """probs ``[..., d]`` -> bit samples ``[..., shots, N]`` int8.

    ``generator`` lives on ``probs``' device. The draw is categorical, as
    the JAX package's ``jax.random.categorical``; the two streams differ.
    """
    return outcomes_to_bits(sample_outcomes(generator, probs, shots),
                            num_qubits)
