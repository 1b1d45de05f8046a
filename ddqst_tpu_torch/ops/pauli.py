"""Pauli algebra and linear-inversion density-matrix reconstruction.

The port's counterpart of ``ddqst_tpu/ops/pauli.py``, in native complex64
(the JAX package's split re/im form existed only because the TPU has no
complex ops). Sufficient statistics come once per basis: the mean parity of
every qubit subset, from outcome histograms by a fast Walsh–Hadamard
transform. Pauli coefficients follow by a factored per-qubit contraction,
and ρ assembles by a factored per-qubit transform, so nothing of size
``[4^N, d, d]`` or ``[4^N, B]`` is ever built.

Endianness: qubit q is bit q of the computational-basis index (qubit 0 =
LSB) and column q of every label array; Pauli matrices kron factor q=N-1
outermost.

Ported here: the factored path for the full canonical 3^N grid in
``"mean"`` mode. The dense path for basis subsets and ``"first"`` mode is
ROADMAP Queue 1 item 5 and raises ``NotImplementedError``.
"""

from __future__ import annotations

from itertools import product

import numpy as np
import torch

_SINGLE = np.stack(
    [
        np.array([[1, 0], [0, 1]], dtype=np.complex64),  # I
        np.array([[0, 1], [1, 0]], dtype=np.complex64),  # X
        np.array([[0, -1j], [1j, 0]], dtype=np.complex64),  # Y
        np.array([[1, 0], [0, -1]], dtype=np.complex64),  # Z
    ]
)

PAULI_CHARS = "IXYZ"


def all_basis_labels(num_qubits: int) -> np.ndarray:
    """``[3^N, N]`` int labels (0=X,1=Y,2=Z), column q = qubit q, in
    ``itertools.product('XYZ', repeat=N)`` order."""
    return np.array(list(product(range(3), repeat=num_qubits)), dtype=np.int32)


def pauli_matrices(labels: np.ndarray) -> np.ndarray:
    """``[K, d, d]`` complex64 Pauli strings from int labels (0=I..3=Z);
    qubit 0 is the innermost (LSB) kron factor."""
    labels = np.asarray(labels)
    if labels.ndim == 1:
        labels = labels[None]
    k, n = labels.shape
    mats = _SINGLE[labels[:, 0]]
    for q in range(1, n):
        nxt = _SINGLE[labels[:, q]]  # becomes the new MSB factor
        mats = np.einsum("kab,kij->kaibj", nxt, mats).reshape(
            k, mats.shape[1] * 2, mats.shape[2] * 2
        )
    return mats


def pauli_matrix(label_str: str) -> np.ndarray:
    """Single Pauli-string matrix from a character label ('XZI' etc.)."""
    label = np.array([PAULI_CHARS.index(c) for c in label_str], dtype=np.int32)
    return pauli_matrices(label)[0]


def counts_parity_means(counts: torch.Tensor, num_qubits: int) -> torch.Tensor:
    """Mean parity of every qubit subset from outcome histograms.

    ``counts [B, 2^N]`` -> ``[B, 2^N]`` float32 whose column m is
    Σ_x counts[b, x]·(-1)^popcount(x & m) / Σ_x counts[b, x]: the fast
    Walsh–Hadamard transform, N doubling passes.
    """
    b, d = counts.shape
    x = counts.to(torch.float32)
    tot = x.sum(dim=1, keepdim=True)
    for q in range(num_qubits):
        # [B, hi, 2, lo]: the middle axis is bit q of the outcome index.
        xr = x.reshape(b, d // 2 ** (q + 1), 2, 2**q)
        x = torch.stack(
            [xr[:, :, 0, :] + xr[:, :, 1, :], xr[:, :, 0, :] - xr[:, :, 1, :]],
            dim=2,
        ).reshape(b, d)
    return x / tot.clamp_min(1.0)


def coeffs_to_rho(coeff: torch.Tensor, num_qubits: int) -> torch.Tensor:
    """ρ = (1/d) Σ_p c_p P_p by a factored per-qubit transform.

    ``coeff [4^N]`` in ``product('IXYZ')`` order (qubit 0 slowest). Qubits
    fold in from N-1 down to 0, each landing as the low row/col bit beneath
    those already folded. Returns ``[d, d]`` complex64.
    """
    n = num_qubits
    s = torch.from_numpy(_SINGLE).to(coeff.device)
    t = coeff.to(torch.complex64).reshape((4,) * n + (1, 1))
    for _ in range(n):
        t = torch.einsum("...pab,pxy->...axby", t, s)
        sh = t.shape
        t = t.reshape(sh[:-4] + (sh[-4] * sh[-3], sh[-2] * sh[-1]))
    return t / 2**n


def _hermitian(h: torch.Tensor) -> torch.Tensor:
    return 0.5 * (h + h.mH)


def project_psd(rho: torch.Tensor) -> torch.Tensor:
    """Clip negative eigenvalues and renormalise the trace to 1."""
    w, v = torch.linalg.eigh(_hermitian(rho))
    wc = w.clamp_min(0.0)
    total = wc.sum()
    scale = torch.where(total > 0, 1.0 / torch.where(total > 0, total, 1.0),
                        torch.ones_like(total))
    return (v * (wc * scale).to(v.dtype)) @ v.mH


def _is_canonical_grid(basis_labels: np.ndarray, num_qubits: int) -> bool:
    basis_labels = np.asarray(basis_labels)
    if basis_labels.shape != (3**num_qubits, num_qubits):
        return False
    return bool(np.array_equal(basis_labels, all_basis_labels(num_qubits)))


def make_counts_inverter(
    num_qubits: int,
    basis_labels: np.ndarray | None = None,
    compat_mode: str = "mean",
    psd: bool = True,
    readout_p: float = 0.0,
):
    """Counts-native linear inversion: ``invert(counts [3^N, 2^N]) -> ρ``.

    Each Pauli coefficient averages the parity estimates of every compatible
    measured basis ("mean" mode). On the canonical grid that weight is a
    tensor product over qubits, so the estimate contracts qubit by qubit
    with one 24-float kernel ``A[pauli, basis, mask_bit]``. ``readout_p``
    mitigates a symmetric readout flip in closed form: a k-qubit parity
    shrinks by (1-2p)^k, so the non-identity rows of A are divided by
    (1-2p). ``psd`` projects onto the PSD cone with trace 1. Returns
    ``[d, d]`` complex64 on the counts' device.
    """
    if basis_labels is None:
        basis_labels = all_basis_labels(num_qubits)
    if compat_mode != "mean" or not _is_canonical_grid(basis_labels, num_qubits):
        raise NotImplementedError(
            "only the factored canonical-grid inverter ('mean' mode over all "
            "3^N bases in product('XYZ') order) is ported; the dense path "
            "for basis subsets and 'first' mode is ROADMAP Queue 1 item 5"
        )
    a_np = np.zeros((4, 3, 2), np.float32)
    a_np[0, :, 0] = 1.0 / 3.0
    for k in range(1, 4):
        a_np[k, k - 1, 1] = 1.0
    if readout_p > 0:
        a_np[1:] /= 1.0 - 2.0 * readout_p
    n = num_qubits

    def invert_counts(counts: torch.Tensor) -> torch.Tensor:
        a = torch.from_numpy(a_np).to(counts.device)
        # Axes after reshape: [b_0..b_{n-1}, m_{n-1}..m_0]; each step
        # contracts the adjacent (b_q, m_q) pair at the group boundary into
        # pauli digit p_q, appended on the right.
        t = counts_parity_means(counts, n).reshape((3,) * n + (2,) * n)
        for r in range(n, 0, -1):
            t = t.reshape(3 ** (r - 1), 3, 2, -1)
            t = torch.einsum("ibmr,pbm->irp", t, a)
        coeff = t.reshape((4,) * n).permute(tuple(range(n - 1, -1, -1)))
        coeff = coeff.reshape(-1).clone()
        coeff[0] = 1.0  # <I..I> == 1 exactly
        rho = coeffs_to_rho(coeff, n)
        return project_psd(rho) if psd else rho

    return invert_counts
