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

Coefficient estimation modes:

- ``"mean"`` (default): average the parity estimate over all compatible
  measured bases.
- ``"first"``: use only the first compatible basis (the reference's rule).

The full canonical 3^N grid in ``"mean"`` mode takes a factored path; basis
subsets and ``"first"`` mode take the dense ``[4^N, B]`` compatibility
weights.
"""

from __future__ import annotations

import functools
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
BASIS_CHARS = "XYZ"


def all_pauli_labels(num_qubits: int) -> np.ndarray:
    """``[4^N, N]`` int labels (0=I,1=X,2=Y,3=Z), column q = qubit q, in
    ``itertools.product('IXYZ', repeat=N)`` order (qubit 0 slowest)."""
    return np.array(list(product(range(4), repeat=num_qubits)), dtype=np.int32)


def all_basis_labels(num_qubits: int) -> np.ndarray:
    """``[3^N, N]`` int labels (0=X,1=Y,2=Z), column q = qubit q, in
    ``itertools.product('XYZ', repeat=N)`` order."""
    return np.array(list(product(range(3), repeat=num_qubits)), dtype=np.int32)


def basis_label_to_str(label: np.ndarray) -> str:
    return "".join(BASIS_CHARS[i] for i in label)


def basis_str_to_label(s: str) -> np.ndarray:
    return np.array([BASIS_CHARS.index(c) for c in s], dtype=np.int32)


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


def subset_parity_means(
    bits: torch.Tensor, weights: torch.Tensor | None = None
) -> torch.Tensor:
    """Mean parity of every qubit subset, per measured basis.

    ``bits [B, S, N]`` integer samples; ``weights`` optional ``[B, S]``
    nonnegative sample weights (zero-weight rows are padding). Returns
    ``[B, 2^N]`` float32 whose column m is E[Π_{q in m} (1 - 2 x_q)]; column
    0 is 1.
    """
    b, s, n = bits.shape
    vals = (1 - 2 * bits).to(torch.float32)
    par = torch.ones((b, s, 1), dtype=torch.float32, device=bits.device)
    for q in range(n):  # doubling: [B, S, 2^q] -> [B, S, 2^(q+1)]
        par = torch.cat([par, par * vals[:, :, q:q + 1]], dim=-1)
    if weights is None:
        return par.mean(dim=1)
    w = weights.to(torch.float32)
    tot = w.sum(dim=1, keepdim=True)
    return torch.einsum("bs,bsm->bm", w, par) / tot.clamp_min(1.0)


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


def _compat_weights(
    num_qubits: int, basis_labels: np.ndarray, mode: str
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side ``(W [4^N, B] float32, mask_idx [4^N] int32)``.

    ``W[p, b]`` weights basis b's parity estimate in Pauli p's coefficient;
    rows sum to 1, or to 0 for Pauli strings no measured basis can estimate
    (their coefficient comes out 0). ``mask_idx[p]`` is the subset mask: bit
    q set iff Pauli p acts nontrivially on qubit q.
    """
    paulis = all_pauli_labels(num_qubits)
    nontrivial = paulis != 0
    mask_idx = (nontrivial * (1 << np.arange(num_qubits))).sum(1).astype(np.int32)
    # Compatible: on every non-identity site the basis char is the Pauli's
    # (Pauli codes 1,2,3 = X,Y,Z against basis codes 0,1,2).
    compat = np.all(
        ~nontrivial[:, None, :]
        | (paulis[:, None, :] - 1 == np.asarray(basis_labels)[None, :, :]),
        axis=-1,
    )
    if mode == "first":
        w = np.zeros(compat.shape, dtype=np.float32)
        has = compat.any(axis=1)
        first = compat.argmax(axis=1)
        w[np.nonzero(has)[0], first[has]] = 1.0
    elif mode == "mean":
        counts = compat.sum(axis=1, keepdims=True)
        w = compat.astype(np.float32) / np.maximum(counts, 1)
    else:
        raise ValueError(f"unknown compat mode: {mode!r}")
    return w.astype(np.float32), mask_idx


def _make_parities_to_rho(
    num_qubits: int,
    basis_labels: np.ndarray | None,
    compat_mode: str,
    psd: bool,
    readout_p: float,
):
    """Shared core: per-basis subset parities ``[B, 2^N]`` -> ρ.

    - Factored (full canonical grid, "mean" mode): the compatibility weight
      is a tensor product over qubits, so the estimate contracts qubit by
      qubit with one 24-float kernel ``A[pauli, basis, mask_bit]`` (I
      averages the 3 basis choices at mask bit 0; X/Y/Z select their own
      basis at mask bit 1). Readout mitigation divides the non-identity
      rows of A by (1-2p).
    - Dense (basis subsets or "first" mode): the ``[4^N, B]`` weights of
      :func:`_compat_weights`, each row scaled by ``(1-2p)^-|mask|``.

    Both set ``<I..I> = 1`` exactly.
    """
    if basis_labels is None:
        basis_labels = all_basis_labels(num_qubits)
    n = num_qubits
    if compat_mode == "mean" and _is_canonical_grid(basis_labels, n):
        a_np = np.zeros((4, 3, 2), np.float32)
        a_np[0, :, 0] = 1.0 / 3.0
        for k in range(1, 4):
            a_np[k, k - 1, 1] = 1.0
        if readout_p > 0:
            a_np[1:] /= 1.0 - 2.0 * readout_p

        def parities_to_rho_factored(parities: torch.Tensor) -> torch.Tensor:
            a = torch.from_numpy(a_np).to(parities.device)
            # Axes after reshape: [b_0..b_{n-1}, m_{n-1}..m_0]; each step
            # contracts the adjacent (b_q, m_q) pair at the group boundary
            # into pauli digit p_q, appended on the right.
            t = parities.reshape((3,) * n + (2,) * n)
            for r in range(n, 0, -1):
                t = t.reshape(3 ** (r - 1), 3, 2, -1)
                t = torch.einsum("ibmr,pbm->irp", t, a)
            coeff = t.reshape((4,) * n).permute(tuple(range(n - 1, -1, -1)))
            coeff = coeff.reshape(-1).clone()
            coeff[0] = 1.0
            rho = coeffs_to_rho(coeff, n)
            return project_psd(rho) if psd else rho

        return parities_to_rho_factored

    w_np, mask_idx_np = _compat_weights(n, basis_labels, compat_mode)
    if readout_p > 0:
        mask_sizes = np.asarray((all_pauli_labels(n) != 0).sum(axis=1),
                                np.float32)
        w_np = w_np * ((1.0 - 2.0 * readout_p) ** -mask_sizes)[:, None]
    w_np = w_np.astype(np.float32)

    def parities_to_rho(parities: torch.Tensor) -> torch.Tensor:
        w = torch.from_numpy(w_np).to(parities.device)
        mask_idx = torch.from_numpy(mask_idx_np).long().to(parities.device)
        selected = parities[:, mask_idx]  # [B, P]
        coeff = torch.einsum("pb,bp->p", w, selected)
        coeff[0] = 1.0  # the all-identity string is row 0
        rho = coeffs_to_rho(coeff, n)
        return project_psd(rho) if psd else rho

    return parities_to_rho


def make_inverter(
    num_qubits: int,
    basis_labels: np.ndarray | None = None,
    compat_mode: str = "mean",
    psd: bool = True,
    readout_p: float = 0.0,
):
    """Linear inversion from per-shot bits for a fixed basis set.

    ``basis_labels [B, N]`` are the measured bases in the row order of the
    ``bits`` argument (default: all 3^N canonical). ``readout_p`` mitigates
    a symmetric per-qubit readout flip in closed form: a k-qubit parity
    shrinks by (1-2p)^k, so the clean estimate is the measured parity over
    (1-2p)^|mask|. ``psd`` projects onto the PSD cone with trace 1.

    Returns ``invert(bits [B, S, N], weights=None) -> ρ [d, d]`` complex64
    on the bits' device.
    """
    parities_to_rho = _make_parities_to_rho(
        num_qubits, basis_labels, compat_mode, psd, readout_p
    )

    def invert(bits: torch.Tensor, weights: torch.Tensor | None = None):
        return parities_to_rho(subset_parity_means(bits, weights))

    return invert


def make_counts_inverter(
    num_qubits: int,
    basis_labels: np.ndarray | None = None,
    compat_mode: str = "mean",
    psd: bool = True,
    readout_p: float = 0.0,
):
    """Counts-native linear inversion: ``invert(counts [B, 2^N]) -> ρ``.

    The estimator of :func:`make_inverter`, fed outcome histograms (counts
    over the 2^N little-endian outcomes per basis); the parities come from
    the fast Walsh–Hadamard transform (:func:`counts_parity_means`).
    Returns ``[d, d]`` complex64 on the counts' device.
    """
    parities_to_rho = _make_parities_to_rho(
        num_qubits, basis_labels, compat_mode, psd, readout_p
    )

    def invert_counts(counts: torch.Tensor) -> torch.Tensor:
        return parities_to_rho(counts_parity_means(counts, num_qubits))

    return invert_counts


@functools.lru_cache(maxsize=32)
def _cached_inverter(num_qubits: int, compat_mode: str, psd: bool):
    return make_inverter(num_qubits, None, compat_mode, psd)


def linear_inversion(
    bits: torch.Tensor,
    num_qubits: int,
    weights: torch.Tensor | None = None,
    compat_mode: str = "mean",
    psd: bool = True,
) -> torch.Tensor:
    """One-shot linear inversion over the full canonical 3^N basis set:
    ``bits [3^N, S, N]`` in :func:`all_basis_labels` row order. For partial
    basis sets use :func:`make_inverter`."""
    return _cached_inverter(num_qubits, compat_mode, psd)(bits, weights)
