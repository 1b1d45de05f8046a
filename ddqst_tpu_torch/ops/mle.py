"""Outcome histograms and maximum-likelihood reconstruction (iterative RρR).

The port's counterpart of ``ddqst_tpu/ops/mle.py``, in native complex64
(the JAX package's split re/im form existed only because the TPU has no
complex ops; TF32 is off, see the package docstring):

  R(ρ) = Σ_{b,i} f_{b,i} / tr(ρ Π_{b,i}) · Π_{b,i},     ρ ← R ρ R / tr(·)

with POVM elements Π_{b,i} = U_b† |i⟩⟨i| U_b for each measured basis b and
outcome i. Readout error folds into the POVM, Π'_{b,i} = Σ_j M_{ij} Π_{b,j},
so the likelihood is that of the actual noisy measurement and no
quasi-probability inversion is needed. Qubit 0 is the least significant bit
of every outcome index.

The iteration stops at the first update whose Frobenius norm is at most
``tol``. The test runs on the device: once it holds, ρ is frozen
(``torch.where``) and the host reads the flag only once per
``iters_per_call`` iterations, so a solve costs a handful of
synchronisations and returns the ρ of the stopping iteration.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ddqst_tpu_torch.ops.pauli import all_basis_labels
from ddqst_tpu_torch.qsim.measure import rotation_unitaries
from ddqst_tpu_torch.qsim.noise import confusion_matrix


def bits_to_counts(bits: torch.Tensor) -> torch.Tensor:
    """``[B, S, N]`` bit samples -> ``[B, 2^N]`` float32 outcome counts.

    A scatter-add histogram: O(B·S) work, no ``[B, S, 2^N]`` one-hot.
    """
    b, s, n = bits.shape
    powers = 1 << torch.arange(n, device=bits.device)
    idx = (bits.long() * powers).sum(-1)  # [B, S]
    out = torch.zeros((b, 2**n), dtype=torch.float32, device=bits.device)
    return out.scatter_add_(1, idx, torch.ones(idx.shape, device=bits.device))


def _povm_elements(
    num_qubits: int, basis_labels: np.ndarray, readout_p: float
) -> np.ndarray:
    """Host-side POVM stack ``[B*d, d, d]`` complex64."""
    d = 2**num_qubits
    rots = rotation_unitaries(basis_labels)  # [B, d, d]
    # Π_{b,i} = U† |i><i| U: the outer product of U's i-th row, conjugated,
    # with itself.
    rows = rots.conj()
    pis = np.einsum("bik,bil->bikl", rows, rows.conj())  # [B, d, d, d]
    if readout_p > 0:
        m = confusion_matrix(num_qubits, readout_p)  # [d_meas, d_true]
        pis = np.einsum("ij,bjkl->bikl", m, pis)
    return pis.reshape(basis_labels.shape[0] * d, d, d).astype(np.complex64)


def _rot1(basis_labels: np.ndarray) -> np.ndarray:
    """Per-qubit 2x2 rotations of each basis row, ``[B, N, 2, 2]`` complex64:
    the single-qubit factors of U_b = ⊗_q u_{b_q} (qubit 0 = LSB, as
    ``qsim.measure.rotation_unitaries``)."""
    n = basis_labels.shape[1]
    return np.stack(
        [rotation_unitaries(basis_labels[:, q:q + 1]) for q in range(n)],
        axis=1,
    ).astype(np.complex64)


def _apply_left(t: torch.Tensor, u: torch.Tensor, q: int, n: int):
    """t <- (I ⊗ u_q ⊗ I) t for batched ``[B, d, d]`` t, per-basis u
    ``[B, 2, 2]``."""
    b, d, _ = t.shape
    hi, lo = 2 ** (n - 1 - q), 2**q
    out = torch.einsum("bxy,bhyld->bhxld", u, t.reshape(b, hi, 2, lo, d))
    return out.reshape(b, d, d)


def _apply_right_dag(t: torch.Tensor, u: torch.Tensor, q: int, n: int):
    """t <- t (I ⊗ u_q ⊗ I)†: new[.., x] = Σ_y t[.., y] conj(u[x, y])."""
    b, d, _ = t.shape
    hi, lo = 2 ** (n - 1 - q), 2**q
    out = torch.einsum("bxy,bdhyl->bdhxl", u.conj(),
                       t.reshape(b, d, hi, 2, lo))
    return out.reshape(b, d, d)


def _rotate(t: torch.Tensor, f: torch.Tensor, n: int) -> torch.Tensor:
    """U t U† for U = ⊗_q f[:, q], by 2N per-qubit contractions."""
    for q in range(n):
        t = _apply_left(t, f[:, q], q, n)
    for q in range(n):
        t = _apply_right_dag(t, f[:, q], q, n)
    return t


def _confuse_probs(p: torch.Tensor, m2: torch.Tensor, n: int) -> torch.Tensor:
    """Apply the tensor-product confusion matrix to ``[B, d]`` rows, one 2x2
    factor per qubit (the ``[d, d]`` kron is never built)."""
    b, d = p.shape
    for q in range(n):
        hi, lo = 2 ** (n - 1 - q), 2**q
        p = torch.einsum("xy,bhyl->bhxl", m2, p.reshape(b, hi, 2, lo))
        p = p.reshape(b, d)
    return p


def _kron_block(f: torch.Tensor) -> torch.Tensor:
    """Dense rotations of one block: per-qubit factors ``[blk, N, 2, 2]`` ->
    U = u_{N-1} ⊗ ... ⊗ u_0, ``[blk, d, d]`` (qubit 0 = LSB)."""
    b, n = f.shape[:2]
    t = f[:, 0]
    for q in range(1, n):
        s = t.shape[1]
        # (A ⊗ B)[i·s + k, j·s + l] = A[i, j] · B[k, l]
        t = torch.einsum("bij,bkl->bikjl", f[:, q], t).reshape(b, 2 * s, 2 * s)
    return t


def _block_born_probs(f: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """diag(U ρ U†) ``[blk, d]`` for the block with factors ``f``:
    Σ_k (Uρ)_ik conj(U)_ik, whose imaginary part vanishes."""
    k = _kron_block(f)
    return ((k @ rho) * k.conj()).sum(-1).real


def _auto_iters_per_call(num_qubits: int, num_rows: int, iterations: int) -> int:
    """The JAX package's iterations per device dispatch (its work scales as
    B·N·d², so the cap shrinks with system size). Kept for parity; here it
    only spaces the host's reads of the convergence flag."""
    d = 2**num_qubits
    cost = max(1, num_rows * num_qubits * d * d)
    return max(50, min(iterations, (1 << 31) // cost))


# With iters_per_call on auto, the host reads the convergence flag at least
# this often: a solve that converges early does not run out its budget.
_FLAG_EVERY = 64

# Elements of the per-iteration [B, d, d] working set above which the
# factored MLE blocks its basis dimension (the JAX package's threshold,
# kept for parity and for the tests that lower it; not an H100 limit).
_FACTORED_BLOCK_ELEMS = 1 << 26


def _run(body: Callable, dev: torch.device, d: int, iterations: int,
         tol: float, iters_per_call: int, info: dict | None) -> torch.Tensor:
    """Drive the diluted RρR map from the maximally mixed state.

    ``body(rho) -> G`` builds the dilution operator; the update, its
    safeguards and the stop are shared by the three implementations.
    """
    rho = torch.eye(d, dtype=torch.complex64, device=dev) / d
    done = torch.zeros((), dtype=torch.bool, device=dev)
    count = torch.zeros((), dtype=torch.int32, device=dev)
    i = 0
    while i < iterations:
        chunk = min(iters_per_call, iterations - i)
        for _ in range(chunk):
            g = body(rho)
            new = g @ rho @ g
            tr = torch.diagonal(new).real.sum()
            ok = (tr > 1e-20) & torch.isfinite(tr)
            new = new * torch.where(ok, 1.0 / torch.where(ok, tr, 1.0), 0.0)
            # If the update degenerated, keep the previous iterate.
            keep = ok & torch.isfinite(torch.view_as_real(new)).all()
            nxt = torch.where(keep, new, rho)
            delta = torch.linalg.matrix_norm(nxt - rho)
            rho = torch.where(done, rho, nxt)
            count += ~done
            done = done | (delta <= tol)
        i += chunk
        if bool(done):  # the one synchronisation per chunk
            break
    if info is not None:
        info["iterations"] = int(count)
    return rho


def make_mle(
    num_qubits: int,
    basis_labels: np.ndarray | None = None,
    readout_p: float = 0.0,
    iterations: int = 4000,
    epsilon: float = 0.25,
    tol: float = 3e-7,
    impl: str = "auto",
    iters_per_call: int = 0,
):
    """Build an MLE reconstructor for a fixed basis set.

    Uses the *diluted* RρR iteration (Řeháček et al.): ρ ← G ρ G / tr(·)
    with G = (1-ε) I + ε R̃, R̃ = R / num_bases, so that tr(R̃ρ) = 1
    identically. The plain RρR map can oscillate on rank-deficient
    empirical data; the diluted map converges monotonically for ε < 1.

    ``iterations`` is a cap: the loop stops once the Frobenius norm of the
    ρ update falls to ``tol`` or below (float32 updates quantise to zero at
    convergence, so it always halts).

    Returns ``reconstruct(counts [B, 2^N], info=None) -> ρ [d, d]``
    complex64 on the counts' device. ``counts`` may be raw counts or
    frequencies (normalised per basis); ``info``, if given, receives
    ``'iterations'``, the count of updates applied.

    ``impl`` selects how the POVM contractions run:

    - ``'dense'``: the ``[B·d, d, d]`` POVM stack. Fine to N≈4.
    - ``'factored'``: never builds Π. tr(ρ Π_{b,i}) = diag(U_b ρ U_b†)_i and
      Σ_i w_i Π_{b,i} = U_b† diag(w) U_b, both by 2N batched per-qubit 2x2
      contractions; the readout confusion matrix (also a tensor product)
      folds in as p ↦ M p and w ↦ Mᵀ w per basis. Above
      ``_FACTORED_BLOCK_ELEMS`` elements of ``[B, d, d]`` the basis
      dimension is blocked and each block's rotations are built densely.
    - ``'auto'``: 'factored' for num_qubits ≥ 5, else 'dense'.

    ``iters_per_call``: iterations between two host reads of the
    convergence flag (0 = auto: the JAX package's dispatch bound, at most
    ``_FLAG_EVERY``).
    """
    if basis_labels is None:
        basis_labels = all_basis_labels(num_qubits)
    basis_labels = np.asarray(basis_labels)
    if impl == "auto":
        impl = "factored" if num_qubits >= 5 else "dense"
    if impl not in ("dense", "factored"):
        raise ValueError(f"unknown impl {impl!r}")
    n = num_qubits
    d = 2**n
    num_rows = basis_labels.shape[0]
    if iters_per_call <= 0:
        iters_per_call = min(_auto_iters_per_call(n, num_rows, iterations),
                             _FLAG_EVERY)
    scale = epsilon / num_rows
    m2_np = np.array([[1.0 - readout_p, readout_p],
                      [readout_p, 1.0 - readout_p]], np.float32)

    if impl == "dense":
        povm_np = _povm_elements(n, basis_labels, readout_p)

        def make_body(f, dev):
            povm = torch.from_numpy(povm_np).to(dev).reshape(num_rows * d,
                                                             d * d)
            povm_ri = torch.view_as_real(povm).reshape(num_rows * d, -1)
            eye = torch.eye(d, dtype=torch.complex64, device=dev)
            f = f.reshape(-1)  # [B*d], sums to B

            def body(rho):
                # tr(ρ Π_k) = Σ re·re + im·im: real for Hermitian operands.
                p = povm_ri @ torch.view_as_real(rho).reshape(-1)
                w = (f / p.clamp_min(1e-8)) * scale
                return (1.0 - epsilon) * eye + (
                    w.to(torch.complex64) @ povm).reshape(d, d)

            return body
    else:
        u_np = _rot1(basis_labels)  # [B, N, 2, 2]
        blocked = num_rows * d * d > _FACTORED_BLOCK_ELEMS
        blk = max(1, _FACTORED_BLOCK_ELEMS // (d * d))

        def make_body(f, dev):
            u = torch.from_numpy(u_np).to(dev)
            ud = u.mH  # u† factors, for U† D U
            m2 = torch.from_numpy(m2_np).to(dev)
            eye = torch.eye(d, dtype=torch.complex64, device=dev)

            def weights(p):
                if readout_p > 0:
                    p = _confuse_probs(p, m2, n)
                w = (f / p.clamp_min(1e-8)) * scale
                if readout_p > 0:
                    # Σ_i w_i Π'_{b,i} = Σ_j (Mᵀw)_j Π_{b,j}
                    w = _confuse_probs(w, m2.T, n)
                return w

            def body(rho):
                # p[b, i] = diag(U_b ρ U_b†)_i = tr(ρ Π_{b,i})
                s = _rotate(rho.expand(num_rows, d, d), u, n)
                w = weights(torch.diagonal(s, dim1=-2, dim2=-1).real)
                # Σ_b U_b† diag(w_b) U_b
                r = _rotate(torch.diag_embed(w.to(torch.complex64)), ud, n)
                return (1.0 - epsilon) * eye + r.sum(dim=0)

            def body_blocked(rho):
                # One [blk, d, d] block live at a time (its dense rotations
                # are built twice an iteration, from the 2x2 factors); both
                # contractions are then matmuls.
                starts = range(0, num_rows, blk)
                p = torch.cat([_block_born_probs(u[lo:lo + blk], rho)
                               for lo in starts])
                w = weights(p)
                r = torch.zeros((d, d), dtype=torch.complex64, device=dev)
                for lo in starts:
                    # Σ_{b,j} w_bj conj(U_b)_j,: ⊗ (U_b)_j,: as one
                    # [d, blk·d] x [blk·d, d] product over flattened rows.
                    rows = _kron_block(u[lo:lo + blk]).reshape(-1, d)
                    wv = w[lo:lo + blk].reshape(-1, 1)
                    r = r + rows.mH @ (wv * rows)
                return (1.0 - epsilon) * eye + r

            return body_blocked if blocked else body

    def reconstruct(counts: torch.Tensor, info: dict | None = None):
        counts = torch.as_tensor(counts, dtype=torch.float32)
        f = counts / counts.sum(dim=-1, keepdim=True).clamp_min(1.0)
        return _run(make_body(f, f.device), f.device, d, iterations, tol,
                    iters_per_call, info)

    return reconstruct


def factored_born_probs(rho: torch.Tensor,
                        basis_labels: np.ndarray) -> torch.Tensor:
    """Born probabilities ``diag(U_b ρ U_b†)`` as ``[B, d]`` rows.

    The math of ``qsim.measure.batched_probs_mixed``, over row blocks of at
    most ``_FACTORED_BLOCK_ELEMS`` elements whose rotations are built from
    the per-qubit factors: the full ``[B, d, d]`` rotation stack and the
    ``U ρ`` product are never held at once. For the MLE-projected
    distillation target at large N.
    """
    labels = np.asarray(basis_labels)
    b, n = labels.shape
    d = 2**n
    blk = max(1, min(b, _FACTORED_BLOCK_ELEMS // (d * d)))
    u = torch.from_numpy(_rot1(labels)).to(rho.device)
    rho = rho.to(torch.complex64)
    p = torch.cat([_block_born_probs(u[lo:lo + blk], rho)
                   for lo in range(0, b, blk)]).clamp_min(0.0)
    return p / p.sum(dim=-1, keepdim=True)
