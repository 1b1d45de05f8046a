"""Circuits, statevectors and random-circuit generation (host-side numpy).

The port's copy of ``ddqst_tpu/qsim/states.py`` (state preparation for
plus / bell / ghz / w / rqc, the dataset builders' circuit hash, batched
statevectors through the C++ engine or numpy, the full circuit unitary and
the named states' vectors). Circuit construction is tiny scalar work and stays on the
host; ``prep_circuit`` draws from the caller's ``np.random.Generator``
exactly as the JAX package does, so one seed gives the same circuit and
target in both packages.

Tensor convention: a statevector of N qubits reshapes to ``[2]*N`` with axis
``N-1-q`` holding qubit q (qubit 0 = least-significant bit of the flat
index).
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from ddqst_tpu_torch.qsim import gates as G
from ddqst_tpu_torch.qsim import native_engine


@dataclasses.dataclass(frozen=True)
class Gate:
    name: str
    qubits: tuple[int, ...]
    params: tuple[float, ...] = ()


@dataclasses.dataclass(frozen=True)
class Circuit:
    num_qubits: int
    gates: tuple[Gate, ...]
    depth: int = 0  # nominal layer depth (for RQC metadata)


def circuit_hash(circuit: Circuit) -> str:
    """MD5 of a canonical serialisation (params rounded to 10 decimals): the
    dataset builders' dedup key, the same string as the JAX package's."""
    parts = [str(circuit.num_qubits)]
    for g in circuit.gates:
        parts.append(
            f"{g.name}:{','.join(map(str, g.qubits))}:"
            + ",".join(f"{p:.10f}" for p in g.params)
        )
    return hashlib.md5("|".join(parts).encode()).hexdigest()


def apply_gate_to(mat: np.ndarray, gate: np.ndarray, qubits, n: int) -> np.ndarray:
    """Apply a k-qubit gate to ``mat`` ([d] statevector or [d, m] columns).

    ``qubits`` is the ordered list the gate's little-endian matrix refers to
    (first listed qubit = low bit of the gate's index).
    """
    k = len(qubits)
    cols = mat.shape[1:] if mat.ndim > 1 else ()
    t = mat.reshape([2] * n + ([int(np.prod(cols))] if cols else []))
    gt = gate.reshape([2] * (2 * k))
    # Gate tensor axes: out_{k-1}..out_0, in_{k-1}..in_0. Input axis for the
    # qubit at list position j is k + (k-1-j); it contracts with state axis
    # n-1-qubits[j].
    in_axes = [k + (k - 1 - j) for j in range(k)]
    st_axes = [n - 1 - q for q in qubits]
    res = np.tensordot(gt, t, axes=(in_axes, st_axes))
    # Result axes: out_{k-1}..out_0 then the untouched state axes in order.
    # Move out axis for list position j (at position k-1-j) to n-1-qubits[j].
    src = [k - 1 - j for j in range(k)]
    dst = [n - 1 - q for q in qubits]
    res = np.moveaxis(res, src, dst)
    return res.reshape(mat.shape)


def circuit_statevector(circuit: Circuit) -> np.ndarray:
    """Exact statevector |ψ⟩ = U|0...0⟩ (complex64, shape [2^N])."""
    n = circuit.num_qubits
    psi = np.zeros(2**n, dtype=np.complex64)
    psi[0] = 1.0
    for g in circuit.gates:
        psi = apply_gate_to(psi, G.gate_matrix(g.name, g.params), g.qubits, n)
    return psi


def circuit_unitary(circuit: Circuit) -> np.ndarray:
    """Full circuit unitary (complex64, shape [2^N, 2^N])."""
    n = circuit.num_qubits
    u = np.eye(2**n, dtype=np.complex64)
    for g in circuit.gates:
        u = apply_gate_to(u, G.gate_matrix(g.name, g.params), g.qubits, n)
    return u


def batch_statevectors(
    circuits: list[Circuit], prefer_native: bool = True
) -> np.ndarray:
    """Exact statevectors ``[C, 2^N]`` complex64 for a batch of circuits
    (``(0, 0)`` for an empty list).

    ``prefer_native=True`` runs the C++ engine
    (:mod:`ddqst_tpu_torch.qsim.native_engine`), built with g++ at first
    use; ``False`` runs the numpy path (:func:`circuit_statevector`). The two
    agree within 2e-6. Unlike the JAX package, which returns the numpy
    path's result when the engine cannot be built, a failed build raises
    ``RuntimeError`` here, so a result always comes from the path asked for.
    """
    if prefer_native:
        return native_engine.statevectors(circuits)
    if not circuits:
        return np.zeros((0, 0), np.complex64)
    return np.stack([circuit_statevector(c) for c in circuits])


def prep_circuit(state_type: str, num_qubits: int, depth: int = 4,
                 rng: np.random.Generator | None = None) -> Circuit:
    """State-preparation circuit for plus / bell / ghz / w / rqc."""
    if state_type == "plus":
        return Circuit(num_qubits, tuple(Gate("h", (q,)) for q in range(num_qubits)))
    if state_type == "bell":
        if num_qubits != 2:
            raise ValueError("bell state requires num_qubits == 2")
        return Circuit(2, (Gate("h", (0,)), Gate("cx", (0, 1))))
    if state_type == "ghz":
        gs = [Gate("h", (0,))] + [
            Gate("cx", (q, q + 1)) for q in range(num_qubits - 1)
        ]
        return Circuit(num_qubits, tuple(gs))
    if state_type == "w":
        # Cascade construction: X on q0, then for each k a controlled-Ry
        # keeping amplitude 1/(n-k) at q_k followed by CX(q_{k+1} -> q_k).
        gs = [Gate("x", (0,))]
        for k in range(num_qubits - 1):
            theta = 2.0 * float(np.arccos(np.sqrt(1.0 / (num_qubits - k))))
            gs.append(Gate("cry", (k, k + 1), (theta,)))
            gs.append(Gate("cx", (k + 1, k)))
        return Circuit(num_qubits, tuple(gs))
    if state_type == "rqc":
        if rng is None:
            rng = np.random.default_rng()
        return random_circuit(rng, num_qubits, depth)
    raise ValueError(f"unknown state_type: {state_type!r}")


def random_circuit(rng: np.random.Generator, num_qubits: int, depth: int) -> Circuit:
    """Layered random circuit over the documented gate set.

    Per layer: random qubit permutation, greedily grouped into 2-qubit and
    1-qubit operations (2-qubit chosen with prob 0.5 when possible), each
    assigned a uniformly random gate from :data:`gates.RANDOM_2Q` /
    :data:`gates.RANDOM_1Q` with uniform [0, 2π) parameters. The draw order
    is the JAX package's, so the same generator state gives the same circuit.
    """
    gs: list[Gate] = []
    for _ in range(depth):
        order = rng.permutation(num_qubits)
        i = 0
        while i < len(order):
            if i + 1 < len(order) and rng.random() < 0.5:
                name, n_par = G.RANDOM_2Q[rng.integers(len(G.RANDOM_2Q))]
                qs = (int(order[i]), int(order[i + 1]))
                i += 2
            else:
                name, n_par = G.RANDOM_1Q[rng.integers(len(G.RANDOM_1Q))]
                qs = (int(order[i]),)
                i += 1
            params = tuple(float(x) for x in rng.uniform(0, 2 * np.pi, n_par))
            gs.append(Gate(name, qs, params))
    return Circuit(num_qubits, tuple(gs), depth=depth)


def plus_state(n: int) -> np.ndarray:
    return np.full(2**n, 1 / np.sqrt(2**n), dtype=np.complex64)


def bell_state() -> np.ndarray:
    psi = np.zeros(4, dtype=np.complex64)
    psi[0] = psi[3] = 1 / np.sqrt(2)
    return psi


def ghz_state(n: int) -> np.ndarray:
    psi = np.zeros(2**n, dtype=np.complex64)
    psi[0] = psi[-1] = 1 / np.sqrt(2)
    return psi


def w_state(n: int) -> np.ndarray:
    """|W_n⟩: equal superposition of single-excitation basis states."""
    psi = np.zeros(2**n, dtype=np.complex64)
    for q in range(n):
        psi[1 << q] = 1 / np.sqrt(n)
    return psi
