"""ctypes binding for the C++ statevector engine (host code).

The port's counterpart of ``ddqst_tpu/qsim/native_engine.py``. The source
``csrc/statevec.cc`` is built with ``g++ -O3 -shared -fPIC`` at first use by
:mod:`ddqst_tpu_torch.ops._build`, into ``ddqst_tpu_torch/_build/`` under a
name that hashes the source and the flags. A failed build raises
``RuntimeError`` with the compiler's output; nothing here falls back to the
numpy path (``states.batch_statevectors(prefer_native=False)``), whose
results agree within 2e-6.

The engine evolves each circuit's statevector from |0...0> through its gate
chain, one circuit after another, on the host; the dataset builder then
rotates and samples every (circuit, basis) pair batched on the device.
"""

from __future__ import annotations

import ctypes
from typing import TYPE_CHECKING

import numpy as np

from ddqst_tpu_torch.ops import _build
from ddqst_tpu_torch.qsim import gates as G

if TYPE_CHECKING:
    from ddqst_tpu_torch.qsim.states import Circuit


def _load() -> ctypes.CDLL:
    """Build (if needed) and load the engine; raises ``RuntimeError`` with
    the compiler's output when it cannot be built."""
    lib = _build.load("statevec")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
    lib.evolve_batch_from_zero.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, i32p, i32p, i32p, i32p, f32p, i64p,
    ]
    lib.evolve_batch_from_zero.restype = None
    return lib


def available() -> bool:
    """Whether the engine builds and loads here."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def _pack_program(circuits: list[Circuit]):
    """Flatten circuits into the engine's program arrays: arities ``ks``,
    two qubit slots a gate (the second unused for 1-qubit gates), the
    concatenated little-endian matrices as interleaved float32, each
    matrix's float offset, and each circuit's first gate and gate count."""
    ks, qubits, mats, offsets, starts, counts = [], [], [], [], [], []
    cursor = 0
    mat_cursor = 0
    for qc in circuits:
        starts.append(cursor)
        counts.append(len(qc.gates))
        for g in qc.gates:
            m = G.gate_matrix(g.name, g.params)
            k = len(g.qubits)
            ks.append(k)
            qubits.extend([g.qubits[0], g.qubits[1] if k == 2 else 0])
            flat = np.ascontiguousarray(m, dtype=np.complex64).view(
                np.float32
            ).ravel()
            mats.append(flat)
            offsets.append(mat_cursor)
            mat_cursor += flat.size
            cursor += 1
    return (
        np.asarray(ks, np.int32),
        np.asarray(qubits, np.int32),
        np.concatenate(mats).astype(np.float32) if mats else np.zeros(0, np.float32),
        np.asarray(offsets, np.int64),
        np.asarray(starts, np.int32),
        np.asarray(counts, np.int32),
    )


def statevectors(circuits: list[Circuit]) -> np.ndarray:
    """Exact statevectors ``[C, 2^N]`` complex64 via the engine (``(0, 0)``
    for an empty list).

    Every circuit must have the same qubit count, and every gate one or two
    distinct qubits below it: the engine indexes amplitudes unchecked.
    """
    lib = _load()
    if not circuits:
        return np.zeros((0, 0), np.complex64)
    n = circuits[0].num_qubits
    if any(qc.num_qubits != n for qc in circuits):
        raise ValueError(f"circuits of other sizes than {n} qubits in a batch")
    ks, qubits, mats, offsets, starts, counts = _pack_program(circuits)
    q = qubits.reshape(-1, 2)
    two = ks == 2
    ok = ((ks == 1) | two) & (q[:, 0] >= 0) & (q[:, 0] < n) & ~(
        two & ((q[:, 1] < 0) | (q[:, 1] >= n) | (q[:, 1] == q[:, 0])))
    if not ok.all():
        bad = int(np.argmin(ok))
        raise ValueError(f"gate {bad} of the batch acts on qubits "
                         f"{q[bad].tolist()} (arity {ks[bad]}) of {n}")
    out = np.zeros((len(circuits), 2 * (1 << n)), np.float32)
    lib.evolve_batch_from_zero(
        out, n, len(circuits), starts, counts, ks, qubits, mats, offsets
    )
    return out.view(np.complex64).reshape(len(circuits), 1 << n)
