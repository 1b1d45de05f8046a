"""Gate matrices and the documented random-circuit gate set.

Host-side numpy, a copy of ``ddqst_tpu/qsim/gates.py`` so that seeded
circuits match the JAX package exactly.

The reference delegates gates to Qiskit (``data_gen.py:145-188`` uses h, cx,
sdg and ``qiskit.circuit.random.random_circuit``). We define our own explicit
gate set; exact circuit-*distribution* parity with qiskit's random_circuit is
impossible and not required (state-level fidelity targets govern — see
SURVEY.md §7.2 item 7).

All matrices are little-endian: for 2-qubit gates acting on (q_low, q_high),
the 4x4 matrix indexes basis states as ``i = b_high * 2 + b_low`` where
``b_low`` is the *first* listed qubit.
"""

from __future__ import annotations

import numpy as np

_C = np.complex64
_SQ2 = 1.0 / np.sqrt(2.0)

I = np.eye(2, dtype=_C)
X = np.array([[0, 1], [1, 0]], dtype=_C)
Y = np.array([[0, -1j], [1j, 0]], dtype=_C)
Z = np.array([[1, 0], [0, -1]], dtype=_C)
H = np.array([[_SQ2, _SQ2], [_SQ2, -_SQ2]], dtype=_C)
S = np.array([[1, 0], [0, 1j]], dtype=_C)
SDG = np.array([[1, 0], [0, -1j]], dtype=_C)
T = np.array([[1, 0], [0, np.exp(1j * np.pi / 4)]], dtype=_C)
TDG = np.array([[1, 0], [0, np.exp(-1j * np.pi / 4)]], dtype=_C)
SX = 0.5 * np.array([[1 + 1j, 1 - 1j], [1 - 1j, 1 + 1j]], dtype=_C)


def rx(theta: float) -> np.ndarray:
    c, s = np.cos(theta / 2), np.sin(theta / 2)
    return np.array([[c, -1j * s], [-1j * s, c]], dtype=_C)


def ry(theta: float) -> np.ndarray:
    c, s = np.cos(theta / 2), np.sin(theta / 2)
    return np.array([[c, -s], [s, c]], dtype=_C)


def rz(theta: float) -> np.ndarray:
    return np.array(
        [[np.exp(-1j * theta / 2), 0], [0, np.exp(1j * theta / 2)]], dtype=_C
    )


def u3(theta: float, phi: float, lam: float) -> np.ndarray:
    c, s = np.cos(theta / 2), np.sin(theta / 2)
    return np.array(
        [
            [c, -np.exp(1j * lam) * s],
            [np.exp(1j * phi) * s, np.exp(1j * (phi + lam)) * c],
        ],
        dtype=_C,
    )


# Two-qubit gates on (q_low=first arg=control for cx/cp, q_high=second).
# Basis order |q_high q_low>: index = 2*b_high + b_low.
CX = np.array(  # control = first qubit (low bit), target = second
    [[1, 0, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0], [0, 1, 0, 0]], dtype=_C
)
CZ = np.diag([1, 1, 1, -1]).astype(_C)
SWAP = np.array(
    [[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=_C
)


def cp(theta: float) -> np.ndarray:
    return np.diag([1, 1, 1, np.exp(1j * theta)]).astype(_C)


def cry(theta: float) -> np.ndarray:
    """Controlled-Ry (control = first listed qubit = low bit)."""
    c, s = np.cos(theta / 2), np.sin(theta / 2)
    # Control set <=> low bit 1 <=> indices 1 (target 0) and 3 (target 1).
    m = np.eye(4, dtype=_C)
    m[1, 1], m[1, 3] = c, -s
    m[3, 1], m[3, 3] = s, c
    return m


# The random-circuit gate set: (name, n_qubits, n_params).
RANDOM_1Q = [
    ("x", 0), ("y", 0), ("z", 0), ("h", 0), ("s", 0), ("sdg", 0),
    ("t", 0), ("tdg", 0), ("sx", 0), ("rx", 1), ("ry", 1), ("rz", 1),
    ("u3", 3),
]
RANDOM_2Q = [("cx", 0), ("cz", 0), ("swap", 0), ("cp", 1)]

_FIXED = {
    "i": I, "x": X, "y": Y, "z": Z, "h": H, "s": S, "sdg": SDG,
    "t": T, "tdg": TDG, "sx": SX, "cx": CX, "cz": CZ, "swap": SWAP,
}
_PARAM = {"rx": rx, "ry": ry, "rz": rz, "u3": u3, "cp": cp, "cry": cry}


def gate_matrix(name: str, params: tuple = ()) -> np.ndarray:
    """Gate matrix by name; parametrised gates take ``params``."""
    if name in _FIXED:
        return _FIXED[name]
    return _PARAM[name](*params)
