"""Dataset record schema: npz shards of circuits with their measurement data.

The port's copy of ``ddqst_tpu/data/records.py``, in the same npz schema, so
each package reads the other's shards:

  ids [C] int64 · hashes [C] str · depths [C] int32 ·
  states [C, 2^N] complex64 (clean statevector ground truth) ·
  basis_labels [C, B, N] int8 (0=X,1=Y,2=Z) · counts [C, B, 2^N] int32

Shards are ``part_K.npz`` files; loading a directory skips corrupt shards
with a warning. :func:`convert_reference_pt` reads the reference's torch-
pickled ``.pt`` parts without qiskit installed, by registering stand-ins for
the three pickled qiskit types.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import sys
import types

import numpy as np

BASIS_CHARS = "XYZ"


def basis_str_to_label(s: str) -> np.ndarray:
    """``'XZY'`` -> ``[0, 2, 1]`` int32 (character q = qubit q)."""
    return np.array([BASIS_CHARS.index(c) for c in s], dtype=np.int32)


@dataclasses.dataclass
class CircuitRecord:
    """One random circuit with its ground truth and measurement data."""

    id: int
    hash: str
    depth: int
    clean_state: np.ndarray  # [2^N] complex64
    basis_labels: np.ndarray  # [B, N] int8
    counts: np.ndarray  # [B, 2^N] int32

    @property
    def num_qubits(self) -> int:
        return self.basis_labels.shape[-1]


def save_shard(path: str, records: list[CircuitRecord]) -> None:
    """Save records (uniform basis count per record) as one npz shard."""
    if not records:
        raise ValueError("empty shard")
    np.savez_compressed(
        path,
        ids=np.array([r.id for r in records], np.int64),
        hashes=np.array([r.hash for r in records]),
        depths=np.array([r.depth for r in records], np.int32),
        states=np.stack([r.clean_state for r in records]).astype(np.complex64),
        basis_labels=np.stack([r.basis_labels for r in records]).astype(np.int8),
        counts=np.stack([r.counts for r in records]).astype(np.int32),
    )


def load_shard(path: str) -> list[CircuitRecord]:
    """The records of one shard. Each array is read (and decompressed) once;
    a record's arrays are rows of the shard's."""
    with np.load(path, allow_pickle=False) as z:
        ids, hashes, depths, states, labels, counts = (
            z[k] for k in ("ids", "hashes", "depths", "states",
                           "basis_labels", "counts"))
    return [
        CircuitRecord(
            id=int(ids[i]),
            hash=str(hashes[i]),
            depth=int(depths[i]),
            clean_state=states[i],
            basis_labels=labels[i],
            counts=counts[i],
        )
        for i in range(len(ids))
    ]


def load_dataset(path: str) -> list[CircuitRecord]:
    """Load a shard file or a directory of ``*.npz`` shards (sorted by
    name); corrupt shards are skipped with a warning."""
    if os.path.isfile(path):
        return load_shard(path)
    records: list[CircuitRecord] = []
    files = sorted(glob.glob(os.path.join(path, "*.npz")))
    if not files:
        raise FileNotFoundError(f"no .npz shards under {path}")
    for f in files:
        try:
            records.extend(load_shard(f))
        except Exception as e:  # corrupt-file skip
            print(f"skipping corrupt shard {f}: {e}", file=sys.stderr)
    return records


# --- Reference .pt reader (qiskit-free unpickling) --------------------------


def _install_qiskit_stubs() -> None:
    """Register minimal stand-ins for the qiskit classes in the pickles:
    Statevector, OpShape and Counts."""

    class _StubStatevector:
        def __setstate__(self, state):
            self.__dict__.update(state if isinstance(state, dict) else {})

    class _StubOpShape:
        def __setstate__(self, state):
            self.__dict__.update(state if isinstance(state, dict) else {})

    class _StubCounts(dict):
        pass

    mods = {
        "qiskit": {},
        "qiskit.quantum_info": {},
        "qiskit.quantum_info.states": {},
        "qiskit.quantum_info.states.statevector": {
            "Statevector": _StubStatevector
        },
        "qiskit.quantum_info.operators": {},
        "qiskit.quantum_info.operators.op_shape": {"OpShape": _StubOpShape},
        "qiskit.result": {},
        "qiskit.result.counts": {"Counts": _StubCounts},
    }
    for name, attrs in mods.items():
        if name not in sys.modules:
            mod = types.ModuleType(name)
            for k, v in attrs.items():
                setattr(mod, k, v)
            sys.modules[name] = mod
        else:
            for k, v in attrs.items():
                if not hasattr(sys.modules[name], k):
                    setattr(sys.modules[name], k, v)


def read_reference_pt(path: str) -> list[dict]:
    """Load one reference ``.pt`` part without qiskit installed."""
    import torch

    _install_qiskit_stubs()
    return torch.load(path, map_location="cpu", weights_only=False)


def convert_reference_pt(src: str, out_dir: str) -> list[str]:
    """Convert reference ``.pt`` part file(s) to npz shards. Returns paths.

    Statevector amplitudes come from the stub's ``_data`` attribute; counts
    dicts are re-keyed from qiskit's little-endian bitstrings into outcome
    indices (the string's last character is qubit 0, so ``int(bitstr, 2)``
    is already the index).
    """
    files = (
        [src] if os.path.isfile(src)
        else sorted(glob.glob(os.path.join(src, "*.pt")))
    )
    os.makedirs(out_dir, exist_ok=True)
    out_paths = []
    for f in files:
        records = []
        for entry in read_reference_pt(f):
            sv = entry["clean_state_vec"]
            amps = np.asarray(getattr(sv, "_data", sv), dtype=np.complex64)
            d = len(amps)
            labels, counts = [], []
            for m in entry["measurements"]:
                labels.append(basis_str_to_label(m["basis"]))
                row = np.zeros(d, np.int32)
                for bitstr, c in m["counts"].items():
                    row[int(bitstr.replace(" ", ""), 2)] += int(c)
                counts.append(row)
            records.append(
                CircuitRecord(
                    id=int(entry.get("id", len(records))),
                    hash=str(entry.get("hash", "")),
                    depth=int(entry.get("depth", 0)),
                    clean_state=amps,
                    basis_labels=np.stack(labels).astype(np.int8),
                    counts=np.stack(counts),
                )
            )
        stem = os.path.splitext(os.path.basename(f))[0]
        out = os.path.join(out_dir, f"{stem}.npz")
        save_shard(out, records)
        out_paths.append(out)
    return out_paths
