"""RQC dataset builders: unique-circuit dedup, shadow capping, chunked shards.

The port's counterpart of ``ddqst_tpu/data/generate.py``:

- **Unique circuit pool** with hash dedup and a safety break at 50x
  attempts.
- **Shadow basis capping**: all 3^N bases when that is <= ``max_bases``,
  else ``max_bases`` random bases per circuit (``build_dataset`` applies 100
  at N >= 5 when ``max_bases=0``).
- **Chunked shards** ``part_K.npz``, resumable: ``seen_hashes.txt`` keeps
  the dedup set across runs and generation continues from the next part.

Circuits, hashes, depths, basis plans and clean states come from
``np.random.default_rng(seed)``, drawn in the JAX package's order (the
circuits, then the basis plan), so they equal the JAX package's. Where
each part runs:

- on the host, in C++ (``qsim.native_engine``, through
  ``states.batch_statevectors``): the statevectors, one engine call a chunk
  for the records' clean states, and one more for the counts when the noise
  has no gate part;
- on the host, in numpy: the density matrices under gate noise
  (``noise.simulate_density_matrix``, one circuit at a time);
- on the working device, one batch a chunk: the rotation of every state
  into every basis, the readout channel and Born sampling. The counts draw
  from a ``torch.Generator`` derived from ``(seed, part)``, so they match
  the JAX package in distribution, not bit for bit.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch

from ddqst_tpu_torch.data.records import CircuitRecord, save_shard
from ddqst_tpu_torch.device import resolve_device
from ddqst_tpu_torch.ops.pauli import all_basis_labels
from ddqst_tpu_torch.qsim import measure, noise, states


def _unique_circuits(
    rng: np.random.Generator,
    count: int,
    num_qubits: int,
    min_depth: int,
    max_depth: int,
    seen_hashes: set[str],
) -> list[tuple[states.Circuit, str]]:
    """Draw ``count`` circuits with unseen hashes (safety break at 50x)."""
    out: list[tuple[states.Circuit, str]] = []
    attempts = 0
    while len(out) < count:
        attempts += 1
        depth = int(rng.integers(min_depth, max_depth + 1))
        qc = states.random_circuit(rng, num_qubits, depth)
        h = states.circuit_hash(qc)
        if h not in seen_hashes:
            seen_hashes.add(h)
            out.append((qc, h))
        if attempts > max(count, 1) * 50:
            raise RuntimeError(
                f"could not find {count} unique circuits in {attempts} "
                "attempts; increase depth or qubit count"
            )
    return out


def _basis_plan(
    rng: np.random.Generator, num_qubits: int, num_circuits: int,
    max_bases: int,
) -> np.ndarray:
    """``[C, B, N]`` basis labels: full set or per-circuit random shadows."""
    full = all_basis_labels(num_qubits)
    if max_bases <= 0 or len(full) <= max_bases:
        return np.broadcast_to(full, (num_circuits,) + full.shape).copy()
    return rng.integers(
        0, 3, size=(num_circuits, max_bases, num_qubits)
    ).astype(np.int32)


def _part_generator(seed: int, part: int, device) -> torch.Generator:
    """The counts generator of one part, derived from ``(seed, part)``."""
    ss = np.random.SeedSequence([seed, part])
    return torch.Generator(device=device).manual_seed(
        int(ss.generate_state(1, np.uint64)[0])
    )


def _simulate_chunk(
    generator: torch.Generator,
    circuits: list[states.Circuit],
    basis_labels: np.ndarray,  # [C, B, N]
    shots: int,
    ncfg: noise.NoiseConfig,
) -> np.ndarray:
    """Counts ``[C, B, 2^N]`` for every circuit x basis, one device pass on
    the generator's device: the mixed path under gate noise, the pure path
    otherwise, then the readout channel."""
    dev = generator.device
    c, b, n = basis_labels.shape
    rots = torch.from_numpy(
        measure.rotation_unitaries(basis_labels.reshape(c * b, n))
    ).reshape(c, b, 2**n, 2**n).to(dev)
    if ncfg.has_gate_noise:
        rhos = np.stack(
            [noise.simulate_density_matrix(qc, ncfg) for qc in circuits]
        )
        probs = measure.batched_probs_mixed_per_circuit(
            torch.from_numpy(rhos).to(dev), rots
        )
    else:
        psis = states.batch_statevectors(circuits)
        probs = measure.batched_probs_pure_per_circuit(
            torch.from_numpy(psis).to(dev), rots
        )
    probs = noise.apply_readout_to_probs(probs, n, ncfg.readout_p)
    return measure.sample_counts(generator, probs, shots).cpu().numpy()


def _records(first_id, pool, basis_labels, counts) -> list[CircuitRecord]:
    clean = states.batch_statevectors([qc for qc, _ in pool])
    return [
        CircuitRecord(
            id=first_id + i,
            hash=h,
            depth=qc.depth,
            clean_state=clean[i],
            basis_labels=basis_labels[i].astype(np.int8),
            counts=counts[i],
        )
        for i, (qc, h) in enumerate(pool)
    ]


def build_dataset(
    seed: int,
    num_samples: int,
    num_qubits: int,
    min_depth: int = 2,
    max_depth: int = 10,
    shots: int = 1024,
    noise_type: str = "torino",
    max_bases: int = 0,
    device: str | torch.device | None = None,
) -> list[CircuitRecord]:
    """Strict unique dataset in memory (reference ``generate_strict_dataset``).

    ``max_bases=0`` applies the reference's rule: full 3^N below 5 qubits,
    100 random bases at N >= 5. Shots are drawn on ``device`` (default
    CUDA; raises if CUDA is absent and ``device`` was not given).
    """
    dev = resolve_device(device)
    if max_bases == 0 and num_qubits >= 5:
        max_bases = 100
    rng = np.random.default_rng(seed)
    ncfg = noise.get_noise_config(noise_type)
    pool = _unique_circuits(
        rng, num_samples, num_qubits, min_depth, max_depth, set()
    )
    basis_labels = _basis_plan(rng, num_qubits, num_samples, max_bases)
    counts = _simulate_chunk(
        _part_generator(seed, 0, dev), [qc for qc, _ in pool], basis_labels,
        shots, ncfg,
    )
    return _records(0, pool, basis_labels, counts)


def build_dataset_chunked(
    seed: int,
    num_samples: int,
    num_qubits: int,
    out_dir: str,
    chunk_size: int = 500,
    min_depth: int = 2,
    max_depth: int = 10,
    shots: int = 1024,
    noise_type: str = "torino",
    max_bases: int = 50,
    log_fn=print,
    device: str | torch.device | None = None,
) -> list[str]:
    """Chunked builder writing ``part_K.npz`` shards (reference
    ``generate_batched_dataset``). Returns shard paths.

    Resumable: existing shards are kept, their hashes reload into the dedup
    set from ``seen_hashes.txt``, and generation continues from the next
    part index until ``num_samples`` circuits exist. Shots are drawn on
    ``device`` (default CUDA; raises if CUDA is absent and ``device`` was
    not given).
    """
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    seen: set[str] = set()
    hash_file = os.path.join(out_dir, "seen_hashes.txt")
    if os.path.exists(hash_file):
        with open(hash_file) as f:
            seen.update(line.strip() for line in f if line.strip())
    existing = sorted(glob.glob(os.path.join(out_dir, "part_*.npz")))
    total = len(seen)
    part = len(existing)
    paths = list(existing)
    ncfg = noise.get_noise_config(noise_type)
    while total < num_samples:
        take = min(chunk_size, num_samples - total)
        pool = _unique_circuits(
            rng, take, num_qubits, min_depth, max_depth, seen
        )
        basis_labels = _basis_plan(rng, num_qubits, take, max_bases)
        counts = _simulate_chunk(
            _part_generator(seed, part, dev), [qc for qc, _ in pool],
            basis_labels, shots, ncfg,
        )
        path = os.path.join(out_dir, f"part_{part}.npz")
        save_shard(path, _records(total, pool, basis_labels, counts))
        with open(hash_file, "a") as f:
            f.write("".join(h + "\n" for _, h in pool))
        paths.append(path)
        total += take
        part += 1
        log_fn(f"saved {path} ({total}/{num_samples} circuits)")
    return paths
