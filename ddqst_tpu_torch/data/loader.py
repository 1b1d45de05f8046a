"""Dataset → training-array loaders.

The port's counterpart of ``ddqst_tpu/data/loader.py``. Counts are dense
``[B, 2^N]`` arrays, so the loaders work from sufficient statistics:

- ``mode="unroll"`` — exact multiset expansion (reference-parity epoch
  semantics), vectorised with ``np.repeat``; rows with zero counts are
  skipped.
- ``mode="sampled"`` — ``num_samples`` draws from the pooled counts
  distribution with replacement, from ``np.random.default_rng(seed)`` as in
  the JAX package, so one seed gives the same arrays in both packages.

The arrays come back as CPU tensors: bits ``[M, N]`` int8, basis_idx
``[M]`` int32 (canonical global index), basis_labels ``[M, N]`` int8 and
circuit_idx ``[M]`` int32 (the position of the originating record, the
circuit id of circuit-conditioned training).
"""

from __future__ import annotations

import numpy as np
import torch

from ddqst_tpu_torch.data.records import CircuitRecord


def _labels_to_idx(labels: np.ndarray) -> np.ndarray:
    """Per-qubit labels ``[..., N]`` -> canonical basis index (qubit 0 is
    the most significant base-3 digit, the ``product('XYZ')`` order)."""
    n = labels.shape[-1]
    powers = 3 ** np.arange(n - 1, -1, -1, dtype=np.int64)
    return (labels.astype(np.int64) * powers).sum(-1).astype(np.int32)


def counts_to_bits_exact(counts: np.ndarray, num_qubits: int) -> np.ndarray:
    """``[d]`` counts -> exact multiset of bit rows ``[sum(counts), N]``."""
    idx = np.repeat(np.arange(len(counts)), counts)
    return ((idx[:, None] >> np.arange(num_qubits)) & 1).astype(np.int8)


def dataset_to_training_arrays(
    records: list[CircuitRecord],
    mode: str = "unroll",
    num_samples: int = 0,
    seed: int = 0,
) -> dict[str, torch.Tensor]:
    """Flatten circuit records into training arrays (see the module
    docstring). ``mode="sampled"`` requires ``num_samples`` (> 0)."""
    if not records:
        raise ValueError("empty dataset")
    n = records[0].num_qubits
    all_counts = np.concatenate([r.counts for r in records])  # [R*B, d]
    all_labels = np.concatenate([r.basis_labels for r in records])
    if mode == "unroll":
        totals = all_counts.sum(axis=1).astype(np.int64)
        keep = np.nonzero(totals)[0]
        bits = np.concatenate(
            [counts_to_bits_exact(all_counts[i], n) for i in keep]
        )
        row_of = np.repeat(keep, totals[keep])
    elif mode == "sampled":
        if num_samples <= 0:
            raise ValueError("mode='sampled' needs num_samples > 0")
        rng = np.random.default_rng(seed)
        flat = all_counts.reshape(-1).astype(np.float64)
        draw = rng.choice(len(flat), size=num_samples, p=flat / flat.sum())
        row_of, outcome = np.divmod(draw, all_counts.shape[1])
        bits = ((outcome[:, None] >> np.arange(n)) & 1).astype(np.int8)
    else:
        raise ValueError(f"unknown loader mode {mode!r}")
    labels = all_labels[row_of].astype(np.int8)
    rows_per_record = np.array([r.counts.shape[0] for r in records])
    row_to_circuit = np.repeat(np.arange(len(records)), rows_per_record)
    return {
        "bits": torch.from_numpy(bits),
        "basis_idx": torch.from_numpy(_labels_to_idx(labels)),
        "basis_labels": torch.from_numpy(labels),
        "circuit_idx": torch.from_numpy(
            row_to_circuit[row_of].astype(np.int32)
        ),
    }


def shuffle_arrays(generator: torch.Generator, arrays: dict) -> dict:
    """One permutation from ``generator`` applied to every array (all on the
    generator's device)."""
    m = arrays["bits"].shape[0]
    perm = torch.randperm(m, generator=generator, device=generator.device)
    return {k: v[perm] for k, v in arrays.items()}
