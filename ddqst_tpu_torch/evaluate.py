"""Evaluation harness: per-circuit raw-vs-D3PM fidelity lift.

The port's counterpart of ``ddqst_tpu/evaluate.py``. For every circuit of
an eval dataset it reconstructs the state (a) from the circuit's raw
measured counts and (b) from model-generated samples, and compares both
with the clean statevector: fidelity, trace distance, von Neumann entropy,
plus the z-bias diagnostic; with ``out_dir`` it writes ``metrics.csv`` and
the two plots.

Two branches, as in the JAX package:

- a circuit-conditioned model (trained by ``pipeline.train_on_dataset``
  with ``condition_on_circuit`` on these records in this order) generates
  per circuit: every (circuit, basis) row gets ``shots_infer`` chains of
  one :func:`~ddqst_tpu_torch.ops.diffusion.p_sample_grid` call, whose T
  steps run the hand-written step kernel on a CUDA device;
- a model conditioned only on (t, basis) generates samples that do not
  depend on the circuit, so they are drawn once with
  :func:`~ddqst_tpu_torch.ops.diffusion.sample_all_bases` (on CUDA, the
  walk kernel from 32·6^N chains up) and inverted once.

``reconstruction`` is ``'linear'`` (``ops.pauli.make_counts_inverter``) or
``'mle'`` (``ops.mle.make_mle``), for the raw counts and the generated
samples alike. A record measured on a subset of the 3^N bases is
reconstructed from those bases (the dense inverter, or the MLE over them).
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np
import torch

from ddqst_tpu_torch.data.records import CircuitRecord
from ddqst_tpu_torch.device import resolve_device
from ddqst_tpu_torch.ops import diffusion as diff
from ddqst_tpu_torch.ops import metrics as M
from ddqst_tpu_torch.ops import mle, pauli
from ddqst_tpu_torch.ops.mle import bits_to_counts
from ddqst_tpu_torch.ops.schedules import DiffusionSchedule
from ddqst_tpu_torch.utils.logging import write_metrics_csv


def _reconstruct_counts(
    num_qubits: int, basis_labels: np.ndarray | None, counts, method: str,
    readout_p: float, device="cpu",
) -> torch.Tensor:
    """ρ from ``counts [B, 2^N]`` measured in ``basis_labels`` (None: the
    canonical 3^N grid), by ``method`` 'linear' or 'mle'."""
    if method not in ("linear", "mle"):
        raise ValueError(f"unknown reconstruction {method!r}")
    make = mle.make_mle if method == "mle" else pauli.make_counts_inverter
    rec = make(num_qubits, basis_labels, readout_p=readout_p)
    if not torch.is_tensor(counts):
        counts = np.asarray(counts, np.float32)
    return rec(torch.as_tensor(counts, dtype=torch.float32, device=device))


def evaluate_dataset(
    generator: torch.Generator,
    records: list[CircuitRecord],
    denoise_fn,
    num_qubits: int,
    schedule: DiffusionSchedule,
    shots_infer: int = 2000,
    exact: bool | None = None,
    reconstruction: str = "linear",
    readout_p: float = 0.0,
    circuit_conditioned: bool = False,
    out_dir: str | None = None,
    log_fn: Callable = print,
    device: str | torch.device | None = None,
    extras: dict | None = None,
) -> list[dict]:
    """Run the raw-vs-D3PM comparison over an eval dataset.

    ``denoise_fn`` (the model), ``schedule`` and ``generator`` live on
    ``device`` (default CUDA; raises if CUDA is absent and ``device`` was
    not given). ``circuit_conditioned=True`` requires a model trained with
    circuit conditioning on these records *in this order*. Returns one dict
    per record: id, depth, raw_fidelity, d3pm_fidelity, raw_trace_distance,
    d3pm_trace_distance, raw_entropy, d3pm_entropy, z_bias (the columns of
    ``metrics.csv``, in that order).

    ``extras``: if given, receives the generated ``samples`` (``[C, 3^N,
    shots, N]`` when circuit-conditioned, else ``[3^N, shots, N]``) and the
    lists ``rho_raw`` and ``rho_d3pm`` of per-record density matrices.
    """
    dev = resolve_device(device)
    num_bases = 3**num_qubits
    if circuit_conditioned:
        c = len(records)
        basis_rows = torch.arange(num_bases, device=dev).repeat_interleave(
            shots_infer).repeat(c)
        circ_rows = torch.arange(c, device=dev).repeat_interleave(
            num_bases * shots_infer)
        packed = torch.stack([basis_rows, circ_rows], dim=-1)
        flat = diff.p_sample_grid(
            generator, denoise_fn, packed, num_qubits, schedule, exact=exact,
            num_circuits=c,
        )
        samples = flat.reshape(c, num_bases, shots_infer, num_qubits)
        zb = float(M.z_bias(samples[0, -1]))
    else:
        samples = diff.sample_all_bases(
            generator, denoise_fn, num_qubits, shots_infer, schedule,
            exact=exact, device=dev,
        )
        zb = float(M.z_bias(samples[-1]))  # canonical last basis = Z...Z

    def gen_rho(bits):
        return _reconstruct_counts(num_qubits, None, bits_to_counts(bits),
                                   reconstruction, readout_p, dev)

    rho_gen = None if circuit_conditioned else gen_rho(samples)
    if extras is not None:
        extras.update(samples=samples, rho_raw=[], rho_d3pm=[])

    out = []
    for i, rec in enumerate(records):
        target = torch.from_numpy(np.asarray(rec.clean_state)).to(dev)
        rho_raw = _reconstruct_counts(
            num_qubits, rec.basis_labels, rec.counts, reconstruction,
            readout_p, dev
        )
        rho_i = gen_rho(samples[i]) if circuit_conditioned else rho_gen
        fid_raw = float(M.state_fidelity(target, rho_raw))
        fid_d3pm = float(M.state_fidelity(target, rho_i))
        s_raw = float(M.von_neumann_entropy(rho_raw))
        s_d3pm = float(M.von_neumann_entropy(rho_i))
        out.append(
            {
                "id": rec.id,
                "depth": rec.depth,
                "raw_fidelity": fid_raw,
                "d3pm_fidelity": fid_d3pm,
                "raw_trace_distance": float(M.trace_distance(target, rho_raw)),
                "d3pm_trace_distance": float(M.trace_distance(target, rho_i)),
                "raw_entropy": s_raw,
                "d3pm_entropy": s_d3pm,
                "z_bias": zb,
            }
        )
        if extras is not None:
            extras["rho_raw"].append(rho_raw)
            extras["rho_d3pm"].append(rho_i)
        log_fn(
            f"circuit {i} (depth={rec.depth}): raw={fid_raw:.3f} -> "
            f"d3pm={fid_d3pm:.3f}"
        )

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        write_metrics_csv(os.path.join(out_dir, "metrics.csv"), out)
        from ddqst_tpu_torch import viz

        viz.plot_fidelity_lift(out, os.path.join(out_dir, "fidelity_lift.png"))
        viz.plot_universality(out, os.path.join(out_dir, "universality.png"))
        log_fn(f"wrote metrics + plots to {out_dir}/")
    return out
