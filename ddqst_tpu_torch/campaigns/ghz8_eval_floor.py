"""The eval tail's own floor at the GHZ-8 operating point: the counterpart
of ``scripts/ghz8_eval_floor.py``.

    python -m ddqst_tpu_torch.campaigns.ghz8_eval_floor [--target NPZ]
        [--workdir DIR] [--shots S] [--seed S] [--out FILE] [--smoke]
        [--device cuda|cpu]

The JAX package's GHZ-8 campaign reached fidelity 0.91254 with 3,000
samples a basis through the eval tail (MLE over the canonical grid on the
generated counts). This isolates how much of the deficit is the tail's:
draw the same samples from the MLE target's Born probabilities, the
distribution a perfect distillation would reproduce, and run the same
estimator and metrics. Two rows, through ``ops.mle.make_mle(n, None,
readout_p=0)`` (at N = 8 its blocked path), fidelity against
``qsim.states.ghz_state(n)``, then ``ops.metrics.get_metrics``:

- ``sampled``: ``multinomial(--shots)`` a basis from the target (numpy's
  ``default_rng(--seed)``, as the script draws, so both packages see the
  same counts);
- ``exact``: ``probs · shots`` as fractional counts, no sampling noise: the
  estimator's own bias, which should approach the target's own fidelity
  against the clean state (``campaigns.mle_target`` logs it).

Rows have the script's keys (``kind``, ``num_qubits``, ``shots_per_basis``,
``fidelity``, ``purity``, ``vn_entropy``, ``wall_s``) and ``device``, and
are appended to ``--out``. ``--target`` defaults to
``campaigns.mle_target.target_path(--workdir, 'ghz8_mle_hot')``.
``--smoke`` runs N = 3 with the GHZ state's exact Born probabilities as the
target and writes nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ddqst_tpu_torch.campaigns import (REPO, RESULTS_DIR, append_row,
                                       device_label)

DEFAULT_OUT = os.path.join(RESULTS_DIR, "ghz8_eval_floor.jsonl")
TAG = "ghz8_mle_hot"


def smoke_probs() -> np.ndarray:
    """``[27, 8]`` float32 Born probabilities of GHZ-3 in every canonical
    basis (``--smoke``'s target)."""
    from ddqst_tpu_torch.ops.pauli import all_basis_labels
    from ddqst_tpu_torch.qsim import measure, states

    rots = torch.from_numpy(measure.rotation_unitaries(all_basis_labels(3)))
    psi = torch.from_numpy(states.ghz_state(3))
    return measure.batched_probs_pure(psi[None], rots)[0].numpy()


def draw_counts(probs: np.ndarray, shots: int, seed: int) -> dict:
    """Each row's counts ``[3^N, 2^N]`` float32: ``sampled`` draws
    ``multinomial(shots)`` a basis from ``default_rng(seed)``, ``exact`` is
    ``probs · shots``."""
    rng = np.random.default_rng(seed)
    return {
        "sampled": np.stack([rng.multinomial(shots, p / p.sum())
                             for p in probs]).astype(np.float32),
        "exact": (probs * shots).astype(np.float32),
    }


def floor_rows(probs: np.ndarray, shots: int, seed: int,
               device: torch.device) -> list[dict]:
    """The ``sampled`` and ``exact`` rows of GHZ-N's target ``probs``
    (``[3^N, 2^N]``), without ``device``."""
    from ddqst_tpu_torch.device import synchronize
    from ddqst_tpu_torch.ops import metrics as M
    from ddqst_tpu_torch.ops import mle
    from ddqst_tpu_torch.qsim import states

    b, d = probs.shape
    n = d.bit_length() - 1
    if d != 2**n or b != 3**n:
        raise ValueError(f"target shape {probs.shape} is not [3^N, 2^N]")
    psi = torch.from_numpy(states.ghz_state(n)).to(device)
    rec = mle.make_mle(n, None, readout_p=0.0)
    rows = []
    for kind, counts in draw_counts(probs, shots, seed).items():
        t0 = time.perf_counter()
        rho = rec(torch.from_numpy(counts).to(device))
        fid = float(M.state_fidelity(psi, rho))
        pur, vn, _ = (float(x) for x in M.get_metrics(rho, n))
        synchronize(device)
        rows.append({
            "kind": kind, "num_qubits": n, "shots_per_basis": shots,
            "fidelity": round(fid, 5), "purity": round(pur, 5),
            "vn_entropy": round(vn, 5),
            "wall_s": round(time.perf_counter() - t0, 1)})
    return rows


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m ddqst_tpu_torch.campaigns.ghz8_eval_floor",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--target", default=None,
                    help=f"target npz (default: <workdir>/{TAG}_target.npz)")
    ap.add_argument("--workdir", default=os.path.join(REPO, "frontier_work"))
    ap.add_argument("--shots", type=int, default=3000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--smoke", action="store_true",
                    help="N=3 with GHZ-3's exact Born probabilities; "
                    "writes no row")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without one)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> list[dict]:
    """The two rows (with ``device``), appended to ``args.out`` unless
    ``--smoke``."""
    from ddqst_tpu_torch.campaigns.mle_target import target_path
    from ddqst_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    if args.smoke:
        probs = smoke_probs()
    else:
        with np.load(args.target or target_path(args.workdir, TAG)) as z:
            probs = z["target"]
        if probs.shape != (3**8, 2**8):
            raise ValueError(f"a GHZ-8 target is [6561, 256], not "
                             f"{probs.shape}")
    rows = floor_rows(probs, args.shots, args.seed, device)
    label = device_label(device)
    for row in rows:
        row["device"] = label
        print(f"[eval_floor] {json.dumps(row)}", flush=True)
        if not args.smoke:
            append_row(args.out, row)
    return rows


def main(argv: list[str] | None = None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
