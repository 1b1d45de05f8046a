"""RQC-3's information ceiling and its >= 0.99 generative campaign, the
counterpart of ``scripts/run_rqc3_ceiling.py``.

    python -m ddqst_tpu_torch.campaigns.rqc3_ceiling --ceiling [--out FILE]
        [--device cuda|cpu]
    python -m ddqst_tpu_torch.campaigns.rqc3_ceiling --run [--only TAG]
        [--seed S] [--out FILE] [--device cuda|cpu]

``--ceiling`` (no model): for the N=3 random circuit of seeds 0-2 under
readout noise, MLE on the exact noisy Born distribution (no shot noise:
noise-aware MLE, plain MLE and mitigated linear inversion) bounds what any
estimator can reach at infinite shots; noise-aware MLE on counts sampled at
5,000, 20,000 and 50,000 shots a basis (numpy's generator at 1000 + seed)
gives the ceiling at each budget. Rows go to
``examples/results_torch/rqc3_ceiling.jsonl``.

``--run``: the generative campaign on the quality stack with the automated
distillation recipe (800 steps at lr 3e-4, the held-out step selection),
against the MLE-projected target or the counts. Rows go to
``examples/results_torch/rqc3_99.jsonl``; a tag already there is skipped,
and a seed other than 0 suffixes the tag with ``_s<seed>``. Every row has
the script's keys and ``device``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Iterator

import numpy as np
import torch

from ddqst_tpu_torch.campaigns import (RESULTS_DIR, append_row,
                                       device_label, read_rows)
from ddqst_tpu_torch.campaigns.recipes import quality_cfg
from ddqst_tpu_torch.config import ExperimentConfig

CEILING_OUT = os.path.join(RESULTS_DIR, "rqc3_ceiling.jsonl")
RUN_OUT = os.path.join(RESULTS_DIR, "rqc3_99.jsonl")
SEEDS = (0, 1, 2)
SHOTS = (5000, 20000, 50000)


def noisy_setup(seed: int, device, noise_type: str = "readout",
                depth: int = 5):
    """``run_experiment``'s data state for this seed: the target
    statevector, the noisy Born probabilities ``[27, 8]`` (float64, readout
    channel included) and the noise config."""
    from ddqst_tpu_torch.ops import pauli
    from ddqst_tpu_torch.pipeline import noisy_basis_probs
    from ddqst_tpu_torch.qsim import measure, noise, states

    circuit = states.prep_circuit("rqc", 3, depth,
                                  np.random.default_rng(seed))
    ncfg = noise.get_noise_config(noise_type)
    rots = torch.from_numpy(measure.rotation_unitaries(
        pauli.all_basis_labels(3))).to(device)
    probs = noisy_basis_probs(circuit, ncfg, rots)
    return (states.circuit_statevector(circuit),
            probs.cpu().numpy().astype(np.float64), ncfg)


def run_ceiling(out_path: str, device) -> list[dict]:
    from ddqst_tpu_torch.ops import metrics as M
    from ddqst_tpu_torch.ops import mle, pauli

    label = device_label(device)
    rows = []

    def emit(rec: dict) -> None:
        rec["device"] = label
        rows.append(rec)
        append_row(out_path, rec)
        print(json.dumps(rec), flush=True)

    for seed in SEEDS:
        target, probs, ncfg = noisy_setup(seed, device)
        target = torch.from_numpy(target).to(device)
        p = ncfg.readout_p
        rec_mle = mle.make_mle(3, readout_p=p)
        rec_mle0 = mle.make_mle(3)
        inv = pauli.make_counts_inverter(3, readout_p=p)

        def fid(rho: torch.Tensor) -> float:
            return float(M.state_fidelity(target, rho))

        exact = torch.from_numpy(probs).float().to(device)
        emit({"mode": "exact_distribution", "seed": seed,
              "mle_noise_aware": round(fid(rec_mle(exact)), 6),
              "mle_plain": round(fid(rec_mle0(exact)), 6),
              "linear_mitigated": round(fid(inv(exact)), 6)})
        rng = np.random.default_rng(1000 + seed)
        for shots in SHOTS:
            counts = np.stack([rng.multinomial(shots, pr / pr.sum())
                               for pr in probs]).astype(np.float32)
            emit({"mode": "sampled", "seed": seed, "shots": shots,
                  "mle_noise_aware": round(fid(rec_mle(
                      torch.from_numpy(counts).to(device))), 6)})
    return rows


def experiments() -> Iterator[tuple[str, ExperimentConfig, str]]:
    """The three ``(tag, cfg, note)`` of the ``--run`` campaign, in the
    script's order."""

    def auto(cfg: ExperimentConfig, target: str) -> ExperimentConfig:
        return cfg.replace(train=type(cfg.train)(
            batch_size=1024, learning_rate=1e-3, optimizer="adam",
            num_epochs=300, lr_schedule="cosine", log_every=0, eval_every=0,
            chain_finetune_steps=800, chain_lr=3e-4,
            chain_val_fraction=0.15, chain_val_patience=4,
            chain_target=target))

    c20 = quality_cfg("rqc3_20k", num_qubits=3, state="rqc",
                      shots_train=20000, shots_infer=50000, noise="readout")
    yield ("rqc3_20k_mle_target", auto(c20, "mle"),
           "RQC-3 20k shots, auto distillation, MLE-projected target")
    yield ("rqc3_20k_counts", auto(c20.replace(name="rqc3_20k_counts"),
                                   "counts"),
           "RQC-3 20k shots, auto distillation, counts target (control)")
    c50 = quality_cfg("rqc3_50k", num_qubits=3, state="rqc",
                      shots_train=50000, shots_infer=50000, noise="readout")
    yield ("rqc3_50k_mle_target", auto(c50, "mle"),
           "RQC-3 50k shots, auto distillation, MLE-projected target")


def run_campaign(out_path: str, only: str, seed: int,
                 device) -> list[tuple[dict, dict]]:
    """The campaign's runs not yet in ``out_path``; returns each one's
    ``(row, results)``."""
    from ddqst_tpu_torch import pipeline

    label = device_label(device)
    done = {r["tag"] for r in read_rows(out_path)}
    out = []
    for tag, cfg, note in experiments():
        full_tag = f"{tag}_s{seed}" if seed else tag
        if (only and only != tag) or full_tag in done:
            continue
        t0 = time.perf_counter()
        res = pipeline.run_experiment(cfg, seed=seed, device=device)
        mit = res.get("raw_fidelity_mitigated")
        rec = {"tag": full_tag,
               "fidelity": round(res["fidelity"], 5),
               "raw_fidelity": round(res["raw_fidelity"], 5),
               "raw_fidelity_mitigated": (None if mit is None
                                          else round(mit, 5)),
               "note": note,
               "wall_s": round(time.perf_counter() - t0, 1),
               "device": label}
        append_row(out_path, rec)
        print(f"== {full_tag}: fid={rec['fidelity']} "
              f"raw={rec['raw_fidelity']} "
              f"mle={rec['raw_fidelity_mitigated']} [{rec['wall_s']}s]",
              flush=True)
        out.append((rec, res))
    return out


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m ddqst_tpu_torch.campaigns.rqc3_ceiling",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--ceiling", action="store_true")
    ap.add_argument("--run", action="store_true")
    ap.add_argument("--only", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="",
                    help="JSONL record (default: results_torch/"
                    "rqc3_ceiling.jsonl for --ceiling, rqc3_99.jsonl for "
                    "--run)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without one)")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    from ddqst_tpu_torch.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.ceiling:
        run_ceiling(args.out or CEILING_OUT, device)
    if args.run:
        run_campaign(args.out or RUN_OUT, args.only, args.seed, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
