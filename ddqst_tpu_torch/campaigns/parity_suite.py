"""The parity and demonstration suite, the counterpart of
``scripts/run_parity_suite.py``.

    python -m ddqst_tpu_torch.campaigns.parity_suite [--out FILE]
        [--only TAG] [--seed S] [--device cuda|cpu]

1. Phase-1 parity: 1-qubit |+> at the notebook budget (1,024 shots a basis,
   ~200 epochs), against notes.pdf Table 2 (0.918919) and the notebook's
   cell 16 (0.909180); the notebook's two MLPs on its own schedule.
2. Phase-2 parity: Bell N=2 and GHZ N=3 at 5,000 training and 10,000
   generated shots a basis, against notes.pdf Table 3 (0.95565, 0.87092).
3. Phase-3 noise sweep: one random circuit (N=2, depth 5) under each of the
   five noise models at the reference's budget.
4. The quality demonstrations (``recipes.quality_cfg``): RQC-3 under
   readout and torino noise, GHZ-3, and RQC-3 at 20,000 shots.

"Parity mode" is the reference's settings: a linear schedule and the
renoise sampler, plain linear inversion, no mitigation, no distillation.
One row a finished experiment is appended to ``--out`` (rerun-safe: a tag
already there is skipped), with the script's keys and ``device``; then a
markdown table of every selected row is printed.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from typing import Iterator

from ddqst_tpu_torch.campaigns import (RESULTS_DIR, append_row,
                                       device_label, read_rows)
from ddqst_tpu_torch.campaigns.recipes import quality_cfg
from ddqst_tpu_torch.config import ExperimentConfig, get_preset

DEFAULT_OUT = os.path.join(RESULTS_DIR, "parity.jsonl")


def parity_cfg(name: str, *, num_qubits: int, state: str, shots_train: int,
               shots_infer: int, noise: str = "readout", epochs: int = 300,
               batch: int = 256, embed: int = 64, hidden: int = 512,
               blocks: int = 4, depth: int = 5, arch: str = "film_mlp",
               schedule: str = "linear", lr: float = 1e-4,
               optimizer: str = "adamw") -> ExperimentConfig:
    """The ``special_states`` preset at the reference's parity settings
    (``scripts/run_parity_suite.py:37-57``): new model, diffusion, train and
    data sections, the fields not named taking their classes' defaults."""
    base = get_preset("special_states")
    return base.replace(
        name=name,
        model=type(base.model)(arch=arch, embed_dim=embed, hidden_dim=hidden,
                               num_blocks=blocks),
        diffusion=type(base.diffusion)(num_timesteps=100, schedule=schedule,
                                       sampler="renoise"),
        train=type(base.train)(batch_size=batch, learning_rate=lr,
                               optimizer=optimizer, num_epochs=epochs,
                               log_every=0, eval_every=0),
        data=type(base.data)(num_qubits=num_qubits, state_type=state,
                             noise_type=noise, shots_train=shots_train,
                             shots_infer=shots_infer, rqc_depth=depth),
    )


PHASE3_NOISES = ("ideal", "readout", "depolarizing", "thermal", "torino")


def experiments() -> Iterator[tuple[str, ExperimentConfig, float | None,
                                    str]]:
    """Every ``(tag, cfg, reference value, note)`` of the script, in its
    order and with its notes."""
    yield ("phase1_plus", parity_cfg(
        "phase1_plus", num_qubits=1, state="plus", shots_train=1024,
        shots_infer=10000, noise="readout", epochs=200, batch=512,
        embed=64, hidden=256, blocks=2,
    ), 0.918919,
        "notes.pdf Table 2 (UpgradedMLP 202 epochs); classical 0.917969")
    # The notebook's two-model comparison (cells 6 / 12): its SimpleMLP and
    # UpgradedMLP on its own p_stay = linspace(1, 0.5) schedule, Adam 1e-3,
    # as many generated samples as training shots.
    yield ("phase1_simple_mlp", parity_cfg(
        "phase1_simple_mlp", num_qubits=1, state="plus", shots_train=1024,
        shots_infer=1024, noise="readout", epochs=200, batch=512,
        embed=32, hidden=128, blocks=2, arch="plain_mlp",
        schedule="notebook", lr=1e-3, optimizer="adam",
    ), 0.909180, "notebook cell 16 (SimpleMLP, 200 epochs)")
    yield ("phase1_upgraded_mlp", parity_cfg(
        "phase1_upgraded_mlp", num_qubits=1, state="plus", shots_train=1024,
        shots_infer=1024, noise="readout", epochs=300, batch=128,
        embed=128, hidden=256, blocks=3, arch="plain_mlp",
        schedule="notebook", lr=1e-3, optimizer="adam",
    ), 0.918919, "notes.pdf Table 2 (UpgradedMLP, 202 epochs)")
    yield ("phase2_bell", parity_cfg(
        "phase2_bell", num_qubits=2, state="bell", shots_train=5000,
        shots_infer=10000, noise="ideal",
    ), 0.95565, "notes.pdf Table 3")
    yield ("phase2_ghz3", parity_cfg(
        "phase2_ghz3", num_qubits=3, state="ghz", shots_train=5000,
        shots_infer=10000, noise="ideal",
    ), 0.87092, "notes.pdf Table 3")
    for noise in PHASE3_NOISES:
        yield (f"phase3_rqc2_{noise}", parity_cfg(
            f"phase3_rqc2_{noise}", num_qubits=2, state="rqc",
            shots_train=1000, shots_infer=10000, noise=noise, depth=5,
        ), None, "phase-3 defaults (config.py:3-24), reference prints but "
                 "does not publish per-noise numbers")
    yield ("rqc3_quality", quality_cfg(
        "rqc3_quality", num_qubits=3, state="rqc", shots_train=5000,
        shots_infer=50000, noise="readout", depth=5,
    ), None, "BASELINE target: N=3 RQC >= 0.99 (quality stack)")
    yield ("rqc3_quality_torino", quality_cfg(
        "rqc3_quality_torino", num_qubits=3, state="rqc", shots_train=5000,
        shots_infer=50000, noise="torino", depth=5,
    ), None, "torino stand-in noise (depolarizing+readout)")
    yield ("ghz3_quality", quality_cfg(
        "ghz3_quality", num_qubits=3, state="ghz", shots_train=5000,
        shots_infer=50000, noise="readout",
    ), None, "BASELINE target: GHZ-3 >= 0.99 through the generative pipeline")
    # RQC-3 at 5,000 shots is capped by its data (MLE on raw ~0.985): four
    # times the shots lift the cap past 0.99.
    yield ("rqc3_quality_20k", quality_cfg(
        "rqc3_quality_20k", num_qubits=3, state="rqc", shots_train=20000,
        shots_infer=100000, noise="readout", depth=5,
    ), None, "RQC-3 >= 0.99 demonstration at the shot budget that supports it")


def run(out: str, only: str = "", seed: int = 0, device="cuda",
        epochs: int = 0) -> list[tuple[dict, dict | None]]:
    """The selected experiments: each one's ``(row, results)``, results None
    for a row already in ``out``. ``epochs`` > 0 cuts CE training to that
    many epochs (the tests' cut; the row is written as any other)."""
    from ddqst_tpu_torch import pipeline
    from ddqst_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    label = device_label(dev)
    done = {r["tag"]: r for r in read_rows(out)}
    rows = []
    for tag, cfg, ref, note in experiments():
        if only and only != tag:
            continue
        if tag in done:
            rows.append((done[tag], None))
            continue
        if epochs:
            cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                        num_epochs=epochs))
        t0 = time.perf_counter()
        res = pipeline.run_experiment(cfg, seed=seed, device=dev)
        mit = res.get("raw_fidelity_mitigated")
        rec = {
            "tag": tag,
            "fidelity": round(res["fidelity"], 5),
            "raw_fidelity": round(res["raw_fidelity"], 5),
            "raw_fidelity_mitigated": None if mit is None else round(mit, 5),
            "trace_distance": round(res["trace_distance"], 5),
            "reference": ref,
            "note": note,
            "wall_s": round(time.perf_counter() - t0, 1),
            "device": label,
        }
        append_row(out, rec)
        rows.append((rec, res))
        print(f"== {tag}: fidelity={rec['fidelity']} (ref {ref}) "
              f"raw={rec['raw_fidelity']} [{rec['wall_s']}s]", flush=True)
    return rows


def table(rows: list[dict]) -> str:
    """The script's markdown table of ``rows``."""
    lines = ["| tag | fidelity | raw baseline | best-raw (MLE) | reference |",
             "|---|---|---|---|---|"]
    lines += [f"| {r['tag']} | {r['fidelity']} | {r['raw_fidelity']} | "
              f"{r['raw_fidelity_mitigated']} | {r['reference']} |"
              for r in rows]
    return "\n".join(lines)


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m ddqst_tpu_torch.campaigns.parity_suite",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="JSONL record the rows are appended to")
    ap.add_argument("--only", default="", help="run this tag alone")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without one)")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    rows = run(args.out, args.only, args.seed, args.device)
    print("\n" + table([r for r, _ in rows]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
