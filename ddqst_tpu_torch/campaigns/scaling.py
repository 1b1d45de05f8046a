"""The scaling ladder: full density-matrix reconstruction beyond N = 3, the
counterpart of ``scripts/run_scaling_ghz.py``.

    python -m ddqst_tpu_torch.campaigns.scaling [--out FILE] [--only TAG]
        [--seed S] [--probe] [--data_cache NPZ] [--target_cache NPZ]
        [--device cuda|cpu]

Every experiment runs the full protocol over all 3^N canonical bases with
the quality stack (cosine schedule, renoise sampler, mitigated training,
exact-chain distillation, noise-aware MLE) through
``pipeline.run_experiment``. One JSON row is appended to ``--out`` a
finished experiment (rerun-safe: a tag already in the file is skipped);
``cpu_tiny`` runs only when ``--only`` names it. After each run one JSON
line gives the kernel launches it made (0 on the CPU, where the wrappers
take their plain versions) and the last walk's plan.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Iterator

from ddqst_tpu_torch.campaigns import (RESULTS_DIR, append_row,
                                       device_label, read_rows)
from ddqst_tpu_torch.campaigns.recipes import (auto_recipe, coverage_steps,
                                               quality_cfg)
from ddqst_tpu_torch.config import ExperimentConfig, get_preset

DEFAULT_OUT = os.path.join(RESULTS_DIR, "scaling.jsonl")


def experiments() -> Iterator[tuple[str, ExperimentConfig, str]]:
    """Every ``(tag, cfg, note)`` of ``scripts/run_scaling_ghz.py:71-349``,
    in its order and with its notes."""
    # cpu_tiny: the drivers' test config, N=2 Bell at toy budgets.
    tiny = get_preset("special_states").replace(name="cpu_tiny")
    tiny = tiny.replace(
        model=type(tiny.model)(embed_dim=16, hidden_dim=32, num_blocks=1),
        diffusion=type(tiny.diffusion)(
            num_timesteps=10, schedule="cosine", sampler="renoise"),
        train=type(tiny.train)(
            batch_size=256, learning_rate=1e-3, optimizer="adam",
            num_epochs=2, log_every=0, eval_every=0,
            chain_finetune_steps=4, chain_lr=1e-3,
            chain_steps_per_call=2, chain_target="mle"),
        data=type(tiny.data)(
            num_qubits=2, state_type="bell", noise_type="ideal",
            shots_train=400, shots_infer=500),
    )
    yield ("cpu_tiny", tiny, "CPU driver-test config (not a TPU experiment)")

    # shots_infer shrinks with N to bound the generated volume (bases x
    # shots_infer): 27 x 50k / 81 x 30k / 243 x 20k.
    yield ("ghz4_quality", quality_cfg(
        "ghz4_quality", num_qubits=4, state="ghz", shots_train=5000,
        shots_infer=30000, noise="readout",
    ), "GHZ-4: 81 bases x 5,000 shots (reference protocol, one N beyond)")
    yield ("w4_quality", quality_cfg(
        "w4_quality", num_qubits=4, state="w", shots_train=5000,
        shots_infer=30000, noise="readout",
    ), "W-4: 81 bases x 5,000 shots")
    cfg5 = quality_cfg(
        "ghz5_quality", num_qubits=5, state="ghz", shots_train=5000,
        shots_infer=20000, noise="readout",
    )
    cfg5 = cfg5.replace(train=type(cfg5.train)(
        batch_size=1024, learning_rate=1e-3, optimizer="adam",
        num_epochs=300, lr_schedule="cosine", log_every=0, eval_every=0,
        chain_finetune_steps=150, chain_lr=3e-4))
    yield ("ghz5_quality", cfg5,
           "GHZ-5: 243 bases x 5,000 shots (4^5=1024 Pauli coefficients)")
    cfg6 = quality_cfg(
        "ghz6_quality", num_qubits=6, state="ghz", shots_train=5000,
        shots_infer=10000, noise="readout",
    )
    # No distillation: the full-grid (46,656-row) backward was too large
    # for the JAX package's device; ghz6_distilled minibatches the bases.
    cfg6 = cfg6.replace(train=type(cfg6.train)(
        batch_size=1024, learning_rate=1e-3, optimizer="adam",
        num_epochs=150, lr_schedule="cosine", log_every=0, eval_every=0))
    yield ("ghz6_quality", cfg6,
           "GHZ-6: 729 bases x 5,000 shots, 2x the reference's max N")
    cfg6d = cfg6.replace(
        name="ghz6_distilled",
        train=type(cfg6.train)(
            batch_size=1024, learning_rate=1e-3, optimizer="adam",
            num_epochs=150, lr_schedule="cosine", log_every=0, eval_every=0,
            chain_finetune_steps=400, chain_lr=3e-4, chain_basis_batch=96))
    yield ("ghz6_distilled", cfg6d,
           "GHZ-6 + basis-minibatched exact-chain distillation")
    # The per-qubit-token transformer factorises the basis conditioning,
    # where the FiLM MLP's 729-row basis embedding shares nothing.
    cfg6t = cfg6d.replace(
        name="ghz6_transformer",
        model=type(cfg6d.model)(
            arch="transformer", input_encoding="token", embed_dim=128,
            hidden_dim=512, num_blocks=4, num_heads=4),
        train=type(cfg6d.train)(
            batch_size=1024, learning_rate=1e-3, optimizer="adam",
            num_epochs=300, lr_schedule="cosine", log_every=0, eval_every=0))
    yield ("ghz6_transformer", cfg6t,
           "GHZ-6, per-qubit-token transformer denoiser (CE only)")
    cfg6td = cfg6t.replace(
        name="ghz6_transformer_distilled",
        train=type(cfg6t.train)(
            batch_size=1024, learning_rate=1e-3, optimizer="adam",
            num_epochs=300, lr_schedule="cosine", log_every=0, eval_every=0,
            chain_finetune_steps=150, chain_lr=3e-4, chain_basis_batch=96,
            chain_steps_per_call=10))
    yield ("ghz6_transformer_distilled", cfg6td,
           "GHZ-6 transformer + minibatched distillation (10-step chunks)")
    cfg6t100 = cfg6t.replace(
        name="ghz6_transformer_e100",
        train=type(cfg6t.train)(
            batch_size=1024, learning_rate=1.5e-3, optimizer="adam",
            num_epochs=100, lr_schedule="cosine", log_every=0, eval_every=0))
    yield ("ghz6_transformer_e100", cfg6t100,
           "GHZ-6 transformer, 100-epoch schedule (wedge-horizon budget)")
    cfg6dh = cfg6d.replace(
        name="ghz6_distilled_hot",
        train=type(cfg6d.train)(
            batch_size=1024, learning_rate=1e-3, optimizer="adam",
            num_epochs=150, lr_schedule="cosine", log_every=0, eval_every=0,
            chain_finetune_steps=800, chain_lr=1e-3, chain_basis_batch=96))
    yield ("ghz6_distilled_hot", cfg6dh,
           "GHZ-6 + hotter minibatched distillation (800 steps, lr 1e-3)")
    cfg5h = quality_cfg(
        "ghz5_distilled_hot", num_qubits=5, state="ghz", shots_train=5000,
        shots_infer=20000, noise="readout",
    )
    cfg5h = cfg5h.replace(train=type(cfg5h.train)(
        batch_size=1024, learning_rate=1e-3, optimizer="adam",
        num_epochs=300, lr_schedule="cosine", log_every=0, eval_every=0,
        chain_finetune_steps=800, chain_lr=1e-3, chain_basis_batch=96))
    yield ("ghz5_distilled_hot", cfg5h,
           "GHZ-5 + hot distillation recipe")
    # The one automated recipe across N: 800 steps at lr 1e-3, the held-out
    # step selection choosing the stopping point.
    yield ("ghz3_auto", auto_recipe(quality_cfg(
        "ghz3_auto", num_qubits=3, state="ghz", shots_train=5000,
        shots_infer=50000, noise="readout",
    )), "GHZ-3, automated distillation recipe")
    yield ("ghz5_auto", auto_recipe(quality_cfg(
        "ghz5_auto", num_qubits=5, state="ghz", shots_train=5000,
        shots_infer=20000, noise="readout",
    )), "GHZ-5, automated distillation recipe")
    yield ("ghz6_auto", auto_recipe(quality_cfg(
        "ghz6_auto", num_qubits=6, state="ghz", shots_train=5000,
        shots_infer=10000, noise="readout",
    ), basis_batch=96, epochs=150),
        "GHZ-6, automated distillation recipe (96-basis minibatch)")
    # A random circuit's state: the generic case, without the structure of
    # the GHZ rows.
    yield ("rqc4_auto", auto_recipe(quality_cfg(
        "rqc4_auto", num_qubits=4, state="rqc", shots_train=5000,
        shots_infer=30000, noise="readout",
    )), "RQC-4 (depth 5): 81 bases, automated recipe")
    yield ("rqc5_auto", auto_recipe(quality_cfg(
        "rqc5_auto", num_qubits=5, state="rqc", shots_train=5000,
        shots_infer=20000, noise="readout",
    )), "RQC-5 (depth 5): 243 bases, automated recipe")
    yield ("rqc6_auto", auto_recipe(quality_cfg(
        "rqc6_auto", num_qubits=6, state="rqc", shots_train=5000,
        shots_infer=10000, noise="readout",
    ), basis_batch=96, epochs=150),
        "RQC-6 (depth 5): 729 bases, automated recipe")
    # N = 7, 2,187 bases: shots_train=3000 bounds an epoch at ~6.4 M rows.
    yield ("ghz7_auto", auto_recipe(quality_cfg(
        "ghz7_auto", num_qubits=7, state="ghz", shots_train=3000,
        shots_infer=5000, noise="readout",
    ), basis_batch=64, epochs=30, steps_per_call=10),
        "GHZ-7: 2187 bases, automated recipe (frontier)")
    # v2: the MLE-projected target, twice the CE epochs, a steadier held-out
    # signal (128 bases a step, patience 12).
    yield ("ghz7_mle", auto_recipe(quality_cfg(
        "ghz7_mle", num_qubits=7, state="ghz", shots_train=3000,
        shots_infer=5000, noise="readout",
    ), basis_batch=128, epochs=60, steps_per_call=10, target="mle",
        val_patience=12),
        "GHZ-7: MLE-projected distillation target, 60 CE epochs")
    # v3: no held-out stop (its per-eval signal is below threshold at 128 of
    # 2,187 bases), a fixed hot budget toward the MLE projection.
    yield ("ghz7_mle_hot", auto_recipe(quality_cfg(
        "ghz7_mle_hot", num_qubits=7, state="ghz", shots_train=3000,
        shots_infer=5000, noise="readout",
    ), basis_batch=128, epochs=60, steps_per_call=10, target="mle",
        val_fraction=0.0, steps=1600),
        "GHZ-7: MLE target, fixed 1600-step hot distillation")
    yield ("rqc7_mle_hot", auto_recipe(quality_cfg(
        "rqc7_mle_hot", num_qubits=7, state="rqc", shots_train=3000,
        shots_infer=5000, noise="readout",
    ), basis_batch=128, epochs=60, steps_per_call=10, target="mle",
        val_fraction=0.0, steps=1600),
        "RQC-7 (depth 5): 2187 bases, MLE target, fixed hot distillation")
    # N = 8, 6,561 bases: the tables once (gen_tables_once), 64 bases a
    # distillation step (16,384 grid rows), 2,000 training shots (13.1 M
    # rows an epoch).
    cfg8 = auto_recipe(quality_cfg(
        "ghz8_mle_hot", num_qubits=8, state="ghz", shots_train=2000,
        shots_infer=3000, noise="readout",
    ), basis_batch=64, epochs=40, steps_per_call=10, target="mle",
        val_fraction=0.0, steps=1600)
    cfg8 = cfg8.replace(diffusion=type(cfg8.diffusion)(
        num_timesteps=100, schedule="cosine", sampler="renoise",
        gen_tables_once=True))
    yield ("ghz8_mle_hot", cfg8,
           "GHZ-8: 6561 bases, MLE target, amortised generation (frontier)")
    # v2: N=7's grid coverage (~94 passes) at the same shapes.
    cfg8v2 = cfg8.replace(
        name="ghz8_mle_hot_v2",
        train=dataclasses.replace(cfg8.train, chain_finetune_steps=9600),
    )
    yield ("ghz8_mle_hot_v2", cfg8v2,
           "GHZ-8 v2: matched-coverage 9600-step distillation")
    cfg8s = cfg8.replace(
        name="ghz8_mle_hot_s4800",
        train=dataclasses.replace(cfg8.train, chain_finetune_steps=4800),
    )
    yield ("ghz8_mle_hot_s4800", cfg8s,
           "GHZ-8: 4800-step distillation (bounded loop length)")
    # The budget from the coverage rule: 4 accumulated minibatches of 64
    # bases a step (3.9% of the grid), each at 16,384 grid rows.
    rqc8 = auto_recipe(quality_cfg(
        "rqc8_mle_hot", num_qubits=8, state="rqc", shots_train=2000,
        shots_infer=3000, noise="readout",
    ), basis_batch=64, epochs=40, steps_per_call=10, target="mle",
        val_fraction=0.0, steps=coverage_steps(8, 64, accum=4), accum=4)
    rqc8 = rqc8.replace(diffusion=type(rqc8.diffusion)(
        num_timesteps=100, schedule="cosine", sampler="renoise",
        gen_tables_once=True))
    yield ("rqc8_mle_hot", rqc8,
           "RQC-8 (depth 5): 6561 bases, coverage-rule budget, accum=4")


def experiment(tag: str) -> tuple[ExperimentConfig, str]:
    """``(cfg, note)`` of one tag of :func:`experiments`; an unknown tag
    raises ``ValueError`` naming the tags."""
    for name, cfg, note in experiments():
        if name == tag:
            return cfg, note
    raise ValueError(f"no experiment {tag!r}; tags: "
                     f"{[t for t, _, _ in experiments()]}")


def probe_cfg(cfg: ExperimentConfig) -> ExperimentConfig:
    """``--probe``: 1 CE epoch and at most two calls' distillation steps,
    every shape unchanged."""
    tr = cfg.train
    return cfg.replace(train=dataclasses.replace(
        tr, num_epochs=1,
        chain_finetune_steps=(
            min(tr.chain_finetune_steps, 2 * tr.chain_steps_per_call)
            if tr.chain_finetune_steps else 0)))


def row(tag: str, cfg: ExperimentConfig, note: str, res: dict,
        wall_s: float, device: str) -> dict:
    """A ladder row: the script's keys, rounded as it rounds them, and
    ``device``."""
    mit = res.get("raw_fidelity_mitigated")
    return {
        "tag": tag,
        "num_qubits": cfg.data.num_qubits,
        "fidelity": round(res["fidelity"], 5),
        "raw_fidelity": round(res["raw_fidelity"], 5),
        "raw_fidelity_mitigated": None if mit is None else round(mit, 5),
        "trace_distance": round(res["trace_distance"], 5),
        "note": note,
        "wall_s": round(wall_s, 1),
        "device": device,
    }


def finished_tags(path: str) -> set[str]:
    """The tags already in a record file."""
    return {r["tag"] for r in read_rows(path)}


def launches_line(tag: str, probe: bool) -> dict:
    """The kernel launches since the counts were last set to 0, and the
    last walk's plan."""
    from ddqst_tpu_torch.ops import cuda_kernels as ck

    return {"tag": tag, "probe": probe,
            "walk_launches": ck.fused_chain_walk.launches,
            "step_launches": ck.fused_chain_step.launches,
            "walk_plan": ck.fused_chain_walk.last_plan}


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m ddqst_tpu_torch.campaigns.scaling",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="JSONL record the rows are appended to")
    ap.add_argument("--only", default="", help="run this tag alone")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--probe", action="store_true",
                    help="whole-shape check at small cost: run the "
                    "selected experiments with 1 CE epoch and at most 2 x "
                    "chain_steps_per_call distillation steps at unchanged "
                    "shapes (model, batch, bases, shots, steps a call), so "
                    "every stage runs once at its real size (there is no "
                    "compile cache to warm); writes no row")
    ap.add_argument("--data_cache", default="",
                    help="npz cache of the generated data (same seed = "
                    "identical data), read if it exists, written otherwise")
    ap.add_argument("--target_cache", default="",
                    help="npz cache of the MLE distillation target "
                    "(chain_target='mle'), read if it exists, written "
                    "otherwise")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without one)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> list[tuple[dict | None, dict]]:
    """Run the selected experiments; returns each one's ``(row, results)``
    (the row None under ``--probe``)."""
    from ddqst_tpu_torch import pipeline
    from ddqst_tpu_torch.device import resolve_device
    from ddqst_tpu_torch.ops import cuda_kernels as ck

    device = resolve_device(args.device)
    if args.only:
        experiment(args.only)  # an unknown tag raises before any work
    label = device_label(device)
    done = finished_tags(args.out)
    out = []
    for tag, cfg, note in experiments():
        if (args.only and args.only != tag) or (tag in done
                                                and not args.probe):
            continue
        if tag == "cpu_tiny" and args.only != tag:
            continue  # the drivers' test config runs only when named
        if args.probe:
            cfg = probe_cfg(cfg)
        ck.fused_chain_walk.launches = ck.fused_chain_step.launches = 0
        t0 = time.perf_counter()
        res = pipeline.run_experiment(
            cfg, seed=args.seed, data_cache=args.data_cache,
            target_cache=args.target_cache, device=device)
        wall_s = time.perf_counter() - t0
        print(json.dumps(launches_line(tag, args.probe)), flush=True)
        if args.probe:
            print(f"== probe {tag} complete [{wall_s:.1f}s]", flush=True)
            out.append((None, res))
            continue
        rec = row(tag, cfg, note, res, wall_s, label)
        append_row(args.out, rec)
        print(f"== {tag}: fidelity={rec['fidelity']} "
              f"raw={rec['raw_fidelity']} mle={rec['raw_fidelity_mitigated']} "
              f"[{rec['wall_s']}s]", flush=True)
        out.append((rec, res))
    return out


def main(argv: list[str] | None = None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
