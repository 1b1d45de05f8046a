"""N=10 shadow-transformer runs, the counterpart of
``scripts/run_shadow_scale.py``.

    python -m ddqst_tpu_torch.campaigns.shadow_scale --tag TAG [--epochs E]
        [--embed D --hidden H --blocks B --heads K] [--max_bases M]
        [--distill_steps S ...] [--params_save PT] [--params_load PT]
        [--out FILE] [--device cuda|cpu]

The ``shadow_transformer`` preset (RQC depth 8 at N=10, sampled bases x
1,024 shots) with the study's knobs, through ``pipeline.run_experiment``'s
shadow route, scored against the exact Born probabilities. One JSON row is
appended to ``--out`` and printed: the script's keys and ``device``.
``--params_save`` / ``--params_load`` are ``torch.save`` state dicts (a
warm start skips CE training; give it the same seed and data flags as the
run that saved them).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from ddqst_tpu_torch.campaigns import RESULTS_DIR, append_row, device_label
from ddqst_tpu_torch.config import ExperimentConfig, get_preset

DEFAULT_OUT = os.path.join(RESULTS_DIR, "shadow.jsonl")


def make_cfg(
    tag: str, *, epochs: int = 150, embed: int = 128, hidden: int = 512,
    blocks: int = 4, heads: int = 4, ema: float = 0.0, lr: float = 1e-3,
    batch: int = 1024, shots_infer: int = 5000, shots_train: int = 1024,
    max_bases: int = 100, sampler: str | None = None, mitigate: bool = False,
    distill_steps: int = 0, distill_lr: float = 1e-3,
    distill_basis_batch: int = 16, distill_steps_per_call: int = 5,
    distill_val: float = 0.15, distill_salt: int = 0,
    distill_hard_frac: float = 0.0,
) -> ExperimentConfig:
    """The ``shadow_transformer`` preset with the study's knobs applied
    (``scripts/run_shadow_scale.py:29-80``): new model, diffusion, train
    and data sections, the fields not named taking their classes'
    defaults. The same flags and seed give the same data, which a warm
    start relies on."""
    base = get_preset("shadow_transformer")
    return base.replace(
        name=f"shadow_{tag}",
        diffusion=type(base.diffusion)(
            num_timesteps=100, schedule="cosine",
            sampler=sampler or base.diffusion.sampler,
        ),
        model=type(base.model)(
            arch="transformer", input_encoding="token",
            embed_dim=embed, hidden_dim=hidden,
            num_blocks=blocks, num_heads=heads,
        ),
        train=type(base.train)(
            batch_size=batch, learning_rate=lr, optimizer="adam",
            num_epochs=epochs, lr_schedule="cosine",
            ema_decay=ema, log_every=0, eval_every=0,
            chain_finetune_steps=distill_steps,
            chain_lr=distill_lr,
            chain_basis_batch=distill_basis_batch,
            chain_steps_per_call=distill_steps_per_call,
            chain_val_fraction=distill_val,
            chain_key_salt=distill_salt,
            chain_hard_frac=distill_hard_frac,
        ),
        data=type(base.data)(
            num_qubits=10, state_type="rqc", noise_type="readout",
            shots_train=shots_train, shots_infer=shots_infer,
            rqc_depth=8, max_bases=max_bases,
            mitigate_readout=mitigate,
            mitigate_train_data=mitigate,
        ),
    )


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m ddqst_tpu_torch.campaigns.shadow_scale",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", required=True)
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--embed", type=int, default=128)
    ap.add_argument("--hidden", type=int, default=512)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--ema", type=float, default=0.0)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--shots_infer", type=int, default=5000)
    ap.add_argument("--shots_train", type=int, default=1024)
    ap.add_argument("--max_bases", type=int, default=100,
                    help="shadow-basis count (3^10 = 59,049 total)")
    ap.add_argument("--sampler", default=None,
                    choices=["auto", "exact", "renoise"],
                    help="reverse-sampler rule (default: preset's, renoise)")
    ap.add_argument("--mitigate", action="store_true",
                    help="train on readout-mitigated counts")
    ap.add_argument("--distill_steps", type=int, default=0,
                    help="shadow-scale exact-chain distillation steps "
                         "(2^10-state chain over the sampled bases)")
    ap.add_argument("--distill_lr", type=float, default=1e-3)
    ap.add_argument("--distill_basis_batch", type=int, default=16)
    ap.add_argument("--distill_steps_per_call", type=int, default=5)
    ap.add_argument("--distill_val", type=float, default=0.15,
                    help="held-out shot fraction for automated step "
                         "selection (0 = run all steps)")
    ap.add_argument("--distill_salt", type=int, default=0,
                    help="distillation minibatch salt: give each warm-"
                         "started continuation a fresh one so basis "
                         "minibatches are not replayed")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="JSONL record the row is appended to")
    ap.add_argument("--params_save", default="",
                    help="torch.save path for the post-distillation params")
    ap.add_argument("--params_load", default="",
                    help="torch.save path to warm-start from (skips CE "
                         "training; use the same seed/data flags as the "
                         "run that saved them)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without one)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> tuple[dict, dict]:
    """One run: appends its row to ``args.out`` and returns ``(row,
    results)``."""
    from ddqst_tpu_torch import pipeline
    from ddqst_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    cfg = make_cfg(
        args.tag, epochs=args.epochs, embed=args.embed, hidden=args.hidden,
        blocks=args.blocks, heads=args.heads, ema=args.ema, lr=args.lr,
        batch=args.batch, shots_infer=args.shots_infer,
        shots_train=args.shots_train, max_bases=args.max_bases,
        sampler=args.sampler, mitigate=args.mitigate,
        distill_steps=args.distill_steps, distill_lr=args.distill_lr,
        distill_basis_batch=args.distill_basis_batch,
        distill_steps_per_call=args.distill_steps_per_call,
        distill_val=args.distill_val, distill_salt=args.distill_salt,
    )
    t0 = time.perf_counter()
    res = pipeline.run_experiment(
        cfg, seed=args.seed, params_load=args.params_load,
        params_save=args.params_save, device=device)
    rec = {
        "tag": args.tag,
        "epochs": args.epochs,
        "model": [args.embed, args.hidden, args.blocks, args.heads],
        "distill_steps": args.distill_steps,
        "ema": args.ema,
        "sampler": cfg.diffusion.sampler,
        "mitigate": args.mitigate,
        "seed": args.seed,
        "shots_infer": args.shots_infer,
        "shots_train": args.shots_train,
        "max_bases": args.max_bases,
        "mean_tv_to_target": round(res["mean_tv_to_target"], 5),
        "tv_shot_noise_floor": round(res["tv_shot_noise_floor"], 5),
        "meas_tv_to_target": round(res["meas_tv_to_target"], 5),
        "mean_marginal_error": round(res["mean_marginal_error"], 5),
        "classical_fidelity": round(res["classical_fidelity"], 5),
        "z_bias": res["z_bias"],
        "wall_s": round(time.perf_counter() - t0, 1),
    }
    if "chain_info" in res:
        ci = res["chain_info"]
        rec["chain_ce_before"] = round(float(ci["train_ce_before"]), 5)
        rec["chain_ce_after"] = round(float(ci["train_ce_after"]), 5)
        if "val_history" in ci:
            rec["chain_best_step"] = int(ci["best_step"])
            rec["chain_val_history"] = [
                [int(s), round(float(c), 5)] for s, c in ci["val_history"]
            ]
    rec["device"] = device_label(device)
    append_row(args.out, rec)
    print(json.dumps(rec), flush=True)
    return rec, res


def main(argv: list[str] | None = None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
