"""Segmented N=10 shadow-scale distillation, each role a fresh child
process: the counterpart of ``scripts/run_shadow_segments.py``.

    python -m ddqst_tpu_torch.campaigns.shadow_segments [--tag TAG]
        [--segments K] [--steps_per_segment S] [--start_segment I]
        [--epochs E] [--embed D --hidden H --blocks B --heads A]
        [--shots_infer S] [--shots_train S] [--max_bases M]
        [--distill_basis_batch B] [--distill_steps_per_call C]
        [--distill_val F] [--hard_frac F] [--seed S] [--workdir DIR]
        [--out FILE] [--data_cache auto|NPZ|''] [--segment_timeout SECONDS]
        [--device cuda|cpu]

Shadow-scale chain distillation moved the reference's N=10 TV plateau from
0.197 to 0.174 in 300 steps. This applies ``campaigns.segments``' protocol
to the shadow route (``shadow_scale.make_cfg``, RQC depth 8 at N=10 on
sampled bases), chained through ``torch.save`` snapshots in ``--workdir``:

- ``datagen`` (only when the data cache is absent): the data, from the
  seed, into ``--data_cache`` (``auto``: ``<workdir>/<tag>_data.npz``);
- ``ce``: the data and CE training, no distillation ->
  ``<tag>_ce_params.pt``;
- segment i: warm start from the previous snapshot (segment 0 from the CE
  one), ``--steps_per_segment`` distillation steps with the minibatch salt
  ``i + 1`` (so no segment replays another's minibatches) ->
  ``<tag>_seg<i>_params.pt``; each appends its steps and chain CE before
  and after to ``<tag>_segments.jsonl``;
- ``eval``: warm start from the last segment, no distillation, the
  generation and exact-Born metrics tail, then one row appended to
  ``--out``: the script's keys (``tag`` is ``<tag>_seg<K>x<S>``,
  ``distill_steps_actual`` the steps the log records) and ``device``.

``--start_segment I`` resumes at segment I with the snapshots before it in
place (-1, the default, starts with the CE role). A child that fails or
outlives ``--segment_timeout`` ends the campaign with exit code 1 and the
tail of its standard error; nothing is retried and no later role runs. A
child whose role equals ``segments.FAIL_ENV`` raises before any work.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from ddqst_tpu_torch.campaigns import REPO, append_row, device_label
from ddqst_tpu_torch.campaigns.segments import (FAIL_ENV, data_cache_path,
                                                run_roles, snapshot)
from ddqst_tpu_torch.campaigns.shadow_scale import DEFAULT_OUT, make_cfg
from ddqst_tpu_torch.config import ExperimentConfig

# The flags every child gets from the parent, as (flag, type, default).
SHARED_FLAGS = (
    ("steps_per_segment", int, 300),
    ("epochs", int, 150),
    ("embed", int, 128),
    ("hidden", int, 512),
    ("blocks", int, 4),
    ("heads", int, 4),
    ("shots_infer", int, 5000),
    ("shots_train", int, 1024),
    ("max_bases", int, 300),
    ("distill_basis_batch", int, 16),
    ("distill_steps_per_call", int, 5),
    ("distill_val", float, 0.15),
    ("hard_frac", float, 0.0),
)


def cfg_for(args: argparse.Namespace, *, distill_steps: int,
            distill_salt: int) -> ExperimentConfig:
    """A role's config: ``shadow_scale.make_cfg`` with the script's
    ``_cfg_for`` fields (``scripts/run_shadow_segments.py:53-66``)."""
    return make_cfg(
        args.tag, epochs=args.epochs, embed=args.embed, hidden=args.hidden,
        blocks=args.blocks, heads=args.heads,
        shots_infer=args.shots_infer, shots_train=args.shots_train,
        max_bases=args.max_bases,
        distill_steps=distill_steps,
        distill_basis_batch=args.distill_basis_batch,
        distill_steps_per_call=args.distill_steps_per_call,
        distill_val=args.distill_val, distill_salt=distill_salt,
        distill_hard_frac=args.hard_frac,
    )


def child(args: argparse.Namespace) -> None:
    """One role, in this (fresh) process."""
    if os.environ.get(FAIL_ENV) == args.child_role:
        raise RuntimeError(f"injected failure in role {args.child_role!r} "
                           f"({FAIL_ENV})")
    from ddqst_tpu_torch import pipeline
    from ddqst_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    tag, seg = args.tag, args.child_segment
    cache = data_cache_path(args)
    if args.child_role == "datagen":
        pipeline.ensure_data_cache(cfg_for(args, distill_steps=0,
                                           distill_salt=0),
                                   args.seed, cache, device=device)
        print("== datagen done", flush=True)
        return
    steps_log = os.path.join(args.workdir, f"{tag}_segments.jsonl")
    if args.child_role == "ce":
        pipeline.run_experiment(
            cfg_for(args, distill_steps=0, distill_salt=0), seed=args.seed,
            params_save=snapshot(args.workdir, tag, -1),
            stop_after="distill", data_cache=cache, device=device)
        print("== ce segment done", flush=True)
        return
    if args.child_role == "distill":
        res = pipeline.run_experiment(
            cfg_for(args, distill_steps=args.steps_per_segment,
                    distill_salt=seg + 1),
            seed=args.seed, params_load=snapshot(args.workdir, tag, seg - 1),
            params_save=snapshot(args.workdir, tag, seg),
            stop_after="distill", data_cache=cache, device=device)
        info = res.get("ft_info") or {}
        # The held-out stop can end a segment early: the log keeps the
        # steps run, and the eval row sums them.
        steps_run = (0 if res.get("ft_losses") is None
                     else len(res["ft_losses"]))
        with open(steps_log, "a") as f:
            f.write(json.dumps({
                "segment": seg, "steps_run": steps_run,
                "ce_before": info.get("train_ce_before"),
                "ce_after": info.get("train_ce_after"),
                "best_step": info.get("best_step"),
            }) + "\n")
        print(f"== segment {seg} done: chain CE "
              f"{info.get('train_ce_before', float('nan')):.5f} -> "
              f"{info.get('train_ce_after', float('nan')):.5f} "
              f"({steps_run} steps run)", flush=True)
        return
    # eval: no further distillation, the generation and metrics tail.
    t0 = time.perf_counter()
    res = pipeline.run_experiment(
        cfg_for(args, distill_steps=0, distill_salt=0), seed=args.seed,
        params_load=snapshot(args.workdir, tag, seg), data_cache=cache,
        device=device)
    actual_steps = None
    if os.path.exists(steps_log):
        with open(steps_log) as f:
            actual_steps = sum(json.loads(line).get("steps_run", 0)
                               for line in f)
    rec = {
        "tag": f"{tag}_seg{seg + 1}x{args.steps_per_segment}",
        "epochs": args.epochs,
        "model": [args.embed, args.hidden, args.blocks, args.heads],
        "distill_steps": (seg + 1) * args.steps_per_segment,
        "distill_steps_actual": actual_steps,
        "max_bases": args.max_bases,
        "seed": args.seed,
        "mean_tv_to_target": round(res["mean_tv_to_target"], 5),
        "tv_shot_noise_floor": round(res["tv_shot_noise_floor"], 5),
        "meas_tv_to_target": round(res["meas_tv_to_target"], 5),
        "mean_marginal_error": round(res["mean_marginal_error"], 5),
        "classical_fidelity": round(res["classical_fidelity"], 5),
        "note": f"segmented distillation: {seg + 1} x "
                f"{args.steps_per_segment} steps",
        "wall_s": round(time.perf_counter() - t0, 1),
        "device": device_label(device),
    }
    append_row(args.out, rec)
    print(json.dumps(rec), flush=True)


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m ddqst_tpu_torch.campaigns.shadow_segments",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", default="dist_seg")
    ap.add_argument("--segments", type=int, default=4)
    for flag, kind, default in SHARED_FLAGS:
        ap.add_argument(f"--{flag}", type=kind, default=default)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default=os.path.join(REPO, "shadow_work"),
                    help="where the snapshots, the steps log and the caches "
                    "are kept")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="JSONL record the eval row is appended to")
    ap.add_argument("--start_segment", type=int, default=-1,
                    help="-1 = run the CE role first; >= 0 = resume the "
                    "distillation chain at this segment (the snapshot "
                    "before it must exist)")
    ap.add_argument("--data_cache", default="auto",
                    help="npz cache of the generated data, filled by a "
                    "datagen child when absent. 'auto' = "
                    "<workdir>/<tag>_data.npz; '' = each role generates")
    ap.add_argument("--segment_timeout", type=int, default=0,
                    help="end the campaign when a role's process runs "
                    "longer than this many seconds (0 = no limit)")
    ap.add_argument("--device", default="cuda",
                    help="torch device for every role (default cuda; "
                    "raises without one)")
    ap.add_argument("--child_role", default="",
                    choices=["", "datagen", "ce", "distill", "eval"],
                    help=argparse.SUPPRESS)
    ap.add_argument("--child_segment", type=int, default=0,
                    help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    if args.child_role:
        child(args)
        return 0
    from ddqst_tpu_torch.device import resolve_device

    resolve_device(args.device)  # no CUDA, no --device cpu: raise here
    os.makedirs(args.workdir, exist_ok=True)
    base = [sys.executable, "-m", "ddqst_tpu_torch.campaigns.shadow_segments",
            "--tag", args.tag, "--seed", str(args.seed),
            "--workdir", args.workdir, "--out", args.out,
            "--data_cache", args.data_cache, "--device", args.device]
    for flag, _, _ in SHARED_FLAGS:
        base += [f"--{flag}", str(getattr(args, flag))]
    # This driver's eval child reads the snapshot of its segment: the last.
    return run_roles(base, data_cache_path(args), args.start_segment,
                     args.segments, args.segments - 1, args.segment_timeout)


if __name__ == "__main__":
    sys.exit(main())
