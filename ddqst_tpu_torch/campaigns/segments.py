"""Segmented distillation: a ladder rung's distillation split into segments,
each role a fresh child process, the counterpart of
``scripts/run_frontier_segments.py``.

    python -m ddqst_tpu_torch.campaigns.segments --tag TAG --segments K
        --steps_per_segment S [--start_segment I] [--workdir DIR]
        [--out FILE] [--data_cache auto|NPZ|''] [--accum A] [--lr_decay D]
        [--opt_chain] [--hard_frac F] [--chain_lr LR] [--ce_epochs E]
        [--steps_per_call C] [--segment_timeout SECONDS] [--device cuda|cpu]

The roles, in order, chained through ``torch.save`` snapshots in
``--workdir`` (``pipeline.run_experiment(params_load=, params_save=,
stop_after='distill')``):

- ``datagen`` (only when the data cache is absent): the data, from the
  seed, into ``--data_cache`` (``auto``: ``<workdir>/<tag>_data.npz``);
- ``ce``: the data and CE training only -> ``<tag>_ce_params.pt``;
- segment 0: warm start from the CE snapshot, the MLE target (cached to
  ``<tag>_target.npz``), then ``--steps_per_segment`` distillation steps
  -> ``<tag>_seg0_params.pt``;
- segment i: warm start from segment i-1, the cached target, the next
  steps -> ``<tag>_seg<i>_params.pt``;
- ``eval``: warm start from the last segment, no distillation, the
  generation and estimator tail, then one row appended to ``--out``.

Each segment salts the minibatch stream with its index
(``chain_key_salt``), so segments draw different bases; ``--lr_decay``
runs segment i at ``chain_lr * lr_decay**i``; ``--opt_chain`` carries the
Adam moments from segment to segment (``<tag>_seg<i>_opt.pt``). Each
segment appends its chain CE before and after to
``<tag>_segments.jsonl``. ``--start_segment I`` resumes at segment I (-1,
the default, starts with the CE role). A child that fails or outlives
``--segment_timeout`` ends the campaign with exit code 1 and the tail of
its standard error; nothing is retried and no later role runs.

A child whose role equals the environment variable ``DDQST_FAIL_ROLE``
raises before any work (the drivers' tests inject a failure this way).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

from ddqst_tpu_torch.campaigns import append_row, device_label
from ddqst_tpu_torch.campaigns.scaling import DEFAULT_OUT, experiment, row

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
FAIL_ENV = "DDQST_FAIL_ROLE"
STDERR_TAIL_LINES = 40


def snapshot(workdir: str, tag: str, seg: int, kind: str = "params") -> str:
    """The ``kind`` ('params' or 'opt') snapshot of segment ``seg`` (-1:
    the CE role)."""
    name = "ce" if seg < 0 else f"seg{seg}"
    return os.path.join(workdir, f"{tag}_{name}_{kind}.pt")


def data_cache_path(args: argparse.Namespace) -> str:
    if args.data_cache == "auto":
        return os.path.join(args.workdir, f"{args.tag}_data.npz")
    return args.data_cache


def child(args: argparse.Namespace) -> None:
    """One role, in this (fresh) process."""
    if os.environ.get(FAIL_ENV) == args.child_role:
        raise RuntimeError(f"injected failure in role {args.child_role!r} "
                           f"({FAIL_ENV})")
    from ddqst_tpu_torch import pipeline
    from ddqst_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    tag = args.tag
    cfg, note = experiment(tag)
    dcache = data_cache_path(args)
    if args.child_role == "datagen":
        pipeline.ensure_data_cache(cfg, args.seed, dcache, device=device)
        print("== datagen done", flush=True)
        return
    seg = args.child_segment
    # Segment 0 warm-starts from the CE snapshot when one exists.
    ce = snapshot(args.workdir, tag, -1)
    prev = (snapshot(args.workdir, tag, seg - 1)
            if seg > 0 or os.path.exists(ce) else "")
    tcache = os.path.join(args.workdir, f"{tag}_target.npz")
    steps_log = os.path.join(args.workdir, f"{tag}_segments.jsonl")
    if args.ce_epochs:
        cfg = cfg.replace(train=dataclasses.replace(
            cfg.train, num_epochs=args.ce_epochs))
    if args.child_role == "ce":
        cfg = cfg.replace(train=dataclasses.replace(
            cfg.train, chain_finetune_steps=0))
        pipeline.run_experiment(cfg, seed=args.seed, params_save=ce,
                                stop_after="distill", data_cache=dcache,
                                device=device)
        print("== ce segment done", flush=True)
        return
    if args.child_role == "distill":
        overrides = dict(
            chain_finetune_steps=args.steps_per_segment,
            chain_key_salt=cfg.train.chain_key_salt + seg,
            chain_accum=args.accum,
            chain_hard_frac=args.hard_frac,
        )
        if args.chain_lr or args.lr_decay != 1.0:
            base_lr = args.chain_lr or cfg.train.chain_lr
            overrides["chain_lr"] = base_lr * args.lr_decay**seg
        if args.steps_per_call:
            overrides["chain_steps_per_call"] = args.steps_per_call
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, **overrides))
        # Segment 0 (or a predecessor without an Adam snapshot) starts
        # fresh moments.
        prev_opt = (snapshot(args.workdir, tag, seg - 1, "opt")
                    if args.opt_chain and seg > 0 else "")
        if prev_opt and not os.path.exists(prev_opt):
            prev_opt = ""
        res = pipeline.run_experiment(
            cfg, seed=args.seed, params_load=prev,
            params_save=snapshot(args.workdir, tag, seg),
            target_cache=tcache, stop_after="distill", opt_load=prev_opt,
            opt_save=(snapshot(args.workdir, tag, seg, "opt")
                      if args.opt_chain else ""),
            data_cache=dcache, device=device)
        info = res.get("ft_info") or {}
        steps_run = (0 if res.get("ft_losses") is None
                     else len(res["ft_losses"]))
        with open(steps_log, "a") as f:
            f.write(json.dumps({
                "segment": seg, "steps_run": steps_run,
                "lr": cfg.train.chain_lr, "accum": args.accum,
                "hard_frac": args.hard_frac,
                "ce_before": info.get("train_ce_before"),
                "ce_after": info.get("train_ce_after"),
            }) + "\n")
        print(f"== segment {seg} done: chain CE "
              f"{info.get('train_ce_before', float('nan')):.5f} -> "
              f"{info.get('train_ce_after', float('nan')):.5f} "
              f"({steps_run} steps @ accum {args.accum})", flush=True)
        return
    # eval: no further distillation, the full tail.
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, chain_finetune_steps=0))
    t0 = time.perf_counter()
    res = pipeline.run_experiment(cfg, seed=args.seed, params_load=prev,
                                  data_cache=dcache, device=device)
    actual_steps = None
    if os.path.exists(steps_log):
        with open(steps_log) as f:
            actual_steps = sum(json.loads(line).get("steps_run", 0)
                               for line in f)
    rec = row(f"{tag}_seg{seg}x{args.steps_per_segment}", cfg,
              f"{note} [segmented: {seg} x {args.steps_per_segment}]", res,
              time.perf_counter() - t0, device_label(device))
    rec["distill_steps_actual"] = actual_steps
    append_row(args.out, rec)
    print(f"== {rec['tag']}: fidelity={rec['fidelity']} "
          f"raw={rec['raw_fidelity']} mle={rec['raw_fidelity_mitigated']} "
          f"[{rec['wall_s']}s]", flush=True)


def run_child(cmd: list[str], label: str, timeout: int) -> bool:
    """Run one role's process to its end (its standard output passes
    through); False, with the tail of its standard error printed, when it
    fails or outlives ``timeout`` seconds (0: no limit)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH", "")) if p)
    print(f"[segments] {label}: starting", flush=True)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, stderr=subprocess.PIPE, text=True,
                              env=env, timeout=timeout or None)
        err, why = proc.stderr, f"exit code {proc.returncode}"
        ok = proc.returncode == 0
    except subprocess.TimeoutExpired as e:
        err = e.stderr.decode() if isinstance(e.stderr, bytes) else (
            e.stderr or "")
        why, ok = f"killed after {timeout} s (--segment_timeout)", False
    sys.stderr.write(err)
    if ok:
        print(f"[segments] {label}: done [{time.perf_counter() - t0:.1f}s]",
              flush=True)
        return True
    tail = "\n".join(err.splitlines()[-STDERR_TAIL_LINES:])
    print(f"[segments] {label} FAILED ({why}); the tail of its stderr:\n"
          f"{tail}", flush=True)
    return False


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m ddqst_tpu_torch.campaigns.segments",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", default="ghz8_mle_hot",
                    help="a tag of campaigns.scaling.experiments()")
    ap.add_argument("--segments", type=int, default=6)
    ap.add_argument("--steps_per_segment", type=int, default=1600)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default=os.path.join(REPO, "frontier_work"),
                    help="where the snapshots and caches are kept")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="JSONL record the eval row is appended to")
    ap.add_argument("--start_segment", type=int, default=-1,
                    help="-1 = run the CE role first; >= 0 = resume an "
                    "interrupted campaign at this segment (segment 0 loads "
                    "the CE snapshot when present)")
    ap.add_argument("--ce_epochs", type=int, default=0,
                    help="override CE epochs for every role (0 = keep)")
    ap.add_argument("--chain_lr", type=float, default=0.0,
                    help="override the config's distillation lr (0 = keep)")
    ap.add_argument("--lr_decay", type=float, default=1.0,
                    help="geometric per-segment lr decay: segment i runs "
                    "at chain_lr * lr_decay**i")
    ap.add_argument("--accum", type=int, default=1,
                    help="gradient accumulation (chain_accum): each Adam "
                    "step averages accum disjoint basis minibatches")
    ap.add_argument("--steps_per_call", type=int, default=0,
                    help="override chain_steps_per_call (0 = keep config)")
    ap.add_argument("--hard_frac", type=float, default=0.0,
                    help="hard-basis mining (chain_hard_frac): mix this "
                    "fraction of excess-KL-proportional weight into each "
                    "segment's minibatch draw, measured from a full-grid "
                    "pass at segment entry")
    ap.add_argument("--opt_chain", action="store_true",
                    help="carry the distillation Adam moments across "
                    "segments")
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
    experiment(args.tag)  # an unknown tag raises before any child
    os.makedirs(args.workdir, exist_ok=True)
    base = [
        sys.executable, "-m", "ddqst_tpu_torch.campaigns.segments",
        "--tag", args.tag, "--seed", str(args.seed),
        "--workdir", args.workdir, "--out", args.out,
        "--steps_per_segment", str(args.steps_per_segment),
        "--ce_epochs", str(args.ce_epochs),
        "--chain_lr", str(args.chain_lr),
        "--lr_decay", str(args.lr_decay),
        "--accum", str(args.accum),
        "--steps_per_call", str(args.steps_per_call),
        "--hard_frac", str(args.hard_frac),
        "--data_cache", args.data_cache, "--device", args.device,
    ] + (["--opt_chain"] if args.opt_chain else [])
    dcache = data_cache_path(args)
    if dcache and not os.path.exists(dcache):
        if not run_child(base + ["--child_role", "datagen"], "datagen",
                         args.segment_timeout):
            return 1
    for seg in range(args.start_segment, args.segments + 1):
        if seg < 0:
            role, seg_arg = "ce", 0
        elif seg == args.segments:
            role, seg_arg = "eval", args.segments  # from the last segment
        else:
            role, seg_arg = "distill", seg
        if not run_child(base + ["--child_role", role, "--child_segment",
                                 str(seg_arg)], f"{role} segment {seg}",
                         args.segment_timeout):
            print(f"[segments] resume with --start_segment {seg}",
                  flush=True)
            return 1
    print("[segments] campaign complete", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
