"""Rebuild a campaign's MLE distillation target and its data cache, the
counterpart of ``scripts/make_mle_target.py``.

    python -m ddqst_tpu_torch.campaigns.mle_target --tag TAG [--seed S]
        [--workdir DIR] [--device cuda|cpu]

A campaign's workdir lies outside git, so its files can be lost. The target
is cheap to rebuild: one config and seed give the same data, and the MLE
projection of those counts is deterministic. This writes
``<workdir>/<tag>_data.npz`` (when absent) and ``<workdir>/<tag>_target.npz``
as a campaign's segment 0 would: the training counts (less the held-out
shots), MLE on them, then the estimate's Born probabilities over the bases
(``pipeline.distill_counts`` and ``pipeline.mle_born_target``, which
``run_experiment`` runs too). ``campaigns.segments`` calls
:func:`write_target` before its first segment. Model snapshots cannot be
rebuilt this way.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Callable

from ddqst_tpu_torch.campaigns import REPO
from ddqst_tpu_torch.config import ExperimentConfig


def data_path(workdir: str, tag: str) -> str:
    return os.path.join(workdir, f"{tag}_data.npz")


def target_path(workdir: str, tag: str) -> str:
    return os.path.join(workdir, f"{tag}_target.npz")


def write_target(cfg: ExperimentConfig, data_cache: str, path: str,
                 device, log_fn: Callable = print) -> str:
    """The MLE target of the data in ``data_cache`` under ``cfg``'s
    held-out split, written to ``path``; returns ``path``."""
    from ddqst_tpu_torch import pipeline

    t0 = time.perf_counter()
    data = pipeline.load_data_cache(data_cache, device)
    counts, _ = pipeline.distill_counts(data.bits,
                                        cfg.train.chain_val_fraction)
    iters: dict = {}
    target = pipeline.mle_born_target(counts, data.basis_labels, iters)
    pipeline.save_target(path, target)
    log_fn(f"[mle_target] wrote {path} shape={tuple(target.shape)} "
           f"({iters['target']} MLE iterations) "
           f"[{time.perf_counter() - t0:.1f}s]")
    return path


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m ddqst_tpu_torch.campaigns.mle_target",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", default="ghz8_mle_hot",
                    help="a tag of campaigns.scaling.experiments()")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", default=os.path.join(REPO, "frontier_work"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without one)")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    from ddqst_tpu_torch import pipeline
    from ddqst_tpu_torch.campaigns.scaling import experiment
    from ddqst_tpu_torch.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg, _ = experiment(args.tag)
    os.makedirs(args.workdir, exist_ok=True)
    dcache = data_path(args.workdir, args.tag)
    pipeline.ensure_data_cache(cfg, args.seed, dcache, device=device)
    write_target(cfg, dcache, target_path(args.workdir, args.tag), device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
