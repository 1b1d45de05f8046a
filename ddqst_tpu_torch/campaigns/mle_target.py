"""Rebuild a campaign's MLE distillation target and its data cache, the
counterpart of ``scripts/make_mle_target.py``.

    python -m ddqst_tpu_torch.campaigns.mle_target --tag TAG [--seed S]
        [--workdir DIR] [--device cuda|cpu]

A campaign's workdir lies outside git, so its files can be lost. The target
is cheap to rebuild: one config and seed give the same data, and the MLE
projection of those counts is deterministic. This writes
``<workdir>/<tag>_data.npz`` (when absent) and ``<workdir>/<tag>_target.npz``
as a campaign's segment 0 would: the training counts (less the held-out
shots, ``pipeline.distill_counts``), MLE on them, then the estimate's Born
probabilities over the bases (``pipeline.born_probs``), as
``run_experiment``'s ``pipeline.mle_born_target`` does. It logs the
estimate's own fidelity against the cache's clean state.
``campaigns.segments`` calls :func:`write_target` before its first segment.
Model snapshots cannot be rebuilt this way.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Callable

import torch

from ddqst_tpu_torch.campaigns import REPO
from ddqst_tpu_torch.config import ExperimentConfig


def data_path(workdir: str, tag: str) -> str:
    return os.path.join(workdir, f"{tag}_data.npz")


def target_path(workdir: str, tag: str) -> str:
    return os.path.join(workdir, f"{tag}_target.npz")


def write_target(cfg: ExperimentConfig, data_cache: str, path: str,
                 device, log_fn: Callable = print) -> dict:
    """The MLE target of the data in ``data_cache`` under ``cfg``'s
    held-out split, written to ``path``. Returns ``{'path', 'iterations',
    'fidelity', 'wall_s'}``: the solve's iterations and the estimate's own
    fidelity against the cache's clean state."""
    from ddqst_tpu_torch import pipeline
    from ddqst_tpu_torch.ops import metrics, mle

    t0 = time.perf_counter()
    data = pipeline.load_data_cache(data_cache, device)
    counts, _ = pipeline.distill_counts(data.bits,
                                        cfg.train.chain_val_fraction)
    solve: dict = {}
    rho = mle.make_mle(data.basis_labels.shape[1], data.basis_labels)(
        counts, solve)
    target = pipeline.born_probs(rho, data.basis_labels)
    pipeline.save_target(path, target)
    fid = float(metrics.state_fidelity(
        torch.from_numpy(data.target).to(rho.device), rho))
    out = dict(path=path, iterations=solve["iterations"], fidelity=fid,
               wall_s=time.perf_counter() - t0)
    log_fn(f"[mle_target] wrote {path} shape={tuple(target.shape)} "
           f"({out['iterations']} MLE iterations; the estimate's fidelity "
           f"{fid:.5f}) [{out['wall_s']:.1f}s]")
    return out


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


def run(args: argparse.Namespace) -> dict:
    """The data cache (when absent) and the target; ``write_target``'s
    record."""
    from ddqst_tpu_torch import pipeline
    from ddqst_tpu_torch.campaigns.scaling import experiment
    from ddqst_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    cfg, _ = experiment(args.tag)
    os.makedirs(args.workdir, exist_ok=True)
    dcache = data_path(args.workdir, args.tag)
    pipeline.ensure_data_cache(cfg, args.seed, dcache, device=device)
    return write_target(cfg, dcache, target_path(args.workdir, args.tag),
                        device)


def main(argv: list[str] | None = None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
