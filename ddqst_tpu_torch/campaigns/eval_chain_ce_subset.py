"""A snapshot's chain CE on a subset of the bases, read as excess KL over
the target's entropy: the counterpart of ``scripts/eval_chain_ce_subset.py``.

    python -m ddqst_tpu_torch.campaigns.eval_chain_ce_subset SNAP.pt
        [SNAP.pt ...] --target NPZ [--tag TAG] [--bases R] [--chunk C]
        [--seed S] [--lowest | --no_z] [--device cuda|cpu]

The chain is independent per basis, so the mean CE over R bases drawn
uniformly (numpy's ``default_rng(--seed)``) estimates the full-grid chain CE
with an error of about 1/sqrt(R). ``--lowest`` takes the R lowest-entropy
target bases instead (the Z sector, where GHZ's coherence structure
concentrates), ``--no_z`` draws only from the all-X/Y bases (the 2^N
coherence-phase bases). ``--bases 3^N`` with neither is the full grid.

The model and schedule are ``--tag``'s in ``campaigns.scaling.experiments()``;
snapshots are ``torch.save`` state dicts. The target npz holds ``target``,
``[3^N, 2^N]`` probabilities (``campaigns.mle_target`` writes it). Each
snapshot prints one line: its CE, the mean excess and the per-basis excess
quantiles. :func:`chain_excess` is the per-basis excess that
``campaigns.ghz8_sector_profile`` and ``campaigns.diag_hard_mining`` also
use.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ddqst_tpu_torch.config import ExperimentConfig


def load_target(path: str) -> np.ndarray:
    """The target npz's rows in float64, each normalised to sum 1."""
    with np.load(path) as z:
        tgt = z["target"].astype(np.float64)
    return tgt / tgt.sum(-1, keepdims=True)


def entropy(rows: np.ndarray) -> np.ndarray:
    """Each row's entropy in nats (float64), 0·log 0 taken as 0."""
    return -np.sum(rows * np.log(np.maximum(rows, 1e-300)), axis=-1)


def select_bases(tgt: np.ndarray, num_qubits: int, bases: int, seed: int,
                 lowest: bool = False, no_z: bool = False) -> np.ndarray:
    """The sorted basis indices the script evaluates (its draws, in its
    order, from ``default_rng(seed)``)."""
    from ddqst_tpu_torch.ops.pauli import all_basis_labels

    rng = np.random.default_rng(seed)
    if lowest:
        return np.sort(np.argsort(entropy(tgt))[:bases])
    if no_z:
        labels = all_basis_labels(num_qubits)
        pool = np.where((labels != 2).all(axis=1))[0]  # 0=X, 1=Y: no Z
        return np.sort(rng.choice(pool, size=min(bases, pool.size),
                                  replace=False))
    return np.sort(rng.choice(tgt.shape[0], size=bases, replace=False))


def chain_excess(model: torch.nn.Module, schedule, cfg: ExperimentConfig,
                 target_rows: np.ndarray, bidx: np.ndarray,
                 chunk: int) -> np.ndarray:
    """Per-basis KL(target || chain) of ``model``'s exact chain on the
    canonical bases ``bidx``: the chain CE against ``target_rows``
    (``[len(bidx), 2^N]`` float64, normalised; cast to float32, the chain
    floored at 1e-12, ``chunk`` bases a forward) less each row's entropy
    (float64). Runs on the schedule's device."""
    from ddqst_tpu_torch.ops.diffusion import chain_distribution

    dev = schedule.betas.device
    n = cfg.data.num_qubits
    parts = []
    with torch.no_grad():
        for i in range(0, len(bidx), chunk):
            tgt = torch.as_tensor(target_rows[i:i + chunk], dtype=torch.float32,
                                  device=dev)
            dist = chain_distribution(
                model, n, schedule, cfg.diffusion.exact,
                basis_idx=torch.as_tensor(bidx[i:i + chunk], device=dev))
            parts.append((-(tgt * torch.log(dist.clamp_min(1e-12))).sum(-1))
                         .cpu().numpy())
    return np.concatenate(parts) - entropy(target_rows)


def load_model(cfg: ExperimentConfig, path: str, device: torch.device):
    """``cfg``'s denoiser on ``device`` with the snapshot's parameters."""
    from ddqst_tpu_torch.models import build_model
    from ddqst_tpu_torch.utils.checkpoint import restore_params

    model = build_model(cfg.model, cfg.data.num_qubits,
                        cfg.diffusion.num_timesteps).to(device)
    return restore_params(path, model).eval()


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m ddqst_tpu_torch.campaigns.eval_chain_ce_subset",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("snaps", nargs="+", help="torch.save params snapshots")
    ap.add_argument("--tag", default="ghz8_mle_hot",
                    help="a tag of campaigns.scaling.experiments() (model, "
                    "schedule)")
    ap.add_argument("--target", required=True,
                    help="target npz ([3^N, 2^N] probabilities)")
    ap.add_argument("--bases", type=int, default=96)
    ap.add_argument("--chunk", type=int, default=16,
                    help="bases a chain forward")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--lowest", action="store_true",
                    help="the --bases lowest-entropy target bases instead "
                    "of a random draw")
    ap.add_argument("--no_z", action="store_true",
                    help="draw only from the all-X/Y bases")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without one)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace, log_fn=print) -> list[dict]:
    """Each snapshot's subset CE: ``{'snap', 'bases', 'ce', 'excess',
    'excess_per_basis', 'q50', 'q90', 'q99', 'max', 'wall_s'}``."""
    from ddqst_tpu_torch.campaigns.scaling import experiment
    from ddqst_tpu_torch.device import resolve_device, synchronize
    from ddqst_tpu_torch.ops.schedules import make_schedule

    device = resolve_device(args.device)
    cfg, _ = experiment(args.tag)
    n = cfg.data.num_qubits
    schedule = make_schedule(cfg.diffusion.schedule,
                             cfg.diffusion.num_timesteps, device)
    tgt = load_target(args.target)
    bidx = select_bases(tgt, n, args.bases, args.seed, args.lowest,
                        args.no_z)
    sub = tgt[bidx]
    floor = float(np.mean(entropy(sub)))
    log_fn(f"[subset] {len(bidx)} bases, subset entropy floor {floor:.5f}")
    out = []
    for snap in args.snaps:
        model = load_model(cfg, snap, device)
        t0 = time.perf_counter()
        exc = chain_excess(model, schedule, cfg, sub, bidx, args.chunk)
        synchronize(device)
        wall = time.perf_counter() - t0
        q = np.percentile(exc, [50, 90, 99, 100])
        log_fn(f"[subset] {snap}: CE {float(exc.mean()) + floor:.5f}  "
               f"excess {exc.mean():.5f}  per-basis KL q50/q90/q99/max "
               f"{q[0]:.4f}/{q[1]:.4f}/{q[2]:.4f}/{q[3]:.4f} ({wall:.0f}s)")
        out.append(dict(snap=snap, bases=bidx, ce=float(exc.mean()) + floor,
                        excess=float(exc.mean()), excess_per_basis=exc,
                        q50=q[0], q90=q[1], q99=q[2], max=q[3], wall_s=wall))
    return out


def main(argv: list[str] | None = None) -> int:
    run(parse_args(argv), log_fn=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
