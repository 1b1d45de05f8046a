"""The excess KL of GHZ-8 snapshots on three basis sectors: the
counterpart of ``scripts/ghz8_sector_profile.py``.

    python -m ddqst_tpu_torch.campaigns.ghz8_sector_profile SNAP.pt
        [SNAP.pt ...] [--tag TAG] [--target NPZ] [--workdir DIR]
        [--bases R] [--chunk C] [--seed S] [--out FILE] [--device cuda|cpu]

One row a (snapshot, sector): the chain's excess KL over the MLE target
(``campaigns.eval_chain_ce_subset.chain_excess``) on

- ``random``: ``--bases`` uniformly drawn bases (the bulk);
- ``low_ent``: the ``--bases`` lowest-entropy bases (the Z-sector
  populations);
- ``xy``: ``--bases`` all-X/Y bases (the coherence-phase sector, where
  the residual of the JAX package's GHZ-8 campaign lay).

The ``random`` and ``xy`` draws share one ``default_rng(--seed)``, in that
order. Each row has the script's keys (``snap``, the snapshot's file name;
``sector``, ``bases``, ``excess_mean``, ``excess_q50``, ``excess_max``,
``wall_s``) and ``device``; it is appended to ``--out`` and printed.
``--target`` defaults to ``campaigns.mle_target.target_path(--workdir,
--tag)``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from ddqst_tpu_torch.campaigns import (REPO, RESULTS_DIR, append_row,
                                       device_label)

DEFAULT_OUT = os.path.join(RESULTS_DIR, "ghz8_sector_excess.jsonl")


def sectors(tgt: np.ndarray, num_qubits: int, bases: int,
            seed: int) -> dict[str, np.ndarray]:
    """The three sectors' sorted basis indices, drawn in the script's
    order."""
    from ddqst_tpu_torch.campaigns.eval_chain_ce_subset import entropy
    from ddqst_tpu_torch.ops.pauli import all_basis_labels

    rng = np.random.default_rng(seed)
    xy_pool = np.where((all_basis_labels(num_qubits) != 2).all(axis=1))[0]
    return {
        "random": np.sort(rng.choice(tgt.shape[0], size=bases,
                                     replace=False)),
        "low_ent": np.sort(np.argsort(entropy(tgt))[:bases]),
        "xy": np.sort(rng.choice(xy_pool, size=min(bases, xy_pool.size),
                                 replace=False)),
    }


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m ddqst_tpu_torch.campaigns.ghz8_sector_profile",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("snaps", nargs="+", help="torch.save params snapshots")
    ap.add_argument("--tag", default="ghz8_mle_hot")
    ap.add_argument("--target", default=None,
                    help="target npz (default: <workdir>/<tag>_target.npz)")
    ap.add_argument("--workdir", default=os.path.join(REPO, "frontier_work"))
    ap.add_argument("--bases", type=int, default=48)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without one)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> list[dict]:
    """The rows of every (snapshot, sector), appended to ``args.out``."""
    from ddqst_tpu_torch.campaigns.eval_chain_ce_subset import (
        chain_excess, load_model, load_target)
    from ddqst_tpu_torch.campaigns.mle_target import target_path
    from ddqst_tpu_torch.campaigns.scaling import experiment
    from ddqst_tpu_torch.device import resolve_device, synchronize
    from ddqst_tpu_torch.ops.schedules import make_schedule

    device = resolve_device(args.device)
    cfg, _ = experiment(args.tag)
    schedule = make_schedule(cfg.diffusion.schedule,
                             cfg.diffusion.num_timesteps, device)
    tgt = load_target(args.target or target_path(args.workdir, args.tag))
    secs = sectors(tgt, cfg.data.num_qubits, args.bases, args.seed)
    label = device_label(device)
    rows = []
    for snap in args.snaps:
        model = load_model(cfg, snap, device)
        for sector, bidx in secs.items():
            t0 = time.perf_counter()
            exc = chain_excess(model, schedule, cfg, tgt[bidx], bidx,
                               args.chunk)
            synchronize(device)
            rec = {
                "snap": os.path.basename(snap), "sector": sector,
                "bases": int(len(bidx)),
                "excess_mean": round(float(exc.mean()), 6),
                "excess_q50": round(float(np.percentile(exc, 50)), 6),
                "excess_max": round(float(exc.max()), 6),
                "wall_s": round(time.perf_counter() - t0, 1),
                "device": label,
            }
            append_row(args.out, rec)
            print(json.dumps(rec), flush=True)
            rows.append(rec)
    return rows


def main(argv: list[str] | None = None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
