"""Score a model snapshot on the exact chain distribution of every basis,
with no sampling noise: the counterpart of ``scripts/exact_rescore.py``.

    python -m ddqst_tpu_torch.campaigns.exact_rescore --tag TAG --params PT
        [--shots S] [--seed S] [--also_sampled] [--max_rows R] [--out FILE]
        [--device cuda|cpu]

The eval tail draws ``shots_infer`` samples a basis from the model and feeds
their histogram to the estimator, which adds a multinomial floor to the
fidelity. This scores the snapshot without it:
``ops.diffusion.chain_distribution_all_bases`` gives the sampler's exact
output distribution in each basis (``--max_rows`` grid rows a forward), and
``dist * shots`` goes to the estimator as fractional counts (MLE for
``reconstruction='mle'``, else linear inversion). ``--also_sampled`` also
scores one multinomial draw from the same distributions (numpy's generator
at ``--seed``): the gap between the two rows is the eval tail's own noise.

``--params`` is a ``torch.save`` state dict, as ``run_experiment(
params_save=)``, ``campaigns.segments`` and ``tools/flax_to_torch.py``
write them. The fidelity target is the campaign's: ``prep_circuit`` draws
the circuit from ``--seed`` as ``run_experiment`` does. Each row (the
script's keys and ``device``) is appended to ``--out`` and printed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ddqst_tpu_torch.campaigns import (RESULTS_DIR, append_row,
                                       device_label)

DEFAULT_OUT = os.path.join(RESULTS_DIR, "exact_rescore.jsonl")


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m ddqst_tpu_torch.campaigns.exact_rescore",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", required=True,
                    help="a tag of campaigns.scaling.experiments()")
    ap.add_argument("--params", required=True,
                    help="torch.save params snapshot of that experiment")
    ap.add_argument("--shots", type=int, default=0,
                    help="fractional-count scale (0 = the config's "
                    "shots_infer); the MLE fixed point does not depend on "
                    "it, --also_sampled's draw does")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--also_sampled", action="store_true",
                    help="also score one multinomial draw from the exact "
                    "distributions through the same estimator")
    ap.add_argument("--max_rows", type=int, default=1 << 14,
                    help="grid rows a chain-distribution forward")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="JSONL record the rows are appended to")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without one)")
    return ap.parse_args(argv)


def rescore(args: argparse.Namespace) -> list[dict]:
    """The rows of one snapshot (exact, then sampled if asked), appended to
    ``args.out``."""
    from ddqst_tpu_torch.campaigns.scaling import experiment
    from ddqst_tpu_torch.device import resolve_device, synchronize
    from ddqst_tpu_torch.models import build_model
    from ddqst_tpu_torch.ops import diffusion as diff
    from ddqst_tpu_torch.ops import metrics as M
    from ddqst_tpu_torch.ops import mle, pauli
    from ddqst_tpu_torch.ops.schedules import make_schedule
    from ddqst_tpu_torch.qsim import states
    from ddqst_tpu_torch.utils.checkpoint import restore_params

    device = resolve_device(args.device)
    cfg, _ = experiment(args.tag)
    n, t_steps = cfg.data.num_qubits, cfg.diffusion.num_timesteps
    shots = args.shots or cfg.data.shots_infer
    schedule = make_schedule(cfg.diffusion.schedule, t_steps, device)
    model = restore_params(
        args.params, build_model(cfg.model, n, t_steps).to(device)).eval()
    circuit = states.prep_circuit(cfg.data.state_type, n,
                                  cfg.data.rqc_depth,
                                  np.random.default_rng(args.seed))
    target = torch.from_numpy(states.circuit_statevector(circuit)).to(device)

    t0 = time.perf_counter()
    with torch.no_grad():
        dist = diff.chain_distribution_all_bases(
            model, n, schedule, exact=cfg.diffusion.exact,
            max_rows=args.max_rows)
    dist = dist.double()
    dist /= dist.sum(-1, keepdim=True)
    synchronize(device)
    t_dist = time.perf_counter() - t0
    print(f"[exact_rescore] chain distribution over {dist.shape[0]} bases "
          f"[{t_dist:.1f}s]", flush=True)

    def score(counts: torch.Tensor) -> tuple[float, ...]:
        c = counts.float()
        if cfg.data.reconstruction == "mle":
            rho = mle.make_mle(n, None, readout_p=0.0)(c)
        else:
            rho = pauli.make_counts_inverter(n, None)(c)
        pur, vn, _ = (float(x) for x in M.get_metrics(rho, n))
        return (float(M.state_fidelity(target, rho)), pur, vn,
                float(M.trace_distance(target, rho)))

    label = device_label(device)

    def row(kind: str, counts: torch.Tensor, **extra) -> dict:
        t0 = time.perf_counter()
        fid, pur, vn, td = score(counts)
        rec = {"tag": args.tag, "kind": kind, "params": args.params,
               "num_qubits": n, "shots_per_basis": shots,
               "fidelity": round(fid, 5), "purity": round(pur, 5),
               "vn_entropy": round(vn, 5), "trace_distance": round(td, 5),
               **extra, "wall_s": round(time.perf_counter() - t0, 1),
               "device": label}
        append_row(args.out, rec)
        print(f"[exact_rescore] {json.dumps(rec)}", flush=True)
        return rec

    rows = [row("exact_dist", dist * shots, dist_wall_s=round(t_dist, 1))]
    if args.also_sampled:
        rng = np.random.default_rng(args.seed)
        p = dist.cpu().numpy()
        sampled = np.stack([rng.multinomial(shots, q) for q in p])
        rows.append(row("sampled_from_dist",
                        torch.from_numpy(sampled).to(device)))
    return rows


def main(argv: list[str] | None = None) -> int:
    rescore(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
