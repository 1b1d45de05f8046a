"""Average K params snapshots (offline Polyak / iterate averaging): the
counterpart of ``scripts/average_params.py``.

    python -m ddqst_tpu_torch.campaigns.average_params --out AVG.pt
        SNAP.pt [SNAP.pt ...] [--device cuda|cpu]

SGD at a minibatch noise floor bounces around the basin's centre; the
average of its iterates sits closer to it than any one iterate (Polyak-
Ruppert averaging). The segment snapshots of a segmented distillation
campaign (``campaigns.segments``) are such iterates: this averages them into
a new snapshot at no gradient cost, to be scored with
``campaigns.eval_chain_ce_subset`` or ``campaigns.exact_rescore``.

Snapshots are ``torch.save`` state dicts (``utils.checkpoint.save_params``);
every tensor is averaged in the script's order, ``(x_0 + x_1 + ...) / K``
summed left to right, on ``--device``.
"""

from __future__ import annotations

import argparse
import sys

import torch


def average(state_dicts: list[dict]) -> dict:
    """The mean of ``state_dicts`` tensor by tensor, summed left to right
    and divided by their count (the script's ``sum(xs[1:], xs[0]) /
    len(xs)``); every dict must have the same names."""
    names = state_dicts[0].keys()
    for sd in state_dicts[1:]:
        if sd.keys() != names:
            raise ValueError("the snapshots' tensor names differ")
    return {k: sum((sd[k] for sd in state_dicts[1:]), state_dicts[0][k])
            / len(state_dicts) for k in names}


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m ddqst_tpu_torch.campaigns.average_params",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("snaps", nargs="+", help="torch.save params snapshots")
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without one)")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    from ddqst_tpu_torch.device import resolve_device
    from ddqst_tpu_torch.utils.checkpoint import save_state_dict

    args = parse_args(argv)
    device = resolve_device(args.device)
    trees = [torch.load(p, map_location=device, weights_only=True)
             for p in args.snaps]
    save_state_dict(args.out, average(trees))
    print(f"averaged {len(trees)} snapshots -> {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
