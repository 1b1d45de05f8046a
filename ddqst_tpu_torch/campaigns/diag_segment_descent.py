"""Why a segmented distillation stops descending at the segment boundary:
the counterpart of ``scripts/diag_segment_descent.py``.

    python -m ddqst_tpu_torch.campaigns.diag_segment_descent [--out FILE]
        [--steps S] [--device cuda|cpu]

The JAX package's GHZ-8 campaign lowered the chain CE by 0.00784 in its
first segment but by 0.00057 in the second, at the same steps, learning
rate and coverage. Two mechanisms could explain it: (a) the Adam moments
reset at the boundary (the driver chained only the parameters), or (b) the
minibatch-gradient noise floor, reached within the first segment at about
1% basis coverage a step. This reproduces the regime at GHZ-5 (243 bases,
4 a minibatch) and measures the full-grid chain CE deltas a segment under
five protocols, all from the same CE-trained model:

- ``single``: one 2S-step ``finetune_chain`` call (no boundary);
- ``params``: 2 × S steps, only the parameters chained;
- ``optchain``: 2 × S steps, the Adam moments chained too
  (``init_opt_state``);
- ``accum4``: as ``optchain`` with 4 minibatches accumulated a step;
- ``lrdecay``: 2 × S steps, a fresh optimiser, segment 2 at lr / 3.

The record (``--out``, default ``examples/results_torch/
diag_segment_descent.json``) has the script's keys, ``{arm: {'deltas',
'ce'}}``, and ``device``. The arms' minibatches come from generators seeded
``0xD157 + salt``, not the script's JAX keys (``campaigns.diag``).
"""

from __future__ import annotations

import sys
from typing import Callable

import torch

from ddqst_tpu_torch.campaigns import diag
from ddqst_tpu_torch.campaigns.recipes import diag_cfg

S = 300  # steps a segment
SALT = 0xD157
NAME = "diag5"


def arms(model0: torch.nn.Module, target, schedule, cfg, device, *,
         steps: int = S, log_fn: Callable = print) -> dict:
    """The five protocols from ``model0`` against ``target`` counts."""
    def distill(model, *, steps, salt, lr=diag.LR, accum=1, init_opt=None):
        return diag.distill(model, target, schedule, cfg, device,
                            steps=steps, salt=SALT + salt, lr=lr,
                            accum=accum, init_opt=init_opt)

    results = {}

    def report(arm, deltas, ce_path):
        results[arm] = {"deltas": deltas, "ce": ce_path}
        log_fn(f"{arm}: CE {' -> '.join(f'{c:.5f}' for c in ce_path)}"
               f"  deltas {['%.5f' % d for d in deltas]}")

    def two(first: dict, second: dict):
        return ([first["train_ce_before"] - first["train_ce_after"],
                 second["train_ce_before"] - second["train_ce_after"]],
                [first["train_ce_before"], first["train_ce_after"],
                 second["train_ce_after"]])

    _, losses, info = distill(model0, steps=2 * steps, salt=1)
    report("single", [info["train_ce_before"] - info["train_ce_after"]],
           [info["train_ce_before"], info["train_ce_after"]])
    # The mean minibatch loss over a window estimates the full-grid CE.
    window = min(50, steps)
    log_fn(f"single loss-window proxies: mid "
           f"{float(losses[steps - window:steps].mean()):.5f} end "
           f"{float(losses[-window:].mean()):.5f}")

    st1, _, i1 = distill(model0, steps=steps, salt=1)
    _, _, i2 = distill(st1, steps=steps, salt=2)
    report("params", *two(i1, i2))

    st1, _, i1 = distill(model0, steps=steps, salt=1)
    _, _, i2 = distill(st1, steps=steps, salt=2,
                       init_opt=i1["final_opt_state"])
    report("optchain", *two(i1, i2))

    st1, _, i1 = distill(model0, steps=steps, salt=1, accum=4)
    _, _, i2 = distill(st1, steps=steps, salt=2, accum=4,
                       init_opt=i1["final_opt_state"])
    report("accum4", *two(i1, i2))

    st1, _, i1 = distill(model0, steps=steps, salt=1)
    _, _, i2 = distill(st1, steps=steps, salt=2, lr=diag.LR / 3)
    report("lrdecay", *two(i1, i2))
    return results


def run(bits: torch.Tensor, basis_idx, *, device: torch.device,
        generator: torch.Generator, steps: int = S, epochs: int = 10,
        log_fn: Callable = print) -> dict:
    """The diagnostic on the data ``bits`` ``[B, S, N]`` of the canonical
    bases ``basis_idx``: CE training from ``generator``, then the arms
    against the data's counts."""
    from ddqst_tpu_torch.ops.mle import bits_to_counts

    cfg = diag_cfg(NAME, num_qubits=bits.shape[2], epochs=epochs)
    model0, schedule = diag.train_ce(cfg, bits, basis_idx, generator,
                                     device, log_fn)
    return arms(model0, bits_to_counts(bits.to(device)), schedule, cfg,
                device, steps=steps, log_fn=log_fn)


def main(argv: list[str] | None = None) -> int:
    return diag.main("diag_segment_descent", diag_cfg(NAME), run, argv,
                     __doc__, S)


if __name__ == "__main__":
    sys.exit(main())
