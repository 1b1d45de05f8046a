"""Which mechanism escapes the distillation's minibatch noise floor: the
counterpart of ``scripts/diag_floor_escape.py``.

    python -m ddqst_tpu_torch.campaigns.diag_floor_escape [--out FILE]
        [--steps S] [--warm W] [--device cuda|cpu]

The JAX package's GHZ-8 chain parked about 0.011 nats above the target's
entropy floor, and neither more steps nor 4 accumulated minibatches moved
it. This reproduces the regime at GHZ-5 (4 bases a minibatch), parks the
chain at the floor with ``WARM`` steps at accum 4, then runs five escapes
at an equal budget of gradient evaluations (1,200 minibatches each):

- ``cont``: S steps at accum 4, lr 1e-3 (the control);
- ``lr3`` / ``lr10``: the same at lr / 3 and lr / 10;
- ``full``: S / 15 steps accumulating the whole grid (``accum=9999``,
  which ``finetune_chain`` clamps to ``num_bases // basis_batch``: 60
  minibatches, 240 of the 243 bases a step);
- ``avg``: ``cont``'s trajectory in 6 chunks with the Adam moments chained,
  scored as the Polyak average of the 6 snapshots
  (``campaigns.average_params.average``) by a forward-only call
  (``steps=0``).

The floor (the target's mean entropy) is recorded so every endpoint reads
as excess KL. The record (``--out``, default ``examples/results_torch/
diag_floor_escape.json``) has the script's keys (``floor``, ``warmup_ce``,
and ``{'ce_end', 'excess', 'delta'}`` an arm) and ``device``. The arms'
minibatches come from generators seeded ``0xF10E + salt``, not the
script's JAX keys (``campaigns.diag``).
"""

from __future__ import annotations

import sys
from typing import Callable

import numpy as np
import torch

from ddqst_tpu_torch.campaigns import diag
from ddqst_tpu_torch.campaigns.recipes import diag_cfg

S = 300     # steps an arm (at accum 4: 1,200 minibatches)
WARM = 600  # accum-4 steps that park the chain at the floor
SALT = 0xF10E
NAME = "diag5esc"
AVG_CHUNKS = 6


def entropy_floor(target_counts) -> float:
    """The target's mean entropy in nats (float64), the CE floor."""
    t = np.asarray(torch.as_tensor(target_counts).cpu(), np.float64)
    t = t / t.sum(-1, keepdims=True)
    return float(np.mean(-np.sum(t * np.log(np.maximum(t, 1e-300)),
                                 axis=-1)))


def arms(model0: torch.nn.Module, target, schedule, cfg, device, *,
         steps: int = S, warm: int = WARM,
         log_fn: Callable = print) -> dict:
    """The warm-up and the five escapes from ``model0`` against ``target``
    counts."""
    from ddqst_tpu_torch.campaigns.average_params import average

    floor = entropy_floor(target)
    log_fn(f"target mean entropy (CE floor) = {floor:.5f}")

    def distill(model, *, steps, salt, lr=diag.LR, accum=4, init_opt=None):
        return diag.distill(model, target, schedule, cfg, device,
                            steps=steps, salt=SALT + salt, lr=lr,
                            accum=accum, init_opt=init_opt)

    st_floor, _, iw = distill(model0, steps=warm, salt=0)
    log_fn(f"warmup: CE {iw['train_ce_before']:.5f} -> "
           f"{iw['train_ce_after']:.5f} (excess "
           f"{iw['train_ce_after'] - floor:.5f})")
    results = {"floor": floor, "warmup_ce": iw["train_ce_after"]}

    def report(arm, before, end):
        results[arm] = {"ce_end": end, "excess": end - floor,
                        "delta": before - end}
        log_fn(f"{arm}: CE {before:.5f} -> {end:.5f}  excess "
               f"{end - floor:.5f}")

    for arm, salt, lr in (("cont", 1, diag.LR), ("lr3", 2, diag.LR / 3),
                          ("lr10", 3, diag.LR / 10)):
        _, _, i = distill(st_floor, steps=steps, salt=salt, lr=lr)
        report(arm, i["train_ce_before"], i["train_ce_after"])
    _, _, i = distill(st_floor, steps=steps // 15, salt=4, accum=9999)
    report("full", i["train_ce_before"], i["train_ce_after"])

    st, opt, first, snaps = st_floor, None, None, []
    for c in range(AVG_CHUNKS):
        st, _, i = distill(st, steps=steps // AVG_CHUNKS, salt=5 + c,
                           init_opt=opt)
        opt = i["final_opt_state"]
        first = i["train_ce_before"] if first is None else first
        snaps.append({k: v.detach().clone()
                      for k, v in st.state_dict().items()})
    st.load_state_dict(average(snaps))
    _, _, i_avg = distill(st, steps=0, salt=99)
    report("avg", first, i_avg["train_ce_after"])
    return results


def run(bits: torch.Tensor, basis_idx, *, device: torch.device,
        generator: torch.Generator, steps: int = S, warm: int = WARM,
        epochs: int = 10, log_fn: Callable = print) -> dict:
    """The diagnostic on the data ``bits`` ``[B, S, N]`` of the canonical
    bases ``basis_idx``: CE training from ``generator``, then the arms
    against the data's counts."""
    from ddqst_tpu_torch.ops.mle import bits_to_counts

    cfg = diag_cfg(NAME, num_qubits=bits.shape[2], epochs=epochs)
    model0, schedule = diag.train_ce(cfg, bits, basis_idx, generator,
                                     device, log_fn)
    return arms(model0, bits_to_counts(bits.to(device)), schedule, cfg,
                device, steps=steps, warm=warm, log_fn=log_fn)


def main(argv: list[str] | None = None) -> int:
    return diag.main("diag_floor_escape", diag_cfg(NAME), run, argv,
                     __doc__, S, WARM)


if __name__ == "__main__":
    sys.exit(main())
