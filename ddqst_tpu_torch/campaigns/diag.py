"""What the three GHZ-5 distillation diagnostics share
(``campaigns.diag_segment_descent``, ``diag_floor_escape`` and
``diag_hard_mining``): their data and CE training as the scripts make them,
a distillation arm through ``train.finetune_chain``, and their record.

The scripts draw each arm's minibatches from ``fold_in(k_train, SALT +
salt)``; the port seeds a ``torch.Generator`` with ``SALT + salt``. The
streams differ, so an arm's minibatches (and numbers) are the port's own;
the deterministic parts (the data's entropy floor, a step given JAX's
draw, the full-grid profiles) are held to the JAX package's on its data.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Callable

import numpy as np
import torch

from ddqst_tpu_torch.config import ExperimentConfig

# The scripts' shared regime: 4 bases a minibatch (1.6% of GHZ-5's 243 a
# step, GHZ-8's 64 of 6,561 being 1%) and the campaign's chain_lr. Their
# steps_per_call only spaces held-out checks in the port, and the
# diagnostics make none.
BASIS_BATCH = 4
LR = 1e-3


def make_data(cfg: ExperimentConfig, device: torch.device):
    """The scripts' data (seed 0: the circuit and bases from
    ``default_rng(0)``, the shots from the port's data stream of seed 0)
    and the training stream, ``(data, train_generator)``."""
    from ddqst_tpu_torch import pipeline

    g_data, g_train, _ = pipeline._generators(0, device)
    data = pipeline.generate_training_data(cfg, g_data,
                                           np.random.default_rng(0))
    return data, g_train


def train_ce(cfg: ExperimentConfig, bits: torch.Tensor, basis_idx,
             generator: torch.Generator, device: torch.device,
             log_fn: Callable = print):
    """The CE-trained denoiser (``train.fit`` from ``generator``) and the
    schedule, on ``device``."""
    import time

    from ddqst_tpu_torch import pipeline
    from ddqst_tpu_torch.models import build_model
    from ddqst_tpu_torch.ops.schedules import make_schedule
    from ddqst_tpu_torch.train import fit

    n, t_steps = cfg.data.num_qubits, cfg.diffusion.num_timesteps
    x, basis = pipeline.flatten_for_training(bits.to(device),
                                             np.asarray(basis_idx))
    schedule = make_schedule(cfg.diffusion.schedule, t_steps, device)
    t0 = time.perf_counter()
    model, _ = fit(generator, build_model(cfg.model, n, t_steps).to(device),
                   x, basis, cfg.train, schedule, log_fn=lambda m: None,
                   device=device)
    log_fn(f"CE training done ({time.perf_counter() - t0:.0f}s)")
    return model, schedule


def distill(model: torch.nn.Module, target, schedule,
            cfg: ExperimentConfig, device: torch.device, *, steps: int,
            salt: int, lr: float = LR, accum: int = 1, init_opt=None,
            hard_frac: float = 0.0):
    """One arm: ``finetune_chain`` on a copy of ``model`` (which stays as
    it is), its minibatches from a generator seeded ``salt``. Returns
    ``finetune_chain``'s ``(model, losses, info)``."""
    from ddqst_tpu_torch.train import finetune_chain

    return finetune_chain(
        copy.deepcopy(model), target, schedule, cfg.data.num_qubits,
        steps=steps, learning_rate=lr, exact=cfg.diffusion.exact,
        basis_batch=BASIS_BATCH,
        generator=torch.Generator(device=device).manual_seed(salt),
        accum=accum, init_opt_state=init_opt, hard_frac=hard_frac,
        device=device)


def write_record(path: str, results: dict, device: torch.device) -> str:
    """``results`` with ``device`` as the JSON record at ``path``."""
    from ddqst_tpu_torch.campaigns import device_label

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(dict(results, device=device_label(device)), f, indent=1)
    return path


def main(module: str, cfg: ExperimentConfig, run: Callable,
         argv: list[str] | None, doc: str, steps: int,
         warm: int | None = None) -> int:
    """A diagnostic's entry point: ``--out`` (default
    ``examples/results_torch/<module>.json``), ``--steps`` (default
    ``steps``, the script's S), ``--warm`` where the script parks the chain
    first (default ``warm``, its WARM) and ``--device``; ``cfg``'s data as
    the script makes it, then ``run(bits, basis_idx, device=, generator=,
    steps=[, warm=])``."""
    import argparse

    from ddqst_tpu_torch.campaigns import RESULTS_DIR
    from ddqst_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(
        prog=f"python -m ddqst_tpu_torch.campaigns.{module}",
        description=doc.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(RESULTS_DIR,
                                                  f"{module}.json"))
    ap.add_argument("--steps", type=int, default=steps,
                    help=f"steps an arm or segment (the script's {steps})")
    if warm is not None:
        ap.add_argument("--warm", type=int, default=warm,
                        help=f"steps that park the chain at the floor (the "
                        f"script's {warm})")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without one)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    data, g_train = make_data(cfg, device)
    depth = dict(steps=args.steps)
    if warm is not None:
        depth["warm"] = args.warm
    results = run(data.bits, data.basis_idx, device=device,
                  generator=g_train,
                  log_fn=lambda m: print(f"[diag] {m}", flush=True), **depth)
    print(f"[diag] wrote {write_record(args.out, results, device)}",
          flush=True)
    return 0
