"""Training loop for the denoiser: optimizers, epochs, EMA.

The port's counterpart of ``ddqst_tpu/train.py`` (``make_optimizer``,
``_run_epoch``, ``eval_loss``, ``fit``). Gradients come from autograd; the
optimizers are torch's with optax's hyper-parameters:

- ``adam``  — ``torch.optim.Adam`` (b1 0.9, b2 0.999, eps 1e-8): the same
  update as ``optax.adam``.
- ``adamw`` — ``torch.optim.AdamW`` with weight decay 1e-4, optax's default
  (torch's own default is 1e-2).
- ``sgd``   — plain ``torch.optim.SGD``.

``lr_schedule='cosine'`` is optax's ``warmup_cosine_decay_schedule``: a
linear warmup from 0 over ``total//20`` steps, then a cosine decay to
``0.02·lr`` at ``total``. Update k (from 0) uses the rate at step k.

Not ported yet: exact-chain distillation (``finetune_chain``, ROADMAP
Queue 1 item 4), checkpoints and resume (item 10), and data/model-parallel
meshes (item 10); each raises ``NotImplementedError``.
"""

from __future__ import annotations

import math
import time
from typing import Callable

import torch

from ddqst_tpu_torch.config import TrainConfig
from ddqst_tpu_torch.device import resolve_device
from ddqst_tpu_torch.models.d3pm import init_params_
from ddqst_tpu_torch.ops.diffusion import denoising_loss
from ddqst_tpu_torch.ops.schedules import DiffusionSchedule

_ADAMW_WEIGHT_DECAY = 1e-4  # optax.adamw's default


def make_lr_schedule(
    cfg: TrainConfig, total_steps: int | None = None
) -> Callable[[int], float]:
    """Learning rate as a function of the update count (0-based)."""
    peak = cfg.learning_rate
    if cfg.lr_schedule != "cosine" or not total_steps:
        return lambda step: peak
    warmup = max(total_steps // 20, 1)
    alpha = 0.02
    decay = total_steps - warmup

    def lr(step: int) -> float:
        if step < warmup:
            return peak * step / warmup
        if decay <= 0:
            return peak
        frac = min(step - warmup, decay) / decay
        return peak * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * frac))
                       + alpha)

    return lr


def make_optimizer(cfg: TrainConfig, params) -> torch.optim.Optimizer:
    if cfg.optimizer == "adamw":
        return torch.optim.AdamW(params, lr=cfg.learning_rate,
                                 weight_decay=_ADAMW_WEIGHT_DECAY)
    if cfg.optimizer == "adam":
        return torch.optim.Adam(params, lr=cfg.learning_rate)
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(params, lr=cfg.learning_rate)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


def _run_epoch(
    model: torch.nn.Module,
    opt: torch.optim.Optimizer,
    lr_fn: Callable[[int], float],
    step0: int,
    generator: torch.Generator,
    bits: torch.Tensor,
    basis: torch.Tensor,
    schedule: DiffusionSchedule,
    batch_size: int,
    t_max: int = 0,
) -> tuple[torch.Tensor, int]:
    """One epoch: a fresh permutation, full batches only (the remainder is
    dropped), one optimizer update per batch.

    Returns (mean loss as a device scalar, number of updates).
    """
    m = bits.shape[0]
    batch_size = min(batch_size, m)  # datasets smaller than one batch
    steps = max(m // batch_size, 1)
    perm = torch.randperm(m, generator=generator, device=bits.device)
    perm = perm[: steps * batch_size].reshape(steps, batch_size)
    losses = []
    for i in range(steps):
        idx = perm[i]
        loss = denoising_loss(generator, model, bits[idx], basis[idx],
                              schedule, t_max=t_max)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        for group in opt.param_groups:
            group["lr"] = lr_fn(step0 + i)
        opt.step()
        losses.append(loss.detach())
    return torch.stack(losses).mean(), steps


@torch.no_grad()
def eval_loss(
    model: torch.nn.Module,
    generator: torch.Generator,
    bits: torch.Tensor,
    basis: torch.Tensor,
    schedule: DiffusionSchedule,
    batch_size: int,
) -> torch.Tensor:
    """Mean denoising CE over an eval set, in full batches (no gradient)."""
    m = bits.shape[0]
    batch_size = min(batch_size, m)
    steps = max(m // batch_size, 1)
    losses = [
        denoising_loss(generator, model, bits[i * batch_size:(i + 1) * batch_size],
                       basis[i * batch_size:(i + 1) * batch_size], schedule)
        for i in range(steps)
    ]
    return torch.stack(losses).mean()


def fit(
    generator: torch.Generator,
    model: torch.nn.Module,
    bits: torch.Tensor,
    basis: torch.Tensor,
    cfg: TrainConfig,
    schedule: DiffusionSchedule,
    eval_bits: torch.Tensor | None = None,
    eval_basis: torch.Tensor | None = None,
    mesh=None,
    log_fn: Callable = print,
    device: str | torch.device | None = None,
) -> tuple[torch.nn.Module, torch.Tensor]:
    """Full training run. Returns (model, per-epoch mean losses ``[E]``).

    The model's parameters are re-drawn from flax's initialisers with
    ``generator`` (as the JAX package's ``fit`` creates its params), then
    trained on ``device`` (default CUDA; raises if CUDA is absent and
    ``device`` was not given). ``generator`` lives on that device and drives
    the initialisation, the permutations, the timesteps and the noise.
    """
    dev = resolve_device(device)
    if mesh is not None or cfg.data_axis != 1 or cfg.model_axis != 1:
        raise NotImplementedError(
            "multi-device training is not ported yet (ROADMAP Queue 1 item 10)"
        )
    if cfg.checkpoint_dir or cfg.resume:
        raise NotImplementedError(
            "training checkpoints are not ported yet (ROADMAP Queue 1 item 10)"
        )
    if resolve_device(generator.device) != dev:
        raise ValueError(f"generator on {generator.device}, expected {dev}")
    model.to(dev)
    init_params_(model, generator)
    schedule = schedule.to(dev)
    bits = bits.to(dev, torch.int8)
    basis = basis.to(dev, torch.int64)
    steps_per_epoch = max(bits.shape[0] // cfg.batch_size, 1)
    lr_fn = make_lr_schedule(cfg, steps_per_epoch * cfg.num_epochs)
    opt = make_optimizer(cfg, model.parameters())

    params = list(model.parameters())
    ema = None
    ema_epochs = 0
    losses = []
    step = 0
    t_start = time.perf_counter()
    model.train()
    for epoch in range(cfg.num_epochs):
        loss, n = _run_epoch(model, opt, lr_fn, step, generator, bits, basis,
                             schedule, cfg.batch_size, t_max=cfg.t_max)
        step += n
        if cfg.ema_decay > 0:
            # Zero-initialised EMA, debiased at the end (Adam-style), so the
            # nearly untrained first epochs never dominate a long run.
            d = cfg.ema_decay
            with torch.no_grad():
                if ema is None:
                    ema = [torch.zeros_like(p) for p in params]
                for e, p in zip(ema, params):
                    e.mul_(d).add_(p, alpha=1.0 - d)
            ema_epochs += 1
        losses.append(loss)
        if cfg.log_every and (epoch + 1) % cfg.log_every == 0:
            log_fn(
                f"epoch {epoch + 1}/{cfg.num_epochs}: "
                f"loss {float(loss):.4f} "
                f"({(epoch + 1) / (time.perf_counter() - t_start):.2f} ep/s)"
            )
        if (eval_bits is not None and cfg.eval_every
                and (epoch + 1) % cfg.eval_every == 0):
            vl = eval_loss(model, generator, eval_bits.to(dev, torch.int8),
                           eval_basis.to(dev, torch.int64), schedule,
                           cfg.batch_size)
            log_fn(f"  val loss {float(vl):.4f}")
    if ema is not None:
        debias = 1.0 / (1.0 - cfg.ema_decay**ema_epochs)
        with torch.no_grad():
            for e, p in zip(ema, params):
                p.copy_(e * debias)
    model.eval()
    return model, torch.stack(losses) if losses else torch.zeros(0)
