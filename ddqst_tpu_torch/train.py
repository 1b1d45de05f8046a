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

``finetune_chain`` is exact-chain distillation: Adam (as ``optax.adam``:
no weight decay, eps outside the root) on the cross-entropy between the
sampler's exact output distribution
(``ops.diffusion.chain_distribution``) and the training counts.

``fit`` checkpoints its training state every ``checkpoint_every`` epochs
and at the end, and resumes from the newest checkpoint
(``utils.checkpoint``). With a ``parallel.mesh.Mesh`` it trains data- and
tensor-parallel, one process a rank.
"""

from __future__ import annotations

import math
import time
from typing import Callable

import numpy as np
import torch

from ddqst_tpu_torch.config import TrainConfig
from ddqst_tpu_torch.device import resolve_device
from ddqst_tpu_torch.models.d3pm import init_params_
from ddqst_tpu_torch.ops.diffusion import chain_distribution, denoising_loss
from ddqst_tpu_torch.ops.schedules import DiffusionSchedule
from ddqst_tpu_torch.parallel import mesh as pm
from ddqst_tpu_torch.parallel import tensor as tp
from ddqst_tpu_torch.utils import checkpoint as ckpt

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
    mesh: pm.Mesh | None = None,
) -> tuple[torch.Tensor, int]:
    """One epoch: a fresh permutation, full batches only (the remainder is
    dropped), one optimizer update per batch.

    With a mesh every rank draws the same permutation, ``t`` and noise for
    the whole batch, takes the loss on its data rank's rows and averages
    the gradients (:func:`average_gradients`). Returns (mean loss as a
    device scalar, this rank's with a mesh; number of updates).
    """
    m = bits.shape[0]
    batch_size = min(batch_size, m)  # datasets smaller than one batch
    steps = max(m // batch_size, 1)
    perm = torch.randperm(m, generator=generator, device=bits.device)
    perm = perm[: steps * batch_size].reshape(steps, batch_size)
    rows = None
    if mesh is not None:
        part = batch_size // mesh.shape[pm.DATA_AXIS]
        rows = slice(mesh.coords[0] * part, (mesh.coords[0] + 1) * part)
    losses = []
    for i in range(steps):
        idx = perm[i]
        loss = denoising_loss(generator, model, bits[idx], basis[idx],
                              schedule, t_max=t_max, rows=rows)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if mesh is not None:
            average_gradients(mesh, model)
        for group in opt.param_groups:
            group["lr"] = lr_fn(step0 + i)
        opt.step()
        losses.append(loss.detach())
    return torch.stack(losses).mean(), steps


def average_gradients(mesh: pm.Mesh, model: torch.nn.Module) -> None:
    """Average the gradients over the data axis, one flattened all-reduce,
    and those of the replicated parameters over the model axis too: their
    values agree across model ranks only up to the card's nondeterministic
    backward (atomics), and averaging keeps the ranks' copies equal."""
    named = [(k, p) for k, p in model.named_parameters() if p.grad is not None]
    pm.all_reduce_mean([p.grad for _, p in named], mesh.data_group,
                       mesh.shape[pm.DATA_AXIS])
    m = mesh.shape[pm.MODEL_AXIS]
    if m > 1:
        dims = tp.transformer_param_shardings(model)
        pm.all_reduce_mean([p.grad for k, p in named if dims[k] is None],
                           mesh.model_group, m)


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
    """Full training run. Returns (model, per-epoch mean losses of the
    epochs run in this call).

    The model's parameters are re-drawn from flax's initialisers with
    ``generator`` (as the JAX package's ``fit`` creates its params), then
    trained on ``device`` (default CUDA; raises if CUDA is absent and
    ``device`` was not given). ``generator`` lives on that device and drives
    the initialisation, the permutations, the timesteps and the noise.

    Checkpoints (``cfg.checkpoint_dir``): after every ``checkpoint_every``
    epochs (0: none) and at the end, ``utils.checkpoint.save_checkpoint``
    writes, under the epoch count, the model's and the optimiser's state
    dicts, ``step`` (optimiser steps, the JAX package's ``state.step``) and
    ``generator``'s state; the end's save is skipped when that epoch was
    already saved, and then holds the parameters before the EMA, as orbax's
    manager does in the JAX package. With ``cfg.resume`` the newest
    checkpoint is restored (after the initialisation draws) and training
    runs its remaining epochs. The JAX package does not save its key: its
    per-epoch ``fold_in`` stream replays the skipped epochs' keys. The port
    draws from one advancing generator, so it saves and restores its state:
    a run resumed from epoch k equals, bit for bit on the CPU, the
    uninterrupted run of the same total epochs, as long as the learning
    rate does not depend on the total (a constant rate, or the same
    ``num_epochs`` in both), and without EMA. The EMA is not saved: it
    starts from zero on resume and averages only the epochs run in this
    call, as in the JAX package (``ddqst_tpu/train.py:640-668``).

    ``mesh`` (``parallel.mesh.make_mesh``; every rank calls ``fit`` with
    the same arguments): training runs on the mesh's device, which
    ``device`` may name but not contradict. The dataset is whole on every
    rank, the initial parameters are broadcast from rank 0 and, with a
    ``model`` axis above 1, a transformer is split over it
    (``parallel.tensor.shard_params``; the optimiser and the EMA then hold
    this rank's shards). Each step a rank takes the loss on its rows of the
    batch, the gradients are averaged over the data axis (and the
    replicated parameters' over the model axis), and the losses returned
    are the data ranks' mean: the one-process losses to float tolerance.
    Only rank 0 logs and writes checkpoints, of the whole model and
    optimiser state, which a resume splits again. Returns the whole model,
    the same on every rank. Raises ``ValueError`` when the batch does not
    divide by ``data``. ``cfg.data_axis`` / ``cfg.model_axis`` are not
    read, as in the JAX package.
    """
    dev = pm.mesh_device(mesh, device)
    if resolve_device(generator.device) != dev:
        raise ValueError(f"generator on {generator.device}, expected {dev}")
    if mesh is not None:
        batch, d = min(cfg.batch_size, bits.shape[0]), mesh.shape[pm.DATA_AXIS]
        if batch % d:
            raise ValueError(f"batch {batch} does not divide by the data "
                             f"axis ({d})")
        if mesh.rank != 0:
            log_fn = _silent
    model.to(dev)
    init_params_(model, generator)
    schedule = schedule.to(dev)
    bits = bits.to(dev, torch.int8)
    basis = basis.to(dev, torch.int64)
    steps_per_epoch = max(bits.shape[0] // cfg.batch_size, 1)
    lr_fn = make_lr_schedule(cfg, steps_per_epoch * cfg.num_epochs)

    step = 0
    start_epoch = 0
    restored = None
    if cfg.checkpoint_dir and cfg.resume and ckpt.latest_step(
            cfg.checkpoint_dir) is not None:
        restored, start_epoch = ckpt.restore_checkpoint(cfg.checkpoint_dir)
        model.load_state_dict(restored["model"])
    if mesh is not None:
        pm.replicate(mesh, model)
        tp.shard_params(mesh, model)
    opt = make_optimizer(cfg, model.parameters())
    params = list(model.parameters())
    if restored is not None:
        opt_state = restored["optimizer"]
        if mesh is not None:
            opt_state = tp.sharded_optimizer_state(mesh, model, opt_state)
        opt.load_state_dict(opt_state)
        generator.set_state(restored["generator"])
        step = int(restored["step"])
        log_fn(f"resumed from checkpoint at epoch {start_epoch}")

    def save(epoch: int) -> None:
        state = {"model": model.state_dict(), "optimizer": opt.state_dict(),
                 "step": step, "generator": generator.get_state()}
        if mesh is None:
            ckpt.save_checkpoint(cfg.checkpoint_dir, state, epoch)
            return
        # The whole state, which rank 0 writes; every rank goes on once it
        # is on disk.
        state["model"] = tp.gathered_state_dict(mesh, model)
        state["optimizer"] = tp.gathered_optimizer_state(mesh, model,
                                                         state["optimizer"])
        if mesh.rank == 0:
            ckpt.save_checkpoint(cfg.checkpoint_dir, state, epoch)
        torch.distributed.barrier()

    ema = None
    ema_epochs = 0
    losses = []
    t_start = time.perf_counter()
    model.train()
    for epoch in range(start_epoch, cfg.num_epochs):
        loss, n = _run_epoch(model, opt, lr_fn, step, generator, bits, basis,
                             schedule, cfg.batch_size, t_max=cfg.t_max,
                             mesh=mesh)
        if mesh is not None:
            pm.all_reduce_mean([loss], mesh.data_group,
                               mesh.shape[pm.DATA_AXIS])
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
        if (cfg.checkpoint_dir and cfg.checkpoint_every
                and (epoch + 1) % cfg.checkpoint_every == 0):
            save(epoch + 1)
    if ema is not None:
        debias = 1.0 / (1.0 - cfg.ema_decay**ema_epochs)
        with torch.no_grad():
            for e, p in zip(ema, params):
                p.copy_(e * debias)
    if cfg.checkpoint_dir:
        save(cfg.num_epochs)
    if mesh is not None:
        tp.gather_params(mesh, model)
    model.eval()
    return model, torch.stack(losses) if losses else torch.zeros(0)


def _silent(*args) -> None:
    """The log of a rank other than 0."""


# Grid rows per forward of the full-grid CE at label-conditioned (shadow)
# scale: the JAX package's bound, kept for parity (not an H100 limit).
_LABEL_GRID_ROWS = 8192


def chain_opt_template(model: torch.nn.Module) -> dict:
    """Zero-valued portable Adam state for :func:`finetune_chain`: the
    structure of ``info['final_opt_state']``, ``{'count', 'mu', 'nu'}`` with
    ``mu`` / ``nu`` keyed by parameter name, built from the model alone."""
    def zeros():
        return {k: torch.zeros_like(p) for k, p in model.named_parameters()}

    return {"count": torch.zeros((), dtype=torch.int32), "mu": zeros(),
            "nu": zeros()}


def finetune_chain(
    model: torch.nn.Module,
    target_counts,
    schedule: DiffusionSchedule,
    num_qubits: int,
    steps: int = 300,
    learning_rate: float = 1e-4,
    exact: bool | None = None,
    confusion=None,
    basis_batch: int = 0,
    generator: torch.Generator | None = None,
    steps_per_call: int = 25,
    val_counts=None,
    val_patience: int = 4,
    basis_labels=None,
    val_every_equiv: float = 2.0,
    accum: int = 1,
    init_opt_state: dict | None = None,
    hard_frac: float = 0.0,
    device: str | torch.device | None = None,
) -> tuple[torch.nn.Module, torch.Tensor, dict]:
    """Exact-chain distillation: fine-tune the denoiser on the SAMPLER.

    CE training minimises a per-step denoising loss, a surrogate for what
    inference does (run the T-step reverse chain and histogram its
    outputs). At tomography scales the chain is a differentiable Markov
    chain on 2^N states per basis
    (:func:`~ddqst_tpu_torch.ops.diffusion.chain_distribution`), so after CE
    training the true objective can be descended directly: the
    cross-entropy between the chain's exact per-basis output distribution
    and the empirical training-count frequencies. There is no sampling
    noise in the loss; full-batch runs draw nothing at all.

    Args:
      model: the CE-trained denoiser; updated in place on ``device``
        (default CUDA; raises if CUDA is absent and ``device`` was not
        given) and returned.
      target_counts: ``[3^N, 2^N]`` per-canonical-basis outcome counts or
        frequencies (normalised internally).
      steps: Adam steps (a cap when ``val_counts`` stops early).
      exact: reverse rule, resolved as at generation: the distilled
        objective must match the sampler that will be used.
      confusion: optional ``[2^N, 2^N]`` readout confusion matrix
        (``M[i, j] = P(measure i | true j)``). When given, the chain's clean
        distribution is pushed through the channel inside the loss and
        matched against raw noisy counts.
      basis_batch: when > 0 and < 3^N, each step descends the CE over that
        many bases drawn without replacement instead of the full set (the
        chain is independent per basis, so the minibatch gradient is
        unbiased).
      generator: draws the basis minibatches, on ``device`` (default: a new
        one seeded 0). Full-batch runs never use it.
      steps_per_call: the JAX package's steps per device dispatch. The
        port needs no chunks for the device's sake, but the held-out CE is
        evaluated only at these chunk boundaries, so the value decides at
        which steps ``val_counts`` is looked at.
      val_counts: optional held-out ``[3^N, 2^N]`` counts (shots not in
        ``target_counts``). When given, after a chunk the full-grid chain
        CE against them is evaluated, the parameters with the best held-out
        CE are kept (step 0, the undistilled model, is a candidate), and
        the loop stops after ``val_patience`` evaluations without an
        improvement of more than 1e-5.
      val_every_equiv: held-out evaluations are spaced by this many
        full-grid-equivalent steps (a minibatched step counts as
        ``accum·basis_batch / B`` of one), and one is always made at the
        last step.
      accum: for minibatched runs, each step averages the gradient over
        ``accum`` disjoint ``basis_batch``-sized minibatches (one
        ``accum·basis_batch`` draw without replacement); clamped so the
        draw fits the basis set.
      init_opt_state: optional portable Adam state (the dict returned in
        ``info['final_opt_state']``) to resume the optimiser from. Only
        meaningful without ``val_counts``.
      hard_frac: hard-basis mining for minibatched runs: with m > 0 the
        draw has probabilities ``(1-m)/B + m·excess_b / Σ excess``, where
        ``excess_b`` is the per-basis KL(target || chain) at entry (from
        the forward pass that gives ``train_ce_before``).
      basis_labels: optional ``[B, N]`` per-qubit basis labels, for a
        denoiser conditioned on label rows. The chain is then distilled
        over exactly those bases, ``target_counts`` / ``val_counts`` are
        ``[B, 2^N]`` rows aligned with them, and ``basis_batch`` draws rows
        of the label array.

    Returns ``(model, losses [steps_run], info)``: the model carries the
    selected parameters. ``info`` holds ``train_ce_before`` /
    ``train_ce_after`` (full-grid CE against the target, also for
    minibatched runs) and ``final_opt_state`` (the Adam state after the
    last step, which with held-out selection belongs to the last
    parameters, not the selected ones); with ``val_counts`` also
    ``val_history`` [(step, ce)], ``best_step`` and ``best_val_ce``; with
    mining, ``hard_draw_p``.
    """
    dev = resolve_device(device)
    model.to(dev)
    schedule = schedule.to(dev)

    def normalised(counts):
        c = torch.as_tensor(counts, dtype=torch.float32, device=dev)
        return c / c.sum(-1, keepdim=True).clamp_min(1e-9)

    target = normalised(target_counts)
    val = None if val_counts is None else normalised(val_counts)
    conf_t = None if confusion is None else torch.as_tensor(
        confusion, dtype=torch.float32, device=dev).T
    labels = None if basis_labels is None else torch.as_tensor(
        basis_labels, device=dev).long()
    num_bases = 3**num_qubits if labels is None else labels.shape[0]
    minibatched = 0 < basis_batch < num_bases

    def ce_per_basis(bidx, tgt):
        if labels is None:
            dist = chain_distribution(model, num_qubits, schedule, exact,
                                      basis_idx=bidx)
        else:
            dist = chain_distribution(
                model, num_qubits, schedule, exact,
                basis_labels=labels if bidx is None else labels[bidx])
        if conf_t is not None:
            dist = dist @ conf_t  # p_meas(i) = Σ_j M[i,j] p_clean(j)
        return -(tgt * torch.log(dist.clamp_min(1e-12))).sum(-1)

    # Full-grid CE (forward only), chunked over bases; the chain is
    # independent per basis, so chunking is exact.
    if labels is None:
        chunk_b = 3 ** min(num_qubits, 5)
    else:
        chunk_b = max(1, min(num_bases, _LABEL_GRID_ROWS // 2**num_qubits))

    @torch.no_grad()
    def grid_ce_per_basis(tgt) -> np.ndarray:
        rows = [
            ce_per_basis(torch.arange(lo, min(lo + chunk_b, num_bases),
                                      device=dev), tgt[lo:lo + chunk_b])
            for lo in range(0, num_bases, chunk_b)
        ]
        return torch.cat(rows).cpu().numpy()

    def full_grid_ce(tgt) -> float:
        return float(np.mean(grid_ce_per_basis(tgt)))

    accum = max(int(accum), 1)
    if minibatched and accum * basis_batch > num_bases:
        # The draw without replacement must fit the basis set.
        accum = max(num_bases // basis_batch, 1)

    ce_before = grid_ce_per_basis(target)
    info: dict = {"train_ce_before": float(np.mean(ce_before))}
    draw_p = torch.ones(num_bases, device=dev)
    if hard_frac > 0 and minibatched:
        tgt_np = target.cpu().numpy().astype(np.float64)
        ent = -np.sum(tgt_np * np.log(np.maximum(tgt_np, 1e-12)), axis=-1)
        excess = np.maximum(ce_before - ent, 0.0)
        tot = float(excess.sum())
        if tot > 0:
            w = (1.0 - hard_frac) / num_bases + hard_frac * excess / tot
            hard_p = (w / w.sum()).astype(np.float32)
            info["hard_draw_p"] = hard_p
            draw_p = torch.from_numpy(hard_p).to(dev)

    named = dict(model.named_parameters())
    params = list(named.values())
    opt = torch.optim.Adam(params, lr=learning_rate)
    if init_opt_state is not None:
        for key in ("mu", "nu"):
            if init_opt_state[key].keys() != named.keys():
                raise ValueError(
                    f"init_opt_state[{key!r}] names differ from the model's")
        for name, p in named.items():
            mu, nu = (torch.as_tensor(init_opt_state[key][name],
                                      device=dev).clone()
                      for key in ("mu", "nu"))
            if mu.shape != p.shape or nu.shape != p.shape:
                raise ValueError(
                    f"init_opt_state moments of {name!r} have shapes "
                    f"{tuple(mu.shape)} and {tuple(nu.shape)}, expected "
                    f"{tuple(p.shape)}")
            opt.state[p] = {
                "step": torch.as_tensor(float(init_opt_state["count"])),
                "exp_avg": mu, "exp_avg_sq": nu,
            }
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def one_step() -> torch.Tensor:
        opt.zero_grad(set_to_none=True)
        if not minibatched:
            loss = ce_per_basis(None, target).mean()
            loss.backward()
        else:
            sel = torch.multinomial(draw_p, accum * basis_batch,
                                    replacement=False, generator=generator)
            loss = torch.zeros((), device=dev)
            for bidx in sel.reshape(accum, basis_batch):
                part = ce_per_basis(bidx, target[bidx]).mean() / accum
                part.backward()  # gradients add up to the mean's
                loss = loss + part.detach()
        opt.step()
        return loss.detach()

    def snapshot():
        return {k: v.detach().clone() for k, v in model.state_dict().items()}

    losses = []
    done = 0
    best_ce = best_step = None
    bad = 0
    val_history = []
    if val is not None:
        best_ce = full_grid_ce(val)
        best_step = 0
        best_params = snapshot()
        val_history.append((0, best_ce))
    equiv_per_step = (accum * basis_batch / num_bases) if minibatched else 1.0
    since_eval = 0.0
    while done < steps:
        length = min(steps_per_call, steps - done)
        losses += [one_step() for _ in range(length)]
        done += length
        since_eval += length * equiv_per_step
        if val is not None and (since_eval >= val_every_equiv
                                or done >= steps):
            since_eval = 0.0
            ce = full_grid_ce(val)
            val_history.append((done, ce))
            if ce < best_ce - 1e-5:
                best_ce, best_params, best_step = ce, snapshot(), done
                bad = 0
            else:
                bad += 1
                if bad >= val_patience:
                    break
    adam = [opt.state.get(p, {}) for p in params]
    info["final_opt_state"] = {
        "count": torch.as_tensor(
            int(adam[0]["step"]) if adam[0] else 0, dtype=torch.int32),
        "mu": {k: st["exp_avg"].detach().clone() if st else torch.zeros_like(p)
               for (k, p), st in zip(named.items(), adam)},
        "nu": {k: st["exp_avg_sq"].detach().clone() if st
               else torch.zeros_like(p)
               for (k, p), st in zip(named.items(), adam)},
    }
    if val is not None:
        model.load_state_dict(best_params)
        info.update(val_history=val_history, best_step=best_step,
                    best_val_ce=best_ce)
    info["train_ce_after"] = full_grid_ce(target)
    model.eval()
    return model, (torch.stack(losses) if losses else torch.zeros(0)), info
