"""D3PM forward noising, denoising loss, and reverse samplers.

The port's counterpart of ``ddqst_tpu/ops/diffusion.py`` for the full
route's generate mode:

- ``q_sample`` / ``denoising_loss`` — x_t is ``x_0 XOR Bernoulli(cum_flip[t])``
  (every transition is a symmetric flip channel), and the loss is the
  cross-entropy of the predicted x_0 logits.
- ``p_sample`` — the per-chain reverse sampler (one denoiser call per step
  for every chain).
- ``p_denoise`` / ``denoise_dataset`` / ``match_timestep`` — denoise mode:
  the same reverse chain started from the *measured* shots at the step t*
  whose cumulative flip probability matches the readout flip rate. Plain
  torch, as in the JAX package (no kernel: every chain calls the denoiser).
- ``grid_p1_tables`` / ``p_sample_grid`` / ``sample_all_bases`` — the
  exhaustive-grid sampler: at small N the denoiser's inputs (x_t, t, basis,
  and the circuit for circuit-conditioned models) take only
  T·C·3^N·2^N values, so all per-step P(bit=1) tables come from a few
  batched forwards and the reverse chain becomes a table walk. On a CUDA
  device the walk runs in the hand-written kernels: all T steps in one
  launch (:func:`ddqst_tpu_torch.ops.cuda_kernels.fused_chain_walk`), or
  one launch per step in :func:`p_sample_grid`
  (:func:`ddqst_tpu_torch.ops.cuda_kernels.fused_chain_step`).

Randomness comes from an explicit ``torch.Generator`` on the working
device. The streams differ from ``jax.random``'s, so the samplers match the
JAX package in distribution, and the deterministic parts (posterior,
tables) to float tolerance.

- ``chain_distribution`` / ``sampler_distribution`` /
  ``chain_distribution_all_bases`` — the sampler's EXACT output
  distribution: the reverse chain is a Markov chain on 2^N states per
  basis, so its distribution is propagated through the per-step transition
  matrices. Differentiable with respect to the denoiser's parameters (the
  lever of ``train.finetune_chain``), and built from the same
  ``_grid_p1_table`` as the samplers, so chain and sampler share one
  posterior.

- ``sample_for_bases`` / ``sample_for_bases_tables`` — the shadow route's
  generation for sampled ``[B, N]`` basis-label rows: per-chain
  :func:`p_sample` ('direct'), or all T tables over the ``B·2^N``
  (basis-row, x) grid and one table walk ('tables').
- ``sample_all_bases_chunked`` (``gen_tables_once``) — the canonical grid's
  tables built once in bounded chunks, then table walks over shot chunks.

  Both assemble their ``[T, B, 2^N, N]`` tables in one preallocated buffer,
  written in place chunk by chunk (the peak is one table plus one chunk),
  and walk through :func:`~ddqst_tpu_torch.ops.cuda_kernels.fused_chain_walk`,
  which takes 2^N up to 2^16 on the card (the JAX package walks these with
  XLA, because its Pallas walk takes 2^N <= 128).
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint as _checkpoint

from ddqst_tpu_torch.device import resolve_device, synchronize
from ddqst_tpu_torch.ops import cuda_kernels, precision
from ddqst_tpu_torch.ops.schedules import DiffusionSchedule

DenoiseFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
# (x_t [B,N] int, t [B] int, basis [B] int) -> logits [B,N,2]


def q_sample(
    generator: torch.Generator, x0: torch.Tensor, t: torch.Tensor,
    schedule: DiffusionSchedule,
) -> torch.Tensor:
    """Forward noising: flip each bit of x0 with probability cum_flip[t]."""
    p = schedule.cum_flip[t][..., None]
    u = torch.rand(x0.shape, generator=generator, device=x0.device)
    return x0 ^ (u < p).to(x0.dtype)


def cross_entropy(logits: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
    """Mean over (batch, qubit) of -log softmax(logits)[x0]."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, x0.long()[..., None]).mean()


def denoising_loss(
    generator: torch.Generator,
    denoise_fn: DenoiseFn,
    x0: torch.Tensor,
    basis: torch.Tensor,
    schedule: DiffusionSchedule,
    t_max: int = 0,
    rows: slice | None = None,
) -> torch.Tensor:
    """t ~ U[1, T] (or U[1, t_max]), x_t = q_sample(x0, t), CE(model(x_t), x0).

    ``rows``: a data-parallel rank's part of the batch. ``t`` and the noise
    are drawn for the whole batch, as one process draws them, and the CE is
    taken over ``rows`` only, so the ranks' mean equals the one-process
    loss.
    """
    upper = t_max if t_max else schedule.num_timesteps
    t = torch.randint(1, upper + 1, (x0.shape[0],), generator=generator,
                      device=x0.device)
    x_t = q_sample(generator, x0, t, schedule)
    if rows is not None:
        x0, x_t, t, basis = x0[rows], x_t[rows], t[rows], basis[rows]
    return cross_entropy(denoise_fn(x_t, t, basis), x0)


def _resolve_exact(schedule: DiffusionSchedule, exact: bool | None) -> bool:
    """Resolve the reverse-rule override against the schedule.

    The exact posterior needs a true cumulative flip probability; the
    linear family's ``cum_flip == betas`` is not one, so exact=True there is
    rejected instead of silently mis-sampling.
    """
    if exact is None:
        return schedule.exact_posterior
    if exact and schedule.kind != "cosine":
        raise ValueError(
            "exact posterior requires a cumulative schedule; the "
            f"{schedule.kind!r} family's cum_flip is the reference's "
            "one-shot quirk (use sampler='renoise' or the cosine schedule)"
        )
    return exact


def _posterior_p1(
    logits: torch.Tensor,
    x_t: torch.Tensor,
    beta_t: torch.Tensor,
    cum_flip_tm1: torch.Tensor,
) -> torch.Tensor:
    """P(x_{t-1}=1 | x_t, p̂(x_0)) for the symmetric binary channel."""
    p1_hat = torch.softmax(logits, dim=-1)[..., 1]
    prior1 = p1_hat * (1.0 - cum_flip_tm1) + (1.0 - p1_hat) * cum_flip_tm1
    prior0 = 1.0 - prior1
    x_is_one = x_t == 1
    trans1 = torch.where(x_is_one, 1.0 - beta_t, beta_t)
    trans0 = torch.where(x_is_one, beta_t, 1.0 - beta_t)
    u1 = trans1 * prior1
    u0 = trans0 * prior0
    return u1 / (u0 + u1 + 1e-8)


@torch.no_grad()
def p_sample(
    generator: torch.Generator,
    denoise_fn: DenoiseFn,
    basis: torch.Tensor,
    num_qubits: int,
    schedule: DiffusionSchedule,
    exact: bool | None = None,
) -> torch.Tensor:
    """Per-chain reverse diffusion: one sample of x_0 per basis row.

    ``exact`` None follows the schedule (cosine → exact posterior, linear →
    renoise). Returns ``[B, N]`` int8.
    """
    exact = _resolve_exact(schedule, exact)
    dev = basis.device
    num = basis.shape[0]
    x = (torch.rand((num, num_qubits), generator=generator, device=dev) < 0.5
         ).to(torch.int8)
    return _reverse_chain(generator, denoise_fn, x, basis,
                          schedule.num_timesteps, schedule, exact)


def _reverse_chain(generator, denoise_fn, x, basis, t_start: int,
                   schedule: DiffusionSchedule, exact: bool) -> torch.Tensor:
    """Steps t_start..1 of the reverse chain from the int8 state ``x``."""
    dev = x.device
    num = x.shape[0]
    for t in range(t_start, 0, -1):
        t_vec = torch.full((num,), t, dtype=torch.int64, device=dev)
        logits = denoise_fn(x, t_vec, basis)
        if exact:
            p1 = _posterior_p1(
                logits, x, schedule.betas[t], schedule.cum_flip[t - 1]
            )
            x = (torch.rand(p1.shape, generator=generator, device=dev) < p1
                 ).to(torch.int8)
        else:
            # Predict x̂_0, then re-noise to t-1 (skip re-noising at t=1).
            p1_hat = torch.softmax(logits, dim=-1)[..., 1]
            x0_hat = (torch.rand(p1_hat.shape, generator=generator, device=dev)
                      < p1_hat).to(torch.int8)
            flip_p = schedule.cum_flip[t - 1] if t > 1 else 0.0
            flips = torch.rand(x0_hat.shape, generator=generator, device=dev
                               ) < flip_p
            x = x0_hat ^ flips.to(torch.int8)
    return x


@torch.no_grad()
def p_denoise(
    generator: torch.Generator,
    denoise_fn: DenoiseFn,
    noisy_bits: torch.Tensor,
    basis: torch.Tensor,
    t_star: int,
    schedule: DiffusionSchedule,
    exact: bool | None = None,
) -> torch.Tensor:
    """Denoise *measured* bitstrings by reverse diffusion from t*.

    The forward process is a symmetric bit-flip channel, the model of
    readout error, so each measured shot is taken as x_{t*} where
    ``cum_flip[t*]`` matches the readout flip rate (:func:`match_timestep`),
    and the reverse chain runs t*..1 under the same rule as
    :func:`p_sample`: this inverts the readout channel shot by shot.

    ``noisy_bits`` ``[B, N]`` (one row per shot), ``basis`` ``[B]`` indices
    or ``[B, N]`` labels, on ``generator``'s device. Returns ``[B, N]``
    int8 samples of x_0.
    """
    exact = _resolve_exact(schedule, exact)
    return _reverse_chain(generator, denoise_fn, noisy_bits.to(torch.int8),
                          basis, t_star, schedule, exact)


# Rows per p_denoise call in denoise_dataset: bounds one call's activations
# (2^21 rows of the rqc width's 512-wide blocks: 4.3 GB a float32 tensor).
_DENOISE_CHAIN_CAP = 1 << 21


@torch.no_grad()
def denoise_dataset(
    generator: torch.Generator,
    denoise_fn: DenoiseFn,
    noisy_bits: torch.Tensor,
    basis: torch.Tensor,
    t_star: int,
    schedule: DiffusionSchedule,
    exact: bool | None = None,
) -> torch.Tensor:
    """:func:`p_denoise` over a flat ``[M, N]`` dataset, at most
    ``_DENOISE_CHAIN_CAP`` rows a call. Returns ``[M, N]`` int8."""
    cap = _DENOISE_CHAIN_CAP
    return torch.cat([
        p_denoise(generator, denoise_fn, noisy_bits[lo:lo + cap],
                  basis[lo:lo + cap], t_star, schedule, exact)
        for lo in range(0, noisy_bits.shape[0], cap)
    ])


def match_timestep(schedule: DiffusionSchedule, flip_prob: float) -> int:
    """Smallest t with cum_flip[t] >= flip_prob (clamped to [1, T])."""
    cf = schedule.cum_flip.cpu().numpy()
    idx = int(np.searchsorted(cf, flip_prob))
    return max(1, min(idx, schedule.num_timesteps))


def _grid_p1_table(
    logits: torch.Tensor,
    x_bits: torch.Tensor,
    t,
    schedule: DiffusionSchedule,
    exact: bool,
) -> torch.Tensor:
    """P(x_{t-1}=1) per grid row for either reverse rule.

    For the renoise rule the two-stage draw (x̂0 ~ Bern(p̂1), then XOR
    Bern(f)) has per-bit marginal p̂1(1-f) + (1-p̂1)f, exactly equivalent in
    distribution. ``t`` is a scalar or a per-row ``[R]`` vector.
    """
    t = torch.as_tensor(t, device=logits.device)
    beta = schedule.betas[t]
    cum = schedule.cum_flip[(t - 1).clamp_min(0)]
    f = torch.where(t > 1, cum, torch.zeros_like(cum))
    if t.dim():  # per-row timesteps broadcast over the qubit axis
        beta, cum, f = beta[:, None], cum[:, None], f[:, None]
    if exact:
        return _posterior_p1(logits, x_bits, beta, cum)
    p1_hat = torch.softmax(logits, dim=-1)[..., 1]
    return p1_hat * (1.0 - f) + (1.0 - p1_hat) * f


def _grid_enum(
    num_qubits: int, device, num_circuits: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """The (circuit ×) basis × bitstring conditioning grid.

    Row ``(circuit·3^N + basis_idx)·2^N + x``. Returns ``(grid_x [Gtot, N]
    int8, grid_basis)`` with ``grid_basis`` ``[Gtot]`` int64, or ``[Gtot,
    2]`` (basis, circuit) when ``num_circuits > 0``.
    """
    num_bases = 3**num_qubits
    g = 2**num_qubits
    reps = max(num_circuits, 1)
    x_enum = (
        (torch.arange(g, device=device)[:, None]
         >> torch.arange(num_qubits, device=device)) & 1
    ).to(torch.int8)
    grid_x = x_enum.repeat(reps * num_bases, 1)
    grid_basis = torch.arange(num_bases, device=device).repeat_interleave(g)
    grid_basis = grid_basis.repeat(reps)
    if num_circuits > 0:
        grid_circ = torch.arange(num_circuits, device=device
                                 ).repeat_interleave(num_bases * g)
        return grid_x, torch.stack([grid_basis, grid_circ], dim=-1)
    return grid_x, grid_basis


# Rows per model forward: the JAX package's TPU-tuned bound, kept for parity
# (it bounds the [rows, hidden] activation block to ~0.25 GB at hidden 512).
_ROW_BUDGET = 1 << 17


def _p1_rows_one_t(
    denoise_fn, t: int, grid_x, grid_basis, schedule, exact, row_budget: int
) -> torch.Tensor:
    """Table rows for ONE timestep with every forward <= ``row_budget`` rows."""
    out = []
    for lo in range(0, grid_x.shape[0], row_budget):
        x = grid_x[lo:lo + row_budget]
        tv = torch.full((x.shape[0],), t, dtype=torch.int64, device=x.device)
        logits = denoise_fn(x, tv, grid_basis[lo:lo + row_budget])
        out.append(_grid_p1_table(logits, x, tv, schedule, exact))
    return torch.cat(out)


def _tables_for_ts(
    denoise_fn,
    ts_c: torch.Tensor,
    num_qubits: int,
    schedule: DiffusionSchedule,
    exact: bool,
    num_circuits: int = 0,
    row_budget: int = _ROW_BUDGET,
    grid: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """P(bit=1) tables ``[len(ts_c), Gtot, N]`` for the given timesteps.

    Every forward is bounded to ``row_budget`` rows: timesteps are grouped
    ``m`` at a time when the grid is small, and one timestep's grid is
    row-chunked when it alone exceeds the budget. A length that ``m`` does
    not divide (a prime T) is padded with dummy t=1 rows, which are sliced
    off, so every group is a forward of the same size.

    ``grid``: an optional ``(grid_x, grid_basis)`` in place of the canonical
    :func:`_grid_enum`; the shadow route passes its ``[B·2^N, N]`` label
    grid here (``grid_basis`` then holds ``[R, N]`` labels).
    """
    if grid is None:
        grid_x, grid_basis = _grid_enum(num_qubits, ts_c.device, num_circuits)
    else:
        grid_x, grid_basis = grid
    gtot = grid_x.shape[0]
    length = ts_c.shape[0]
    if gtot > row_budget:
        return torch.stack([
            _p1_rows_one_t(denoise_fn, int(t), grid_x, grid_basis, schedule,
                           exact, row_budget)
            for t in ts_c
        ])
    m = min(max(1, row_budget // gtot), length)
    n_chunks = -(-length // m)
    ts_pad = torch.cat(
        [ts_c, torch.ones(n_chunks * m - length, dtype=ts_c.dtype,
                          device=ts_c.device)]
    )
    big_x = grid_x.repeat(m, 1)
    big_basis = grid_basis.repeat((m,) + (1,) * (grid_basis.dim() - 1))
    out = []
    for ts_g in ts_pad.reshape(n_chunks, m):
        big_t = ts_g.repeat_interleave(gtot)
        logits = denoise_fn(big_x, big_t, big_basis)  # [m·Gtot, N, 2]
        p1 = _grid_p1_table(logits, big_x, big_t, schedule, exact)
        out.append(p1.reshape(m, gtot, num_qubits))
    return torch.cat(out)[:length]


@torch.no_grad()
def grid_p1_tables(
    denoise_fn: DenoiseFn,
    num_qubits: int,
    schedule: DiffusionSchedule,
    exact: bool | None = None,
    num_circuits: int = 0,
    row_budget: int = _ROW_BUDGET,
) -> torch.Tensor:
    """P(bit=1) tables for EVERY (t, (circuit,) basis, x) in a few batched
    forwards.

    Returns ``[T, Gtot, N]`` float32 on the schedule's device (Gtot =
    max(C, 1)·3^N·2^N, rows laid out as in :func:`_grid_enum`), index 0 =
    the first reverse step (t = T).
    """
    exact = _resolve_exact(schedule, exact)
    ts = torch.arange(schedule.num_timesteps, 0, -1,
                      device=schedule.betas.device)
    return _tables_for_ts(denoise_fn, ts, num_qubits, schedule, exact,
                          num_circuits, row_budget)


def _unpack(idx: torch.Tensor, num_qubits: int) -> torch.Tensor:
    shifts = torch.arange(num_qubits, device=idx.device)
    return ((idx[..., None] >> shifts) & 1).to(torch.int8)


@torch.no_grad()
def p_sample_grid(
    generator: torch.Generator,
    denoise_fn: DenoiseFn,
    basis: torch.Tensor,
    num_qubits: int,
    schedule: DiffusionSchedule,
    exact: bool | None = None,
    num_circuits: int = 0,
    precompute: bool = True,
    timings: dict | None = None,
) -> torch.Tensor:
    """Reverse diffusion via exhaustive-grid evaluation (small N).

    ``basis`` is ``[B]`` basis indices, or, with ``num_circuits > 0``
    (circuit-conditioned models), a packed ``[B, 2]`` of (basis, circuit);
    the grid then enumerates (circuit, basis, x).

    ``precompute=True`` takes all T tables ``[T, Gtot, N]`` from one
    :func:`grid_p1_tables` call; ``precompute=False`` runs one grid forward
    per step instead (cheaper when chains are few). In both, each step's
    chain update (gather the chain's table row, one Bernoulli per bit,
    pack) is :func:`~ddqst_tpu_torch.ops.cuda_kernels.fused_chain_step`,
    called with one 64-bit seed drawn from ``generator`` per call and the
    step's index: on a CUDA device that launches the hand-written kernel
    once per step (or raises), and only CPU tensors take its plain version.
    Each chain's row offset ``((circuit·3^N +) basis)·2^N`` is computed once,
    as int32, and handed to every step as its ``row_base``; the chain state
    goes from one launch straight into the next.

    ``timings``: if given, the seconds spent on the table precompute
    (``precompute=True`` only) and on the T chain updates are stored under
    ``'tables'`` and ``'steps'`` (the device is synchronised around each).
    Returns ``[B, N]`` int8.
    """
    exact = _resolve_exact(schedule, exact)
    dev = basis.device
    g = 2**num_qubits
    gtot = max(num_circuits, 1) * 3**num_qubits * g
    if gtot >= 2**31:
        raise ValueError(f"the grid's {gtot} rows do not fit an int32 row id")
    if num_circuits > 0:
        row_base = (basis[:, 1].long() * 3**num_qubits + basis[:, 0].long()) * g
    else:
        row_base = basis.long() * g
    row_base = row_base.to(torch.int32).contiguous()
    x_idx = torch.randint(0, g, (basis.shape[0],), generator=generator,
                          device=dev, dtype=torch.int32)
    seed = int(torch.randint(0, 2**63 - 1, (), generator=generator,
                             device=dev))
    t0 = time.perf_counter()
    if precompute:
        tables = grid_p1_tables(denoise_fn, num_qubits, schedule, exact,
                                num_circuits)
        if timings is not None:
            synchronize(dev)
            timings["tables"] = time.perf_counter() - t0
    else:
        grid_x, grid_basis = _grid_enum(num_qubits, dev, num_circuits)
    t0 = time.perf_counter()
    for i, t in enumerate(range(schedule.num_timesteps, 0, -1)):
        if precompute:
            table = tables[i]
        else:
            table = _p1_rows_one_t(denoise_fn, t, grid_x, grid_basis,
                                   schedule, exact, _ROW_BUDGET)
        x_idx = cuda_kernels.fused_chain_step(seed, table.contiguous(), x_idx,
                                              num_qubits, step=i,
                                              row_base=row_base)
    if timings is not None:
        synchronize(dev)
        timings["steps"] = time.perf_counter() - t0
    return _unpack(x_idx, num_qubits)


def chain_distribution(
    denoise_fn: DenoiseFn,
    num_qubits: int,
    schedule: DiffusionSchedule,
    exact: bool | None = None,
    basis_idx: torch.Tensor | None = None,
    basis_labels: torch.Tensor | None = None,
    checkpoint: bool = True,
) -> torch.Tensor:
    """EXACT output distribution of the reverse sampler, per basis.

    At small N the reverse chain is a Markov chain on 2^N states whose
    per-step transition factorises over bits given (x_t, basis):
    ``T[b, x, y] = Π_q p1[b,x,q]^{y_q} (1-p1[b,x,q])^{1-y_q}``. Propagating
    the uniform start through the T transitions gives the infinite-shot
    limit of :func:`sample_all_bases`, with no generation shot noise.

    Everything is smooth in the denoiser's outputs, so the result is
    differentiable with respect to the parameters behind ``denoise_fn``.
    With ``checkpoint`` (and gradients enabled) each step is wrapped in
    ``torch.utils.checkpoint``: only the ``[B, 2^N]`` carry is kept per
    step and the backward pass recomputes the step's forward, instead of
    keeping every denoiser activation of all T steps.

    ``basis_idx`` (1-D int tensor) restricts the chain to those canonical
    bases; every basis' chain is independent, so this is exact restriction.
    ``basis_labels`` (``[B, N]`` per-qubit labels, mutually exclusive with
    ``basis_idx``) conditions the denoiser on label rows instead, for a
    denoiser that takes them. ``exact`` resolves as at generation.

    Runs on the schedule's device. Returns ``[B or 3^N, 2^N]`` float32
    outcome probabilities.
    """
    if basis_idx is not None and basis_labels is not None:
        raise ValueError("basis_idx and basis_labels are mutually exclusive")
    exact = _resolve_exact(schedule, exact)
    dev = schedule.betas.device
    g = 2**num_qubits
    if basis_labels is not None:
        cond = torch.as_tensor(basis_labels, device=dev).long()
        num_bases = cond.shape[0]
        grid_cond = cond.repeat_interleave(g, dim=0)
    else:
        if basis_idx is None:
            basis_idx = torch.arange(3**num_qubits, device=dev)
        basis_idx = torch.as_tensor(basis_idx, device=dev).long()
        num_bases = basis_idx.shape[0]
        grid_cond = basis_idx.repeat_interleave(g)
    x_enum = _unpack(torch.arange(g, device=dev), num_qubits)
    grid_x = x_enum.repeat(num_bases, 1)
    y_bits = x_enum.float()  # [2^N, N]

    def step(dist: torch.Tensor, t: int) -> torch.Tensor:
        t_vec = torch.full((grid_x.shape[0],), t, dtype=torch.int64,
                           device=dev)
        logits = denoise_fn(grid_x, t_vec, grid_cond)
        p1 = _grid_p1_table(logits, grid_x, t, schedule, exact).reshape(
            num_bases, g, num_qubits)
        # Accumulated qubit by qubit, so the [B, x, y, N] intermediate is
        # never built; out of place, for autograd.
        trans = None
        for q in range(num_qubits):
            pq = p1[:, :, None, q]
            yq = y_bits[None, None, :, q]
            f = pq * yq + (1.0 - pq) * (1.0 - yq)
            trans = f if trans is None else trans * f
        if precision.active():
            new = precision.chain_product(dist, trans)
        else:
            new = torch.einsum("bx,bxy->by", dist, trans)
        return new / new.sum(dim=-1, keepdim=True)

    remat = checkpoint and torch.is_grad_enabled()
    dist = torch.full((num_bases, g), 1.0 / g, dtype=torch.float32, device=dev)
    for t in range(schedule.num_timesteps, 0, -1):
        if remat:
            dist = _checkpoint(step, dist, t, use_reentrant=False,
                               preserve_rng_state=False)
        else:
            dist = step(dist, t)
    return dist


@torch.no_grad()
def sampler_distribution(
    denoise_fn: DenoiseFn,
    num_qubits: int,
    schedule: DiffusionSchedule,
    exact: bool | None = None,
) -> torch.Tensor:
    """:func:`chain_distribution` over all 3^N bases without gradients:
    ``[3^N, 2^N]``, to feed straight into MLE or linear inversion."""
    return chain_distribution(denoise_fn, num_qubits, schedule, exact)


@torch.no_grad()
def chain_distribution_all_bases(
    denoise_fn: DenoiseFn,
    num_qubits: int,
    schedule: DiffusionSchedule,
    exact: bool | None = None,
    basis_labels: torch.Tensor | None = None,
    max_rows: int = 1 << 14,
) -> torch.Tensor:
    """Exact sampler distribution over EVERY basis, chunked over bases so no
    forward exceeds ``max_rows`` grid rows (the JAX package's bound, kept
    for parity). ``basis_labels`` switches to label conditioning (``[B, N]``
    rows) instead of the canonical 3^N enumeration. Returns ``[3^N or B,
    2^N]`` float32 probabilities.
    """
    g = 2**num_qubits
    num_bases = (3**num_qubits if basis_labels is None
                 else basis_labels.shape[0])
    chunk_b = max(1, min(num_bases, max_rows // g))
    rows = []
    for lo in range(0, num_bases, chunk_b):
        hi = min(lo + chunk_b, num_bases)
        if basis_labels is None:
            rows.append(chain_distribution(
                denoise_fn, num_qubits, schedule, exact,
                basis_idx=torch.arange(lo, hi)))
        else:
            rows.append(chain_distribution(
                denoise_fn, num_qubits, schedule, exact,
                basis_labels=basis_labels[lo:hi]))
    return torch.cat(rows)


def _check_generator(generator: torch.Generator, device) -> torch.device:
    dev = resolve_device(device)
    if resolve_device(generator.device) != dev:
        raise ValueError(f"generator on {generator.device}, expected {dev}")
    return dev


@torch.no_grad()
def _assembled_tables(
    denoise_fn, num_qubits: int, schedule: DiffusionSchedule, exact: bool,
    grid: tuple[torch.Tensor, torch.Tensor], max_table_rows: int,
    row_budget: int,
) -> torch.Tensor:
    """All T steps' tables ``[T, C, 2^N, N]`` of a grid of ``C·2^N`` rows,
    computed ``m`` timesteps at a time (``m·C·2^N <= max_table_rows`` rows,
    every forward ``<= row_budget`` rows) and written in place into one
    preallocated buffer, so the peak is the table plus one chunk (the JAX
    package's donated ``_table_acc``)."""
    t_steps = schedule.num_timesteps
    g = 2**num_qubits
    gtot = grid[0].shape[0]
    m = min(max(1, max_table_rows // gtot), t_steps)
    ts = torch.arange(t_steps, 0, -1, device=schedule.betas.device)
    tables = torch.empty((t_steps, gtot // g, g, num_qubits),
                         dtype=torch.float32, device=grid[0].device)
    for lo in range(0, t_steps, m):
        part = _tables_for_ts(denoise_fn, ts[lo:lo + m], num_qubits, schedule,
                              exact, row_budget=row_budget, grid=grid)
        tables[lo:lo + part.shape[0]] = part.reshape(part.shape[0], -1, g,
                                                     num_qubits)
    return tables


def _walk_shot_chunks(
    generator: torch.Generator, tables: torch.Tensor, shots: int,
    max_chains: int,
) -> torch.Tensor:
    """``shots`` chains per table row, walked at most ``max_chains`` chains
    a call through :func:`~ddqst_tpu_torch.ops.cuda_kernels.fused_chain_walk`
    (on CUDA the kernel, one launch a call), each call with its own
    ``init`` and 64-bit seed drawn from ``generator``. Returns ``[C, shots,
    N]`` int8."""
    _, c, g, n = tables.shape
    dev = tables.device
    cap = max(1, max_chains // c)
    n_calls = -(-shots // cap)
    per_call = -(-shots // n_calls)  # equal chunks
    idx = []
    for _ in range(n_calls):
        init = torch.randint(0, g, (c, per_call), generator=generator,
                             device=dev, dtype=torch.int32)
        seed = int(torch.randint(0, 2**63 - 1, (), generator=generator,
                                 device=dev))
        idx.append(cuda_kernels.fused_chain_walk(seed, tables, init, n))
    out = idx[0] if n_calls == 1 else torch.cat(idx, dim=1)[:, :shots]
    return _unpack(out, n)


def _timed_tables_and_walk(make_tables, walk, dev, timings):
    t0 = time.perf_counter()
    tables = make_tables()
    if timings is not None:
        synchronize(dev)
        timings["tables"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = walk(tables)
    if timings is not None:
        synchronize(dev)
        timings["walk"] = time.perf_counter() - t0
    return out


@torch.no_grad()
def sample_all_bases(
    generator: torch.Generator,
    denoise_fn: DenoiseFn,
    num_qubits: int,
    shots: int,
    schedule: DiffusionSchedule,
    exact: bool | None = None,
    grid_mode: str = "auto",
    walk: str = "auto",
    device: str | torch.device | None = None,
    timings: dict | None = None,
) -> torch.Tensor:
    """Generate ``shots`` samples for every canonical basis.

    Returns ``[3^N, shots, N]`` int8 on ``device`` (default CUDA; raises if
    CUDA is absent and ``device`` was not given). ``denoise_fn`` (the model),
    ``schedule`` and ``generator`` live on that device.

    ``grid_mode``: ``'auto'`` uses the grid sampler when the (x, basis) grid
    is smaller than the chain count, ``'on'``/``'off'`` force it.

    ``walk`` selects the grid path's chain walk:

    - ``'seq'`` — no table precompute: :func:`p_sample_grid` with
      ``precompute=False``, one grid forward per step, each step's chain
      update through
      :func:`~ddqst_tpu_torch.ops.cuda_kernels.fused_chain_step` (on CUDA,
      T launches of the hand-written step kernel).
    - ``'auto'`` — below 32·6^N chains ``'seq'`` (the JAX package's
      crossover, tuned on a TPU and kept for parity, not an H100 limit);
      otherwise all T tables in one precompute, then the whole walk through
      :func:`~ddqst_tpu_torch.ops.cuda_kernels.fused_chain_walk`. That
      wrapper launches the hand-written kernel for CUDA tensors (raising if
      N > 16) and takes its plain version only for CPU tensors.
    - ``'cuda'`` — the table walk of ``'auto'``, demanded: raises unless
      the device is CUDA and the grid path is on.

    ``timings``: if given, the seconds spent on the table precompute and the
    walk are stored under ``'tables'`` and ``'walk'`` (the device is
    synchronised around each); the paths without a precompute store their
    whole time, model forwards included, under ``'walk'``.
    """
    dev = _check_generator(generator, device)
    num_bases = 3**num_qubits
    g = 2**num_qubits
    chains = num_bases * shots
    use_grid = grid_mode == "on" or (
        grid_mode == "auto" and 6**num_qubits < chains
    )
    if walk not in ("auto", "cuda", "seq"):
        raise ValueError(f"unknown walk {walk!r}")
    if walk == "cuda" and (dev.type != "cuda" or not use_grid):
        raise ValueError(
            "walk='cuda' launches the CUDA kernel on the grid path; got "
            f"device {dev}, grid {'on' if use_grid else 'off'}"
        )
    if use_grid and (walk == "cuda" or (
            walk == "auto" and chains >= 32 * 6**num_qubits)):
        return _timed_tables_and_walk(
            lambda: grid_p1_tables(denoise_fn, num_qubits, schedule, exact
                                   ).reshape(schedule.num_timesteps,
                                             num_bases, g, num_qubits),
            lambda tables: _walk_shot_chunks(generator, tables, shots, chains),
            dev, timings)
    t0 = time.perf_counter()
    basis = torch.arange(num_bases, device=dev).repeat_interleave(shots)
    if use_grid:
        out = p_sample_grid(generator, denoise_fn, basis, num_qubits,
                            schedule, exact=exact, precompute=False)
    else:
        out = p_sample(generator, denoise_fn, basis, num_qubits, schedule,
                       exact=exact)
    if timings is not None:
        synchronize(dev)
        timings["walk"] = time.perf_counter() - t0
    return out.reshape(num_bases, shots, num_qubits)


@torch.no_grad()
def sample_for_bases(
    generator: torch.Generator,
    denoise_fn: DenoiseFn,
    basis_labels: torch.Tensor,
    shots: int,
    schedule: DiffusionSchedule,
    exact: bool | None = None,
    max_chains_per_call: int = 1 << 16,
    mode: str = "auto",
    device: str | torch.device | None = None,
    timings: dict | None = None,
) -> torch.Tensor:
    """Generate ``shots`` samples per basis-label row (the shadow route).

    ``basis_labels``: ``[B, N]`` per-qubit labels (0=X, 1=Y, 2=Z), the
    transformer denoiser's conditioning form, used where 3^N makes global
    indices and the full enumeration infeasible. Returns ``[B, shots, N]``
    int8 on ``device`` (default CUDA; raises if CUDA is absent and
    ``device`` was not given), where ``denoise_fn``, ``schedule`` and
    ``generator`` live.

    ``mode``:

    - ``'direct'`` — per-chain :func:`p_sample` on the flat label rows, at
      most ``max_chains_per_call`` chains a call (the JAX package's bound
      on one call's activations).
    - ``'tables'`` — :func:`sample_for_bases_tables`: the tables over the
      ``B·2^N`` (basis-row, x) grid, then one table walk; ``timings`` gets
      ``'tables'`` and ``'walk'``.
    - ``'auto'`` — tables when chains outnumber grid rows (``shots >=
      2^N``) and the CUDA walk takes the N (``cuda_kernels._MAX_WALK_N``),
      direct otherwise. Both sample the same chain; the JAX package walks
      any N with XLA, the port's walk is the kernel, so above its N the
      direct sampler runs on every device.
    """
    dev = _check_generator(generator, device)
    if mode not in ("auto", "tables", "direct"):
        raise ValueError(f"unknown mode {mode!r}")
    labels = torch.as_tensor(basis_labels, device=dev).long()
    b, n = labels.shape
    if mode == "tables" or (mode == "auto" and shots >= 2**n
                            and n <= cuda_kernels._MAX_WALK_N):
        return sample_for_bases_tables(generator, denoise_fn, labels, shots,
                                       schedule, exact=exact, device=dev,
                                       timings=timings)
    flat = labels.repeat_interleave(shots, dim=0)  # [B·shots, N]
    out = [p_sample(generator, denoise_fn, flat[lo:lo + max_chains_per_call],
                    n, schedule, exact=exact)
           for lo in range(0, flat.shape[0], max_chains_per_call)]
    return torch.cat(out).reshape(b, shots, n)


@torch.no_grad()
def sample_for_bases_tables(
    generator: torch.Generator,
    denoise_fn: DenoiseFn,
    basis_labels: torch.Tensor,
    shots: int,
    schedule: DiffusionSchedule,
    exact: bool | None = None,
    max_table_rows: int = 1 << 18,
    max_chains: int = 1 << 21,
    row_budget: int = 1 << 16,
    device: str | torch.device | None = None,
    timings: dict | None = None,
) -> torch.Tensor:
    """Shadow-route generation with amortised grid tables.

    Within a basis row every chain's denoiser input is one of the 2^N
    values of x_t, so the per-step tables over the ``[B·2^N, N]``
    (basis-row, x) grid determine the whole reverse process: the model runs
    T·B·2^N grid rows instead of T·B·shots chain rows, and every chain
    becomes a table walk with no model call.

    - Tables: ``m`` timesteps a chunk (``m·B·2^N <= max_table_rows``), every
      forward ``<= row_budget`` rows (tighter than the MLP's budget: a
      transformer row carries N token activations), written in place into
      one ``[T, B, 2^N, N]`` buffer (409.6 MB at T=100, B=100, N=10).
    - Walk: at most ``max_chains`` chains a call through
      :func:`~ddqst_tpu_torch.ops.cuda_kernels.fused_chain_walk`, each call
      with its own ``init`` and seed from ``generator``; on CUDA one kernel
      launch a call (one at the ``shadow_transformer`` preset).

    The distribution is the direct sampler's (the same per-step marginals).
    Returns ``[B, shots, N]`` int8; ``timings`` gets ``'tables'`` and
    ``'walk'`` seconds (the device synchronised around each).
    """
    exact = _resolve_exact(schedule, exact)
    dev = _check_generator(generator, device)
    labels = torch.as_tensor(basis_labels, device=dev).long()
    b, n = labels.shape
    g = 2**n
    grid = (_unpack(torch.arange(g, device=dev), n).repeat(b, 1),
            labels.repeat_interleave(g, dim=0))
    return _timed_tables_and_walk(
        lambda: _assembled_tables(denoise_fn, n, schedule, exact, grid,
                                  max_table_rows, row_budget),
        lambda tables: _walk_shot_chunks(generator, tables, shots, max_chains),
        dev, timings)


@torch.no_grad()
def sample_all_bases_chunked(
    generator: torch.Generator,
    denoise_fn: DenoiseFn,
    num_qubits: int,
    shots: int,
    schedule: DiffusionSchedule,
    exact: bool | None = None,
    max_table_rows: int = 1 << 22,
    max_chains: int = 1 << 22,
    walk: str = "auto",
    device: str | torch.device | None = None,
    timings: dict | None = None,
) -> torch.Tensor:
    """All-bases generation with the grid tables computed ONCE.

    :func:`sample_all_bases` builds the ``[T, 6^N]`` tables inside every
    call, so a run chunked over shots pays for them once a chunk. Here they
    are built once: ``m`` timesteps a chunk (``m·6^N <= max_table_rows``
    rows; every forward ``<= 2^17`` rows) into one preallocated ``[T, 3^N,
    2^N, N]`` buffer written in place (peak: the table plus one chunk, 5.4
    GB at N = 8), then walked at most ``max_chains`` chains a call through
    :func:`~ddqst_tpu_torch.ops.cuda_kernels.fused_chain_walk` (2^N up to
    2^16 on the card).

    ``walk``: ``'auto'`` (the walk's wrapper: the kernel on CUDA, its plain
    version on the CPU) or ``'cuda'`` (the same, demanded: raises unless
    the device is CUDA). The distribution equals ``sample_all_bases``'s, and
    the tables equal :func:`grid_p1_tables`'s. Returns ``[3^N, shots, N]``
    int8; ``timings`` gets ``'tables'`` and ``'walk'``.
    """
    exact = _resolve_exact(schedule, exact)
    dev = _check_generator(generator, device)
    if walk not in ("auto", "cuda"):
        raise ValueError(f"unknown walk {walk!r}")
    if walk == "cuda" and dev.type != "cuda":
        raise ValueError(f"walk='cuda' launches the CUDA kernel; got device "
                         f"{dev}")
    grid = _grid_enum(num_qubits, dev)
    return _timed_tables_and_walk(
        lambda: _assembled_tables(denoise_fn, num_qubits, schedule, exact,
                                  grid, max_table_rows, _ROW_BUDGET),
        lambda tables: _walk_shot_chunks(generator, tables, shots, max_chains),
        dev, timings)
