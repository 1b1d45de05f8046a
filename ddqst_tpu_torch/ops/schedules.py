"""Noise schedules for the binary (bit-flip) D3PM forward process.

The port's counterpart of ``ddqst_tpu/ops/schedules.py``. Every single-step
transition is a symmetric 2x2 flip channel, so a schedule is two scalar
arrays:

- ``betas[t]``    — single-step flip probability P(x_t != x_{t-1}).
- ``cum_flip[t]`` — cumulative flip probability P(x_t != x_0).

Families:

- ``linear``   — ``betas = linspace(0.001, 0.5, T+1)`` float32, applied
  one-shot: ``cum_flip == betas`` (the reference quirk kept for parity).
- ``notebook`` — ``betas = 1 - linspace(1, 0.5, T+1)``, also one-shot.
- ``cosine``   — Nichol & Dhariwal ᾱ(t) in float64, β clipped at 0.999,
  β_0 = 0, with ``cum_flip`` from a float32 chain of 2x2 products so the
  arrays match the JAX package to float32 rounding.

The arrays are built on the host in numpy and moved to the caller's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Frozen schedule consumed by the diffusion ops.

    Attributes:
      betas: ``[T+1]`` float32, single-step flip probability (index 0 unused).
      cum_flip: ``[T+1]`` float32, cumulative flip probability P(x_t != x_0).
      num_timesteps: T.
      kind: schedule family name.
      exact_posterior: default reverse rule (True: exact D3PM posterior,
        False: predict-x0-and-renoise).
    """

    betas: torch.Tensor
    cum_flip: torch.Tensor
    num_timesteps: int
    kind: str
    exact_posterior: bool

    def to(self, device: torch.device | str) -> "DiffusionSchedule":
        return dataclasses.replace(
            self, betas=self.betas.to(device), cum_flip=self.cum_flip.to(device)
        )


def _cumulative_flip_from_chain(betas: np.ndarray) -> np.ndarray:
    """Off-diagonal of the float32 chain Q̄_t = Q_t @ Q̄_{t-1}."""
    q_bar = np.eye(2, dtype=np.float32)
    out = [np.float32(0.0)]
    for beta in betas[1:]:
        q_t = np.array([[1.0 - beta, beta], [beta, 1.0 - beta]], np.float32)
        q_bar = q_t @ q_bar
        out.append(q_bar[0, 1])
    return np.asarray(out, np.float32)


def _make(betas: np.ndarray, cum_flip: np.ndarray, kind: str,
          exact_posterior: bool, device) -> DiffusionSchedule:
    return DiffusionSchedule(
        betas=torch.from_numpy(betas).to(device),
        cum_flip=torch.from_numpy(cum_flip).to(device),
        num_timesteps=len(betas) - 1,
        kind=kind,
        exact_posterior=exact_posterior,
    )


def linear_schedule(num_timesteps: int, device="cpu") -> DiffusionSchedule:
    """Phases 1–3: ``betas = linspace(0.001, 0.5, T+1)``, ``cum_flip == betas``."""
    betas = np.linspace(0.001, 0.5, num_timesteps + 1).astype(np.float32)
    return _make(betas, betas.copy(), "linear", False, device)


def notebook_schedule(num_timesteps: int, device="cpu") -> DiffusionSchedule:
    """Phase-1 notebook: ``betas = 1 - linspace(1, 0.5, T+1)``, one-shot."""
    p_stay = np.linspace(1.0, 0.5, num_timesteps + 1).astype(np.float32)
    betas = (np.float32(1.0) - p_stay).astype(np.float32)
    return _make(betas, betas.copy(), "notebook", False, device)


def cosine_betas(num_timesteps: int) -> np.ndarray:
    """float64 ᾱ, β_t = min(1 - ᾱ_t/ᾱ_{t-1}, 0.999), β_0 = 0, cast float32."""
    steps = np.arange(num_timesteps + 1, dtype=np.float64) / num_timesteps
    alpha_bar = np.cos((steps + 0.008) / 1.008 * np.pi / 2) ** 2
    alpha_bar = alpha_bar / alpha_bar[0]
    betas = np.minimum(1.0 - alpha_bar[1:] / alpha_bar[:-1], 0.999)
    return np.concatenate([[0.0], betas]).astype(np.float32)


def cosine_schedule(num_timesteps: int, device="cpu") -> DiffusionSchedule:
    """Phase-4 cosine schedule with the true cumulative Q̄ chain."""
    betas = cosine_betas(num_timesteps)
    return _make(betas, _cumulative_flip_from_chain(betas), "cosine", True,
                 device)


def make_schedule(kind: str, num_timesteps: int, device="cpu") -> DiffusionSchedule:
    if kind == "linear":
        return linear_schedule(num_timesteps, device)
    if kind == "notebook":
        return notebook_schedule(num_timesteps, device)
    if kind == "cosine":
        return cosine_schedule(num_timesteps, device)
    raise ValueError(f"unknown schedule kind: {kind!r}")
