"""Hard-basis mining (``TrainConfig.chain_hard_frac``) against the uniform
minibatch draw: the counterpart of ``scripts/diag_hard_mining.py``.

    python -m ddqst_tpu_torch.campaigns.diag_hard_mining [--out FILE]
        [--steps S] [--warm W] [--device cuda|cpu]

In the JAX package's GHZ-8 campaign the chain's residual excess KL over
the MLE target was about 0.011 nats on the full-grid mean but 0.0002 on
48 random bases: it sat in under 1% of the bases (the low-entropy Z
sector), which a uniform minibatch draw starves of gradient. This
reproduces the regime at GHZ-5 (the campaign's smooth MLE-projected Born
target, 4 bases a minibatch at accum 4), parks the chain at the uniform
draw's floor with ``WARM`` steps, then runs three arms of S steps from that
one state:

- ``uniform``: ``hard_frac = 0`` (the control);
- ``hard50`` / ``hard90``: half / 90% of the draw follows each basis'
  measured excess KL.

Each arm's :func:`profile`: the full-grid mean excess KL, its mean over
the Z-sector decile (the lowest-entropy tenth of the bases) and the worst
basis'. The record (``--out``, default ``examples/results_torch/
diag_hard_mining.json``) has the script's keys (``floor``, ``warmup`` and
the arms, each ``{'mean', 'zsector', 'max'}``) and ``device``. The arms'
minibatches come from generators seeded ``0x4A8D + salt``, not the
script's JAX keys (``campaigns.diag``).
"""

from __future__ import annotations

import sys
from typing import Callable

import numpy as np
import torch

from ddqst_tpu_torch.campaigns import diag
from ddqst_tpu_torch.campaigns.recipes import diag_cfg

S = 300     # steps an arm
WARM = 600  # steps that park the chain at the uniform draw's floor
ACCUM = 4
SALT = 0x4A8D
NAME = "diag5mine"
ARMS = (("uniform", 0.0), ("hard50", 0.5), ("hard90", 0.9))


def mle_target(bits: torch.Tensor, basis_labels: np.ndarray) -> np.ndarray:
    """The campaign's smooth target (``pipeline.mle_born_target`` of the
    counts), ``[B, 2^N]`` float64, normalised."""
    from ddqst_tpu_torch.ops.mle import bits_to_counts
    from ddqst_tpu_torch.pipeline import mle_born_target

    target = mle_born_target(bits_to_counts(bits), basis_labels, {})
    target = target.double().cpu().numpy()
    return target / target.sum(-1, keepdims=True)


def profile(model: torch.nn.Module, schedule, cfg, target: np.ndarray,
            low: np.ndarray) -> dict:
    """The full-grid excess KL's mean, its mean over the bases ``low`` and
    its maximum."""
    from ddqst_tpu_torch.campaigns.eval_chain_ce_subset import chain_excess

    exc = chain_excess(model, schedule, cfg, target,
                       np.arange(target.shape[0]), target.shape[0])
    return {"mean": float(exc.mean()), "zsector": float(exc[low].mean()),
            "max": float(exc.max())}


def z_decile(target: np.ndarray) -> np.ndarray:
    """The lowest-entropy tenth of the bases (at least one)."""
    from ddqst_tpu_torch.campaigns.eval_chain_ce_subset import entropy

    ent = entropy(target)
    return np.argsort(ent)[:max(len(ent) // 10, 1)]


def arms(model0: torch.nn.Module, target: np.ndarray, schedule, cfg,
         device, *, steps: int = S, warm: int = WARM,
         log_fn: Callable = print) -> dict:
    """The warm-up and the three arms from ``model0`` against the
    ``[3^N, 2^N]`` probabilities ``target``."""
    from ddqst_tpu_torch.campaigns.eval_chain_ce_subset import entropy

    ent, low = entropy(target), z_decile(target)
    log_fn(f"MLE target built; floor {ent.mean():.5f}, Z-sector floor "
           f"{ent[low].mean():.5f}")

    def distill(model, *, steps, salt, hard=0.0):
        return diag.distill(model, target, schedule, cfg, device,
                            steps=steps, salt=SALT + salt, accum=ACCUM,
                            hard_frac=hard)

    def line(p):
        return (f"excess mean {p['mean']:.5f} zsector {p['zsector']:.5f} "
                f"max {p['max']:.5f}")

    st_floor, _, _ = distill(model0, steps=warm, salt=0)
    p = profile(st_floor, schedule, cfg, target, low)
    log_fn(f"warmup (uniform {warm}@{ACCUM}): {line(p)}")
    results = {"floor": float(ent.mean()), "warmup": p}
    for arm, hard in ARMS:
        st, _, info = distill(st_floor, steps=steps, salt=17, hard=hard)
        results[arm] = p = profile(st, schedule, cfg, target, low)
        log_fn(f"{arm}: {line(p)} (CE {info['train_ce_before']:.5f} -> "
               f"{info['train_ce_after']:.5f})")
    return results


def run(bits: torch.Tensor, basis_idx, *, device: torch.device,
        generator: torch.Generator, steps: int = S, warm: int = WARM,
        epochs: int = 10, log_fn: Callable = print) -> dict:
    """The diagnostic on the data ``bits`` ``[B, S, N]`` of the canonical
    bases ``basis_idx``: CE training from ``generator``, the MLE target of
    the data, then the arms."""
    from ddqst_tpu_torch.ops.pauli import all_basis_labels

    n = bits.shape[2]
    cfg = diag_cfg(NAME, num_qubits=n, epochs=epochs)
    model0, schedule = diag.train_ce(cfg, bits, basis_idx, generator,
                                     device, log_fn)
    target = mle_target(bits.to(device),
                        all_basis_labels(n)[np.asarray(basis_idx)])
    return arms(model0, target, schedule, cfg, device, steps=steps,
                warm=warm, log_fn=log_fn)


def main(argv: list[str] | None = None) -> int:
    return diag.main("diag_hard_mining", diag_cfg(NAME), run, argv,
                     __doc__, S, WARM)


if __name__ == "__main__":
    sys.exit(main())
