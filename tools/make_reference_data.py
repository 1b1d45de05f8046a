#!/usr/bin/env python3
"""Write a scaling rung's seed data with the JAX package, and print the JAX
package's data-side numbers on it.

    JAX_PLATFORMS=cpu python tools/make_reference_data.py --tag rqc6_auto \\
        --out examples/reference_data/rqc6_auto_seed0.npz

The rung's config is ``scripts/run_scaling_ghz.py``'s own (its
``experiments()``). The file is ``ddqst_tpu.pipeline.ensure_data_cache`` at
the seed, in the JAX package's schema (``save_data_cache``), which the
port's ``run_experiment(data_cache=...)`` reads; an existing file is kept.
Then, as ``ddqst_tpu.pipeline.run_experiment`` computes them on that data
and on the CPU: the raw-inversion fidelity (linear inversion of the raw
training counts) and MLE on the raw counts (readout-aware, solved to the
package's tolerance, at most ``--mle-iterations``) with its iteration
count. One JSON line. The npz's arrays are the same at every run; the
zip's timestamps are not, so the file's bytes differ.

With ``--draws`` it writes instead the bases the rung's distillation draws
(``ddqst_tpu.train.finetune_chain`` in the recipe at ``--seed``, with the
recipe's own ``chain_key_salt``), one row a step:

    JAX_PLATFORMS=cpu python tools/make_reference_data.py --tag ghz6_auto \\
        --draws --out examples/reference_data/ghz6_auto_draws_seed0.npz

The draws read no parameters: ``run_experiment`` keys the distillation with
``fold_in(k_train, 0xD157 + chain_key_salt)``, each chunk of
``chain_steps_per_call`` steps folds in the steps done and splits that many
keys, and each step chooses ``chain_basis_batch`` of the 3^N bases without
replacement. The file holds ``draws`` (int16 ``[steps, basis_batch]``),
``tag``, ``seed``, ``salt`` (the offset on the recipe's
``chain_key_salt``: 0), ``steps_per_call`` and ``jax_version``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from ddqst_tpu import pipeline as jpipe  # noqa: E402
from ddqst_tpu.ops import metrics as jM  # noqa: E402
from ddqst_tpu.ops import mle as jmle  # noqa: E402
from ddqst_tpu.ops import pauli as jpauli  # noqa: E402
from ddqst_tpu.ops.complexlib import from_complex  # noqa: E402
from ddqst_tpu.qsim import noise as jnoise  # noqa: E402


def rung_cfg(tag: str):
    """``scripts/run_scaling_ghz.py``'s config of ``tag``."""
    import run_scaling_ghz

    for name, cfg, _ in run_scaling_ghz.experiments():
        if name == tag:
            return cfg
    raise ValueError(f"no rung {tag!r} in scripts/run_scaling_ghz.py")


class CountedSolve:
    """Within the block, every ``ddqst_tpu.ops.mle`` solve records the
    iterations it applied in ``self.iterations`` (the package's own loop,
    ``_run_chunked``, which returns only ρ)."""

    def __enter__(self):
        self.run = jmle._run_chunked
        self.iterations = []

        def counted(step, rho0, f, iterations, tol):
            i, delta, rho = 0, float("inf"), rho0
            while i < iterations and delta > tol:
                i_arr, rho, delta_arr = step(jnp.int32(i), rho, f)
                i, delta = int(i_arr), float(delta_arr)
            self.iterations.append(i)
            return rho

        jmle._run_chunked = counted
        return self

    def __exit__(self, *exc):
        jmle._run_chunked = self.run


def data_side(cfg, data, mle_iterations: int = 4000) -> dict:
    """``ddqst_tpu.pipeline.run_experiment``'s raw baselines on ``data``
    (``ddqst_tpu/pipeline.py:893-912``): the raw-inversion fidelity and MLE
    on the raw counts, with its iteration count and seconds."""
    n = cfg.data.num_qubits
    target = from_complex(data.target)
    raw = jmle.bits_to_counts(data.bits).astype(jnp.float32)
    rho_raw = jpauli.make_counts_inverter(n, data.basis_labels)(raw)
    p = jnoise.get_noise_config(cfg.data.noise_type).readout_p
    t0 = time.perf_counter()
    with CountedSolve() as solve:
        rho = jmle.make_mle(n, data.basis_labels, readout_p=p,
                            iterations=mle_iterations)(raw)
    return dict(raw_fidelity=float(jM.state_fidelity(target, rho_raw)),
                raw_fidelity_mitigated=float(jM.state_fidelity(target, rho)),
                mle_iterations=solve.iterations[0],
                mle_s=time.perf_counter() - t0, readout_p=p)


def distill_key(seed: int, salt: int):
    """The key ``ddqst_tpu.pipeline.run_experiment`` hands
    ``finetune_chain`` at ``seed`` with ``chain_key_salt`` ``salt``."""
    _, k_train, _ = jax.random.split(jax.random.key(seed), 3)
    return jax.random.fold_in(k_train, 0xD157 + salt)


def chunk_draws(key, done: int, length: int, num_bases: int,
                basis_batch: int) -> np.ndarray:
    """The bases of the chunk of ``length`` steps that starts after
    ``done`` steps: ``[length, basis_batch]``, as ``finetune_chain``'s
    ``run_chunk`` draws them (no mining, one minibatch a step)."""
    keys = jax.random.split(jax.random.fold_in(key, done), length)
    return np.stack([np.asarray(jax.random.choice(
        k, num_bases, (basis_batch,), replace=False)) for k in keys])


def recipe_draws(cfg, seed: int) -> np.ndarray:
    """Every step's bases in ``cfg``'s distillation: ``[steps,
    basis_batch]``, int16. Raises ``ValueError`` for a recipe whose draw
    this does not reproduce (mining, accumulation, no minibatch)."""
    tr = cfg.train
    num_bases = 3**cfg.data.num_qubits
    if (tr.chain_hard_frac or tr.chain_accum > 1
            or not 0 < tr.chain_basis_batch < num_bases):
        raise ValueError(f"{cfg.name}: the draw is not one uniform "
                         "minibatch a step")
    key = distill_key(seed, tr.chain_key_salt)
    rows, done = [], 0
    while done < tr.chain_finetune_steps:
        length = min(tr.chain_steps_per_call, tr.chain_finetune_steps - done)
        rows.append(chunk_draws(key, done, length, num_bases,
                                tr.chain_basis_batch))
        done += length
    return np.concatenate(rows).astype(np.int16)


def write_draws(tag: str, seed: int, out: str) -> dict:
    """``--draws``: the rung's draws and what keyed them, at ``out``."""
    cfg = rung_cfg(tag)
    t0 = time.perf_counter()
    draws = recipe_draws(cfg, seed)
    np.savez(out, draws=draws, tag=np.array(tag), seed=np.int64(seed),
             salt=np.int64(0),
             steps_per_call=np.int64(cfg.train.chain_steps_per_call),
             jax_version=np.array(jax.__version__))
    return dict(tag=tag, seed=seed, salt=0, path=out,
                shape=list(draws.shape), jax_version=jax.__version__,
                draws_s=time.perf_counter() - t0,
                bytes=os.path.getsize(out))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="rqc6_auto")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", required=True)
    ap.add_argument("--mle-iterations", type=int, default=4000)
    ap.add_argument("--draws", action="store_true",
                    help="write the distillation's basis draws instead")
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    if args.draws:
        print(json.dumps(write_draws(args.tag, args.seed, args.out)),
              flush=True)
        return 0
    cfg = rung_cfg(args.tag)
    t0 = time.perf_counter()
    jpipe.ensure_data_cache(cfg, args.seed, args.out)
    data_s = time.perf_counter() - t0
    data = jpipe.load_data_cache(args.out)
    out = dict(tag=args.tag, seed=args.seed, path=args.out, data_s=data_s,
               bytes=os.path.getsize(args.out),
               **data_side(cfg, data, args.mle_iterations))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
